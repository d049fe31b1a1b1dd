"""Serving cells: ``RequestScheduler`` over a ``SessionRuntime`` with
adapted tenants, driven by a closed loop of clients.

Each of ``clients`` clients is bound to a tenant (an adapter of the pool)
or to the base model, sends a request, waits for its last token, and sends
the next at once. A request's prompt is the tenant's shared prefix
(``shared_prefix`` tokens, drawn once a tenant) followed by tokens of its
own; it asks for a number of new tokens at temperature 0.

Lengths are log-normal, with the mean and deviation that ``prompt`` and
``new_tokens`` state, cut to [``lo``, the scheduler's cap]. Clients are
spread over the models (the tenants in order, the base model at rank
``base_rank``, none where it is null) by Zipf(``zipf``) over their ranks.

The work is the same for every seed: the lengths are the distribution's
quantiles at (i + 1/2) / n, in one fixed shuffled order, and the clients'
models fixed counts (largest remainder) in one fixed assignment; the seed
draws every token id.

Set-up warms every shape the window uses: one request of each tenant
(which publishes its prefix when prefix reuse is on), then a wave of the
shortest and a wave of the longest requests, each drained.
"""

from __future__ import annotations

import importlib
import math
import time
from statistics import NormalDist

import numpy as np
import torch

from portbench import flops as FL
from portbench import weights as W
from portbench.correct import gap_readings
from portbench.harness import percentile

#: requests a client has queued for one run (the window never needs more)
PER_CLIENT = 64
#: seconds a request may take past the window's close before it counts failed
LATE_S = 60.0
#: the lengths' order and the clients' tenants are the same for every seed,
#: so that seeds differ only in token ids and runs only by the system's noise
ORDER_SEED = 20240519



def lognormal_lengths(mean: float, std: float, lo: int, hi: int, n: int) -> np.ndarray:
    """The log-normal of this mean and deviation at its ``n`` quantiles
    (i + 1/2) / n, rounded and cut to [lo, hi]."""
    s2 = math.log1p((std / mean) ** 2)
    mu, sigma = math.log(mean) - s2 / 2, math.sqrt(s2)
    q = [NormalDist(mu, sigma).inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.rint(np.exp(q)), lo, hi).astype(np.int64)


def client_tenants(clients: int, tenants: int, base_rank, zipf: float) -> list:
    """The clients' models (None: the base model) as fixed counts, by
    largest remainder, of Zipf(``zipf``) over the ranks: the tenants in
    order, with the base model at ``base_rank`` (1 = the most popular)."""
    models = list(range(tenants))
    if base_rank:
        models.insert(base_rank - 1, None)
    w = 1.0 / np.arange(1, len(models) + 1) ** zipf
    share = clients * w / w.sum()
    counts = np.floor(share).astype(int)
    for i in np.argsort(-(share - counts), kind="stable")[: clients - counts.sum()]:
        counts[i] += 1
    return [m for m, k in zip(models, counts) for _ in range(k)]


class Traffic:
    """Every request of one run, drawn from the seed."""

    def __init__(self, tr: dict, vocab: int, seed: int):
        order = np.random.default_rng(ORDER_SEED)
        c = tr["clients"]
        self.tenant_of = [client_tenants(c, tr["tenants"], tr["base_rank"], tr["zipf"])[i]
                          for i in order.permutation(c)]
        n = c * PER_CLIENT
        sc, pr, nw = tr["scheduler"], tr["prompt"], tr["new_tokens"]
        own_cap = sc["max_prompt"] - tr["shared_prefix"]
        self.own = order.permutation(lognormal_lengths(pr["mean"], pr["std"], pr["lo"], own_cap, n))
        self.new = order.permutation(lognormal_lengths(nw["mean"], nw["std"], nw["lo"], sc["max_new_cap"], n))
        rng = np.random.default_rng(seed)
        pre = tr["shared_prefix"]
        self.prefix = {t: rng.integers(0, vocab, pre) for t in range(tr["tenants"])}
        self.prefix[None] = rng.integers(0, vocab, pre)
        self.seed, self.vocab, self.tr = seed, vocab, tr

    def request(self, client: int, k: int) -> tuple:
        """Client ``client``'s ``k``-th request: (tenant, prompt, new), the
        same whatever the order in which clients send."""
        i = (k * self.tr["clients"] + client) % len(self.own)
        t = self.tenant_of[client]
        own = np.random.default_rng([self.seed, 1, client, k]).integers(0, self.vocab, int(self.own[i]))
        return t, np.concatenate([self.prefix[t], own]).astype(np.int32), int(self.new[i])

    def warmup(self) -> list[list[tuple]]:
        """Waves of requests that reach every shape of the window."""
        bucket = self.tr["scheduler"]["admit_bucket"]
        lo, hi = int(self.own.min()), int(self.own.max())
        nlo, nhi = int(self.new.min()), int(self.new.max())
        who = sorted(set(self.tenant_of), key=lambda t: -1 if t is None else t)
        rng = np.random.default_rng([self.seed, 2])

        def req(t, own, new):
            body = rng.integers(0, self.vocab, own)
            return t, np.concatenate([self.prefix[t], body]).astype(np.int32), new

        waves = [[req(t, hi, nlo) for t in who]]
        for own in (lo, hi):
            waves.append([req(who[i % len(who)], own, nhi if own == hi else nlo) for i in range(bucket)])
        return waves


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.spans = spans
        self.s_weights, self.s_adapters, self.s_traffic, self.s_runtime, self.s_sample = W.sub_seeds(seed, 5)
        self.traffic = Traffic(traffic, config["vocab_size"], self.s_traffic)
        self.RD = importlib.import_module(f"portbench.reference.{config['reference']}")

    # -- set-up ----------------------------------------------------------------

    def adapters(self) -> dict:
        """The tenants' adapter stacks {"A": (T, L, D, R), "B": (T, L, R, D)},
        float32, from the seed: A N(0, 1/D), B N(0, adapter_b_std^2)."""
        g = W.generator(self.device, self.s_adapters)
        t, n, d, r = self.tr["tenants"], self.cfg["n_layers"], self.cfg["d_model"], self.tr["rank"]
        a = torch.randn((t, n, d, r), generator=g, device=self.device).div_(d ** 0.5)
        b = torch.randn((t, n, r, d), generator=g, device=self.device).mul_(self.tr["adapter_b_std"])
        return {"A": a, "B": b}

    def setup(self) -> None:
        from repro_torch.core import lm_skiplora as SL
        from repro_torch.core.runtime import SessionRuntime
        from repro_torch.core.scheduler import RequestScheduler

        tr = self.tr
        self.weights = W.make(self.cfg, self.s_weights, self.device)
        self.port_cfg = W.port_config(self.cfg)
        self.stack = self.adapters()
        self.rt = SessionRuntime(self.port_cfg, SL.SkipLoRAConfig(rank=tr["rank"]), self.weights,
                                 max_tenants=tr["tenants"], samples_per_tenant=1, seq=8, use_kernel=True,
                                 seed=self.s_runtime % (1 << 30), device=self.device)
        self.rt.pool.register_many(list(range(tr["tenants"])), self.stack)
        self.sched = RequestScheduler(self.rt, **tr["scheduler"])
        for wave in self.traffic.warmup():
            for t, prompt, new in wave:
                self.sched.submit(t, prompt, max_new=new)
            self.sched.drain()

    # -- the window --------------------------------------------------------------

    def admissions(self) -> int:
        c = self.sched.counters
        return c["dispatch/admit"] + c["dispatch/admit_reuse"] + c["dispatch/admit_pipe"]

    def window(self, seconds: float, trace) -> dict:
        tr = self.tr
        rank = tr["rank"]
        recs, live = [], {}
        sent = [0] * tr["clients"]
        flops = 0
        tokens_out = 0
        prompt_admitted = 0
        reused0 = self.sched.counters["prefix/tokens_reused"]

        def submit(c: int) -> None:
            t, prompt, new = self.traffic.request(c, sent[c])
            sent[c] += 1
            t_sub = time.perf_counter()
            req = self.sched.submit(t, prompt, max_new=new)
            rec = {"req": req, "client": c, "tenant": t, "submit": t_sub, "first": None, "done": None,
                   "prompt": prompt, "new": new, "seen": 0}
            recs.append(rec)
            live[req.rid] = rec

        t0 = time.perf_counter()
        for c in range(tr["clients"]):
            submit(c)
        closing = False
        while live:
            now = time.perf_counter()
            if not closing:
                if trace is not None:
                    trace.tick(t0, now)
                if now - t0 >= seconds:
                    closing = True
                    t_end = now
                    reused1 = self.sched.counters["prefix/tokens_reused"]
                    if trace is not None:
                        trace.stop()
            elif now - t_end > LATE_S:
                break
            a0 = self.admissions()
            attrs: dict = {}
            with self.spans("sched.step", attrs=attrs):
                self.sched.step()
            t_ret = time.perf_counter()
            attrs["admit"] = self.admissions() > a0
            for rid, rec in list(live.items()):
                req = rec["req"]
                n = len(req.tokens)
                if n > rec["seen"] and not closing:
                    adapted = rec["tenant"] is not None
                    p = len(rec["prompt"])
                    for i in range(rec["seen"], n):
                        if i == 0:
                            flops += FL.prefill_flops(self.cfg, p, rank, adapted)
                            prompt_admitted += p
                        else:
                            flops += FL.decode_flops(self.cfg, p + i, rank, adapted)
                    tokens_out += n - rec["seen"]
                if n > 0 and rec["first"] is None:
                    rec["first"] = t_ret
                rec["seen"] = n
                if req.done:
                    rec["done"] = t_ret
                    del live[rid]
                    if not closing:
                        submit(rec["client"])
        if not closing:
            t_end = time.perf_counter()
            reused1 = self.sched.counters["prefix/tokens_reused"]
        failed = sum(1 for r in recs if r["done"] is None or r["req"].error is not None)
        ok = [r for r in recs if r["done"] is not None and r["req"].error is None]
        ttft = [(r["first"] - r["submit"]) * 1e3 for r in ok]
        tpot = [(r["done"] - r["first"]) * 1e3 / (r["new"] - 1) for r in ok if r["new"] > 1]
        self.recs = ok
        window_s = t_end - t0
        self.win = {"window_s": window_s, "flops": flops, "tokens": tokens_out, "prompt_admitted": prompt_admitted,
                    "tokens_reused": reused1 - reused0,
                    "steps": [(t1 - t0_, a["attrs"].get("admit", False))
                              for t0_, t1, a in self.spans.of("sched.step") if t0_ >= t0 and t1 <= t_end]}
        metrics = {"serve_tokens_per_s": tokens_out / window_s}
        if ttft:
            metrics["ttft_p95_ms"] = percentile(ttft, 95)
        if tpot:
            metrics["tpot_p95_ms"] = percentile(tpot, 95)
        return {"metrics": metrics, "attempted": len(recs), "failed": failed}

    # -- after the window ------------------------------------------------------

    def release(self) -> None:
        from portbench.drivers import free_program

        self.sched = None
        self.rt = None
        free_program()

    def sample(self) -> list[dict]:
        """``check.requests`` finished requests drawn from the seed, the
        longest among them."""
        recs = self.recs
        longest = max(range(len(recs)), key=lambda i: len(recs[i]["prompt"]) + recs[i]["new"])
        rest = [i for i in range(len(recs)) if i != longest]
        k = min(self.tr["check"]["requests"] - 1, len(rest))
        pick = np.random.default_rng(self.s_sample).choice(len(rest), k, replace=False)
        return [recs[longest]] + [recs[rest[i]] for i in sorted(pick)]

    def _forward(self, recs, precision: str) -> list[torch.Tensor]:
        """Logits (new, V) at the positions that produced each request's
        tokens: the prompt and the served tokens but the last, one forward."""
        seqs, adapters, groups = [], [], []
        width = self.tr["scheduler"]["max_prompt"]
        for r in recs:
            toks = np.asarray(r["req"].tokens[: r["new"]], np.int64)
            seq = np.concatenate([r["prompt"].astype(np.int64), toks[:-1]])
            seqs.append(torch.as_tensor(seq, device=self.device)[None])
            t = r["tenant"]
            adapters.append(None if t is None else (self.stack["A"][t], self.stack["B"][t]))
            p = len(r["prompt"])
            groups.append([(0, p, width)] + [(i, i + 1, 1) for i in range(p, len(seq))])
        out = self.RD.forward(self.weights, self.cfg, seqs, adapters=adapters, groups=groups, precision=precision)
        res = []
        for r, h in zip(recs, out["h"]):
            p = len(r["prompt"])
            res.append(self.RD.logits(self.weights, self.cfg, h[0, p - 1:], precision))
        return res

    def check(self, control: bool = False) -> dict:
        """``logit_gap``: the widest amount by which a served token's
        reference logit lies below the reference's best; ``mean_gap``: its
        mean over every served token of the sample. The control reads the
        same of the token that float8 puts first at each position."""
        recs = self.sample()
        with self.RD.exact_float32(), torch.no_grad():
            ref = self._forward(recs, "fp32")
            served = [torch.as_tensor(np.asarray(r["req"].tokens[: r["new"]]), device=self.device) for r in recs]
            out = {"readings": gap_readings(ref, served), "served_tokens": sum(r["new"] for r in recs)}
            if control:
                low = self._forward(recs, "fp8")
                out["control"] = gap_readings(ref, [lo.argmax(dim=-1) for lo in low])
        return out
