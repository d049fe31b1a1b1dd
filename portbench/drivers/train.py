"""Fine-tuning cells: ``SessionRuntime`` ingest, adapt and release.

Set-up fills a session of ``tenants`` x ``samples_per_tenant`` rows of
``seq`` tokens, ``ingest_rows`` rows a call, then runs the first job,
which is also the warm-up: it builds every kernel and captures every
graph the window replays. A job is, with ``job.new_tenant``, the release
of the least recently trained tenant and the ingest of a new tenant's
rows, then ``job.adapt_calls`` calls of ``adapt(epochs,
batch_per_tenant)``, over every tenant or over the new one. The window
runs jobs back to back.

The reference follows two calls for a sample of tenants drawn from the
seed: set-up's first, from the adapters' first draw, and the window's
last call over them, from the state the window's earlier calls left
(copied before and after each such call: some tens of MB on the device).

Rows are drawn on the device from the seed: ``seq + 1`` token ids a row,
the tokens the first ``seq`` and the labels the last ``seq`` of them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops as FL
from portbench import weights as W
from portbench.correct import train_readings
from portbench.reference import decoder as RD
from portbench.reference import skip2lora as RS



class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.spans = spans
        (self.s_weights, self.s_rows, self.s_init, self.s_runtime, self.s_sample,
         self.s_jobs) = W.sub_seeds(seed, 6)
        self.job = traffic["job"]
        self.rt = None
        #: the calls the reference follows: "first" and the window's "last"
        self.calls: dict = {}
        self.sampled: list = []

    # -- data -----------------------------------------------------------------

    def rows(self, key: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        g = W.generator(self.device, (self.s_rows << 20) + key)
        ids = torch.randint(0, self.cfg["vocab_size"], (n, self.tr["seq"] + 1), generator=g, device=self.device)
        return ids[:, :-1].contiguous(), ids[:, 1:].to(torch.int32).contiguous()

    def init_generator(self, job: int) -> torch.Generator:
        return W.generator(self.device, (self.s_init << 16) + job)

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.core import lm_skiplora as SL
        from repro_torch.core.runtime import SessionRuntime
        from repro_torch.optim.optimizers import adamw

        tr = self.tr
        o = tr["optimizer"]
        self.weights = W.make(self.cfg, self.s_weights, self.device)
        self.port_cfg = W.port_config(self.cfg)
        sl = SL.SkipLoRAConfig(rank=tr["rank"], mode=tr["mode"], cache_dtype=tr["cache_dtype"])
        self.rt = SessionRuntime(
            self.port_cfg, sl, self.weights, max_tenants=tr["tenants"],
            samples_per_tenant=tr["samples_per_tenant"], seq=tr["seq"],
            optimizer=adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"]),
            use_kernel=tr["use_kernel"], seed=self.s_runtime % (1 << 30), device=self.device,
        )
        #: tenant -> cache partition, by the session's rule: the smallest
        #: free partition, a released tenant's partition freed for the next
        self.partition: dict = {}
        self.lru: list = []
        self.data: dict = {}
        for t in range(tr["tenants"]):
            self._ingest(t, self.rows(t, tr["samples_per_tenant"]))
            self.lru.append(t)
        self.jobs_run = 0
        self._run_job(record_first=True)

    def _ingest(self, tenant, rows) -> None:
        tok, lab = rows
        if tenant not in self.partition:
            used = set(self.partition.values())
            self.partition[tenant] = min(p for p in range(self.tr["tenants"]) if p not in used)
        self.data[tenant] = rows
        step = self.tr["ingest_rows"]
        for i in range(0, tok.shape[0], step):
            with self.spans("train.ingest", rows=min(step, tok.shape[0] - i)):
                self.rt.ingest(tenant, tok[i:i + step], lab[i:i + step])

    def _run_job(self, record_first: bool = False) -> dict:
        """One job; returns its counts of tokens trained and rows ingested."""
        job, j = self.job, self.jobs_run
        rows_in = 0
        if job["new_tenant"]:
            victim = self.lru.pop(0)
            with self.spans("train.release"):
                self.rt.release(victim)
            del self.partition[victim], self.data[victim]
            tenant = ("job", j)
            self._ingest(tenant, self.rows(self.tr["tenants"] + j, self.tr["samples_per_tenant"]))
            rows_in = self.tr["samples_per_tenant"]
            group = [tenant]
            draws = [tenant]
        else:
            group = None
            draws = list(self.lru) if j == 0 else []
        tokens = 0
        for c in range(job["adapt_calls"]):
            first = record_first and c == 0
            watched = [] if first else [t for t in self.sampled
                                        if (group is None or t in group) and self.rt.tenant(t).trained]
            start = self._snapshot(watched)
            with self.spans("train.adapt"):
                res = self.rt.adapt(group, epochs=job["epochs"], batch_per_tenant=job["batch_per_tenant"],
                                    generator=self.init_generator(j))
            shape = next(iter(res["losses"].values())).shape          # (epochs, steps)
            n_t = len(res["losses"])
            tokens += shape[0] * shape[1] * n_t * job["batch_per_tenant"] * self.tr["seq"]
            finite = all(np.isfinite(v).all() for v in res["losses"].values())
            if first:
                self._record_first(res, draws, group)
                self.calls["first"]["end"] = self._snapshot(self.sampled)
            elif watched:
                self.calls["last"] = {"start": start, "end": self._snapshot(watched),
                                      "losses": {t: res["losses"][t] for t in watched}}
            if not finite:
                raise FloatingPointError("a loss of the adapt call is not finite")
        if job["new_tenant"]:
            self.lru.append(group[0])
        else:
            self.lru.append(self.lru.pop(0))
        self.jobs_run += 1
        return {"tokens": tokens, "rows_ingested": rows_in, "adapt_calls": job["adapt_calls"]}

    def _snapshot(self, tenants: list) -> dict:
        """Copies of each tenant's training state, on the device: before a
        call, where the reference starts it; after, what is judged."""
        out = {}
        for t in tenants:
            st = self.rt.tenant(t)
            out[t] = {"A": st.adapters["A"].detach().clone(), "B": st.adapters["B"].detach().clone(),
                      "mu": {k: v.detach().clone() for k, v in st.opt_mu.items()},
                      "nu": {k: v.detach().clone() for k, v in st.opt_nu.items()},
                      "step": st.step, "epoch": st.epochs_done}
        return out

    def _record_first(self, res: dict, draws: list, group) -> None:
        """Draw the sampled tenants and keep the first call's losses: the
        reference starts them from their first draw."""
        rng = np.random.default_rng(self.s_sample)
        if group is None:
            n = len(draws)
            k = self.tr["check"]["tenants"]
            half = n // 2
            pick = sorted(rng.choice(half, k // 2, replace=False).tolist()
                          + (half + rng.choice(n - half, k - k // 2, replace=False)).tolist())
            self.sampled = [draws[i] for i in pick]
        else:
            self.sampled = list(group)
        self.calls = {"first": {"start": {t: {"draw": draws.index(t), "step": 0, "epoch": 0} for t in self.sampled},
                                "losses": {t: res["losses"][t] for t in self.sampled}}}
        self.n_draws = len(draws)
        self.sampled_data = {t: self.data[t] for t in self.sampled}
        self.sampled_partition = {t: self.partition[t] for t in self.sampled}

    # -- the window --------------------------------------------------------------

    def counters(self) -> dict:
        from repro_torch.core import prefill_graph

        eg = self.rt.epoch_graph_stats()
        return {"epoch_captures": eg.get("captures", 0), "prefill_captures": prefill_graph.GRAPHS.stats["captures"]}

    def window(self, seconds: float, trace) -> dict:
        c0 = self.counters()
        tokens = rows = calls = jobs = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if trace is not None:
                trace.tick(t0, now)
            if now - t0 >= seconds:
                break
            with self.spans("train.job"):
                got = self._run_job()
            tokens += got["tokens"]
            rows += got["rows_ingested"]
            calls += got["adapt_calls"]
            jobs += 1
        t1 = time.perf_counter()
        if trace is not None:
            trace.stop()
        c1 = self.counters()
        self.win = {"window_s": t1 - t0, "t0": t0, "t1": t1, "tokens": tokens, "rows_ingested": rows,
                    "adapt_calls": calls, "jobs": jobs, "counters": {k: c1[k] - c0[k] for k in c0}}
        return {"metrics": {"train_tokens_per_s": tokens / (t1 - t0)}, "attempted": calls, "failed": 0}

    def window_flops(self) -> float:
        """The benchmark's count of the window's work: every adapt call's
        cached steps, and every ingested row's forward."""
        tr, job = self.tr, self.job
        positions = job["batch_per_tenant"] * tr["seq"]
        per_call_tenants = 1 if job["new_tenant"] else tr["tenants"]
        steps = -(-tr["samples_per_tenant"] // job["batch_per_tenant"]) * job["epochs"]
        step = FL.cached_step_flops(self.cfg, positions * per_call_tenants, tr["rank"])
        out = self.win["adapt_calls"] * steps * step
        out += FL.ingest_flops(self.cfg, self.win["rows_ingested"], tr["seq"], tr["rank"])
        return out

    # -- after the window ------------------------------------------------------

    def release(self) -> None:
        """Move the followed calls' states to the host, then free the
        program's state: the session and every graph cache."""
        from portbench.drivers import free_program

        self.calls = _to_cpu(self.calls)
        self.rt = None
        free_program()

    def reference(self, precision: str = "fp32") -> dict:
        """The reference's run of each call the program was read in, for
        each sampled tenant: {call: {tenant: {"losses", "A", "B", "mu",
        "A0", "B0"}}}."""
        tr, o = self.tr, self.tr["optimizer"]
        a0s = RS.initial_a(self.init_generator(0), self.cfg["n_layers"], self.cfg["d_model"], tr["rank"],
                           self.n_draws)
        out = {name: {} for name in self.calls}
        with RD.exact_float32(), torch.no_grad():
            for t in self.sampled:
                tok, lab = self.sampled_data[t]
                acts, y = RS.cached_rows(self.weights, self.cfg, tok, precision=precision)
                for name, call in self.calls.items():
                    if t not in call["losses"]:
                        continue
                    st = call["start"][t]
                    start = ({"A": a0s[st["draw"]]} if "draw" in st else
                             {k: _to_device(st[k], self.device) for k in ("A", "B", "mu", "nu")})
                    start["step"] = st["step"]
                    steps = RS.plan(self.s_runtime % (1 << 30), self.sampled_partition[t], st["epoch"],
                                    tok.shape[0], self.job["batch_per_tenant"])
                    with torch.enable_grad():
                        r = RS.follow(self.weights, self.cfg, acts, y, lab, start, steps, o, precision=precision)
                    out[name][t] = {"losses": r["losses"], "A": r["A"].cpu(), "B": r["B"].cpu(),
                                    "mu": {k: v.cpu() for k, v in r["mu"].items()},
                                    "A0": start["A"].cpu(), "B0": r["B0"].cpu()}
                del acts, y
        return out

    def program(self) -> dict:
        """The program's losses and end state of each call, by tenant."""
        return {name: {t: {"losses": call["losses"][t][0], **call["end"][t]} for t in call["losses"]}
                for name, call in self.calls.items()}

    def check(self, control: bool = False) -> dict:
        ref = self.reference()
        out = {"readings": train_readings(self.program(), ref)}
        if control:
            out["control"] = train_readings(self.reference("fp8"), ref)
        return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.float().cpu() if isinstance(tree, torch.Tensor) else tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
