"""Continuous-batching request scheduler over ``SessionRuntime``.

Counterpart of ``repro.core.scheduler``. ``serve()`` takes
pre-formed batches: every row starts together, decodes in lockstep and
finishes together. This module is the request-level event loop instead:
per-tenant requests in, step-synchronous dispatches out.

Event model (one ``step()`` = one dispatch per shard with work):

  1. *Admit*: ``batch_plan.plan_admissions`` walks the arrival-ordered
     queue under the per-tenant in-flight cap (FIFO within tenant, no
     head-of-line blocking across tenants) and fills up to ``admit_bucket``
     free rows.
  2. *Dispatch*: with admissions, the padded admission prefill
     (``lm.sched_prefill``), each new row's first token, the scatter of
     caches/tokens/positions into the live batch, then ``chunk`` decode
     steps; without admissions, the ``chunk`` steps alone. The decode is
     ``chunk`` in-place ``lm.decode_step_``s over per-row positions, per-row
     temperatures and per-row adapter slots: on the card one CUDA-graph
     replay over the live batch's resident buffers (``core.decode_graph``),
     on the CPU (or with ``loop=True``) eager steps. On the card the
     admission (prefill, first-token sample and scatter) is one CUDA-graph
     replay too (``core.prefill_graph``), the pipelined one included.
  3. *Harvest*: after every shard's dispatch is issued, pull the tokens
     to the host, append per row, retire rows whose requests hit
     ``max_new`` (their rows are recyclable at once: a follow-up admission
     wave runs in the same step on each shard with admissions).

Shards: a request decodes on its tenant's slot shard (base traffic and
tenants without a slot ride shard 0), in that shard's live batch, on the
shard's device, against the shard's pool and its paged KV pool and radix
index; nothing crosses shards.

Rows never wait for each other: a row admitted at step k decodes from its
own position while its neighbours are mid-sequence. Retired rows keep
their token and position frozen (``torch.where(active, ...)``; their cache
writes land at a frozen position nobody reads), so the dispatch's shapes
never change.

Prefix reuse (the paged KV pool and radix index on the runtime): a wave
whose prompts all match pooled blocks gathers them into the admission
caches (``kv_pool.gather_blocks``: K10 on the card, two launches a wave)
and prefills only the tails (``lm.sched_prefill_reuse``); a dense wave
publishes its prompts' full blocks into the pool afterwards.

Sampling: each dispatch draws from a ``torch.Generator`` on its shard's
device seeded from ``(seed, dispatch counter)``: deterministic replay for a
fresh, identically seeded scheduler, never one stream for two dispatches.
``mode="sequential"`` runs the same machinery but admits a request only
into an empty session, the one-request-at-a-time baseline.

Fine-tuning ingestion rides the same loop: ``submit_ingest`` queues an
``IngestRequest``, which runs (``SessionRuntime.ingest``) at the end of the
next ``step``, between decode dispatches. ``quality_metrics`` reports the
runtime's control-plane events beside the serving counters.

Pipelined admission (a runtime built with ``pipeline_stages=N`` over a
model axis): the admission prefill runs as GPipe microbatches of
``microbatch`` rows over the shard's group's devices
(``lm.pipeline_sched_prefill``), the admission width padded up to
``n_micro * microbatch`` (``admit_pad``; the pads are dropped rows);
``predicted_bubble()`` is the schedule's bubble fraction. On the card the
whole pipelined admission (the GPipe ticks over every stage's card, the
first-token sample, the scatter) is one CUDA-graph replay
(``prefill_graph.admit`` with ``pipe``), as the dense one is. The pipelined
prefill keeps the dense caches, so prefix reuse is off under it. Decode
stays on the group's tensor-parallel path.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import batch_plan
from repro_torch.core.cuda_graph import capturable
from repro_torch.models.blocks import ATTN_KINDS
from repro_torch.models.lm import (
    decode_step_,
    init_stacked_caches,
    layer_caches,
    pipeline_sched_prefill,
    sample_token,
    sched_prefill,
    sched_prefill_reuse,
)
from repro_torch.models.tp import run_devices

#: Sentinel batch row of an admission's padding entries: their prefill is
#: computed and dropped (only the admitted rows scatter into the live
#: batch), so padding an admission up to the bucket width never perturbs
#: live rows. They read the last row's slot and temperature.
_DROP_ROW = 1 << 30


@dataclasses.dataclass(eq=False)
class Request:
    """One in-flight generation request (the scheduler's future)."""

    rid: int
    tenant: Any                        # None -> base model
    prompt: np.ndarray                 # (len,) int32
    max_new: int
    temperature: float = 0.0
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: Terminal failure: the dispatch this request was admitted into raised.
    #: The request is ``done`` (it will never produce tokens) and ``result``
    #: re-raises the stored error.
    error: Optional[BaseException] = None

    def result(self) -> np.ndarray:
        if self.error is not None:
            raise RuntimeError(f"request {self.rid} failed in dispatch") from self.error
        if not self.done:
            raise RuntimeError(f"request {self.rid} still in flight")
        return np.asarray(self.tokens[: self.max_new], np.int32)

    @property
    def latency(self) -> float:
        if self.finished_at is None:
            raise RuntimeError(f"request {self.rid} still in flight")
        return self.finished_at - self.submitted_at


@dataclasses.dataclass(eq=False)
class IngestRequest:
    """Queued fine-tuning work, run at the next step boundary."""

    rid: int
    tenant: Any
    tokens: Any
    labels: Any
    logits: Optional[torch.Tensor] = None
    done: bool = False


# ---------------------------------------------------------------------------
# Dispatch bodies
# ---------------------------------------------------------------------------


def _temps(host: np.ndarray, device):
    """Per-row temperatures for ``sample_token``: 0.0 when every row is
    greedy (no draw at all), else a (B,) tensor."""
    return torch.as_tensor(host, dtype=torch.float32, device=device) if (host > 0).any() else 0.0


def _chunk_scan(params, cfg, use_kernel, fuse, chunk, pools, idx, caches, tok, pos, active, temps,
                generator, max_seq, loop=False):
    """``chunk`` decode steps over the live batch's stacked ``caches``,
    ``tok`` and ``pos``, updated in place: retired rows frozen, live
    positions clamped so a chunk overshooting a finishing row never writes
    past the cache. On the card one CUDA-graph replay
    (``decode_graph.chunk``), over a model group too, on one card or spread
    over several (``cuda_graph.capturable``); on the CPU or with ``loop``,
    the same steps eagerly. ``fuse``
    computes each step's skip term as dense per-row math instead of a grouped kernel
    launch. Returns (tok, pos, tokens sampled at each step (chunk, B)):
    each chunk hands back exactly the tokens the host has not seen."""
    if _graphed(params, tok, loop):
        from repro_torch.core import decode_graph

        toks = decode_graph.chunk(params, cfg, chunk, pools, idx, caches, tok, pos, active, temps, generator,
                                  max_seq, use_kernel=use_kernel, fuse=fuse)
        return tok, pos, toks
    from repro_torch.core.adapter_pool import grouped_plan

    plan = grouped_plan(pools, idx, use_kernel=use_kernel, fused=fuse)
    state = {"tok": tok, "pos": pos, "caches": layer_caches(caches)}
    toks = []
    for _ in range(chunk):
        decode_step_(params, cfg, state, active=active, max_seq=max_seq, temperature=temps,
                     generator=generator, pools=pools, idx=idx, use_kernel=use_kernel, fuse_skip=fuse,
                     plan=plan)
        toks.append(tok[:, 0].clone())
    return tok, pos, torch.stack(toks)


def _admit_scatter(logits, adm, rows, start_pos, caches, tok, pos, adm_temps, generator):
    """Sample each admitted row's first token, then scatter the first
    ``len(rows)`` admission rows' caches, tokens and positions into live
    rows ``rows`` (the padding rows behind them are dropped). Returns the
    first tokens (A, 1)."""
    tok0 = sample_token(logits, adm_temps, generator)
    k, p = rows.shape[0], adm["k"].shape[2]
    for n in ("k", "v"):
        caches[n][:, rows, :p] = adm[n][:, :k]
    tok[rows] = tok0[:k]
    pos[rows] = start_pos[:k]
    return tok0


def _dense_admission(params, cfg, use_kernel, pools, new_tokens, new_lens, new_idx, rows, caches, tok, pos,
                     adm_temps, generator, adm, plan=None):
    """The padded (A, P) prompts prefilled into the zeroed admission caches
    ``adm``, then the scatter: what one replay of the dense admission's
    graph runs (``prefill_graph.admit``). Returns the first tokens."""
    logits, _ = sched_prefill(params, cfg, new_tokens, new_lens, pools, new_idx, caches=layer_caches(adm),
                              use_kernel=use_kernel, plan=plan)
    return _admit_scatter(logits, adm, rows, new_lens.long(), caches, tok, pos, adm_temps, generator)


def _pipe_admission(params, cfg, pipe, pools, new_tokens, new_lens, new_idx, rows, caches, tok, pos, adm_temps,
                    generator, adm):
    """The padded (A, P) prompts prefilled as GPipe microbatches over the
    stages (``pipe``: stages, valid, devices, n_micro) into the zeroed
    admission caches ``adm`` (whole: the stages hold whole layers), then
    the scatter: what the eager pipelined admission and one replay of its
    graph (``prefill_graph.admit`` with ``pipe``) run. Returns the first
    tokens."""
    stages, valid, devices, n_micro = pipe
    logits, _ = pipeline_sched_prefill(params, cfg, stages, valid, new_tokens, new_lens, pools, new_idx,
                                       devices=devices, n_micro=n_micro, caches=layer_caches(adm))
    return _admit_scatter(logits, adm, rows, new_lens.long(), caches, tok, pos, adm_temps, generator)


def _reuse_admission(params, cfg, use_kernel, pools, pool_data, tables, tail_tokens, tail_lens, prefix_lens,
                     new_idx, rows, caches, tok, pos, adm_temps, generator, adm, plan=None):
    """The block tables gathered out of the pool into the zeroed admission
    caches ``adm`` (data movement: no forward FLOPs for the prefix), the
    (A, PT) tails prefilled, then the scatter: what one replay of the
    prefix-reuse admission's graph runs (``prefill_graph.admit_reuse``).
    Returns the first tokens."""
    from repro_torch.core.kv_pool import gather_blocks

    prefix = gather_blocks(pool_data, tables, use_kernel=use_kernel)
    span = prefix["k"].shape[2]
    for n in ("k", "v"):
        adm[n][:, :, :span] = prefix[n]
    logits, _ = sched_prefill_reuse(params, cfg, tail_tokens, tail_lens, prefix_lens, layer_caches(adm), pools,
                                    new_idx, use_kernel=use_kernel, plan=plan)
    return _admit_scatter(logits, adm, rows, (prefix_lens + tail_lens).long(), caches, tok, pos, adm_temps,
                          generator)


def _graphed(params, tok, loop) -> bool:
    """Whether a dispatch replays CUDA graphs: on the card unless ``loop``
    asks for eager steps (``_chunk_scan``'s test)."""
    return not loop and capturable(run_devices(params, tok))


def _sched_admit(params, cfg, how, chunk, max_seq, pools, idx, new_tokens, new_lens, new_idx, rows,
                 caches, tok, pos, active, temps, adm_temps, generator, pipe=None):
    """Dense admission: prefill the padded (A, P) prompts into fresh
    admission caches, sample the admitted rows' first tokens, scatter them
    into the live batch, then decode the chunk (``how``: ``_chunk_scan``'s
    use_kernel, fuse and loop). ``pipe`` (stages, valid, devices, n_micro)
    runs the prefill as GPipe microbatches (``_pipe_admission``). On the
    card the admission is one CUDA-graph replay (``prefill_graph.admit``)
    and the chunk another; on the CPU or with ``loop``, eager. Returns
    (tok, pos, toks, tok0 (A, 1))."""
    use_kernel, fuse, loop = how
    a, p = new_tokens.shape
    if _graphed(params, tok, loop):
        from repro_torch.core import prefill_graph

        tok0 = prefill_graph.admit(params, cfg, use_kernel, pools, new_tokens, new_lens, new_idx, rows, caches,
                                   tok, pos, adm_temps, generator, pipe=pipe)
    elif pipe is not None:
        # the pipeline's stages hold whole layers: their caches are whole too
        adm = init_stacked_caches(cfg, a, p, device=tok.device)
        tok0 = _pipe_admission(params, cfg, pipe, pools, new_tokens, new_lens, new_idx, rows, caches, tok, pos,
                               adm_temps, generator, adm)
    else:
        adm = init_stacked_caches(cfg, a, p, device=tok.device, params=params)
        tok0 = _dense_admission(params, cfg, use_kernel, pools, new_tokens, new_lens, new_idx, rows, caches, tok,
                                pos, adm_temps, generator, adm)
    tok, pos, toks = _chunk_scan(params, cfg, use_kernel, fuse, chunk, pools, idx, caches, tok, pos, active,
                                 temps, generator, max_seq, loop)
    return tok, pos, toks, tok0


def _sched_admit_reuse(params, cfg, how, chunk, max_seq, pools, idx, pool_data, tables, tail_tokens,
                       tail_lens, prefix_lens, new_idx, rows, caches, tok, pos, active, temps,
                       adm_temps, generator, *, prompt):
    """Prefix-reuse admission: every prompt of the wave matched >= 1 pooled
    block. Gather their block tables out of the pool into fresh (A, P)
    admission caches, prefill only the (A, PT) tails, sample and scatter
    as the dense admission does, then decode the chunk. On the card the
    admission is one CUDA-graph replay (``prefill_graph.admit_reuse``) and
    the chunk another; on the CPU or with ``loop`` (``how[2]``), eager."""
    use_kernel, fuse, loop = how
    if _graphed(params, tok, loop):
        from repro_torch.core import prefill_graph

        tok0 = prefill_graph.admit_reuse(params, cfg, use_kernel, pools, pool_data, tables, tail_tokens, tail_lens,
                                         prefix_lens, new_idx, rows, caches, tok, pos, adm_temps, generator,
                                         prompt=prompt)
    else:
        adm = init_stacked_caches(cfg, tables.shape[0], prompt, device=tok.device, params=params)
        tok0 = _reuse_admission(params, cfg, use_kernel, pools, pool_data, tables, tail_tokens, tail_lens,
                                prefix_lens, new_idx, rows, caches, tok, pos, adm_temps, generator, adm)
    tok, pos, toks = _chunk_scan(params, cfg, use_kernel, fuse, chunk, pools, idx, caches, tok, pos, active,
                                 temps, generator, max_seq, loop)
    return tok, pos, toks, tok0


# ---------------------------------------------------------------------------
# Live batch
# ---------------------------------------------------------------------------


class _LiveBatch:
    """One shard's resident decode state: device tensors (stacked caches
    (L, B, max_seq, n_kv, hd), split by heads or by sequence over the
    shard's model group when ``params`` is one, tok (B, 1), pos (B,)) plus host-side row
    bookkeeping. ``rows[i]`` is the request occupying batch row ``i`` (None
    = free)."""

    def __init__(self, cfg, max_batch: int, max_seq: int, device, params=None):
        self.caches = init_stacked_caches(cfg, max_batch, max_seq, device=device, params=params)
        self.tok = torch.zeros((max_batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((max_batch,), dtype=torch.long, device=device)
        self.rows: list[Optional[Request]] = [None] * max_batch
        self.active = np.zeros((max_batch,), bool)
        self.temps = np.zeros((max_batch,), np.float32)
        self.idx = np.zeros((max_batch,), np.int32)
        self.idx_version: Optional[int] = None
        #: Per-row prefix pin: ``(index, handle)`` while the row reuses
        #: pooled KV blocks, released when the row retires.
        self.blocks: list[Optional[tuple]] = [None] * max_batch

    def free_rows(self) -> list[int]:
        return [i for i, r in enumerate(self.rows) if r is None]

    def n_active(self) -> int:
        return int(self.active.sum())


class RequestScheduler:
    """Admission queue + continuous-batching event loop over a runtime.

    ``max_prompt`` is the single pad bucket every prompt is right-padded to;
    ``max_seq = max_prompt + max_new_cap`` sizes the live KV caches.
    ``inflight_per_tenant`` caps one tenant's simultaneous batch rows;
    ``admit_bucket`` is the (padded) admission width of one dispatch;
    ``chunk`` is how many decode steps each dispatch runs, one CUDA-graph
    replay on the card, after the admission's own replay (``loop=True``
    runs both as eager steps, what the replays are held against).
    ``prefix_reuse`` turns on the paged KV prefix cache; ``kv_block``
    overrides the default block size and
    ``kv_pool_blocks`` the pool's block count (default: enough for twice
    the live batch's prompts, at least 8). The skip-sums
    follow the runtime's ``use_kernel`` and ``decode_fuse``. The pool
    and index live on the runtime, so a later scheduler reuses what an
    earlier one published (``runtime.reset_prefix_cache()`` clears them).
    On a runtime built with ``pipeline_stages`` the admission prefill runs
    as GPipe microbatches of ``microbatch`` rows (default 1), one replay on
    the card as well, and ``prefix_reuse`` is off."""

    def __init__(
        self,
        runtime,
        *,
        max_batch: int = 8,
        max_prompt: int = 16,
        max_new_cap: int = 32,
        admit_bucket: int = 2,
        inflight_per_tenant: int = 2,
        chunk: int = 4,
        mode: str = "continuous",
        microbatch: int = 0,
        prefix_reuse: bool = True,
        kv_block: Optional[int] = None,
        kv_pool_blocks: Optional[int] = None,
        loop: bool = False,
    ):
        if mode not in ("continuous", "sequential"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        kinds = set(runtime.cfg.layer_kinds())
        if not kinds <= set(ATTN_KINDS):
            raise NotImplementedError(
                f"scheduler needs per-row decode positions, which only the attention cache "
                f"supports; config has {sorted(kinds)}"
            )
        if admit_bucket > max_batch:
            raise ValueError(f"admit_bucket {admit_bucket} > max_batch {max_batch}")
        self.rt = runtime
        self.max_batch = max_batch
        self.max_prompt = max_prompt
        self.max_new_cap = max_new_cap
        self.max_seq = max_prompt + max_new_cap
        self.admit_bucket = admit_bucket
        self.inflight_per_tenant = inflight_per_tenant
        self.chunk = chunk
        self.mode = mode
        # Pipelined admission: microbatches of ``microbatch`` rows, the
        # admission width padded to n_micro * microbatch (dropped rows); more
        # microbatches a dispatch, a smaller bubble (P-1)/(n_micro+P-1).
        self.pipeline = runtime.pipeline_stages > 1
        if self.pipeline:
            mb = int(microbatch) if microbatch else 1
            if mb < 1:
                raise ValueError(f"microbatch {microbatch} < 1")
            self.n_micro = -(-admit_bucket // mb)
            self.admit_pad = self.n_micro * mb
        elif microbatch:
            raise ValueError("microbatch is a pipelined-admission knob; the runtime was built without "
                             "pipeline_stages")
        else:
            self.admit_pad = admit_bucket
        # the pipelined prefill keeps the dense caches: no prefix reuse
        self.prefix_reuse = bool(prefix_reuse) and not self.pipeline
        self.kv_block = int(kv_block) if kv_block else None
        self.kv_pool_blocks = int(kv_pool_blocks) if kv_pool_blocks else None
        #: (use_kernel, fuse, loop) of every dispatch's skip-sums and chunk
        self._how = (runtime.use_kernel, runtime.decode_fuse, bool(loop))
        self.counters = Counter()
        self._pending: deque[Request] = deque()
        self._ingest_queue: deque[IngestRequest] = deque()
        self._completed: list[Request] = []
        self._batches: dict[int, _LiveBatch] = {}
        self._in_flight: Counter = Counter()
        self._next_rid = 0
        self._dispatches = 0

    def predicted_bubble(self) -> Optional[float]:
        """The GPipe bubble fraction the pipelined admission is scheduled at
        (None without pipelining)."""
        if not self.pipeline:
            return None
        from repro_torch.runtime.pipeline_par import bubble_fraction

        return bubble_fraction(self.n_micro, self.rt.pipeline_stages)

    # -- submission ----------------------------------------------------------

    def submit(self, tenant, prompt, *, max_new: int, temperature: float = 0.0) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or prompt.size > self.max_prompt:
            raise ValueError(f"prompt length {prompt.size} outside (0, {self.max_prompt}]")
        if not 0 < max_new <= self.max_new_cap:
            raise ValueError(f"max_new {max_new} outside (0, {self.max_new_cap}]")
        req = Request(
            rid=self._next_rid, tenant=tenant, prompt=prompt, max_new=max_new,
            temperature=float(temperature), submitted_at=time.perf_counter(),
        )
        self._next_rid += 1
        self._pending.append(req)
        self.counters["submitted"] += 1
        return req

    def submit_ingest(self, tenant, tokens, labels) -> IngestRequest:
        """Queue ``runtime.ingest(tenant, tokens, labels)`` for the next step
        boundary; the request's ``logits`` are set when it has run."""
        req = IngestRequest(rid=self._next_rid, tenant=tenant, tokens=tokens, labels=labels)
        self._next_rid += 1
        self._ingest_queue.append(req)
        return req

    def quality_metrics(self) -> dict:
        """The runtime's control-plane events (gate decisions, rollbacks,
        quarantines), shaped for the serving metrics beside latency. No
        ``gate`` section when the runtime has no control plane."""
        out: dict[str, Any] = {
            k.split("/", 1)[1]: int(v) for k, v in sorted(self.rt.counters.items()) if k.startswith("control/")
        }
        cm = self.rt.control_metrics()
        if cm is not None:
            out["gate"] = {k: cm[k] for k in ("accepted", "rejected", "quarantined", "rollbacks", "auto_rollbacks")}
            out["quarantined_tenants"] = cm["quarantined_tenants"]
        return out

    # -- shard routing -------------------------------------------------------

    def _shard_of(self, tenant) -> int:
        """A tenant with a pool slot decodes on its slot's shard; base
        traffic and tenants without a slot ride shard 0's zero slot."""
        pool = self.rt.pool
        return pool.shard_of(tenant) if tenant is not None and pool.has(tenant) else 0

    def _batch(self, shard: int) -> _LiveBatch:
        lb = self._batches.get(shard)
        if lb is None:
            with self.rt._on(shard):
                lb = self._batches[shard] = _LiveBatch(self.rt.cfg, self.max_batch, self.max_seq,
                                                       self.rt._shard_device[shard], self.rt._shard_params[shard])
        return lb

    @property
    def _lb(self) -> _LiveBatch:
        """Shard 0's live batch (a one-shard session's only one)."""
        return self._batch(0)

    def _refresh_idx(self, shard: int, lb: _LiveBatch) -> None:
        """Re-resolve occupied rows' pool slots when the shard's slot map
        changed (its ``version`` moved) or the occupancy did."""
        pool = self.rt.pool
        version = pool.shards[shard].version
        if lb.idx_version == version:
            return
        who = [r.tenant if r is not None and pool.has(r.tenant) else None for r in lb.rows]
        lb.idx = pool.lookup_local(shard, who).cpu().numpy()
        lb.idx_version = version

    # -- the event loop ------------------------------------------------------

    def step(self) -> int:
        """One scheduler tick: admit + dispatch on every shard with work,
        harvest the produced tokens after every dispatch is issued, and,
        when the harvest freed rows while requests wait, one follow-up
        admission wave on the shards with admissions; then run the queued
        ingest work. Returns the dispatches issued."""
        issued = [self._dispatch(shard, admits) for shard, admits in self._plan()]
        done0 = self.counters["completed"]
        for out in issued:
            self._harvest(*out)
        # Row recycle: rows released by this step's retirements are
        # admissible at once, not one step later.
        if self._pending and self.counters["completed"] > done0:
            extra = [self._dispatch(shard, admits) for shard, admits in self._plan() if admits]
            for out in extra:
                self._harvest(*out)
            if extra:
                self.counters["recycle_waves"] += 1
            issued += extra
        self._run_ingest()
        return len(issued)

    def _active(self) -> int:
        return sum(lb.n_active() for lb in self._batches.values())

    def drain(self) -> list[Request]:
        """Pump the loop until every queued request has completed; returns
        the requests completed during the drain, in completion order."""
        done0 = len(self._completed)
        while self._pending or self._ingest_queue or self._active():
            if self.step() == 0 and (self._pending or self._active()):   # step ran the ingest queue
                raise RuntimeError("scheduler stalled with queued work")
        return self._completed[done0:]

    def _run_ingest(self) -> None:
        while self._ingest_queue:
            req = self._ingest_queue.popleft()
            req.logits = self.rt.ingest(req.tenant, req.tokens, req.labels)
            req.done = True
            self.counters["ingested"] += 1

    def _plan(self) -> list[tuple[int, list[Request]]]:
        """Route the pending queue by shard and pick each shard's admissions
        under the fairness policy: (shard, admissions) for every shard with
        work ([] steps its live rows alone). Sequential mode admits one
        request at a time over the whole session, and only into an idle
        one."""
        pending = list(self._pending)
        if self.mode == "sequential":
            if self._active() == 0 and pending:
                return [(self._shard_of(pending[0].tenant), pending[:1])]
            return [(s, []) for s, lb in sorted(self._batches.items()) if lb.n_active()]
        by_shard: dict[int, list[Request]] = {}
        for r in pending:
            by_shard.setdefault(self._shard_of(r.tenant), []).append(r)
        plans = []
        for shard in sorted(set(by_shard) | {s for s, lb in self._batches.items() if lb.n_active()}):
            lb = self._batch(shard)
            queue = by_shard.get(shard, [])
            picks = batch_plan.plan_admissions(
                queue, self._in_flight, len(lb.free_rows()),
                cap=self.inflight_per_tenant, bucket=self.admit_bucket,
            )
            admits = [queue[i] for i in picks]
            if admits or lb.n_active():
                plans.append((shard, admits))
        return plans

    def _prefix_state(self, shard: int = 0):
        """(pool, index) of the shard's paged prefix cache on the runtime,
        built lazily. Disabled, ``(None, None)``, when no full block can ever
        be matched (a match is capped at ``(len - 1) // block`` so a tail
        token survives)."""
        from repro_torch.core import kv_pool as KV

        blk = self.kv_block or KV.get_default_block()
        if (self.max_prompt - 1) // blk < 1:
            return None, None
        n_blocks = self.kv_pool_blocks or max(8, 2 * self.max_batch * (self.max_prompt // blk))
        pool = self.rt.kv_pool(shard, block=blk, n_blocks=n_blocks)
        return pool, self.rt.prefix_index(shard)

    @torch.no_grad()
    def _dispatch(self, shard: int, admits: list[Request]):
        """One shard's dispatch, on its device. Returns (shard, [(request,
        row)] admitted, (tokens (chunk, B), first tokens or None))."""
        with self.rt._on(shard):
            return self._dispatch_on(shard, admits)

    def _dispatch_on(self, shard: int, admits: list[Request]):
        lb = self._batch(shard)
        dev = self.rt._shard_device[shard]
        matches = None
        pool = pidx = None
        if admits and self.prefix_reuse:
            pool, pidx = self._prefix_state(shard)
            if pidx is not None:
                m = [pidx.match(r.tenant, r.prompt) for r in admits]
                # One dispatch is one kind: split a mixed wave at the first
                # kind flip and take the longest same-kind FIFO prefix
                # (all-reuse or all-dense); the rest stay pending.
                want = bool(m[0])
                take = 1
                while take < len(admits) and bool(m[take]) == want:
                    take += 1
                if take < len(admits):
                    admits = admits[:take]
                    self.counters["prefix/wave_split"] += 1
                if want:
                    matches = m[:take]
        now = time.perf_counter()
        free = lb.free_rows()
        for req, row in zip(admits, free):
            self._pending.remove(req)
            lb.rows[row] = req
            lb.active[row] = True
            lb.temps[row] = req.temperature
            self._in_flight[req.tenant] += 1
            req.started_at = now
        lb.idx_version = None            # occupancy changed: re-resolve slots
        self._refresh_idx(shard, lb)
        generator = torch.Generator(device=dev).manual_seed((self.rt.seed << 32) + self._dispatches)
        self._dispatches += 1
        params, pools = self.rt._shard_params[shard], self.rt.pool.shard_pools(shard)
        idx = torch.as_tensor(lb.idx, device=dev)
        active = torch.as_tensor(lb.active, device=dev)
        temps = _temps(lb.temps, dev)
        if not admits:
            use_kernel, fuse, loop = self._how
            lb.tok, lb.pos, toks = _chunk_scan(
                params, self.rt.cfg, use_kernel, fuse, self.chunk, pools, idx, lb.caches, lb.tok, lb.pos,
                active, temps, generator, self.max_seq, loop,
            )
            self.counters["dispatch/step"] += 1
            return shard, [], (toks, None)
        a, p = self.admit_pad, self.max_prompt
        rows = free[: len(admits)]
        if matches is not None:
            return self._dispatch_reuse(shard, lb, admits, rows, matches, pool, pidx, params, pools, idx,
                                        active, temps, generator)
        new_tokens = np.zeros((a, p), np.int32)
        new_lens = np.ones((a,), np.int32)
        new_rows = np.full((a,), _DROP_ROW, np.int64)
        for j, (req, row) in enumerate(zip(admits, rows)):
            new_tokens[j, : req.prompt.size] = req.prompt
            new_lens[j] = req.prompt.size
            new_rows[j] = row
        pick = np.minimum(new_rows, self.max_batch - 1)
        try:
            lb.tok, lb.pos, toks, tok0 = _sched_admit(
                params, self.rt.cfg, self._how, self.chunk, self.max_seq, pools, idx,
                torch.as_tensor(new_tokens, device=dev), torch.as_tensor(new_lens, device=dev),
                torch.as_tensor(lb.idx[pick], device=dev), torch.as_tensor(rows, device=dev),
                lb.caches, lb.tok, lb.pos, active, temps, _temps(lb.temps[pick], dev), generator,
                pipe=(self.rt._stage_blocks[shard], self.rt._stage_valid[shard], self.rt._group(shard),
                      self.n_micro) if self.pipeline else None,
            )
        except Exception as err:
            self._abort_admits(lb, admits, rows, err)
            raise
        self.counters["dispatch/admit_pipe" if self.pipeline else "dispatch/admit"] += 1
        if pidx is not None:
            self._publish_rows(pool, pidx, lb, admits, rows)
            self.counters["prefix/misses"] += len(admits)
        return shard, list(zip(admits, rows)), (toks, tok0)

    def _dispatch_reuse(self, shard: int, lb: _LiveBatch, admits, rows, matches, pool, pidx, params, pools,
                        idx, active, temps, generator):
        """Reuse-wave dispatch: every admit matched >= 1 pooled block. Pin
        the matched blocks for the rows' lifetimes, then gather them into
        the admission caches and prefill only the tails."""
        dev = self.rt._shard_device[shard]
        a, p = self.admit_pad, self.max_prompt
        blk = pool.block
        nbs = [len(ids) for ids in matches]
        max_nb = max(nbs)
        tails = [r.prompt.size - nb * blk for r, nb in zip(admits, nbs)]
        # Tail pad bucket: block-quantised, never above the prompt bucket.
        pt = min(p, -(-max(tails) // blk) * blk)
        tables = np.zeros((a, max_nb), np.int32)
        tail_tokens = np.zeros((a, pt), np.int32)
        tail_lens = np.ones((a,), np.int32)
        prefix_lens = np.zeros((a,), np.int32)
        new_rows = np.full((a,), _DROP_ROW, np.int64)
        for j, (req, row, ids) in enumerate(zip(admits, rows, matches)):
            nb = len(ids)
            # Rows with nb < max_nb pad their table with block 0, any valid
            # id: the padded key positions are >= the row's own length,
            # masked in the tail prefill and overwritten by decode.
            tables[j, :nb] = ids
            plen = nb * blk
            t = req.prompt[plen:]
            tail_tokens[j, : t.size] = t
            tail_lens[j] = t.size
            prefix_lens[j] = plen
            new_rows[j] = row
            lb.blocks[row] = (pidx, pidx.acquire(ids))
            self.counters["prefix/blocks_reused"] += nb
            self.counters["prefix/tokens_reused"] += plen
        self.counters["prefix/hits"] += len(admits)
        pick = np.minimum(new_rows, self.max_batch - 1)
        try:
            lb.tok, lb.pos, toks, tok0 = _sched_admit_reuse(
                params, self.rt.cfg, self._how, self.chunk, self.max_seq, pools, idx, pool.data,
                torch.as_tensor(tables, device=dev), torch.as_tensor(tail_tokens, device=dev),
                torch.as_tensor(tail_lens, device=dev), torch.as_tensor(prefix_lens, device=dev),
                torch.as_tensor(lb.idx[pick], device=dev), torch.as_tensor(rows, device=dev),
                lb.caches, lb.tok, lb.pos, active, temps, _temps(lb.temps[pick], dev), generator,
                prompt=p,
            )
        except Exception as err:
            self._abort_admits(lb, admits, rows, err)
            raise
        self.counters["dispatch/admit_reuse"] += 1
        return shard, list(zip(admits, rows)), (toks, tok0)

    def _publish_rows(self, pool, pidx, lb: _LiveBatch, admits, rows) -> None:
        """After a dense admission, index the wave's full prompt blocks and
        publish their freshly prefilled K/V out of the live rows into the
        pool (``floor(len / block)`` blocks a prompt; only newly created
        radix nodes copy)."""
        for req, row in zip(admits, rows):
            created = pidx.insert(req.tenant, req.prompt)
            if created:
                pool.publish(lb.caches, row, [bid for bid, _ in created],
                             [slot for _, slot in created])
                self.counters["prefix/published_blocks"] += len(created)

    def _release_blocks(self, lb: _LiveBatch, row: int) -> None:
        handle = lb.blocks[row]
        if handle is not None:
            lb.blocks[row] = None
            pidx, h = handle
            pidx.release(h)

    def prefix_metrics(self) -> dict:
        """Prefix-reuse counters plus each shard's pool occupancy, keyed by
        shard. After a drain every held block belongs to exactly one radix
        node, so ``refs_total == held == nodes``
        (``SessionRuntime.check_prefix_no_leaks``)."""
        out: dict[str, Any] = {
            k.split("/", 1)[1]: int(v)
            for k, v in sorted(self.counters.items())
            if k.startswith("prefix/")
        }
        indexes = self.rt._prefix_indexes
        out["pools"] = {
            str(s): {
                "block": p.block,
                "n_blocks": p.n_blocks,
                "free": p.n_free(),
                "held": int((p.refs > 0).sum()),
                "refs_total": int(p.refs.sum()),
                "nodes": indexes[s].n_nodes() if s in indexes else 0,
            }
            for s, p in sorted(self.rt._kv_pools.items())
        }
        return out

    def _abort_admits(self, lb: _LiveBatch, admits, rows, err) -> None:
        """Unwind a failed dispatch's admissions: the rows just claimed go
        back to the free list and each admitted tenant's in-flight count
        comes back down (else one raising dispatch leaks batch rows and pins
        the tenant at its cap). The requests fail terminally (``error`` set;
        ``result()`` re-raises), not re-queued: the caller sees the raise and
        owns the retry policy."""
        now = time.perf_counter()
        for req, row in zip(admits, rows):
            self._release_blocks(lb, row)
            lb.rows[row] = None
            lb.active[row] = False
            self._in_flight[req.tenant] -= 1
            if self._in_flight[req.tenant] <= 0:
                del self._in_flight[req.tenant]
            req.done = True
            req.error = err
            req.finished_at = now
            self.counters["failed"] += 1
        lb.idx_version = None

    def _harvest(self, shard: int, admitted, out) -> None:
        lb = self._batch(shard)
        toks, tok0 = out
        toks = toks.cpu().numpy()                    # (chunk, B): the sync point
        if tok0 is not None:
            tok0 = tok0.cpu().numpy()                # (bucket, 1)
            for j, (req, _) in enumerate(admitted):
                req.tokens.append(int(tok0[j, 0]))
        for row, req in enumerate(lb.rows):
            if req is None or not lb.active[row]:
                continue
            need = req.max_new - len(req.tokens)
            req.tokens.extend(int(t) for t in toks[: max(need, 0), row])
            if len(req.tokens) >= req.max_new:
                self._finish(lb, row, req)
        self.counters["steps"] += self.chunk

    def _finish(self, lb: _LiveBatch, row: int, req: Request) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        self._release_blocks(lb, row)
        lb.rows[row] = None
        lb.active[row] = False
        self._in_flight[req.tenant] -= 1
        if self._in_flight[req.tenant] <= 0:
            del self._in_flight[req.tenant]
        self._completed.append(req)
        self.counters["completed"] += 1
        self.counters["tokens"] += req.max_new
