"""CUDA graphs of the serving prefills, the session's ingest and the
scheduler's admissions: one replay a call.

The reference runs each of these calls as one compiled program through its
compiled-function cache (``repro.core.runtime.compiled``): the prefill
(``_prefill_fn``), the grouped prefill (``_prefill_grouped_fn``), the
session's ingest (``_ingest_fn``) and the scheduler's dense, pipelined and
prefix-reuse admissions (``repro.core.scheduler._sched_admit_fn``,
``_sched_admit_pipe_fn``, ``_sched_admit_reuse_fn``). On the card each
becomes a CUDA-graph replay, captured through ``decode_graph``'s entries
(``decode_graph._Entry``) with one step a call:

  - a key's first call runs the call eagerly on a side stream of every card
    it reaches, as the warm-up, and its result is the call's;
  - its second call captures the call and replays it, and every later call
    replays it. A shape seen once never pays a capture.

The calls:

  - ``prefill``: ``lm.serve_prefill`` (an adapters stack or none) or, with
    ``pools``, ``lm.serve_prefill_grouped``. Tokens, slot index and grouping
    plan are copied into buffers of the entry; its serve caches are its own,
    made fresh inside the graph as ``lm.init_serve_caches`` makes them
    (zeroed, or copied from a fresh set where a recurrent state starts
    non-zero), so no position left by the last replay differs from the
    eager path's. They are handed out and stay valid until the entry's next
    call: ``runtime.generate`` and ``generate_grouped`` hand them at once to
    the decode, which copies them into its own buffers.
  - ``ingest``: ``lm.ingest_prefill`` and ``lm_skiplora._encode_acts``. The
    logits are handed out as a copy; the encoded rows and ``y_base`` as the
    entry's buffers, which ``SessionRuntime.ingest`` writes into its cache
    engine (a copy on either tier) before anything else runs.
  - ``admit``: the scheduler's dense admission: ``lm.sched_prefill`` into
    admission caches of the entry's own, zeroed inside the graph as
    ``lm.init_stacked_caches`` makes them, the first token sampled at the
    admitted rows' temperatures and the scatter of the first ``k`` rows'
    caches, tokens and positions into the live batch
    (``scheduler._dense_admission``).
  - ``admit`` with ``pipe`` (stages, valid, devices, n_micro), the
    pipelined admission of a runtime built with ``pipeline_stages``:
    ``lm.pipeline_sched_prefill``'s GPipe ticks over the stages' cards into
    whole admission caches of the entry's own (the stages hold whole
    layers), then the same draw and scatter
    (``scheduler._pipe_admission``). Its first call, eager on a side stream
    of every card, makes each cross-card copy of the ticks (the stages'
    adapter rows, the handoffs, the far stage's K/V) once before the
    capture, which must not be the first to enable peer access.
  - ``admit_reuse``: the prefix-reuse admission: ``kv_pool.gather_blocks``
    (K10 on the card), the prefix written into the admission caches,
    ``lm.sched_prefill_reuse`` and the same scatter
    (``scheduler._reuse_admission``).

After any admission the chunk's decode steps run as the
``decode_graph.chunk`` replay: an admission dispatch is two replays where
the reference's is one program.

Keys, as the reference's jit keys its programs, plus the storage (pointer,
shape, strides, dtype, device: ``cuda_graph.storage_sig``) of every tensor
of the caller's that a graph reads or writes in place:

  - prefill: the config, (B, S), the cache length, and the storage of the
    params and the adapters; grouped, also ``use_kernel``, the slot index's
    dtype and the storage of the pools;
  - ingest: as the grouped prefill, with the cache mode instead of a cache
    length;
  - admit: (A, P), the number ``k`` of admitted rows, the admitted rows'
    temperature kind (``decode_graph._temp_kind``: greedy draws nothing,
    per-row temperatures a static (A,) buffer), ``use_kernel``, and the
    storage of the params, the pools and the live batch's caches, token and
    position. The reference pads the scatter to the bucket and drops the
    padding rows (``mode="drop"``); here the graph scatters exactly the
    first ``k`` rows, so no index repeats. The live batch's temperatures
    are read only by the chunk, whose own entry keys them;
  - admit_pipe: as admit, plus ``n_micro``, the storage of the stage split
    (the runtime's ``_stage_blocks[shard]``), the ``valid`` mask as a host
    tuple (read once a call, on the CPU, where the runtime keeps it) and the
    stage devices; the entry spans the run devices and every stage's card;
  - admit_reuse: as admit, plus the tail bucket ``PT``, the table width
    ``max_nb`` and the storage of the paged pool.

The entries live in ``GRAPHS``, a ``GraphCache`` of their own beside
``decode_graph.GRAPHS`` (its stats: hits, misses, evictions, captures,
replays, eager first calls, and their host seconds). The eager paths
(``runtime.generate_loop``, ``RequestScheduler(loop=True)``,
``lm.ingest_prefill`` called directly) are what the replays are held
against, bitwise. A capture that fails raises ``GraphCaptureError`` naming
the call; nothing falls back to an eager call.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.adapter_pool import grouped_plan
from repro_torch.core.cuda_graph import GraphCache, storage_sig
from repro_torch.core.decode_graph import _Entry, _generator, _load_plan, _temp_kind
from repro_torch.models import lm as LM
from repro_torch.models import tp as TP

__all__ = ["CAPACITY", "GRAPHS", "admit", "admit_reuse", "ingest", "prefill"]

#: Entries the prefill cache keeps. A scheduler holds one dense (or
#: pipelined) key for each number of admitted rows (at most the admission
#: bucket) and one reuse key for each (tail bucket, table width, rows) its
#: waves meet, while its chunk entry stays in ``decode_graph.GRAPHS``; a
#: serving session adds one prefill key a batch shape and pool, and an
#: ingest key a shard. The scheduler cell (bucket 2, one tail bucket and
#: table width) uses two; 16 leaves room for a bucket of 4 over several
#: tail buckets beside the serving and ingest keys, so that no admission
#: evicts another in a run (an evicted key pays its eager first call and
#: capture again).
CAPACITY = 16

#: the graphs of the prefills, ingests and admissions
GRAPHS = GraphCache(CAPACITY)


def _nothing(at: int, n: int) -> None:
    pass


def _zero(t) -> bool:
    """Whether a freshly made cache leaf (tensor or ``tp.HeadSplit``) is
    all zeros (a host read, once, when an entry is made)."""
    parts = t.parts if isinstance(t, TP.HeadSplit) else [t]
    return not any(bool(p.any()) for p in parts)


class _Call(_Entry):
    """One call's entry: ``body`` runs the call once over the entry's
    buffers and the live call's tensors (``self.live``), and keeps each
    output in ``self.out`` (``_keep``)."""

    def __init__(self, stats, what, device, sampling, devices):
        super().__init__(stats, what, device, sampling, devices)
        self.out: dict[str, torch.Tensor] = {}

    def _keep(self, name: str, t: torch.Tensor) -> None:
        """Output ``name``: the warm-up's own tensor, then copied into it."""
        buf = self.out.get(name)
        if buf is None:
            self.out[name] = t
        else:
            buf.copy_(t)

    def call(self, live, generator: Optional[torch.Generator] = None) -> None:
        first = not self._warm
        self.live = live
        try:
            self.run(1, 1, _nothing, generator)
        finally:
            self.live = None
        if first:
            # the warm-up made its outputs on its side stream: the buffers
            # every later call copies into are the current stream's
            self.out = {k: v.clone() for k, v in self.out.items()}

    def free(self) -> None:
        super().free()
        self.out = {}


class _Prefill(_Call):
    """``prefill``'s entry: tokens, slot index, plan and serve caches of its
    own (with the fresh values of the caches' non-zero leaves)."""

    def __init__(self, stats, cfg, tokens, max_seq, *, params, pools, idx, use_kernel, devices):
        dev = tokens.device
        b, s = tokens.shape
        kind = "grouped prefill" if pools is not None else "prefill"
        super().__init__(stats, f"the {kind} ({cfg.name}, {b}x{s})", dev, False, devices)
        self.cfg, self.use_kernel = cfg, use_kernel
        self.tokens = torch.zeros_like(tokens)
        fresh = LM.init_serve_caches(cfg, b, max_seq, device=dev, params=params)
        self.caches = [{n: TP.zeros_like(t) for n, t in c.items()} for c in fresh]
        self.fresh = [{n: None if _zero(t) else t for n, t in c.items()} for c in fresh]
        self.idx = torch.zeros_like(idx) if pools is not None else None
        self.plan = grouped_plan(pools, self.idx, use_kernel=use_kernel)

    def body(self, n, generator):
        params, adapters, pools = self.live
        for mine, fresh in zip(self.caches, self.fresh):
            for name, t in mine.items():
                if fresh[name] is None:
                    t.zero_()
                else:
                    t.copy_(fresh[name])
        if pools is None:
            logits, _ = LM.serve_prefill(params, self.cfg, self.tokens, self.caches, adapters=adapters)
        else:
            logits, _ = LM.serve_prefill_grouped(params, self.cfg, self.tokens, self.caches, pools, self.idx,
                                                 use_kernel=self.use_kernel, plan=self.plan)
        self._keep("logits", logits)


def prefill_key(params, cfg, tokens, max_seq: int, *, adapters=None, pools=None, idx=None,
                use_kernel: bool = True) -> tuple:
    """The key of ``prefill``'s entry for these arguments."""
    grouped = pools is not None
    return ("prefill_grouped" if grouped else "prefill", cfg, tuple(tokens.shape), tokens.dtype, max_seq,
            use_kernel if grouped else None, idx.dtype if grouped else None, storage_sig(params),
            storage_sig(adapters), storage_sig(pools))


def prefill(params, cfg, tokens: torch.Tensor, max_seq: int, *, adapters=None, pools=None, idx=None,
            use_kernel: bool = True, graphs: Optional[GraphCache] = None):
    """``lm.serve_prefill`` (``pools`` None) or ``lm.serve_prefill_grouped``
    on the card, into serve caches of ``max_seq`` positions. Returns (the
    last-position logits, a new tensor; the caches, the entry's own: valid
    until its next call)."""
    graphs = GRAPHS if graphs is None else graphs
    key = prefill_key(params, cfg, tokens, max_seq, adapters=adapters, pools=pools, idx=idx,
                      use_kernel=use_kernel)
    e = graphs.entry(key, lambda: _Prefill(graphs.stats, cfg, tokens, max_seq, params=params, pools=pools,
                                           idx=idx, use_kernel=use_kernel,
                                           devices=TP.run_devices(params, tokens)))
    e.tokens.copy_(tokens)
    if e.idx is not None:
        e.idx.copy_(idx)
        _load_plan(e.plan, pools, e.idx)
    e.call((params, adapters, pools))
    return e.out["logits"].clone(), e.caches


class _Ingest(_Call):
    """``ingest``'s entry: tokens, slot index and plan of its own; outputs
    the logits, ``y_base`` and the encoded cache rows."""

    def __init__(self, stats, cfg, sl, tokens, *, pools, idx, use_kernel, devices):
        b, s = tokens.shape
        super().__init__(stats, f"the ingest forward ({cfg.name}, {b}x{s})", tokens.device, False, devices)
        self.cfg, self.sl, self.use_kernel = cfg, sl, use_kernel
        self.tokens = torch.zeros_like(tokens)
        self.idx = torch.zeros_like(idx) if pools is not None else None
        self.plan = grouped_plan(pools, self.idx, use_kernel=use_kernel)

    def body(self, n, generator):
        from repro_torch.core.lm_skiplora import _encode_acts

        params, pools = self.live
        logits, acts, y_base = LM.ingest_prefill(params, self.cfg, self.tokens, pools, self.idx,
                                                 use_kernel=self.use_kernel, plan=self.plan)
        self._keep("logits", logits)
        self._keep("y_base", y_base)
        for name, t in _encode_acts(acts, None, self.sl).items():
            self._keep(name, t)


def ingest_key(params, cfg, sl, tokens, pools=None, idx=None, *, use_kernel: bool = True) -> tuple:
    """The key of ``ingest``'s entry for these arguments."""
    return ("ingest", cfg, sl.mode, tuple(tokens.shape), tokens.dtype, use_kernel,
            None if idx is None else idx.dtype, pools is None, storage_sig(params), storage_sig(pools))


def ingest(params, cfg, sl, tokens: torch.Tensor, pools=None, idx=None, *, use_kernel: bool = True,
           graphs: Optional[GraphCache] = None):
    """``lm.ingest_prefill`` and ``lm_skiplora._encode_acts(acts, None,
    sl)`` on the card. Returns (the last-position logits, a new tensor;
    the encoded rows {name: (B, ...)} and ``y_base`` (B, S, D), the entry's
    buffers: valid until its next call)."""
    graphs = GRAPHS if graphs is None else graphs
    key = ingest_key(params, cfg, sl, tokens, pools, idx, use_kernel=use_kernel)
    e = graphs.entry(key, lambda: _Ingest(graphs.stats, cfg, sl, tokens, pools=pools, idx=idx,
                                          use_kernel=use_kernel, devices=TP.run_devices(params, tokens)))
    e.tokens.copy_(tokens)
    if e.idx is not None:
        e.idx.copy_(idx)
        _load_plan(e.plan, pools, e.idx)
    e.call((params, pools))
    values = {k: v for k, v in e.out.items() if k not in ("logits", "y_base")}
    return e.out["logits"].clone(), values, e.out["y_base"]


class _Admit(_Call):
    """An admission's entry: its inputs copied into buffers of its own
    (``self.args``), admission caches of its own, the plan; outputs the
    admitted rows' first tokens. ``reuse``: the prefix-reuse admission;
    ``pipe`` (stages, valid, devices, n_micro): the pipelined one, its
    caches whole and its ``valid`` mask kept on the host."""

    def __init__(self, stats, cfg, use_kernel, args: dict, adm_temps, prompt: int, *, params, pools, reuse,
                 devices, pipe=None):
        dev = args["new_idx"].device
        a = args["new_idx"].shape[0]
        kind = "prefix-reuse admission" if reuse else "pipelined admission" if pipe else "admission"
        super().__init__(stats, f"the scheduler's {kind} ({cfg.name}, {a}x{prompt}, {args['rows'].shape[0]} "
                         f"rows)", dev, _temp_kind(adm_temps)[0] != "greedy", devices)
        self.cfg, self.use_kernel, self.reuse = cfg, use_kernel, reuse
        self.pipe = None
        if pipe is not None:
            stages, valid, stage_devices, n_micro = pipe
            self.pipe = (stages, torch.tensor(_host_mask(valid)), stage_devices, n_micro)
        self.args = {n: torch.zeros_like(t) for n, t in args.items()}
        self.temps = torch.zeros_like(adm_temps) if isinstance(adm_temps, torch.Tensor) else adm_temps
        self.adm = LM.init_stacked_caches(cfg, a, prompt, device=dev, params=None if pipe else params)
        # the pipelined prefill's skip terms take no grouping plan
        self.plan = None if pipe else grouped_plan(pools, self.args["new_idx"], use_kernel=use_kernel)

    def body(self, n, generator):
        from repro_torch.core import scheduler as S

        params, pools, pool_data, caches, tok, pos = self.live
        for t in self.adm.values():
            t.zero_()
        a = self.args
        if self.reuse:
            tok0 = S._reuse_admission(params, self.cfg, self.use_kernel, pools, pool_data, a["tables"],
                                      a["tail_tokens"], a["tail_lens"], a["prefix_lens"], a["new_idx"], a["rows"],
                                      caches, tok, pos, self.temps, generator, self.adm, plan=self.plan)
        elif self.pipe is not None:
            tok0 = S._pipe_admission(params, self.cfg, self.pipe, pools, a["new_tokens"], a["new_lens"],
                                     a["new_idx"], a["rows"], caches, tok, pos, self.temps, generator, self.adm)
        else:
            tok0 = S._dense_admission(params, self.cfg, self.use_kernel, pools, a["new_tokens"], a["new_lens"],
                                      a["new_idx"], a["rows"], caches, tok, pos, self.temps, generator, self.adm,
                                      plan=self.plan)
        self._keep("tok0", tok0)


def _host_mask(valid) -> tuple:
    """A stage split's ``valid`` mask (n_stages, per) as nested tuples of
    bools, read on the host."""
    return tuple(tuple(bool(v) for v in row) for row in valid.tolist())


def _pipe_sig(pipe) -> Optional[tuple]:
    """What keys a pipelined admission beyond a dense one: ``n_micro``, the
    stage split's storage, its ``valid`` mask and the stage devices."""
    if pipe is None:
        return None
    stages, valid, devices, n_micro = pipe
    return n_micro, storage_sig(stages), _host_mask(valid), tuple(torch.device(d) for d in devices)


def admit_key(params, cfg, use_kernel: bool, pools, args: dict, adm_temps, caches, tok, pos, *,
              prompt: int, pool_data=None, pipe=None) -> tuple:
    """The key of an admission's entry: ``args`` its input tensors by name
    (the shapes give (A, P), ``k`` = len(rows), and for a reuse admission
    (A, PT) and (A, max_nb)), ``pool_data`` the paged pool of a reuse
    admission, ``pipe`` the stages of a pipelined one."""
    kind = "admit_reuse" if pool_data is not None else "admit_pipe" if pipe is not None else "admit"
    return (kind, cfg, prompt, use_kernel, tuple((n, tuple(t.shape), t.dtype) for n, t in args.items()),
            _temp_kind(adm_temps), storage_sig(params), storage_sig(pools), storage_sig(pool_data),
            storage_sig(caches), storage_sig(tok), storage_sig(pos), _pipe_sig(pipe))


def _admit(params, cfg, use_kernel, pools, args, caches, tok, pos, adm_temps, generator, prompt, pool_data,
           graphs, pipe=None):
    graphs = GRAPHS if graphs is None else graphs
    reuse = pool_data is not None
    key = admit_key(params, cfg, use_kernel, pools, args, adm_temps, caches, tok, pos, prompt=prompt,
                    pool_data=pool_data, pipe=pipe)
    # a pipelined admission spans every stage's card too
    devices = TP.run_devices(params, tok) + ([torch.device(d) for d in pipe[2]] if pipe is not None else [])
    e = graphs.entry(key, lambda: _Admit(graphs.stats, cfg, use_kernel, args, adm_temps, prompt, params=params,
                                         pools=pools, reuse=reuse, devices=devices, pipe=pipe))
    for n, t in args.items():
        e.args[n].copy_(t)
    _load_plan(e.plan, pools, e.args["new_idx"])
    if isinstance(adm_temps, torch.Tensor):
        e.temps.copy_(adm_temps)
    e.call((params, pools, pool_data, caches, tok, pos), _generator(generator, tok.device))
    return e.out["tok0"].clone()


def admit(params, cfg, use_kernel: bool, pools, new_tokens, new_lens, new_idx, rows, caches, tok, pos, adm_temps,
          generator, *, pipe=None, graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """The scheduler's dense admission on the card, one replay: the (A, P)
    prefill, the first tokens of the admitted rows drawn from ``generator``
    (advanced as the eager draw advances it) and the scatter of the first
    ``len(rows)`` rows into the live batch's ``caches``, ``tok`` and
    ``pos`` (in place). With ``pipe`` (stages, valid, devices, n_micro) the
    prefill runs as GPipe microbatches over the stages, as the pipelined
    admission's eager path does. Returns the first tokens (A, 1), a new
    tensor."""
    args = dict(new_tokens=new_tokens, new_lens=new_lens, new_idx=new_idx, rows=rows)
    return _admit(params, cfg, use_kernel, pools, args, caches, tok, pos, adm_temps, generator,
                  new_tokens.shape[1], None, graphs, pipe)


def admit_reuse(params, cfg, use_kernel: bool, pools, pool_data, tables, tail_tokens, tail_lens, prefix_lens,
                new_idx, rows, caches, tok, pos, adm_temps, generator, *, prompt: int,
                graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """The scheduler's prefix-reuse admission on the card, one replay: the
    gather of ``tables`` out of the paged pool ``pool_data`` into (A,
    ``prompt``) admission caches, the (A, PT) tail prefill, and the draw and
    scatter of ``admit``. Returns the first tokens (A, 1), a new tensor."""
    args = dict(tables=tables, tail_tokens=tail_tokens, tail_lens=tail_lens, prefix_lens=prefix_lens,
                new_idx=new_idx, rows=rows)
    return _admit(params, cfg, use_kernel, pools, args, caches, tok, pos, adm_temps, generator, prompt,
                  pool_data, graphs)
