"""CUDA graphs of the decode: one replay for ``unroll`` decode steps.

The reference runs a whole generation as one ``lax.scan`` dispatch
(``repro.models.lm.decode_scan``) and each scheduler chunk as one jitted
scan (``repro.core.scheduler._chunk_scan``). Eager steps on the card are
host-bound: Python launches one short kernel at a time. A CUDA graph is the
card's form of that one dispatch. This module captures ``lm.decode_step_``,
the in-place step over static buffers, into ``torch.cuda.CUDAGraph``s and
replays them:

  - ``decode``: ``lm.decode_scan`` on CUDA tensors. Graphs of ``unroll``
    steps over buffers the entry owns (token, 0-d position, slot index,
    grouping plan, per-row temperatures, serve caches: KV caches and, for
    recurrent blocks, their states, which the forward writes in place). A
    call copies the prefill's caches, ``tok0`` and the start position in,
    replays the ``unroll``-step graph ``max_new // unroll`` times and a
    graph of the remaining ``max_new % unroll`` steps once, and copies the
    caches back.
  - ``chunk``: the request scheduler's ``chunk`` steps, over the live
    batch's resident caches, token and position, with the slot index, the
    live-row mask, the temperatures and the plan copied into static buffers.

What fixes a graph keys it: the config, the kind of call, the shapes, the
temperature (greedy, one value, or per row), ``use_kernel``, ``fuse_skip``,
``unroll`` and the data pointer, shape and dtype of every tensor of the
caller's that the graph reads (params, adapters, pool, and the scheduler's
live-batch buffers). A hit therefore replays over exactly the caller's
tensors, and a reallocated pool recaptures instead of reading freed memory.
``GraphCache`` keeps the ``capacity`` most recently used entries and frees
an evicted entry's graphs and their private memory pool.

A backbone split over a model group (``tp.GroupParams``) is captured the
same way (``cuda_graph.capturable``): the entry's caches are twins of the
split caches (``tp.HeadSplit.zeros_like``: each part on its member's
device, the same ranges and axis; a cache kept whole stays a tensor), and
the key holds every member's storage. Members that share the home card run
one after the other on the capture stream; members on other cards run on
a capture stream of their card, forked from the home one and joined back
(``cuda_graph.capture(devices=)``), their allocations in a pool the entry
keeps on each such card, and every replay is ordered with those cards'
eager work (``cuda_graph.across``).

The first call of an entry runs its first step eagerly on a side stream of
every card the step reaches, as the warm-up: the kernel libraries load and
``cudaFuncSetAttribute`` runs outside the capture. That step is one of the
call's own, so every call executes exactly its steps. A capture that fails
raises ``GraphCaptureError`` naming the step and the CUDA error; nothing
falls back to eager steps.

Launch accounting: the kernel wrappers count their launches in Python
(``KernelLib.launch``, ``kernel.ROW_LAUNCHES``), which a replay does not
run. ``LaunchTape`` (``core.cuda_graph``, re-exported here) takes back what
a capture counted (a capture executes nothing) and adds it again at every
replay, so the counters keep counting launches executed.

Sampling: a graph that samples draws from a ``torch.Generator`` registered
with it. A call sets that generator to the caller's generator state before
each replay and hands the advanced state back, so the draws are the eager
steps' draws.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Optional

import torch

from repro_torch.core.adapter_pool import grouped_plan
from repro_torch.core.cuda_graph import (CardPools, GraphCache, GraphCaptureError, LaunchTape, across, capture,
                                        on_side_stream, other_cards, storage_sig)
from repro_torch.kernels.skip_lora.ops import plan_tile
from repro_torch.models import lm as LM
from repro_torch.models import tp as TP

__all__ = ["GRAPHS", "GraphCache", "GraphCaptureError", "LaunchTape", "chunk", "decode", "segments"]


def segments(steps: int, unroll: int) -> list[int]:
    """The graph lengths that ``steps`` decode steps replay, ``unroll`` a
    replay: ``steps // unroll`` full graphs, then one of the remainder."""
    full, rest = divmod(steps, unroll)
    return [unroll] * full + ([rest] if rest else [])


def _temp_kind(temperature) -> tuple:
    """Greedy, one value (baked into the graph, as the eager step divides by
    the Python float) or per-row (a static (B,) buffer)."""
    if isinstance(temperature, torch.Tensor):
        return ("rows", temperature.dtype)
    return ("greedy",) if temperature <= 0 else ("value", float(temperature))


class _Entry:
    """One cache entry: the static buffers of a decode call or a scheduler
    chunk, and its graphs, one per number of steps, sharing one memory
    pool on the home card and one on each other card of ``devices`` (the
    call's run devices, ``tp.run_devices``). ``body(n, generator)`` runs
    ``n`` steps over the buffers and the live call's tensors
    (``self.live``)."""

    def __init__(self, stats: Counter, what: str, device: torch.device, sampling: bool, devices=()):
        # the cache's stats, not the cache: an entry that pointed back at its
        # cache would free its graphs only in the cycle collector, which may
        # run inside another capture
        self.stats, self.what, self.device, self.sampling = stats, what, device, sampling
        self.devices = list(devices)
        self.live: Any = None
        self._graphs: dict[int, tuple[torch.cuda.CUDAGraph, LaunchTape, Optional[torch.Generator]]] = {}
        self._pool = None
        self._pools = CardPools(device)
        self._warm = False

    def body(self, n: int, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def run(self, steps: int, unroll: int, emit: Callable[[int, int], None], generator) -> None:
        """``steps`` decode steps: on a fresh entry the first eagerly on a
        side stream (the warm-up), the rest as replays; ``emit(at, n)``
        after each segment takes its ``n`` tokens out as steps ``at...``.
        Captures and replays run with the entry's device current."""
        with torch.cuda.device(self.device):
            self._run(steps, unroll, emit, generator)

    def _run(self, steps, unroll, emit, generator) -> None:
        state = generator.get_state() if self.sampling else None
        done = 0
        cards = other_cards(self.devices, torch.cuda.current_device())
        if not self._warm and steps:
            state = self._eager(state, cards)
            emit(0, 1)
            done, self._warm = 1, True
        with across(cards):
            for n in segments(steps - done, unroll):
                graph, tape, gen = self._graph(n)
                if gen is not None:
                    gen.set_state(state)
                t0 = time.perf_counter()
                graph.replay()
                self.stats["replay_s"] += time.perf_counter() - t0
                if gen is not None:
                    state = gen.get_state()
                tape.replayed()
                self.stats["replays"] += 1
                emit(done, n)
                done += n
        if self.sampling:
            generator.set_state(state)

    def _eager(self, state, cards):
        gen = None
        if self.sampling:
            gen = torch.Generator(device=self.device)
            gen.set_state(state)
        t0 = time.perf_counter()
        on_side_stream(lambda: self.body(1, gen), self.device, cards)
        self.stats["eager_steps"] += 1
        self.stats["eager_s"] += time.perf_counter() - t0
        return gen.get_state() if gen is not None else None

    def _graph(self, n: int):
        got = self._graphs.get(n)
        if got is not None:
            return got
        graph = torch.cuda.CUDAGraph()
        gen = None
        if self.sampling:
            gen = torch.Generator(device=self.device)
            graph.register_generator_state(gen)
        tape = LaunchTape()
        t0 = time.perf_counter()
        with tape.recording():
            capture(graph, lambda: self.body(n, gen), what=f"{n} step(s) of {self.what}", pool=self._pool,
                    devices=self.devices, pools=self._pools)
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[n] = got = (graph, tape, gen)
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return got

    def free(self) -> None:
        for graph, _, _ in self._graphs.values():
            graph.reset()
        self._graphs.clear()
        self._pool = self.live = None
        self._pools = CardPools(self.device)


#: the graphs ``lm.decode_scan`` and the scheduler's chunks replay
GRAPHS = GraphCache()


def _generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    """The caller's generator, or the device's default one (what an eager
    draw with ``generator=None`` takes)."""
    if generator is not None:
        return generator
    return torch.cuda.default_generators[device.index if device.index is not None else torch.cuda.current_device()]


def _load_plan(plan, pools, idx) -> None:
    """The call's grouping plan, built once at the tile the entry was
    captured with (a later ``ops.set_default_tile`` leaves a captured graph
    as it is), into the entry's static plan buffers."""
    if plan is not None:
        for buf, new in zip(plan, grouped_plan(pools, idx, tm=plan_tile(plan))):
            buf.copy_(new)


def _layout(t) -> tuple:
    """What an entry's twin of a cache leaf must match: a tensor's shape
    and dtype; a split cache's axis, ranges and each part's shape, dtype
    and device."""
    if isinstance(t, TP.HeadSplit):
        return ("split", t.axis, tuple(t.ranges), tuple((tuple(p.shape), p.dtype, p.device) for p in t.parts))
    return (tuple(t.shape), t.dtype)


class _Decode(_Entry):
    """``decode``'s entry: token, 0-d position, slot index, plan, per-row
    temperatures and serve caches (KV, recurrent states) of its own; steps
    emit the carried token."""

    def __init__(self, stats, cfg, tok0, caches, *, temperature, pools, idx, use_kernel, fuse_skip, unroll,
                 devices=()):
        dev = tok0.device
        super().__init__(stats, f"the decode step ({cfg.name}, batch {tok0.shape[0]})", dev,
                         _temp_kind(temperature)[0] != "greedy", devices)
        self.cfg = cfg
        self.state = {"tok": torch.zeros_like(tok0), "pos": torch.zeros((), dtype=torch.long, device=dev),
                      "caches": [{n: TP.zeros_like(t) for n, t in c.items()} for c in caches]}
        self.idx = torch.zeros_like(idx) if idx is not None else None
        self.temps = torch.zeros_like(temperature) if isinstance(temperature, torch.Tensor) else temperature
        self.plan = grouped_plan(pools, self.idx, use_kernel=use_kernel, fused=fuse_skip)
        self.flags = dict(use_kernel=use_kernel, fuse_skip=fuse_skip)
        self.out = torch.zeros((tok0.shape[0], unroll), dtype=tok0.dtype, device=dev)

    def body(self, n, generator):
        params, adapters, pools = self.live
        for i in range(n):
            self.out[:, i].copy_(self.state["tok"][:, 0])
            LM.decode_step_(params, self.cfg, self.state, temperature=self.temps, generator=generator,
                            adapters=adapters, pools=pools, idx=self.idx, plan=self.plan, **self.flags)


def decode(params, cfg, tok0, start_pos: int, caches, *, max_new: int, temperature=0.0, generator=None,
           adapters=None, pools=None, idx=None, use_kernel: bool = True, fuse_skip: bool = False,
           unroll: int = 1, graphs: Optional[GraphCache] = None):
    """``lm.decode_scan`` on the card: ``max_new`` steps as replays of
    ``unroll``-step graphs. The caches are updated in place. Returns
    (tokens (B, max_new) with tok0 first, caches)."""
    graphs = GRAPHS if graphs is None else graphs
    unroll = max(1, min(unroll, max_new))
    shapes = tuple((n, _layout(t)) for c in caches for n, t in c.items())
    key = ("decode", cfg, tuple(tok0.shape), tok0.dtype, shapes, _temp_kind(temperature), use_kernel,
           fuse_skip, unroll, None if idx is None else idx.dtype, storage_sig(params), storage_sig(adapters),
           storage_sig(pools))
    e = graphs.entry(key, lambda: _Decode(
        graphs.stats, cfg, tok0, caches, temperature=temperature, pools=pools, idx=idx, use_kernel=use_kernel,
        fuse_skip=fuse_skip, unroll=unroll, devices=TP.run_devices(params, tok0)))
    st = e.state
    st["tok"].copy_(tok0)
    st["pos"].fill_(start_pos)
    for mine, theirs in zip(st["caches"], caches):
        for n, t in theirs.items():
            mine[n].copy_(t)
    if idx is not None:
        e.idx.copy_(idx)
        _load_plan(e.plan, pools, e.idx)
    if isinstance(temperature, torch.Tensor):
        e.temps.copy_(temperature)
    toks = torch.empty((tok0.shape[0], max_new), dtype=tok0.dtype, device=tok0.device)

    def emit(at, n):
        toks[:, at:at + n].copy_(e.out[:, :n])

    e.live = (params, adapters, pools)
    try:
        e.run(max_new, unroll, emit, _generator(generator, tok0.device))
    finally:
        e.live = None
    for mine, theirs in zip(st["caches"], caches):
        for n, t in theirs.items():
            t.copy_(mine[n])
    return toks, caches


class _Chunk(_Entry):
    """``chunk``'s entry: slot index, live-row mask, per-row temperatures and
    plan of its own over the live batch's caches, token and position; steps
    emit the new token."""

    def __init__(self, stats, cfg, steps, max_seq, pools, idx, tok, active, temps, use_kernel, fuse, devices=()):
        super().__init__(stats, f"the scheduler's decode step ({cfg.name}, batch {tok.shape[0]})",
                         tok.device, _temp_kind(temps)[0] != "greedy", devices)
        self.cfg, self.max_seq = cfg, max_seq
        self.idx = torch.zeros_like(idx)
        self.active = torch.zeros_like(active)
        self.temps = torch.zeros_like(temps) if isinstance(temps, torch.Tensor) else temps
        self.plan = grouped_plan(pools, self.idx, use_kernel=use_kernel, fused=fuse)
        self.flags = dict(use_kernel=use_kernel, fuse_skip=fuse)
        self.out = torch.zeros((steps, tok.shape[0]), dtype=tok.dtype, device=tok.device)

    def body(self, n, generator):
        params, pools, caches, tok, pos = self.live
        state = {"tok": tok, "pos": pos, "caches": LM.layer_caches(caches)}
        for i in range(n):
            LM.decode_step_(params, self.cfg, state, active=self.active, max_seq=self.max_seq,
                            temperature=self.temps, generator=generator, pools=pools, idx=self.idx,
                            plan=self.plan, **self.flags)
            self.out[i].copy_(tok[:, 0])


def chunk(params, cfg, steps: int, pools, idx, caches, tok, pos, active, temps, generator, max_seq: int, *,
          use_kernel: bool = True, fuse: bool = False, graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """The scheduler's ``steps`` decode steps on the card, one replay, over
    the live batch's stacked ``caches``, ``tok`` (B, 1) and ``pos`` (B,),
    updated in place. Returns the token each step sampled, (steps, B)."""
    graphs = GRAPHS if graphs is None else graphs
    key = ("chunk", cfg, steps, max_seq, _temp_kind(temps), use_kernel, fuse, idx.dtype, active.dtype,
           storage_sig(params), storage_sig(pools), storage_sig(caches), storage_sig(tok), storage_sig(pos))
    e = graphs.entry(key, lambda: _Chunk(graphs.stats, cfg, steps, max_seq, pools, idx, tok, active, temps,
                                         use_kernel, fuse, TP.run_devices(params, tok)))
    e.idx.copy_(idx)
    e.active.copy_(active)
    _load_plan(e.plan, pools, e.idx)
    if isinstance(temps, torch.Tensor):
        e.temps.copy_(temps)
    toks = torch.empty((steps, tok.shape[0]), dtype=tok.dtype, device=tok.device)

    def emit(at, n):
        toks[at:at + n].copy_(e.out[:n])

    e.live = (params, pools, caches, tok, pos)
    try:
        e.run(steps, steps, emit, _generator(generator, tok.device))
    finally:
        e.live = None
    return toks
