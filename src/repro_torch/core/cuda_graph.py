"""What the port's CUDA graphs share: the cache of captured entries, the
capture guard, the side-stream warm-up, the launch tape and the epoch
graph.

The reference dispatches a whole loop as one ``lax.scan``; the card's form
of that one dispatch is a CUDA graph replay. ``core.decode_graph`` captures
decode steps, ``core.finetune`` the steps of an MLP epoch,
``launch.train`` the trainer's scan chunk, and ``EpochGraph`` the steps of
the LM fine-tuning epochs (``core.lm_skiplora``, ``core.fleet_finetune``,
the session's resident ``adapt``). All keep their entries in a
``GraphCache`` and capture through ``capture``, which turns a failed
capture into ``GraphCaptureError``: nothing falls back to eager steps.

The rule every graph here keeps: a graph writes only what the reference's
scan donates, and only into buffers that came from the same caller. What
the reference reads and does not donate (params, tokens, labels) is never
written. Donated state is either copied into the entry's own buffers and
handed out as new tensors (``EpochGraph``'s small state), or used in place
when the entry is keyed on its storage (``EpochGraph``'s live tensors, the
trainer chunk's parameters and moments), so a second caller's tensors of
equal shapes get an entry of their own and never land in the first
caller's buffers.
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings
from collections import Counter, OrderedDict
from typing import Any, Callable, Optional, Sequence

import torch


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


#: one capture stream a device: ``torch.cuda.graph``'s own default is made
#: once, on whichever device is current at its first use, and a capture on
#: another device through it records nothing
_STREAMS: dict[int, "torch.cuda.Stream"] = {}


def capture(graph: "torch.cuda.CUDAGraph", fn: Callable[[], None], *, what: str, pool=None) -> None:
    """Capture ``fn``'s work into ``graph`` on the current CUDA device
    (``pool``: a memory pool to share with other graphs). No cycle
    collection runs inside the capture: freeing another graph there
    (``cudaGraphExecDestroy``) would invalidate this one. A failure, and a
    capture that records nothing (work sent to another device's stream),
    raise ``GraphCaptureError`` naming ``what``."""
    dev = torch.cuda.current_device()
    stream = _STREAMS.get(dev)
    if stream is None:
        stream = _STREAMS[dev] = torch.cuda.Stream(dev)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="The CUDA Graph is empty")
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                fn()
    except (RuntimeError, ValueError, UserWarning) as err:
        raise GraphCaptureError(f"capturing {what} into a CUDA graph failed: {err}") from err
    finally:
        if collecting:
            gc.enable()


def on_side_stream(fn: Callable[[], Any], device: torch.device) -> Any:
    """Run ``fn`` on a fresh side stream ordered after the current stream's
    work, and make the current stream wait for it: the warm-up before a
    capture (the kernel libraries load and their handles and workspaces
    are made outside the capture)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


class GraphCache:
    """The ``capacity`` most recently used graph entries (LRU). An entry is
    any object with a ``free()`` method, which an eviction calls. ``stats``
    counts hits, misses and evictions, and whatever the entries count in it
    (captures, replays, eager first steps, host seconds in ``replay()``)."""

    def __init__(self, capacity: int = 4):
        if capacity < 1:
            raise ValueError(f"graph cache capacity {capacity} < 1")
        self.capacity = capacity
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self.stats: Counter = Counter()

    def __len__(self) -> int:
        return len(self._entries)

    def entry(self, key: tuple, make: Callable[[], Any]) -> Any:
        e = self._entries.get(key)
        if e is not None:
            self.stats["hits"] += 1
            self._entries.move_to_end(key)
            return e
        self.stats["misses"] += 1
        while len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)[1].free()
            self.stats["evictions"] += 1
        e = self._entries[key] = make()
        return e

    def clear(self) -> None:
        while self._entries:
            self._entries.popitem(last=False)[1].free()


def storage_sig(tree) -> tuple:
    """(data pointer, shape, strides, dtype) of every tensor in ``tree``
    (nested dicts, lists and tuples), with the dict keys, in order: what
    keys a graph to the tensors it reads or writes in place."""
    out: list = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype))
        elif isinstance(t, dict):
            for k, v in t.items():
                out.append(k)
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            raise TypeError(f"unexpected leaf {type(t).__name__} in a graph's inputs")

    walk(tree)
    return tuple(out)


def shapes(tensors: Sequence[torch.Tensor]) -> tuple:
    """(shape, dtype) of each tensor: what keys a graph to the tensors it
    copies into buffers of its own."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def capture_note(stats: Counter, since: Counter) -> str:
    """What ``stats`` gained since the copy ``since`` in captures, as a
    suffix for a line that reports a time: ", of which capture X s + eager
    first step Y s (N graphs)", or "" when nothing was captured."""
    got = stats.copy()
    got.subtract(since)
    if got["captures"] <= 0:
        return ""
    return (f", of which capture {got['capture_s']:.2f}s + eager first step {got['first_step_s']:.2f}s "
            f"({got['captures']} graph(s))")


def _counters() -> tuple[dict, ...]:
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import paged as PG
    from repro_torch.kernels.skip_lora import kernel as K

    return K.LAUNCHES, K.ROW_LAUNCHES, FK.LAUNCHES, PG.LAUNCHES


class LaunchTape:
    """The kernel launches one capture counted, by kernel and, for the
    grouped forwards, by row class. ``recording()`` around a capture takes
    them back out of the counters; ``replayed(n)`` adds them ``n`` times."""

    def __init__(self):
        self.counts: list[dict] = []

    @contextlib.contextmanager
    def recording(self):
        counters = _counters()
        before = [dict(c) for c in counters]
        try:
            yield self
        finally:
            self.counts = [{k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
                           for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.clear()
                c.update(b)

    def replayed(self, n: int = 1) -> None:
        for c, d in zip(_counters(), self.counts):
            for k, v in d.items():
                c[k] = c.get(k, 0) + n * v

    def kernel_launches(self) -> int:
        """Launches recorded, over all kernels (row classes not counted
        twice)."""
        return sum(sum(d.values()) for i, d in enumerate(self.counts) if i != 1)


class EpochGraph:
    """One epoch kind's CUDA graphs for one caller's tensors: a reference
    ``lax.scan`` epoch as replays of a step graph.

    ``step(live, carry, consts, idx) -> (new carry, loss)`` is one step of
    the epoch on the row ``idx`` of its index matrix. Its state comes in
    three kinds:

      - ``carry``: the small donated state (adapters, optimizer moments and
        step count), copied into buffers of the entry's own at each call;
        the graph writes each step's new carry back into them, and a call
        hands out copies, so no later replay writes what a caller holds;
      - ``consts``: small inputs read only (row -> tenant maps, held-out
        ids, a frozen A), copied in likewise;
      - ``live``: the large tensors, used in place and never copied: params,
        tokens and labels, which the graph reads, and the activation cache,
        which a populate step writes (donated, as in the reference). The
        entry keeps no reference to them between calls; its cache key must
        hold their storage (``storage_sig``), so a replay reads and writes
        exactly the caller's tensors.

    The index matrix goes into a buffer of the entry's own, and a step
    reads its row through a step counter held on the device, which each
    captured step advances: one graph of one step serves every row, and an
    epoch replays it once a row. ``before`` / ``after``, ``fn(live, carry,
    consts) -> tensor``, are captured into graphs of their own and replayed
    before the first step and after the last (the held-out loss of a fleet
    epoch).

    An entry's first call runs its first step eagerly on the current
    stream, through the code the graph captures, and keeps what it gives
    (the new carry, the loss, the counter at 1): ``before``, then the step,
    so the kernel libraries load and their handles and workspaces are made
    outside the capture at no extra step. ``after`` runs once eagerly too,
    its result dropped and its launches taken back out of the launch
    counters (``stats["warmup_launches"]``): they are not the epoch's. The
    captures follow, each through ``capture`` with a ``LaunchTape``, and
    the call replays the step graph for the other rows, so the counters
    count each step's launches once, as the eager loop does. ``stats``
    also gets captures, replays, first steps and the host seconds of each
    (``first_step_s``, ``capture_s``, ``replay_s``)."""

    def __init__(self, stats: Counter, step: Callable, *, device: torch.device, what: str,
                 before: Optional[Callable] = None, after: Optional[Callable] = None):
        # the cache's stats, not the cache: an entry that pointed back at its
        # cache would free its graphs only in the cycle collector, which may
        # run inside another capture
        self.stats, self.step, self.device, self.what = stats, step, device, what
        self.before, self.after = before, after
        self.live: Any = None
        self.carry: list[torch.Tensor] = []
        self.consts: list[torch.Tensor] = []
        self.idx = self.s = self.losses = None
        self.out: dict[str, torch.Tensor] = {}
        self._graphs: dict[str, tuple[torch.cuda.CUDAGraph, LaunchTape]] = {}
        self._pool = None

    def _load(self, carry, consts, idx_mat) -> None:
        if self.idx is None:
            self.carry = [t.clone() for t in carry]
            self.consts = [t.clone() for t in consts]
            self.idx = idx_mat.clone()
            self.s = torch.zeros((1,), dtype=torch.long, device=idx_mat.device)
            return
        for dst, src in zip(self.carry + self.consts + [self.idx], list(carry) + list(consts) + [idx_mat],
                            strict=True):
            dst.copy_(src)
        self.s.zero_()

    def _advance(self, new, loss) -> None:
        for dst, src in zip(self.carry, new, strict=True):
            dst.copy_(src)
        self.losses.index_copy_(0, self.s, loss.unsqueeze(0))
        self.s.add_(1)

    def _step(self) -> None:
        self._advance(*self.step(self.live, self.carry, self.consts, self.idx.index_select(0, self.s)[0]))

    def _extra(self, name: str) -> None:
        fn = self.before if name == "before" else self.after
        self.out[name].copy_(fn(self.live, self.carry, self.consts))

    def _first_step(self) -> None:
        t0 = time.perf_counter()
        if self.before is not None:
            self.out["before"] = self.before(self.live, self.carry, self.consts)
        new, loss = self.step(self.live, self.carry, self.consts, self.idx.index_select(0, self.s)[0])
        self.losses = loss.new_zeros((self.idx.shape[0],) + tuple(loss.shape))
        self._advance(new, loss)
        del new, loss
        if self.after is not None:
            tape = LaunchTape()
            with tape.recording():
                self.out["after"] = torch.zeros_like(self.after(self.live, self.carry, self.consts))
            self.stats["warmup_launches"] += tape.kernel_launches()
        self.stats["first_steps"] += 1
        self.stats["first_step_s"] += time.perf_counter() - t0

    def _graph(self, name: str) -> tuple[torch.cuda.CUDAGraph, LaunchTape]:
        got = self._graphs.get(name)
        if got is not None:
            return got
        graph, tape = torch.cuda.CUDAGraph(), LaunchTape()
        if name == "step":
            fn, what = self._step, f"the step of {self.what}"
        else:
            fn, what = (lambda: self._extra(name)), f"the {name} pass of {self.what}"
        t0 = time.perf_counter()
        with tape.recording():
            capture(graph, fn, what=what, pool=self._pool)
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[name] = got = (graph, tape)
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return got

    def run(self, live, carry: Sequence[torch.Tensor], consts: Sequence[torch.Tensor],
            idx_mat: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor, dict[str, torch.Tensor]]:
        """The epoch over ``idx_mat`` (steps, batch): (the new carry, the
        step losses (steps, ...), {"before", "after": their outputs}), all
        new tensors. ``live`` is handed to ``step`` only during the call."""
        with torch.cuda.device(self.device):
            self.live = live
            try:
                self._load(carry, consts, idx_mat)
                first = self.losses is None
                if first:
                    self._first_step()
                names = (["before"] if self.before is not None else []) + ["step"] + (
                    ["after"] if self.after is not None else [])
                graphs = {n: self._graph(n) for n in names}   # every capture before the first replay
            finally:
                self.live = None
            plan = ([graphs["before"]] if self.before is not None and not first else []) + [graphs["step"]] * (
                self.idx.shape[0] - first) + ([graphs["after"]] if self.after is not None else [])
            t0 = time.perf_counter()
            for graph, tape in plan:
                graph.replay()
                tape.replayed()
            self.stats["replays"] += len(plan)
            self.stats["replay_s"] += time.perf_counter() - t0
            return ([t.clone() for t in self.carry], self.losses.clone(),
                    {k: v.clone() for k, v in self.out.items()})

    def free(self) -> None:
        for graph, _ in self._graphs.values():
            graph.reset()
        self._graphs.clear()
        self._pool = self.live = self.idx = self.losses = None
        self.carry, self.consts, self.out = [], [], {}
