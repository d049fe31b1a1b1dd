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

Work that spans several cards (a backbone split over a model group whose
members sit on other cards than the home one) is one capture too:
``capture(devices=)`` forks a capture stream on each other card from the
home capture stream and joins it back, makes it that card's current stream
for the capture (so the members' kernels and the cross-card copies of
``models.tp``, which PyTorch orders with events on both cards' current
streams, are recorded in the one graph), and routes that card's
allocations into a pool the entry owns there (``torch.cuda.MemPool``), so
no replay reads memory the card's allocator has handed out again.
``across`` orders the replays with the other cards' eager work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import warnings
from collections import Counter, OrderedDict
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.models import tp as TP


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


#: one capture stream a device: ``torch.cuda.graph``'s own default is made
#: once, on whichever device is current at its first use, and a capture on
#: another device through it records nothing
_STREAMS: dict[int, "torch.cuda.Stream"] = {}


def _stream(card: int) -> "torch.cuda.Stream":
    s = _STREAMS.get(card)
    if s is None:
        s = _STREAMS[card] = torch.cuda.Stream(card)
    return s


def other_cards(devices: Sequence, home: int) -> list[int]:
    """The CUDA cards among ``devices`` other than the card ``home``, each
    once, in order of first appearance (a device without an index is
    ``home``)."""
    out: list[int] = []
    for d in devices:
        d = torch.device(d)
        card = home if d.index is None else d.index
        if d.type == "cuda" and card != home and card not in out:
            out.append(card)
    return out


@contextlib.contextmanager
def _current(streams: Sequence["torch.cuda.Stream"]):
    """Each stream current on its own card for the block; the current card
    stays the one it was (``torch.cuda.set_stream`` also makes the
    stream's card current)."""
    home = torch.cuda.current_device()
    before = [torch.cuda.current_stream(s.device) for s in streams]
    for s in streams:
        torch.cuda.set_stream(s)
    torch.cuda.set_device(home)
    try:
        yield
    finally:
        for s in before:
            torch.cuda.set_stream(s)
        torch.cuda.set_device(home)


class CardPools(dict):
    """card -> ``torch.cuda.MemPool``: the memory an entry's graphs hold on
    the cards other than its own (``home``), filled by ``capture``.
    Dropping it first waits for ``home`` and every card it holds a pool
    on: a replay's copies write one card's memory from another card, and
    freeing a pool (``cudaFree``) waits only for the pool's own card, so a
    pool freed while the replays are in flight would be written after it
    is gone."""

    def __init__(self, home: torch.device):
        super().__init__()
        self.home = home

    def __del__(self):
        if self and torch.cuda.is_initialized():
            for card in [self.home, *self]:
                torch.cuda.synchronize(card)


@contextlib.contextmanager
def _members(home: "torch.cuda.Stream", cards: Sequence[int], pools: dict):
    """Inside a capture on ``home``: each card's capture stream forked from
    ``home`` and current on its card, the card's allocations routed into
    ``pools[card]``; every stream joined back into ``home`` at the end.
    When the block raised, the joins are still tried (a capture that fails
    may have invalidated them), and the block's error is the one raised."""
    streams = [_stream(c) for c in cards]
    for s in streams:
        s.wait_stream(home)
    ok = False
    try:
        with contextlib.ExitStack() as stack:
            for c in cards:
                stack.enter_context(torch.cuda.use_mem_pool(pools[c], device=c))
            stack.enter_context(_current(streams))
            yield
        ok = True
    finally:
        for s in streams:
            try:
                home.wait_stream(s)
            except RuntimeError:
                if ok:
                    raise


def capture(graph: "torch.cuda.CUDAGraph", fn: Callable[[], None], *, what: str, pool=None,
            devices: Sequence = (), pools: Optional[dict] = None) -> None:
    """Capture ``fn``'s work into ``graph`` on the current CUDA device
    (``pool``: a memory pool to share with other graphs). ``devices``: the
    devices the work runs on; each CUDA card among them other than the
    current one is synchronised first (its eager work cannot be waited on
    from inside the capture), then recorded on a capture stream of its own
    forked from the current card's, its allocations going into ``pools``
    (the caller's ``CardPools``, filled on first use and kept as long as
    the graph). No cycle collection runs inside the capture: freeing
    another graph there (``cudaGraphExecDestroy``) would invalidate this
    one. A failure, and a capture that records nothing (work sent to
    another device's stream), raise ``GraphCaptureError`` naming
    ``what``."""
    home = torch.cuda.current_device()
    stream = _stream(home)
    cards = other_cards(devices, home)
    if cards and pools is None:
        raise ValueError(f"capturing {what} over cards {cards} needs pools to own their memory")
    for c in cards:
        torch.cuda.synchronize(c)
        if c not in pools:
            with torch.cuda.device(c):
                pools[c] = torch.cuda.MemPool()
    before = torch.cuda.current_stream()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="The CUDA Graph is empty")
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                with _members(stream, cards, pools) if cards else contextlib.nullcontext():
                    fn()
    except (RuntimeError, ValueError, UserWarning) as err:
        # a capture that fails to end leaves the capture stream current
        torch.cuda.set_stream(before)
        raise GraphCaptureError(f"capturing {what} into a CUDA graph failed: {err}") from err
    finally:
        if collecting:
            gc.enable()


@contextlib.contextmanager
def across(cards: Sequence[int]):
    """Replays on the current card ordered with the eager work of the
    other ``cards`` their graphs reach: the current stream waits for each
    card's current stream before the block, and each card's current stream
    waits for the current stream after it."""
    if not cards:
        yield
        return
    home = torch.cuda.current_stream()
    for c in cards:
        home.wait_stream(torch.cuda.current_stream(c))
    yield
    for c in cards:
        torch.cuda.current_stream(c).wait_stream(home)


def on_side_stream(fn: Callable[[], Any], device: torch.device, cards: Sequence[int] = ()) -> Any:
    """Run ``fn`` on a fresh side stream on ``device`` and on each other
    card of ``cards``, each ordered after its card's current stream, and
    make every current stream wait for its side stream: the warm-up before a
    capture (the kernel libraries load and their handles and workspaces are
    made outside the capture, on every card the work reaches)."""
    sides = [torch.cuda.Stream(device)] + [torch.cuda.Stream(c) for c in cards]
    mains = [torch.cuda.current_stream(s.device) for s in sides]
    for side, main in zip(sides, mains):
        side.wait_stream(main)
    with torch.cuda.device(device), _current(sides):
        out = fn()
    for side, main in zip(sides, mains):
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


def _flatten(tree, out: list) -> list:
    """The tensors of ``tree`` (nested dicts, lists and tuples, dataclass
    instances such as a ``SkipCache``, model groups and split caches) in
    order, with the marks that tell its structure: dict keys and field
    names, a group's devices, a split's axis and ranges."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out.append(f.name)
            _flatten(getattr(tree, f.name), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.append(k)
            _flatten(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    elif isinstance(tree, TP.GroupParams):
        out.append(("group", tuple(torch.device(d) for d in tree.devices)))
        for m in tree.members:
            _flatten(m, out)
    elif isinstance(tree, TP.HeadSplit):
        out.append(("split", tree.axis, tuple(tree.ranges)))
        for part in tree.parts:
            _flatten(part, out)
    elif tree is not None:
        raise TypeError(f"unexpected leaf {type(tree).__name__} in a graph's inputs")
    return out


def storage_sig(tree) -> tuple:
    """(data pointer, shape, strides, dtype, device) of every tensor in
    ``tree`` (nested dicts, lists, tuples and dataclass instances), with
    the dict keys and field names, in order: what keys a graph to the
    tensors it reads or writes in place. A backbone split over a model
    group (``tp.GroupParams``) gives its devices, then each member's
    tensors in member order; a split cache (``tp.HeadSplit``) its axis and
    ranges, then each part's storage. A member re-sharded, or a part
    re-made, into new storage therefore keys a new capture."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device) if isinstance(t, torch.Tensor)
                 else t for t in _flatten(tree, []))


def tree_devices(tree) -> list[torch.device]:
    """The devices of ``tree``'s tensors, each once, in order of first
    appearance: what a capture over them must reach."""
    out: list[torch.device] = []
    for t in _flatten(tree, []):
        if isinstance(t, torch.Tensor) and t.device not in out:
            out.append(t.device)
    return out


def capturable(devices: Sequence) -> bool:
    """Whether work that runs on ``devices`` (the devices of a call's
    tensors: a whole backbone's one, or the home device and every member
    of a model group) can be one CUDA-graph capture: true when every one is
    a CUDA device, on one card (a group whose members share the home
    device, such as ``[cuda:0, cuda:0]``) or on several (``[cuda:0,
    cuda:1]``); false for an empty list and wherever a ``cpu`` or ``meta``
    device appears.

    This is the one test every graphed path makes (``lm.decode_scan``, the
    scheduler's chunk, ``lm_skiplora.graphed``). Work on several cards is
    captured by ``capture(devices=)``: a capture stream on each other card,
    forked from the home card's and joined back, and each card's
    allocations in a pool the entry owns there."""
    devs = [torch.device(d) for d in devices]
    return bool(devs) and all(d.type == "cuda" for d in devs)


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
    (``first_step_s``, ``capture_s``, ``replay_s``).

    ``devices``: every device the step's tensors live on (``tree_devices``
    of ``live``). Where they span several cards, each capture reaches every
    card (``capture(devices=)``), the entry keeps a pool on each card other
    than ``device``, and the replays are ordered with those cards' eager
    work (``across``)."""

    def __init__(self, stats: Counter, step: Callable, *, device: torch.device, what: str,
                 before: Optional[Callable] = None, after: Optional[Callable] = None, devices: Sequence = ()):
        # the cache's stats, not the cache: an entry that pointed back at its
        # cache would free its graphs only in the cycle collector, which may
        # run inside another capture
        self.stats, self.step, self.device, self.what = stats, step, device, what
        self.before, self.after, self.devices = before, after, list(devices)
        self.live: Any = None
        self.carry: list[torch.Tensor] = []
        self.consts: list[torch.Tensor] = []
        self.idx = self.s = self.losses = None
        self.out: dict[str, torch.Tensor] = {}
        self._graphs: dict[str, tuple[torch.cuda.CUDAGraph, LaunchTape]] = {}
        self._pool = None
        self._pools = CardPools(device)

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
            capture(graph, fn, what=what, pool=self._pool, devices=self.devices, pools=self._pools)
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
            with across(other_cards(self.devices, torch.cuda.current_device())):
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
        self._pools = CardPools(self.device)
        self.carry, self.consts, self.out = [], [], {}
