"""What the port's CUDA graphs share: the cache of captured entries, the
capture guard and the side-stream warm-up.

The reference dispatches a whole loop as one ``lax.scan``; the card's form
of that one dispatch is a CUDA graph replay. ``core.decode_graph`` captures
decode steps, ``core.finetune`` the steps of an MLP epoch. Both keep their
entries in a ``GraphCache`` and capture through ``capture``, which turns a
failed capture into ``GraphCaptureError``: nothing falls back to eager
steps.
"""

from __future__ import annotations

import gc
from collections import Counter, OrderedDict
from typing import Any, Callable

import torch


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def capture(graph: "torch.cuda.CUDAGraph", fn: Callable[[], None], *, what: str, pool=None) -> None:
    """Capture ``fn``'s work into ``graph`` (``pool``: a memory pool to share
    with other graphs). No cycle collection runs inside the capture: freeing
    another graph there (``cudaGraphExecDestroy``) would invalidate this one.
    A failure raises ``GraphCaptureError`` naming ``what``."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            fn()
    except (RuntimeError, ValueError) as err:
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
    (captures, replays, warm-up steps, host seconds in ``replay()``)."""

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

