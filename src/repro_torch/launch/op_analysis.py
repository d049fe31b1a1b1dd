"""Op analysis of one execution of a step: the counterpart of
``repro.launch.hlo_analysis``.

The reference parses XLA's optimised HLO for the dot FLOPs and the
collective bytes of a compiled step, multiplying what sits in a ``while``
body by the loop's trip count. The port has no HLO: ``OpCounter``, a
``TorchDispatchMode``, sees every aten op a step really issues, on the
card, the CPU or the ``meta`` device (shapes only: the dry-run computes
nothing), and counts

  - dot FLOPs, from ``torch.utils.flop_counter``'s registered formulas
    (2 * M * N * K for a matrix product; attention kernels), and all FLOPs:
    those plus one a result element of every pointwise op and one an input
    element of every reduction;
  - bytes accessed: each op's tensor inputs and outputs (views move none);
  - peak live bytes: each op's new storages are live from the op until the
    storage is freed (a weakref finaliser), autograd's saved tensors
    included until the backward frees them;
  - the bytes that cross members: ``models.tp`` reports each collective
    (``tp.on_collective``) where it moves data, with the reference's
    per-device conventions (an all-reduce 2x the summed tensor's bytes, an
    all-gather the gathered tensor's); ``add_collective`` adds those of
    the data axis (``launch.dryrun``).

The port's loops are Python loops, so every iteration is issued and
counted: that is the reference's loop multiplier. ``count(fn,
sample_loops=True)`` (the dry-run) spares a recurrent cell's 32k-step time
loops (``models.ssm.time_steps``): it runs ``fn`` twice, each loop cut to
its first 2 and then 3 steps (``ssm.sample_time_loops``). A cut loop's
counts are a first step, ``k - 2`` middle steps and a last one, and the
zeros that pad its outputs cost in proportion to the ``s - k`` steps it
left out, so the counts are affine in ``k``; the run at 2 plus ``s - 2``
times the difference is the whole loop's, forward and backward (the
backward's sums into a loop-invariant tensor's gradient included). Peak
live bytes are extrapolated the same way, which holds where the peak
falls at the same point of both runs.

Each op is attributed to the member ``tp.current_member()`` names (0, the
home device, outside a group's member loops), a backward op to its forward
op's member (a label on the autograd node: the engine may run the backward
on another thread, where the member is unset); the forward ops that a
rematerialised region replays inside the backward (``models.remat``) to
the member the replay names, as in the forward, and their storages count
toward the peak while the backward holds them; the per-device numbers are
the busiest member's, the home device's, which also runs the replicated
norms, routers and sums, as every device does in XLA's SPMD program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import remat as RM
from repro_torch.models import ssm as S
from repro_torch.models import tp as TP

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    per_op_bytes: dict[str, float]
    total_bytes: float
    count: int

    def as_dict(self):
        return {
            "per_op_bytes": dict(self.per_op_bytes),
            "total_bytes": self.total_bytes,
            "count": self.count,
        }


def collective_bytes(op: str, nbytes: float) -> float:
    """Per-device traffic of one collective whose result (the summed or
    gathered tensor) has ``nbytes``: ring algorithms with (n-1)/n ~ 1, as
    the reference counts them."""
    if op not in COLLECTIVE_OPS:
        raise ValueError(op)
    return 2.0 * nbytes if op == "all-reduce" else float(nbytes)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class MemberCounts:
    dot_flops: float = 0.0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    live_bytes: float = 0.0
    peak_bytes: float = 0.0

    def as_dict(self):
        return {"dot_flops": self.dot_flops, "flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "peak_bytes": self.peak_bytes}


class OpCounter(TorchDispatchMode):
    """Counts the ops issued inside ``with OpCounter() as c:`` (see the
    module docstring); ``c.members[i]`` holds member i's counts,
    ``c.collectives()`` the collective traffic."""

    def __init__(self):
        super().__init__()
        self.members: dict[int, MemberCounts] = defaultdict(MemberCounts)
        self.live_all = 0.0          # every member's new storages together
        self.peak_all = 0.0
        self.ops = 0                 # aten ops issued
        self._coll: dict[str, float] = defaultdict(float)
        self._coll_count = 0
        self._tracked: dict[int, tuple] = {}         # storage id -> (member, bytes)
        self._pending: list = []                     # weakrefs to a member op's outputs
        self._pending_member = 0
        self._stack = contextlib.ExitStack()

    # -- the mode ---------------------------------------------------------

    def __enter__(self):
        self._stack.enter_context(TP.on_collective(self._on_collective))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._pending:
            self._label_nodes()
        out = func(*args, **kwargs)
        self.ops += 1
        node = torch._C._current_autograd_node()
        if node is not None and not RM.in_region():   # a backward op: its forward op's member
            member = node.metadata.get(TP.MEMBER_KEY, 0)
        else:
            member = TP.current_member()
            if member and any(t.requires_grad for t in _tensors(args)):
                self._pending.extend(weakref.ref(t) for t in _tensors(out))
                self._pending_member = member
        c = self.members[member]
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.dot_flops += f
            c.flops += f
        elif torch.Tag.pointwise in func.tags:
            c.flops += sum(t.numel() for t in _tensors(out))
        elif torch.Tag.reduction in func.tags:
            c.flops += sum(t.numel() for t in _tensors(args))
        if not func.is_view:
            moved = sum(_nbytes(t) for t in _tensors(args)) + sum(_nbytes(t) for t in _tensors(kwargs))
            moved += sum(_nbytes(t) for t in _tensors(out))
            c.bytes_accessed += moved
            fresh = [r.alias_info is None for r in func._schema.returns]
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for t, new in zip(outs, fresh):
                if new and isinstance(t, torch.Tensor):
                    self._track(t, member)
        return out

    def _label_nodes(self) -> None:
        """The autograd nodes of the last member op's outputs (set once the
        op returned) run their backward as that member."""
        for ref in self._pending:
            t = ref()
            if t is not None and t.grad_fn is not None:
                t.grad_fn.metadata[TP.MEMBER_KEY] = self._pending_member
        self._pending = []

    def _track(self, t: torch.Tensor, member: int) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        nbytes = st.nbytes()
        self._tracked[key] = (member, nbytes)
        c = self.members[member]
        c.live_bytes += nbytes
        c.peak_bytes = max(c.peak_bytes, c.live_bytes)
        self.live_all += nbytes
        self.peak_all = max(self.peak_all, self.live_all)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        member, nbytes = self._tracked.pop(key)
        self.members[member].live_bytes -= nbytes
        self.live_all -= nbytes

    # -- collectives --------------------------------------------------------

    def _on_collective(self, op: str, t: torch.Tensor) -> None:
        self.add_collective(op, _nbytes(t))

    def add_collective(self, op: str, nbytes: float) -> None:
        """One collective of a result of ``nbytes``."""
        self._coll[op] += collective_bytes(op, nbytes)
        self._coll_count += 1

    def collectives(self) -> CollectiveStats:
        per_op = {k: v for k, v in self._coll.items() if v}
        return CollectiveStats(per_op_bytes=per_op, total_bytes=sum(per_op.values()), count=self._coll_count)

    @property
    def home(self) -> MemberCounts:
        return self.members[0]

    def extrapolated(self, other: "OpCounter", times: int) -> "OpCounter":
        """The counts of a run whose loops issue ``times`` more steps than
        this run's, ``other`` having issued one more: ``self + times *
        (other - self)``, for every member's counts and peaks and the
        collectives; ``ops`` the two runs' issued ops together."""
        out = OpCounter()

        def line(a, b):
            return a + times * (b - a)

        for i in sorted(set(self.members) | set(other.members)):
            a, b = self.members[i], other.members[i]
            out.members[i] = MemberCounts(**{f.name: line(getattr(a, f.name), getattr(b, f.name))
                                             for f in dataclasses.fields(MemberCounts)})
        out.peak_all = line(self.peak_all, other.peak_all)
        for op in set(self._coll) | set(other._coll):
            out._coll[op] = line(self._coll[op], other._coll[op])
        out._coll_count = line(self._coll_count, other._coll_count)
        out.ops = self.ops + other.ops
        return out


def count(fn, *, sample_loops: bool = False):
    """``fn()`` under an ``OpCounter`` -> (its result, the counter). With
    ``sample_loops`` a time loop longer than 3 steps is counted from two
    runs cut to 2 and 3 steps (see the module docstring); the result is the
    second run's."""
    if not sample_loops:
        with OpCounter() as c:
            out = fn()
        return out, c
    with S.sample_time_loops(2) as sample, OpCounter() as c2:
        out = fn()
    if not sample.lengths:
        return out, c2
    if len(sample.lengths) > 1:
        raise ValueError(f"time loops of lengths {sorted(sample.lengths)} in one run: one extrapolation cannot "
                         "count them")
    (s,) = sample.lengths
    del out
    with S.sample_time_loops(3), OpCounter() as c3:
        out = fn()
    return out, c2.extrapolated(c3, s - 2)
