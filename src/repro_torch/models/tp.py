"""Megatron tensor parallelism over a model group: one backbone replica
split over a list of devices, run by one process.

``GroupParams`` wraps ``runtime.sharding.shard_backbone``'s member trees
with the full tree's spec tree and the group's devices; indexing it walks
all three together, so ``params["stack"][l]`` is layer ``l`` split over
the group. ``models.lm`` and ``models.blocks`` hand a ``GroupParams`` to
the functions here and run their own code on anything else, so one device
runs bitwise as before.

Each member computes with its own shard on its own device; where Megatron
all-reduces, the members' partial results are copied onto the group's
first device (the *home*, where activations, caches and pools live) and
summed there in member order. Activations go out to a member by a copy
(a no-op for a member on the home device). The branches follow
``sharding._param_spec_for``:

  - attention: heads split -> each member attends over its heads (KV heads
    too when they divide, else its query heads' KV heads from the whole
    fresh K/V), and ``wo`` is row parallel (partials summed); heads that do
    not divide -> ``d_model`` split, the q/k/v partials summed and attention
    run on the home device, ``wo`` splitting its output (the pieces
    concatenated) or replicated.
  - KV caches (``init_caches``), placed as the reference's ``cache_specs``
    places them: split by each member's own KV heads where they divide the
    group (``HeadSplit``), each part on its member's device; else split by
    sequence (context parallelism), member i holding a contiguous range of
    positions. Over a sequence split a decode step (or an offset prefill)
    sends every query head to each member, which attends over its own
    positions only, and merges the members' partial outputs by their
    log-sum-exps on the home device (``attend_split``): a step moves no
    cached position between devices. A cache whose positions the group
    does not divide stays whole on the home device, where attention runs.
  - dense FFN: ``w_gate``/``w_up`` column split, ``w_down`` row split.
  - MoE: one dispatch on the home device (the router is replicated, so the
    drops are the one-device ones); a member forms only its experts' E*C
    slots (or, where the experts do not divide, every slot over its slice
    of the expert hidden dimension) and combines them; the shared FFN
    splits as a dense one; the partial outputs are summed.
  - vocabulary: each member looks up the embedding rows it owns (zero
    elsewhere) and the partials are summed (exact); the readout's logits
    are each member's vocabulary slice, concatenated on the home device;
    the chunked loss's ``dh`` is the ordered sum of the members'
    ``dlogits_m @ table_m``.
  - mamba: ``in_proj``'s column blocks gathered on the home device (an
    all-gather), then each member runs the conv and the selective scan on
    its slice of ``d_inner``; the ``x_proj`` partials (dt_low, B, C) and
    ``out_proj``'s are summed. Its ``ssm`` and ``conv`` states are split by
    ``d_inner`` over the members (``HeadSplit`` on their ``d_inner`` axis).
  - mLSTM: ``up_proj`` gathered as mamba's ``in_proj``; each member's conv
    on its ``d_inner`` slice; the q/k/v and gate partials summed; the
    recurrence runs each member's heads where the heads divide the group
    (its ``c`` split by heads), else once on the home device; ``down_proj``
    row parallel. ``n`` and ``m`` stay whole on the home device, as the
    reference's ``cache_specs`` keeps them.
  - sLSTM is replicated and runs whole on the home device.
  A recurrent mixer whose ``d_inner`` does not divide the group runs whole
  on the home device (its weights are then replicated).

Where Megatron moves data between members, ``reduce`` (an all-reduce of
the summed tensor) and ``gather`` (an all-gather of the concatenated one)
tell the listeners of ``on_collective`` (``launch.op_analysis``'s counter);
the member loops set ``current_member()``, which the counter reads. Neither
costs anything without a listener.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import ffn as FFN
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.layers import apply_rope
from repro_torch.models.layers import embed as _embed
from repro_torch.models.layers import unembed as _unembed

Params = Any

#: the member whose ops run now (0, the home device, outside member loops)
_MEMBER: contextvars.ContextVar = contextvars.ContextVar("tp_member", default=0)
#: callables ``fn(op, tensor)`` told of every collective (``on_collective``)
_LISTENERS: list[Callable] = []


def current_member() -> int:
    return _MEMBER.get()


#: the autograd-node metadata key naming the member whose forward op made
#: the node (``launch.op_analysis`` attributes the node's backward to it)
MEMBER_KEY = "op_member"


def label_node(node) -> None:
    """Name ``current_member()`` on an autograd node (a custom Function's
    ``ctx``), whose backward then counts as that member's."""
    node.metadata[MEMBER_KEY] = current_member()


@contextlib.contextmanager
def as_member(i: int):
    """Attribute the ops issued inside to member ``i``."""
    token = _MEMBER.set(i)
    try:
        yield
    finally:
        _MEMBER.reset(token)


def _each(g: "GroupParams"):
    """(i, member tree, device) over a group, with ``current_member()`` = i
    while the caller's loop body runs."""
    for i, (m, d) in enumerate(zip(g.members, g.devices)):
        with as_member(i):
            yield i, m, d


@contextlib.contextmanager
def on_collective(fn: Callable):
    """Call ``fn(op, tensor)`` for every collective the group code makes:
    ``"all-reduce"`` with the summed tensor, ``"all-gather"`` with the
    gathered one."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


def _collective(op: str, t: torch.Tensor) -> torch.Tensor:
    for fn in _LISTENERS:
        fn(op, t)
    return t


class GroupParams:
    """A params (sub)tree split over a model group: ``members[i]`` is member
    i's shard tree on ``devices[i]``, ``specs`` the full tree's specs."""

    __slots__ = ("members", "specs", "devices")

    def __init__(self, members: list[Params], specs: Params, devices: list[torch.device]):
        self.members, self.specs, self.devices = members, specs, devices

    def __getitem__(self, key) -> "GroupParams":
        return GroupParams([m[key] for m in self.members], self.specs[key], self.devices)

    def __contains__(self, key) -> bool:
        return key in self.members[0]

    def __len__(self) -> int:
        return len(self.members[0])

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def local(self) -> Params:
        """Member 0's tree, on the home device: the replicated leaves."""
        return self.members[0]


def group_params(params: Params, devices) -> GroupParams:
    """``params`` split over ``devices`` (``sharding.shard_backbone``)."""
    from repro_torch.runtime import sharding as SH

    mesh = SH.group_mesh(devices)
    return GroupParams(SH.shard_backbone(params, list(mesh.devices)), SH.param_specs(params, mesh),
                       list(mesh.devices))


def is_group(params) -> bool:
    return isinstance(params, GroupParams)


def home_device(params) -> torch.device:
    """Where a backbone's activations live: a group's home device, else
    the embedding table's."""
    return params.home if is_group(params) else params["embed"]["table"].device


def run_devices(params, x: torch.Tensor) -> list[torch.device]:
    """The devices a call over ``params`` with ``x`` on the home device
    runs on: ``x``'s, then a group's members' (what
    ``cuda_graph.capturable`` tests)."""
    return [x.device] + (list(params.devices) if is_group(params) else [])


def local(params):
    """A replicated subtree as plain tensors (member 0's for a group)."""
    return params.local if is_group(params) else params


def init_group_params(generator: torch.Generator, cfg, devices, prepare=None) -> GroupParams:
    """``lm.init_lm``'s draws (``lm.init_parts``: the same order, so the
    same numbers) split over ``devices`` a part at a time, so no device
    holds more than its members' shards and one drawn part: a backbone no
    card holds whole. ``prepare(key, tree)`` may change a part in place
    before it is split."""
    from repro_torch.models import lm as LM
    from repro_torch.runtime import sharding as SH

    mesh = SH.group_mesh(devices)
    devices = list(mesh.devices)
    specs = SH.param_specs(LM.param_shapes(cfg), mesh)
    members: list[Params] = [{} for _ in devices]
    for key, tree in LM.init_parts(generator, cfg):
        if prepare is not None:
            prepare(key, tree)
        spec = specs["stack"][key[1]] if isinstance(key, tuple) else specs[key]
        for m, part in zip(members, SH.shard_backbone(tree, devices, specs=spec)):
            LM.put_part(m, key, part)
        del tree   # the drawn part goes before the next one is drawn
    return GroupParams(members, specs, devices)


def reduce(parts: list[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The members' partial results summed on ``home``, in member order:
    Megatron's all-reduce."""
    out = parts[0].to(home)
    for p in parts[1:]:
        out = out + p.to(home)
    return _collective("all-reduce", out)


def gather(parts: list[torch.Tensor], home: torch.device, dim: int = -1) -> torch.Tensor:
    """The members' blocks concatenated on ``home`` along ``dim``: an
    all-gather."""
    return _collective("all-gather", torch.cat([p.to(home) for p in parts], dim=dim))


def _split(spec, axis: int) -> bool:
    return spec[axis] == "model"


# ---------------------------------------------------------------------------
# Vocabulary: embedding and readout
# ---------------------------------------------------------------------------


def embed(ge: GroupParams, ids: torch.Tensor, *, scale_by_sqrt_dim: bool, dtype) -> torch.Tensor:
    """Vocab-parallel lookup: each member's rows where it owns the id, zero
    elsewhere, summed (exactly the one-device rows)."""
    if not _split(ge.specs["table"], 0):
        return _embed(ge.local, ids, scale_by_sqrt_dim=scale_by_sqrt_dim, dtype=dtype)
    parts = []
    for i, m, dev in _each(ge):
        t = m["table"]
        rows = ids.to(dev) - i * t.shape[0]
        hit = (rows >= 0) & (rows < t.shape[0])
        parts.append(t[rows.clamp(0, t.shape[0] - 1)] * hit[..., None].to(t.dtype))
    x = reduce(parts, ge.home).to(dtype)
    if scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(ge.local["table"].shape[1])).to(dtype).item()
    return x


def unembed(ge: GroupParams, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits: each member's vocabulary slice, concatenated on the home
    device."""
    if not _split(ge.specs["table"], 0):
        return _unembed(ge.local, h)
    return gather([_unembed(m, h.to(dev)) for _, m, dev in _each(ge)], ge.home)


@dataclasses.dataclass
class VocabShards:
    """A readout table split by vocabulary over a group: fp32 ``tables[i]``
    on ``devices[i]`` (``lm._ChunkLogLik``'s table)."""

    tables: list[torch.Tensor]
    devices: list[torch.device]

    def logits(self, hn: torch.Tensor, matmul) -> torch.Tensor:
        parts = []
        for i, (t, d) in enumerate(zip(self.tables, self.devices)):
            with as_member(i):
                parts.append(matmul(hn.to(d), t.T))
        return gather(parts, hn.device)

    def dh(self, dlogits: torch.Tensor, matmul) -> torch.Tensor:
        """sum_m dlogits[..., vocab of m] @ table_m, in member order."""
        parts, v0 = [], 0
        for i, (t, d) in enumerate(zip(self.tables, self.devices)):
            with as_member(i):
                parts.append(matmul(dlogits[..., v0:v0 + t.shape[0]].to(d), t))
            v0 += t.shape[0]
        return reduce(parts, dlogits.device)


def readout_table(ge: GroupParams):
    """The fp32 readout table for ``lm._ChunkLogLik``: one tensor where the
    vocabulary is replicated, else its ``VocabShards``."""
    if not _split(ge.specs["table"], 0):
        return ge.local["table"].float()
    return VocabShards([m["table"].float() for m in ge.members], list(ge.devices))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class HeadSplit:
    """A cache tensor split along one axis over a model group: ``parts[i]``,
    on member i's device, holds indices ``ranges[i]`` = [lo, hi) of axis
    ``axis`` (negative). K and V caches split by their KV heads (axis -2)
    where the KV heads divide the group, else by sequence positions (axis
    -3: context parallelism, ``init_caches``); recurrent states by
    ``d_inner`` or heads. Indexing the dimensions before ``axis`` gives a
    ``HeadSplit`` of the parts' views; assigning into them takes a
    ``HeadSplit`` of the same ranges or a whole tensor (each part its
    indices), and assigning into a slice of ``axis`` too (``c[:, rows,
    :p] = ...``) takes any value, each part its indices of the slice (a
    ``HeadSplit`` value gathered first). ``whole()`` gathers it on the home
    device; ``zeros_like()``, ``zero_()`` and ``copy_()`` give a CUDA-graph
    entry a twin of its own, make it fresh and copy a split cache into and
    out of it."""

    __slots__ = ("parts", "ranges", "axis")

    def __init__(self, parts: list[torch.Tensor], ranges, axis: int = -2):
        self.parts, self.ranges, self.axis = list(parts), [tuple(r) for r in ranges], axis

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.axis] = self.ranges[-1][1]
        return torch.Size(s)

    def __len__(self) -> int:
        return self.parts[0].shape[0]

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _lead(self, idx, dev):
        t = idx if isinstance(idx, tuple) else (idx,)
        if any(i is Ellipsis for i in t) or len(t) > self.parts[0].dim() + self.axis:
            raise IndexError("a HeadSplit indexes its leading dimensions only")
        t = tuple(i.to(dev) if isinstance(i, torch.Tensor) else i for i in t)
        return t if isinstance(idx, tuple) else t[0]

    def __getitem__(self, idx) -> "HeadSplit":
        return HeadSplit([p[self._lead(idx, p.device)] for p in self.parts], self.ranges, self.axis)

    def __setitem__(self, idx, value) -> None:
        t = idx if isinstance(idx, tuple) else (idx,)
        lead = self.parts[0].dim() + self.axis
        if len(t) == lead + 1 and isinstance(t[lead], slice):
            self._set_span(t[:lead], t[lead], value)
            return
        if isinstance(value, HeadSplit):
            if value.ranges != self.ranges:
                raise ValueError(f"heads {value.ranges} assigned into heads {self.ranges}")
            values = value.parts
        else:
            values = [value.narrow(self.axis, lo, hi - lo) for lo, hi in self.ranges]
        for p, v in zip(self.parts, values):
            p[self._lead(idx, p.device)] = v.to(p.device)

    def _set_span(self, lead: tuple, span: slice, value) -> None:
        """``self[lead + (span,)] = value``: each part takes the indices of
        ``span`` it holds."""
        a, b, step = span.indices(self.shape[self.axis])
        if step != 1:
            raise IndexError("a HeadSplit assigns a contiguous slice of its split axis")
        value = whole(value)
        for p, (lo, hi) in zip(self.parts, self.ranges):
            x0, x1 = max(a, lo), min(b, hi)
            if x1 > x0:
                src = value.narrow(self.axis, x0 - a, x1 - x0) if value.dim() >= -self.axis else value
                p[self._lead(lead, p.device) + (slice(x0 - lo, x1 - lo),)] = src.to(p.device)

    def zeros_like(self) -> "HeadSplit":
        """A zeroed twin: parts of the same shapes, dtypes and devices over
        the same ranges and axis (a graph entry's own cache buffer)."""
        return HeadSplit([torch.zeros_like(p) for p in self.parts], self.ranges, self.axis)

    def zero_(self) -> "HeadSplit":
        """Zero every part in place (a graph entry's cache made fresh);
        returns ``self``."""
        for p in self.parts:
            p.zero_()
        return self

    def copy_(self, src: "HeadSplit") -> "HeadSplit":
        """Copy ``src``, a ``HeadSplit`` of the same axis and ranges, into
        the parts in place, part by part; returns ``self``."""
        if not isinstance(src, HeadSplit) or src.axis != self.axis or src.ranges != self.ranges:
            got = (src.axis, src.ranges) if isinstance(src, HeadSplit) else type(src).__name__
            raise ValueError(f"copy into a HeadSplit of axis {self.axis}, ranges {self.ranges} from {got}")
        for p, q in zip(self.parts, src.parts, strict=True):
            if p.shape != q.shape:
                raise ValueError(f"copy of a part {tuple(q.shape)} into one of {tuple(p.shape)}")
            p.copy_(q)
        return self

    def whole(self) -> torch.Tensor:
        """Every index on the home device, each from the first member that
        holds it."""
        pieces, top = [], 0
        for p, (lo, hi) in zip(self.parts, self.ranges):
            if hi > top:
                pieces.append(p.narrow(self.axis, top - lo, hi - top).to(self.parts[0].device))
                top = hi
        return torch.cat(pieces, dim=self.axis)


def whole(t):
    """A cache tensor whole on one device (``HeadSplit.whole``)."""
    return t.whole() if isinstance(t, HeadSplit) else t


def zeros_like(t):
    """A zeroed twin of a cache leaf: a tensor's ``torch.zeros_like``, a
    ``HeadSplit``'s ``zeros_like()``."""
    return t.zeros_like() if isinstance(t, HeadSplit) else torch.zeros_like(t)


def _kv_range(i: int, n: int, spec: A.AttnSpec, kv_split: bool) -> tuple[int, int]:
    """[lo, hi) of the KV heads member i of n reads: its own where the KV
    heads split, else the KV heads of its query heads."""
    if kv_split:
        return i * spec.n_kv_heads // n, (i + 1) * spec.n_kv_heads // n
    hq, g = spec.n_heads // n, spec.n_heads // spec.n_kv_heads
    lo, hi = i * hq // g, ((i + 1) * hq - 1) // g + 1
    if hq % (hi - lo) or (hq >= g and hq % g) or (hq < g and g % hq):
        raise NotImplementedError(f"{hq} query heads a member do not map onto whole KV groups of {g}")
    return lo, hi


def init_caches(gp: GroupParams, cfg, batch: int, max_seq: int, *, stacked: bool = False):
    """Zeroed serve caches of a backbone split over ``gp``'s group: one
    {"k", "v"} dict an attention layer (``lm.init_serve_caches``' layout)
    and a recurrent layer's state, or, with ``stacked`` (attention-only
    stacks), two (L, batch, max_seq, n_kv, hd) tensors
    (``lm.init_stacked_caches``'). A K or V cache is placed as the
    reference's ``cache_specs`` places it over a model axis of the group's
    size: a ``HeadSplit`` of each member's own KV heads where they divide
    the group; else a ``HeadSplit`` by sequence, member i holding positions
    [i * max_seq / n, (i + 1) * max_seq / n) (context parallelism), where
    the group divides ``max_seq``; else whole on the home device. A
    recurrent state as ``_init_state`` splits it."""
    from repro_torch.models.blocks import ATTN_KINDS

    kinds = cfg.layer_kinds()
    spec = A.AttnSpec.from_config(cfg, local=False)   # local layers' heads are the same
    n = len(gp.devices)
    lead = (cfg.n_layers,) if stacked else ()

    def zeros(seq, heads, dev):
        return torch.zeros(lead + (batch, seq, heads, spec.head_dim), dtype=torch.bfloat16, device=dev)

    def kv():
        if spec.n_kv_heads % n == 0:
            w = spec.n_kv_heads // n
            return HeadSplit([zeros(max_seq, w, d) for d in gp.devices], [(i * w, (i + 1) * w) for i in range(n)])
        if max_seq % n == 0:
            w = max_seq // n
            return HeadSplit([zeros(w, spec.n_kv_heads, d) for d in gp.devices],
                             [(i * w, (i + 1) * w) for i in range(n)], axis=-3)
        return zeros(max_seq, spec.n_kv_heads, gp.home)

    if stacked:
        return {"k": kv(), "v": kv()}
    return [{"k": kv(), "v": kv()} if kind in ATTN_KINDS else _init_state(gp["stack"][l][kind], kind, cfg, batch)
            for l, kind in enumerate(kinds)]


def seq_split(t) -> bool:
    """True for a K/V cache split by sequence positions (``init_caches``)."""
    return isinstance(t, HeadSplit) and t.axis == -3


def _init_state(gk: GroupParams, kind: str, cfg, batch: int) -> dict:
    """A recurrent layer's zeroed serve state over the group, split as the
    reference's ``cache_specs`` splits it where the mixer runs split:
    mamba's ``ssm`` and ``conv`` and mLSTM's ``conv`` by ``d_inner``,
    mLSTM's ``c`` by heads when they divide the group; the rest (and
    sLSTM's whole state) on the home device."""
    from repro_torch.models.blocks import init_block_cache

    state = init_block_cache(kind, batch, 1, cfg, torch.bfloat16, device=gk.home)
    n = len(gk.devices)
    axes = {}
    if kind in ("mamba", "mlstm") and _split(gk.specs["conv_w"], 1):
        axes["conv"] = -1
        if kind == "mamba":
            axes["ssm"] = -2
        elif cfg.n_heads % n == 0:
            axes["c"] = -3
    for name, axis in axes.items():
        t = state[name]
        w = t.shape[axis] // n
        shape = list(t.shape)
        shape[axis] = w
        state[name] = HeadSplit([torch.zeros(shape, dtype=t.dtype, device=d) for d in gk.devices],
                                [(i * w, (i + 1) * w) for i in range(n)], axis)
    return state


def _member_cache(cache, i: int, lo: int, hi: int):
    """Member i's {"k", "v"}: its ``HeadSplit`` parts, heads [lo, hi)."""
    if cache is None:
        return None
    if not isinstance(cache["k"], HeadSplit) or seq_split(cache["k"]):
        raise ValueError("a group whose KV heads split takes caches split by heads: make them with params= "
                         "(lm.init_serve_caches, lm.init_stacked_caches)")
    if cache["k"].ranges[i] != (lo, hi):
        raise ValueError(f"member {i} reads KV heads {(lo, hi)}, its cache part holds {cache['k'].ranges[i]}")
    return {n: cache[n].parts[i] for n in ("k", "v")}


def _full_proj(ga: GroupParams, name: str, xs: list[torch.Tensor]) -> torch.Tensor:
    """A projection whose heads are not split, on the home device: the
    members' ``d_model`` partials summed, or member 0's where the weight is
    replicated."""
    spec = ga.specs[name]
    if _split(spec, 0):
        w = ga.members[0][name].shape[0]
        return reduce([A._proj(xs[i][..., i * w:(i + 1) * w], m[name]) for i, m, _ in _each(ga)], ga.home)
    return A._proj(xs[0], ga.local[name])


def _write_part(part: torch.Tensor, new: torch.Tensor, lo: int, mode: str, pos) -> None:
    """Write the fresh K or V ``new`` (b, s, nk, hd) into ``part`` (b, n_i,
    nk, hd), the cache's positions [lo, lo + n_i), in place, as
    ``attention.attend`` writes a whole cache: positions [0, s) in a
    prefill, each row's [offs, offs + s) in an offset prefill, ``pos`` in a
    decode. Only the fresh K/V of the part's own positions reach it; a
    position held by another part leaves it as it was (a device ``pos``
    selects with ``where``, so nothing is read back to the host)."""
    dev, n_i = part.device, part.shape[1]
    b, s = new.shape[:2]
    if mode == "prefill" and pos is None:
        x1 = min(lo + n_i, s)
        if x1 > lo:
            part[:, :x1 - lo] = new[:, lo:x1].to(dev, part.dtype)
        return
    new = new.to(dev, part.dtype)
    if mode == "prefill":
        src = torch.arange(lo, lo + n_i, device=dev)[None] - pos.long().to(dev)[:, None]     # (b, n_i)
        hit = ((src >= 0) & (src < s))[:, :, None, None]
        picked = torch.gather(new, 1, src.clamp(0, s - 1)[:, :, None, None].expand(b, n_i, *new.shape[2:]))
        part.copy_(torch.where(hit, picked, part))
    elif isinstance(pos, torch.Tensor) and pos.dim() == 0:
        at = pos.long().to(dev).reshape(1) - lo
        inside = (at >= 0) & (at < n_i)
        at = at.clamp(0, n_i - 1)
        part.index_copy_(1, at, torch.where(inside, new, part.index_select(1, at)))
    elif isinstance(pos, torch.Tensor):
        rows = torch.arange(b, device=dev)
        at = pos.long().to(dev) - lo
        inside = ((at >= 0) & (at < n_i))[:, None, None]
        at = at.clamp(0, n_i - 1)
        part[rows, at] = torch.where(inside, new[:, 0], part[rows, at])
    elif lo <= pos < lo + n_i:
        part[:, pos - lo:pos - lo + 1] = new


def _write_split(cache, k: torch.Tensor, v: torch.Tensor, mode: str, pos) -> None:
    """``_write_part`` of the fresh K and V into each member's part, as
    that member."""
    for name, new in (("k", k), ("v", v)):
        for i, (part, (lo, _)) in enumerate(zip(cache[name].parts, cache[name].ranges)):
            with as_member(i):
                _write_part(part, new, lo, mode, pos)


def attend_split(q, k, v, spec: A.AttnSpec, mode: str, cache, pos, positions: torch.Tensor) -> torch.Tensor:
    """``attention.attend`` over a K/V cache split by sequence (``seq_split``):
    the fresh ``k`` / ``v`` go into the parts that hold their positions
    (``_write_part``); a prefill attends over the fresh K/V as before; a
    decode step or an offset prefill runs each member's query heads over
    its own positions (``attention.sdpa_partial``: the same mask, window
    and softcap, by global position) on its device, and the unnormalised
    partial outputs with their fp32 sums and largest logits are gathered on
    ``q``'s device and merged there (``attention.merge_partials``). What
    moves is the queries out and the partials back, never a cached
    position. ``q`` holds every query head; ``positions`` (b, s) are its
    global positions."""
    ks, vs = cache["k"], cache["v"]
    _write_split(cache, k, v, mode, pos)
    if mode == "prefill" and pos is None:
        return A._sdpa(q, k, v, A.causal_mask(q.shape[1], k.shape[1], 0, spec.window, device=q.device), spec)
    parts = []
    for i, (pk, pv, (lo, hi)) in enumerate(zip(ks.parts, vs.parts, ks.ranges)):
        with as_member(i):
            dev = pk.device
            mask = A.row_mask(positions.to(dev), hi - lo, spec.window, k_offset=lo)
            parts.append([t[None] for t in A.sdpa_partial(q.to(dev), pk.to(q.dtype), pv.to(q.dtype), mask, spec)])
    return A.merge_partials(*(gather([p[j] for p in parts], q.device, dim=0) for j in range(3)), q.dtype)


def attention(ga: GroupParams, x: torch.Tensor, spec: A.AttnSpec, mode: str, cache=None, pos=None):
    """One attention layer over the group: (y (b, s, d) on the home device,
    cache)."""
    n, home = len(ga.devices), ga.home
    positions = A.query_positions(x, mode, pos)
    xs = [x.to(d) for d in ga.devices]
    rope = dict(theta=spec.rope_theta, rope_pct=spec.rope_pct)
    heads_split = _split(ga.specs["wq"], 1)
    if heads_split and _split(ga.specs["wk"], 1):
        # the KV heads split with the query heads: each member its own
        parts = []
        for i, m, dev in _each(ga):
            lo, hi = _kv_range(i, n, spec, True)
            pos_i = positions.to(dev)
            q = apply_rope(A._proj(xs[i], m["wq"]), pos_i, **rope)
            k = apply_rope(A._proj(xs[i], m["wk"]), pos_i, **rope)
            v = A._proj(xs[i], m["wv"])
            local_spec = dataclasses.replace(spec, n_heads=spec.n_heads // n, n_kv_heads=hi - lo)
            o, _ = A.attend(q, k, v, local_spec, mode, _member_cache(cache, i, lo, hi),
                            pos.to(dev) if isinstance(pos, torch.Tensor) else pos)
            parts.append(A._out(o, m["wo"]))
        return reduce(parts, home), cache
    # the K/V whole on the home device: d_model partials summed, or replicated
    k = apply_rope(_full_proj(ga, "wk", xs), positions, **rope)
    v = _full_proj(ga, "wv", xs)
    split = cache is not None and seq_split(cache["k"])
    if cache is not None and not split and isinstance(cache["k"], HeadSplit):
        raise ValueError("a group whose KV heads do not divide it takes caches split by sequence or whole: make "
                         "them with params= (lm.init_serve_caches, lm.init_stacked_caches)")
    fresh = cache is None or (mode == "prefill" and pos is None)
    if heads_split and fresh:
        # attention over the fresh K/V: each member's query heads over
        # copies of the KV heads they read; the cache takes its positions
        if split:
            _write_split(cache, k, v, mode, pos)
        elif cache is not None:
            cache["k"][:, :k.shape[1]] = k.to(cache["k"].dtype)
            cache["v"][:, :v.shape[1]] = v.to(cache["v"].dtype)
        parts = []
        for i, m, dev in _each(ga):
            lo, hi = _kv_range(i, n, spec, False)
            q = apply_rope(A._proj(xs[i], m["wq"]), positions.to(dev), **rope)
            local_spec = dataclasses.replace(spec, n_heads=spec.n_heads // n, n_kv_heads=hi - lo)
            o, _ = A.attend(q, k[:, :, lo:hi].to(dev), v[:, :, lo:hi].to(dev), local_spec, "train")
            parts.append(A._out(o, m["wo"]))
        return reduce(parts, home), cache
    if heads_split:
        # every query head on the home device, where the cache's partials meet
        q = gather([apply_rope(A._proj(xs[i], m["wq"]), positions.to(dev), **rope) for i, m, dev in _each(ga)],
                   home, dim=2)
    else:
        q = apply_rope(_full_proj(ga, "wq", xs), positions, **rope)
    if split:
        o = attend_split(q, k, v, spec, mode, cache, pos, positions)
    else:
        o, cache = A.attend(q, k, v, spec, mode, cache, pos)
    if heads_split:
        hq = spec.n_heads // n
        return reduce([A._out(o[:, :, i * hq:(i + 1) * hq].to(dev), m["wo"]) for i, m, dev in _each(ga)],
                      home), cache
    if _split(ga.specs["wo"], 2):
        return gather([A._out(o.to(d), m["wo"]) for _, m, d in _each(ga)], home), cache
    return A._out(o, ga.local["wo"]), cache


# ---------------------------------------------------------------------------
# FFN and MoE
# ---------------------------------------------------------------------------


def ffn(gf: GroupParams, z: torch.Tensor, *, act: str, gated: bool) -> torch.Tensor:
    """Column split ``w_gate``/``w_up``, row split ``w_down``: the members'
    partials summed; a replicated FFN runs on the home device."""
    if not _split(gf.specs["w_up"], 1):
        return FFN.ffn(gf.local, z, act=act, gated=gated)
    return reduce([FFN.ffn(m, z.to(d), act=act, gated=gated) for _, m, d in _each(gf)], gf.home)


def moe_ffn(gm: GroupParams, x: torch.Tensor, mcfg, *, act: str):
    """The MoE FFN over the group: (y, aux) as ``moe.moe_ffn``."""
    orig_shape = x.shape
    s, d = x.shape[-2], x.shape[-1]
    xg = x.reshape(-1, s, d)
    disp = MOE.dispatch(gm.local["router"], xg, mcfg)
    c, n = disp["c"], len(gm.devices)
    wspec = gm.specs["w_gate"]
    shared_split = mcfg.n_shared and _split(gm.specs["shared"]["w_up"], 1)
    if not (_split(wspec, 0) or _split(wspec, 2)):
        y = MOE.combine(MOE.expert_outputs(gm.local, xg, disp["slot_token"], disp["slot_valid"], c, act=act), disp)
    else:
        parts = []
        for i, m, dev in _each(gm):
            e_loc = m["w_gate"].shape[0]
            lo = i * e_loc * c if _split(wspec, 0) else 0
            mine = {k: v.to(dev) for k, v in disp.items() if k != "c"}
            xd = xg.to(dev)
            ye = MOE.expert_outputs(m, xd, mine["slot_token"][:, lo:lo + e_loc * c],
                                    mine["slot_valid"][:, lo:lo + e_loc * c], c, act=act)
            y_i = MOE.combine(ye, mine, lo)
            if shared_split:
                y_i = y_i + FFN.ffn(m["shared"], xd, act=act, gated=True)
            parts.append(y_i)
        y = reduce(parts, gm.home)
    if mcfg.n_shared and not shared_split:
        y = y + FFN.ffn(gm.local["shared"], xg, act=act, gated=True)
    return y.reshape(orig_shape), MOE.aux_loss(disp, mcfg)


# ---------------------------------------------------------------------------
# Recurrent mixers
# ---------------------------------------------------------------------------


def _cols(g: GroupParams, name: str, xs: list[torch.Tensor]) -> torch.Tensor:
    """x @ W for a W (in, out) split on its output axis: the members'
    column blocks gathered on the home device; a replicated W there."""
    if not _split(g.specs[name], 1):
        return xs[0] @ g.local[name].to(xs[0].dtype)
    return gather([xs[i] @ m[name].to(xs[i].dtype) for i, m, _ in _each(g)], g.home)


def _part(state, name: str, i: int):
    """Member i's part of a state leaf (the whole leaf where it is not
    split); None without a state."""
    if state is None:
        return None
    t = state[name]
    return t.parts[i] if isinstance(t, HeadSplit) else t


def _split_state(state) -> None:
    """A mixer split by ``d_inner`` takes its state split as ``_init_state``
    splits it."""
    if state is not None and not isinstance(state["conv"], HeadSplit):
        raise ValueError("a group whose recurrent mixers split takes states split over its members: make them "
                         "with params= (lm.init_serve_caches)")


def _write_whole(state, new: dict) -> None:
    if state is not None:
        for name, t in new.items():
            state[name].copy_(t)


def mamba(gm: GroupParams, x: torch.Tensor, cfg, state=None) -> torch.Tensor:
    """One mamba mixer over the group -> y on the home device; a serve
    ``state`` (``_init_state``) is updated in place."""
    xs = [x.to(d) for d in gm.devices]
    xin, z = torch.chunk(_cols(gm, "in_proj", xs), 2, dim=-1)
    if not _split(gm.specs["conv_w"], 1):
        y, new = S.mamba_mix(gm.local, xin, z, cfg, state)
        _write_whole(state, new)
        return y
    _split_state(state)
    w, d_state = gm.members[0]["conv_w"].shape[1], gm.local["a_log"].shape[1]
    xcs, convs, projs = [], [], []
    for i, m, dev in _each(gm):
        xc, conv = S.mamba_conv(m, xin[..., i * w:(i + 1) * w].to(dev), _part(state, "conv", i))
        xcs.append(xc)
        convs.append(conv)
        projs.append(xc @ m["x_proj"].to(xc.dtype))
    dt_r, b, c = S.mamba_split_proj(reduce(projs, gm.home), gm.local["dt_proj"].shape[0], d_state)
    outs = []
    for i, m, dev in _each(gm):
        y, h = S.mamba_scan(m, xcs[i], z[..., i * w:(i + 1) * w].to(dev), S.mamba_dt(m, dt_r.to(dev)),
                            b.to(dev), c.to(dev), _part(state, "ssm", i))
        outs.append(y @ m["out_proj"].to(y.dtype))
        if state is not None:
            _part(state, "ssm", i).copy_(h)
            _part(state, "conv", i).copy_(convs[i])
    return reduce(outs, gm.home)


def mlstm(gl: GroupParams, x: torch.Tensor, cfg, state=None) -> torch.Tensor:
    """One mLSTM cell over the group -> y on the home device; a serve
    ``state`` is updated in place."""
    xs = [x.to(d) for d in gl.devices]
    a_in, z = torch.chunk(_cols(gl, "up_proj", xs), 2, dim=-1)
    if not _split(gl.specs["conv_w"], 1):
        y, new = S.mlstm_mix(gl.local, a_in, z, cfg, state)
        _write_whole(state, new)
        return y
    _split_state(state)
    dtype, (b, s, di), n, nh, home = x.dtype, a_in.shape, len(gl.devices), cfg.n_heads, gl.home
    w = gl.members[0]["conv_w"].shape[1]
    a_cs, proj = [], []
    for i, m, dev in _each(gl):
        a_i = a_in[..., i * w:(i + 1) * w].to(dev)
        a_c, conv = S.mlstm_conv(m, a_i, _part(state, "conv", i))
        a_cs.append(a_c)
        proj.append(S.mlstm_proj(m, a_i, a_c))
        if state is not None:
            _part(state, "conv", i).copy_(conv)
    q, k, v, ig, logf = S.mlstm_gates(*(reduce([p[j] for p in proj], home) for j in range(5)), gl.local["f_bias"])
    hd = q.shape[-1]
    if state is None:
        c0, n0, m0 = S.mlstm_zero_state(b, nh, hd, home)
    else:
        c0, n0, m0 = state["c"], state["n"], state["m"]
    hs = []
    if nh % n == 0:
        hn = nh // n
        for i, m, dev in _each(gl):
            sl = slice(i * hn, (i + 1) * hn)
            c_i = c0.parts[i] if isinstance(c0, HeadSplit) else c0[:, sl].to(dev)
            h, c_i, n_i, m_i = S.mlstm_recur(q[:, :, sl].to(dev), k[:, :, sl].to(dev), v[:, :, sl].to(dev),
                                             ig[:, :, sl].to(dev), logf[:, :, sl].to(dev), c_i,
                                             n0[:, sl].to(dev), m0[:, sl].to(dev), dtype)
            hs.append(h.reshape(b, s, w))
            if state is not None:
                state["c"].parts[i].copy_(c_i)
                state["n"][:, sl].copy_(n_i)
                state["m"][:, sl].copy_(m_i)
    else:
        h, c, nn, mm = S.mlstm_recur(q, k, v, ig, logf, c0, n0, m0, dtype)
        _write_whole(state, {"c": c, "n": nn, "m": mm})
        hs = [h.reshape(b, s, di)[..., i * w:(i + 1) * w].to(dev) for i, dev in enumerate(gl.devices)]
    outs = [(hs[i] * torch.nn.functional.silu(z[..., i * w:(i + 1) * w].to(dev))) @ m["down_proj"].to(dtype)
            for i, m, dev in _each(gl)]
    return reduce(outs, home)


def slstm(gs: GroupParams, x: torch.Tensor, cfg, state=None) -> torch.Tensor:
    """sLSTM is replicated: the whole cell on the home device."""
    y, new = S.slstm_seq(gs.local, x, cfg, state)
    _write_whole(state, new)
    return y


_MIXERS = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_forward(kind: str, gp: GroupParams, h: torch.Tensor, cfg, *, mode: str, cache=None, pos=None):
    """``blocks.block_forward`` of one layer split over the group: (h_out,
    cache, moe aux or None), everything on the home device."""
    from repro_torch.models.blocks import ATTN_KINDS, _norm

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    p = gp.local
    x = _norm(cfg, p["norm1"], h)
    if kind in ATTN_KINDS:
        spec = A.AttnSpec.from_config(cfg, local=(kind == "attn_local"))
        y, cache = attention(gp["attn"], x, spec, mode, cache, pos)
    elif kind in _MIXERS:
        y = _MIXERS[kind](gp[kind], x, cfg, None if mode == "train" else cache)
    else:
        raise ValueError(kind)
    if "post_norm1" in p:
        y = _norm(cfg, p["post_norm1"], y)
    h = h + y
    aux: Optional[torch.Tensor] = None
    if "moe" in p or "ffn" in p:
        z = _norm(cfg, p["norm2"], h)
        if "moe" in p:
            y2, aux = moe_ffn(gp["moe"], z, cfg.moe, act=cfg.ffn_activation)
        else:
            y2 = ffn(gp["ffn"], z, act=cfg.ffn_activation, gated=cfg.ffn_gated)
        if "post_norm2" in p:
            y2 = _norm(cfg, p["post_norm2"], y2)
        h = h + y2
    return h, cache, aux
