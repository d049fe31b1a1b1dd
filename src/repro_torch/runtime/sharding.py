"""Device meshes, axis rules and parameter spec trees: the counterpart of
``repro.runtime.sharding``.

The session shards *tenants* over ``("pod", "data")``: each logical shard
holds its tenants' pool slots, cache partitions and training state on one
device, and no value ever crosses between shards. So the data axis is
placement and routing only: one process drives every device, and on a
data-only mesh the frozen backbone is one replica per device.

A ``model`` axis above 1 gives each data shard a *group* of devices that
holds ONE Megatron-split backbone replica (``shard_backbone``): attention
heads, FFN hidden, experts and vocabulary split over the group's members as
``param_specs`` says, everything else replicated. ``models.tp`` runs a
block on a group: each member computes with its shard, partial results are
copied onto the group's first device and summed there in member order.

  - ``Mesh``: a numpy object array of ``torch.device`` with its axis names.
  - ``make_mesh``: the one mesh constructor. ``devices=None`` takes every CUDA
    device in order and raises when there is none (a mesh never falls back to
    the CPU). A device may repeat only if it is ``cpu`` or ``meta``: the
    port's form of the reference's forced host devices, so the CPU tests run
    a multi-device session in one process and the dry-run
    (``launch.dryrun``) lays a production mesh over ``meta``. A CUDA device
    listed twice raises.
  - ``session_mesh_layout`` / ``session_devices``: a session mesh's data
    groups and their devices, in shard order.
  - ``replicate_backbone``: one replica per *distinct* device; the caller's
    own tensors serve on the device they live on, so shards that share a
    device share one backbone.

  - ``AxisRules`` / ``SESSION_TP_RULES`` (and the dry-run's
    ``FSDP_RULES_KW`` / ``EP_RULES_KW``): logical axis -> mesh axis;
    ``ShardScope``: a group's 1-D ``("model",)`` mesh and its rules, as
    data (a ``tp.GroupParams`` carries its own devices).
  - spec trees: a spec is a tuple with one entry per dimension, an axis
    name, a tuple of axis names or None (replicated): ``param_specs`` (the
    reference's rule table over the port's flat per-layer paths),
    ``session_param_specs``, ``zero1_specs``, ``fsdp_param_specs``,
    ``ep_param_specs``, ``maybe_fsdp_specs``, ``spec_shards`` and
    ``per_device_bytes``. ``convert.specs_from_reference`` maps the
    reference's periods/remainder spec trees onto these.

The reference's ``constrain`` (a sharding constraint on an activation),
``named``, ``batch_spec`` and ``replicated`` place arrays for XLA's
partitioner, and its ``sharding_scope`` / ``suspend_scope`` / ``scope_ctx``
make the rules ``constrain`` reads current; here every tensor is placed
where it is made, so none of them has a counterpart.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence

import numpy as np
import torch

Params = Any
Spec = tuple


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices: ``devices`` (numpy object array of
    ``torch.device``, one axis per name) over ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(int(n) for n in self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _device(d) -> torch.device:
    """A ``torch.device`` with its index where the type has one (``cuda`` ->
    the current CUDA device)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. ``devices=None`` takes the CUDA
    devices in order; an explicit list pins the grid to its first
    ``prod(shape)`` entries (the elastic path rebuilds a mesh from whatever
    survived)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} != axes {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape}: every axis needs >= 1 device")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(devices=None) takes the CUDA devices, and there is none")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    devices = devices[:n]
    seen = set()
    for d in devices:
        if d.type not in ("cpu", "meta") and d in seen:
            raise ValueError(f"device {d} listed twice: only the CPU (and meta) may repeat in a mesh")
        seen.add(d)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def session_mesh_layout(mesh: Mesh) -> tuple[int, int, list[list[torch.device]]]:
    """``(n_data, n_model, groups)`` of a session mesh: tenants shard over
    ``("pod", "data")``, ``groups[s]`` is data shard ``s``'s device list
    (``n_model`` devices: one backbone replica split over a model axis, a
    single device on a data-only mesh)."""
    data_axes, model_size = [], 1
    for i, (ax, size) in enumerate(zip(mesh.axis_names, mesh.shape)):
        if ax in ("data", "pod"):
            data_axes.append(i)
        elif ax == "model":
            model_size = size
        elif size > 1:
            raise ValueError(
                f"session meshes shard tenants on ('pod', 'data') and the backbone on 'model' only; "
                f"axis {ax!r} has size {size}"
            )
    order = data_axes + [i for i in range(mesh.devices.ndim) if i not in data_axes]
    grid = np.transpose(mesh.devices, order).reshape(-1, model_size)
    return grid.shape[0], model_size, [list(row) for row in grid]


def session_devices(mesh: Mesh) -> list[torch.device]:
    """The data-axis device list of a session mesh, in shard order: each
    group's first device, where its host-side state lives."""
    return [g[0] for g in session_mesh_layout(mesh)[2]]


def _to(tree: Params, device: torch.device) -> Params:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _home(params: Params) -> Optional[torch.device]:
    """The device of the first tensor in ``params``."""
    if isinstance(params, torch.Tensor):
        return params.device
    items = params.values() if isinstance(params, dict) else params if isinstance(params, (list, tuple)) else ()
    for v in items:
        d = _home(v)
        if d is not None:
            return d
    return None


def replicate_backbone(params: Params, devices) -> list[Params]:
    """The frozen backbone on every device of ``devices``, in order: one
    replica per distinct device, the caller's own tree on the device it
    lives on (never cloned), a copy on each other device."""
    home = _home(params)
    replicas: dict[torch.device, Params] = {}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in replicas:
            replicas[d] = params if d == home else _to(params, d)
        out.append(replicas[d])
    return out


# ---------------------------------------------------------------------------
# Axis rules and a shard's model group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical axis name -> mesh axis (or a tuple of them, or None:
    replicated). The reference's table, field for field."""

    batch: Any = ("pod", "data")
    seq: Any = None
    heads: Any = "model"
    vocab: Any = "model"
    ffn: Any = "model"
    expert: Any = "model"
    capacity: Any = None
    d_inner: Any = "model"
    logits_batch: Any = ("pod", "data")
    expert_group: Any = ("pod", "data")
    layers: Any = None

    def resolve(self, mesh_axes: tuple[str, ...], logical: Any) -> Any:
        """The mesh axes of ``logical`` (a rule name or a literal axis spec)
        that ``mesh_axes`` has; None when none is left."""
        v = getattr(self, logical) if isinstance(logical, str) and hasattr(self, logical) else logical
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in mesh_axes else None
        vs = tuple(a for a in v if a in mesh_axes)
        return vs if vs else None


#: Within one data shard's model group the rows are not split (the data
#: axis lies across groups), so every batch-like axis replicates and the
#: tensor axes follow Megatron.
SESSION_TP_RULES = AxisRules(
    batch=None, seq=None, heads="model", vocab="model", ffn="model", expert="model", capacity=None,
    d_inner="model", logits_batch=None, expert_group=None, layers="model",
)

#: 'fsdp': the batch over the (data, model) grid, every weight split and
#: gathered a layer at a time; the loss logits batch on 'data', vocab on
#: 'model'. The reference's table, field for field.
FSDP_RULES_KW = dict(
    batch=("data", "model"), heads=None, vocab="model", ffn=None, expert=None, capacity=None,
    d_inner=None, logits_batch=("data",), expert_group=("data", "model"),
)

#: 'ep': 'fsdp' for the dense path, the MoE experts on 'model' with their
#: buffers grouped on ('pod', 'data').
EP_RULES_KW = dict(
    batch=("data", "model"), heads=None, vocab="model", ffn=None, expert="model", capacity=None,
    d_inner=None, logits_batch=("data",), expert_group=("pod", "data"),
)


@dataclasses.dataclass(frozen=True)
class ShardScope:
    """One data shard's model group as a 1-D ``("model",)`` mesh with its
    rules (``SessionRuntime._scope``)."""

    mesh: Mesh
    rules: AxisRules = SESSION_TP_RULES


def group_mesh(devices) -> Mesh:
    """A 1-D ``("model",)`` mesh over ``devices`` as given. Unlike
    ``make_mesh`` it takes a CUDA device listed twice: a group of one
    card's members, which runs the split on one card."""
    devices = [_device(d) for d in devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, ("model",))


def shard_submesh(mesh: Mesh, shard: int) -> Mesh:
    """Data shard ``shard``'s model group as its own 1-D ``("model",)``
    mesh: the devices every dispatch of that shard runs on."""
    return group_mesh(session_mesh_layout(mesh)[2][shard])


# ---------------------------------------------------------------------------
# Parameter spec trees
# ---------------------------------------------------------------------------


def _axis_size(mesh: Mesh, axis: Any) -> int:
    axes = (axis,) if isinstance(axis, str) else axis
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def _divisible(dim: int, mesh: Mesh, axis: Any) -> bool:
    """A split must divide the dimension evenly; a leaf that does not falls
    back to the next rule or to replication."""
    return axis is None or dim % _axis_size(mesh, axis) == 0


def _param_spec_for(path: str, shape: tuple[int, ...], mesh: Mesh) -> Spec:
    """The spec of one leaf at ``path`` ("stack/3/attn/wq") of ``shape``:
    the reference's rule table."""
    nd = len(shape)

    def m(ax_idx: int, axis="model") -> Any:
        return axis if _divisible(shape[ax_idx], mesh, axis) else None

    # Embedding / untied head: vocab split (the logits stay vocab split).
    if re.search(r"(embed|head)/table$", path):
        return (m(0), None)
    # Attention: split heads; where the head count does not divide the
    # group (musicgen's 24, paligemma's one KV head), split d_model instead
    # (the contraction: partial sums, row parallel).
    if re.search(r"attn/w[qkv]$", path):
        if m(1):
            return (None, "model", None)
        return (m(0), None, None)
    if re.search(r"attn/wo$", path):
        if m(0):
            return ("model", None, None)
        return (None, None, m(2))
    # MoE experts (E, D, F) / (E, F, D): split the experts; where their
    # count does not divide, the expert FFN's hidden dimension.
    if "/moe/" in path:
        if path.endswith("router"):
            return (None, None)
        if nd == 3:
            if m(0):
                return ("model", None, None)
            if path.endswith("w_down"):
                return (None, m(1), None)
            return (None, None, m(2))
        if re.search(r"w_(gate|up)$", path):    # the shared expert's FFN
            return (None, m(1))
        if path.endswith("w_down"):
            return (m(0), None)
        return (None,) * nd
    # Dense FFN.
    if re.search(r"ffn/w_(gate|up)$", path):
        return (None, m(1))
    if re.search(r"ffn/w_down$", path):
        return (m(0), None)
    # Mamba.
    if "/mamba/" in path:
        if path.endswith("in_proj"):
            return (None, m(1))
        if path.endswith(("x_proj", "out_proj", "a_log")):
            return (m(0), None)
        if path.endswith(("dt_proj", "conv_w")):
            return (None, m(1))
        if path.endswith(("dt_bias", "d_skip")):
            return (m(0),)
        return (None,) * nd
    # mLSTM.
    if "/mlstm/" in path:
        if path.endswith(("up_proj", "conv_w")):
            return (None, m(1))
        if path.endswith(("wq", "wk", "wv")):
            return (m(0), None, None)
        if path.endswith(("w_i", "w_f", "down_proj")):
            return (m(0), None)
        return (None,) * nd
    # sLSTM (a small dense recurrence), norms, biases: replicated.
    return (None,) * nd


def _map_path(fn, tree: Params, path: str = "", *rest: Params) -> Params:
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, f"{path}/{k}" if path else str(k), *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_path(fn, v, f"{path}/{i}" if path else str(i), *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _leaves(tree: Params) -> list:
    """The leaves of a tree of dicts and lists in order (a spec, a tuple,
    is a leaf)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_specs(params: Params, mesh: Mesh) -> Params:
    """The spec tree of a params tree (tensors, on the ``meta`` device for
    shapes alone): the port's flat layer list has no periods axis."""
    return _map_path(lambda path, leaf: _param_spec_for(path, tuple(leaf.shape), mesh), params)


def session_param_specs(params: Params, mesh: Mesh) -> Params:
    """Backbone placement of a session mesh: ``param_specs`` on a mesh with
    a ``model`` axis above 1, all replicated on a data-only one (there the
    adapters, moments and cache partitions carry the data axis, never the
    frozen backbone)."""
    if "model" in mesh.axis_names and _axis_size(mesh, "model") > 1:
        return param_specs(params, mesh)
    return _map_path(lambda path, leaf: (None,) * leaf.dim(), params)


def specs_all_replicated(specs: Params) -> bool:
    return all(all(part is None for part in spec) for spec in _leaves(specs))


def spec_shards(shape: tuple[int, ...], spec: Spec, mesh: Mesh) -> int:
    total = 1
    for part in spec:
        if part is not None:
            total *= _axis_size(mesh, part)
    return total


def per_device_bytes(params: Params, specs: Params, mesh: Mesh) -> float:
    """Bytes of the params one device holds under ``specs``."""
    total = 0.0
    for leaf, spec in zip(_leaves(params), _leaves(specs)):
        total += leaf.numel() * leaf.element_size() / spec_shards(tuple(leaf.shape), spec, mesh)
    return total


def zero1_specs(params: Params, specs: Params, mesh: Mesh) -> Params:
    """Optimizer-moment specs: the param specs with the first still
    replicated axis of at least 128 that divides also split over 'data'
    (ZeRO-1); a spec already on 'data' stays (idempotent)."""

    def upgrade(path, leaf, spec):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if any(p == "data" or (isinstance(p, tuple) and "data" in p) for p in parts):
            return tuple(parts)
        data_size = _axis_size(mesh, "data")
        for i, (dim, p) in enumerate(zip(shape, parts)):
            if p is None and dim % data_size == 0 and dim >= 128:
                parts[i] = "data"
                break
        return tuple(parts)

    return _map_path(upgrade, params, "", specs)


def _stacked_copies(path: str, cfg) -> int:
    """How many layers the reference stacks into this leaf: its periods
    leaves hold one copy per period, its remainder leaves one."""
    m = re.match(r"stack/(\d+)/", path)
    if cfg is None or m is None:
        return 1
    return cfg.n_periods if int(m.group(1)) < cfg.n_periods * cfg.period else 1


def fsdp_param_specs(params: Params, mesh: Mesh, *, cfg=None) -> Params:
    """Fully split weights: each leaf of at least 2^16 elements splits its
    first axis that divides the whole (data x model) grid, else the first
    that divides 'data'; the embedding / head tables prefer the vocab over
    the grid, else vocab on 'model' and d_model on 'data'. With ``cfg`` a
    layer's leaf counts at the size of the reference's stacked leaf (its
    periods' copies together), so the threshold picks the reference's
    leaves."""
    grid = tuple(a for a in ("data", "model") if a in mesh.axis_names)

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"(embed|head)/table$", path):
            if shape[0] % _axis_size(mesh, grid) == 0:
                return (grid, None)
            v_ok = shape[0] % _axis_size(mesh, "model") == 0
            d_ok = shape[1] % _axis_size(mesh, "data") == 0
            return ("model" if v_ok else None, "data" if d_ok else None)
        parts = [None] * len(shape)
        if leaf.numel() * _stacked_copies(path, cfg) >= (1 << 16):
            for i in range(len(shape)):
                if shape[i] % _axis_size(mesh, grid) == 0:
                    parts[i] = grid
                    break
                if shape[i] % _axis_size(mesh, "data") == 0:
                    parts[i] = "data"
                    break
        return tuple(parts)

    return _map_path(leaf_spec, params)


def ep_param_specs(params: Params, mesh: Mesh, *, cfg=None) -> Params:
    """'ep' weights: each MoE expert tensor (rank 3 under /moe/) splits E
    over 'model' (where it divides) and its first remaining axis that
    divides over 'data'; everything else as ``fsdp_param_specs`` (``cfg``
    as there)."""

    def leaf_spec(path, leaf, spec):
        shape = tuple(leaf.shape)
        if "/moe/" in path and len(shape) == 3:
            parts = [None] * 3
            if shape[0] % _axis_size(mesh, "model") == 0:
                parts[0] = "model"
            for i in (1, 2):
                if shape[i] % _axis_size(mesh, "data") == 0:
                    parts[i] = "data"
                    break
            return tuple(parts)
        return spec

    return _map_path(leaf_spec, params, "", fsdp_param_specs(params, mesh, cfg=cfg))


def maybe_fsdp_specs(params: Params, specs: Params, mesh: Mesh, *, threshold_bytes: float = 8e9) -> tuple[Params, bool]:
    """Where the TP-split weights still exceed ``threshold_bytes`` a device,
    split every large leaf over 'data' too (``zero1_specs``). Returns
    (specs, applied)."""
    if per_device_bytes(params, specs, mesh) <= threshold_bytes:
        return specs, False
    return zero1_specs(params, specs, mesh), True


# ---------------------------------------------------------------------------
# One backbone replica split over a model group
# ---------------------------------------------------------------------------


def shard_slices(shape: tuple[int, ...], spec: Spec, n: int, member: int) -> tuple[slice, ...]:
    """Member ``member``'s index into a leaf of ``shape`` split as ``spec``
    over a group of ``n``: a contiguous 1/n of each axis on 'model'."""
    out = []
    for dim, part in zip(shape, spec):
        if part is None:
            out.append(slice(None))
        elif part == "model":
            w = dim // n
            out.append(slice(member * w, (member + 1) * w))
        else:
            raise ValueError(f"a model group splits on 'model' only, not {part!r}")
    return tuple(out)


def shard_backbone(params: Params, group, *, specs: Params = None) -> list[Params]:
    """One split backbone replica over ``group`` (a list of devices, the
    same CUDA device repeated allowed): member i's tree holds, on
    ``group[i]``, its 1/n of every leaf ``param_specs`` splits over the
    group's ``("model",)`` axis (its own copy) and the replicated leaves
    (the caller's own tensor where it already lives on that device, else a
    copy). ``models.tp`` runs such a list. ``specs`` (default: the tree's
    own ``param_specs``) splits a subtree by its part of a whole tree's
    specs, a layer at a time."""
    mesh = group_mesh(group)
    n = mesh.size
    if specs is None:
        specs = param_specs(params, mesh)

    def member(i):
        dev = mesh.devices[i]

        def leaf(path, t, spec):
            if all(p is None for p in spec):
                return t.to(dev)
            return t[shard_slices(tuple(t.shape), spec, n, i)].to(dev, copy=True, memory_format=torch.contiguous_format)

        return _map_path(leaf, params, "", specs)

    return [member(i) for i in range(n)]
