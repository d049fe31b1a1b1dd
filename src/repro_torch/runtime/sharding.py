"""Device meshes of the session's data axis, the counterpart of the data-axis
part of ``repro.runtime.sharding``.

The session shards *tenants* over ``("pod", "data")``: each logical shard
holds its tenants' pool slots, cache partitions and training state on one
device, and no value ever crosses between shards. So the data axis is
placement and routing only: one process drives every device, and the frozen
backbone is one replica per device.

  - ``Mesh``: a numpy object array of ``torch.device`` with its axis names.
  - ``make_mesh``: the one mesh constructor. ``devices=None`` takes every CUDA
    device in order and raises when there is none (a mesh never falls back to
    the CPU). A device may repeat only if it is ``cpu``: the port's form of the
    reference's forced host devices, so the CPU tests run a multi-device
    session in one process. A CUDA device listed twice raises.
  - ``session_mesh_layout`` / ``session_devices``: a session mesh's data
    groups and their devices, in shard order.
  - ``replicate_backbone``: one replica per *distinct* device; the caller's
    own tensors serve on the device they live on, so shards that share a
    device share one backbone.

A ``model`` axis above 1 (Megatron tensor parallelism over ``AxisRules`` /
``constrain``) needs collectives across cards and raises, naming slice 7b of
the port, as do the reference's parameter, FSDP, expert and ZeRO-1 spec trees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

Params = Any

#: the port's slice that brings the model axis
MODEL_AXIS_SLICE = "slice 7b: the model axis needs collectives across several GPUs"


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
        if d.type != "cpu" and d in seen:
            raise ValueError(f"device {d} listed twice: only the CPU may repeat in a mesh")
        seen.add(d)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def session_mesh_layout(mesh: Mesh) -> tuple[int, int, list[list[torch.device]]]:
    """``(n_data, n_model, groups)`` of a session mesh: tenants shard over
    ``("pod", "data")``, ``groups[s]`` is data shard ``s``'s device list. A
    ``model`` axis above 1 raises (slice 7b)."""
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
    if model_size > 1:
        raise NotImplementedError(f"a session mesh with a model axis of {model_size} is not ported ({MODEL_AXIS_SLICE})")
    order = data_axes + [i for i in range(mesh.devices.ndim) if i not in data_axes]
    grid = np.transpose(mesh.devices, order).reshape(-1, model_size)
    return grid.shape[0], model_size, [list(row) for row in grid]


def session_devices(mesh: Mesh) -> list[torch.device]:
    """The data-axis device list of a session mesh, in shard order."""
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
