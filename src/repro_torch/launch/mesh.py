"""Production mesh construction, the counterpart of ``repro.launch.mesh``.

Functions, never module-level constants, so importing this module touches no
device. Each goes through ``runtime.sharding.make_mesh``, which raises when
there are fewer devices than the mesh needs. ``devices="meta"`` lays the
mesh over the ``meta`` device repeated (no memory, no card): the dry-run's
production meshes, the reference's forced host devices.
"""

from __future__ import annotations

from repro_torch.runtime.sharding import Mesh, make_mesh


def _devices(devices, n: int):
    return [devices] * n if isinstance(devices, str) else devices


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512 devices);
    ``devices`` as in ``make_debug_mesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=_devices(devices, 512 if multi_pod else 256))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, devices=None) -> Mesh:
    """A small (data, model) mesh for tests (``devices``: an explicit list,
    e.g. repeated ``cpu`` entries, or one device type, ``"cpu"`` or
    ``"meta"``, repeated)."""
    return make_mesh((n_data, n_model), ("data", "model"), devices=_devices(devices, n_data * n_model))


def mesh_batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes that shard the global batch."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def mesh_chip_count(mesh: Mesh) -> int:
    return mesh.size
