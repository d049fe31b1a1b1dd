"""Fault tolerance on one device (``repro_torch.runtime.fault``):
``Supervisor``, ``SessionSupervisor``, ``StragglerMonitor`` and
``healthy_mesh_shape``; ``SessionRuntime`` is re-exported from
``repro_torch.core.runtime``. The reference's sharding rules, pipeline
parallelism and elastic re-mesh need several devices (slice 7)."""

from repro_torch.core.runtime import SessionRuntime  # noqa: F401
from repro_torch.runtime.fault import (  # noqa: F401
    SessionSupervisor,
    StragglerMonitor,
    Supervisor,
    healthy_mesh_shape,
)
