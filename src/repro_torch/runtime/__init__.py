"""Fault tolerance and the session's data axis: ``Supervisor``,
``SessionSupervisor``, ``StragglerMonitor``, ``healthy_mesh_shape``,
``elastic_remesh``, ``elastic_session_mesh`` (``repro_torch.runtime.fault``)
and ``Mesh``, ``make_mesh``, ``session_mesh_layout``, ``session_devices``,
``replicate_backbone`` (``repro_torch.runtime.sharding``); ``SessionRuntime``
is re-exported from ``repro_torch.core.runtime``. The reference's model-axis
rules and pipeline parallelism belong to slice 7b of the port."""

from repro_torch.core.runtime import SessionRuntime  # noqa: F401
from repro_torch.runtime.fault import (  # noqa: F401
    SessionSupervisor,
    StragglerMonitor,
    Supervisor,
    elastic_remesh,
    elastic_session_mesh,
    healthy_mesh_shape,
)
from repro_torch.runtime.sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate_backbone,
    session_devices,
    session_mesh_layout,
)
