"""Fault tolerance and the session's data axis: ``Supervisor``,
``SessionSupervisor``, ``StragglerMonitor``, ``healthy_mesh_shape``,
``elastic_remesh``, ``elastic_session_mesh`` (``repro_torch.runtime.fault``)
and ``Mesh``, ``make_mesh``, ``session_mesh_layout``, ``session_devices``,
``replicate_backbone``, ``shard_backbone``, ``ShardScope``,
``SESSION_TP_RULES`` (``repro_torch.runtime.sharding``) and GPipe's
``split_stages``, ``pipeline_apply``, ``pipeline_prefill``,
``bubble_fraction`` (``repro_torch.runtime.pipeline_par``);
``SessionRuntime`` is re-exported from ``repro_torch.core.runtime``."""

from repro_torch.core.runtime import SessionRuntime  # noqa: F401
from repro_torch.runtime.fault import (  # noqa: F401
    SessionSupervisor,
    StragglerMonitor,
    Supervisor,
    elastic_remesh,
    elastic_session_mesh,
    healthy_mesh_shape,
)
from repro_torch.runtime.pipeline_par import (  # noqa: F401
    bubble_fraction,
    pipeline_apply,
    pipeline_prefill,
    split_stages,
)
from repro_torch.runtime.sharding import (  # noqa: F401
    SESSION_TP_RULES,
    Mesh,
    ShardScope,
    make_mesh,
    replicate_backbone,
    session_devices,
    session_mesh_layout,
    shard_backbone,
)
