"""Architecture registry: one module per assigned architecture."""

from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    get_config,
    list_archs,
    reduce_config,
)
