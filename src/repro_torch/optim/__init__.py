"""Optimizers: SGD / Adam / AdamW as functions on dicts of tensors."""

from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adamw,
    apply_updates,
    make_optimizer,
    sgd,
)
