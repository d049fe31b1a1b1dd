"""Checkpointing: atomic save / restore with a manifest, in the reference's
file format (``repro_torch.checkpoint.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_checkpoint,
    restore_checkpoint,
    restore_runtime_session,
    save_checkpoint,
    save_runtime_session,
)
