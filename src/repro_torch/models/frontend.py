"""Modality frontend stubs: the prefix embeddings of the vision and audio
configs.

Counterpart of ``repro.models.frontend``. The ``vlm`` / ``audio``
architectures specify the transformer backbone only; their vision tower or
audio encoder is not implemented, in the reference as here. A caller
supplies precomputed patch or frame embeddings, which these helpers size
and splice ahead of the embedded tokens (the loss is masked over them).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig


def frontend_prefix_len(cfg: ModelConfig) -> int:
    """Number of prefix embedding positions the (stub) frontend supplies."""
    if cfg.frontend is None:
        return 0
    return cfg.frontend_seq


def prefix_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16) -> Optional[tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of the precomputed frontend embeddings, or None
    without a frontend (the reference returns a ``ShapeDtypeStruct``)."""
    p = frontend_prefix_len(cfg)
    if p == 0:
        return None
    return (batch, p, cfg.d_model), dtype


def splice_prefix(token_embeds: torch.Tensor, prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Concatenate frontend prefix embeddings ahead of token embeddings."""
    if prefix_embeds is None:
        return token_embeds
    return torch.cat([prefix_embeds.to(token_embeds.dtype), token_embeds], dim=1)
