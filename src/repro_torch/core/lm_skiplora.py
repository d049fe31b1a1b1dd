"""Skip2-LoRA at LM scale: adapters and their int8 quantisation.

Counterpart of the serving subset of ``repro.core.lm_skiplora``. For every
layer k an adapter (A_k: D->R, B_k: R->D) taps the residual-stream input of
block k, and its output is added to the final hidden state:

    h_final <- y_base + sum_k x^k A_k B_k

Adapters live in the flat layout {"A": (L, D, R), "B": (L, R, D)} -- one
``AdapterPool`` slot. ``adapters_to_stack`` / ``stack_to_adapters`` convert
to and from the per-layer list the port's layer stack takes (the
reference's periodic layout has no counterpart here). The cache modes,
populate and cached epochs belong to the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

Params = Any


@dataclasses.dataclass(frozen=True)
class SkipLoRAConfig:
    rank: int = 16
    mode: str = "full"             # full | int8 | freeze_a
    cache_dtype: str = "bfloat16"  # dtype for unquantised slots
    use_fused_kernel: bool = False

    def __post_init__(self):
        if self.mode not in ("full", "int8", "freeze_a"):
            raise ValueError(self.mode)


def init_adapters(generator: torch.Generator, cfg: ModelConfig, sl: SkipLoRAConfig) -> Params:
    """Flat adapters on ``generator.device``: A ~ N(0, 1/D) (fp32 master),
    B = 0 (identity at init)."""
    l, d, r = cfg.n_layers, cfg.d_model, sl.rank
    dev = generator.device
    return {
        "A": torch.randn((l, d, r), generator=generator, device=dev) / math.sqrt(d),
        "B": torch.zeros((l, r, d), dtype=torch.float32, device=dev),
    }


def adapters_to_stack(adapters: Params) -> list[Params]:
    """Flat {"A": (L, D, R), "B": (L, R, D)} -> per-layer [{"A", "B"}]."""
    return [{"A": a, "B": b} for a, b in zip(adapters["A"], adapters["B"])]


def stack_to_adapters(stack: list[Params]) -> Params:
    """Per-layer [{"A", "B"}] -> flat {"A": (L, D, R), "B": (L, R, D)}."""
    return {
        "A": torch.stack([p["A"] for p in stack]),
        "B": torch.stack([p["B"] for p in stack]),
    }


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rowwise over the last axis. Returns (q int8, scale fp32 without last
    axis). ``torch.round`` rounds half to even like ``jnp.round``, so the
    payload is bitwise the reference's."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)
