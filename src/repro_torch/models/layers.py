"""Elementary layers: norms, embeddings, rotary embeddings, activations.

Counterpart of ``repro.models.layers``. Every fp32 upcast sits where the
reference has it, so a float32 config agrees to rounding and a bf16 config
rounds at the same points.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = Any


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, *, device=None) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, *, eps: float = 1e-6, unit_offset: bool = True) -> torch.Tensor:
    """RMSNorm in fp32. ``unit_offset`` follows gemma: effective scale = 1 + w."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    scale = 1.0 + scale if unit_offset else scale
    return (xf * scale).to(dtype)


def init_layernorm(d: int, *, device=None) -> Params:
    return {
        "scale": torch.ones((d,), dtype=torch.float32, device=device),
        "bias": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def layernorm(params: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    out = xf * params["scale"].float() + params["bias"].float()
    return out.to(dtype)


def make_norm(norm_type: str, d: int, *, device=None) -> Params:
    if norm_type == "rmsnorm":
        return init_rmsnorm(d, device=device)
    if norm_type == "layernorm":
        return init_layernorm(d, device=device)
    raise ValueError(norm_type)


def apply_norm(norm_type: str, params: Params, x: torch.Tensor, *, eps: float, unit_offset: bool = False) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rmsnorm(params, x, eps=eps, unit_offset=unit_offset)
    if norm_type == "layernorm":
        return layernorm(params, x, eps=eps)
    raise ValueError(norm_type)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(generator: torch.Generator, vocab: int, d: int, dtype) -> Params:
    table = torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02
    return {"table": table.to(dtype)}


def embed(params: Params, ids: torch.Tensor, *, scale_by_sqrt_dim: bool, dtype) -> torch.Tensor:
    x = params["table"][ids].to(dtype)
    if scale_by_sqrt_dim:
        # The scale is rounded to the model dtype before the product, as the
        # reference does; a Python scalar needs no host-to-device copy.
        x = x * torch.tensor(math.sqrt(params["table"].shape[1])).to(dtype).item()
    return x


def unembed(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Readout: logits = h @ E^T, computed in fp32."""
    return h.float() @ params["table"].float().T


# ---------------------------------------------------------------------------
# Rotary position embeddings (with partial-rotary support)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, rope_pct: float, *, device=None) -> torch.Tensor:
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / max(rot_dim, 1)
    return 1.0 / (theta**exponent)  # (rot_dim/2,)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10_000.0,
    rope_pct: float = 1.0,
) -> torch.Tensor:
    """Apply rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    if rot_dim == 0:
        return x
    freqs = rope_freqs(head_dim, theta, rope_pct, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, rot/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, rot/2)
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., : rot_dim // 2], x_rot[..., rot_dim // 2 :]
    xf1, xf2 = x1.float(), x2.float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    out = torch.cat([out1, out2], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot_dim < head_dim else out


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)
