"""Grouped-query attention with sliding windows, softcaps and KV caches.

Counterpart of ``repro.models.attention`` for the serving path: MHA / GQA /
MQA via ``n_kv_heads``, sliding windows, the gemma2 attention-logit softcap,
partial rotary and ``head_dim != d / heads``. Weights keep the reference's
layouts: ``wq`` (D, H, hd), ``wk``/``wv`` (D, Hkv, hd), ``wo`` (H, hd, D).

Entry points:
  - ``attn_train``: full-sequence causal attention (training / populate);
    ``use_flash=True`` goes through the flash-attention kernel (K4).
  - ``attn_prefill``: full-sequence causal attention that also writes
    positions [0, s) of the KV cache.
  - ``attn_decode``: one step at a scalar position against the cache.

The caches are updated in place (the reference returns new arrays); the
functions still return the cache so callers read like the reference.
The per-row-position decode, ``attn_prefill_ext`` and the paged decode
belong to the scheduler and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

Params = Any

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static per-layer attention hyperparameters."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0          # 0 -> global causal; >0 -> sliding window
    softcap: float = 0.0
    query_scale: float = 0.0  # 0 -> rsqrt(head_dim)
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0

    @classmethod
    def from_config(cls, cfg: ModelConfig, *, local: bool) -> "AttnSpec":
        return cls(
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            window=cfg.sliding_window if local else 0,
            softcap=cfg.attn_softcap,
            query_scale=cfg.query_scale,
            rope_theta=cfg.rope_theta,
            rope_pct=cfg.rope_pct,
        )


def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)

    def w(shape):
        return (torch.randn(shape, generator=generator, device=generator.device) * s).to(dtype)

    return {
        "wq": w((d, cfg.n_heads, hd)),
        "wk": w((d, cfg.n_kv_heads, hd)),
        "wv": w((d, cfg.n_kv_heads, hd)),
        "wo": w((cfg.n_heads, hd, d)),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dnh->bsnh") as one matrix product."""
    b, s, d = x.shape
    _, n, h = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * h)).reshape(b, s, n, h)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bsnh,nhd->bsd") as one matrix product."""
    b, s, n, h = o.shape
    return o.reshape(b, s, n * h) @ wo.to(o.dtype).reshape(n * h, -1)


def _qkv(params: Params, x: torch.Tensor, positions: torch.Tensor, spec: AttnSpec):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q = apply_rope(q, positions, theta=spec.rope_theta, rope_pct=spec.rope_pct)
    k = apply_rope(k, positions, theta=spec.rope_theta, rope_pct=spec.rope_pct)
    return q, k, v


def _scale(spec: AttnSpec) -> float:
    return spec.query_scale if spec.query_scale else spec.head_dim**-0.5


def _sdpa(
    q: torch.Tensor,          # (b, sq, n, h)
    k: torch.Tensor,          # (b, sk, nk, h)
    v: torch.Tensor,          # (b, sk, nk, h)
    mask: torch.Tensor,       # (b or 1, sq, sk) bool, True = attend
    spec: AttnSpec,
) -> torch.Tensor:
    """GQA attention: fp32 logits (softcap, NEG_INF mask, softmax), probs
    cast back to the compute dtype before the value product."""
    b, sq, n, h = q.shape
    group = spec.n_heads // spec.n_kv_heads
    qg = q.reshape(b, sq, spec.n_kv_heads, group, h)
    logits = torch.einsum("bsngh,btnh->bngst", qg * _scale(spec), k).float()
    if spec.softcap:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(b, sq, n, h)


def causal_mask(sq: int, sk: int, q_offset: int, window: int, *, device=None) -> torch.Tensor:
    """(1, sq, sk) mask: key t attends iff t <= q_pos and q_pos - t < window."""
    q_pos = torch.arange(sq, device=device) + q_offset
    k_pos = torch.arange(sk, device=device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m[None]


def attn_train(
    params: Params,
    x: torch.Tensor,
    spec: AttnSpec,
    positions: Optional[torch.Tensor] = None,
    *,
    use_flash: bool = False,
) -> torch.Tensor:
    """Full-sequence causal attention. ``use_flash`` routes the attention
    itself through ``kernels.flash_attn.ops.flash_attention`` (the CUDA
    kernel on the card, its plain version on the CPU), which never
    materialises the (S, S) scores; the reference's model never sets it."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(params, x, positions, spec)
    if use_flash:
        from repro_torch.kernels.flash_attn.ops import flash_attention

        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=spec.window, softcap=spec.softcap, scale=_scale(spec),
        ).transpose(1, 2)
    else:
        mask = causal_mask(s, s, 0, spec.window, device=x.device)
        out = _sdpa(q, k, v, mask, spec)
    return _out(out, params["wo"])


# ---------------------------------------------------------------------------
# KV cache (serving)
# ---------------------------------------------------------------------------


def init_kv_cache(
    batch: int, max_seq: int, spec: AttnSpec, dtype=torch.bfloat16, *, device=None
) -> dict[str, torch.Tensor]:
    shape = (batch, max_seq, spec.n_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_prefill(
    params: Params, x: torch.Tensor, spec: AttnSpec, cache: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-sequence forward that also writes positions [0, s) of the cache.
    Attention reads the fresh K/V in the compute dtype, not the cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(params, x, positions, spec)
    mask = causal_mask(s, s, 0, spec.window, device=x.device)
    out = _sdpa(q, k, v, mask, spec)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return _out(out, params["wo"]), cache


def attn_decode(
    params: Params,
    x: torch.Tensor,              # (b, 1, d)
    pos: int,                     # position of this token, the same for every row
    spec: AttnSpec,
    cache: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: write K/V at ``pos``, attend over cache[0:pos+1]
    (the reference's scalar-``pos`` branch)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(params, x, positions, spec)
    cache["k"][:, pos : pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos : pos + 1] = v.to(cache["v"].dtype)
    ck, cv = cache["k"], cache["v"]
    mask = causal_mask(1, ck.shape[1], pos, spec.window, device=x.device)
    out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), mask, spec)
    return _out(out, params["wo"]), cache
