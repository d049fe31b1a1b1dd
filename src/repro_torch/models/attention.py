"""Grouped-query attention with sliding windows, softcaps and KV caches.

Counterpart of ``repro.models.attention`` for the serving path: MHA / GQA /
MQA via ``n_kv_heads``, sliding windows, the gemma2 attention-logit softcap,
partial rotary and ``head_dim != d / heads``. Weights keep the reference's
layouts: ``wq`` (D, H, hd), ``wk``/``wv`` (D, Hkv, hd), ``wo`` (H, hd, D).

Entry points (each the projections, ``attend`` and the output product):
  - ``attn_train``: full-sequence causal attention (training / populate);
    ``use_flash=True`` goes through the flash-attention kernel (K4).
  - ``attn_prefill``: full-sequence causal attention that also writes
    positions [0, s) of the KV cache.
  - ``attn_prefill_ext``: per-row *offset* prefill over the cache (the
    scheduler's prefix-reuse admission).
  - ``attn_decode``: one step against the cache, at one position for the
    whole batch (an int, or a 0-d device tensor that a CUDA graph can
    replay) or, given a (b,) tensor, at each row's own position (continuous
    batching).
  - ``attn_decode_paged``: the per-row decode over KV pool blocks behind a
    block table, gathered through ``kernels.flash_attn.paged`` (K10 with
    ``use_kernel=True``).

The caches are updated in place (the reference returns new arrays); the
functions still return the cache so callers read like the reference.
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


def _logits(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """fp32 GQA logits (b, nk, group, sq, sk) of ``q`` (b, sq, n, h) against
    ``k`` (b, sk, nk, h): scaled, softcapped, ``NEG_INF`` where ``mask``
    (b or 1, sq, sk) is False."""
    b, sq, n, h = q.shape
    qg = q.reshape(b, sq, spec.n_kv_heads, spec.n_heads // spec.n_kv_heads, h)
    logits = torch.einsum("bsngh,btnh->bngst", qg * _scale(spec), k).float()
    if spec.softcap:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    return logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)


def _sdpa(
    q: torch.Tensor,          # (b, sq, n, h)
    k: torch.Tensor,          # (b, sk, nk, h)
    v: torch.Tensor,          # (b, sk, nk, h)
    mask: torch.Tensor,       # (b or 1, sq, sk) bool, True = attend
    spec: AttnSpec,
) -> torch.Tensor:
    """GQA attention: fp32 logits (softcap, NEG_INF mask, softmax), probs
    cast back to the compute dtype before the value product."""
    probs = torch.softmax(_logits(q, k, mask, spec), dim=-1).to(q.dtype)
    return torch.einsum("bngst,btnh->bsngh", probs, v).reshape(q.shape)


def sdpa_partial(
    q: torch.Tensor,          # (b, sq, n, h)
    k: torch.Tensor,          # (b, sk, nk, h): one part of the keys
    v: torch.Tensor,
    mask: torch.Tensor,       # (b or 1, sq, sk) bool, True = attend
    spec: AttnSpec,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_sdpa`` over one part of the keys, unnormalised: (sum_t p_t v_t
    (b, sq, n, h) in the compute dtype, with p_t = exp(logit_t - top) in
    the compute dtype; sum_t p_t (b, sq, n) fp32; top, the part's largest
    logit (b, sq, n) fp32). ``merge_partials`` of the parts' triples is the
    attention over all keys. A part whose keys are all masked has top
    ``NEG_INF``: weight 0 beside any part with a key to attend."""
    b, sq, n, _ = q.shape
    logits = _logits(q, k, mask, spec)
    top = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - top)
    out = torch.einsum("bngst,btnh->bsngh", p.to(q.dtype), v).reshape(q.shape)

    def heads_last(t):                                       # (b, nk, g, sq) -> (b, sq, n)
        return t.permute(0, 3, 1, 2).reshape(b, sq, n)

    return out, heads_last(p.sum(dim=-1)), heads_last(top.squeeze(-1))


def merge_partials(outs: torch.Tensor, sums: torch.Tensor, tops: torch.Tensor, dtype) -> torch.Tensor:
    """The attention over every part's keys from ``sdpa_partial``'s triples
    stacked on a leading part axis (``outs`` (P, b, sq, n, h), ``sums`` and
    ``tops`` (P, b, sq, n)): each part scaled by exp(its top - the largest
    top), summed in part order in fp32, divided by the scaled sums' total
    -> ``dtype``."""
    w = torch.exp(tops - tops.amax(dim=0))
    out, total = outs[0].float() * w[0][..., None], sums[0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + outs[i].float() * w[i][..., None]
        total = total + sums[i] * w[i]
    return (out / total[..., None]).to(dtype)


def causal_mask(sq: int, sk: int, q_offset, window: int, *, device=None) -> torch.Tensor:
    """(1, sq, sk) mask: key t attends iff t <= q_pos and q_pos - t < window.
    ``q_offset`` is an int or a 0-d tensor on ``device``."""
    q_pos = torch.arange(sq, device=device) + q_offset
    k_pos = torch.arange(sk, device=device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m[None]


def row_mask(q_pos: torch.Tensor, sk: int, window: int, k_offset: int = 0) -> torch.Tensor:
    """(b, s, sk) mask for per-row query positions ``q_pos`` (b, s): key t
    (at position ``k_offset + t``: a sequence part of a cache) attends iff
    its position is <= q_pos and q_pos minus it is < window."""
    k_pos = torch.arange(k_offset, k_offset + sk, device=q_pos.device)
    m = k_pos[None, None, :] <= q_pos[:, :, None]
    if window > 0:
        m &= k_pos[None, None, :] > (q_pos[:, :, None] - window)
    return m


def query_positions(x: torch.Tensor, mode: str, pos=None) -> torch.Tensor:
    """(b, s) query positions of ``x`` (b, s, d) in ``mode``, with ``pos``
    as the entry points below take it: train / prefill from 0, an offset
    prefill from each row's ``pos``, a decode step at ``pos`` (an int, a
    0-d tensor, or a (b,) tensor of per-row positions)."""
    b, s = x.shape[:2]
    if mode != "decode" and pos is None:
        return torch.arange(s, device=x.device)[None].expand(b, s)
    if mode != "decode":
        return pos.long()[:, None] + torch.arange(s, device=x.device)[None]
    if isinstance(pos, torch.Tensor) and pos.dim() == 0:
        return pos.long().expand(b, 1)
    if isinstance(pos, torch.Tensor):
        return pos.long()[:, None]
    return torch.full((b, 1), pos, device=x.device)


def attend(
    q: torch.Tensor,             # (b, s, n, h), rotated
    k: torch.Tensor,             # (b, s, nk, h), rotated
    v: torch.Tensor,             # (b, s, nk, h)
    spec: AttnSpec,
    mode: str,
    cache: Optional[dict[str, torch.Tensor]] = None,
    pos=None,
    *,
    use_flash: bool = False,
) -> tuple[torch.Tensor, Optional[dict[str, torch.Tensor]]]:
    """The attention of the entry points below, between the projections
    and the output product: writes the fresh K/V into ``cache`` (in place)
    where the mode has one and returns (the heads' outputs (b, s, n, h),
    cache). ``spec``'s head counts are the ones ``q``/``k`` carry, so a
    model group's member runs it over its own heads (``models.tp``)."""
    b, s = q.shape[:2]
    if mode == "train":
        if use_flash:
            from repro_torch.kernels.flash_attn.ops import flash_attention

            out = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=spec.window, softcap=spec.softcap, scale=_scale(spec),
            ).transpose(1, 2)
        else:
            out = _sdpa(q, k, v, causal_mask(s, s, 0, spec.window, device=q.device), spec)
        return out, None
    if mode == "prefill" and pos is None:
        out = _sdpa(q, k, v, causal_mask(s, s, 0, spec.window, device=q.device), spec)
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        return out, cache
    if mode == "prefill":
        offs = pos.long()
        sk = cache["k"].shape[1]
        src = torch.arange(sk, device=q.device)[None] - offs[:, None]         # (b, sk)
        hit = ((src >= 0) & (src < s))[:, :, None, None]
        src = src.clamp(0, s - 1)[:, :, None, None]
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            picked = torch.gather(new.to(c.dtype), 1, src.expand(b, sk, *new.shape[2:]))
            c.copy_(torch.where(hit, picked, c))
        mask = row_mask(offs[:, None] + torch.arange(s, device=q.device)[None], sk, spec.window)
        return _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, spec), cache
    if isinstance(pos, torch.Tensor) and pos.dim() == 0:
        pos = pos.long()
        at = pos.reshape(1)
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        mask = causal_mask(1, cache["k"].shape[1], pos, spec.window, device=q.device)
    elif isinstance(pos, torch.Tensor):
        pos = pos.long()
        rows = torch.arange(b, device=q.device)
        cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
        mask = row_mask(pos[:, None], cache["k"].shape[1], spec.window)
    else:
        cache["k"][:, pos : pos + 1] = k.to(cache["k"].dtype)
        cache["v"][:, pos : pos + 1] = v.to(cache["v"].dtype)
        mask = causal_mask(1, cache["k"].shape[1], pos, spec.window, device=q.device)
    return _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, spec), cache


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
    if positions is None:
        positions = query_positions(x, "train")
    q, k, v = _qkv(params, x, positions, spec)
    out, _ = attend(q, k, v, spec, "train", use_flash=use_flash)
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


def _cached(params: Params, x: torch.Tensor, spec: AttnSpec, mode: str, cache, pos):
    q, k, v = _qkv(params, x, query_positions(x, mode, pos), spec)
    out, cache = attend(q, k, v, spec, mode, cache, pos)
    return _out(out, params["wo"]), cache


def attn_prefill(
    params: Params, x: torch.Tensor, spec: AttnSpec, cache: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-sequence forward that also writes positions [0, s) of the cache.
    Attention reads the fresh K/V in the compute dtype, not the cache."""
    return _cached(params, x, spec, "prefill", cache, None)


def attn_prefill_ext(
    params: Params,
    x: torch.Tensor,              # (b, s, d) tail tokens (right-padded)
    offs: torch.Tensor,           # (b,) int per-row start position
    spec: AttnSpec,
    cache: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Per-row *offset* prefill: row b's ``s`` tokens occupy positions
    ``[offs[b], offs[b] + s)``; their K/V go into the cache at those
    positions and attention runs over the CACHE, including whatever the
    caller pre-wrote below ``offs`` (the prefix-reuse admission: gathered
    pool blocks sit at ``[0, offs)``, so the tail attends reused keys
    without recomputing them).

    Padding as in the reference: pad tail positions write garbage K/V at
    indices >= the row's true end, writes past the cache are dropped (the
    reference's ``mode="drop"``), and rows with a shorter reused prefix see
    garbage between their prefix and the wave's padded prefix, all at
    positions >= their own length, which the causal mask hides and decode
    overwrites before attending there. The write is a select over the whole
    cache row (key t takes tail token t - offs[b] where that is in [0, s)),
    so no index leaves the cache and the host never reads ``offs``."""
    return _cached(params, x, spec, "prefill", cache, offs)


def attn_decode(
    params: Params,
    x: torch.Tensor,              # (b, 1, d)
    pos,                          # int: every row's position; (b,) tensor: each row's
    spec: AttnSpec,
    cache: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: write K/V at ``pos``, attend over cache[0:pos+1].

    An ``int`` ``pos`` is the reference's scalar branch (every row at the
    same position). A 0-d tensor is the same step with the position on the
    device: K/V go in through an index op and the mask is built from the
    tensor, so a CUDA graph can replay the step at a later position; it
    gives the int branch's booleans and bits. A (b,) tensor selects the
    continuous-batching branch: each row writes its K/V at its own position
    and masks keys per row, what the request scheduler needs once rows
    admitted at different times share one live batch. Positions must lie
    inside the cache."""
    return _cached(params, x, spec, "decode", cache, pos)


def attn_decode_paged(
    params: Params,
    x: torch.Tensor,                 # (b, 1, d)
    pos: torch.Tensor,               # (b,) int per-row position
    spec: AttnSpec,
    pool: dict[str, torch.Tensor],   # {"k", "v"}: (n_blocks, block, n_kv, hd)
    table: torch.Tensor,             # (b, T) int32 pool block ids
    *,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Block-table variant of ``attn_decode``'s per-row branch: row b's K/V
    for token position t lives in pool block ``table[b, t // block]`` at
    offset ``t % block`` instead of a contiguous cache row.

    The step writes the new K/V at ``pos`` into the owning pool block, in
    place (the caller must hold that block exclusively: the copy-on-write
    rule, ``KVBlockPool.copy_block`` first if shared), then attends over the
    gathered per-row keys with the dense branch's per-row mask, so given
    equal KV bytes the output is bitwise the dense ``attn_decode``'s. With
    ``use_kernel`` the gather is K10 on a CUDA pool, else its plain version
    on any device (the reference's default). Returns (y, the updated pool)."""
    from repro_torch.kernels.flash_attn import paged

    blk = pool["k"].shape[1]
    pos = pos.long()
    q, k, v = _qkv(params, x, pos[:, None], spec)
    owner = table.long().gather(1, (pos // blk)[:, None])[:, 0]            # (b,)
    off = pos % blk
    pool["k"][owner, off] = k[:, 0].to(pool["k"].dtype)
    pool["v"][owner, off] = v[:, 0].to(pool["v"].dtype)
    gather = paged.gather if use_kernel else paged.paged_gather_ref
    ck, cv = gather(pool["k"], table), gather(pool["v"], table)
    mask = row_mask(pos[:, None], ck.shape[1], spec.window)
    out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), mask, spec)
    return _out(out, params["wo"]), pool
