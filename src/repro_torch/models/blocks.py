"""Per-layer blocks and the layer stack.

Counterpart of ``repro.models.blocks``. A *block* is one residual layer:
pre-norm -> attention -> residual add, then pre-norm -> FFN -> residual add,
with the gemma2/3 sandwich post-norms where the config asks for them.

The reference stacks the layers of each period position and scans over
periods; the port keeps one flat list of per-layer dicts in execution order
(layer ``l = p * period + i``, remainder at the tail) and loops over it.
``convert.py`` maps between the two layouts. The stack also implements the
single-stack Skip-LoRA tap: every block's *input* is projected through its
(A_k, B_k) pair and summed into a skip term the LM adds to the final hidden
state.

Only the attention kinds are ported; mamba / mLSTM / sLSTM blocks and MoE
FFNs raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn, init_ffn
from repro_torch.models.layers import apply_norm, make_norm

Params = Any

ATTN_KINDS = ("attn", "attn_local")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: non-attention blocks, MoE
    FFNs and modality frontends."""
    other = sorted(set(cfg.layer_kinds()) - set(ATTN_KINDS))
    if other:
        raise NotImplementedError(f"{cfg.name}: block kinds {other} are not ported")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend is not ported")


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(
        cfg.norm_type, p, x, eps=cfg.norm_eps, unit_offset=cfg.rmsnorm_unit_offset
    )


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, kind: str, cfg: ModelConfig, dtype) -> Params:
    """One layer's params; norm params are fp32 as ``make_norm`` makes them."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    d, dev = cfg.d_model, generator.device
    p: dict[str, Params] = {"norm1": make_norm(cfg.norm_type, d, device=dev)}
    p["attn"] = A.init_attn(generator, cfg, dtype)
    if cfg.use_post_norm:
        p["post_norm1"] = make_norm(cfg.norm_type, d, device=dev)
    if cfg.d_ff:
        p["norm2"] = make_norm(cfg.norm_type, d, device=dev)
        p["ffn"] = init_ffn(generator, d, cfg.d_ff, gated=cfg.ffn_gated, dtype=dtype)
        if cfg.use_post_norm:
            p["post_norm2"] = make_norm(cfg.norm_type, d, device=dev)
    return p


def init_block_cache(
    kind: str, batch: int, max_seq: int, cfg: ModelConfig, dtype, *, device=None
) -> Params:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    spec = A.AttnSpec.from_config(cfg, local=(kind == "attn_local"))
    return A.init_kv_cache(batch, max_seq, spec, dtype, device=device)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def block_forward(
    kind: str,
    params: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,                     # "train" | "prefill" | "decode"
    cache: Params = None,
    pos=None,                      # int, or a (b,) tensor of per-row positions
) -> tuple[torch.Tensor, Params]:
    """Apply one block. Returns (h_out, cache); the cache is None in train
    mode. ``pos`` routes as in the reference: in prefill a (b,) tensor is
    each row's start offset (``attn_prefill_ext``, the prefix-reuse
    admission) and None the classic prefill; in decode an ``int`` is the
    scalar branch and a (b,) tensor the per-row branch."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    x = _norm(cfg, params["norm1"], h)
    spec = A.AttnSpec.from_config(cfg, local=(kind == "attn_local"))
    if mode == "train":
        y = A.attn_train(params["attn"], x, spec)
    elif mode == "prefill":
        if pos is not None:
            y, cache = A.attn_prefill_ext(params["attn"], x, pos, spec, cache)
        else:
            y, cache = A.attn_prefill(params["attn"], x, spec, cache)
    elif mode == "decode":
        y, cache = A.attn_decode(params["attn"], x, pos, spec, cache)
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported")
    if "post_norm1" in params:
        y = _norm(cfg, params["post_norm1"], y)
    h = h + y
    if "ffn" in params:
        z = _norm(cfg, params["norm2"], h)
        y2 = ffn(params["ffn"], z, act=cfg.ffn_activation, gated=cfg.ffn_gated)
        if "post_norm2" in params:
            y2 = _norm(cfg, params["post_norm2"], y2)
        h = h + y2
    return h, cache


# ---------------------------------------------------------------------------
# Layer stack: one flat list of layers
# ---------------------------------------------------------------------------


def init_stack(generator: torch.Generator, cfg: ModelConfig, dtype) -> list[Params]:
    """Per-layer params in execution order."""
    check_supported(cfg)
    return [init_block(generator, kind, cfg, dtype) for kind in cfg.layer_kinds()]


def init_stack_caches(
    batch: int, max_seq: int, cfg: ModelConfig, dtype, *, device=None
) -> list[Params]:
    """Per-layer KV caches in execution order."""
    return [
        init_block_cache(kind, batch, max_seq, cfg, dtype, device=device)
        for kind in cfg.layer_kinds()
    ]


def _apply_adapter(adapter: Params, h: torch.Tensor) -> torch.Tensor:
    """Skip-LoRA tap: (h @ A) @ B in model dtype."""
    return (h @ adapter["A"].to(h.dtype)) @ adapter["B"].to(h.dtype)


def stack_forward(
    stack: list[Params],
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    caches: Optional[list[Params]] = None,
    pos=None,
    adapters: Optional[list[Params]] = None,   # per-layer {"A": (D,R), "B": (R,D)}
    collect_acts: bool = False,
) -> dict[str, Any]:
    """Run all layers. Returns dict with:
    h       : final hidden state
    skip    : accumulated Skip-LoRA term (zeros if no adapters)
    caches  : the (updated in place) per-layer caches; None in train mode
    acts    : per-layer block inputs (n_layers, B, S, D) if collect_acts

    In train mode the backbone params never require grad, so autograd
    records only the adapters' skip path, which reads the block inputs
    and nothing inside the blocks: the counterpart of the reference's
    rematerialised (``jax.checkpoint``) layer scan."""
    skip = torch.zeros_like(h)
    acts = []
    for l, kind in enumerate(cfg.layer_kinds()):
        if collect_acts:
            acts.append(h)
        if adapters is not None:
            skip = skip + _apply_adapter(adapters[l], h)
        cache = None if caches is None else caches[l]
        h, cache = block_forward(kind, stack[l], h, cfg, mode=mode, cache=cache, pos=pos)
        if caches is not None:
            caches[l] = cache
    return {
        "h": h,
        "skip": skip,
        "caches": caches,
        "acts": torch.stack(acts) if collect_acts else None,
    }
