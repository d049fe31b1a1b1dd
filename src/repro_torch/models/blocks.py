"""Per-layer blocks and the layer stack.

Counterpart of ``repro.models.blocks``. A *block* is one residual layer:
pre-norm -> mixer (attention / mamba / mLSTM / sLSTM) -> residual add, then,
for attention and mamba layers, pre-norm -> FFN or MoE -> residual add,
with the gemma2/3 sandwich post-norms where the config asks for them. The
xLSTM cells have no external FFN.

The reference stacks the layers of each period position and scans over
periods; the port keeps one flat list of per-layer dicts in execution order
(layer ``l = p * period + i``, remainder at the tail) and loops over it, so
mixed periods (jamba's attention and mamba layers, MoE on every other
layer) and remainders need nothing more. ``convert.py`` maps between the
two layouts. The stack also implements the single-stack Skip-LoRA tap:
every block's *input* is projected through its (A_k, B_k) pair and summed
into a skip term the LM adds to the final hidden state.

Serve caches are updated in place: the attention functions write their K/V
into the cache, and a recurrent block's new state is copied into its cache
dict, so a CUDA graph of a decode step replays over the same buffers.

In train mode each period of layers is rematerialised (``remat.region``),
as the reference's ``jax.checkpoint`` around its period scan: the backward
keeps a period's inputs and replays the period for the rest.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import remat as RM
from repro_torch.models import ssm as S
from repro_torch.models import tp as TP
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn, init_ffn
from repro_torch.models.layers import apply_norm, make_norm
from repro_torch.models.moe import init_moe, moe_ffn

Params = Any

ATTN_KINDS = ("attn", "attn_local")


def require_attention(cfg: ModelConfig, what: str) -> None:
    """Raise for a stack with recurrent blocks: ``what`` (a KV layout)
    holds attention layers only."""
    kinds = sorted(set(cfg.layer_kinds()) - set(ATTN_KINDS))
    if kinds:
        raise NotImplementedError(f"{cfg.name}: {what} holds attention layers only, not {kinds}")

#: recurrent kinds -> (init, init_state, seq form, step form)
_RECURRENT = {
    "mamba": (S.init_mamba, S.init_mamba_state, S.mamba_seq, S.mamba_step),
    "mlstm": (S.init_mlstm, S.init_mlstm_state, S.mlstm_seq, S.mlstm_step),
    "slstm": (S.init_slstm, S.init_slstm_state, S.slstm_seq, S.slstm_step),
}


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(
        cfg.norm_type, p, x, eps=cfg.norm_eps, unit_offset=cfg.rmsnorm_unit_offset
    )


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, kind: str, layer_idx: int, cfg: ModelConfig, dtype) -> Params:
    """Layer ``layer_idx``'s params; norm params are fp32 as ``make_norm``
    makes them. An MoE FFN where ``cfg.layer_has_moe(layer_idx)``."""
    d, dev = cfg.d_model, generator.device
    p: dict[str, Params] = {"norm1": make_norm(cfg.norm_type, d, device=dev)}
    if kind in ATTN_KINDS:
        p["attn"] = A.init_attn(generator, cfg, dtype)
    elif kind in _RECURRENT:
        p[kind] = _RECURRENT[kind][0](generator, cfg, dtype)
    else:
        raise ValueError(kind)
    if cfg.use_post_norm:
        p["post_norm1"] = make_norm(cfg.norm_type, d, device=dev)
    if kind in ATTN_KINDS or kind == "mamba":
        if cfg.layer_has_moe(layer_idx):
            p["norm2"] = make_norm(cfg.norm_type, d, device=dev)
            p["moe"] = init_moe(generator, d, cfg.moe, dtype)
        elif cfg.d_ff:
            p["norm2"] = make_norm(cfg.norm_type, d, device=dev)
            p["ffn"] = init_ffn(generator, d, cfg.d_ff, gated=cfg.ffn_gated, dtype=dtype)
        if cfg.use_post_norm and ("moe" in p or "ffn" in p):
            p["post_norm2"] = make_norm(cfg.norm_type, d, device=dev)
    return p


def init_block_cache(
    kind: str, batch: int, max_seq: int, cfg: ModelConfig, dtype, *, device=None
) -> Params:
    """A KV cache for an attention kind, the recurrent state otherwise
    (its memories fp32, its conv window and sLSTM's ``h`` in ``dtype``)."""
    if kind in ATTN_KINDS:
        spec = A.AttnSpec.from_config(cfg, local=(kind == "attn_local"))
        return A.init_kv_cache(batch, max_seq, spec, dtype, device=device)
    if kind in _RECURRENT:
        return _RECURRENT[kind][1](batch, cfg, dtype, device=device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _write_state(cache: Params, new: Params) -> Params:
    """Copy a recurrent block's new state into its cache dict, in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def block_forward(
    kind: str,
    params: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,                     # "train" | "prefill" | "decode"
    cache: Params = None,
    pos=None,                      # int, or a (b,) tensor of per-row positions
) -> tuple[torch.Tensor, Params, Optional[torch.Tensor]]:
    """Apply one block. Returns (h_out, cache, moe_aux): the cache is None in
    train mode, the aux the MoE FFN's load-balance loss (fp32 scalar) or
    None for a block without one (the reference's zero). ``pos`` routes the
    attention kinds as in the reference: in prefill a (b,) tensor is each
    row's start offset (``attn_prefill_ext``, the prefix-reuse admission)
    and None the classic prefill; in decode an ``int`` is the scalar branch
    and a (b,) tensor the per-row branch. The recurrent kinds read their
    state, not ``pos``; a prefill starts from the (zeroed) cache's state.
    A layer split over a model group (``tp.GroupParams``) runs
    ``tp.block_forward``."""
    if isinstance(params, TP.GroupParams):
        return TP.block_forward(kind, params, h, cfg, mode=mode, cache=cache, pos=pos)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    x = _norm(cfg, params["norm1"], h)
    if kind in ATTN_KINDS:
        spec = A.AttnSpec.from_config(cfg, local=(kind == "attn_local"))
        if mode == "train":
            y = A.attn_train(params["attn"], x, spec)
        elif mode == "prefill" and pos is not None:
            y, cache = A.attn_prefill_ext(params["attn"], x, pos, spec, cache)
        elif mode == "prefill":
            y, cache = A.attn_prefill(params["attn"], x, spec, cache)
        else:
            y, cache = A.attn_decode(params["attn"], x, pos, spec, cache)
    elif kind in _RECURRENT:
        _, _, seq, step = _RECURRENT[kind]
        if mode == "train":
            y, _ = seq(params[kind], x, cfg, None)
        else:
            y, new = (seq if mode == "prefill" else step)(params[kind], x, cfg, cache)
            cache = _write_state(cache, new)
    else:
        raise ValueError(kind)
    if "post_norm1" in params:
        y = _norm(cfg, params["post_norm1"], y)
    h = h + y
    aux = None
    if "moe" in params or "ffn" in params:
        z = _norm(cfg, params["norm2"], h)
        if "moe" in params:
            y2, aux = moe_ffn(params["moe"], z, cfg.moe, act=cfg.ffn_activation)
        else:
            y2 = ffn(params["ffn"], z, act=cfg.ffn_activation, gated=cfg.ffn_gated)
        if "post_norm2" in params:
            y2 = _norm(cfg, params["post_norm2"], y2)
        h = h + y2
    return h, cache, aux


# ---------------------------------------------------------------------------
# Layer stack: one flat list of layers
# ---------------------------------------------------------------------------


def init_stack_caches(
    batch: int, max_seq: int, cfg: ModelConfig, dtype, *, device=None
) -> list[Params]:
    """Per-layer KV caches and recurrent states in execution order."""
    return [
        init_block_cache(kind, batch, max_seq, cfg, dtype, device=device)
        for kind in cfg.layer_kinds()
    ]


def _apply_adapter(adapter: Params, h: torch.Tensor) -> torch.Tensor:
    """Skip-LoRA tap: (h @ A) @ B in model dtype. Its result only adds into
    the skip sum, so a rematerialised region's replay leaves out the
    ``@ B`` (``remat.product``)."""
    with RM.tail():
        return RM.product(h @ adapter["A"].to(h.dtype), adapter["B"].to(h.dtype))


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
    aux     : the MoE FFNs' summed aux loss (fp32 scalar; zero without one)

    In train mode each period of layers (``[p * period, (p + 1) *
    period)``, ``p < n_periods``) runs as one rematerialised region
    (``remat.region``), carrying (h, skip, aux) and returning the period's
    block inputs: the backward keeps each period's inputs and replays the
    period for the rest, as the reference's ``jax.checkpoint``-ed period
    scan does. The remainder layers run outside any region, as the reference's
    unrolled ones."""
    kinds = cfg.layer_kinds()
    if mode == "train" and caches is not None:
        raise ValueError("train mode takes no caches: a rematerialised period is replayed in the backward, so it "
                         "must not write states in place")

    def layers(lo: int, hi: int, h, skip, aux):
        acts = []
        for l in range(lo, hi):
            if collect_acts:
                acts.append(h)
            if adapters is not None:
                skip = skip + _apply_adapter(adapters[l], h)
            cache = None if caches is None else caches[l]
            # the last block of a region: its FFN's down projection feeds no
            # saved tensor unless a post-norm reads it
            with RM.tail(l == hi - 1 and "post_norm2" not in stack[l]):
                h, cache, a = block_forward(kinds[l], stack[l], h, cfg, mode=mode, cache=cache, pos=pos)
            if caches is not None:
                caches[l] = cache
            if a is not None:
                aux = a if aux is None else aux + a
        return h, skip, aux, acts

    skip = torch.zeros_like(h)
    acts, aux = [], None
    start = 0
    if mode == "train":
        for p in range(cfg.n_periods):
            lo, hi = p * cfg.period, (p + 1) * cfg.period
            h, skip, aux, a = RM.region(functools.partial(layers, lo, hi), h, skip, aux)
            acts += a
        start = cfg.n_periods * cfg.period
    h, skip, aux, a = layers(start, len(kinds), h, skip, aux)
    acts += a
    return {
        "h": h,
        "skip": skip,
        "caches": caches,
        "acts": torch.stack(acts) if collect_acts else None,
        "aux": aux if aux is not None else torch.zeros((), dtype=torch.float32, device=h.device),
    }
