"""Analytic MODEL_FLOPS per (arch x shape x step).

MODEL_FLOPS = the textbook useful compute: 6*N*D for dense training
(2 fwd + 4 bwd per matmul param per token), 6*N_active*D for MoE, plus
attention score/value terms; decode counts 2*N_active per token plus the
KV-cache dot products. Comparing against the compiled HLO dot-FLOPs
surfaces remat recompute and sharding-padding waste (§Roofline ratio).

A copy of ``repro.launch.flops`` over the port's ``models.config``: every
formula as the reference writes it, so a share of peak read from it is
the reference's. ``finetune_cached`` counts rank 16 and three readout
products (forward, and the backward's two); the port's cached step
computes the frozen readout twice (the forward and the gradient for h,
``models.lm.lm_loss_rows``), so it needs two thirds of that readout term.
"""

from __future__ import annotations

from repro_torch.launch.shapes import SHAPES
from repro_torch.models.config import ModelConfig


def _embed_params(cfg: ModelConfig) -> int:
    return cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def _matmul_params(cfg: ModelConfig) -> int:
    """Active params that participate in matmuls per token (excl. the
    embedding gather; the tied readout matmul is added separately)."""
    return cfg.active_param_count() - _embed_params(cfg)


def _attention_flops_per_seq(cfg: ModelConfig, s: int, causal: bool = True) -> float:
    """QK^T + PV flops for one sequence of length s across all layers."""
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in cfg.layer_kinds():
        if not kind.startswith("attn"):
            continue
        window = cfg.sliding_window if kind == "attn_local" else 0
        if window and window < s:
            pairs = s * window  # each query sees <= window keys
        else:
            pairs = s * (s + 1) / 2 if causal else s * s
        total += 2 * 2 * cfg.n_heads * hd * pairs  # QK + PV, 2 flops/MAC
    return total


def reuse_saved_flops(cfg: ModelConfig, prefix_tokens: int) -> float:
    """Prefill FLOPs one prefix-reuse admission skips: the matmul stack
    over ``prefix_tokens`` positions plus their causal attention pairs
    (the gathered KV blocks replace both). The readout is NOT saved — the
    tail prefill still produces the next-token logits."""
    if prefix_tokens <= 0:
        return 0.0
    return (2.0 * _matmul_params(cfg) * prefix_tokens
            + _attention_flops_per_seq(cfg, prefix_tokens))


def _decode_attn_flops(cfg: ModelConfig, ctx: int, batch: int) -> float:
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in cfg.layer_kinds():
        if not kind.startswith("attn"):
            continue
        window = cfg.sliding_window if kind == "attn_local" else 0
        keys = min(ctx, window) if window else ctx
        total += 2 * 2 * cfg.n_heads * hd * keys * batch
    return total


def _recurrence_flops_per_token(cfg: ModelConfig) -> float:
    """Elementwise state-update flops per token (mamba/mLSTM dominate; these
    sit inside the time scan that HLO cost analysis counts once)."""
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "mamba":
            mc = cfg.mamba
            di = mc.d_inner(cfg.d_model)
            total += 6.0 * di * mc.d_state  # exp, mul-add state, C dot
        elif kind == "mlstm":
            xc = cfg.xlstm
            di = int(cfg.d_model * xc.mlstm_proj_factor)
            hd = di // cfg.n_heads
            total += 8.0 * cfg.n_heads * hd * hd  # C update + Cq read
        elif kind == "slstm":
            total += 16.0 * cfg.d_model
    return total


def readout_flops(cfg: ModelConfig, tokens: float) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.vocab_size


def model_flops(cfg: ModelConfig, shape_name, step: str) -> float:
    """Global (all-chips) useful FLOPs for one step.

    ``shape_name`` is either a registered ``SHAPES`` key or an explicit
    ``(batch, seq)`` pair — benchmark code measures at shapes that are not
    registry cells."""
    if isinstance(shape_name, str):
        shape = SHAPES[shape_name]
        b, s = shape.batch, shape.seq
    else:
        b, s = shape_name
    tokens = float(b * s)
    n = _matmul_params(cfg)

    if step in ("train", "finetune_populate"):
        mm = 6.0 * n * tokens
        attn = 3.0 * b * _attention_flops_per_seq(cfg, s)  # fwd + 2x bwd
        head = 3.0 * readout_flops(cfg, tokens)
        rec = 3.0 * tokens * _recurrence_flops_per_token(cfg)
        if step == "finetune_populate":
            # Frozen backbone: forward only (1/3 of the train cost) + adapter
            # terms (negligible) + full readout fwd/bwd.
            return (mm + attn + rec) / 3.0 + head
        return mm + attn + head + rec

    if step == "finetune_cached":
        # Zero backbone compute: adapter sum fwd+bwd + readout fwd+bwd.
        r = 16  # default rank used in the dry-run cells
        adapters = 6.0 * tokens * cfg.n_layers * (2.0 * cfg.d_model * r)
        return adapters + 3.0 * readout_flops(cfg, tokens)

    if step == "prefill":
        mm = 2.0 * n * tokens
        attn = b * _attention_flops_per_seq(cfg, s)
        rec = tokens * _recurrence_flops_per_token(cfg)
        return mm + attn + rec + readout_flops(cfg, float(b))

    if step == "decode":
        mm = 2.0 * n * b
        attn = _decode_attn_flops(cfg, s, b)
        rec = b * _recurrence_flops_per_token(cfg)
        return mm + attn + rec + readout_flops(cfg, float(b))

    raise ValueError(step)
