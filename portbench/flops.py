"""The yardstick's arithmetic: operations and bytes worked out from shapes,
and the card's published peaks.

Nothing here reads a counter of the program, so a share of a peak or of a
roofline reads the same work whatever implements it. Each count is the
work the algorithm needs (a causal attention counts the pairs it attends,
an MoE layer the experts its tokens route to), not what an implementation
happens to issue.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
#: the tensor cores, HBM3 bandwidth (at the full 700 W power limit).
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BPS = 3.35e12


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies in one layer: attention projections,
    and the dense FFN or the router, its top-k experts and the shared FFN."""
    d, hd = cfg["d_model"], head_dim(cfg)
    n = d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
    moe = cfg.get("moe")
    if moe:
        n += d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
        n += 3 * d * moe.get("shared_d_ff", 0)
    else:
        n += (3 if cfg["ffn_gated"] else 2) * d * cfg["d_ff"]
    return n


def attn_pair_flops(cfg: dict) -> int:
    """One query attending one key in one layer: q.k and p.v."""
    return 4 * cfg["n_heads"] * head_dim(cfg)


def readout_flops(cfg: dict, rows: int) -> int:
    """Logits of ``rows`` positions: one (rows x D) x (D x V) product."""
    return 2 * rows * cfg["d_model"] * cfg["vocab_size"]


def skip_flops(cfg: dict, rows: int, rank: int) -> int:
    """The skip sum's forward at ``rows`` positions: x A then (x A) B per layer."""
    return 4 * rows * cfg["n_layers"] * cfg["d_model"] * rank


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    """A causal forward of ``rows`` sequences of ``seq`` tokens through
    every layer (no readout)."""
    per_row = seq * 2 * layer_params_per_token(cfg) + attn_pair_flops(cfg) * seq * (seq + 1) // 2
    return rows * cfg["n_layers"] * per_row


def ingest_flops(cfg: dict, rows: int, seq: int, rank: int) -> int:
    """The session's ingest: the forward, the adapted last position's skip
    sum and its readout."""
    return forward_flops(cfg, rows, seq) + skip_flops(cfg, rows, rank) + readout_flops(cfg, rows)


def cached_step_flops(cfg: dict, positions: int, rank: int) -> int:
    """One cached fine-tuning step over ``positions`` (rows x seq) tokens:
    the skip sum forward and its backward to A and B (1 + 1.5 times the
    forward), and the readout's two products (the logits, and the
    gradient to the hidden state; the head is frozen)."""
    return skip_flops(cfg, positions, rank) * 5 // 2 + 2 * readout_flops(cfg, positions)


def readout_train_flops(cfg: dict, positions: int) -> int:
    """The readout loss's forward and backward to the hidden state at
    ``positions`` tokens: two products of 2 * M * D * V."""
    return 2 * readout_flops(cfg, positions)


def prefill_flops(cfg: dict, prompt: int, rank: int, adapted: bool) -> int:
    """A request's admission: its real prompt tokens through every layer,
    then the first token's readout (and skip sum when adapted)."""
    out = forward_flops(cfg, 1, prompt) + readout_flops(cfg, 1)
    return out + (skip_flops(cfg, 1, rank) if adapted else 0)


def decode_flops(cfg: dict, context: int, rank: int, adapted: bool) -> int:
    """One decoded token whose query attends ``context`` positions (itself
    included), its readout and skip sum."""
    out = cfg["n_layers"] * (2 * layer_params_per_token(cfg) + attn_pair_flops(cfg) * context)
    out += readout_flops(cfg, 1)
    return out + (skip_flops(cfg, 1, rank) if adapted else 0)


def skipsum_train_bytes(cfg: dict, positions: int, tenants: int, rank: int, act_bytes: int = 2) -> int:
    """The grouped skip sum's forward and backward at ``positions`` tokens
    over ``tenants`` float32 adapter stacks: acts and the output's
    gradient read once, the output written once, A and B read once and
    their gradients written once."""
    n, d = cfg["n_layers"], cfg["d_model"]
    acts = n * positions * d * act_bytes
    rows_io = 2 * positions * d * act_bytes
    adapters = 2 * 2 * tenants * n * d * rank * 4
    return acts + rows_io + adapters


def skipsum_train_ops(cfg: dict, positions: int, rank: int) -> int:
    return skip_flops(cfg, positions, rank) * 5 // 2


def moe_bytes(cfg: dict, rows: int, experts_hit: int, act_bytes: int = 2, w_bytes: int = 2) -> int:
    """One MoE FFN call over ``rows`` tokens: the float32 router, each
    expert the tokens route to and the shared FFN read once, the input
    read and the output written once."""
    moe, d = cfg["moe"], cfg["d_model"]
    w = experts_hit * 3 * d * moe["d_ff_expert"] + 3 * d * moe.get("shared_d_ff", 0)
    return d * moe["n_experts"] * 4 + w * w_bytes + 2 * rows * d * act_bytes


def roofline_share(ops: int, nbytes: int, seconds: float, peak_ops: float) -> float:
    """Least time the card could take (the larger of ops over the peak and
    bytes over the bandwidth) over the time taken, in percent."""
    return 100.0 * max(ops / peak_ops, nbytes / HBM_BPS) / seconds
