"""Unified model configuration for all assigned architectures.

One ``ModelConfig`` describes a decoder-only LM backbone built from a
periodic pattern of blocks (attention / mamba / mLSTM / sLSTM), with
optional MoE FFNs, modality frontends (stubbed), and per-arch attention
details (GQA, sliding windows, logit softcaps, partial RoPE).

The layer stack is ``pattern`` tiled ``n_layers // len(pattern)`` times plus
a remainder. The dataclasses are a verbatim copy of ``repro.models.config``
(the port imports nothing of the JAX package); the port's model runs the
layers as one flat Python loop, so it only reads ``layer_kinds()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (qwen2-moe)
    shared_d_ff: int = 0         # total ff width of the shared path
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    every_k_layers: int = 1      # jamba: MoE on every 2nd layer


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0   # up-projection factor of mLSTM blocks
    slstm_ff_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # Layer pattern: block kind per position within one period.
    # Kinds: "attn", "attn_local", "mamba", "mlstm", "slstm".
    pattern: tuple[str, ...] = ("attn",)

    # Attention details.
    sliding_window: int = 0          # window for "attn_local" layers
    attn_softcap: float = 0.0        # gemma2-style attention logit softcap
    final_softcap: float = 0.0       # gemma2-style final logit softcap
    query_scale: float = 0.0         # 0 -> 1/sqrt(head_dim)
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # stablelm: 25% partial rotary
    attn_bias: bool = False          # stablelm2 uses qkv bias? (no) keep generic

    # FFN details.
    ffn_activation: str = "silu"     # silu | gelu
    ffn_gated: bool = True           # SwiGLU/GeGLU vs plain MLP
    moe: Optional[MoEConfig] = None

    # Norm / embedding.
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rmsnorm_unit_offset: bool = False  # gemma: weight = 1 + w
    use_post_norm: bool = False        # gemma2/3 pre+post sandwich norms
    tie_embeddings: bool = True
    scale_embed_by_sqrt_dim: bool = False  # gemma family

    # Non-attention block families.
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # Modality frontend stub: None | "vision" | "audio".
    frontend: Optional[str] = None
    frontend_seq: int = 0            # prefix length supplied by the frontend

    # Numerics.
    dtype: str = "bfloat16"          # activation/weight compute dtype

    def __post_init__(self):
        if self.n_layers % len(self.pattern) and self.n_layers < len(self.pattern):
            raise ValueError("pattern longer than n_layers")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def remainder_pattern(self) -> tuple[str, ...]:
        rem = self.n_layers - self.n_periods * self.period
        return self.pattern[:rem]

    def layer_kinds(self) -> list[str]:
        """Block kind for every layer, in order."""
        return list(self.pattern) * self.n_periods + list(self.remainder_pattern)

    def layer_has_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        kind = self.layer_kinds()[layer_idx]
        if kind in ("mlstm", "slstm"):
            return False  # xLSTM blocks have no external FFN
        return layer_idx % self.moe.every_k_layers == (self.moe.every_k_layers - 1)

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.layer_kinds()):
            if kind.startswith("attn"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # q,k,v
                total += self.n_heads * hd * d                          # o
                if not self.layer_has_moe(i) and self.d_ff:
                    total += d * self.d_ff * (3 if self.ffn_gated else 2)
            elif kind == "mamba":
                mc = self.mamba or MambaConfig()
                di = mc.d_inner(d)
                total += d * 2 * di + di * d + di * (mc.d_conv + 2 * mc.d_state + 2)
            elif kind == "mlstm":
                xc = self.xlstm or XLSTMConfig()
                di = int(d * xc.mlstm_proj_factor)
                total += d * 2 * di + di * d + 3 * di * di // max(1, self.n_heads)
            elif kind == "slstm":
                xc = self.xlstm or XLSTMConfig()
                total += 4 * d * d + 4 * d * (d // max(1, self.n_heads))
                total += int(d * xc.slstm_ff_factor) * d * 2
            if self.layer_has_moe(i):
                m = self.moe
                total += d * m.n_experts * m.d_ff_expert * 3
                total += d * m.n_experts  # router
                if m.n_shared:
                    total += d * m.shared_d_ff * 3
            total += 2 * d  # norms
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.layer_has_moe(i)
        )
        inactive = (
            n_moe_layers * self.d_model * (m.n_experts - m.top_k) * m.d_ff_expert * 3
        )
        return int(full - inactive)
