"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
(hf:microsoft/Phi-3.5-MoE-instruct; hf).

32L d_model=4096 32H (kv=8) d_ff_expert=6400 vocab=32064, MoE on every
layer, no shared experts. head_dim=128, SwiGLU experts, RMSNorm, untied.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    pattern=("attn",),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    ffn_activation="silu",
    ffn_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
)
