"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4
(hf:Qwen/Qwen1.5-MoE-A2.7B; hf).

24L d_model=2048 16H (kv=16) d_ff_expert=1408 vocab=151936. Shared path is
the 4 always-on experts fused into one 5632-wide gated FFN. Untied.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    pattern=("attn",),
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared=4,
        shared_d_ff=5632,
    ),
    ffn_activation="silu",
    ffn_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
)
