"""jamba-1.5-large-398b [hybrid] — Mamba + attention 7:1 interleave with MoE
(arXiv:2403.19887; hf).

72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536. Period of 8 layers with
attention at position 3 (1 attn : 7 mamba), MoE (16 experts top-2,
expert d_ff 24576) on every second layer, dense SwiGLU (d_ff 24576)
otherwise. Mamba-dominant -> runs the long_500k shape.
"""

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=(
        "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every_k_layers=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    ffn_activation="silu",
    ffn_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
)
