"""gemma-7b [dense] — GeGLU, head_dim=256 (arXiv:2403.08295; hf).

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000. Full global causal
attention on every layer, tied + scaled embeddings, unit-offset RMSNorm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=("attn",),
    ffn_activation="gelu",
    ffn_gated=True,
    norm_type="rmsnorm",
    rmsnorm_unit_offset=True,
    tie_embeddings=True,
    scale_embed_by_sqrt_dim=True,
)
