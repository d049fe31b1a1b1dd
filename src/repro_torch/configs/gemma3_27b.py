"""gemma3-27b [dense] — 5:1 local:global attention, 128k context
(hf:google/gemma-3-*; unverified).

62L d_model=5376 32H (kv=16) d_ff=21504 vocab=262144, head_dim=128,
sliding window 1024 on local layers, GeGLU, sandwich norms, tied + scaled
embeddings. 62 = 10 full (5 local + 1 global) periods + 2 local remainder.
Global layers are full attention -> long_500k skipped (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("attn_local",) * 5 + ("attn",),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    ffn_activation="gelu",
    ffn_gated=True,
    norm_type="rmsnorm",
    rmsnorm_unit_offset=True,
    use_post_norm=True,
    tie_embeddings=True,
    scale_embed_by_sqrt_dim=True,
)
