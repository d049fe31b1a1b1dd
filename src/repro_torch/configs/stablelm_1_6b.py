"""stablelm-1.6b [dense] (hf:stabilityai/stablelm-2-1_6b; unverified).

24L d_model=2048 32H (kv=32, full MHA) d_ff=5632 vocab=100352, partial
rotary (25%), LayerNorm, SwiGLU, untied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    pattern=("attn",),
    rope_pct=0.25,
    rope_theta=10_000.0,
    ffn_activation="silu",
    ffn_gated=True,
    norm_type="layernorm",
    norm_eps=1e-5,
    tie_embeddings=False,
)
