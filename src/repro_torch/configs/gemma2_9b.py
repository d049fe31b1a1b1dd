"""gemma2-9b [dense] — alternating local/global attention with logit
softcaps (arXiv:2408.00118; hf).

42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000, head_dim=256,
window 4096 on local layers, attn softcap 50, final softcap 30, GeGLU,
sandwich norms, tied + scaled embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    ffn_activation="gelu",
    ffn_gated=True,
    norm_type="rmsnorm",
    rmsnorm_unit_offset=True,
    use_post_norm=True,
    tie_embeddings=True,
    scale_embed_by_sqrt_dim=True,
)
