"""paligemma-3b [vlm] — SigLIP + gemma backbone (arXiv:2407.07726; hf).

18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=257216, head_dim=256.
Backbone only: the SigLIP vision tower is stubbed — ``input_specs()``
supplies 256 precomputed patch embeddings as a prefix; loss is masked over
the prefix. Gemma-style GeGLU / unit-offset RMSNorm / tied scaled embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    pattern=("attn",),
    ffn_activation="gelu",
    ffn_gated=True,
    norm_type="rmsnorm",
    rmsnorm_unit_offset=True,
    tie_embeddings=True,
    scale_embed_by_sqrt_dim=True,
    frontend="vision",
    frontend_seq=256,
)
