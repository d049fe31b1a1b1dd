"""musicgen-medium [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284; hf).

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048. Backbone only per the
assignment: the EnCodec encoder and the text-conditioning cross-attention
are stubbed — ``input_specs()`` provides a precomputed conditioning prefix
of 64 frame embeddings; the 4-codebook interleaving is flattened to a
single code stream (vocab 2048). Standard post-2017 decoder: LayerNorm,
ungated GELU FFN, untied output head.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    ffn_activation="gelu",
    ffn_gated=False,
    norm_type="layernorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    frontend="audio",
    frontend_seq=64,
)
