"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517; unverified).

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304. xLSTM[7:1] ratio: seven mLSTM
blocks per sLSTM block (the paper's preferred mix). d_ff=0 -> no external
FFN; the cells carry their own up-projections (mLSTM x2, sLSTM ff 4/3).
Fully recurrent -> runs the long_500k shape.
"""

from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_ff_factor=4.0 / 3.0, conv_kernel=4),
    norm_type="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
)
