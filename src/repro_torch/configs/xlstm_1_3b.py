"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM interleave).

[arXiv:2405.04517; unverified]
48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.
d_ff=0: xLSTM blocks carry their own expand-2 up-projection; there is no
separate FFN.  Sub-quadratic: constant-size matrix/scalar memory state.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pos_type="none",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(n_heads=4, expand=2, d_conv=4, chunk_size=64),
    tie_embeddings=False,
    source="arXiv:2405.04517; unverified",
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    pos_type="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    xlstm=XLSTMConfig(n_heads=4, expand=2, d_conv=4, chunk_size=8),
)
