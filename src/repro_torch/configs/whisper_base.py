"""whisper-base [audio] — encoder-decoder; conv frontend STUB.

[arXiv:2212.04356; unverified]
6L d_model=512 8H d_ff=2048 vocab=51865.  Enc-dec: 6 encoder + 6 decoder
layers, LayerNorm + GeLU, sinusoidal positions.  The conv1d audio frontend
is a stub: the encoder takes precomputed frame embeddings (``frames``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,               # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm_type="layernorm",
    mlp_type="gelu",
    pos_type="sinusoidal",
    encoder_layers=6,
    encoder_seq_divisor=2,    # encoder frames = seq_len // 2 (conv stride-2 stub)
    frontend="audio",
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    norm_type="layernorm",
    mlp_type="gelu",
    pos_type="sinusoidal",
    encoder_layers=2,
    encoder_seq_divisor=2,
    frontend="audio",
    tie_embeddings=True,
)
