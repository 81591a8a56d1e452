"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2, QKV bias.

[arXiv:2406.12793; hf:THUDM/chatglm3-6b]
28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM applies rotary embeddings to half of each head dim ("2d RoPE")
and uses bias on the fused QKV projection.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,          # 2d rope: rotate half the head dim
    qkv_bias=True,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    source="arXiv:2406.12793; hf",
)

SMOKE = ModelConfig(
    name="chatglm3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    rope_fraction=0.5,
    qkv_bias=True,
)
