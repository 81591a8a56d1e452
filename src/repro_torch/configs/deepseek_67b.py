"""deepseek-67b [dense] — llama-architecture, deep stack.

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base]
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    source="arXiv:2401.02954; hf",
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
