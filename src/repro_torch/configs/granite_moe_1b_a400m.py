"""granite-moe-1b-a400m [moe] — 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
24L d_model=1024 16H (GQA kv=8) d_ff=512/expert, MoE 32e top-8, vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, every=1,
                  capacity_factor=1.25),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64, every=1),
)
