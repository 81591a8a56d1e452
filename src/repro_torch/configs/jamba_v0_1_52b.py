"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]
32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 16e top-2, vocab=65536.
Each 8-layer Jamba block has 1 attention layer and 7 Mamba layers; MoE
replaces the FFN on every other layer.  Sub-quadratic for long context:
only 4/32 layers keep a KV cache.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pos_type="none",          # jamba uses no positional encoding
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2,
                  capacity_factor=1.25),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887; hf",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    pos_type="none",
    block_pattern=("mamba", "attn", "mamba", "mamba"),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, every=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
)
