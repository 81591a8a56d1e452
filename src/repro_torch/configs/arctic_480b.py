"""arctic-480b [moe] — dense-MoE hybrid: 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128e top-2, vocab=32000.
Every layer carries an MoE FFN (128 experts of d_ff=4864) in parallel with
a dense residual FFN.  Adafactor with bf16 state is the production
optimizer choice at this scale.  The port runs only its SMOKE config (the
dense-residual branch and Adafactor in the CPU tests).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(
        n_experts=128, top_k=2, d_ff_expert=4864, every=1,
        dense_residual=True, d_ff_dense=4864, capacity_factor=1.25),
    optimizer="adafactor",
    opt_state_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, every=1,
                  dense_residual=True, d_ff_dense=96),
    optimizer="adafactor",
)
