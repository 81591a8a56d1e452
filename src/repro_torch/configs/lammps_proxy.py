"""lammps-proxy — the paper's own workload stand-in.

The Flux Operator paper benchmarks LAMMPS (a CORAL-2 scalable-science
proxy) under two operators.  Our equivalent "application container" is a
small compute-bound transformer step; orchestration benchmarks submit this
as the job payload.  It is NOT one of the ten assigned architectures.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="lammps-proxy",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1024,
    vocab_size=1024,
    source="paper §4 proxy",
)

SMOKE = ModelConfig(
    name="lammps-proxy-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
)
