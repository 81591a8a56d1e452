from repro_torch.configs.base import (  # noqa: F401
    BASELINE, OPTIMIZED, SHAPES, STRATEGIES, ZERO3, ModelConfig, MoEConfig,
    ShardingStrategy, TrainConfig, WorkloadShape,
)
from repro_torch.configs.registry import ARCH_IDS, get, smoke  # noqa: F401
