from repro_torch.configs.base import (  # noqa: F401
    BASELINE, OPTIMIZED, SHAPES, STRATEGIES, ZERO3, ModelConfig, MoEConfig,
    ShardingStrategy, TrainConfig, WorkloadShape,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, EXTRA_IDS, get, smoke,
)
