from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, MoEConfig, TrainConfig, WorkloadShape,
)
from repro_torch.configs.registry import ARCH_IDS, get, smoke  # noqa: F401
