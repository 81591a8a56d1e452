from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, get, smoke  # noqa: F401
