"""Architecture registry of the port: ``get(name)`` and ``smoke(name)``.

Each ported architecture lives in ``configs/<id>.py`` (dashes become
underscores) and exposes ``CONFIG`` (the published config) and
``SMOKE`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ["chatglm3-6b", "yi-6b", "qwen2-72b", "deepseek-67b",
            "xlstm-1.3b", "arctic-480b", "granite-moe-1b-a400m",
            "pixtral-12b", "jamba-v0.1-52b", "whisper-base"]

# The paper itself has no model; its workload proxy (LAMMPS / CORAL-2
# stand-in) is a small compute-bound config used by orchestration benches.
EXTRA_IDS = ["lammps-proxy"]


def _module(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS + EXTRA_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{ARCH_IDS + EXTRA_IDS}")
    return importlib.import_module(_module(arch_id)).CONFIG


def smoke(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS + EXTRA_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{ARCH_IDS + EXTRA_IDS}")
    return importlib.import_module(_module(arch_id)).SMOKE
