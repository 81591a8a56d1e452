"""Learning-rate schedules (warmup + cosine, the LM default)."""
from __future__ import annotations

import math

import torch


def lr_schedule(step, *, base_lr: float, warmup_steps: int,
                total_steps: int, min_ratio: float = 0.1):
    """Float32 learning rate at ``step`` (an int or a tensor, which keeps
    the result on its device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * torch.where(step < warmup_steps, warm, cos)
