"""Plain PyTorch RMSNorm: the twin of the JAX package's ``rmsnorm_ref``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, weight, *, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
