"""Plain PyTorch grouped expert GEMM: the twin of the JAX package's
``moe_gemm/ref.py``.

x: (E, T, D) capacity-packed expert inputs; w: (E, D, F).
out[e] = x[e] @ w[e], summed in float32 and returned in ``x.dtype``.
"""
from __future__ import annotations

import torch


def moe_gemm_ref(x, w):
    return torch.bmm(x.float(), w.float()).to(x.dtype)
