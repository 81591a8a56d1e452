"""Plain PyTorch block-scaled int8 quantize and dequantize: the twin of
the JAX package's ``kernels/quantize/ref.py``.

Symmetric int8 with one float32 scale per row of ``block`` contiguous
values.  A zero row quantizes to scale 1.0 and zero codes, so padding
round-trips exactly.  Both divisions are tensor by tensor: PyTorch turns
a CUDA tensor divided by a Python number into a product with its
reciprocal, which can differ from the division in the last bit, and the
kernels (``csrc/quantize.cu``) divide.
"""
from __future__ import annotations

import torch

QMAX = 127.0


def quantize_int8_ref(x, *, block: int = 256):
    """x: (n_blocks, block) f32 -> (codes int8, scales f32 (n_blocks,))."""
    assert x.ndim == 2 and x.shape[1] == block, x.shape
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scales = torch.where(amax > 0.0, amax / torch.full_like(amax, QMAX),
                         torch.ones_like(amax))
    codes = torch.clamp(torch.round(xf / scales[:, None]), -QMAX, QMAX)
    return codes.to(torch.int8), scales


def dequantize_int8_ref(codes, scales):
    """(codes int8 (n_blocks, block), scales (n_blocks,)) -> f32."""
    return codes.float() * scales[:, None].float()
