"""RMSNorm: the CUDA kernel (``csrc/rmsnorm.cu``) for a CUDA tensor, the
plain version (``ref.rmsnorm_ref``) for a CPU tensor.

This raw wrapper returns a tensor without autograd history and refuses
inputs that require grad under grad mode; the differentiable route is
``ops.RMSNorm``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x, weight, *, eps=1e-5):
    """x: (..., d) bf16; weight: (d,) f32.  Same type and shape out."""
    build.refuse_autograd("rmsnorm", x, weight)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps=eps)
    d = x.shape[-1]
    build.check(x, "rmsnorm x", torch.bfloat16)
    build.check(weight, "rmsnorm weight", torch.float32, (d,))
    if d % 8:
        raise ValueError(f"rmsnorm: d={d} must be a multiple of 8")
    out = torch.empty_like(x)
    build.launch("rmsnorm", "rmsnorm_bf16", x.device, x.data_ptr(),
                 weight.data_ptr(), out.data_ptr(), x.numel() // d, d,
                 float(eps))
    return out
