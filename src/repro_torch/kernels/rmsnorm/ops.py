"""Differentiable RMSNorm over the kernel.

The forward is the CUDA kernel (its plain version for a CPU tensor).
The JAX package's Pallas rmsnorm has no custom VJP and no backward
kernel, so neither has the port: the backward is the derivative of
``rmsnorm_ref`` in plain float32 torch operations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel


def rmsnorm_bwd(x, weight, dout, *, eps=1e-5):
    """(dx in x's type, dweight in weight's type) of
    ``y = x / sqrt(mean(x^2) + eps) * weight``."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * rstd
    dy = dout.float()
    dweight = (dy * xhat).reshape(-1, x.shape[-1]).sum(0)
    dxhat = dy * weight.float()
    dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dweight.to(weight.dtype)


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return kernel.rmsnorm(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, dout, eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x, weight, *, eps=1e-5):
    return RMSNorm.apply(x, weight, eps)
