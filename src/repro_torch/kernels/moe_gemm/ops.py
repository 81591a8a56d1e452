"""Differentiable grouped expert GEMM over the kernel.

The JAX package has no backward kernel for this product (XLA
differentiates its einsum); here both gradients are grouped products of
the same kernel on transposed views, ``dX = dY W^T`` and ``dW = X^T dY``,
so a backward launches it twice.  For CPU tensors the wrapper takes the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm import kernel


class MoEGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return kernel.moe_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = kernel.moe_gemm(dy, w.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = kernel.moe_gemm(x.transpose(1, 2), dy)
        return dx, dw


def moe_gemm(x, w):
    return MoEGemm.apply(x, w)
