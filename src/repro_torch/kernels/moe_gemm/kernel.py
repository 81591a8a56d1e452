"""Grouped expert GEMM: the CUDA kernel (``csrc/moe_gemm.cu``) for CUDA
tensors, the plain version (``ref.moe_gemm_ref``) for CPU tensors.

The raw wrapper returns a tensor without autograd history and refuses
inputs that require grad under grad mode; the differentiable route is
``ops.MoEGemm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm import ref


def _check_operand(t, name):
    """A bf16 CUDA tensor of three dims, on the kernel's 2-byte grain.
    Any strides: the kernel reads them (transposed views need no copy)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected torch.bfloat16, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name}: expected 3 dims, got {tuple(t.shape)}")
    if t.data_ptr() % 2 or any(s < 0 for s in t.stride()):
        raise ValueError(f"{name}: misaligned pointer or negative stride")


def moe_gemm(x, w):
    """x: (E, T, D); w: (E, D, F) -> (E, T, F) in x's type, f32 sums.
    Any T, D and F: the kernel masks the ragged edges itself."""
    build.refuse_autograd("moe_gemm", x, w)
    if x.device.type == "cpu":
        return ref.moe_gemm_ref(x, w)
    _check_operand(x, "moe_gemm x")
    _check_operand(w, "moe_gemm w")
    e, t, d = x.shape
    if w.shape[:2] != (e, d) or w.device != x.device:
        raise ValueError(f"moe_gemm: w {tuple(w.shape)} on {w.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    f = w.shape[2]
    out = torch.empty((e, t, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build.launch("moe_gemm", "moe_gemm_bf16", x.device, x.data_ptr(),
                 w.data_ptr(), out.data_ptr(), e, t, f, d, *x.stride(),
                 *w.stride())
    return out
