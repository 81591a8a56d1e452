"""Block-scaled int8 quantize and dequantize: the CUDA kernels
(``csrc/quantize.cu``) for CUDA tensors, the plain versions (``ref``)
for CPU tensors.  Neither has a gradient: they compress gradients after
the backward."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quantize import ref


def quantize_int8(x):
    """x: (n_blocks, block) f32 -> (codes int8 (n_blocks, block), scales
    f32 (n_blocks,)).  Any number of rows and any block length."""
    if x.ndim != 2:
        raise ValueError(f"quantize_int8: expected (n_blocks, block), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.quantize_int8_ref(x, block=x.shape[1])
    build.check(x, "quantize_int8 x", torch.float32)
    rows, block = x.shape
    codes = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if x.numel():
        build.launch("quantize", "quantize_int8_f32", x.device, x.data_ptr(),
                     codes.data_ptr(), scales.data_ptr(), rows, block)
    return codes, scales


def dequantize_int8(codes, scales):
    """(codes int8 (n_blocks, block), scales f32 (n_blocks,)) -> f32."""
    if codes.ndim != 2:
        raise ValueError(f"dequantize_int8: expected (n_blocks, block), got "
                         f"{tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return ref.dequantize_int8_ref(codes, scales)
    rows, block = codes.shape
    build.check(codes, "dequantize_int8 codes", torch.int8)
    build.check(scales, "dequantize_int8 scales", torch.float32, (rows,))
    if scales.device != codes.device:
        raise ValueError(f"dequantize_int8: scales on {scales.device}, codes "
                         f"on {codes.device}")
    out = torch.empty((rows, block), dtype=torch.float32, device=codes.device)
    if codes.numel():
        build.launch("dequantize", "dequantize_int8_f32", codes.device,
                     codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
                     rows, block)
    return out
