"""Flash-attention forward: the CUDA kernel (``csrc/flash_fwd.cu``) for
CUDA tensors, the plain version (``ref.fwd``) for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (64, 128)


def flash_fwd(q, k, v, *, causal=True, scale=None, q_offset=0):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D).  Returns (out, lse):
    out like q, lse (B, Sq, H) float32."""
    if q.device.type == "cpu":
        return ref.fwd(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"flash_fwd: head dim {d} (takes {HEAD_DIMS}), "
                         f"heads {h} over {hkv} KV heads")
    build.check(q, "flash_fwd q", torch.bfloat16)
    build.check(k, "flash_fwd k", torch.bfloat16, (b, skv, hkv, d))
    build.check(v, "flash_fwd v", torch.bfloat16, (b, skv, hkv, d))
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    build.launch("flash_fwd", "flash_fwd_bf16", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, sq, skv, h, hkv, d, int(causal), int(q_offset),
                 float(scale or d ** -0.5))
    return out, lse
