"""Flash attention: the CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) for CUDA tensors, the plain versions (``ref.fwd``,
``ref.bwd``) for CPU tensors.

These raw wrappers return tensors without autograd history and refuse
inputs that require grad under grad mode; the differentiable route is
``ops.FlashAttention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (8, 16, 32, 64, 128, 160)


def _check_qkv(name, q, k, v):
    b, _, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"{name}: head dim {d} (takes {HEAD_DIMS}), "
                         f"heads {h} over {hkv} KV heads")
    build.check(q, f"{name} q", torch.bfloat16)
    build.check(k, f"{name} k", torch.bfloat16, (b, skv, hkv, d))
    build.check(v, f"{name} v", torch.bfloat16, (b, skv, hkv, d))


def flash_fwd(q, k, v, *, causal=True, scale=None, q_offset=0):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D).  Returns (out, lse):
    out like q, lse (B, Sq, H) float32."""
    build.refuse_autograd("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return ref.fwd(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    _check_qkv("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    build.launch("flash_fwd", "flash_fwd_bf16", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, sq, skv, h, hkv, d, int(causal), int(q_offset),
                 float(scale or d ** -0.5))
    return out, lse


def _check_bwd(name, q, k, v, dout, lse, delta):
    """Everything the backward kernels read through raw pointers."""
    build.refuse_autograd(name, q, k, v, dout, lse, delta)
    _check_qkv(name, q, k, v)
    build.check(dout, f"{name} dout", torch.bfloat16, q.shape)
    build.check(lse, f"{name} lse", torch.float32, q.shape[:3])
    build.check(delta, f"{name} delta", torch.float32, q.shape[:3])


def _bwd_args(q, k, causal, scale, q_offset):
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    return (b, sq, skv, h, hkv, d, int(causal), int(q_offset),
            float(scale or d ** -0.5))


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal=True, scale=None,
                 q_offset=0):
    """The dq kernel alone: CUDA tensors only (``flash_bwd`` is the
    wrapper with a plain version).  delta (B, Sq, H) float32 is
    ``rowsum(out * dout)``."""
    _check_bwd("flash_bwd_dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    build.launch("flash_bwd_dq", "flash_bwd_dq_bf16", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(),
                 *_bwd_args(q, k, causal, scale, q_offset))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal=True, scale=None,
                  q_offset=0):
    """The dk/dv kernel alone, inputs as ``flash_bwd_dq``; (dk, dv)."""
    _check_bwd("flash_bwd_dkv", q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    build.launch("flash_bwd_dkv", "flash_bwd_dkv_bf16", q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), *_bwd_args(q, k, causal, scale, q_offset))
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, *, causal=True, scale=None,
              q_offset=0):
    """Gradients of attention from the forward's ``out`` and ``lse``:
    (dq like q, dk like k, dv like v).  ``delta = rowsum(out * dout)`` is
    taken here in float32, then the dq kernel and the dk/dv kernel run."""
    build.refuse_autograd("flash_bwd", q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return ref.bwd(q, k, v, out, lse, dout, causal=causal, scale=scale,
                       q_offset=q_offset)
    build.check(out, "flash_bwd out", torch.bfloat16, q.shape)
    delta = (out.float() * dout.float()).sum(-1)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    return (dq,) + flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
