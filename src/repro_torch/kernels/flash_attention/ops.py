"""Differentiable flash attention over the kernels: the twin of the JAX
package's ``flash_attention/ops.py`` custom VJP.

``forward`` runs ``flash_fwd`` and saves q, k, v, out and lse;
``backward`` runs ``flash_bwd`` on them.  For CPU tensors both wrappers
take their plain versions (``ref.fwd``, ``ref.bwd``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out, lse = kernel.flash_fwd(q, k, v, causal=causal, scale=scale,
                                    q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over a strided view (the grad of a reshape
        # feeding a matmul); the kernels read dense rows
        dq, dk, dv = kernel.flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                      **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, q_offset=0):
    return FlashAttention.apply(q, k, v, causal, scale, q_offset)
