"""Dispatching facade over the port's kernels, with the signatures of the
JAX package's ``kernels/ops.py``.

``impl=None`` picks by the tensor's device: the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU tensor.  ``impl="ref"``
takes the plain version on any device (the comparisons on the card);
``impl="cuda"`` insists on the kernel and raises for a CPU tensor.
There is no fallback from a kernel to its plain version.

``flash_attention``, ``rmsnorm`` and ``moe_gemm`` are differentiable on
every route: the kernels through their ``torch.autograd.Function``s
(flash attention with the ``flash_bwd`` kernels as its backward, rmsnorm
with a plain float32 backward, the grouped GEMM with two launches of its
own kernel), the plain versions through ``ref.chunked``'s custom backward
and autograd.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as _dec
from repro_torch.kernels.decode_attention import ref as _dec_ref
from repro_torch.kernels.flash_attention import ops as _fa
from repro_torch.kernels.flash_attention import ref as _fa_ref
from repro_torch.kernels.moe_gemm import ops as _moe
from repro_torch.kernels.moe_gemm import ref as _moe_ref
from repro_torch.kernels.quantize import kernel as _q
from repro_torch.kernels.quantize import ref as _q_ref
from repro_torch.kernels.rmsnorm import ops as _rn
from repro_torch.kernels.rmsnorm import ref as _rn_ref

IMPLS = (None, "cuda", "ref")


def _plain(impl, x) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl == "ref"


def flash_attention(q, k, v, *, causal=True, scale=None, q_offset=0,
                    block_kv=1024, impl=None):
    # the Function would take the plain versions on the CPU as well,
    # but without ``block_kv`` and with GQA run natively
    if _plain(impl, q) or q.device.type == "cpu":
        return _fa_ref.chunked(q, k, v, causal=causal, scale=scale,
                               block_kv=block_kv, q_offset=q_offset)
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)


def decode_attention(q, k, v, cache_len, *, scale=None, impl=None):
    if _plain(impl, q):
        return _dec_ref.decode_ref(q, k, v, cache_len, scale=scale)
    return _dec.decode_attention(q, k, v, cache_len, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           scale=None, impl=None):
    if _plain(impl, q):
        return _dec_ref.paged_decode_ref(q, k_pages, v_pages, block_table,
                                         lengths, scale=scale)
    return _dec.paged_decode_attention(q, k_pages, v_pages, block_table,
                                       lengths, scale=scale)


def paged_prefill_attention(q, k_pages, v_pages, block_table, start,
                            n_valid, *, scale=None, impl=None):
    if _plain(impl, q):
        return _dec_ref.paged_prefill_ref(q, k_pages, v_pages, block_table,
                                          start, n_valid, scale=scale)
    return _dec.paged_prefill_attention(q, k_pages, v_pages, block_table,
                                        start, n_valid, scale=scale)


def rmsnorm(x, weight, *, eps=1e-5, impl=None):
    if _plain(impl, x) or x.device.type == "cpu":
        return _rn_ref.rmsnorm_ref(x, weight, eps=eps)
    return _rn.rmsnorm(x, weight, eps=eps)


def moe_gemm(x, w, *, impl=None):
    if _plain(impl, x) or x.device.type == "cpu":
        return _moe_ref.moe_gemm_ref(x, w)
    return _moe.moe_gemm(x, w)


def quantize_int8(x, *, impl=None):
    """Block-scaled symmetric int8: x (n_blocks, block) f32 -> (codes
    int8, scales f32 (n_blocks,)).  The cross-pod gradient compression
    primitive (see repro_torch/comm/collectives.py)."""
    if _plain(impl, x):
        return _q_ref.quantize_int8_ref(x, block=x.shape[-1])
    return _q.quantize_int8(x)


def dequantize_int8(codes, scales, *, impl=None):
    if _plain(impl, codes):
        return _q_ref.dequantize_int8_ref(codes, scales)
    return _q.dequantize_int8(codes, scales)
