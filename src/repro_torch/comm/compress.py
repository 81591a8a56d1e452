"""Int8 error-feedback compression for the cross-pod gradient phase: the
port of the JAX package's ``comm/compress.py``.

Each pod's cross-pod payload (its pod-mean gradient shard, see
``collectives.sync_grads``) is quantized to int8 with one fp32 scale
per ``block`` contiguous elements (``kernels/quantize``).  What
quantization rounds away is NOT lost: the residual ``x - Q(x)`` is
added back into the next step's payload (error feedback), so small
gradient components accumulate until they clear the quantization
threshold — plain int8 rounding stalls on them forever.

The residual is TRAIN STATE.  Its schema is a function of the strategy
alone — one row per logical pod payload (``strategy.compress_pods``),
each row shaped like the parameter tree — never of the live mesh, so a
checkpoint holds the whole ``(pods, ...)`` array.  A rank of a mesh
whose pod tier has ``compress_pods`` pods holds only its own pod's row
(the row dim is split over ``pod``, ``collectives.grad_rules``);
mesh-dependent padding is transient inside the sync and never stored.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ShardingStrategy
from repro_torch.models import params as P

# logical axis name of the residual's leading (per-pod-payload) dim
EF_POD_AXIS = "ef_pod"


def ef_defs(model_defs, strategy: ShardingStrategy):
    """PDef tree for the error-feedback residual: one fp32 row per
    logical pod payload, each row shaped like the parameter leaf."""
    pods = max(int(strategy.compress_pods), 1)
    return P.tree_map(
        lambda d: dataclasses.replace(
            d, shape=(pods,) + d.shape, axes=(EF_POD_AXIS,) + d.axes,
            init="zeros", dtype="float32"),
        model_defs)


def compress_payload(x, block: int, *, impl=None):
    """Quantize/dequantize one flat payload (length % block == 0).

    Returns ``(deq, err)``: the values the payload's int8 codes and
    scales stand for, and the rounding error the caller feeds back into
    the residual.  Zero blocks round-trip exactly (scale 1.0), so padding
    never leaks into the residual.
    """
    from repro_torch.kernels import ops
    blocks = x.reshape(-1, block)
    codes, scales = ops.quantize_int8(blocks, impl=impl)
    deq = ops.dequantize_int8(codes, scales, impl=impl).reshape(x.shape)
    return deq, x - deq
