"""Topology-aware gradient collectives: the two-phase hierarchical sync.
The port of the JAX package's ``comm/collectives.py``.

``sync_grads`` reduces per-chunk gradients over the mesh's process
groups in the tier order ``CommTopology`` derives from the mesh, where
the JAX package runs the same three phases inside a ``shard_map``:

1. **reduce-scatter inside each pod** over the fast ``data`` axis —
   every rank ends up owning one shard of its pod's summed gradient;
2. **all-reduce the shards across pods** over the slow ``pod`` axis —
   the only phase that crosses the pod boundary, and the only phase
   int8 compression touches: with ``policy.compress`` each rank adds its
   slice of its pod's error-feedback residual, quantizes the sum
   (``kernels.ops.quantize_int8``), and the int8 codes and per-block
   scales are what the pod group exchanges (an all-gather); every rank
   dequantizes all pods' payloads in one launch and sums them;
3. **all-gather back** over ``data`` so every rank holds the full
   synced gradient.

The composition is numerically interchangeable with a flat all-reduce
mean over ``(pod, data)``.  Each rank passes its own chunks, chunk ``i``
of the global ``n_chunks`` covering rows ``[i*B/n, (i+1)*B/n)`` of the
batch, pod-major.  Before the scatter each pod's chunk sum is scaled to
the POD-MEAN gradient, a quantity invariant under resizes of the data
tier.

``resolve_policy`` is the single fallback gate: a strategy asking for
hierarchical/compressed sync on a mesh that cannot honor it degrades
to flat sync with one structured ``CommFallbackWarning`` — or raises
``CommTopologyError`` when the strategy pins ``comm_strict``.

The groups are gloo, which moves CUDA tensors through host memory
itself (torch 2.11's gloo takes CUDA payloads of float32 and int8 for
all three operations), so ranks may share one card.  ``PAYLOAD_BYTES``
counts the bytes each rank hands to the collectives of each axis.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.comm.topology import CommTopology
from repro_torch.configs.base import ShardingStrategy
from repro_torch.kernels import ops
from repro_torch.models import params as P


class CommFallbackWarning(UserWarning):
    """The requested comm schedule degraded to flat sync (one per build)."""


class CommTopologyError(ValueError):
    """``comm_strict``: the mesh cannot honor the requested schedule."""


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """Resolved (strategy x mesh) communication decision."""

    hierarchical: bool = False
    compress: bool = False
    block: int = 256
    pods: int = 0                  # compression schema rows (strategy)
    buckets: int = 1               # sync buckets (1 = monolithic)


def degrade(strategy: ShardingStrategy, why: str, mesh=None) -> None:
    """Flat-sync fallback: warn once per step build, or raise under
    ``comm_strict`` — the silent-no-op failure mode is pinned out.

    The warning MESSAGE carries the mesh axis-shape: the warnings
    registry dedups on message text, so a rebuild onto a *different*
    degraded mesh re-warns instead of being swallowed by the first
    mesh's warning (rebuilding on the SAME mesh stays deduped).
    """
    msg = (f"comm: strategy {strategy.name!r} requested hierarchical/"
           f"compressed gradient sync but {why}; falling back to flat sync")
    if mesh is not None:
        msg += f" [mesh={dict(mesh.shape)}]"
    if strategy.comm_strict:
        raise CommTopologyError(msg)
    warnings.warn(msg, CommFallbackWarning, stacklevel=3)


def resolve_policy(strategy: ShardingStrategy, mesh) -> CommPolicy:
    """Decide what the comm layer actually does on this mesh."""
    if not (strategy.hierarchical_collectives or strategy.compress_cross_pod):
        return CommPolicy()
    topo = CommTopology.from_mesh(mesh)
    if not topo.has_pod_tier:
        degrade(strategy, "the mesh has no pod tier (axis 'pod' missing "
                f"or size 1)", mesh=mesh)
        return CommPolicy()
    compress = bool(strategy.compress_cross_pod)
    if compress and topo.pod_size != strategy.compress_pods:
        degrade(strategy, f"the mesh pod tier ({topo.pod_size}) does not "
                f"match strategy.compress_pods ({strategy.compress_pods}) "
                "— the error-feedback schema is strategy-sized", mesh=mesh)
        compress = False
    return CommPolicy(hierarchical=True, compress=compress,
                      block=strategy.compress_block,
                      pods=strategy.compress_pods,
                      buckets=max(int(strategy.comm_buckets), 1))


# --------------------------------------------------------------------------
# The collectives, over gloo groups
# --------------------------------------------------------------------------

# bytes each rank handed to the collectives of each mesh axis
# ("world" for the flat all-reduce)
PAYLOAD_BYTES: Dict[str, int] = {}


def reset_counters() -> None:
    PAYLOAD_BYTES.clear()


def _count(x, axis: str) -> None:
    PAYLOAD_BYTES[axis] = (PAYLOAD_BYTES.get(axis, 0)
                           + x.numel() * x.element_size())


def _scatter(x, mesh, axis):
    """Reduce-scatter (sum) of ``x`` over ``axis``: this rank's 1/n."""
    g = mesh.group(axis)
    if g is None:
        return x
    out = x.new_empty(x.numel() // mesh.shape[axis])
    _count(x, axis)
    dist.reduce_scatter_tensor(out, x, group=g)
    return out


def _gather(x, mesh, axis):
    """All-gather of ``x`` over ``axis`` along its first dim."""
    g = mesh.group(axis)
    if g is None:
        return x
    out = x.new_empty((mesh.shape[axis] * x.shape[0],) + tuple(x.shape[1:]))
    _count(x, axis)
    dist.all_gather_into_tensor(out, x, group=g)
    return out


def _sum(x, mesh, axis):
    """All-reduce (sum) of ``x`` over ``axis``, in place."""
    g = mesh.group(axis)
    if g is not None:
        _count(x, axis)
        dist.all_reduce(x, group=g)
    return x


def all_reduce_sum(x, mesh):
    """Sum ``x`` in place over every rank of ``mesh`` (the flat sync)."""
    if mesh.size > 1:
        _count(x, "world")
        dist.all_reduce(x)
    return x


# --------------------------------------------------------------------------
# The two-phase sync
# --------------------------------------------------------------------------


def sync_grads(stacked, defs, mesh, policy: CommPolicy,
               strategy: ShardingStrategy, residual=None):
    """Hierarchically reduce per-chunk gradients to their mean.

    ``stacked``: tree matching ``defs``; each leaf is this rank's
    ``(n_local, *param_shape)`` per-chunk MEAN gradients, the rank's
    share of the global ``n_local * pod * data`` chunks.  ``residual``:
    this rank's rows of the error-feedback tree, ``(1, *param_shape)``
    (its pod's row; ``compress.ef_rows``).

    Returns ``(mean_grads, new_residual)``: the whole synced float32
    gradient on every rank, and the residual, which passes through
    untouched unless ``policy.compress`` and a residual tree is given.
    """
    g_leaves = P.tree_leaves(stacked)
    pod = mesh.shape.get("pod", 1)
    data = mesh.shape.get("data", 1)
    n_chunks = g_leaves[0].shape[0] * pod * data
    block = int(policy.block)
    compress = bool(policy.compress) and residual is not None
    d_idx = mesh.coords.get("data", 0)
    p_idx = mesh.coords.get("pod", 0)

    def sync_leaf(g, e):
        shape = g.shape[1:]
        n = g[0].numel()
        unit = data * block
        padded = -(-n // unit) * unit
        k = padded // data
        # local chunk partial sum, scaled to the pod-mean gradient: sum
        # over a pod's n_chunks/pod chunks of per-chunk means, divided by
        # that count — invariant under data-tier resizes
        flat = torch.zeros(padded, dtype=torch.float32, device=g.device)
        part = g[0] if g.shape[0] == 1 else g.sum(0)
        torch.mul(part.reshape(-1).float(), pod / float(n_chunks),
                  out=flat[:n])
        # phase 1: reduce-scatter inside the pod over the fast axis
        s = _scatter(flat, mesh, "data")
        del flat
        if compress:
            # phase 2 (compressed): the payload plus this rank's slice of
            # its pod's residual, quantized; only int8 codes and block
            # scales cross the pod boundary
            lo = d_idx * k
            m = max(0, min(n, lo + k) - lo)
            x = s.clone()
            x[:m].add_(e[0].reshape(-1)[lo:lo + m].float())
            codes, scales = ops.quantize_int8(x.view(-1, block))
            deq = ops.dequantize_int8(_gather(codes, mesh, "pod"),
                                      _gather(scales, mesh, "pod"))
            deq = deq.view(pod, k)
            err = x.sub_(deq[p_idx])
            s = deq.sum(0)
            e_new = _gather(err, mesh, "data")[:n]
            e_new = e_new.reshape(shape)[None].to(e.dtype)
        else:
            # phase 2: all-reduce the shards across pods
            s = _sum(s, mesh, "pod")
            e_new = e
        # phase 3: all-gather the synced shards back inside the pod
        out = _gather(s, mesh, "data")
        return out[:n].div_(pod).view(shape), e_new

    if not compress:
        synced = [sync_leaf(g, None)[0] for g in g_leaves]
        return P.tree_unflatten(stacked, synced), residual
    outs = [sync_leaf(g, e) for g, e in
            zip(g_leaves, P.tree_leaves(residual))]
    return (P.tree_unflatten(stacked, [o[0] for o in outs]),
            P.tree_unflatten(residual, [o[1] for o in outs]))


# --------------------------------------------------------------------------
# Bucketed sync: one two-phase schedule per bucket, reverse-layer order
# --------------------------------------------------------------------------


def sync_grads_bucketed(stacked, defs, mesh, policy: CommPolicy,
                        strategy: ShardingStrategy, residual=None):
    """:func:`sync_grads`, issued as ``policy.buckets`` independent
    syncs in reverse-layer order.

    Backward finalizes deep layers' gradients first, so issuing the deep
    buckets' cross-pod phase as its own sync lets a runtime that
    overlaps communication with the still-running shallow backward do
    so.  The reduction per leaf is untouched, so the result is
    numerically interchangeable with the monolithic sync for every
    bucket count, and per-bucket EF residuals are just path-slices of
    the one strategy-schema'd residual tree.
    """
    from repro_torch.comm import bucketing

    if policy.buckets <= 1:
        return sync_grads(stacked, defs, mesh, policy, strategy,
                          residual=residual)
    buckets = bucketing.partition_buckets(defs, policy.buckets)
    d_sub = bucketing.bucket_subtrees(defs, defs, buckets)
    g_sub = bucketing.bucket_subtrees(stacked, defs, buckets)
    e_sub = (bucketing.bucket_subtrees(residual, defs, buckets)
             if residual is not None else [None] * len(buckets))
    g_out, e_out = [], []
    for db, gb, eb in zip(d_sub, g_sub, e_sub):
        g, e = sync_grads(gb, db, mesh, policy, strategy, residual=eb)
        g_out.append(g)
        e_out.append(e)
    synced = bucketing.unbucket_leaves(g_out, defs, buckets)
    if residual is None:
        return synced, residual
    return synced, bucketing.unbucket_leaves(e_out, defs, buckets)
