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

The layers' collectives for tensor, expert and FSDP parallelism live
here too, each an ``autograd.Function`` over one axis's group:
``copy_to`` (identity forward, all-reduce backward), ``reduce_from``
(all-reduce forward, identity backward), ``gather_dim`` (all-gather
forward, reduce-scatter backward), ``exchange`` (the all-to-all of
hierarchical MoE dispatch over ``pod``, and of a sequence mixer's
in-projection halves over ``model``) and ``vocab_parallel_xent``;
``broadcast_along`` hands a serving engine's logits from the data shard
that ran a prompt to the others (no gradient).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.compress import EF_POD_AXIS
from repro_torch.comm.topology import CommTopology
from repro_torch.configs.base import ShardingStrategy
from repro_torch.dist.sharding import DATA_AXES, param_rules
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


# logical axis of a stacked per-chunk gradient's leading dim
DP_CHUNK_AXIS = "dp_chunks"


def _no_pod(rule):
    if rule is None:
        return None
    t = rule if isinstance(rule, tuple) else (rule,)
    t = tuple(a for a in t if a != "pod")
    return t[0] if len(t) == 1 else (t or None)


def grad_rules(strategy: ShardingStrategy):
    """Rule table for the comm layer's trees (the reference's): the
    residual's leading dim owns ``pod``, its trailing dims keep only the
    tensor and expert axes (``embed`` and ``pod`` stripped), so a rank
    holds its pod's row of its model-axis shard of each leaf."""
    rules = {k: _no_pod(v) for k, v in param_rules(strategy).items()}
    rules["embed"] = None
    rules[DP_CHUNK_AXIS] = DATA_AXES
    rules[EF_POD_AXIS] = "pod"
    return rules


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


def sum_over(x, mesh, axes):
    """Sum ``x`` in place over the ranks that differ only along ``axes``
    (one all-reduce an axis; every rank of the mesh when ``axes`` are all
    of its axes of size > 1)."""
    live = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not live:
        return x
    if len(live) > 1 and set(live) == {a for a, n in mesh.shape.items()
                                       if n > 1}:
        return all_reduce_sum(x, mesh)
    for a in live:
        _sum(x, mesh, a)
    return x


# --------------------------------------------------------------------------
# Tensor, expert and FSDP parallelism: collectives autograd runs through
# --------------------------------------------------------------------------
#
# Each is an ``autograd.Function`` over one axis's gloo group.  A CUDA
# payload goes through host memory in the collective itself (``_staged``:
# page-locked host tensors, copies that do not block): gloo's CUDA
# path is proven for float32 and int8 reduce-scatter, all-gather and
# all-reduce only, and these carry bfloat16 activations and an
# all-to-all.  On a mesh of one rank (or an axis of size 1) each is the
# identity.


def _live_group(mesh, axis):
    if mesh is None or mesh.size == 1 or mesh.shape.get(axis, 1) == 1:
        return None
    return mesh.group(axis)


def _staged(op, x, out_shape=None):
    """``op(inp, out)`` on a contiguous copy of ``x``; returns ``out``
    (``inp`` itself, reduced in place, when ``out_shape`` is None) on
    ``x``'s device.  A CUDA ``x`` goes through page-locked host tensors,
    copied there and back without blocking: the stream is synchronized
    before gloo reads them, and torch's caching host allocator, which
    hands the pinned blocks out again, holds a block back until the copy
    that reads it has finished."""
    if not x.is_cuda:
        inp = x.detach().clone().contiguous()
        out = inp if out_shape is None else inp.new_empty(out_shape)
        op(inp, out)
        return out
    inp = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    inp.copy_(x.detach(), non_blocking=True)
    out = inp if out_shape is None else torch.empty(
        out_shape, dtype=x.dtype, pin_memory=True)
    torch.cuda.current_stream(x.device).synchronize()
    op(inp, out)
    return out.to(x.device, non_blocking=True)


def _reduce(x, mesh, axis, op=dist.ReduceOp.SUM):
    """All-reduce of ``x`` over ``axis`` into a new tensor."""
    g = _live_group(mesh, axis)
    if g is None:
        return x
    _count(x, axis)
    return _staged(lambda i, o: dist.all_reduce(i, op=op, group=g), x)


def gather_along(x, dim, mesh, axis):
    """All-gather of ``x`` over ``axis`` along ``dim``, in the axis's
    coordinate order."""
    g = _live_group(mesh, axis)
    if g is None:
        return x
    n = mesh.shape[axis]
    _count(x, axis)
    front = x.movedim(dim, 0)
    out = _staged(lambda i, o: dist.all_gather_into_tensor(o, i, group=g),
                  front, (n * front.shape[0],) + tuple(front.shape[1:]))
    return out.movedim(0, dim)


def scatter_along(x, dim, mesh, axis):
    """Reduce-scatter (sum) of ``x`` over ``axis`` along ``dim``: this
    rank's 1/n of the sum."""
    g = _live_group(mesh, axis)
    if g is None:
        return x
    n = mesh.shape[axis]
    _count(x, axis)
    front = x.movedim(dim, 0)
    out = _staged(lambda i, o: dist.reduce_scatter_tensor(o, i, group=g),
                  front, (front.shape[0] // n,) + tuple(front.shape[1:]))
    return out.movedim(0, dim)


def broadcast_along(x, mesh, axis, src: int):
    """``x`` of the rank at coordinate ``src`` of ``axis`` (this rank's
    other coordinates), on every rank of the axis's group: each passes a
    tensor of the same shape and dtype, and gets the source's back."""
    g = _live_group(mesh, axis)
    if g is None:
        return x
    coords = dict(mesh.coords, **{axis: src})
    root = int(np.ravel_multi_index(tuple(coords[a] for a in mesh.axis_names),
                                    tuple(mesh.shape.values())))
    if mesh.coords[axis] == src:
        _count(x, axis)
    return _staged(lambda i, o: dist.broadcast(i, root, group=g), x)


def slice_along(x, dim, mesh, axis):
    """This rank's 1/n of ``x`` along ``dim`` over ``axis``."""
    n = mesh.shape.get(axis, 1) if mesh is not None and mesh.size > 1 else 1
    if n == 1:
        return x
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.coords[axis] * k, k)


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated tensor entering
    a computation each rank of ``axis`` does a part of (the input of a
    column-parallel product, of local experts, of local vocab logits)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product (or of local experts) made whole."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherDim(torch.autograd.Function):
    """All-gather forward over ``axes`` (rank-major, as a
    ``NamedSharding`` lays a dim over a tuple of axes); backward a
    reduce-scatter where the ranks of ``axes`` took different batch rows
    (``sum_grads``: FSDP), else this rank's slice of a gradient every
    rank of ``axes`` holds whole."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh, sum_grads):
        ctx.dim, ctx.axes, ctx.mesh, ctx.sum = dim, axes, mesh, sum_grads
        for a in reversed(axes):
            x = gather_along(x, dim, mesh, a)
        return x

    @staticmethod
    def backward(ctx, grad):
        for a in ctx.axes:
            grad = (scatter_along(grad, ctx.dim, ctx.mesh, a) if ctx.sum
                    else slice_along(grad, ctx.dim, ctx.mesh, a))
        return grad, None, None, None, None


def _exchange(x, mesh, axis, send=None, recv=None):
    """All-to-all over ``axis``: block j of ``x``'s first dim goes to the
    rank at coordinate j, whose block arrives at position j.  ``send``
    and ``recv`` (rows a rank, None: equal blocks) make the blocks
    uneven: ``send[j]`` rows go to rank j, ``recv[j]`` come from it.
    Only the rows bound for other ranks are counted: this rank's own
    block does not move."""
    g = _live_group(mesh, axis)
    if g is None:
        return x
    n, me = mesh.shape[axis], mesh.coords[axis]
    row = x[0].numel() * x.element_size()
    moved = (x.shape[0] * (n - 1) // n if send is None
             else sum(k for j, k in enumerate(send) if j != me))
    PAYLOAD_BYTES[axis] = PAYLOAD_BYTES.get(axis, 0) + moved * row
    rows = x.shape[0] if recv is None else sum(recv)
    return _staged(lambda i, o: dist.all_to_all_single(
        o, i, output_split_sizes=recv, input_split_sizes=send, group=g),
        x, (rows,) + tuple(x.shape[1:]))


class _Exchange(torch.autograd.Function):
    """The all-to-all of :func:`_exchange`; its backward sends each
    block's gradient back the way it came (the exchange with ``send``
    and ``recv`` swapped)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, send, recv):
        ctx.mesh, ctx.axis, ctx.sizes = mesh, axis, (send, recv)
        return _exchange(x, mesh, axis, send, recv)

    @staticmethod
    def backward(ctx, grad):
        send, recv = ctx.sizes
        return (_exchange(grad, ctx.mesh, ctx.axis, recv, send),
                None, None, None, None)


def copy_to(x, mesh, axis):
    return x if _live_group(mesh, axis) is None else \
        _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    return x if _live_group(mesh, axis) is None else \
        _ReduceFrom.apply(x, mesh, axis)


def gather_dim(x, dim, axes, mesh, *, sum_grads=True):
    """``x`` gathered along ``dim`` over the tuple ``axes`` (outermost
    first); see :class:`_GatherDim`."""
    axes = tuple(a for a in axes if _live_group(mesh, a) is not None)
    return _GatherDim.apply(x, dim, axes, mesh, sum_grads) if axes else x


def exchange(x, mesh, axis, send=None, recv=None):
    """See :func:`_exchange`; ``send``/``recv`` lists of rows a rank."""
    return x if _live_group(mesh, axis) is None else \
        _Exchange.apply(x, mesh, axis, send, recv)


class _VocabParallelXent(torch.autograd.Function):
    """Per-token cross-entropy of logits whose vocabulary is split over
    ``axis`` (this rank's columns ``[start, start + V_local)``): the max,
    the sum of exponentials and the target logit are all-reduced, so no
    rank gathers a (B, S, V) tensor.  Backward: softmax minus the
    one-hot, on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, start, mesh, axis):
        mx = _reduce(logits.detach().amax(-1), mesh, axis,
                     op=dist.ReduceOp.MAX)
        p = torch.exp(logits.detach() - mx[..., None])
        total = _reduce(p.sum(-1), mesh, axis)
        local = labels.long() - start
        hit = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)
        gold = torch.gather(logits.detach(), -1, idx[..., None])[..., 0]
        gold = _reduce(torch.where(hit, gold, torch.zeros_like(gold)),
                       mesh, axis)
        p.div_(total[..., None])
        ctx.save_for_backward(p, idx, hit)
        return mx + torch.log(total) - gold

    @staticmethod
    def backward(ctx, grad):
        p, idx, hit = ctx.saved_tensors
        out = p * grad[..., None]
        out.scatter_add_(-1, idx[..., None],
                         -(grad * hit.to(grad.dtype))[..., None])
        return out, None, None, None, None


def vocab_parallel_xent(logits, labels, start, mesh, axis):
    return _VocabParallelXent.apply(logits, labels, start, mesh, axis)


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
    (its pod's row, as ``grad_rules`` place it).

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
