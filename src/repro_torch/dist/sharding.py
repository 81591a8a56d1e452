"""Parameter, optimizer-state and cache sharding: logical axis names ->
mesh axes, and the operator's bridge from a Fluxion ``ResourceSet`` to a
mesh.  The port of the JAX package's ``dist/sharding.py``.

Model code never names mesh axes.  Weights declare *logical* axes in
their ``PDef``s (``embed``, ``heads``, ``ff``, ``vocab``, ``expert``,
...) and a :class:`~repro_torch.configs.base.ShardingStrategy` picks the
rule table that maps each logical axis onto zero or more mesh axes.  The
resolver then enforces the physical constraints the rule tables cannot
know about:

* a mesh axis that does not exist on this mesh is dropped;
* a mesh axis whose size does not divide the dimension is dropped;
* a mesh axis is used at most once per spec.

A resolved spec is a plain tuple with one entry per tensor dimension:
``None``, a mesh axis name, or a tuple of names (``tuple(spec)`` of the
reference's ``PartitionSpec``).  The resolvers read only ``mesh.shape``.

Placement: on a mesh of ranks each rank holds one shard of a leaf, a
plain tensor of :func:`local_shape` (no DTensor: the kernels take local
tensors).  A dim split over a tuple of axes is laid out rank-major over
the tuple, as a ``NamedSharding`` lays it: :func:`shard` cuts a whole
tensor to this rank's shard, :func:`gather` collects a shard back to
the whole tensor over the spec's axes (every rank of the mesh must
call it, leaf by leaf in the same order).  A mesh built from a shape
alone gives one rank's shapes and shards without running anything.

``submesh_for``'s mesh is a ``dist.mesh.Mesh`` whose ``devices`` hold
``torch.device``s of this process.  The degrade rule is the JAX
package's: an allocation that names more chips than the list holds
becomes the largest (hosts, chips) grid that fits, down to one device.
On one card every allocation is therefore ``(1, 1)`` on ``cuda:0``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ShardingStrategy
from repro_torch.device import resolve_device
from repro_torch.dist.mesh import DATA_AXES, Mesh, axis_size, data_axes

# A rule maps a logical axis name to a mesh axis, a tuple of mesh axes,
# or None (replicated).
Rule = Union[str, Tuple[str, ...], None]
# A resolved spec: one Rule-like entry per tensor dimension.
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]


def device_list(device=None) -> List[torch.device]:
    """The devices a mesh may take: every card of this process (``device``
    None or a CUDA device; raises where there is no card), or the one CPU
    device when ``device`` is ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def replicated(mesh: Mesh) -> Spec:
    """The spec that shards nothing (``PartitionSpec()``)."""
    return ()


# --------------------------------------------------------------------------
# Rule tables
# --------------------------------------------------------------------------


def param_rules(strategy: ShardingStrategy) -> Dict[str, Rule]:
    """Weight sharding rules (see models/layers.py for the axis names)."""
    tp = "model" if strategy.tensor_parallel else None
    if strategy.fsdp_params:
        # ZeRO-3; without TP the model axis joins the FSDP domain
        embed: Rule = "data" if strategy.tensor_parallel \
            else ("data", "model")
    else:
        embed = None
    if not strategy.expert_parallel:
        expert: Rule = None
    elif strategy.hierarchical_moe:
        # experts span the pod tier too (pod-major), so each pod holds
        # only n_experts/P expert weights; on a pod-less mesh this
        # resolves back to plain model-axis expert parallelism
        expert = ("pod", "model")
    else:
        expert = "model"
    return {
        "embed": embed,
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "vocab": tp,
        "expert": expert,
        "mamba_in": tp,
        "xl_in": tp,
        "xl_heads": tp,
    }


def opt_rules(strategy: ShardingStrategy) -> Dict[str, Rule]:
    """Optimizer-state rules: ZeRO-1 — states shard over the data axis
    even when the parameters themselves are replicated."""
    rules = dict(param_rules(strategy))
    if rules.get("embed") is None:
        rules["embed"] = "data"
    return rules


def cache_rules(strategy: ShardingStrategy) -> Dict[str, Rule]:
    """Decode-state rules (see transformer.cache_defs for the names).

    ``pages`` is the paged KV pool's page dim: a pool shards over the
    data tier exactly when the engine's host-side free lists are
    partitioned to match (``EngineConfig.dp_shards``; serve/paging)."""
    tp = "model" if strategy.tensor_parallel else None
    return {
        "batch": DATA_AXES,
        "pages": DATA_AXES,
        "kv_seq": tp if strategy.kv_seq_axis == "model" else None,
        "kv_heads": tp,
        "mamba_in": tp,
        "xl_in": tp,
        "xl_heads": tp,
    }


# --------------------------------------------------------------------------
# Resolution
# --------------------------------------------------------------------------


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 rules: Dict[str, Rule], mesh: Mesh) -> Spec:
    """Logical axes -> a resolved spec under this mesh's constraints;
    never raises."""
    used: set = set()
    spec = []
    for dim, name in zip(shape, axes):
        rule = rules.get(name) if name is not None else None
        cand: Tuple[str, ...] = () if rule is None else (
            rule if isinstance(rule, tuple) else (rule,))
        cand = tuple(a for a in cand if a in mesh.shape and a not in used)
        while cand and dim % axis_size(mesh, cand) != 0:
            cand = cand[:-1]
        if not cand:
            spec.append(None)
            continue
        used.update(cand)
        spec.append(cand[0] if len(cand) == 1 else cand)
    return tuple(spec)


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``()`` for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _splits(mesh: Mesh, entry) -> int:
    return axis_size(mesh, entry_axes(entry))


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's shard of a leaf of ``shape``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(d) // _splits(mesh, e) for d, e in zip(shape, spec))


def shard_index(entry, mesh: Mesh, coords=None) -> int:
    """This rank's chunk (or that of the rank at ``coords``) of a dim
    split over ``entry``'s axes: rank-major over the tuple (the first
    axis outermost)."""
    coords = mesh.coords if coords is None else coords
    idx = 0
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def _slices(shape, spec, mesh, coords):
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = int(d) // _splits(mesh, e)
        at = shard_index(e, mesh, coords) * k
        out.append(slice(at, at + k))
    return tuple(out)


def shard(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full``: a tensor of its
    own (``full`` may be freed), or ``full`` itself where the spec splits
    nothing here."""
    out = full
    for dim, e in enumerate(spec):
        n = _splits(mesh, e)
        if n > 1:
            k = out.shape[dim] // n
            out = out.narrow(dim, shard_index(e, mesh) * k, k)
    return out if out is full else out.clone(
        memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each rank's shard: an all-gather over the
    axes of every split dim (a collective: every rank calls it)."""
    from repro_torch.comm.collectives import gather_along
    out = local
    for dim, e in enumerate(spec):
        if _splits(mesh, e) > 1:
            for a in reversed(entry_axes(e)):
                out = gather_along(out, dim, mesh, a)
    return out


def gather_to_host(local: torch.Tensor, spec: Spec, mesh: Mesh):
    """The whole tensor in host memory on rank 0 (None on the other
    ranks): each rank's shard goes to rank 0 once, over the process
    group, and rank 0 lays each where its rank's coordinates put it.  A
    leaf the spec splits nothing of moves nothing.  A collective where it
    splits: every rank calls it."""
    import torch.distributed as dist
    host = local.detach().to("cpu")
    splits = [_splits(mesh, e) for e in spec]
    if all(n == 1 for n in splits):
        return host if mesh.rank == 0 else None
    shape = [d * n for d, n in zip(host.shape, splits)] + list(
        host.shape[len(splits):])
    host = host.contiguous()
    parts = ([torch.empty_like(host) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(host, parts, dst=0)
    if mesh.rank != 0:
        return None
    whole = host.new_empty(tuple(shape))
    dims = tuple(mesh.shape.values())
    for r, part in enumerate(parts):
        coords = dict(zip(mesh.axis_names,
                          (int(c) for c in np.unravel_index(r, dims))))
        whole[_slices(shape, spec, mesh, coords)] = part
    return whole


def tree_shardings(defs, mesh: Mesh, rules: Dict[str, Rule]):
    """PDef tree -> tree of resolved specs."""
    from repro_torch.models import params as P   # deferred: models import us
    return P.tree_map(
        lambda d: resolve_spec(d.shape, d.axes, rules, mesh), defs)


def cache_shardings(cdefs, mesh: Mesh, strategy: ShardingStrategy):
    return tree_shardings(cdefs, mesh, cache_rules(strategy))


def batch_sharding(mesh: Mesh, ndim: int, global_batch: int,
                   strategy: ShardingStrategy,
                   seq_dim: Optional[int] = None) -> Spec:
    """Model-input spec: batch over the data axes, optionally the
    sequence dim over the model axis (sequence-parallel residuals)."""
    spec: list = [None] * ndim
    d = data_axes(mesh)
    if not strategy.tensor_parallel and "model" in mesh.shape:
        d = d + ("model",)
    while d and global_batch % axis_size(mesh, d) != 0:
        d = d[:-1]
    if d:
        spec[0] = d[0] if len(d) == 1 else d
    if (seq_dim is not None and strategy.tensor_parallel
            and "model" in mesh.shape and "model" not in d):
        spec[seq_dim] = "model"
    return tuple(spec)


# --------------------------------------------------------------------------
# ResourceSet -> sub-mesh (the operator's bridge)
# --------------------------------------------------------------------------


def _pod_tier(rset) -> Optional[Tuple[int, int]]:
    """(n_pods, hosts_per_pod) when the allocation spans pods evenly.

    The pod tier only rises when it is well-formed: ≥ 2 distinct pods,
    the same host count in each, hosts grouped pod-contiguously (the
    graph numbers hosts pod-major, and matchers return sorted ids).
    Anything else — legacy ResourceSets without pod info, ragged spans
    — flattens to the classic (data, model) mesh.
    """
    pods = tuple(getattr(rset, "pods", ()) or ())
    if len(pods) != rset.n_hosts or len(set(pods)) < 2:
        return None
    if list(pods) != sorted(pods):
        return None
    counts = {p: pods.count(p) for p in set(pods)}
    if len(set(counts.values())) != 1:
        return None
    return len(counts), next(iter(counts.values()))


def submesh_for(rset, devices=None) -> Mesh:
    """Map a Flux ``ResourceSet`` allocation onto a device sub-mesh.

    The allocation's chip ids index ``devices`` (default:
    :func:`device_list`) directly — the resource graph drives physical
    placement.  Hosts become the ``data`` axis, chips-per-host the
    ``model`` axis; an allocation whose hosts span pods evenly yields a
    ``(pod, data, model)`` mesh.  When the allocation names more chips
    than the list has, the mesh degrades to the largest (hosts, chips)
    grid that fits, down to a single device.
    """
    devices = list(device_list() if devices is None else devices)
    nd = len(devices)
    cids = rset.chip_ids()
    if cids and len(cids) <= nd and max(cids) < nd:
        devs = [devices[c] for c in cids]
        tier = _pod_tier(rset)
        if tier is not None:
            n_pods, per_pod = tier
            shape: Tuple[int, ...] = (n_pods, per_pod, rset.chips_per_host)
            axes: Tuple[str, ...] = ("pod", "data", "model")
        else:
            shape = (rset.n_hosts, rset.chips_per_host)
            axes = ("data", "model")
    else:
        hosts = max(1, min(rset.n_hosts, nd))
        chips = max(1, min(rset.chips_per_host, nd // hosts))
        devs = devices[:hosts * chips]
        shape = (hosts, chips)
        axes = ("data", "model")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(shape, axes, devices=arr.reshape(shape))
