"""Activation sharding constraints and the mesh the model code runs
on; the port of the JAX package's ``dist/actsharding.py``.

Model code marks activations with *logical* ``act_*`` names
(``constrain(x, "act_batch", None, "act_ff")``).  Inside an
``activation_sharding(mesh, strategy)`` context those names resolve to
mesh axes through the strategy's rule table; outside any context
``constrain`` is the identity, so the same model file runs anywhere.

In the port ``constrain`` is always the identity: a rank holds the
activations its own computation makes, and where they live is the
port's choice, not a constraint the model states.  The context is what
the model code reads to learn the mesh, the strategy and this rank's
coordinates (:func:`current`, :func:`tp`): a layer whose weights are
split over the ``model`` axis computes its part and runs the
collectives of ``comm.collectives`` that make it whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ShardingStrategy
from repro_torch.dist.mesh import Mesh, axis_size
from repro_torch.dist.sharding import DATA_AXES, Rule, Spec, resolve_spec


def act_rules(strategy: ShardingStrategy) -> Dict[str, Rule]:
    """Activation rule table; ``act_*_force`` names apply regardless of
    the strategy's optional toggles (the call site has already decided
    sharding is required, e.g. heads unshardable on this mesh)."""
    tp = "model" if strategy.tensor_parallel else None
    return {
        "act_batch": DATA_AXES,
        "act_seq": tp if strategy.seq_shard_activations else None,
        "act_seq_force": tp,
        "act_heads": tp,
        "act_kv": tp,
        "act_kv_seq": tp if strategy.kv_seq_axis == "model" else None,
        "act_ff": tp,
        "act_vocab": tp,
        "act_expert": "model" if strategy.expert_parallel else None,
        # hierarchical MoE: the expert HOME dim (which pod owns the
        # expert) shards over the pod tier; the resolver then keeps
        # ``act_batch`` off ``pod`` in the same spec (axis used once)
        "act_expert_home": "pod" if strategy.hierarchical_moe else None,
        "act_inner": tp,
    }


@dataclasses.dataclass(frozen=True)
class _ActiveSharding:
    mesh: Mesh
    strategy: ShardingStrategy
    rules: Dict[str, Rule]
    # the global rows of the batch the ranks run, where every rank of the
    # batch axes takes as many (None: unknown, or uneven)
    global_rows: Optional[int] = None


class _Ctx(threading.local):
    def __init__(self):
        self.stack = []


_CTX = _Ctx()


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, strategy: ShardingStrategy, *,
                        global_rows: Optional[int] = None):
    """Enter the mesh/strategy under which ``constrain`` resolves and the
    model code places its work."""
    _CTX.stack.append(_ActiveSharding(mesh, strategy, act_rules(strategy),
                                      global_rows))
    try:
        yield _CTX.stack[-1]
    finally:
        _CTX.stack.pop()


def current() -> Optional[_ActiveSharding]:
    return _CTX.stack[-1] if _CTX.stack else None


@contextlib.contextmanager
def reenter(ctx: Optional[_ActiveSharding]):
    """``ctx`` active again inside the block, where it is not already:
    a checkpointed block's recomputation runs on the autograd engine's
    thread (a CUDA backward's device thread), which sees no context of
    the thread that entered it, so the block takes it as an argument."""
    if ctx is None or current() is ctx:
        yield ctx
        return
    _CTX.stack.append(ctx)
    try:
        yield ctx
    finally:
        _CTX.stack.pop()


def constrain(x, *names):
    """Constrain ``x`` dim-by-dim to the named logical activation axes:
    the identity in the port (where an activation lives is the port's
    choice); the names are still checked against ``x``'s rank."""
    ctx = current()
    if ctx is not None and len(names) != x.ndim:
        raise ValueError(
            f"constrain: {len(names)} names for rank-{x.ndim} array")
    return x


def on_ranks() -> Optional[_ActiveSharding]:
    """The active context where its mesh runs over several ranks (each
    holding shards), else None (one process: every leaf is whole)."""
    ctx = current()
    return ctx if ctx is not None and ctx.mesh.spans_ranks else None


def tp() -> Tuple[Optional[Mesh], int]:
    """(mesh, size of its ``model`` axis) where the active context splits
    layers over that axis: tensor parallelism on, a mesh of ranks, the
    axis larger than 1; else (None, 1)."""
    ctx = on_ranks()
    if ctx is None or not ctx.strategy.tensor_parallel:
        return None, 1
    n = ctx.mesh.shape.get("model", 1)
    return (ctx.mesh, n) if n > 1 else (None, 1)


def tp_splits(full: int) -> bool:
    """Whether a dim of ``full`` whose logical axis maps to ``model``
    (heads, kv_heads, ff, vocab) is split here: the rule's axis divides
    it (``resolve_spec``'s test)."""
    mesh, n = tp()
    return mesh is not None and full % n == 0


def tp_state_shape(d) -> Tuple[int, ...]:
    """The shape of this rank's part of a decode-state leaf of PDef
    ``d`` under tensor parallelism: ``resolve_spec``'s split of it by
    ``cache_rules``, over ``model`` only (its batch rows are the
    caller's); ``d.shape`` where the context splits nothing."""
    mesh, _ = tp()
    if mesh is None:
        return tuple(d.shape)
    from repro_torch.dist.sharding import (cache_rules, entry_axes,
                                           local_shape, resolve_spec)
    spec = resolve_spec(d.shape, d.axes, cache_rules(current().strategy),
                        mesh)
    return local_shape(d.shape, tuple("model" if "model" in entry_axes(e)
                                      else None for e in spec), mesh)


def gather_leaves(params, defs, *, skip=()):
    """Each leaf of ``params`` (a tree shaped like the PDef tree ``defs``,
    unstacked) gathered over the axes of its spec whose ranks take
    different batch rows: FSDP's gather of a leaf split over ``data`` (or
    ``("data", "model")`` without tensor parallelism), whose backward
    reduce-scatters the gradient.  Dims split over ``model`` under tensor
    parallelism stay split for the layer.  Identity off ranks; leaves
    whose key is in ``skip`` pass through (MoE experts place themselves).
    Every rank gathers the same leaves in the same (sorted) order."""
    ctx = on_ranks()
    if ctx is None or not (ctx.strategy.fsdp_params
                           or not ctx.strategy.tensor_parallel):
        return params
    from repro_torch.comm import collectives as coll
    from repro_torch.dist.mesh import batch_axes
    from repro_torch.dist.sharding import entry_axes, param_rules
    rules = param_rules(ctx.strategy)
    batch = batch_axes(ctx.mesh, ctx.strategy.tensor_parallel)

    def one(t, d):
        spec = resolve_spec(d.shape, d.axes, rules, ctx.mesh)
        for dim, e in enumerate(spec):
            axes = entry_axes(e)
            over = tuple(a for a in axes if a in batch)
            if not over:
                continue
            if over != axes[:len(over)]:
                raise NotImplementedError(
                    f"a dim split over {axes}: the batch axes {over} must "
                    "come first to be gathered alone")
            t = coll.gather_dim(t, dim, over, ctx.mesh, sum_grads=True)
        return t

    def walk(p, d):
        return {k: walk(p[k], d[k]) if isinstance(p[k], dict)
                else one(p[k], d[k]) for k in sorted(p)}

    return {k: params[k] if k in skip else
            walk(params[k], defs[k]) if isinstance(params[k], dict)
            else one(params[k], defs[k]) for k in sorted(params)}


def model_axis_divides(n: int) -> bool:
    """Whether the active tensor-parallel axis evenly divides ``n``
    (vacuously true off-mesh and without tensor parallelism)."""
    ctx = current()
    if ctx is None or not ctx.strategy.tensor_parallel:
        return True
    return n % ctx.mesh.shape.get("model", 1) == 0


def activation_spec(mesh: Mesh, strategy: ShardingStrategy, shape,
                    *names) -> Spec:
    """Resolve act names outside a context (output-sharding declarations)."""
    return resolve_spec(shape, names, act_rules(strategy), mesh)
