"""Activation sharding constraints; the port of the JAX package's
``dist/actsharding.py``.

Model code marks activations with *logical* ``act_*`` names
(``constrain(x, "act_batch", None, "act_ff")``).  Inside an
``activation_sharding(mesh, strategy)`` context those names resolve to
mesh axes through the strategy's rule table; outside any context
``constrain`` is the identity, so the same model file runs anywhere.

The port runs a model on one device.  So inside a context ``constrain``
is the identity wherever the resolved spec shards nothing (every mesh
of one device), and raises ``NotImplementedError`` where it would shard:
placing an activation on a mesh is DTensor's work, ROADMAP Queue 1 item
5(d).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional

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


class _Ctx(threading.local):
    def __init__(self):
        self.stack = []


_CTX = _Ctx()


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, strategy: ShardingStrategy):
    """Enter the mesh/strategy under which ``constrain`` resolves."""
    _CTX.stack.append(_ActiveSharding(mesh, strategy, act_rules(strategy)))
    try:
        yield _CTX.stack[-1]
    finally:
        _CTX.stack.pop()


def current() -> Optional[_ActiveSharding]:
    return _CTX.stack[-1] if _CTX.stack else None


def constrain(x, *names):
    """Constrain ``x`` dim-by-dim to the named logical activation axes.

    Identity when no ``activation_sharding`` context is active, and
    inside one wherever the resolved spec splits no dim (unknown/None
    names, non-dividing axes, axes of size 1); raises where it would
    (Queue 1 item 5(d))."""
    ctx = current()
    if ctx is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(
            f"constrain: {len(names)} names for rank-{x.ndim} array")
    spec = resolve_spec(x.shape, names, ctx.rules, ctx.mesh)
    if all(axis_size(ctx.mesh, s if isinstance(s, tuple) else (s,)) == 1
           for s in spec if s is not None):
        return x
    raise NotImplementedError(
        f"constrain{names} resolves to {spec} on mesh {ctx.mesh.shape}: "
        "sharded activations wait for DTensor placements (ROADMAP Queue 1 "
        "item 5(d))")


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
