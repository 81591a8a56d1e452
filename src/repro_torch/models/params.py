"""Parameter definition trees, materialized as torch tensors.

The same ``PDef`` schema as the JAX package (shape, logical axes, init
recipe), over nested dicts.  ``init_params`` draws real tensors from an
explicit ``torch.Generator``; ``from_numpy`` carries a JAX parameter
tree (nested dicts of numpy arrays, e.g. from ``jax.device_get``) across
with the same key paths and the same leading ``n_repeats`` stacking.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # normal | zeros | ones | fan_in
    scale: float = 0.02
    custom: Optional[str] = None             # named custom init (mamba etc.)
    dtype: Optional[str] = None              # per-leaf dtype override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def stack(defs, reps: int, axis_name: Optional[str] = None):
    """Prepend a stacked layer dimension to every PDef in a tree."""
    return tree_map(
        lambda d: dataclasses.replace(
            d, shape=(reps,) + d.shape, axes=(axis_name,) + d.axes), defs)


def tree_map(f, tree):
    """Map ``f`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def tree_leaves(tree):
    """Leaves in sorted key order (the order ``jax.tree_util`` uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves, in ``tree_leaves``
    order, are ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        return next(it)

    return rebuild(tree)


def abstract_params(defs, dtype=torch.float32):
    """The tree's shapes and dtypes as tensors on the ``meta`` device
    (no storage): a template to restore a checkpoint into."""
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=DTYPES[d.dtype] if d.dtype else dtype,
        device="meta"), defs)


def _custom_init(name: str, generator, shape, device):
    """The JAX package's named inits, in float32: ``mamba_a_log`` and
    ``slstm_fgate_bias`` are deterministic (log 1..d_state over the
    channels; 3.0), ``mamba_dt_bias`` draws dt log-uniform in [1e-3,
    1e-1] and stores softplus^-1 of it."""
    if name == "mamba_a_log":
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).clone()
    if name == "mamba_dt_bias":
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    if name == "slstm_fgate_bias":
        return torch.full(shape, 3.0, dtype=torch.float32, device=device)
    raise ValueError(f"unknown custom init {name!r}")


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Materialize a PDef tree: normal(0, scale), normal(0, 1 /
    sqrt(fan_in)) with the JAX package's fan-in (the first dim of a
    matrix, stacked dims included), zeros, ones or a named custom init,
    in ``dtype`` unless a leaf overrides it.  Draws are made in float32
    and then cast, so a bfloat16 tree is the rounding of the float32 one
    from the same seed.
    """
    device = generator.device if device is None else torch.device(device)

    def make(d: PDef):
        dt = DTYPES[d.dtype] if d.dtype else dtype
        if d.custom is not None:
            return _custom_init(d.custom, generator, d.shape, device).to(dt)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "normal":
            scale = d.scale
        elif d.init == "fan_in":
            fan_in = d.shape[0] if len(d.shape) > 1 else max(d.shape[-1], 1)
            scale = 1.0 / math.sqrt(fan_in)
        else:
            raise ValueError(f"unsupported init {d.init!r}")
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dt)

    return tree_map(make, defs)


def from_numpy(tree, device=None):
    """Numpy leaves (float32 or ml_dtypes bfloat16) -> torch tensors.

    ``torch.from_numpy`` rejects bfloat16, so such a leaf goes through a
    16-bit integer view of the same bits.  The dtype is recognised by name
    so that no ``ml_dtypes`` import is needed.
    """
    def conv(a: Any):
        a = np.array(a)          # a writable copy: jax hands out read-only views
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device) if device is not None else t

    return tree_map(conv, tree)


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(defs))
