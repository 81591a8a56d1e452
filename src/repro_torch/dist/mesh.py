"""The port's device mesh: named axes over the ranks of the running
process group.  The mesh part of the JAX package's ``dist/sharding.py``
(``DATA_AXES``, ``make_mesh``, ``axis_size``, ``data_axes``); its rule
tables for tensor parallelism and FSDP wait for a later slice.

Ranks are laid out row-major over the axes, so on ``("pod", "data")``
rank = pod * data_size + data_index: pod-major, the chunk order the
train step's gradient chunks follow (``dist/steps.py``).  A mesh of one
rank needs no process group and is the single-device case.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

# mesh axes that carry the data-parallel dimension, outermost first
DATA_AXES = ("pod", "data")


class Mesh:
    """Axis names, their sizes (``shape``, a dict in axis order, as
    ``dict(jax_mesh.shape)`` reads), this rank, its coordinate on each
    axis, and one process group per axis of size > 1: ``group(axis)``
    holds the ranks that differ from this one only along ``axis``.

    A class of its own rather than ``torch.distributed.device_mesh``:
    ``init_device_mesh("cuda", ...)`` binds rank r to card r % count and
    builds its groups with the device type's default backend, and here
    several ranks may share one card with every group on gloo.  This
    class leaves the device to the caller and makes every group gloo.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0, groups: Optional[Dict] = None):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             "differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.size = int(np.prod(tuple(shape), dtype=np.int64))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            axes, (int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self._groups = dict(groups or {})

    def group(self, axis: str):
        """The process group along ``axis``; None where the axis has
        size 1 (nothing to talk to)."""
        if self.shape.get(axis, 1) > 1 and axis not in self._groups:
            raise RuntimeError(f"mesh {self.shape} has no process group "
                               f"for axis {axis!r}")
        return self._groups.get(axis)


def _axis_rank_sets(shape: Sequence[int], i: int):
    """The rank sets of axis ``i``: ranks that differ only in that axis."""
    ids = np.arange(int(np.prod(tuple(shape)))).reshape(tuple(shape))
    return np.moveaxis(ids, i, -1).reshape(-1, shape[i]).tolist()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              timeout: Optional[timedelta] = None) -> Mesh:
    """A mesh over the running process group, whose size must be the
    product of ``shape``; a mesh of one rank needs none.  Every rank
    must call this with the same arguments: each creates every axis
    group (``new_group`` is collective), gloo, with ``timeout`` (the
    library's default when None)."""
    n = int(np.prod(tuple(shape), dtype=np.int64))
    if n == 1:
        return Mesh(shape, axes)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise ValueError(f"a {tuple(shape)} mesh needs a process group of "
                         f"{n} ranks; the running one has {have}")
    rank = dist.get_rank()
    groups = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            continue
        for ranks in _axis_rank_sets(shape, i):
            g = dist.new_group(ranks, timeout=timeout, backend="gloo")
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape, axes, rank, groups)


def axis_size(mesh: Mesh, axes: Tuple[str, ...]) -> int:
    """Product of the named mesh axes' sizes (1 for the empty tuple)."""
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64)) \
        if axes else 1


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.shape)
