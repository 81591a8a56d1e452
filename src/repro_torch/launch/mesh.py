"""Local mesh builder and the one place the port's launchers turn an arch
id into ``(config, mesh)``; the port of the JAX package's
``launch/mesh.py``.

A mesh here is a ``dist.mesh.Mesh`` whose ``devices`` hold this
process's ``torch.device``s (``dist.sharding.device_list``).  Where the
process has fewer devices than the mesh wants, building it raises, as
``jax.make_mesh`` does: nothing shrinks to what there is.  The 16x16
production mesh of the JAX package comes with the port's dry run.

The one difference from the reference: ``resolve_workload`` gives the
FULL config unless ``smoke`` (the reference gives the SMOKE config
unless ``production``), because the port's local mesh is a card that
holds the full width.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import device_list


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` devices of
    :func:`~repro_torch.dist.sharding.device_list` (``device`` None: every
    card, from ``cuda:0``; a card with an index: the cards from it on;
    ``"cpu"``: the one CPU device).  Raises ``ValueError`` where there are
    fewer."""
    devices = device_list(device)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        devices = devices[dev.index:]
    n = data * model
    if n < 1 or n > len(devices):
        raise ValueError(
            f"a (data={data}, model={model}) mesh needs {n} devices; this "
            f"process has {len(devices)} ({', '.join(map(str, devices))})")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh((data, model), ("data", "model"),
                devices=arr.reshape(data, model))


def resolve_workload(arch: str, *, smoke: bool = False, dp: int = 1,
                     tp: int = 1, device=None):
    """Config-registry lookup and mesh construction in one place: the
    launchers resolve an arch id to ``(config, mesh)`` here, the full
    config unless ``smoke`` (the SMOKE config), on a local ``(dp, tp)``
    mesh over ``device``'s devices."""
    from repro_torch.configs import registry
    cfg = (registry.smoke if smoke else registry.get)(arch)
    return cfg, make_local_mesh(dp, tp, device)


# NVIDIA H100 SXM (data sheet): dense bf16 tensor-core FLOP/s and HBM3
# bytes/s, per card.  The comm layer's link tiers live with its
# bandwidth model (comm/topology.py).
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
