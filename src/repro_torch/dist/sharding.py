"""The operator's bridge to the port's devices: ``submesh_for``, the
part of the JAX package's ``dist/sharding.py`` that turns a Fluxion
``ResourceSet`` into a mesh.  Its rule tables (parameters, optimizer
state, caches), ``resolve_spec`` and ``batch_sharding`` wait for tensor
parallelism and FSDP (ROADMAP Queue 1 item 5).

The mesh is a ``dist.mesh.Mesh`` whose ``devices`` hold ``torch.device``s
of this process.  The degrade rule is the JAX package's: an allocation
that names more chips than the list holds becomes the largest (hosts,
chips) grid that fits, down to one device.  On one card every allocation
is therefore ``(1, 1)`` on ``cuda:0``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.mesh import Mesh


def device_list(device=None) -> List[torch.device]:
    """The devices a mesh may take: every card of this process (``device``
    None or a CUDA device; raises where there is no card), or the one CPU
    device when ``device`` is ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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
