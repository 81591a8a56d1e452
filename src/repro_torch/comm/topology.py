"""Communication topology derived from a mesh's axis names: a copy of
the JAX package's ``comm/topology.py``, with ``from_mesh`` reading the
port's ``dist.mesh.Mesh`` (any object whose ``shape`` maps axis names to
sizes).

The Flux resource graph is fully hierarchical (cluster -> pod -> host
-> chip) and ``sharding.submesh_for`` mirrors that hierarchy into mesh
axis names: ``model`` spans the chips of one host (fastest links),
``data`` spans hosts inside one pod (intra-pod ICI), ``pod`` spans
pods (the slow, contended DCN hop — the scarce resource the paper's
contention framing says the topology must schedule around).

``CommTopology.from_mesh`` turns those names into an ordered tier list
with a per-tier bandwidth/latency model, and ``estimate_sync_bytes``
prices a gradient sync against it: how many bytes cross the pod
boundary under the flat (topology-unaware) schedule, the hierarchical
two-phase schedule, and the int8-compressed cross-pod phase.  The
estimates drive the JAX package's ``benchmarks/comm.py`` and the claim
checks in ``BENCH_comm.json``; the port keeps them so both packages
price a sync alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# The reference's pricing model, not measurements of any link the port
# runs on: modeled per-link numbers of a TPU v5e-like pod (ICI) and the
# data-center network between pods (DCN), as in the JAX package.
ICI_BW = 50e9          # bytes/s, intra-pod chip links (data/model tiers)
DCN_BW = 2.5e9         # bytes/s, cross-pod data-center links (pod tier)
ICI_LATENCY = 1e-6     # seconds per hop
DCN_LATENCY = 10e-6

# slow -> fast; axes outside this list are ignored by the comm layer
TIER_ORDER: Tuple[str, ...] = ("pod", "data", "model")

_TIER_LINKS = {
    "pod": (DCN_BW, DCN_LATENCY),
    "data": (ICI_BW, ICI_LATENCY),
    "model": (ICI_BW, ICI_LATENCY),
}


@dataclass(frozen=True)
class CommTier:
    """One level of the collective hierarchy: a mesh axis + link model."""

    axis: str
    size: int
    bandwidth: float       # bytes/s per link
    latency: float         # seconds per hop


@dataclass(frozen=True)
class CommTopology:
    tiers: Tuple[CommTier, ...]        # slow -> fast (pod, data, model)

    @classmethod
    def from_mesh(cls, mesh) -> "CommTopology":
        """Derive tiers from the mesh's axis names; a size-1 axis is
        not a tier (there is nothing to communicate across)."""
        tiers = []
        for axis in TIER_ORDER:
            size = dict(mesh.shape).get(axis, 1)
            if size > 1:
                bw, lat = _TIER_LINKS[axis]
                tiers.append(CommTier(axis, size, bw, lat))
        return cls(tuple(tiers))

    def tier(self, axis: str) -> Optional[CommTier]:
        for t in self.tiers:
            if t.axis == axis:
                return t
        return None

    @property
    def has_pod_tier(self) -> bool:
        return self.tier("pod") is not None

    def tier_size(self, axis: str) -> int:
        t = self.tier(axis)
        return t.size if t is not None else 1

    @property
    def pod_size(self) -> int:
        return self.tier_size("pod")

    @property
    def data_size(self) -> int:
        return self.tier_size("data")


def payload_bytes(n_elems: int, *, compress: bool,
                  block: int = 256) -> float:
    """Wire size of one gradient payload: fp32, or int8 codes plus one
    fp32 scale per quantization block."""
    if not compress:
        return 4.0 * n_elems
    return 1.0 * n_elems + 4.0 * (n_elems / block)


def estimate_sync_bytes(topo: CommTopology, n_elems: int, *,
                        hierarchical: bool, compress: bool = False,
                        block: int = 256) -> Dict[str, float]:
    """Price one gradient sync of ``n_elems`` fp32 elements.

    Ring model.  Flat (topology-unaware) all-reduce runs one ring over
    all P*D data-parallel ranks; nothing orders the ring by pod, so
    every edge is priced as a pod crossing when a pod tier exists —
    the full gradient transits the slow boundary 2*(R-1) times.  The
    hierarchical schedule reduce-scatters inside each pod first, so
    only pod-reduced SHARDS ride the D parallel cross-pod rings:
    2*(P-1) full-gradient equivalents total, 2*(P-1)/P * N/D serially
    per DCN link.  Compression shrinks exactly that cross-pod payload.
    """
    P, D = topo.pod_size, topo.data_size
    R = max(P * D, 1)
    fp32 = 4.0 * n_elems
    out: Dict[str, float] = {"n_elems": float(n_elems), "pod": P, "data": D}
    if P <= 1:
        # no pod boundary: every schedule degenerates to intra-pod
        out.update(cross_pod_bytes=0.0, cross_pod_per_link=0.0,
                   intra_pod_bytes=2.0 * fp32 * (R - 1),
                   est_cross_pod_time_s=0.0)
        return out
    if not hierarchical:
        per_edge = 2.0 * fp32 * (R - 1) / R
        out["cross_pod_bytes"] = per_edge * R        # all R edges cross
        out["cross_pod_per_link"] = per_edge
        out["intra_pod_bytes"] = 0.0
    else:
        wire = payload_bytes(n_elems, compress=compress, block=block)
        shard = wire / D
        out["cross_pod_bytes"] = 2.0 * shard * (P - 1) * D
        out["cross_pod_per_link"] = 2.0 * shard * (P - 1) / P
        # reduce-scatter + all-gather inside each pod, fp32
        out["intra_pod_bytes"] = 2.0 * fp32 * (D - 1) / D * P
    t = topo.tier("pod")
    # bandwidth-model estimate, NOT a measurement (hence the est_ prefix
    # everywhere this number surfaces, BENCH_comm.json included)
    out["est_cross_pod_time_s"] = (out["cross_pod_per_link"] / t.bandwidth
                                   + 2.0 * (P - 1) * t.latency)
    return out


def estimate_a2a_bytes(topo: CommTopology, *, n_tokens: int, d_model: int,
                       n_experts: int, capacity: int, top_k: int,
                       hierarchical: bool,
                       bytes_per_elem: float = 2.0) -> Dict[str, float]:
    """Price one MoE dispatch+combine against the pod tier.

    Both schedules assume experts sharded across the ``pod`` tier
    (``expert -> (pod, model)``, the hierarchical-MoE weight rule — the
    regime where expert weights no longer fit one pod replicated).

    *Flat* is the topology-unaware lowering today's combine produces:
    an all-gather of EVERY expert's capacity slots across all pods
    (each of ``P`` pods receives the other ``P-1`` pods' full
    ``n_experts * capacity`` slot block) — dispatch mirrored, so the
    payload crosses the DCN boundary twice.

    *Hierarchical* routes pod-locally and exchanges cross-pod only the
    tokens whose expert lives in another pod: with experts partitioned
    pod-major and balanced routing, an expected ``(P-1)/P`` of the
    ``n_tokens * top_k`` chosen (token, expert) rows — never the full
    slot grid, and never slots capacity already dropped.
    """
    P = topo.pod_size
    out: Dict[str, float] = {
        "n_tokens": float(n_tokens), "d_model": float(d_model),
        "pod": float(P)}
    row = bytes_per_elem * d_model
    if P <= 1:
        out.update(cross_pod_bytes=0.0, cross_pod_per_link=0.0,
                   est_cross_pod_time_s=0.0)
        return out
    if not hierarchical:
        # all-gather of the full (n_experts * capacity) slot grid to
        # every other pod, for dispatch AND combine
        total = 2.0 * n_experts * capacity * row * (P - 1)
    else:
        # only remote-expert token rows ride DCN (twice: there + back)
        total = 2.0 * n_tokens * top_k * row * (P - 1) / P
    t = topo.tier("pod")
    out["cross_pod_bytes"] = total
    out["cross_pod_per_link"] = total / P
    out["est_cross_pod_time_s"] = (out["cross_pod_per_link"] / t.bandwidth
                                   + 2.0 * (P - 1) * t.latency)
    return out
