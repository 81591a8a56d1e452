"""Fluxion-style hierarchical resource graph + graph matchers.

Resources form a rooted directed graph cluster -> pod -> host -> chip
(the TPU-fleet analogue of Fluxion's cluster -> rack -> node -> socket
-> core).  Jobs are matched to resource subgraphs by graph traversal
(first-fit or best-fit), allocations are exclusive at host granularity
(the paper's 1-pod-per-node rule: a workload manager must see whole
hosts, because resource discovery — hwloc there, device enumeration
here — cannot scope to a slice of a host).

A matched ``ResourceSet`` maps directly onto a JAX device sub-mesh via
its chip ids, which is how scheduled jobs become pjit workloads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Host:
    hid: int
    pod: int
    chips: int
    state: str = "up"            # up | down | draining
    alloc: Optional[int] = None  # jobid holding this host (exclusive)
    hostname: str = ""


@dataclass
class ResourceSet:
    """An exclusive allocation: host ids (and implied chips).

    ``pods`` carries the pod of each host (parallel to ``hosts``) so
    the execution layer can preserve pod locality: ``submesh_for``
    raises a ``(pod, data, model)`` mesh when the allocation spans
    pods instead of flattening the hierarchy away.  Empty for legacy
    call sites that construct allocations by hand.
    """

    hosts: Tuple[int, ...]
    chips_per_host: int
    pods: Tuple[int, ...] = ()

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def n_chips(self) -> int:
        return self.n_hosts * self.chips_per_host

    def chip_ids(self) -> List[int]:
        return [h * self.chips_per_host + c
                for h in self.hosts for c in range(self.chips_per_host)]


class ResourceGraph:
    def __init__(self, n_pods: int, hosts_per_pod: int,
                 chips_per_host: int = 4, name: str = "cluster"):
        self.name = name
        self.n_pods = n_pods
        self.hosts_per_pod = hosts_per_pod
        self.chips_per_host = chips_per_host
        self.hosts: Dict[int, Host] = {}
        self.image_cache: set = set()      # hosts with the app image pulled
        for p in range(n_pods):
            for i in range(hosts_per_pod):
                hid = p * hosts_per_pod + i
                self.hosts[hid] = Host(
                    hid=hid, pod=p, chips=chips_per_host,
                    hostname=f"{name}-{hid}")

    # -- state management (elasticity registers hosts that are DOWN) ------
    def set_state(self, hid: int, state: str):
        self.hosts[hid].state = state

    def up_hosts(self) -> List[Host]:
        return [h for h in self.hosts.values() if h.state == "up"]

    def free_hosts(self) -> List[Host]:
        return [h for h in self.up_hosts() if h.alloc is None]

    # -- matchers ----------------------------------------------------------
    def match(self, n_hosts: int, policy: str = "first_fit",
              same_pod: bool = False) -> Optional[ResourceSet]:
        """Find n free hosts. ``best_fit`` packs the emptiest pods last
        (keeps large contiguous blocks available — Fluxion's locality
        heuristic); ``first_fit`` takes lowest ids."""
        free = self.free_hosts()
        if len(free) < n_hosts:
            return None
        if same_pod:
            by_pod: Dict[int, List[Host]] = {}
            for h in free:
                by_pod.setdefault(h.pod, []).append(h)
            cands = [hs for hs in by_pod.values() if len(hs) >= n_hosts]
            if not cands:
                return None
            if policy == "best_fit":
                cands.sort(key=len)            # tightest pod first
            hosts = sorted(cands[0], key=lambda h: h.hid)[:n_hosts]
        elif policy == "best_fit":
            # prefer filling partially-used pods before opening fresh ones
            by_pod: Dict[int, List[Host]] = {}
            for h in free:
                by_pod.setdefault(h.pod, []).append(h)
            pods = sorted(by_pod, key=lambda p: len(by_pod[p]))
            hosts = []
            for p in pods:
                for h in sorted(by_pod[p], key=lambda h: h.hid):
                    if len(hosts) == n_hosts:
                        break
                    hosts.append(h)
            hosts = hosts[:n_hosts]
        else:
            hosts = sorted(free, key=lambda h: h.hid)[:n_hosts]
        if len(hosts) < n_hosts:
            return None
        # pod-major host order, whatever policy picked the set: the
        # submesh bridge raises a (pod, data, model) mesh only over
        # pod-contiguous allocations (best_fit visits pods by fill)
        hosts.sort(key=lambda h: (h.pod, h.hid))
        return ResourceSet(tuple(h.hid for h in hosts),
                           self.chips_per_host,
                           pods=tuple(h.pod for h in hosts))

    def alloc(self, rset: ResourceSet, jobid: int):
        for hid in rset.hosts:
            h = self.hosts[hid]
            if h.alloc is not None or h.state != "up":
                raise RuntimeError(
                    f"host {hid} not allocatable (job {jobid})")
            h.alloc = jobid

    def free(self, jobid: int):
        for h in self.hosts.values():
            if h.alloc == jobid:
                h.alloc = None

    def allocated_to(self, jobid: int) -> List[int]:
        return [h.hid for h in self.hosts.values() if h.alloc == jobid]

    # -- hierarchical instances (Flux sub-instance = subgraph) -------------
    def subgraph(self, rset: ResourceSet, name: str) -> "ResourceGraph":
        sub = ResourceGraph(0, 0, self.chips_per_host, name=name)
        sub.n_pods = self.n_pods
        sub.hosts_per_pod = self.hosts_per_pod
        for hid in rset.hosts:
            src = self.hosts[hid]
            sub.hosts[hid] = Host(hid=hid, pod=src.pod, chips=src.chips,
                                  hostname=src.hostname)
        return sub

    def utilization(self) -> float:
        up = self.up_hosts()
        if not up:
            return 0.0
        return sum(1 for h in up if h.alloc is not None) / len(up)
