"""Deterministic discrete-event simulator for the control plane.

The Flux Operator's control plane (reconciler, broker bootstrap, TBON
heartbeats, elasticity, bursting) is latency-dominated, not
compute-dominated; on this single-CPU container we reproduce its
*behaviour and scaling shape* with an event loop whose latency model is
calibrated to the paper's measured bands (Section 4: cluster creation
< 60 s with ~5 s jitter; ZeroMQ TCP connect retries with exponential
backoff; MPI-Operator-style serial SSH handshakes).

Everything is seeded — reruns are bit-identical.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())


class SimClock:
    """Priority-queue event loop with a virtual clock (seconds)."""

    def __init__(self, seed: int = 0):
        self.now = 0.0
        self._q: List[_Event] = []
        self._seq = itertools.count()
        self.rng = random.Random(seed)
        self._trace: List[tuple] = []

    def call_at(self, t: float, fn: Callable, *args):
        heapq.heappush(self._q, _Event(max(t, self.now), next(self._seq),
                                       fn, args))

    def call_in(self, dt: float, fn: Callable, *args):
        self.call_at(self.now + max(dt, 0.0), fn, *args)

    def run(self, until: Optional[float] = None,
            stop_when: Optional[Callable[[], bool]] = None) -> float:
        while self._q:
            if stop_when is not None and stop_when():
                break
            ev = heapq.heappop(self._q)
            if until is not None and ev.time > until:
                heapq.heappush(self._q, ev)
                break
            self.now = ev.time
            ev.fn(*ev.args)
        return self.now

    def trace(self, kind: str, **kw):
        self._trace.append((self.now, kind, kw))

    def events(self, kind: Optional[str] = None):
        return [t for t in self._trace if kind is None or t[1] == kind]


@dataclass
class NetModel:
    """Latency/bandwidth constants (calibrated to the paper's bands)."""

    # pod/node lifecycle (EKS-ish)
    node_boot_mean: float = 28.0       # s: pod scheduled -> container ready
    node_boot_jitter: float = 5.0      # the paper's ~5 s variability
    node_teardown_mean: float = 9.0
    image_pull_cold: float = 90.0      # first pull of the Flux+app image
    # control-plane RPC
    rpc_latency: float = 0.002         # ZeroMQ over TCP, same-rack
    tcp_connect: float = 0.05
    zmq_retry_base: float = 0.1        # exponential backoff on dead peer
    zmq_retry_max: float = 6.4
    ssh_handshake: float = 0.35        # MPI Operator per-worker ssh cost
    # Paper Fig 3: LAMMPS wall ~5% slower under the MPI Operator; cause
    # left open there ("suitable for investigation with performance
    # tools").  Modeled as a fixed app-efficiency factor (candidates:
    # mpirun PMI wireup inside MPI_Init, missing NUMA/fabric pinning).
    mpi_app_overhead: float = 0.05
    configmap_propagate: float = 1.0
    # scheduler costs
    sched_cycle: float = 0.01          # per scheduling decision
    broker_submit_cost: float = 2e-4   # lead-broker serial job ingest
    etcd_write: float = 0.015          # fsync-bound object write
    etcd_contention: float = 5e-5      # extra per live object (etcd limit)

    def boot_time(self, rng: random.Random) -> float:
        return max(1.0, rng.gauss(self.node_boot_mean,
                                  self.node_boot_jitter / 2))

    def teardown_time(self, rng: random.Random) -> float:
        return max(0.5, rng.gauss(self.node_teardown_mean, 1.0))
