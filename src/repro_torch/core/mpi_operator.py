"""The MPI Operator baseline (paper §4's comparison system).

Structural differences from the Flux Operator, all from the paper:
  * an EXTRA launcher pod that does no work (the user pays for it);
  * worker coordination over SSH: the launcher performs a per-worker
    handshake SERIALLY (getOrCreateSSHAuthSecret + ssh fan-out),
    vs the TBON's parallel tree connect;
  * one MPIJob == one job — no queue, no elasticity, no state to save;
  * job launch = mpirun from the launcher (per-rank ssh spawn) vs
    ``flux submit`` routed through an always-up broker tree.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.jobspec import Job, JobSpec
from repro_torch.core.resource_graph import ResourceGraph, ResourceSet
from repro_torch.core.sim import NetModel, SimClock


@dataclass
class MPIJobStatus:
    phase: str = "Pending"       # Pending | Running | Succeeded
    t_created: float = 0.0
    t_ready: float = 0.0
    t_launched: float = 0.0
    t_done: float = 0.0


class MPIJob:
    """One MPIJob custom resource: launcher + N workers."""

    def __init__(self, clock: SimClock, net: NetModel,
                 fleet: ResourceGraph, n_workers: int,
                 executor: Optional[Callable] = None):
        self.clock = clock
        self.net = net
        self.fleet = fleet
        self.n_workers = n_workers
        self.executor = executor
        self.status = MPIJobStatus()
        self.workers_up = 0
        self.launcher_up = False
        self._hosts: List[int] = []

    def create(self):
        self.status.t_created = self.clock.now
        # needs n_workers + 1 hosts: the launcher node does no work
        rset = self.fleet.match(self.n_workers + 1)
        if rset is None:
            raise RuntimeError("insufficient hosts for MPIJob + launcher")
        self.fleet.alloc(rset, id(self) % (1 << 30))
        self._hosts = list(rset.hosts)
        # launcher and workers boot in parallel (pods), but coordination
        # is serial ssh from the launcher once everyone is up
        boots = [self.net.boot_time(self.clock.rng)
                 for _ in range(self.n_workers + 1)]
        self.clock.call_in(boots[0], self._launcher_ready)
        for b in boots[1:]:
            self.clock.call_in(b, self._worker_ready)

    def _launcher_ready(self):
        self.launcher_up = True
        self._maybe_ready()

    def _worker_ready(self):
        self.workers_up += 1
        self._maybe_ready()

    def _maybe_ready(self):
        if self.launcher_up and self.workers_up >= self.n_workers \
                and self.status.phase == "Pending":
            self.status.phase = "Running"
            self.status.t_ready = self.clock.now

    def mpirun(self, spec: JobSpec, done: Callable[[float], None]):
        """Serial ssh handshake to every worker, then the app runs.

        ``done`` receives the APP wall time (the LAMMPS-reported number
        in the paper); the handshake is the Fig-5 launcher time and is
        surfaced via ``status.t_launched``."""
        assert self.status.phase == "Running"
        handshake = self.net.ssh_handshake * self.n_workers
        self.status.t_launched = handshake

        def run():
            if self.executor is not None:
                self.executor(spec, self._hosts[1:],
                              lambda wall: self._finish(done, wall))
            else:
                self.clock.call_in(
                    spec.walltime, self._finish, done, spec.walltime)
        self.clock.call_in(handshake, run)

    def _finish(self, done, wall):
        self.status.t_done = self.clock.now
        done(wall)

    def delete(self):
        self.fleet.free(id(self) % (1 << 30))
        self.status.phase = "Succeeded"
