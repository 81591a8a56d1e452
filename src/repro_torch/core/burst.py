"""Bursting: extend a MiniCluster's job capacity to EXTERNAL clusters.

Paper §3.5: a plugin service runs on the lead broker; jobs marked
``burstable`` that the local Fluxion matcher cannot place are offered
to plugins.  A plugin that accepts provisions a remote cluster whose
FOLLOWER brokers connect back to the lead (exposed as a NodePort
analogue): the lead's system config pre-registers namespaced hostnames
for the remote ranks, which sit DOWN until the burst comes up — the
same "register more nodes than exist" trick as local elasticity.

Plugins implemented: ``local`` (same fleet, new hosts), and mock cloud
providers (``gke``/``eks``/``ce``) that differ in provisioning latency.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.jobspec import Job, JobState
from repro_torch.core.reconciler import FluxMiniCluster
from repro_torch.core.resource_graph import ResourceGraph
from repro_torch.core.sim import NetModel, SimClock


@dataclass
class BurstPlugin:
    """One provider target. Provisioning latency models the provider."""

    name: str
    provision_s: float            # create remote cluster / node group
    remote_fleet: ResourceGraph   # capacity on the provider side
    max_nodes: int = 64

    def satisfiable(self, job: Job) -> bool:
        return (job.spec.n_nodes <= self.max_nodes
                and len(self.remote_fleet.free_hosts()) >= job.spec.n_nodes)


def make_plugin(name: str, clock_seed: int = 0) -> BurstPlugin:
    lat = {"local": 5.0, "ce": 75.0, "gke": 120.0, "eks": 150.0}
    fleet = ResourceGraph(n_pods=1, hosts_per_pod=64,
                          name=f"burst-{name}")
    return BurstPlugin(name=name, provision_s=lat.get(name, 120.0),
                       remote_fleet=fleet)


class BurstService:
    """Runs from the lead broker; watches for burstable stuck jobs."""

    def __init__(self, clock: SimClock, net: NetModel,
                 mc: FluxMiniCluster, interval: float = 5.0,
                 selector: Optional[Callable[[Job], bool]] = None):
        self.clock = clock
        self.net = net
        self.mc = mc
        self.plugins: List[BurstPlugin] = []
        self.interval = interval
        self.selector = selector or (lambda j: j.spec.burstable)
        self.bursts: List[Dict] = []
        self._running = False

    def load_plugin(self, plugin: BurstPlugin):
        self.plugins.append(plugin)

    def start(self):
        self._running = True
        # schedule-time path: the instance offers unmatched burstable
        # jobs directly; the periodic tick remains as a backstop for
        # plugin capacity that frees up later
        self.mc.instance.burst_hooks.append(self._hook)
        self.clock.call_in(self.interval, self._tick)

    def stop(self):
        self._running = False
        if self._hook in self.mc.instance.burst_hooks:
            self.mc.instance.burst_hooks.remove(self._hook)

    def _hook(self, job: Job) -> bool:
        # schedule_loop only offers jobs its own matcher already failed
        # to place — no need to re-run the graph match
        return self.offer(job, recheck_local=False)

    def offer(self, job: Job, *, recheck_local: bool = True) -> bool:
        """Take ``job`` if a plugin can satisfy it."""
        if not self._running or not self.selector(job):
            return False
        if recheck_local and \
                self.mc.instance.graph.match(job.spec.n_nodes) is not None:
            return False              # local resources exist; not our job
        for plugin in self.plugins:
            if plugin.satisfiable(job):
                self._burst(job, plugin)
                return True
        return False

    def _tick(self):
        if not self._running:
            return
        for job in self.mc.instance.queue.schedulable():
            self.offer(job)
        self.clock.call_in(self.interval, self._tick)

    def _burst(self, job: Job, plugin: BurstPlugin):
        """Provision remote nodes; remote followers join the lead's TBON."""
        rset = plugin.remote_fleet.match(job.spec.n_nodes)
        plugin.remote_fleet.alloc(rset, job.jobid)
        job.state = JobState.RUN      # assigned to the burst
        job.t_run = self.clock.now + plugin.provision_s
        self.clock.trace("burst_start", jobid=job.jobid,
                         plugin=plugin.name)
        rec = {"jobid": job.jobid, "plugin": plugin.name,
               "t_start": self.clock.now, "n_nodes": job.spec.n_nodes}
        self.bursts.append(rec)

        def remote_done():
            job.transition(JobState.CLEANUP)
            job.result = "completed"
            job.t_done = self.clock.now
            plugin.remote_fleet.free(job.jobid)
            job.transition(JobState.INACTIVE)
            rec["t_done"] = self.clock.now
            self.clock.trace("burst_done", jobid=job.jobid,
                             plugin=plugin.name)

        # provision + remote boot + connect back to the lead (NodePort),
        # then the job runs for its walltime
        connect = (self.net.tcp_connect
                   + self.mc.pool.rpc_cost(0))
        self.clock.call_in(plugin.provision_s + connect
                           + job.spec.walltime, remote_done)
