"""The Flux Operator: reconcile MiniClusterSpec -> running Flux cluster.

Faithful to the paper's design decisions:

* headless-service naming: predictable hostnames registered BEFORE any
  broker boots (the paper's fix over rewriting /etc/hosts);
* ConfigMap bootstrap: system config (ranks 0..maxSize-1 all registered;
  absent ranks are DOWN) + CURVE certificate generated INSIDE the
  operator (the cgo/ZeroMQ improvement — no one-off keygen pod);
* indexed-job semantics: pods created in index order, lowest first and
  in batches; deletion highest-index-first; index 0 (lead broker) is
  created first and deleted last — scaling can never remove it;
* 1 pod : 1 host placement (anti-affinity / hwloc whole-host rule);
* level-triggered reconcile loop driving observed -> desired state.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.broker import BrokerPool, BrokerState
from repro_torch.core.instance import Executor, FluxInstance
from repro_torch.core.minicluster import MiniClusterSpec, MiniClusterStatus
from repro_torch.core.resource_graph import ResourceGraph
from repro_torch.core.sim import NetModel, SimClock

CREATE_BATCH = 8          # indexed-job batched pod creation


@dataclass
class NamingService:
    """Headless-service analogue: rank -> stable hostname, ready at once."""

    cluster: str
    entries: Dict[int, str] = field(default_factory=dict)

    def register(self, max_size: int):
        for r in range(max_size):
            self.entries[r] = f"{self.cluster}-{r}.flux-service"

    def resolve(self, rank: int) -> str:
        return self.entries[rank]


@dataclass
class ConfigMap:
    """System config + curve cert mounted read-only by every pod."""

    system_config: Dict = field(default_factory=dict)
    curve_cert: str = ""

    @staticmethod
    def generate_cert(seed: str) -> str:
        # stands in for zeromq curve keygen compiled into the operator
        return hashlib.sha256(seed.encode()).hexdigest()


class FluxMiniCluster:
    """One reconciled MiniCluster: operator state + the Flux instance."""

    def __init__(self, clock: SimClock, net: NetModel,
                 fleet: ResourceGraph, spec: MiniClusterSpec,
                 executor: Optional[Executor] = None):
        spec.validate()
        self.clock = clock
        self.net = net
        self.fleet = fleet
        self.spec = spec
        self.status = MiniClusterStatus()
        self.naming = NamingService(spec.name)
        self.configmap = ConfigMap()
        self.pool = BrokerPool(clock, net, spec.effective_max,
                               fanout=spec.tbon_fanout)
        # the instance schedules ONLY on this MiniCluster's own pods — a
        # per-cluster resource graph the reconciler keeps in sync
        self.cluster_graph = ResourceGraph(0, 0, fleet.chips_per_host,
                                           name=spec.name)
        self.instance = FluxInstance(clock, net, self.cluster_graph,
                                     self.pool, executor, name=spec.name)
        # elastic workloads applied to this instance subscribe to our
        # resize events through this backref
        self.instance.minicluster = self
        self._desired = 0
        self._assigned: Dict[int, int] = {}      # rank -> host id
        # resize listeners: cb(new_size, source) fires SYNCHRONOUSLY in
        # patch_size, BEFORE any pod is created or torn down — the
        # graceful-elasticity window where a running workload can
        # checkpoint (the elastic train executor subscribes here)
        self.on_resize: List[Callable[[int, str], None]] = []
        self.t_created: Optional[float] = None
        self.t_ready: Optional[float] = None
        self.pool.on_up.append(self._check_ready)
        # self-healing: a heartbeat-declared-dead rank is recreated on a
        # fresh host by the level-triggered reconcile loop
        self.pool.on_lost.append(self._on_rank_lost)

    # -- operator entry points ------------------------------------------------
    def create(self):
        """Apply the CRD: naming svc + configmap, then indexed pods."""
        self.t_created = self.clock.now
        self.naming.register(self.spec.effective_max)
        self.configmap.curve_cert = ConfigMap.generate_cert(self.spec.name)
        self.configmap.system_config = {
            "ranks": list(range(self.spec.effective_max)),
            "hosts": [self.naming.resolve(r)
                      for r in range(self.spec.effective_max)],
        }
        self._desired = self.spec.size
        # configmap propagation precedes the first pod start
        self.clock.call_in(self.net.configmap_propagate, self.reconcile)

    def patch_size(self, new_size: int, source: str = "user"):
        """Elasticity: .spec.size changes (user patch, API, autoscaler —
        all share this one validation/patch path); validate, publish the
        resize event to listeners, then reconcile.

        Listeners fire synchronously BEFORE the etcd write schedules the
        reconcile: pods only start booting / tearing down after the
        event, so a subscribed workload gets a consistent point to
        checkpoint at (graceful shrink) or to start watching for the new
        ranks (grow).
        """
        if new_size < 1:
            raise ValueError("cannot scale below 1 (lead broker)")
        if new_size > self.spec.effective_max:
            raise ValueError(
                f"cannot scale past maxSize={self.spec.effective_max}")
        self.status.phase = "Scaling"
        self._desired = new_size
        self.clock.trace("patch_size", size=new_size, source=source)
        for cb in list(self.on_resize):
            cb(new_size, source)
        self.clock.call_in(self.net.etcd_write, self.reconcile)

    def delete(self, on_deleted: Optional[Callable[[], None]] = None):
        """Tear down all pods, highest index first, lead broker last."""
        self._desired = 0
        ranks = sorted(self._assigned, reverse=True)
        delay = 0.0
        for r in ranks:
            delay += self.net.teardown_time(self.clock.rng) / max(
                len(ranks), 1)
            self.clock.call_in(delay, self._teardown_rank, r)
        def finish():
            self.status.phase = "Deleted"
            if on_deleted:
                on_deleted()
        self.clock.call_in(delay + self.net.teardown_time(self.clock.rng),
                           finish)

    # -- reconcile loop ---------------------------------------------------------
    def reconcile(self):
        """Level-triggered: drive observed pod set toward desired size."""
        current = sorted(self._assigned)
        want = self._desired
        have = len(current)
        placed_all = True
        if have < want:
            # create missing ranks lowest-first in batches
            missing = [r for r in range(want) if r not in self._assigned]
            batch = missing[:CREATE_BATCH]
            for rank in batch:
                host = self._place(rank)
                if host is None:
                    # level-triggered conditions are a SET: dedupe, and
                    # clear again once placement succeeds
                    self._set_condition("Unschedulable")
                    placed_all = False
                    break
                self._assigned[rank] = host
                # image pull is cached ON THE HOST (paper: a throwaway
                # run pre-pulls; autoscaled NEW nodes re-pay it — Fig 4)
                cold = host not in self.fleet.image_cache
                extra = self.net.image_pull_cold if cold else 0.0
                self.fleet.image_cache.add(host)
                self.clock.trace("pod_create", rank=rank, host=host,
                                 cold_pull=cold)
                if extra:
                    self.clock.call_in(
                        extra, self.pool.boot, rank, host)
                else:
                    self.pool.boot(rank, host)
            if len(batch) == CREATE_BATCH and len(missing) > CREATE_BATCH:
                self.clock.call_in(self.net.sched_cycle * 5, self.reconcile)
        elif have > want:
            # delete extras, highest index first; rank 0 never deleted
            extras = [r for r in sorted(self._assigned, reverse=True)
                      if r >= want and r != 0]
            for rank in extras:
                self._teardown_rank(rank)
        if placed_all:
            # desired state is reachable again (placement succeeded, or
            # the spec shrank): level-triggered conditions must clear
            self._clear_condition("Unschedulable")
        self._update_status()

    def _set_condition(self, cond: str):
        if cond not in self.status.conditions:
            self.status.conditions.append(cond)

    def _clear_condition(self, cond: str):
        if cond in self.status.conditions:
            self.status.conditions.remove(cond)

    def _place(self, rank: int) -> Optional[int]:
        """1 pod per host (anti-affinity); hosts come from the fleet."""
        used = set(self._assigned.values())
        for h in self.fleet.free_hosts():
            if h.hid not in used:
                return h.hid
        return None

    def _teardown_rank(self, rank: int):
        if rank not in self._assigned:
            return
        host = self._assigned.pop(rank)
        self.pool.teardown(rank)
        # host leaves the schedulable graph (running jobs are requeued)
        h = self.cluster_graph.hosts.pop(host, None)
        if h is not None and h.alloc is not None:
            for job in list(self.instance.queue.running()):
                if job.allocation and host in job.allocation.hosts:
                    self.cluster_graph.free(job.jobid)
                    job.allocation = None
                    from repro_torch.core.jobspec import JobState
                    job.state = JobState.SCHED
                    job.requeues += 1
            self.clock.call_in(self.net.sched_cycle,
                               self.instance.schedule_loop)
        self.clock.trace("pod_delete", rank=rank, host=host)
        self._update_status()

    def _on_rank_lost(self, rank: int):
        host = self._assigned.pop(rank, None)
        if host is not None:
            self.cluster_graph.hosts.pop(host, None)
            if host in self.fleet.hosts:
                self.fleet.set_state(host, "down")   # cordon bad hardware
        self.pool.brokers[rank].connect_attempts = 0
        self.clock.trace("rank_lost_recreating", rank=rank, host=host)
        self.clock.call_in(self.net.sched_cycle, self.reconcile)

    # -- status -------------------------------------------------------------------
    def _check_ready(self, rank: int):
        # broker is up: its host joins the MiniCluster's schedulable graph
        host = self.pool.brokers[rank].host
        if host is not None and host in self.fleet.hosts \
                and host not in self.cluster_graph.hosts:
            src = self.fleet.hosts[host]
            from repro_torch.core.resource_graph import Host
            self.cluster_graph.hosts[host] = Host(
                hid=host, pod=src.pod, chips=src.chips,
                hostname=self.naming.resolve(rank))
            self.instance.schedule_loop()
        self._update_status()

    def _update_status(self):
        n_up = self.pool.n_up()
        self.status.ready_ranks = n_up
        self.status.size = len(self._assigned)
        if n_up >= self._desired > 0 and self.status.phase != "Ready":
            self.status.phase = "Ready"
            if self.t_ready is None:
                self.t_ready = self.clock.now
                self.clock.trace("minicluster_ready",
                                 dt=self.t_ready - self.t_created)
        elif n_up < self._desired:
            if self.status.phase == "Ready":
                self.status.phase = "Scaling"

    # -- convenience ---------------------------------------------------------------
    def wait_ready(self) -> float:
        self.clock.run(stop_when=lambda: self.status.phase == "Ready")
        return self.t_ready - self.t_created

    def apply(self, spec, **kw):
        """Apply a declarative :class:`repro_torch.spec.WorkloadSpec` to this
        MiniCluster's instance (the CRD-style submission path; elastic
        workloads ride our ``on_resize`` events automatically)."""
        return self.instance.apply(spec, **kw)

    def apply_pipeline(self, pspec, **kw):
        """Apply a declarative PipelineSpec to this MiniCluster's
        instance (the pipeline layer, ``repro_torch.flow``)."""
        return self.instance.apply_pipeline(pspec, **kw)

    def attach_elastic_executor(self, **kwargs):
        """Deprecated shim: ``apply(WorkloadSpec(kind="train",
        resources=ResourceSpec(elastic=True)))`` — kept only so old
        callers keep working, with a DeprecationWarning."""
        return self.instance.attach_elastic_executor(minicluster=self,
                                                     **kwargs)
