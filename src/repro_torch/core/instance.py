"""A Flux instance: brokers + scheduler + queue on a resource graph.
A copy of the JAX package's ``core/instance.py`` whose ``apply`` binds
the port's executors and whose ``apply_pipeline`` runs the port's
pipeline layer (``repro_torch.flow``).

The lead broker (rank 0) owns the queue and the Fluxion matcher; jobs
submitted through the instance go DEPEND->PRIORITY->SCHED->RUN->
CLEANUP->INACTIVE.  Job execution is delegated to an executor callback
(real steps on a sub-mesh, or modeled walltime), so orchestration
benchmarks and end-to-end examples share this code.

Instances are hierarchical: ``spawn_subinstance`` carves a subgraph and
returns a child instance that schedules within it (Flux's defining
feature; the operator maps it onto pod-slice sub-meshes).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.broker import BrokerPool, BrokerState
from repro_torch.core.jobspec import Job, JobSpec, JobState
from repro_torch.core.queue import JobQueue
from repro_torch.core.resource_graph import ResourceGraph, ResourceSet
from repro_torch.core.sim import NetModel, SimClock

# executor: (job, rset, done_cb(result, actual_walltime)) -> None
Executor = Callable[[Job, ResourceSet, Callable[[str, float], None]], None]
# burst hook: (job) -> True if an external plugin took the job
BurstHook = Callable[[Job], bool]


class FluxInstance:
    def __init__(self, clock: SimClock, net: NetModel,
                 graph: ResourceGraph, pool: BrokerPool,
                 executor: Optional[Executor] = None,
                 match_policy: str = "first_fit", name: str = "flux0"):
        self.clock = clock
        self.net = net
        self.graph = graph
        self.pool = pool
        self.queue = JobQueue()
        self.executor = executor or self._sim_executor
        self.match_policy = match_policy
        self.name = name
        self.children: List["FluxInstance"] = []
        # bursting plugins (BurstService) register here; unmatched
        # burstable jobs are offered at schedule time
        self.burst_hooks: List[BurstHook] = []
        pool.on_lost.append(self._on_node_lost)
        self._paused = False
        self._ingest_busy_until = 0.0
        # set by FluxMiniCluster when this instance is operator-managed
        # (elastic workloads subscribe to its resize events)
        self.minicluster = None
        # declarative submission path (repro_torch.spec); created on first
        # apply() and installed as the executor dispatch
        self._workloads = None
        # pipeline layer (repro_torch.flow); created on first apply_pipeline()
        self._pipelines = None
        # anti-starvation: once the top-priority unmatched job has
        # waited this long (sim seconds), stop backfilling smaller jobs
        # past it and let the cluster drain toward it
        self.starvation_window = 300.0

    # -- submission (flux submit) -------------------------------------------
    def submit(self, spec: JobSpec, rank: int = 0) -> Job:
        """Submit from ``rank``; the RPC routes up the TBON to the lead,
        which ingests submissions serially (its throughput bound)."""
        job = Job(spec=spec)
        arrival = self.clock.now + self.pool.rpc_cost(rank)
        start = max(arrival, self._ingest_busy_until)
        self._ingest_busy_until = start + self.net.broker_submit_cost
        self.clock.call_at(self._ingest_busy_until, self._enqueue, job)
        return job

    def _enqueue(self, job: Job):
        self.queue.submit(job, self.clock.now)
        self.clock.trace("job_submitted", jobid=job.jobid)
        self.clock.call_in(self.net.sched_cycle, self.schedule_loop)

    # -- scheduling (Fluxion) -----------------------------------------------
    def match_pod_local(self, n_nodes: int) -> Optional[ResourceSet]:
        """Pod-locality first (Fluxion's hierarchy heuristic, applied):
        a job that FITS inside one pod should never be scattered across
        the slow cross-pod links just because lower host ids were free
        elsewhere — cross-pod bandwidth is the contended resource.
        Falls back to a cross-pod placement only when no single pod can
        hold the job."""
        rset = self.graph.match(n_nodes, policy=self.match_policy,
                                same_pod=True)
        if rset is None:
            rset = self.graph.match(n_nodes, policy=self.match_policy)
        return rset

    def schedule_loop(self):
        if self._paused:
            return
        reserving = False
        for job in self.queue.schedulable():
            if reserving:
                # a starved high-priority job holds a reservation: stop
                # backfilling smaller jobs past it (they would keep the
                # cluster fragmented forever under continuous arrivals);
                # burstable jobs may still leave through a plugin
                if job.spec.burstable:
                    for hook in self.burst_hooks:
                        if hook(job):
                            break
                continue
            # pod-locality is a per-workload property (spec-driven);
            # default True: cross-pod links are the contended resource
            if job.spec.attributes.get("pod_local", True):
                rset = self.match_pod_local(job.spec.n_nodes)
            else:
                rset = self.graph.match(job.spec.n_nodes,
                                        policy=self.match_policy)
            if rset is None:
                if job.spec.burstable:
                    # offer to the bursting plugins; first taker wins
                    for hook in self.burst_hooks:
                        if hook(job):
                            break
                elif (self.clock.now - job.t_submit
                        >= self.starvation_window):
                    reserving = True
                continue
            self.graph.alloc(rset, job.jobid)
            job.allocation = rset
            job.t_sched = self.clock.now
            job.transition(JobState.RUN)
            job.t_run = self.clock.now
            self.clock.trace("job_run", jobid=job.jobid,
                             hosts=list(rset.hosts))
            self.executor(job, rset, self._make_done(job))

    def _make_done(self, job: Job):
        def done(result: str, walltime: float):
            if job.state != JobState.RUN:
                return                  # canceled/lost meanwhile
            job.transition(JobState.CLEANUP)
            job.result = result
            job.t_done = self.clock.now
            self.graph.free(job.jobid)
            self.queue.fairshare.charge(
                job.spec.user, job.spec.n_nodes * walltime)
            job.transition(JobState.INACTIVE)
            self.clock.trace("job_done", jobid=job.jobid, result=result)
            self.clock.call_in(self.net.sched_cycle, self.schedule_loop)
        return done

    def _sim_executor(self, job: Job, rset: ResourceSet, done):
        self.clock.call_in(job.spec.walltime, done, "completed",
                           job.spec.walltime)

    # -- fault handling -------------------------------------------------------
    def _on_node_lost(self, rank: int):
        """Heartbeat-declared node death: requeue jobs touching the host."""
        b = self.pool.brokers[rank]
        host = b.host
        for job in list(self.queue.running()):
            if job.allocation and host in job.allocation.hosts:
                self.graph.free(job.jobid)
                job.allocation = None
                job.state = JobState.SCHED      # requeue (restart from ckpt)
                job.requeues += 1
                self.clock.trace("job_requeued", jobid=job.jobid,
                                 lost_rank=rank)
        if host is not None:
            self.graph.set_state(host, "down")
        self.clock.call_in(self.net.sched_cycle, self.schedule_loop)

    # -- queue control (save/restore support) ---------------------------------
    def pause(self):
        self._paused = True

    def resume(self):
        self._paused = False
        self.clock.call_in(self.net.sched_cycle, self.schedule_loop)

    def drain(self, host: int):
        self.graph.set_state(host, "draining")

    # -- declarative submission (the ONE path) ---------------------------------
    def apply(self, spec, *, cfg=None, strategy=None, executor_opts=None):
        """Reconcile a declarative :class:`repro_torch.spec.WorkloadSpec` into
        a scheduled, executor-backed job and return its
        :class:`repro_torch.spec.WorkloadHandle`.

        This is the single submission path for real workloads: the spec
        is validated at apply time (structured :class:`SpecError`, never
        a first-step crash), resources are matched pod-locally when
        ``spec.resources.pod_local``, the executor is bound from
        ``(kind, elastic)``, and the handle observes the unified
        lifecycle ``Pending -> Bound -> Running -> Resizing ->
        Completed/Failed``.

        ``cfg`` / ``strategy`` override the registry/name lookup with
        in-memory objects (tests, benches); ``executor_opts`` forwards
        simulation knobs (``sim_step_time``, ``ticks_per_chunk``, ...)
        to the bound executor.
        """
        from repro_torch.spec.reconcile import WorkloadReconciler
        if self._workloads is None:
            self._workloads = WorkloadReconciler(self)
        return self._workloads.apply(spec, cfg=cfg, strategy=strategy,
                                     executor_opts=executor_opts)

    def apply_pipeline(self, pspec, *, cfg=None, strategy=None,
                       executor_opts=None, stage_opts=None):
        """Reconcile a declarative :class:`repro_torch.flow.PipelineSpec` —
        a DAG of WorkloadSpecs with triggers, gates and canary
        promotion — and return its
        :class:`repro_torch.flow.PipelineHandle`.  Validation (cycles,
        unknown refs, per-stage cluster checks) happens HERE, in the
        SpecError style; the DAG then walks event-driven off each
        stage's WorkloadHandle transitions.  ``stage_opts`` maps stage
        names to per-stage ``cfg``/``strategy``/``executor_opts``
        overrides."""
        from repro_torch.flow.reconcile import PipelineReconciler
        if getattr(self, "_pipelines", None) is None:
            self._pipelines = PipelineReconciler(self)
        return self._pipelines.apply(pspec, cfg=cfg, strategy=strategy,
                                     executor_opts=executor_opts,
                                     stage_opts=stage_opts)

    # -- deprecated imperative executor attachment ------------------------------
    def _deprecated(self, name: str):
        warnings.warn(
            f"FluxInstance.{name}() is deprecated: submit workloads "
            "declaratively through FluxInstance.apply(WorkloadSpec) "
            "instead (the executor is bound from the spec)",
            DeprecationWarning, stacklevel=3)

    def _set_executor(self, ex):
        """Install an imperative executor without clobbering the spec
        dispatch: applied workloads keep their bound executors, plain
        JobSpec submissions route to ``ex``."""
        if self._workloads is not None:
            self._workloads._fallback = ex
        else:
            self.executor = ex

    def attach_submesh_executor(self, **kwargs) -> "FluxInstance":
        """Deprecated shim: ``apply(WorkloadSpec(kind="train"))``."""
        self._deprecated("attach_submesh_executor")
        from repro_torch.core.executor import SubmeshExecutor
        self._set_executor(SubmeshExecutor(self.clock, self.net, **kwargs))
        return self

    def attach_serve_executor(self, **kwargs) -> "FluxInstance":
        """Deprecated shim: ``apply(WorkloadSpec(kind="serve"))``."""
        self._deprecated("attach_serve_executor")
        from repro_torch.core.executor import ServeExecutor
        self._set_executor(ServeExecutor(self.clock, self.net, **kwargs))
        return self

    def attach_elastic_executor(self, minicluster=None, **kwargs):
        """Deprecated shim: ``apply(WorkloadSpec(kind="train",
        resources=ResourceSpec(elastic=True)))``."""
        self._deprecated("attach_elastic_executor")
        from repro_torch.core.executor import ElasticTrainExecutor
        ex = ElasticTrainExecutor(self.clock, self.net, **kwargs)
        if minicluster is not None:
            ex.bind(minicluster)
        self._set_executor(ex)
        return ex

    # -- hierarchy -------------------------------------------------------------
    def spawn_subinstance(self, rset: ResourceSet,
                          executor: Optional[Executor] = None
                          ) -> "FluxInstance":
        sub_graph = self.graph.subgraph(rset, f"{self.name}.sub")
        sub_pool = BrokerPool(self.clock, self.net, rset.n_hosts,
                              fanout=self.pool.tbon.k)
        child = FluxInstance(self.clock, self.net, sub_graph, sub_pool,
                             executor or self.executor,
                             self.match_policy, name=f"{self.name}.sub")
        self.children.append(child)
        return child

    # -- metrics (the Flux metrics API surface) ---------------------------------
    def metrics(self) -> Dict:
        return {
            "queue_depth": self.queue.depth(),
            "backlog_node_seconds": self.queue.backlog_node_seconds(),
            "n_up": self.pool.n_up(),
            "utilization": self.graph.utilization(),
            "running": len(self.queue.running()),
        }
