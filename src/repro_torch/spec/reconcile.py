"""Reconcile a WorkloadSpec into an executor-backed job.

``WorkloadReconciler`` is the single submission path behind
``FluxInstance.apply(spec)``:

1. **Validate at submit time.**  Structural validation
   (``spec.validate``) plus cluster-aware checks — capacity against the
   cluster's registered hosts, serve-ability of the arch, and the comm
   policy under ``comm_strict`` probed on the very mesh the allocation
   would produce (``match_pod_local`` peek -> ``submesh_for`` ->
   ``comm.resolve_policy``, the SAME functions the train step calls,
   so validator and runtime cannot disagree).  Bad specs raise
   :class:`repro_torch.spec.workload.SpecError` before anything is queued.
2. **Bind the executor from the spec.**  (kind, elastic) selects the
   executor class; spec knobs configure it; executors are cached per
   configuration so same-shaped workloads share compiled steps/engines.
3. **Dispatch + lifecycle.**  The reconciler installs itself as the
   instance's executor and routes each scheduled job to its handle's
   executor, driving the handle through Pending -> Bound -> Running ->
   (Resizing ->)* Completed/Failed.  Jobs submitted outside ``apply``
   (plain ``JobSpec``s) fall through to whatever executor the instance
   had before — sim workloads keep working.

A copy of the JAX package's ``spec/reconcile.py`` that binds the port's
executors (``core/executor.py``), every one the JAX package binds.
Meshes are laid over the slots of a ``dist.ranks.RankPool``
(``executor_opts["ranks"]``), whose ranks then run each job on its mesh
as the reference's executors run it on theirs; without a pool, over the
devices the executor runs on (``executor_opts["device"]``; the card by
default), so on one card every allocation is then ``(1, 1)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.jobspec import Job, JobSpec, JobState
from repro_torch.spec.handle import (BOUND, COMPLETED, FAILED, RUNNING,
                               WorkloadHandle)
from repro_torch.spec.workload import SpecError, WorkloadSpec, _err


class _DryRunExecutor:
    """Validation-only workload: bind resources, resolve the sharding /
    comm decisions the allocation implies, run no compute.  The record
    in ``ran`` is the point of the job."""

    def __init__(self, clock, net, tbon_fanout: int = 2, strategy=None,
                 device=None, ranks=None):
        self.clock = clock
        self.net = net
        self.k = tbon_fanout
        self.strategy = strategy
        self.device = device
        self.ranks = ranks
        self.ran: Dict[int, Dict] = {}

    def __call__(self, job: Job, rset, done):
        from repro_torch.comm import resolve_policy
        from repro_torch.configs import BASELINE
        from repro_torch.core.executor import tbon_bootstrap_cost
        from repro_torch.dist.sharding import device_list, submesh_for
        mesh = submesh_for(rset, device_list(self.device, self.ranks))
        strategy = self.strategy or BASELINE
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            policy = resolve_policy(strategy, mesh)
        self.ran[job.jobid] = {
            "mesh_shape": tuple(mesh.devices.shape),
            "n_devices": int(mesh.size),
            "hosts": list(rset.hosts),
            "strategy": strategy.name,
            "comm": {"hierarchical": policy.hierarchical,
                     "compress": policy.compress},
        }
        wall = tbon_bootstrap_cost(self.net, rset.n_hosts, self.k)
        self.clock.call_in(wall, done, "completed", wall)


class WorkloadReconciler:
    """Per-instance spec -> executor reconciliation + dispatch."""

    def __init__(self, instance):
        self.instance = instance
        self.handles: Dict[int, WorkloadHandle] = {}
        self._executors: Dict[Tuple, Any] = {}
        # plain JobSpec submissions keep their pre-apply executor
        self._fallback = instance.executor
        instance.executor = self._dispatch

    # -- the ONE submission path -------------------------------------------
    def apply(self, spec: WorkloadSpec, *, cfg=None, strategy=None,
              executor_opts: Optional[Dict[str, Any]] = None
              ) -> WorkloadHandle:
        errors = spec.errors(known_arch=cfg is None)
        if not errors:
            strategy = strategy if strategy is not None \
                else spec.resolved_strategy
            cfg = cfg if cfg is not None else self._registry_cfg(spec)
            opts = executor_opts or {}
            errors = self._cluster_errors(spec, cfg, strategy,
                                          opts.get("device"),
                                          opts.get("ranks"))
        if errors:
            raise SpecError(errors)
        ex = self._executor_for(spec, cfg, strategy,
                                dict(executor_opts or {}))
        # a replicated serve fleet binds ONE allocation covering every
        # replica; the executor slices it into per-replica submeshes
        replicas = spec.serve.replicas if spec.kind == "serve" else 1
        job = self.instance.submit(JobSpec(
            n_nodes=spec.resources.n_nodes * max(replicas, 1),
            walltime=spec.walltime,
            user=spec.user,
            urgency=spec.urgency,
            command=spec.arch,
            attributes={"workload": spec.kind,
                        "pod_local": spec.resources.pod_local,
                        "elastic": spec.resources.elastic,
                        "replicas": max(replicas, 1),
                        "spec_name": spec.name},
            args=self._job_args(spec)))
        handle = WorkloadHandle(spec, job, ex, self.instance.clock)
        self.handles[job.jobid] = handle
        self.instance.clock.trace("workload_applied", jobid=job.jobid,
                                  workload=spec.kind, name=spec.name)
        return handle

    @staticmethod
    def _registry_cfg(spec: WorkloadSpec):
        from repro_torch.configs import registry
        return registry.smoke(spec.arch)

    @staticmethod
    def _job_args(spec: WorkloadSpec) -> Dict[str, Any]:
        if spec.kind != "serve":
            return {}
        s = spec.serve
        return {"max_new": s.max_new, "temperature": s.temperature,
                "n_requests": s.n_requests, "replicas": s.replicas,
                "tenant": s.tenant, "ttft_slo_s": s.ttft_slo_s}

    # -- cluster-aware validation ------------------------------------------
    def _cluster_errors(self, spec, cfg, strategy, device=None, ranks=None):
        errs = []
        inst = self.instance
        r = spec.resources
        if r.elastic and getattr(inst, "minicluster", None) is None:
            errs.append(_err(
                "resources.elastic", "no-minicluster",
                "elastic workloads need a MiniCluster-managed instance "
                "(resize events come from FluxMiniCluster.patch_size)"))
        capacity = self._capacity()
        replicas = spec.serve.replicas if spec.kind == "serve" else 1
        need = r.n_nodes * max(replicas, 1)
        if capacity and need > capacity:
            detail = (f"n_nodes={r.n_nodes}" if replicas <= 1 else
                      f"replicas={replicas} x n_nodes={r.n_nodes} = "
                      f"{need} hosts")
            errs.append(_err(
                "resources.n_nodes", "over-capacity",
                f"{detail} exceeds the cluster's maximum of "
                f"{capacity} hosts — the job could never be scheduled"))
        if spec.kind == "serve":
            if cfg.encoder_layers:
                errs.append(_err(
                    "arch", "not-servable",
                    f"{cfg.name}: the serving engine hosts decoder-only "
                    "architectures (encoder_layers > 0)"))
            elif cfg.pos_type not in ("rope", "none"):
                errs.append(_err(
                    "arch", "not-servable",
                    f"{cfg.name}: per-slot positions need rope (or no) "
                    f"position encoding, not {cfg.pos_type!r}"))
        errs.extend(self._comm_errors(spec, strategy, device, ranks))
        return errs

    def _capacity(self) -> int:
        mc = getattr(self.instance, "minicluster", None)
        if mc is not None:
            return mc.spec.effective_max
        return len(self.instance.graph.hosts)

    def _comm_errors(self, spec, strategy, device=None, ranks=None):
        """Probe the comm policy on the mesh this allocation would get.

        Only ``comm_strict`` strategies can fail here (non-strict ones
        degrade with a warning at step build).  The probe reuses the
        scheduler's own matcher and the train step's own policy
        resolver; when the cluster has no hosts yet (pre-``create``)
        there is no mesh to probe and the check is skipped.
        """
        if not strategy.comm_strict:
            return []
        if not (strategy.hierarchical_collectives
                or strategy.compress_cross_pod):
            return []
        from repro_torch.comm import CommTopologyError, resolve_policy
        from repro_torch.dist.sharding import device_list, submesh_for
        inst = self.instance
        n = spec.resources.n_nodes
        rset = (inst.match_pod_local(n) if spec.resources.pod_local
                else inst.graph.match(n, policy=inst.match_policy))
        if rset is None:
            return []                   # nothing to probe yet
        mesh = submesh_for(rset, device_list(device, ranks))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                resolve_policy(strategy, mesh)
        except CommTopologyError as e:
            return [_err(
                "strategy", "comm-strict",
                f"comm_strict: the {dict(mesh.shape)} mesh this "
                f"allocation resolves to cannot honor the requested "
                f"schedule ({e})")]
        return []

    # -- executor binding ---------------------------------------------------
    def _executor_for(self, spec, cfg, strategy, opts):
        key = (spec.kind, spec.resources.elastic, cfg, strategy,
               dataclasses.astuple(spec.train),
               dataclasses.astuple(spec.serve),
               tuple(sorted(opts.items())))
        ex = self._executors.get(key)
        if ex is not None:
            return ex
        inst = self.instance
        clock, net = inst.clock, inst.net
        mc = getattr(inst, "minicluster", None)
        if spec.kind == "train" and spec.resources.elastic:
            from repro_torch.core.executor import ElasticTrainExecutor
            t = spec.train
            ex = ElasticTrainExecutor(
                clock, net, total_steps=t.total_steps,
                chunk_steps=t.chunk_steps, seq_len=t.seq_len,
                global_batch=t.global_batch, strategy=strategy, cfg=cfg,
                ckpt_root=t.ckpt_dir, **opts).bind(mc)
        elif spec.kind == "train":
            from repro_torch.core.executor import SubmeshExecutor
            opts.setdefault("steps", spec.train.total_steps)
            ex = SubmeshExecutor(clock, net, seq_len=spec.train.seq_len,
                                 strategy=strategy, cfg=cfg, **opts)
        elif (spec.kind == "serve" and spec.resources.elastic
                and spec.serve.replicas > 1):
            from repro_torch.core.executor import ElasticFleetServeExecutor
            s = spec.serve
            ex = ElasticFleetServeExecutor(
                clock, net, replicas=s.replicas,
                nodes_per_replica=spec.resources.n_nodes,
                n_requests=s.n_requests, max_new=s.max_new,
                tenant=s.tenant, ttft_slo_s=s.ttft_slo_s,
                strategy=strategy, engine_config=spec.engine_config(),
                cfg=cfg, **opts).bind(mc)
        elif spec.kind == "serve" and spec.resources.elastic:
            from repro_torch.core.executor import ElasticServeExecutor
            s = spec.serve
            ex = ElasticServeExecutor(
                clock, net, n_requests=s.n_requests, max_new=s.max_new,
                strategy=strategy, engine_config=spec.engine_config(),
                cfg=cfg, **opts).bind(mc)
        elif spec.kind == "serve" and spec.serve.replicas > 1:
            from repro_torch.core.executor import FleetServeExecutor
            s = spec.serve
            ex = FleetServeExecutor(
                clock, net, replicas=s.replicas,
                nodes_per_replica=spec.resources.n_nodes,
                n_requests=s.n_requests, max_new=s.max_new,
                tenant=s.tenant, ttft_slo_s=s.ttft_slo_s,
                strategy=strategy, engine_config=spec.engine_config(),
                cfg=cfg, **opts)
        elif spec.kind == "serve":
            from repro_torch.core.executor import ServeExecutor
            s = spec.serve
            ex = ServeExecutor(
                clock, net, n_requests=s.n_requests, max_new=s.max_new,
                strategy=strategy, engine_config=spec.engine_config(),
                cfg=cfg, **opts)
        else:
            ex = _DryRunExecutor(clock, net, strategy=strategy, **opts)
        if hasattr(ex, "phase_cb"):
            ex.phase_cb = self._phase
        self._executors[key] = ex
        return ex

    # -- dispatch + lifecycle ----------------------------------------------
    def _dispatch(self, job: Job, rset, done):
        handle = self.handles.get(job.jobid)
        if handle is None:
            return self._fallback(job, rset, done)
        handle._transition(BOUND, hosts=list(rset.hosts))
        handle._transition(RUNNING)

        def finish(result: str, walltime: float):
            # same guard as FluxInstance._make_done: a completion
            # callback that fires after the job was requeued (node
            # loss raced it) is stale — the handle must not go
            # terminal, or the re-placement would be an illegal
            # transition out of Completed
            if job.state == JobState.RUN:
                # stamp BEFORE the transition so terminal-phase
                # listeners (pipeline gates) see handle.result()
                handle._stamp_result(result)
                handle._transition(COMPLETED if result == "completed"
                                   else FAILED, result=result)
            done(result, walltime)

        handle.executor(job, rset, finish)

    def _phase(self, jobid: int, phase: str, **detail):
        """Elastic executors report Resizing/Running through here."""
        handle = self.handles.get(jobid)
        if handle is not None and not handle.done:
            handle._transition(phase, **detail)
