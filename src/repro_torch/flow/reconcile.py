"""Reconcile a PipelineSpec into an event-driven DAG of workloads.

``PipelineReconciler`` is the submission path behind
``FluxInstance.apply_pipeline``:

1. **Validate at apply time.**  Structural validation
   (``PipelineSpec.errors``: cycles, unknown refs, unknown triggers,
   gate/promote kind-compatibility) plus the SAME cluster-aware checks
   ``WorkloadReconciler`` runs for a single spec, applied to every
   workload stage — a pipeline whose third stage could never schedule
   fails at apply, not an hour into the run.
2. **Walk the DAG off WorkloadHandle events.**  Stages arm when their
   dependencies are satisfied and fire per their trigger (completion /
   cron / interval on the SimClock — deterministic under test).  Each
   workload run is an ordinary ``instance.apply``; the reconciler
   subscribes to the handle and advances the pipeline on its terminal
   transitions (fan-out/fan-in for free via ``depends_on``).  Failures
   retry up to ``max_retries``, then mark every transitive descendant
   ``Skipped`` — never ``Failed``; only the failing stage itself fails.
3. **Gates and promotion.**  A gate evaluates its upstream's
   ``handle.result()`` (the stable stamped summary); a failed gate
   COMPLETES but skips its descendants and touches nothing else.  A
   promote stage lifts the source train stage's checkpointed params
   and rolls them into the target's LIVE elastic serve fleet replica
   by replica (``ElasticFleetServeExecutor.promote``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

from repro_torch.flow.handle import (COMPLETED, FAILED, PENDING, RUNNING,
                               SKIPPED, PipelineHandle)
from repro_torch.flow.spec import PipelineSpec, StageSpec
from repro_torch.obs import MetricsRegistry
from repro_torch.spec.workload import SpecError

_GATE_OPS = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
}


class PipelineReconciler:
    """Per-instance pipeline reconciliation + DAG walking."""

    def __init__(self, instance):
        self.instance = instance
        self.clock = instance.clock
        self.handles: Dict[int, PipelineHandle] = {}
        self.metrics = MetricsRegistry()
        self._next_pid = 1

    # -- the ONE submission path -------------------------------------------
    def apply(self, pspec: PipelineSpec, *, cfg=None, strategy=None,
              executor_opts: Optional[Dict[str, Any]] = None,
              stage_opts: Optional[Dict[str, Dict[str, Any]]] = None
              ) -> PipelineHandle:
        """Validate, register, and activate a pipeline.

        ``cfg`` / ``strategy`` / ``executor_opts`` apply to every
        workload stage; ``stage_opts`` maps a stage name to per-stage
        overrides (``{"cfg": ..., "strategy": ..., "executor_opts":
        ...}``) — a pipeline usually mixes train and serve stages whose
        simulation knobs differ.
        """
        stage_opts = dict(stage_opts or {})
        known_arch = (cfg is None and not any(
            "cfg" in so for so in stage_opts.values()))
        errors = pspec.errors(known_arch=known_arch)
        if not errors:
            wr = self._workloads()
            for i, s in enumerate(pspec.stages):
                if s.kind != "workload" or s.workload is None:
                    continue
                so = stage_opts.get(s.name, {})
                scfg = so.get("cfg", cfg)
                if scfg is None:
                    scfg = wr._registry_cfg(s.workload)
                strat = so.get("strategy", strategy)
                if strat is None:
                    strat = s.workload.resolved_strategy
                errors.extend(
                    dict(e, field=f"stages[{i}].workload.{e['field']}")
                    for e in wr._cluster_errors(s.workload, scfg, strat))
        if errors:
            raise SpecError(errors)
        pid = self._next_pid
        self._next_pid += 1
        handle = PipelineHandle(pid, pspec, self.clock, self)
        handle._opts = {"cfg": cfg, "strategy": strategy,
                        "executor_opts": executor_opts,
                        "stage_opts": stage_opts}
        self.handles[pid] = handle
        self.clock.trace("pipeline_applied", pid=pid,
                         pipeline=pspec.name,
                         stages=[s.name for s in pspec.stages])
        handle._set_phase(RUNNING)
        self._settle(handle)
        return handle

    def _workloads(self):
        from repro_torch.spec.reconcile import WorkloadReconciler
        inst = self.instance
        if inst._workloads is None:
            inst._workloads = WorkloadReconciler(inst)
        return inst._workloads

    def _stage_overrides(self, handle: PipelineHandle, name: str):
        o = handle._opts
        so = o["stage_opts"].get(name, {})
        ex_opts = so.get("executor_opts", o["executor_opts"])
        return (so.get("cfg", o["cfg"]), so.get("strategy", o["strategy"]),
                dict(ex_opts) if ex_opts else None)

    def _mark(self, handle: PipelineHandle, name: str, phase: str,
              **detail):
        handle._set_stage(name, phase, **detail)
        self.metrics.inc("pipeline_stage_phase_total",
                         pipeline=handle.spec.name, stage=name,
                         phase=phase)
        self.clock.trace("pipeline_stage", pid=handle.pid, stage=name,
                         phase=phase)

    # -- DAG settling --------------------------------------------------------
    def _deps_state(self, handle: PipelineHandle, sspec: StageSpec) -> str:
        """'ready' | 'wait' | 'skip' for a stage's dependency set."""
        for dep in sspec.depends_on:
            dst = handle.stages[dep]
            dspec = handle.spec.stage(dep)
            if dst.phase in (FAILED, SKIPPED):
                return "skip"
            if dst.phase != COMPLETED:
                return "wait"
            if (dspec.kind == "gate" and dst.result is not None
                    and not dst.result.get("passed", False)):
                return "skip"
        return "ready"

    def _settle(self, handle: PipelineHandle):
        """Level-triggered pass: arm newly-ready stages, skip stages
        whose upstream path died, finish the pipeline when every stage
        is terminal.  Called after every stage event."""
        if handle.done:
            return
        for sspec in handle.spec.stages:
            st = handle.stages[sspec.name]
            if st.terminal or st.phase == RUNNING or st.armed:
                continue
            state = self._deps_state(handle, sspec)
            if state == "skip":
                self._skip(handle, sspec.name,
                           reason="upstream failed or skipped")
            elif state == "ready":
                self._arm(handle, sspec)
        self._maybe_finish(handle)

    def _arm(self, handle: PipelineHandle, sspec: StageSpec):
        """Schedule the stage's trigger, dependencies now satisfied."""
        st = handle.stages[sspec.name]
        st.armed = True
        t = sspec.trigger
        handle._event(sspec.name, "armed", trigger=t.on)
        if t.on == "completion":
            self.clock.call_in(0.0, self._fire_stage, handle, sspec.name,
                               "completion")
        elif t.on == "interval":
            self.clock.call_in(t.every, self._timed_fire, handle,
                               sspec.name, "interval")
        elif t.on == "cron":
            now = self.clock.now
            k = max(0, math.ceil((now - t.offset) / t.every))
            at = t.offset + k * t.every
            if at < now:                 # float-edge: never fire in the past
                at += t.every
            self.clock.call_at(at, self._timed_fire, handle, sspec.name,
                               "cron")

    def _timed_fire(self, handle: PipelineHandle, name: str, source: str):
        """One cron/interval occurrence: fire if the guard allows, then
        schedule the next grid point while fires remain.  An occurrence
        suppressed by the guard (a run is still live) is SKIPPED, not
        queued — the next grid point tries again."""
        st = handle.stages[name]
        sspec = handle.spec.stage(name)
        if handle.done or st.phase in (FAILED, SKIPPED):
            return
        self._fire_stage(handle, name, source)
        t = sspec.trigger
        if t.count == 0 or st.fires < t.count:
            self.clock.call_in(t.every, self._timed_fire, handle, name,
                               source)

    # -- firing --------------------------------------------------------------
    def _fire_stage(self, handle: PipelineHandle, name: str,
                    source: str = "manual") -> bool:
        """Submit one run of ``name`` unless guarded.  The guard is the
        double-submit protection pinned by tests: a trigger racing a
        manual ``fire`` at the same sim time submits ONCE — a live run
        or an exhausted fire budget absorbs the second edge."""
        if handle.done:
            return False
        st = handle.stages[name]
        sspec = handle.spec.stage(name)
        if st.phase in (COMPLETED, FAILED, SKIPPED):
            return False
        if st.handle is not None and not st.handle.done:
            handle._event(name, "fire_suppressed", source=source,
                          reason="run still live")
            return False
        t = sspec.trigger
        if t.count and st.fires >= t.count:
            handle._event(name, "fire_suppressed", source=source,
                          reason="fire budget exhausted")
            return False
        if self._deps_state(handle, sspec) != "ready":
            handle._event(name, "fire_suppressed", source=source,
                          reason="dependencies unsatisfied")
            return False
        st.fires += 1
        if sspec.kind == "workload":
            self._run_workload(handle, name, sspec, source)
        elif sspec.kind == "gate":
            self._run_gate(handle, name, sspec, source)
        else:
            self._run_promote(handle, name, sspec, source)
        return True

    # -- workload stages -----------------------------------------------------
    def _run_workload(self, handle: PipelineHandle, name: str,
                      sspec: StageSpec, source: str):
        st = handle.stages[name]
        st.attempts = 1
        self._submit(handle, name, sspec, source)

    def _submit(self, handle: PipelineHandle, name: str,
                sspec: StageSpec, source: str):
        st = handle.stages[name]
        cfg, strategy, ex_opts = self._stage_overrides(handle, name)
        wh = self.instance.apply(sspec.workload, cfg=cfg,
                                 strategy=strategy,
                                 executor_opts=ex_opts)
        st.handle = wh
        st.handles.append(wh)
        self._mark(handle, name, RUNNING, source=source,
                   jobid=wh.job.jobid, attempt=st.attempts)
        wh.subscribe(lambda w, phase, detail, h=handle, n=name:
                     self._on_workload_event(h, n, w, phase, detail))

    def _on_workload_event(self, handle: PipelineHandle, name: str,
                           wh, phase: str, detail: Dict[str, Any]):
        st = handle.stages[name]
        if wh is not st.handle:
            return                      # superseded by a retry
        handle._event(name, "workload_event", workload_phase=phase,
                      jobid=wh.job.jobid)
        if phase == "Completed":
            self._run_done(handle, name, ok=True)
        elif phase == "Failed":
            self._run_done(handle, name, ok=False)

    def _run_done(self, handle: PipelineHandle, name: str, ok: bool):
        st = handle.stages[name]
        sspec = handle.spec.stage(name)
        if ok:
            st.result = st.handle.result()
            t = sspec.trigger
            recurring = (t.on in ("cron", "interval")
                         and (t.count == 0 or t.count > 1))
            if recurring and (t.count == 0 or st.fires < t.count):
                handle._event(name, "run_completed", fires=st.fires)
            else:
                self._mark(handle, name, COMPLETED, fires=st.fires,
                           attempts=st.attempts)
            self._settle(handle)
            return
        if st.attempts <= sspec.max_retries:
            st.attempts += 1
            handle._event(name, "retry", attempt=st.attempts,
                          max_retries=sspec.max_retries)
            self.clock.call_in(0.0, self._submit, handle, name, sspec,
                               "retry")
            return
        self._fail_stage(handle, name,
                         reason=f"workload failed after "
                                f"{st.attempts} attempt(s)")

    def _fail_stage(self, handle: PipelineHandle, name: str, reason: str):
        self._mark(handle, name, FAILED, reason=reason)
        for d in handle.spec.downstream(name):
            self._skip(handle, d, reason=f"upstream {name!r} failed")
        self._settle(handle)

    def _skip(self, handle: PipelineHandle, name: str, reason: str):
        st = handle.stages[name]
        if not st.terminal:
            self._mark(handle, name, SKIPPED, reason=reason)

    # -- gate stages ---------------------------------------------------------
    def _run_gate(self, handle: PipelineHandle, name: str,
                  sspec: StageSpec, source: str):
        st = handle.stages[name]
        st.attempts = 1
        up = handle.stages[sspec.depends_on[0]]
        g = sspec.gate
        val = (up.result or {}).get(g.metric)
        passed = val is not None and _GATE_OPS[g.op](val, g.value)
        st.result = {"passed": passed, "metric": g.metric, "value": val,
                     "op": g.op, "threshold": g.value,
                     "upstream": up.name}
        self._mark(handle, name, RUNNING, source=source)
        self._mark(handle, name, COMPLETED, passed=passed,
                   metric=g.metric, value=val, threshold=g.value)
        self.clock.trace("pipeline_gate", pid=handle.pid, stage=name,
                         passed=passed, metric=g.metric, value=val)
        if not passed:
            # a failed gate COMPLETES (it did its job); descendants are
            # Skipped — never Failed — and running siblings (the serve
            # fleet a promote would have touched) are left alone
            for d in handle.spec.downstream(name):
                self._skip(handle, d,
                           reason=f"gate {name!r} did not pass")
        self._settle(handle)

    # -- promote stages ------------------------------------------------------
    def _run_promote(self, handle: PipelineHandle, name: str,
                     sspec: StageSpec, source: str):
        st = handle.stages[name]
        st.attempts = 1
        p = sspec.promote
        self._mark(handle, name, RUNNING, source=source,
                   from_stage=p.from_stage, target=p.target)
        self._promote_when_live(handle, name, sspec)

    def _promote_when_live(self, handle: PipelineHandle, name: str,
                           sspec: StageSpec):
        """Start the roll once the target fleet is actually serving; a
        target still placing re-checks on the sim clock, a target that
        already died fails the stage."""
        st = handle.stages[name]
        if st.terminal or handle.done:
            return
        p = sspec.promote
        tgt = handle.stages[p.target]
        twh = tgt.handle
        if twh is not None and twh.done:
            return self._fail_stage(
                handle, name,
                reason=f"promote target {p.target!r} is no longer live "
                       f"({twh.phase})")
        if tgt.phase in (FAILED, SKIPPED):
            return self._fail_stage(
                handle, name,
                reason=f"promote target {p.target!r} never started")
        if (twh is None or twh.phase not in ("Running", "Resizing")
                or twh.job.jobid not in getattr(twh.executor,
                                                "sessions", {})):
            handle._event(name, "waiting_for_target", target=p.target)
            self.clock.call_in(5.0, self._promote_when_live, handle,
                               name, sspec)
            return
        params = self._checkpoint_params(handle, name, p.from_stage)
        if params is None:
            return                      # stage already failed
        ex = twh.executor
        if not hasattr(ex, "promote"):
            return self._fail_stage(
                handle, name,
                reason=f"target {p.target!r} executor "
                       f"({type(ex).__name__}) cannot promote — it "
                       "must be an elastic replicated fleet")
        note = p.note or f"{handle.spec.name}/{name}"
        ex.promote(twh.job, params, note=note,
                   on_done=lambda rec, h=handle, n=name:
                   self._promote_done(h, n, rec))
        handle._event(name, "promote_started", target=p.target,
                      note=note)

    def _checkpoint_params(self, handle: PipelineHandle, name: str,
                           from_stage: str):
        """Lift the trained params out of the source stage's elastic
        train session — restored from its latest checkpoint when one
        exists (the promotion contract: what rolls out is what was
        SAVED), falling back to the live final state.  The params come
        back as host tensors (the checkpoint restores onto the host)."""
        from repro_torch.models import params as P
        src = handle.stages[from_stage]
        swh = src.handle
        ses = (getattr(swh.executor, "sessions", {}) or {}).get(
            swh.job.jobid) if swh is not None else None
        state = getattr(ses, "state", None)
        ckpt = getattr(ses, "ckpt", None)
        if (ckpt is not None and state is not None
                and ckpt.latest_step() is not None):
            ckpt.wait()                 # async final save must commit
            # the params alone: the optimizer state stays on disk
            restored, _step = ckpt.restore_latest(
                {"params": state["params"]})
            if restored is not None:
                state = restored
        if state is None or "params" not in state:
            self._fail_stage(
                handle, name,
                reason=f"promote source {from_stage!r} has no trained "
                       "state to lift")
            return None
        return P.tree_map(lambda t: t.detach().to("cpu", copy=True),
                          state["params"])

    def _promote_done(self, handle: PipelineHandle, name: str,
                      rec: Dict[str, Any]):
        st = handle.stages[name]
        if st.terminal or handle.done:
            return
        st.result = dict(rec)
        self._mark(handle, name, COMPLETED,
                   sim_promote_s=rec.get("sim_promote_s"),
                   replicas=rec.get("replicas"),
                   to_version=rec.get("to_version"))
        self._settle(handle)

    # -- pipeline completion -------------------------------------------------
    def _maybe_finish(self, handle: PipelineHandle):
        if handle.done:
            return
        if not all(st.terminal for st in handle.stages.values()):
            return
        fatal = [n for n, st in handle.stages.items()
                 if st.phase == FAILED
                 and handle.spec.stage(n).on_failure == "fail"]
        phase = FAILED if fatal else COMPLETED
        handle._set_phase(phase, failed_stages=fatal)
        self.clock.trace("pipeline_done", pid=handle.pid,
                         pipeline=handle.spec.name, phase=phase)
