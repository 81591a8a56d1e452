"""PipelineHandle: the observable lifecycle of one applied pipeline.

``FluxInstance.apply_pipeline(pspec)`` returns a handle whose per-stage
states walk::

    Pending -> Running -> Completed | Failed | Skipped

and whose pipeline phase aggregates them (``Completed`` when every
stage is terminal and nothing failed fatally, ``Failed`` when a stage
with ``on_failure="fail"`` exhausted its retries).  Every stage event
is recorded with its simulated timestamp — ``obs.spans_from_pipeline``
lifts the history onto ``pipe-<id>`` trace timelines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PENDING = "Pending"
RUNNING = "Running"
COMPLETED = "Completed"
FAILED = "Failed"
SKIPPED = "Skipped"

STAGE_PHASES = (PENDING, RUNNING, COMPLETED, FAILED, SKIPPED)
TERMINAL = (COMPLETED, FAILED, SKIPPED)


@dataclass
class StageState:
    """Live state of one DAG node."""

    name: str
    kind: str
    phase: str = PENDING
    armed: bool = False           # trigger scheduled (deps satisfied)
    fires: int = 0                # trigger-initiated submissions
    attempts: int = 0             # submissions for the current fire
    handle: Any = None            # WorkloadHandle of the LAST run
    handles: List[Any] = field(default_factory=list)   # every run
    result: Optional[Dict[str, Any]] = None
    t_started: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def terminal(self) -> bool:
        return self.phase in TERMINAL


class PipelineHandle:
    """What ``apply_pipeline`` hands back: spec + stage states +
    pipeline lifecycle.  ``fire(stage)`` is the manual trigger (same
    double-submit guard as timed triggers)."""

    def __init__(self, pid: int, spec, clock, reconciler):
        self.pid = pid
        self.spec = spec
        self.clock = clock
        self._reconciler = reconciler
        self.phase = PENDING
        self.stages: Dict[str, StageState] = {
            s.name: StageState(name=s.name, kind=s.kind)
            for s in spec.stages}
        self._events: List[Dict[str, Any]] = [
            {"t": clock.now, "phase": PENDING, "pid": pid,
             "pipeline": spec.name}]

    # -- recording (reconciler-facing) --------------------------------------
    def _event(self, stage: Optional[str], phase: str, **detail):
        self._events.append({"t": self.clock.now, "stage": stage,
                             "phase": phase, **detail})

    def _set_stage(self, name: str, phase: str, **detail):
        st = self.stages[name]
        if st.terminal and phase != st.phase:
            raise ValueError(
                f"pipeline {self.spec.name!r}: illegal stage transition "
                f"{st.phase} -> {phase} ({name!r})")
        if st.phase == PENDING and phase == RUNNING:
            st.t_started = self.clock.now
        if phase in TERMINAL and st.t_done is None:
            st.t_done = self.clock.now
        st.phase = phase
        self._event(name, phase, **detail)

    def _set_phase(self, phase: str, **detail):
        if self.phase != phase:
            self.phase = phase
            self._event(None, phase, **detail)

    # -- control ------------------------------------------------------------
    def fire(self, stage: str) -> bool:
        """Manually trigger ``stage`` now.  Returns True when a run was
        actually submitted (False: guarded — already live, out of
        fires, dependencies unsatisfied, or terminal)."""
        return self._reconciler._fire_stage(self, stage, source="manual")

    # -- observation --------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.phase in (COMPLETED, FAILED)

    def stage(self, name: str) -> StageState:
        return self.stages[name]

    def status(self) -> Dict[str, Any]:
        return {
            "pid": self.pid,
            "pipeline": self.spec.name,
            "phase": self.phase,
            "stages": {
                n: {"phase": st.phase, "kind": st.kind,
                    "fires": st.fires, "attempts": st.attempts,
                    "result": (dict(st.result)
                               if st.result is not None else None)}
                for n, st in self.stages.items()},
            "n_events": len(self._events),
        }

    def events(self) -> List[Dict[str, Any]]:
        return [dict(e) for e in self._events]
