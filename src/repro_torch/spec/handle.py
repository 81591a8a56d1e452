"""WorkloadHandle: the observable lifecycle of one applied spec.

``FluxInstance.apply(spec)`` returns a handle whose phase walks the
unified workload lifecycle::

    Pending -> Bound -> Running -> Resizing -> Completed | Failed
                 ^____________________|
                        (re-placement after resize / fault requeue)

Every transition is recorded with its simulated timestamp; ``status()``
is the point-in-time view, ``events()`` the full history.  The handle
is the one observation surface regardless of which executor the
reconciler bound — train, serve, elastic or dryrun.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

PENDING = "Pending"
BOUND = "Bound"
RUNNING = "Running"
RESIZING = "Resizing"
COMPLETED = "Completed"
FAILED = "Failed"

PHASES = (PENDING, BOUND, RUNNING, RESIZING, COMPLETED, FAILED)

# legal phase edges; re-placement paths loop Resizing/Running back
# through Bound (a fault requeue re-binds, an in-place remesh does not)
_EDGES = {
    PENDING: (BOUND, FAILED),
    BOUND: (RUNNING, RESIZING, FAILED),
    RUNNING: (RESIZING, BOUND, COMPLETED, FAILED),
    RESIZING: (BOUND, RUNNING, RESIZING, COMPLETED, FAILED),
    COMPLETED: (),
    FAILED: (),
}


class WorkloadHandle:
    """What ``apply`` hands back: spec + job + executor + lifecycle."""

    def __init__(self, spec, job, executor, clock):
        self.spec = spec
        self.job = job
        self.executor = executor
        self.clock = clock
        self.phase = PENDING
        self._events: List[Dict[str, Any]] = [
            {"t": clock.now, "phase": PENDING, "jobid": job.jobid}]
        self._listeners: List[Any] = []
        self._result: Optional[Dict[str, Any]] = None

    # -- lifecycle ----------------------------------------------------------
    def subscribe(self, cb) -> None:
        """Register ``cb(handle, phase, detail)`` to fire on every
        recorded event — transitions AND same-phase detail events.  The
        pipeline reconciler walks its DAG off these callbacks."""
        self._listeners.append(cb)

    def _transition(self, phase: str, **detail):
        if phase == self.phase:
            # same-phase event (e.g. progress detail): record, no edge
            self._events.append({"t": self.clock.now, "phase": phase,
                                 **detail})
        else:
            if phase not in _EDGES[self.phase]:
                raise ValueError(
                    f"illegal workload transition {self.phase} -> {phase} "
                    f"(job {self.job.jobid})")
            self.phase = phase
            self._events.append({"t": self.clock.now, "phase": phase,
                                 **detail})
        for cb in list(self._listeners):
            cb(self, phase, detail)

    def result(self) -> Optional[Dict[str, Any]]:
        """Summary dict stamped when the workload reaches a terminal
        phase (None before then) — the stable surface pipeline gates
        evaluate instead of scraping events.  Train workloads report
        ``steps``/``final_loss``, serve workloads request counts,
        dryrun the probed mesh."""
        return dict(self._result) if self._result is not None else None

    def _stamp_result(self, outcome: str) -> None:
        out: Dict[str, Any] = {"outcome": outcome,
                               "kind": self.spec.kind,
                               "jobid": self.job.jobid}
        rec = getattr(self.executor, "ran", {}).get(self.job.jobid)
        if rec is not None:
            if self.spec.kind == "train":
                out["steps"] = rec.get(
                    "steps", getattr(self.executor, "steps", None))
                out["final_loss"] = rec.get("loss")
            elif self.spec.kind == "serve":
                out["n_requests"] = rec.get("n_requests")
                out["n_tokens"] = rec.get("n_tokens")
                out["ttft_mean_s"] = rec.get("ttft_mean_s")
                if "replicas" in rec:
                    out["replicas"] = rec["replicas"]
            elif self.spec.kind == "dryrun":
                out["n_devices"] = rec.get("n_devices")
                out["mesh_shape"] = rec.get("mesh_shape")
        self._result = out

    @property
    def done(self) -> bool:
        return self.phase in (COMPLETED, FAILED)

    # -- observation --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        alloc = self.job.allocation
        return {
            "phase": self.phase,
            "jobid": self.job.jobid,
            "kind": self.spec.kind,
            "job_state": self.job.state.value,
            "result": self.job.result,
            "hosts": list(alloc.hosts) if alloc is not None else None,
            "requeues": self.job.requeues,
            "n_events": len(self._events),
        }

    def events(self) -> List[Dict[str, Any]]:
        return [dict(e) for e in self._events]

    # -- serve convenience --------------------------------------------------
    def submit_request(self, prompt, max_new_tokens: Optional[int] = None,
                       temperature: Optional[float] = None):
        """Submit a generation request to an elastic serve workload
        (admitted mid-flight; parked requests ride out a resize)."""
        if self.spec.kind != "serve":
            raise ValueError("submit_request: not a serve workload")
        submit = getattr(self.executor, "submit_request", None)
        if submit is None:
            raise ValueError("submit_request needs an elastic serve "
                             "workload (resources.elastic=true)")
        s = self.spec.serve
        return submit(
            self.job, prompt,
            max_new=(s.max_new if max_new_tokens is None else
                     max_new_tokens),
            temperature=(s.temperature if temperature is None else
                         temperature))
