"""Canonical jobspec + job lifecycle states (flux-core RFC 14/21 analogue)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional


class JobState(Enum):
    DEPEND = "DEPEND"
    PRIORITY = "PRIORITY"
    SCHED = "SCHED"
    RUN = "RUN"
    CLEANUP = "CLEANUP"
    INACTIVE = "INACTIVE"


TERMINAL = (JobState.INACTIVE,)

# legal transitions (flux job lifecycle)
_TRANSITIONS = {
    JobState.DEPEND: (JobState.PRIORITY, JobState.INACTIVE),
    JobState.PRIORITY: (JobState.SCHED, JobState.INACTIVE),
    JobState.SCHED: (JobState.RUN, JobState.INACTIVE),
    JobState.RUN: (JobState.CLEANUP, JobState.INACTIVE),
    JobState.CLEANUP: (JobState.INACTIVE,),
    JobState.INACTIVE: (),
}

_ids = itertools.count(1)


@dataclass
class JobSpec:
    """Resource request + task description."""

    n_nodes: int = 1
    tasks_per_node: int = 1
    walltime: float = 60.0              # requested seconds of work
    user: str = "flux"
    urgency: int = 16                   # 0..31, flux default 16
    attributes: Dict[str, Any] = field(default_factory=dict)
    # the payload: a named workload (arch id or callable key) + args
    command: str = "sleep"
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def burstable(self) -> bool:
        return bool(self.attributes.get("burstable", False))


@dataclass
class Job:
    spec: JobSpec
    jobid: int = field(default_factory=lambda: next(_ids))
    state: JobState = JobState.DEPEND
    priority: float = 0.0
    t_submit: float = 0.0
    t_sched: Optional[float] = None
    t_run: Optional[float] = None
    t_done: Optional[float] = None
    result: Optional[str] = None        # completed | failed | canceled | lost
    allocation: Optional[Any] = None    # ResourceSet when RUN
    requeues: int = 0

    def transition(self, new: JobState):
        if new not in _TRANSITIONS[self.state]:
            raise ValueError(
                f"illegal job transition {self.state} -> {new} "
                f"(job {self.jobid})")
        self.state = new

    def to_dict(self) -> Dict:
        return {
            "jobid": self.jobid,
            "state": self.state.value,
            "spec": {
                "n_nodes": self.spec.n_nodes,
                "tasks_per_node": self.spec.tasks_per_node,
                "walltime": self.spec.walltime,
                "user": self.spec.user,
                "urgency": self.spec.urgency,
                "attributes": dict(self.spec.attributes),
                "command": self.spec.command,
                "args": dict(self.spec.args),
            },
            "t_submit": self.t_submit,
            "result": self.result,
            "requeues": self.requeues,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Job":
        spec = JobSpec(**d["spec"])
        job = cls(spec=spec)
        job.jobid = d["jobid"]            # identity survives save/restore
        job.state = JobState(d["state"])
        job.t_submit = d["t_submit"]
        job.result = d.get("result")
        job.requeues = d.get("requeues", 0)
        return job


def reset_job_ids(start: int = 1):
    global _ids
    _ids = itertools.count(start)
