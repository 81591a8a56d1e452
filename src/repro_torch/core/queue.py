"""Flux-style job queue: urgency + fair-share priority, FIFO within.

The queue is the broker-local structure whose depth feeds the custom
metrics API (autoscaling) and whose contents move across MiniClusters
on save/restore.  Fair-share mirrors flux-accounting: per-user usage
decays exponentially; priority = urgency + w * fairshare.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.jobspec import Job, JobState


@dataclass
class FairShare:
    halflife: float = 3600.0
    usage: Dict[str, float] = field(default_factory=dict)
    _last_decay: float = 0.0

    def decay(self, now: float):
        dt = now - self._last_decay
        if dt <= 0:
            return
        f = 0.5 ** (dt / self.halflife)
        for u in self.usage:
            self.usage[u] *= f
        self._last_decay = now

    def charge(self, user: str, node_seconds: float):
        self.usage[user] = self.usage.get(user, 0.0) + node_seconds

    def factor(self, user: str) -> float:
        """1.0 for unused accounts, -> 0 as usage grows."""
        total = sum(self.usage.values()) or 1.0
        return 1.0 - self.usage.get(user, 0.0) / total


class JobQueue:
    def __init__(self, fairshare_weight: float = 100.0):
        self.jobs: Dict[int, Job] = {}
        self.fairshare = FairShare()
        self.fs_weight = fairshare_weight

    # -- lifecycle ---------------------------------------------------------
    def submit(self, job: Job, now: float) -> int:
        job.t_submit = now
        self.jobs[job.jobid] = job
        job.transition(JobState.PRIORITY)
        self._prioritize(job, now)
        job.transition(JobState.SCHED)
        return job.jobid

    def _prioritize(self, job: Job, now: float):
        self.fairshare.decay(now)
        job.priority = (job.spec.urgency
                        + self.fs_weight
                        * self.fairshare.factor(job.spec.user))

    def cancel(self, jobid: int) -> bool:
        job = self.jobs.get(jobid)
        if job is None or job.state == JobState.INACTIVE:
            return False
        if job.state == JobState.RUN:
            job.transition(JobState.CLEANUP)
        job.result = "canceled"
        job.transition(JobState.INACTIVE)
        return True

    # -- queries -----------------------------------------------------------
    def schedulable(self) -> List[Job]:
        out = [j for j in self.jobs.values() if j.state == JobState.SCHED]
        out.sort(key=lambda j: (-j.priority, j.t_submit, j.jobid))
        return out

    def running(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.state == JobState.RUN]

    def depth(self) -> int:
        return len(self.schedulable())

    def backlog_node_seconds(self) -> float:
        return sum(j.spec.n_nodes * j.spec.walltime
                   for j in self.schedulable())

    def job(self, jobid: int) -> Optional[Job]:
        return self.jobs.get(jobid)

    def stats(self) -> Dict[str, int]:
        by = {}
        for j in self.jobs.values():
            by[j.state.value] = by.get(j.state.value, 0) + 1
        return by
