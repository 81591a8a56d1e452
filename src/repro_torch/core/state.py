"""Queue state save/restore across MiniClusters (paper §3.1).

Faithful semantics (``exactly_once=False``): the queue is paused, jobs
are archived to a shared volume, and the new cluster restores them —
but jobs that were RUNNING when the queue stopped are lost with some
probability (the paper observed 1-2 lost of ~10, "roughly 9 out of 10
transition nicely").  Job IDs survive the move; restored jobs that no
longer fit the (possibly smaller) new cluster stay queued.

``exactly_once=True`` is the beyond-paper improvement: running jobs are
checkpointed into the archive at pause time and requeue deterministically
on the new cluster — nothing is lost.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.jobspec import Job, JobState
from repro_torch.core.reconciler import FluxMiniCluster
from repro_torch.core.sim import SimClock

LOSS_PROB = 0.15            # per in-flight job, matches ~1-2 of 10


@dataclass
class Archive:
    """The shared-volume archive two MiniClusters exchange."""

    payload: str = ""

    def dump(self, jobs: List[Dict]):
        self.payload = json.dumps({"jobs": jobs})

    def load(self) -> List[Dict]:
        return json.loads(self.payload)["jobs"] if self.payload else []


def save_state(clock: SimClock, mc: FluxMiniCluster, archive: Archive,
               *, exactly_once: bool = False) -> Dict:
    """Pause the queue and archive it. Returns transfer stats."""
    inst = mc.instance
    inst.pause()
    jobs_out, lost = [], 0
    for job in inst.queue.jobs.values():
        if job.state == JobState.INACTIVE:
            continue
        d = job.to_dict()
        if job.state == JobState.RUN:
            if exactly_once:
                d["state"] = JobState.SCHED.value   # checkpointed; requeue
                d["requeues"] = job.requeues + 1
            else:
                # at-most-once: in-flight jobs may be lost in transfer
                if clock.rng.random() < LOSS_PROB:
                    lost += 1
                    job.result = "lost"
                    continue
                d["state"] = JobState.SCHED.value
                d["requeues"] = job.requeues + 1
        jobs_out.append(d)
    archive.dump(jobs_out)
    clock.trace("state_saved", n=len(jobs_out), lost=lost)
    return {"archived": len(jobs_out), "lost": lost}


def restore_state(clock: SimClock, mc: FluxMiniCluster,
                  archive: Archive) -> Dict:
    """Load archived jobs into a (differently-sized) MiniCluster.

    Job IDs are preserved.  Jobs wider than the new cluster remain
    queued (unschedulable until it grows) — matching the paper's note.
    """
    inst = mc.instance
    restored, too_wide = 0, 0
    for d in archive.load():
        job = Job.from_dict(d)
        job.state = JobState.SCHED
        inst.queue.jobs[job.jobid] = job
        restored += 1
        if job.spec.n_nodes > mc.spec.effective_max:
            too_wide += 1
    clock.trace("state_restored", n=restored)
    inst.resume()
    return {"restored": restored, "unschedulable": too_wide}
