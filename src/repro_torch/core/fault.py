"""Fault injection + straggler detection/mitigation.

Failure path: a killed broker stops heartbeating; the TBON's aggregated
heartbeat sweep declares it down after ``hb_miss_limit`` misses; the
instance requeues jobs that touched the host (checkpoint/restart
semantics — the training substrate's ckpt/ module provides the actual
state restore) and marks the host down so the matcher avoids it.

Straggler path: a slow node (boot or heartbeat lag) is detected from
heartbeat latency; mitigation drains it so new work avoids it, and
optionally re-submits its running jobs elsewhere (speculative
re-execution).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.broker import BrokerState
from repro_torch.core.jobspec import JobState
from repro_torch.core.reconciler import FluxMiniCluster
from repro_torch.core.sim import SimClock


def kill_node(clock: SimClock, mc: FluxMiniCluster, rank: int,
              at: float):
    """Schedule an abrupt node failure at sim time ``at``."""
    clock.call_at(at, mc.pool.fail, rank)


def make_straggler(mc: FluxMiniCluster, rank: int, hb_lag: float = 1.0):
    """Give a broker persistent heartbeat lag (slow node)."""
    mc.pool.brokers[rank].hb_latency = hb_lag


@dataclass
class StragglerMitigator:
    """Detect laggy brokers and drain their hosts."""

    clock: SimClock
    mc: FluxMiniCluster
    threshold: float = 0.5
    interval: float = 10.0
    drained: List[int] = None
    speculative: bool = True

    def start(self):
        self.drained = []
        self.clock.call_in(self.interval, self._tick)

    def _tick(self):
        pool = self.mc.pool
        inst = self.mc.instance
        for rank in pool.stragglers(self.threshold):
            b = pool.brokers[rank]
            if b.host is None or b.host in self.drained:
                continue
            inst.drain(b.host)
            self.drained.append(b.host)
            self.clock.trace("straggler_drained", rank=rank, host=b.host)
            if self.speculative:
                # requeue running jobs that include the slow host
                for job in list(inst.queue.running()):
                    if job.allocation and b.host in job.allocation.hosts:
                        inst.graph.free(job.jobid)
                        job.allocation = None
                        job.state = JobState.SCHED
                        job.requeues += 1
                        self.clock.trace("job_respawned", jobid=job.jobid)
                inst.schedule_loop()
        self.clock.call_in(self.interval, self._tick)
