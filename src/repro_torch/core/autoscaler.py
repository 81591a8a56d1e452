"""Autoscaling: HPA-style utilization policy vs the Flux metrics API.

The paper's progression: a default HorizontalPodAutoscaler on CPU
utilization is "not fine-tuned enough" for queued HPC work, so a
custom metrics API served FROM THE LEAD BROKER exposes queue-aware
signals and the autoscaler acts on those.  Both are implemented here
against the same patch path (``FluxMiniCluster.patch_size``), mirroring
the paper's note that user-, application- and autoscaler-initiated
scaling all share one validation/patch code path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.reconciler import FluxMiniCluster
from repro_torch.core.sim import SimClock
from repro_torch.obs.metrics import MetricsRegistry


@dataclass
class HPAPolicy:
    """Kubernetes HPA algorithm: desired = ceil(current * util / target)."""

    target_utilization: float = 0.7
    min_size: int = 1
    max_size: int = 64

    def desired(self, mc: FluxMiniCluster) -> int:
        util = mc.instance.graph.utilization()
        cur = max(mc.pool.n_up(), 1)
        want = math.ceil(cur * util / self.target_utilization)
        return max(self.min_size, min(self.max_size, want,
                                      mc.spec.effective_max))


@dataclass
class FluxMetricsPolicy:
    """Custom metrics API: scale from queue contents, not CPU.

    desired = running-node demand + backlog demand, where backlog demand
    converts queued node-seconds into nodes assuming a horizon.
    """

    horizon_s: float = 60.0
    min_size: int = 1
    max_size: int = 64

    def desired(self, mc: FluxMiniCluster) -> int:
        m = mc.instance.metrics()
        running_nodes = sum(
            j.spec.n_nodes for j in mc.instance.queue.running())
        backlog_nodes = math.ceil(
            m["backlog_node_seconds"] / self.horizon_s)
        want = running_nodes + backlog_nodes
        return max(self.min_size,
                   min(self.max_size, want, mc.spec.effective_max))


@dataclass
class FleetDemandPolicy:
    """Scale a serving FLEET from its router's demand signal.

    ``Router.desired_replicas`` converts the demand EWMA (in-flight +
    queued requests) into the replica count that would hold occupancy
    at ``target_occupancy`` of per-replica slots; this policy maps that
    to hosts (``nodes_per_replica`` per engine) so the same Autoscaler
    patch path that resizes MiniClusters resizes fleets.
    """

    router: object = None             # repro_torch.serve.Router (duck-typed)
    nodes_per_replica: int = 1
    target_occupancy: float = 0.75
    min_size: int = 1
    max_size: int = 64

    def desired(self, mc: FluxMiniCluster) -> int:
        reps = self.router.desired_replicas(self.target_occupancy)
        want = reps * self.nodes_per_replica
        return max(self.min_size,
                   min(self.max_size, want, mc.spec.effective_max))


class Autoscaler:
    def __init__(self, clock: SimClock, mc: FluxMiniCluster, policy,
                 interval: float = 15.0, stabilization: float = 60.0,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        self.clock = clock
        self.mc = mc
        self.policy = policy
        self.interval = interval
        self.stabilization = stabilization     # scale-down damping (HPA)
        self._last_scale_down = -1e9
        # scale-down wanted inside the stabilization window: deferred,
        # not dropped — applied when the window expires (HPA semantics:
        # the window picks the HIGHEST recommendation seen inside it)
        self._pending_down: Optional[int] = None
        self.decisions = []
        self._running = False
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer                   # optional obs.trace.Tracer

    def _record(self, decision: str, cur: int, want: int) -> None:
        """Count the decision kind distinctly and (when traced) stamp a
        why-event on the autoscaler timeline at sim time."""
        self.metrics.inc("autoscale_decisions_total", decision=decision)
        if self.tracer is not None:
            self.tracer.event(f"autoscale_{decision}", "autoscaler",
                              t=self.clock.now, current=cur, target=want)

    def start(self):
        if not self._running:
            self._running = True
            self.clock.call_in(self.interval, self._tick)

    def stop(self):
        self._running = False

    def _tick(self):
        if not self._running:
            return
        want = self.policy.desired(self.mc)
        cur = self.mc._desired
        # autoscaler-driven patches flow through the same validation /
        # resize-event path as user patches, tagged with their source so
        # elastic workloads (and the trace) can tell who resized them
        if want > cur:
            self._pending_down = None          # demand is back — cancel
            self.mc.patch_size(want, source="autoscaler")
            self.decisions.append((self.clock.now, cur, want))
            self._record("scale_up", cur, want)
        elif want < cur:
            if self.clock.now - self._last_scale_down >= self.stabilization:
                # the highest recommendation seen inside the window wins
                # (scale down no further than any deferred target asked)
                target = want if self._pending_down is None \
                    else max(want, self._pending_down)
                self._pending_down = None
                self.mc.patch_size(target, source="autoscaler")
                self._last_scale_down = self.clock.now
                self.decisions.append((self.clock.now, cur, target))
                self._record("scale_down", cur, target)
            else:
                # inside the window: defer, don't drop — a sustained
                # drop is applied by the first tick past the window
                self._pending_down = want if self._pending_down is None \
                    else max(self._pending_down, want)
                self.decisions.append(
                    (self.clock.now, cur, want, "deferred"))
                self._record("deferred", cur, want)
        else:
            self._pending_down = None
        self.clock.call_in(self.interval, self._tick)
