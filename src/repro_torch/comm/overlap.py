"""Event-model schedule: how much cross-pod time hides behind backward.

Real hardware overlaps the bucketed sync by async dispatch — each
bucket's cross-pod collective is issued the moment its gradients are
final, while XLA keeps differentiating the shallower layers.  The CPU
simulator cannot observe that overlap, so this module prices it
explicitly: a deterministic event model over the bucket timeline,
using ``CommTopology``'s bandwidth model for the DCN tier.  A copy of
the JAX package's ``comm/overlap.py`` (pure Python: it prices the same
buckets the same way).

Model assumptions (stamped into ``BENCH_comm.json`` so the numbers
read as estimates, not hardware claims):

* backward compute sweeps layers deep -> shallow at a uniform
  bytes-per-second rate, so bucket ``i`` (reverse-layer order) becomes
  READY at ``backward_s * cum_bytes(0..i) / total_bytes``;
* the cross-pod hop is one serialized DCN channel: bucket ``i``'s
  transfer starts at ``max(ready_i, end_{i-1})`` and runs for the
  bandwidth-model time of its (padded, optionally int8-compressed)
  payload;
* transfer time inside ``[0, backward_s]`` is HIDDEN, anything after
  is EXPOSED on the critical path, and the modeled step time is
  ``max(backward_s, last transfer end)``.

Under this model the unbucketed schedule (one bucket, ready only when
backward completes) exposes its entire cross-pod time, and bucketing
is monotonically no worse: ``end_i <= backward_s + sum(t_0..t_i)`` by
induction, so the bucketed modeled step time never exceeds the
unbucketed one — the claim ``benchmarks/comm.py`` checks.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.comm.bucketing import GradBucket
from repro_torch.comm.topology import CommTopology, estimate_sync_bytes


@dataclasses.dataclass(frozen=True)
class BucketWindow:
    """One bucket's place on the modeled timeline (seconds)."""

    index: int
    n_bytes: int                 # fp32 bytes of the bucket's gradients
    cross_pod_s: float           # bandwidth-model DCN time of its payload
    ready_s: float               # backward finalizes the bucket's grads
    start_s: float               # DCN channel free AND grads ready
    end_s: float
    hidden_s: float              # overlapped with remaining backward
    exposed_s: float             # on the critical path after backward


@dataclasses.dataclass(frozen=True)
class OverlapSchedule:
    backward_s: float
    windows: Tuple[BucketWindow, ...]
    cross_pod_s: float           # serial sum of all DCN transfer time
    hidden_s: float
    exposed_s: float
    step_time_s: float           # modeled: max(backward end, last transfer)

    @property
    def hidden_frac(self) -> float:
        return self.hidden_s / self.cross_pod_s if self.cross_pod_s else 1.0

    @property
    def n_buckets(self) -> int:
        return len(self.windows)


def schedule_overlap(topo: CommTopology, buckets: Sequence[GradBucket], *,
                     backward_s: float, compress: bool = False,
                     block: int = 256) -> OverlapSchedule:
    """Price the bucketed two-phase sync against the backward timeline.

    ``buckets`` in reverse-layer order (``bucketing.partition_buckets``
    output); ``backward_s`` is the modeled wall time of the backward
    pass the transfers hide behind.
    """
    total_bytes = sum(b.n_bytes for b in buckets) or 1
    unit = max(topo.data_size, 1) * block
    windows = []
    cum = 0
    chan_free = 0.0
    for b in buckets:
        cum += b.n_bytes
        ready = backward_s * cum / total_bytes
        est = estimate_sync_bytes(topo, b.padded_elems(unit),
                                  hierarchical=True, compress=compress,
                                  block=block)
        t = est["est_cross_pod_time_s"]
        start = max(ready, chan_free)
        end = start + t
        hidden = max(0.0, min(end, backward_s) - start)
        windows.append(BucketWindow(
            index=b.index, n_bytes=b.n_bytes, cross_pod_s=t,
            ready_s=ready, start_s=start, end_s=end,
            hidden_s=hidden, exposed_s=max(0.0, t - hidden)))
        chan_free = end
    total_t = sum(w.cross_pod_s for w in windows)
    hidden = sum(w.hidden_s for w in windows)
    end = windows[-1].end_s if windows else 0.0
    return OverlapSchedule(
        backward_s=backward_s, windows=tuple(windows),
        cross_pod_s=total_t, hidden_s=hidden, exposed_s=total_t - hidden,
        step_time_s=max(backward_s, end))


def summarize(sched: OverlapSchedule) -> dict:
    """JSON-ready view of a schedule (``BENCH_comm.json`` overlap rows)."""
    return {
        "n_buckets": sched.n_buckets,
        "backward_s": sched.backward_s,
        "est_cross_pod_time_s": sched.cross_pod_s,
        "hidden_s": sched.hidden_s,
        "exposed_s": sched.exposed_s,
        "hidden_frac": sched.hidden_frac,
        "modeled_step_time_s": sched.step_time_s,
        "buckets": [
            {"index": w.index, "bytes": w.n_bytes,
             "ready_s": w.ready_s, "start_s": w.start_s, "end_s": w.end_s,
             "hidden_s": w.hidden_s, "exposed_s": w.exposed_s}
            for w in sched.windows],
    }


def to_metrics(registry, sched: OverlapSchedule, *,
               schedule: str = "bucketed", tracer=None) -> None:
    """Publish a schedule into an ``obs.MetricsRegistry`` (per-bucket
    estimated cross-pod bytes and hidden/exposed time, plus the
    schedule-level hidden fraction) and, when ``tracer`` is given,
    record each bucket's transfer window as a span on the trace
    ``comm-<schedule>`` (the modeled-timeline export the comm bench
    ships next to its BENCH rows)."""
    for w in sched.windows:
        registry.set("comm_bucket_cross_pod_bytes", w.n_bytes,
                     schedule=schedule, bucket=w.index)
        registry.set("comm_bucket_hidden_s", w.hidden_s,
                     schedule=schedule, bucket=w.index)
        registry.set("comm_bucket_exposed_s", w.exposed_s,
                     schedule=schedule, bucket=w.index)
        if tracer is not None:
            tracer.span("bucket_xfer", f"comm-{schedule}",
                        w.start_s, w.end_s, bucket=w.index,
                        n_bytes=w.n_bytes, hidden_s=w.hidden_s,
                        exposed_s=w.exposed_s)
    registry.set("comm_hidden_frac", sched.hidden_frac, schedule=schedule)
    registry.set("comm_modeled_step_time_s", sched.step_time_s,
                 schedule=schedule)
    if tracer is not None:
        tracer.span("backward", f"comm-{schedule}", 0.0, sched.backward_s,
                    modeled=True)
