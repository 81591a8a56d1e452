"""Span-based tracing with an injectable clock.

One :class:`Tracer` collects *spans* (named intervals on a trace) and
*instant events* (named points), all stamped by one :class:`Clock` the
caller injects — ``WallClock`` for real runs.  A *trace*
is just a string id grouping related spans: one request's lifecycle is
the trace ``req-<rid>``, one workload's is ``wl-<jobid>``, one resize's
is ``resize-<jobid>``.

The serving tier is instrumented at the *stamp* level: engines record a
request's phase boundaries (``t_created``/``t_submit``/``t_admit``/
``t_prefill_done``/``t_first``/``t_done``) through their clock and
:meth:`Tracer.record_request` turns those stamps into the five request
spans at finish time — so a disabled tracer (the default: ``tracer is
None``) costs the hot path nothing beyond attribute stamps it already
made.

Clock-injection rule (the ROADMAP "Observability contract"): every
component that stamps timing takes a ``Clock`` and calls
``clock.now()``; nothing below the launch/bench layer calls
``time.perf_counter()`` directly.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


class Clock:
    """Injectable time source; ``now()`` returns seconds (or ticks —
    the unit is the caller's convention, spans just inherit it)."""

    def now(self) -> float:
        raise NotImplementedError


class WallClock(Clock):
    """Real time (``time.perf_counter``) — the default everywhere."""

    def now(self) -> float:
        return time.perf_counter()


WALL = WallClock()


@dataclass
class Span:
    """One named interval on a trace; ``t_end is None`` while open."""

    name: str
    trace: str
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> Optional[float]:
        return None if self.t_end is None else self.t_end - self.t_start


# the spans whose durations telescope to ttft_e2e (t_created..t_first)
TTFT_SPANS = ("router_hold", "queue_wait", "prefill", "first_decode")
REQUEST_SPANS = TTFT_SPANS + ("decode",)


class Tracer:
    """Collects spans + instant events stamped by one clock.

    ``begin``/``end`` bracket live work; ``span`` records an interval
    whose endpoints the caller already has (the request/stamp path);
    ``event`` records an instant (the *why* events: fairness skip,
    no-admissible-engine wait, autoscaler "deferred").
    """

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock if clock is not None else WALL
        self.spans: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self._open: List[Span] = []

    # -- recording ----------------------------------------------------------
    def begin(self, name: str, trace: str, t: Optional[float] = None,
              **attrs) -> Span:
        sp = Span(name=name, trace=trace,
                  t_start=self.clock.now() if t is None else t,
                  attrs=dict(attrs))
        self._open.append(sp)
        return sp

    def end(self, span: Span, t: Optional[float] = None, **attrs) -> Span:
        span.t_end = self.clock.now() if t is None else t
        span.attrs.update(attrs)
        if span in self._open:
            self._open.remove(span)
        self.spans.append(span)
        return span

    def span(self, name: str, trace: str, t_start: float, t_end: float,
             **attrs) -> Span:
        sp = Span(name=name, trace=trace, t_start=t_start, t_end=t_end,
                  attrs=dict(attrs))
        self.spans.append(sp)
        return sp

    def event(self, name: str, trace: str, t: Optional[float] = None,
              **attrs) -> Dict[str, Any]:
        ev = {"name": name, "trace": trace,
              "t": self.clock.now() if t is None else t, "attrs": dict(attrs)}
        self.events.append(ev)
        return ev

    # -- request lifecycle --------------------------------------------------
    def record_request(self, req, **attrs) -> List[Span]:
        """Turn a finished request's stamps into its lifecycle spans
        (trace ``req-<rid>``): router hold -> queue wait -> prefill ->
        first decode -> decode.  Adjacent spans share their endpoint
        floats, so the TTFT spans telescope to ``ttft_e2e`` exactly."""
        trace = f"req-{req.rid}"
        stamps = [
            ("router_hold", req.t_created, req.t_submit),
            ("queue_wait", req.t_submit, req.t_admit),
            ("prefill", req.t_admit, req.t_prefill_done),
            ("first_decode", req.t_prefill_done, req.t_first),
            ("decode", req.t_first, req.t_done),
        ]
        base = {"rid": req.rid, "tenant": req.tenant, **attrs}
        out = []
        for name, t0, t1 in stamps:
            if t0 is None or t1 is None:
                continue
            out.append(self.span(name, trace, t0, t1, **base))
        self.event("finish", trace, t=req.t_done,
                   n_prompt=len(req.prompt), n_generated=len(req.tokens),
                   ttft=req.ttft, ttft_e2e=req.ttft_e2e, **base)
        return out

    # -- observation --------------------------------------------------------
    def open_spans(self) -> List[Span]:
        return list(self._open)

    def traces(self) -> List[str]:
        seen: Dict[str, None] = {}
        for sp in self.spans:
            seen.setdefault(sp.trace, None)
        for ev in self.events:
            seen.setdefault(ev["trace"], None)
        return list(seen)

    def spans_for(self, trace: str) -> List[Span]:
        return [sp for sp in self.spans if sp.trace == trace]


def ttft_breakdown(spans: Sequence[Span]) -> Dict[str, Any]:
    """Reconstruct TTFT from one request trace's spans.

    ``sum_s`` uses ``math.fsum`` over the (exact, by Sterbenz — the
    stamps are nearby floats) span durations, so it equals the stamped
    ``ttft_e2e = t_first - t_created`` bit-for-bit under both wall and
    tick clocks; the acceptance claim pins this.
    """
    parts = {sp.name: sp for sp in spans if sp.name in TTFT_SPANS}
    durs = {n: parts[n].duration for n in TTFT_SPANS if n in parts}
    ordered = [parts[n] for n in TTFT_SPANS if n in parts]
    return {
        "spans": durs,
        "sum_s": math.fsum(durs.values()),
        "start": ordered[0].t_start if ordered else None,
        "end": ordered[-1].t_end if ordered else None,
    }
