"""Trace/metrics export: Chrome trace events (Perfetto), JSONL, JSON.

``to_chrome_trace`` converts one or more :class:`~repro_torch.obs.trace.
Tracer`s into the Chrome trace-event format (``chrome://tracing`` /
https://ui.perfetto.dev load it directly): every span becomes a
complete (``ph:"X"``) event, every instant event a thread-scoped
``ph:"i"``, and each trace id maps to its own named thread so one
request or workload reads as one timeline row.  Timestamps are
microseconds relative to the earliest stamp in the export (ticks count
as seconds, so virtual-tick traces render at 1 tick = 1 ms wall in the
UI's ms display).

``provenance`` is the common header every ``BENCH_*.json`` /
``METRICS_*.json`` writer stamps: backend ("cuda" or "cpu"), mesh
shape, torch and CUDA versions, the card's name, git sha, timestamp,
and ``jax_version: "none"`` (the port runs no JAX; the key stays because
``tools/validate_trace.py`` requires it of every artifact).

A copy of the JAX package's ``obs/export.py`` (``repro.`` ->
``repro_torch.``) whose ``provenance`` reports the port's backend.

``spans_from_handle`` / ``events_from_sim`` lift the operator tier's
existing observation surfaces (``WorkloadHandle.events()``, the sim
clock's ``trace()`` ring) into tracer records without those layers
needing a tracer threaded through them.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.obs.trace import Span, Tracer


# -- provenance --------------------------------------------------------------
def provenance(mesh=None, **extra) -> Dict[str, Any]:
    """The common BENCH/METRICS header.  Best-effort: import- or
    git-starved environments degrade fields to "unknown", never raise."""
    try:
        import torch
        cuda = torch.cuda.is_available()
        backend = "cuda" if cuda else "cpu"
        torch_version = torch.__version__
        cuda_version = torch.version.cuda or "none"
        device = torch.cuda.get_device_name(0) if cuda else "cpu"
    except Exception:                                  # pragma: no cover
        backend = torch_version = cuda_version = device = "unknown"
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5).stdout.strip()
    except Exception:                                  # pragma: no cover
        sha = ""
    import datetime
    return {
        "backend": backend,
        "mesh_shape": dict(mesh.shape) if mesh is not None else None,
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "device": device,
        "jax_version": "none",
        "git_sha": sha or "unknown",
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        **extra,
    }


# -- chrome trace ------------------------------------------------------------
Tracers = Union[Tracer, Sequence[Tracer]]


def _as_list(tracers: Tracers) -> List[Tracer]:
    return [tracers] if isinstance(tracers, Tracer) else list(tracers)


def to_chrome_trace(tracers: Tracers, *, meta: Optional[dict] = None,
                    allow_open: bool = False) -> dict:
    """Perfetto-loadable dict.  Open spans are an export error unless
    ``allow_open`` (they export with ``dur=0`` and an ``unclosed``
    marker ``tools/validate_trace.py`` rejects)."""
    trs = _as_list(tracers)
    open_spans = [sp for tr in trs for sp in tr.open_spans()]
    if open_spans and not allow_open:
        names = [f"{sp.trace}:{sp.name}" for sp in open_spans]
        raise ValueError(f"unclosed spans at export: {names}")

    stamps = [sp.t_start for tr in trs for sp in tr.spans]
    stamps += [ev["t"] for tr in trs for ev in tr.events]
    stamps += [sp.t_start for sp in open_spans]
    t0 = min(stamps) if stamps else 0.0

    def us(t: float) -> float:
        return (t - t0) * 1e6

    tids: Dict[str, int] = {}
    events: List[dict] = []

    def tid_of(trace: str) -> int:
        if trace not in tids:
            tids[trace] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tids[trace], "args": {"name": trace}})
        return tids[trace]

    for tr in trs:
        for sp in tr.spans:
            events.append({
                "name": sp.name, "ph": "X", "pid": 0,
                "tid": tid_of(sp.trace), "ts": us(sp.t_start),
                "dur": us(sp.t_end) - us(sp.t_start),
                "args": dict(sp.attrs)})
        for ev in tr.events:
            events.append({
                "name": ev["name"], "ph": "i", "s": "t", "pid": 0,
                "tid": tid_of(ev["trace"]), "ts": us(ev["t"]),
                "args": dict(ev["attrs"])})
        for sp in open_spans:
            if sp in tr._open:
                events.append({
                    "name": sp.name, "ph": "X", "pid": 0,
                    "tid": tid_of(sp.trace), "ts": us(sp.t_start),
                    "dur": 0.0,
                    "args": {**sp.attrs, "unclosed": True}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": meta if meta is not None else provenance(),
    }


def write_chrome_trace(path: str, tracers: Tracers, *,
                       meta: Optional[dict] = None,
                       allow_open: bool = False) -> dict:
    doc = to_chrome_trace(tracers, meta=meta, allow_open=allow_open)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc


def write_jsonl(path: str, tracers: Tracers) -> int:
    """Flat event log: one JSON record per line, spans and instants
    interleaved in time order (the grep-able export)."""
    records: List[dict] = []
    for tr in _as_list(tracers):
        for sp in tr.spans:
            records.append({"kind": "span", "trace": sp.trace,
                            "name": sp.name, "t_start": sp.t_start,
                            "t_end": sp.t_end, "attrs": sp.attrs})
        for ev in tr.events:
            records.append({"kind": "event", "trace": ev["trace"],
                            "name": ev["name"], "t": ev["t"],
                            "attrs": ev["attrs"]})
    records.sort(key=lambda r: r.get("t_start", r.get("t", 0.0)))
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return len(records)


def write_metrics(path: str, registry, *, meta: Optional[dict] = None,
                  **extra) -> dict:
    doc = {"provenance": meta if meta is not None else provenance(),
           **registry.snapshot(), **extra}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc


# -- operator-tier lifts ------------------------------------------------------
def spans_from_handle(handle, tracer: Optional[Tracer] = None) -> List[Span]:
    """One workload's lifecycle as spans (trace ``wl-<jobid>``): each
    phase's span runs until the next transition; same-phase detail
    events become instants.  Derived from ``WorkloadHandle.events()``
    so the spec tier needs no tracer of its own."""
    tr = tracer if tracer is not None else Tracer()
    events = handle.events()
    trace = f"wl-{handle.job.jobid}"
    out: List[Span] = []
    prev = None                          # (phase, t, detail)
    for ev in events:
        detail = {k: v for k, v in ev.items() if k not in ("t", "phase")}
        if prev is not None and ev["phase"] != prev[0]:
            out.append(tr.span(prev[0].lower(), trace, prev[1], ev["t"],
                               **prev[2]))
            prev = (ev["phase"], ev["t"], detail)
        elif prev is None:
            prev = (ev["phase"], ev["t"], detail)
        else:
            tr.event(ev["phase"].lower(), trace, t=ev["t"], **detail)
    if prev is not None:
        # terminal phase: zero-length closing span at its own stamp
        out.append(tr.span(prev[0].lower(), trace, prev[1], prev[1],
                           **prev[2]))
    return out


def spans_from_pipeline(phandle, tracer: Optional[Tracer] = None
                        ) -> List[Span]:
    """One pipeline's lifecycle as span timelines: the pipeline-level
    phases land on trace ``pipe-<pid>`` and every stage's phases on
    ``pipe-<pid>/<stage>`` (one Perfetto row per stage — the DAG reads
    as a gantt chart).  Non-phase records (armed, workload_event,
    retry, fire_suppressed, promote_started, ...) become instants.
    Derived from ``PipelineHandle.events()`` so the flow tier needs no
    tracer of its own."""
    from repro_torch.flow.handle import STAGE_PHASES
    tr = tracer if tracer is not None else Tracer()
    per: Dict[str, List[Dict[str, Any]]] = {}
    top: List[Dict[str, Any]] = []
    for ev in phandle.events():
        stage = ev.get("stage")
        (per.setdefault(stage, []) if stage else top).append(ev)
    out: List[Span] = []

    def lift(trace: str, evs: List[Dict[str, Any]]):
        prev = None                      # (phase, t, detail)
        for ev in evs:
            phase = ev["phase"]
            detail = {k: v for k, v in ev.items()
                      if k not in ("t", "phase", "stage")}
            if phase in STAGE_PHASES:
                if prev is not None:
                    out.append(tr.span(prev[0].lower(), trace, prev[1],
                                       ev["t"], **prev[2]))
                prev = (phase, ev["t"], detail)
            else:
                tr.event(phase.lower(), trace, t=ev["t"], **detail)
        if prev is not None:
            # terminal phase: zero-length closing span at its own stamp
            out.append(tr.span(prev[0].lower(), trace, prev[1], prev[1],
                               **prev[2]))

    lift(f"pipe-{phandle.pid}", top)
    for stage in sorted(per):
        lift(f"pipe-{phandle.pid}/{stage}", per[stage])
    return out


def events_from_sim(sim_clock, tracer: Optional[Tracer] = None,
                    kinds: Optional[Iterable[str]] = None) -> int:
    """Lift ``SimClock.trace()`` records (elastic_ckpt, serve_park,
    workload_applied, ...) into tracer instants, grouped per job when
    the record carries a ``jobid``."""
    tr = tracer if tracer is not None else Tracer()
    want = set(kinds) if kinds is not None else None
    n = 0
    for t, kind, kw in sim_clock.events():
        if want is not None and kind not in want:
            continue
        jobid = kw.get("jobid")
        trace = f"wl-{jobid}" if jobid is not None else "sim"
        # sim records are free-form: suffix keys that would collide
        # with the event's own name/trace/t fields
        attrs = {(k if k not in ("name", "trace", "t") else k + "_"): v
                 for k, v in kw.items()}
        tr.event(kind, trace, t=t, **attrs)
        n += 1
    return n
