"""Labelled counter/gauge/histogram registry.

One :class:`MetricsRegistry` per component (each Engine owns one, the
Router another); a fleet view is :meth:`MetricsRegistry.merged` over
the named parts.  Counters are monotonic except through :meth:`put`,
the absolute-set path the elastic park/restore snapshot uses (an
engine rebuilt on a new mesh adopts the parked engine's counts).

Two export surfaces:

* :meth:`snapshot` — a JSON-ready dict (``METRICS_*.json``, bench
  consumption);
* :meth:`to_prometheus` — Prometheus text exposition (``# TYPE`` lines,
  ``name{label="v"} value`` samples, ``_bucket``/``_sum``/``_count``
  histogram series).

Metric names follow Prometheus convention: ``<tier>_<what>_total`` for
counters, plain ``<tier>_<what>`` for gauges, ``<tier>_<what>_s`` for
second-valued histograms.  The ROADMAP "Observability contract" lists
the registered names.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# seconds-scale latency buckets (ticks land in them too: 1, 5, 10 ...)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0)


def _key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, Dict[LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[LabelKey, float]] = {}
        self._hists: Dict[str, Dict[LabelKey, dict]] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}

    # -- counters -----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> float:
        series = self._counters.setdefault(name, {})
        k = _key(labels)
        series[k] = series.get(k, 0.0) + value
        return series[k]

    def put(self, name: str, value: float, **labels) -> float:
        """Absolute counter set — the park/restore adoption path (and
        compatibility shims that mirror legacy attribute writes)."""
        self._counters.setdefault(name, {})[_key(labels)] = float(value)
        return float(value)

    # -- gauges -------------------------------------------------------------
    def set(self, name: str, value: float, **labels) -> float:
        self._gauges.setdefault(name, {})[_key(labels)] = float(value)
        return float(value)

    # -- histograms ---------------------------------------------------------
    def observe(self, name: str, value: float,
                buckets: Optional[Iterable[float]] = None, **labels):
        bks = self._buckets.setdefault(
            name, tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS)
        series = self._hists.setdefault(name, {})
        k = _key(labels)
        h = series.get(k)
        if h is None:
            h = series[k] = {"count": 0, "sum": 0.0, "min": None,
                             "max": None, "buckets": [0] * (len(bks) + 1)}
        h["count"] += 1
        h["sum"] += value
        h["min"] = value if h["min"] is None else min(h["min"], value)
        h["max"] = value if h["max"] is None else max(h["max"], value)
        h["buckets"][bisect.bisect_left(bks, value)] += 1

    # -- reads --------------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """Current counter/gauge value (0.0 when never written)."""
        k = _key(labels)
        if name in self._counters:
            return self._counters[name].get(k, 0.0)
        return self._gauges.get(name, {}).get(k, 0.0)

    def histogram(self, name: str, **labels) -> Optional[dict]:
        h = self._hists.get(name, {}).get(_key(labels))
        return dict(h) if h else None

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        def rows(table):
            return [{"name": n, "labels": dict(k), "value": v}
                    for n, series in sorted(table.items())
                    for k, v in sorted(series.items())]

        hists = []
        for n, series in sorted(self._hists.items()):
            bks = self._buckets[n]
            for k, h in sorted(series.items()):
                # cumulative bucket counts, Prometheus ``le`` semantics
                cum, buckets = 0, []
                for le, c in zip(list(bks) + ["+Inf"], h["buckets"]):
                    cum += c
                    buckets.append({"le": le, "count": cum})
                hists.append({
                    "name": n, "labels": dict(k), "count": h["count"],
                    "sum": h["sum"], "min": h["min"], "max": h["max"],
                    "buckets": buckets,
                })
        return {"counters": rows(self._counters),
                "gauges": rows(self._gauges), "histograms": hists}

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for n, series in sorted(self._counters.items()):
            lines.append(f"# TYPE {n} counter")
            for k, v in sorted(series.items()):
                lines.append(f"{n}{_fmt_labels(k)} {v:g}")
        for n, series in sorted(self._gauges.items()):
            lines.append(f"# TYPE {n} gauge")
            for k, v in sorted(series.items()):
                lines.append(f"{n}{_fmt_labels(k)} {v:g}")
        for n, series in sorted(self._hists.items()):
            lines.append(f"# TYPE {n} histogram")
            bks = self._buckets[n]
            for k, h in sorted(series.items()):
                cum = 0
                for le, c in zip(list(bks) + ["+Inf"], h["buckets"]):
                    cum += c
                    le_s = le if le == "+Inf" else f"{le:g}"
                    extra = f'le="{le_s}"'
                    lines.append(f"{n}_bucket{_fmt_labels(k, extra)} {cum}")
                lines.append(f"{n}_sum{_fmt_labels(k)} {h['sum']:g}")
                lines.append(f"{n}_count{_fmt_labels(k)} {h['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def merged(named: Dict[str, "MetricsRegistry"],
               label: str = "source") -> "MetricsRegistry":
        """One registry over several, each part's series relabelled
        with ``label=<part name>`` (the fleet export view)."""
        out = MetricsRegistry()
        for src_name, reg in named.items():
            tag = {label: src_name}
            for n, series in reg._counters.items():
                for k, v in series.items():
                    out.inc(n, v, **dict(k), **tag)
            for n, series in reg._gauges.items():
                for k, v in series.items():
                    out.set(n, v, **dict(k), **tag)
            for n, series in reg._hists.items():
                out._buckets.setdefault(n, reg._buckets[n])
                dst = out._hists.setdefault(n, {})
                for k, h in series.items():
                    kk = _key({**dict(k), **tag})
                    if kk in dst:
                        d = dst[kk]
                        d["count"] += h["count"]
                        d["sum"] += h["sum"]
                        for m in ("min", "max"):
                            vals = [x for x in (d[m], h[m]) if x is not None]
                            d[m] = (min(vals) if m == "min" else max(vals)) \
                                if vals else None
                        d["buckets"] = [a + b for a, b in
                                        zip(d["buckets"], h["buckets"])]
                    else:
                        dst[kk] = {**h, "buckets": list(h["buckets"])}
        return out
