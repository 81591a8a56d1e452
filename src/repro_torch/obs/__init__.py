"""Observability: span tracing on an injectable clock (``trace``),
labelled metrics (``metrics``) and their export (``export``: Chrome
trace events for Perfetto, JSONL, metrics snapshots, the provenance
header), copies of the JAX package's ``obs`` modules."""
from repro_torch.obs.export import (events_from_sim, provenance,  # noqa: F401
                                    spans_from_handle, spans_from_pipeline,
                                    to_chrome_trace, write_chrome_trace,
                                    write_jsonl, write_metrics)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Clock, Tracer, WallClock  # noqa: F401
