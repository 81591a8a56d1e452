"""Pipeline launcher: apply a declarative PipelineSpec to a simulated
MiniCluster and walk the DAG to completion.

  PYTHONPATH=src python -m repro_torch.launch.pipeline \
      --pipeline examples/specs/pipeline_canary.json \
      [--size 0] [--trace TRACE_pipeline.json] [--check] [--device cpu]

``--check`` lints the pipeline (cycles, unknown refs, unknown
triggers, gate/promote kind-compatibility) and exits without running —
the same validator ``FluxInstance.apply_pipeline`` enforces.
``--trace`` exports the ``pipe-<id>`` span timelines (plus each
workload's lifecycle) as a Chrome/Perfetto trace.  Every stage runs on
the card unless ``--device`` names another device (``cpu``: the
kernels' plain versions); the stages take their archs' SMOKE configs,
as in the JAX launcher.  A copy of the JAX package's
``launch/pipeline.py``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _auto_size(pspec) -> int:
    """Hosts needed if every workload stage ran concurrently (the
    safe default for an unconstrained DAG)."""
    total = 0
    for s in pspec.stages:
        if s.kind == "workload" and s.workload is not None:
            replicas = (s.workload.serve.replicas
                        if s.workload.kind == "serve" else 1)
            total += s.workload.resources.n_nodes * max(replicas, 1)
    return max(total, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", required=True,
                    help="declarative PipelineSpec JSON")
    ap.add_argument("--check", action="store_true",
                    help="lint only; do not run")
    ap.add_argument("--size", type=int, default=0,
                    help="MiniCluster size (0 = sized to the DAG)")
    ap.add_argument("--horizon", type=float, default=1e6,
                    help="sim-seconds budget for the run")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome/Perfetto trace here")
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.flow import check_pipeline
    pspec, errors = check_pipeline(args.pipeline)
    if errors:
        print(f"INVALID {args.pipeline}")
        for e in errors:
            print(f"  - {e['field']}: {e['message']} [{e['code']}]")
        sys.exit(1)
    print(f"OK {args.pipeline}: {len(pspec.stages)} stages "
          f"({', '.join(s.name for s in pspec.stages)})")
    if args.check:
        return

    from repro_torch.core import (FluxMiniCluster, MiniClusterSpec, NetModel,
                            ResourceGraph, SimClock)
    size = args.size or _auto_size(pspec)
    clock = SimClock(seed=0)
    graph = ResourceGraph(n_pods=max(1, (size + 3) // 4),
                          hosts_per_pod=4, chips_per_host=2)
    mc = FluxMiniCluster(clock, NetModel(), graph,
                         MiniClusterSpec(name=pspec.name, size=size,
                                         max_size=size))
    mc.create()
    mc.wait_ready()
    opts = {"device": args.device} if args.device else None
    handle = mc.apply_pipeline(pspec, executor_opts=opts)
    clock.run(until=clock.now + args.horizon,
              stop_when=lambda: handle.done)
    status = handle.status()
    print(json.dumps(status, indent=2, default=str))
    if args.trace:
        from repro_torch.obs import (Tracer, spans_from_handle,
                               spans_from_pipeline, write_chrome_trace)
        tr = Tracer()
        spans_from_pipeline(handle, tr)
        for st in handle.stages.values():
            for wh in st.handles:
                spans_from_handle(wh, tr)
        write_chrome_trace(args.trace, tr)
        print(f"trace -> {args.trace}")
    sys.exit(0 if status["phase"] == "Completed" else 2)


if __name__ == "__main__":
    main()
