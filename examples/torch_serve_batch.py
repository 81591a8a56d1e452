"""Serve a small model with continuously batched requests UNDER the
operator, on the PyTorch port: a declarative serve WorkloadSpec is
applied to a MiniCluster, the reconciler binds an elastic serving engine
to the job's allocation, and requests stream through the handle — half
of them submitted mid-decode (the continuous-batching path: no restart,
no re-capture).  The twin of ``examples/serve_batch.py`` over
``repro_torch.core`` and ``repro_torch.spec``; the engine serves the
arch's SMOKE config on the card (``--device cpu``: on the CPU).

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch yi-6b] \
        [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import (FluxMiniCluster, JobState, MiniClusterSpec,
                              NetModel, ResourceGraph, SimClock)
from repro_torch.serve.paging import round_up
from repro_torch.spec import ResourceSpec, ServeSpec, WorkloadSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    clock = SimClock(seed=0)
    fleet = ResourceGraph(n_pods=1, hosts_per_pod=2, chips_per_host=4)
    mc = FluxMiniCluster(clock, NetModel(), fleet,
                         MiniClusterSpec(name="serve", size=2))
    mc.create()
    mc.wait_ready()

    page = 8
    spec = WorkloadSpec(
        kind="serve", arch=args.arch, name="serve-batch",
        resources=ResourceSpec(n_nodes=2, elastic=True),
        serve=ServeSpec(
            n_slots=args.batch, page_size=page,
            max_prompt_len=round_up(args.prompt_len, page),
            max_seq_len=round_up(args.prompt_len + args.gen, page),
            max_new=args.gen, temperature=args.temperature,
            n_requests=max(args.batch // 2, 1)))
    t0 = time.perf_counter()
    h = mc.apply(spec, executor_opts={"device": args.device})
    ex, job = h.executor, h.job

    rng = np.random.default_rng(0)
    vocab = registry.smoke(args.arch).vocab_size
    # the spec's n_requests arrive at placement; stagger the rest in
    # mid-decode through the handle (continuous batching)
    clock.run(until=clock.now + 5_000,
              stop_when=lambda: job.jobid in ex.sessions
              and ex.sessions[job.jobid].ticks >= 2)
    late = [h.submit_request(rng.integers(0, vocab,
                                          args.prompt_len).tolist(),
                             max_new_tokens=args.gen,
                             temperature=args.temperature)
            for _ in range(args.batch - spec.serve.n_requests)]
    clock.run(until=clock.now + 100_000,
              stop_when=lambda: job.state == JobState.INACTIVE)
    dt = time.perf_counter() - t0

    assert h.phase == "Completed", h.status()
    rec = ex.ran[job.jobid]
    print(f"served {rec['n_requests']} requests ({len(late)} admitted "
          f"mid-decode): {rec['n_tokens']} tokens in {dt*1e3:.0f} ms "
          f"wall (incl. warm-up and capture) on mesh {rec['mesh_shape']}")
    print(f"lifecycle: {' -> '.join(e['phase'] for e in h.events())}")
    for i, toks in enumerate(rec["tokens"]):
        print(f"  request {i}: {toks}")
    return h


if __name__ == "__main__":
    main()
