"""Training launcher of the port, on one device.  Runs on CUDA unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --steps 20 --batch 8 --seq 64 [--device cpu]

Elastic: ``--elastic`` splits the run into grow/shrink phases with a
``Trainer.remesh`` between them (a checkpoint round trip, or one through
host memory without ``--ckpt-dir``), as the JAX launcher does across its
host's devices and the operator's ElasticTrainExecutor does at a
MiniCluster resize.  A process here runs on one device, so every phase's
mesh is (1, 1):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --elastic --steps 12 --batch 8 --seq 64 [--device cpu]

Mesh, strategy and spec flags of the JAX launcher wait for the port's
sharding.
"""
from __future__ import annotations

import argparse
import contextlib


def phase_steps(total: int, n_phases: int):
    """Split ``total`` steps over the elastic phases, front-loaded so
    the sum is EXACTLY ``total`` and trailing phases may get 0 (those
    are skipped — never a negative run, never an overrun)."""
    base, rem = divmod(total, n_phases)
    return [base + (1 if i < rem else 0) for i in range(n_phases)]


def main(argv=None):
    import torch

    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.train import Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS
                    + registry.EXTRA_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--elastic", action="store_true",
                    help="grow/shrink phases with a Trainer.remesh "
                         "(checkpoint round trip) between them")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the train loop with torch.profiler: a "
                         "Chrome trace in DIR and a table of the "
                         "costliest operators on stdout")
    args = ap.parse_args(argv)

    cfg = (registry.smoke if args.smoke else registry.get)(args.arch)
    shape = WorkloadShape("smoke", "train", args.seq, args.batch)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1))
    tr = Trainer(cfg, tcfg, shape, ckpt_dir=args.ckpt_dir,
                 device=args.device)
    on_cuda = tr.device.type == "cuda"
    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_cuda else []))
    with prof:
        if args.elastic:
            hist = _elastic(tr, args)
        else:
            hist = tr.run(args.steps, ckpt_every=args.ckpt_every,
                          log_every=5)
    if args.profile_dir:
        import os
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "train_trace.json")
        prof.export_chrome_trace(path)
        key = "self_cuda_time_total" if on_cuda else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=key, row_limit=20))
        print(f"[profile] torch.profiler trace in {path}")
    if on_cuda:
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              f" GB")
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f})")


def _elastic(tr, args):
    """The JAX launcher's phases: one host, two hosts, one host, a
    remesh between phases.  ``sharding.submesh_for`` lays each over the
    trainer's one device, so every mesh is (1, 1) (several devices of
    one process: ROADMAP Queue 1 item 5) and each remesh is the
    checkpoint (or host memory) round trip alone."""
    from repro_torch.core.resource_graph import ResourceSet
    from repro_torch.dist.sharding import submesh_for
    hist, started = [], False
    hosts = [1, 2, 1]
    for n_hosts, n in zip(hosts, phase_steps(args.steps, len(hosts))):
        if n == 0:
            continue
        if started:
            mesh = submesh_for(ResourceSet(hosts=tuple(range(n_hosts)),
                                           chips_per_host=1), [tr.device])
            dt = tr.remesh(mesh)
            shape = tuple(mesh.shape.values())
            print(f"[elastic] remesh -> {n_hosts} host(s), mesh {shape} "
                  f"resumed at step {tr.start_step} in {dt:.2f}s",
                  flush=True)
        started = True
        hist = tr.run(n, ckpt_every=args.ckpt_every, log_every=5)
    return hist


if __name__ == "__main__":
    main()
