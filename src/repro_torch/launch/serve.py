"""Serving launcher of the port: a thin client of the continuous-batching
engine, at the JAX launcher's flags.  Runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --prompt-len 256 --gen 32 --batch 8 [--prefill-chunk 256] \
      [--replicas 2] [--temperature 0.8] [--smoke --device cpu]

or declaratively, from the same WorkloadSpec the operator applies (its
arch, engine shapes, strategy, request knobs and replicas):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --spec examples/specs/serve_fleet.json [--smoke --device cpu]

The full config unless ``--smoke``.  ``--replicas N`` puts a ``Router``
over N engines on the mesh's device, each with its own weights drawn
from ``--seed``.  ``--dp``/``--tp`` above 1 raise: the engine runs on
one device (ROADMAP Queue 1 item 5(e)).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def main(argv=None):
    """Serve ``--batch`` random prompts; returns the engine (a ``Router``
    with ``--replicas`` above 1) and the requests."""
    from repro_torch.configs import STRATEGIES, registry
    from repro_torch.launch.mesh import resolve_workload
    from repro_torch.serve import Engine, EngineConfig, Router
    from repro_torch.serve.engine import refuse_sharded_mesh
    from repro_torch.serve.paging import round_up

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=registry.ARCH_IDS
                    + registry.EXTRA_IDS)
    ap.add_argument("--spec", default=None,
                    help="declarative WorkloadSpec JSON (kind: serve); "
                         "engine shapes + request knobs come from the "
                         "spec")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel mesh axis size")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh axis size")
    ap.add_argument("--strategy", default="baseline",
                    choices=list(STRATEGIES))
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help=">0: chunked prefill inside the decode tick")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1: a Router over N engine replicas (the "
                         "fleet tier; shared prefix cache when the "
                         "engines support it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the serving section with torch.profiler: "
                         "a Chrome trace in DIR and a table of the "
                         "costliest operators on stdout")
    args = ap.parse_args(argv)

    refuse_sharded_mesh({"data": args.dp, "model": args.tp})
    if args.spec:
        from repro_torch.spec import load_spec
        wspec = load_spec(args.spec)
        if wspec.kind != "serve":
            raise ValueError(f"launch.serve needs a serve spec, got "
                             f"kind={wspec.kind!r}")
        args.arch = wspec.arch
        strategy = wspec.resolved_strategy
        cfg, mesh = resolve_workload(args.arch, smoke=args.smoke,
                                     dp=args.dp, tp=args.tp,
                                     device=args.device)
        s = wspec.serve
        args.batch = s.n_slots
        args.gen = s.max_new
        args.temperature = s.temperature
        args.prompt_len = min(args.prompt_len, s.max_prompt_len)
        args.replicas = max(args.replicas, s.replicas)
        ecfg = wspec.engine_config()
    else:
        if not args.arch:
            ap.error("--arch or --spec is required")
        strategy = STRATEGIES[args.strategy]
        cfg, mesh = resolve_workload(args.arch, smoke=args.smoke,
                                     dp=args.dp, tp=args.tp,
                                     device=args.device)
        ecfg = EngineConfig(
            n_slots=args.batch, page_size=args.page_size,
            max_prompt_len=round_up(args.prompt_len, args.page_size),
            max_seq_len=round_up(args.prompt_len + args.gen,
                                 args.page_size),
            prefill_chunk=args.prefill_chunk)
    t_build = time.perf_counter()
    engines = [Engine(cfg, ecfg, strategy=strategy, mesh=mesh,
                      seed=args.seed) for _ in range(args.replicas)]
    eng = Router(engines) if args.replicas > 1 else engines[0]
    dev = engines[0].device
    on_cuda = dev.type == "cuda"
    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_cuda else []))
    with prof:
        t0 = time.perf_counter()            # serving clock: post-build
        rng = np.random.default_rng(args.seed)
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).tolist(),
                           max_new_tokens=args.gen,
                           temperature=args.temperature)
                for _ in range(args.batch)]
        eng.run()
        if on_cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "serve_trace.json")
        prof.export_chrome_trace(path)
        key = "self_cuda_time_total" if on_cuda else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=key, row_limit=25))
        print(f"[profile] torch.profiler trace in {path}")

    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft for r in reqs]
    per_tok = (elapsed - max(ttft)) / max(args.gen - 1, 1)
    name = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    print(f"{cfg.name} on {name}")
    print(f"mesh {dict(mesh.shape)} strategy {strategy.name} "
          f"temperature {args.temperature} "
          + (f"replicas {args.replicas} " if args.replicas > 1 else "")
          + f"(engine build {(t0 - t_build) * 1e3:.0f} ms)")
    print(f"prefill {args.prompt_len} toks x{args.batch}: "
          f"ttft {min(ttft) * 1e3:.1f}-{max(ttft) * 1e3:.1f} ms "
          f"(incl. warm-up and capture)")
    print(f"decode {args.gen} toks x{args.batch}: {n_tok} tokens in "
          f"{elapsed * 1e3:.1f} ms ({per_tok * 1e3:.1f} ms/step incl. "
          f"warm-up and capture)")
    print(f"engine stats: {eng.stats()}")
    print("generated ids (request 0):", reqs[0].tokens[:16])
    return eng, reqs


if __name__ == "__main__":
    main()
