"""Serving launcher of the port: a thin client of the continuous-batching
engine, at the JAX launcher's flags.  Runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --prompt-len 256 --gen 32 --batch 8 [--prefill-chunk 256] \
      [--replicas 2] [--temperature 0.8] [--smoke --device cpu] \
      [--dp 2 --tp 2]

or declaratively, from the same WorkloadSpec the operator applies (its
arch, engine shapes, strategy, request knobs and replicas):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --spec examples/specs/serve_fleet.json [--smoke --device cpu]

The full config unless ``--smoke``.  ``--replicas N`` puts a ``Router``
over N engines on the mesh, each with its own weights drawn from
``--seed``.  ``--dp D --tp T`` above one rank serves on a ``(data D,
model T)`` mesh of gloo ranks (``dist.mesh.make_mesh``): where no
process group is running, the launcher spawns the D*T ranks itself
(``torch.multiprocessing``, a file rendezvous in a temporary directory),
rank r on ``cuda:{r % device_count}`` or on ``--device``; each builds
the mesh and serves, and rank 0's report is printed.  Under a running
process group of D*T ranks (started by the caller) this process serves
as its rank.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT = timedelta(seconds=600)     # each collective (gloo's own)


def _parser():
    from repro_torch.configs import STRATEGIES, registry

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
                    help="torch device (default: cuda; on a mesh of ranks "
                         "rank r takes cuda:{r %% device_count})")
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
    return ap


def main(argv=None):
    """Serve ``--batch`` random prompts; returns the engine (a ``Router``
    with ``--replicas`` above 1) and the requests.  Where it spawns a
    mesh of ranks, it returns rank 0's ``stats()`` in the engine's place
    (the engines live in the ranks' processes) and rank 0's requests."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if not (args.arch or args.spec):
        ap.error("--arch or --spec is required")
    if args.dp * args.tp > 1 and not dist.is_initialized():
        return _spawn(argv, args.dp * args.tp, args.device)
    eng, reqs, lines = _serve(args)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("\n".join(lines))
    return eng, reqs


def _spawn(argv, world: int, device):
    """Run ``main(argv)`` on ``world`` spawned gloo ranks; print rank 0's
    report and return its (stats, requests).  A rank that fails raises
    here with its traceback."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="serve_ranks_")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, argv, device, threads,
                               os.path.join(tmp, "pg"), q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < world:
            try:
                res = q.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a serving rank exited with "
                                       f"{dead} before reporting")
                continue
            if "error" in res:
                raise RuntimeError(f"serving rank {res['rank']} failed:\n"
                                   f"{res['error']}")
            results[res["rank"]] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print("\n".join(results[0]["lines"]))
    return results[0]["stats"], results[0]["requests"]


def _rank_main(rank, world, argv, device, threads, init_file, q):
    """One spawned rank: join the gloo group, serve, report (rank 0 its
    printed lines, stats and requests)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dev = torch.device(device) if device else torch.device(
            "cuda", rank % max(torch.cuda.device_count(), 1))
        if dev.type == "cpu":
            torch.set_num_threads(threads)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=RANK_TIMEOUT)
        try:
            eng, reqs, lines = _serve(_parser().parse_args(argv), dev)
            out = {"rank": rank}
            if rank == 0:
                out.update(lines=lines, stats=eng.stats(), requests=reqs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        q.put(out)
    except BaseException:
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _serve(args, device=None):
    """Build the engine (or Router) on this process's mesh and serve;
    returns (engine, requests, the report's lines)."""
    from repro_torch.configs import STRATEGIES, registry
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.launch.mesh import resolve_workload
    from repro_torch.serve import Engine, EngineConfig, Router
    from repro_torch.serve.paging import round_up

    ranks = args.dp * args.tp > 1
    if args.spec:
        from repro_torch.spec import load_spec
        wspec = load_spec(args.spec)
        if wspec.kind != "serve":
            raise ValueError(f"launch.serve needs a serve spec, got "
                             f"kind={wspec.kind!r}")
        args.arch = wspec.arch
        strategy = wspec.resolved_strategy
        s = wspec.serve
        args.batch = s.n_slots
        args.gen = s.max_new
        args.temperature = s.temperature
        args.prompt_len = min(args.prompt_len, s.max_prompt_len)
        args.replicas = max(args.replicas, s.replicas)
        ecfg = wspec.engine_config()
    else:
        strategy = STRATEGIES[args.strategy]
        ecfg = EngineConfig(
            n_slots=args.batch, page_size=args.page_size,
            max_prompt_len=round_up(args.prompt_len, args.page_size),
            max_seq_len=round_up(args.prompt_len + args.gen,
                                 args.page_size),
            prefill_chunk=args.prefill_chunk)
    if ranks:
        if dist.get_world_size() != args.dp * args.tp:
            raise ValueError(f"--dp {args.dp} --tp {args.tp} needs "
                             f"{args.dp * args.tp} ranks; the process "
                             f"group has {dist.get_world_size()}")
        cfg = (registry.smoke if args.smoke else registry.get)(args.arch)
        mesh = make_mesh((args.dp, args.tp), ("data", "model"),
                         timeout=RANK_TIMEOUT)
        if device is None:
            device = (torch.device(args.device) if args.device else
                      torch.device("cuda", dist.get_rank()
                                   % max(torch.cuda.device_count(), 1)))
        kw = {"device": device}
    else:
        cfg, mesh = resolve_workload(args.arch, smoke=args.smoke,
                                     dp=args.dp, tp=args.tp,
                                     device=args.device)
        kw = {}
    t_build = time.perf_counter()
    engines = [Engine(cfg, ecfg, strategy=strategy, mesh=mesh,
                      seed=args.seed, **kw) for _ in range(args.replicas)]
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
    lines = []
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        name = (f"serve_trace_rank{mesh.rank}.json" if ranks
                else "serve_trace.json")
        path = os.path.join(args.profile_dir, name)
        prof.export_chrome_trace(path)
        key = "self_cuda_time_total" if on_cuda else "self_cpu_time_total"
        lines.append(prof.key_averages().table(sort_by=key, row_limit=25))
        lines.append(f"[profile] torch.profiler trace in {path}")

    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft for r in reqs]
    per_tok = (elapsed - max(ttft)) / max(args.gen - 1, 1)
    name = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    lines.append(f"{cfg.name} on {name}")
    lines.append(
        f"mesh {dict(mesh.shape)} strategy {strategy.name} "
        f"temperature {args.temperature} "
        + (f"replicas {args.replicas} " if args.replicas > 1 else "")
        + f"(engine build {(t0 - t_build) * 1e3:.0f} ms)")
    if ranks:
        lines.append(f"ranks {mesh.size} (gloo), rank 0 on {dev}, "
                     f"coordinates {mesh.coords}")
    lines.append(f"prefill {args.prompt_len} toks x{args.batch}: "
                 f"ttft {min(ttft) * 1e3:.1f}-{max(ttft) * 1e3:.1f} ms "
                 f"(incl. warm-up and capture)")
    lines.append(f"decode {args.gen} toks x{args.batch}: {n_tok} tokens in "
                 f"{elapsed * 1e3:.1f} ms ({per_tok * 1e3:.1f} ms/step incl. "
                 f"warm-up and capture)")
    lines.append(f"engine stats: {eng.stats()}")
    lines.append(f"generated ids (request 0): {reqs[0].tokens[:16]}")
    return eng, reqs, lines


if __name__ == "__main__":
    main()
