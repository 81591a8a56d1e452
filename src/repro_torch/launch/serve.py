"""Serving launcher of the port: a thin client of the continuous-batching
engine.  Runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --prompt-len 256 --gen 32 --batch 8 [--prefill-chunk 256] \
      [--temperature 0.8] [--smoke --device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def main(argv=None):
    from repro_torch.configs import registry
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.paging import round_up

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS
                    + registry.EXTRA_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help=">0: chunked prefill inside the decode tick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the serving section with torch.profiler: "
                         "a Chrome trace in DIR and a table of the "
                         "costliest operators on stdout")
    args = ap.parse_args(argv)

    cfg = (registry.smoke if args.smoke else registry.get)(args.arch)
    ecfg = EngineConfig(
        n_slots=args.batch, page_size=args.page_size,
        max_prompt_len=round_up(args.prompt_len, args.page_size),
        max_seq_len=round_up(args.prompt_len + args.gen, args.page_size),
        prefill_chunk=args.prefill_chunk)
    t_build = time.perf_counter()
    eng = Engine(cfg, ecfg, seed=args.seed, device=args.device)
    on_cuda = eng.device.type == "cuda"
    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_cuda else []))
    with prof:
        t0 = time.perf_counter()
        rng = np.random.default_rng(args.seed)
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).tolist(),
                           max_new_tokens=args.gen,
                           temperature=args.temperature)
                for _ in range(args.batch)]
        eng.run()
        if on_cuda:
            torch.cuda.synchronize(eng.device)
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
    dev = torch.cuda.get_device_name(eng.device) if on_cuda else "cpu"
    print(f"{cfg.name} on {dev} temperature {args.temperature} "
          f"(engine build {(t0 - t_build) * 1e3:.0f} ms)")
    print(f"prefill {args.prompt_len} toks x{args.batch}: "
          f"ttft {min(ttft) * 1e3:.1f}-{max(ttft) * 1e3:.1f} ms")
    print(f"decode {args.gen} toks x{args.batch}: {n_tok} tokens in "
          f"{elapsed * 1e3:.1f} ms ({per_tok * 1e3:.1f} ms/step)")
    print(f"engine stats: {eng.stats()}")
    print("generated ids (request 0):", reqs[0].tokens[:16])


if __name__ == "__main__":
    main()
