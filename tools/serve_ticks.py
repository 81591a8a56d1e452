#!/usr/bin/env python3
"""The serving engine's ticks through one tree's ``repro_torch``, as
``chip_smoke.py``'s serve phase runs them, for comparing trees in one
call:

    python3 tools/serve_ticks.py [--src DIR] [--arch ARCH [--layers N]]

An arch (default yi-6b) at full width and depth, or at ``--layers`` of
its layers, random weights from seed 0, serves ``chip_smoke.py``'s
twelve prompts through the engine's legacy ticks (which also warm the
process), then with ``prefill_chunk=256``; each run prints its tick
medians by kind, TTFT, launches and graphs captured
(``chip_smoke.serve_run``), then its peak device memory, the pool's
bytes, the capture milliseconds and each prefill's milliseconds by
prompt length.  The engines take their default (CUDA graphs since they
were added; an older tree has none).  Then a
third, chunked run of the prompts traces its fifth mixed tick (every
running slot's decode and a prompt chunk) and stops: the card's busy
time and idle share in that tick and its device time by kernel.  A
sequence-mixer arch takes no chunked tick: its sixth decode tick is
traced instead, and then the exact-length prefill of the longest prompt
alone.  (The profiler starts and stops outside the
timed runs: its set-up takes seconds.)  ``--src`` runs another tree's
``repro_torch`` (e.g. an older commit's ``src``, unpacked into a
directory ``.gitignore`` lists) with this tree's ``chip_smoke.py``
driving it.  Prints the card's name and power limit.  Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to run")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve this many of the arch's layers")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_ticks: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT), str(ROOT / "tools")]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    # after repro_torch: flash_bwd_variants puts this tree's src first
    from flash_bwd_variants import card

    dev = torch.device("cuda")
    print(f"[serve] {card(torch)}; repro_torch from "
          f"{Path(build.__file__).parents[2]}")
    build.build()
    cfg = registry.get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"[serve] {cfg.name}, {cfg.n_layers} layers")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, 12)]
    for chunk in (0, 256):
        report = {}
        cs.serve_run(torch, dev, cfg, params, chunk, prompts, build,
                     report=report)
        print(f"[serve] chunk={chunk}: peak device memory "
              f"{report['peak_bytes'] / 1e9:.3f} GB allocated, "
              f"{report['peak_reserved'] / 1e9:.3f} GB reserved (pool "
              f"{report['pool_bytes'] / 1e9:.3f} GB); captures "
              f"{report['capture_ms']:.1f} ms; prefill ms by prompt "
              f"length {[(n, round(ms, 2)) for n, ms in report['prefill_ms']]}")

    def traced_step(eng):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            more = eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        cs.check(more, "the run ended before the tick to trace")
        return prof, dt

    mixers = cfg.sub_quadratic
    eng = cs.serve_engine(cfg, params, dev, 0 if mixers else 256)
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    count = "n_decode_steps" if mixers else "n_mixed_steps"
    while getattr(eng, count) < (5 if mixers else 4):
        eng.step()
    while True:                     # the next tick of that kind
        n = getattr(eng, count)
        prof, dt = traced_step(eng)
        if getattr(eng, count) > n:
            break
    if not mixers:
        print("[serve] chunked(256): mixed tick 5 traced (the decode of "
              "every running slot and a 256-row prompt chunk):")
        cs.step_table(prof, dt, "serve")
        return 0
    print("[serve] legacy: decode tick 6 traced (8 running slots):")
    cs.step_table(prof, dt, "serve")
    del eng
    eng = cs.serve_engine(cfg, params, dev, 0)
    longest = max(prompts, key=len)
    eng.submit(longest, max_new_tokens=32)
    prof, dt = traced_step(eng)
    print(f"[serve] the exact-length prefill of a {len(longest)}-token "
          f"prompt alone, traced:")
    cs.step_table(prof, dt, "serve")
    return 0


if __name__ == "__main__":
    sys.exit(main())
