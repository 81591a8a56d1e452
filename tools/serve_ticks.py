#!/usr/bin/env python3
"""The serving engine's ticks through one tree's ``repro_torch``, as
``chip_smoke.py``'s serve phase runs them, for comparing trees in one
call:

    python3 tools/serve_ticks.py [--src DIR]

yi-6b at full width and depth, random weights from seed 0, serves
``chip_smoke.py``'s twelve prompts through the engine's legacy ticks
(which also warm the process), then with ``prefill_chunk=256``; each
run prints its tick medians by kind, TTFT and launches
(``chip_smoke.serve_run``).  Then a third, chunked run of the prompts
traces its fifth mixed tick (every running slot's decode and a prompt
chunk) and stops: the card's busy time and idle share in that tick and
its device time by kernel.  (The profiler starts and stops outside the
timed runs: its set-up takes seconds.)  ``--src`` runs another tree's
``repro_torch`` (e.g. an older commit's ``src``, unpacked into a
directory ``.gitignore`` lists) with this tree's ``chip_smoke.py``
driving it.  Prints the card's name and power limit.  Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to run")
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
    cfg = registry.get("yi-6b")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, 12)]
    for chunk in (0, 256):
        cs.serve_run(torch, dev, cfg, params, chunk, prompts, build)

    eng = cs.serve_engine(cfg, params, dev, 256)
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    while eng.n_mixed_steps < 4:
        eng.step()
    while True:                     # the next mixed tick
        n_mix = eng.n_mixed_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            more = eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        cs.check(more, "the chunked run ended before its fifth mixed tick")
        if eng.n_mixed_steps > n_mix:
            break
    print("[serve] chunked(256): mixed tick 5 traced (the decode of every "
          "running slot and a 256-row prompt chunk):")
    cs.step_table(prof, dt, "serve")
    return 0


if __name__ == "__main__":
    sys.exit(main())
