#!/usr/bin/env python3
"""``chip_smoke.py``'s comm and tp phases with their spawned ranks on
torch's default intra-op threads and pinned to a count, in one call, for
the phases' seconds side by side:

    python3 tools/rank_threads.py [--order default,1,1,default]
        [--phases comm,tp]

For each setting of ``--order`` it sets ``OMP_NUM_THREADS`` in this
process's environment (``default``: as the environment gave it), which
the phases' spawned ranks inherit and torch reads as they start, then
runs each phase of ``--phases`` (``chip_smoke.comm_phase`` and
``tp_phase``; every check of theirs holds; each prints the threads a
rank ran on) and prints its seconds.  With ``tp`` it first runs the
train phase (the tp phase holds its yi-6b runs to that phase's one-rank
history).  Builds the kernels; prints the card's name and power limit.
Needs a CUDA card and nvcc: about 2 minutes a comm phase, 6 a tp phase.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="default,1,1,default",
                    help="thread settings in order: 'default' or a count")
    ap.add_argument("--phases", default="comm,tp",
                    help="comma-separated: comm, tp")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rank_threads: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    phases = {"comm": cs.comm_phase, "tp": cs.tp_phase}
    names = args.phases.split(",")
    build.build()
    build.lib()
    if "tp" in names:
        cs.train_phase(torch, dev, build)
    given = os.environ.get("OMP_NUM_THREADS")
    times = []
    for setting in args.order.split(","):
        if setting != "default":
            os.environ["OMP_NUM_THREADS"] = str(int(setting))
        elif given is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = given
        for name in names:
            t = time.perf_counter()
            phases[name](torch, dev, build, smi)
            times.append((name, setting, time.perf_counter() - t))
            print(f"[rank_threads] {name} phase, ranks on {setting} "
                  f"threads: {times[-1][2]:.1f} s ({smi})", flush=True)
    print("[rank_threads] " + "; ".join(f"{n} {s}: {t:.1f} s"
                                         for n, s, t in times) + f" ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
