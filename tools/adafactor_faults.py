#!/usr/bin/env python3
"""``chip_smoke.py``'s adafactor part against planted faults in the
sharded Adafactor update, to show that its checks see them:

    python3 tools/adafactor_faults.py [--faults none,local_divisor,no_sum]

One one-rank reference (``chip_smoke.ada_reference``), then for each
entry of ``--faults`` four spawned gloo ranks of the card run the part's
sharded steps (``chip_smoke._tp_train_run``) with the fault planted in
their own copy of ``repro_torch.optim.optimizers`` (the files are not
touched), and this process holds them to the reference
(``chip_smoke.ada_report``: losses, grad_norm, state bytes, launches,
the checkpoint restored on one rank and its factored moments):

* ``none``: no fault; every check must hold;
* ``local_divisor``: each mean over a split dim divided by the shard's
  size, not the whole dim's (``_whole_shape`` returns the local shape);
* ``no_sum``: the shards' row, column and RMS sums not all-reduced
  (``_sum_groups`` returns each rank's own).

Prints, for each entry, the first check that failed or that all held,
then one line with every verdict and the card's name and power limit;
exits non-zero if ``none`` failed or a fault passed.  Needs a CUDA card
and nvcc: about a minute an entry after the kernels' build.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _plant(fault: str) -> None:
    from repro_torch.optim import optimizers as opt
    if fault == "local_divisor":
        opt._whole_shape = lambda shape, spec, mesh: list(shape)
    elif fault == "no_sum":
        opt._sum_groups = lambda parts, mesh: [t for t, _ in parts]
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")


def fault_rank(rank, init_file, ckpt_dir, fault, queue):
    """One of four ranks: the adafactor part's sharded steps, ``fault``
    planted, a checkpoint at the last under ``ckpt_dir``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.dist import mesh as dmesh
    from repro_torch.kernels import build

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    timeout = timedelta(seconds=cs.TP_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4, timeout=timeout)
    _plant(fault)
    name, cfg, shape, mshape, axes, strategy = cs._ada_setup()
    mesh = dmesh.make_mesh(mshape, axes, timeout=timeout)
    run = cs._tp_train_run(torch, dev, build, name, cfg, shape, mesh,
                           strategy, cs.ADA_STEPS, ckpt_dir, cs._ada_tcfg())
    dist.destroy_process_group()
    queue.put((rank, run))


def _ranks(fault, ckpt_dir):
    import torch.multiprocessing as tmp
    init = ROOT / "build" / f"ada_faults_pg_{os.getpid()}"
    init.unlink(missing_ok=True)
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=fault_rank,
                         args=(r, str(init), str(ckpt_dir), fault, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        init.unlink(missing_ok=True)
    return [(r, got[r]) for r in range(4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", default="none,local_divisor,no_sum")
    args = ap.parse_args()
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("adafactor_faults: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build.build()
    build.lib()
    want, moments = cs.ada_reference(torch, dev)
    verdicts = {}
    for fault in args.faults.split(","):
        ckpt = ROOT / "build" / "ada_faults_ckpt" / fault
        shutil.rmtree(ckpt, ignore_errors=True)
        t = time.perf_counter()
        print(f"[adafactor_faults] {fault}", flush=True)
        runs = _ranks(fault, ckpt)
        try:
            cs.ada_report(torch, dev, runs, want, moments, ckpt, smi, {})
            verdicts[fault] = "every check held"
        except RuntimeError as e:
            verdicts[fault] = f"failed: {e}"
        shutil.rmtree(ckpt, ignore_errors=True)
        print(f"[adafactor_faults] {fault}: {verdicts[fault]} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(f"[adafactor_faults] {json.dumps(verdicts)} ({smi})")
    ok = all((v == "every check held") == (f == "none")
             for f, v in verdicts.items())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
