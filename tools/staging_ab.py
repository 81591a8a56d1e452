#!/usr/bin/env python3
"""The gloo host staging of two trees side by side, in one call:
``comm/collectives.py`` as this tree has it, and as an older tree has
it, each under the rest of this tree's ``repro_torch``:

    python3 tools/staging_ab.py --parent DIR \\
        [--plan parent:exchange+comm,change:exchange+comm+tp,...]

``DIR`` holds the older tree (``DIR/src/repro_torch/comm/collectives.py``,
e.g. a ``git archive`` of the parent commit unpacked into a directory
``.gitignore`` lists).  Each entry of ``--plan`` is ``tree:phases``
(``tree`` is ``parent`` or ``change``; ``phases`` joined by ``+``), run
in order, each in a process of its own on that tree's sources:

* ``exchange``: four spawned gloo ranks of the card time
  ``layers.split_halves`` (the in-projection's u/z exchange of one
  mixer layer) at ``chip_smoke.SEQMIX_TP_EXCHANGES``' rows for jamba
  and xlstm (``chip_smoke._exchange_ms``: rank 0's median host ms);
* ``comm``: ``chip_smoke.comm_phase`` (its checks hold);
* ``tp``: ``chip_smoke.train_phase`` (the tp phase holds yi-6b to its
  one-rank history), then ``chip_smoke.tp_phase``.

Prints each entry's numbers and seconds, then all of them on one line,
with the card's name and power limit.  Needs a CUDA card and nvcc: about
half a minute an exchange, 2 minutes a comm phase, 7 a tp phase.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVES = Path("repro_torch") / "comm" / "collectives.py"


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def exchange_rank(rank, init_file, queue):
    """One of four ranks: ``chip_smoke._exchange_ms`` for each arch and
    row count of ``SEQMIX_TP_EXCHANGES``, on its (data, model) mesh."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.dist import mesh as dmesh
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    timeout = timedelta(seconds=cs.TP_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4, timeout=timeout)
    meshes = {}
    out = {}
    for arch, _ in cs.SEQMIX_TP_SERVE:
        for label, mshape, rows in cs.SEQMIX_TP_EXCHANGES:
            if mshape not in meshes:
                meshes[mshape] = dmesh.make_mesh(mshape, ("data", "model"),
                                                 timeout=timeout)
            out[f"{arch} {label} {rows}"] = cs._exchange_ms(
                torch, dev, meshes[mshape], cs.seqmix_tp_cfg(arch), rows)
    dist.destroy_process_group()
    queue.put((rank, out))


def _exchange(torch):
    import torch.multiprocessing as tmp
    init = ROOT / "build" / f"ab_pg_{os.getpid()}"
    init.unlink(missing_ok=True)
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=exchange_rank, args=(r, str(init), q))
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
        init.unlink(missing_ok=True)
    return got[0]


def child(src: str, phases) -> None:
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.comm import collectives
    from repro_torch.kernels import build
    print(f"[staging_ab] collectives from {collectives.__file__}",
          flush=True)
    dev, smi = torch.device("cuda"), _smi()
    build.build()
    build.lib()
    out = {}
    for name in phases:
        t = time.perf_counter()
        if name == "exchange":
            out["exchange_ms"] = _exchange(torch)
        elif name == "comm":
            cs.comm_phase(torch, dev, build, smi)
        elif name == "tp":
            cs.train_phase(torch, dev, build)
            t = time.perf_counter()
            cs.tp_phase(torch, dev, build, smi)
        out[f"{name}_s"] = time.perf_counter() - t
        print(f"[staging_ab] {name}: {out[f'{name}_s']:.1f} s", flush=True)
    print("[staging_ab] RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the older tree's root")
    ap.add_argument("--plan", default="parent:exchange+comm,"
                    "change:exchange+comm+tp,parent:exchange+comm+tp,"
                    "change:exchange+comm")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--phases", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.phases.split("+"))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("staging_ab: CUDA is not available", file=sys.stderr)
        return 2
    parent = ROOT / "build" / "staging_ab" / "parent_src"
    shutil.rmtree(parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", parent / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(args.parent) / "src" / COLLECTIVES, parent / COLLECTIVES)
    trees = {"parent": str(parent), "change": str(ROOT / "src")}
    smi, results = _smi(), []
    for entry in args.plan.split(","):
        tree, _, phases = entry.partition(":")
        print(f"[staging_ab] {tree}: {phases}", flush=True)
        run = subprocess.run(
            [sys.executable, __file__, "--child", trees[tree], "--phases",
             phases], stdout=subprocess.PIPE, text=True)
        sys.stdout.write(run.stdout)
        if run.returncode:
            print(f"[staging_ab] {tree} {phases} exited {run.returncode}",
                  file=sys.stderr)
            return run.returncode
        line = [x for x in run.stdout.splitlines()
                if x.startswith("[staging_ab] RESULT ")][-1]
        results.append((tree, json.loads(line.split(" ", 2)[2])))
    for tree, res in results:
        print(f"[staging_ab] {tree}: {json.dumps(res)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
