#!/usr/bin/env python3
"""How far a sharded train step's gradient norm may lie from one rank's
by bf16 rounding alone, for a ``chip_smoke.py`` seqmix_tp train cut:

    python3 tools/tp_grad_noise.py [--arch jamba-v0.1-52b|xlstm-1.3b]
        [--rows R] [--seq S] [--no-moe] [--leaves]

The cut's weights (seed 0, float32) and one batch (seed 5) through
``Model.loss`` and its backward on this card three ways: the kernels in
bf16, the plain versions in bf16 and in float32; then the same weights,
each of four spawned gloo ranks keeping its shard, on (data 1, model 4)
in bf16 through the kernels.  Prints each path's loss and global
gradient norm against the kernels' and float32's (and with
``--leaves`` each leaf's norm).  ``--no-moe`` drops the MoE FFN for a
dense one (jamba), ``--rows``/``--seq`` set the batch.  Prints the
card's name and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def setup(torch, dev, args):
    import chip_smoke as cs
    from repro_torch.models.model import Model
    cut = {arch: cfg for arch, cfg, _ in cs.seqmix_tp_train_setup()}
    cfg = cut[args.arch]
    if args.no_moe:
        cfg = dataclasses.replace(cfg, moe=None)
    g = torch.Generator(device=dev).manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (args.rows, args.seq + 1),
                        generator=g, device=dev)
    return cfg, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}, Model(cfg)


def grads(torch, model, params, batch, dtype, mesh=None):
    """(loss, each leaf's gradient) of ``model`` at ``params``."""
    from repro_torch.configs import BASELINE
    from repro_torch.dist.actsharding import activation_sharding
    from repro_torch.models import params as P
    p = P.tree_map(lambda t: t.detach().requires_grad_(True), params)
    ctx = (contextlib.nullcontext() if mesh is None else activation_sharding(
        mesh, BASELINE, global_rows=batch["tokens"].shape[0]))
    with ctx:
        loss = model.loss(p, batch, compute_dtype=dtype)[0]
    loss.backward()
    return float(loss.detach()), [t.grad for t in P.tree_leaves(p)]


def draw(torch, dev, model, local=None):
    from repro_torch.models import params as P
    return P.init_params(model.param_defs(),
                         torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev, local=local)


def rank_main(rank, init_file, argv, q):
    """One rank of (data 1, model 4): its shard of the weights, the bf16
    kernels' gradients, each leaf's squared norm summed over ``model``
    (rank 0 puts them on ``q``)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.configs import BASELINE
    from repro_torch.dist import mesh as dmesh
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps as dsteps
    from repro_torch.models import params as P
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=600))
    mesh = dmesh.make_mesh((1, 4), ("data", "model"))
    cfg, batch, model = setup(torch, dev, parse(argv))
    rules = shd.param_rules(BASELINE)
    params = draw(torch, dev, model, local=lambda d, t: shd.shard(
        t, shd.resolve_spec(d.shape, d.axes, rules, mesh), mesh))
    specs = P.tree_leaves(dsteps.train_state_shardings(
        cfg, BASELINE, mesh)["params"])
    loss, g = grads(torch, model, params, batch, torch.bfloat16, mesh)
    sq = []
    for t, sp in zip(g, specs):
        s = (t.float() ** 2).sum().cpu()
        if any(e is not None for e in sp):
            dist.all_reduce(s)
        sq.append(float(s))
    dist.destroy_process_group()
    q.put((loss, sq) if rank == 0 else None)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--no-moe", action="store_true")
    ap.add_argument("--leaves", action="store_true")
    return ap.parse_args(argv)


def main() -> int:
    import torch
    import torch.multiprocessing as tmp
    if not torch.cuda.is_available():
        print("tp_grad_noise: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.models import params as P
    argv = sys.argv[1:]
    args = parse(argv)
    dev = torch.device("cuda")
    build.build()
    build.lib()
    cfg, batch, model = setup(torch, dev, args)
    params = draw(torch, dev, model)
    res = {}
    for name, impl, dtype in (("kernels", None, torch.bfloat16),
                              ("plain", "ref", torch.bfloat16),
                              ("plain_f32", "ref", torch.float32)):
        from repro_torch.models.model import Model
        loss, g = grads(torch, Model(cfg, impl=impl), params, batch, dtype)
        res[name] = (loss, [float((t.float() ** 2).sum()) for t in g])
        del g
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    init_file = ROOT / "build" / f"grad_noise_pg_{os.getpid()}"
    init_file.parent.mkdir(exist_ok=True)
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, str(init_file), argv, q))
             for r in range(4)]
    for p in procs:
        p.start()
    outs = [q.get(timeout=900) for _ in procs]
    for p in procs:
        p.join()
    init_file.unlink(missing_ok=True)
    res["ranks"] = next(o for o in outs if o is not None)
    norm = {k: sum(sq) ** 0.5 for k, (_, sq) in res.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    what = (f"{cfg.name} {cfg.block_pattern}{' no MoE' if args.no_moe else ''}"
            f", {args.rows} x {args.seq}")
    for k, (loss, _) in res.items():
        print(f"[grad_noise] {what}: {k} loss {loss:.6f}, grad norm "
              f"{norm[k]:.6f}, relative to the kernels' "
              f"{norm[k] / norm['kernels'] - 1:+.3e}, to float32's "
              f"{norm[k] / norm['plain_f32'] - 1:+.3e} ({smi})")
    if args.leaves:
        paths = [".".join(p) for p in _paths(model.param_defs())]
        for i, path in enumerate(paths):
            n = {k: v[1][i] ** 0.5 for k, v in res.items()}
            print(f"[grad_noise]   {path}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in n.items()))
    return 0


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


if __name__ == "__main__":
    sys.exit(main())
