"""What each of four gloo ranks runs for ``tests/test_torch_comm.py`` (on
the CPU, ``run_rank``) and ``tests/test_torch_cuda.py`` (on one card,
``cuda_sync_rank``).

A module apart from the test file, and without JAX: the ranks are
spawned processes, and each imports this module to find its function.
``run_rank`` joins the process group, runs every scenario in one fixed
order (each a collective on all four ranks) and puts each result, or
its traceback, on the queue.  The test file compares the results with
the JAX package and with the port's single-device step.
"""
from __future__ import annotations

import dataclasses
import os
import traceback
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch.comm import collectives
from repro_torch.configs.base import (BASELINE, ModelConfig,
                                      ShardingStrategy, TrainConfig,
                                      WorkloadShape)
from repro_torch.dist import mesh as dmesh
from repro_torch.dist import sharding as shd
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.train import Trainer

WORLD = 4
TINY = ModelConfig(name="tiny-comm", family="dense", n_layers=2,
                   d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                   vocab_size=128)
# float32 compute isolates the comm schedule from bf16 noise
TCFG = TrainConfig(learning_rate=1e-2, total_steps=10, warmup_steps=0,
                   compute_dtype="float32")
SHAPE = WorkloadShape("comm", "train", 16, 8)
HIER = ShardingStrategy(name="hier", hierarchical_collectives=True)
COMPRESSED = ShardingStrategy(name="hier-int8",
                              hierarchical_collectives=True,
                              compress_cross_pod=True, compress_pods=2,
                              compress_block=64)
N_STEPS = 3
BUCKETS = (2, 4, 7)


def _np_tree(tree):
    return P.tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _history(tr):
    return [{k: h[k] for k in ("loss", "xent", "grad_norm")}
            for h in tr.history]


def _sync(mesh, inputs):
    """The function-level sync of the JAX test's tree on (pod, data)."""
    defs = {k: P.PDef(tuple(s), tuple(a))
            for k, (s, a) in inputs["defs"].items()}
    out = {}
    for name, strat, ef in (
            ("hier", HIER, None),
            ("hier-int8", COMPRESSED, inputs["ef"]),
            ("hier-int8-zero-ef", COMPRESSED,
             {k: np.zeros_like(v) for k, v in inputs["ef"].items()})):
        policy = comm.resolve_policy(strat, mesh)
        mine = {k: torch.from_numpy(v[mesh.rank:mesh.rank + 1])
                for k, v in inputs["stacked"].items()}
        if ef is not None:
            # this rank's rows of the residual, as its resolved spec
            # places them (its pod's row)
            ef = {k: shd.shard(torch.from_numpy(v), shd.resolve_spec(
                v.shape, (comm.EF_POD_AXIS,) + defs[k].axes,
                comm.grad_rules(strat), mesh), mesh)
                for k, v in ef.items()}
        synced, new_ef = comm.sync_grads(mine, defs, mesh, policy, strat,
                                         residual=ef)
        out[name] = {"synced": _np_tree(synced),
                     "ef": _np_tree(new_ef) if ef else None}
    out["pod"] = mesh.coords["pod"]
    return out


def _buckets(mesh):
    """Bucketed against monolithic sync of TINY-shaped gradients: the
    largest difference per (strategy, bucket count), and the number of
    ``sync_grads`` calls each bucketed sync made."""
    defs = Model(TINY).param_defs()
    rng = np.random.default_rng(11)
    full = [rng.standard_normal((WORLD,) + d.shape).astype(np.float32)
            for d in P.tree_leaves(defs)]
    stacked = P.tree_unflatten(defs, [torch.from_numpy(a[mesh.rank:
                                                         mesh.rank + 1])
                                      for a in full])
    real = collectives.sync_grads
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    out = {}
    for strat in (HIER, COMPRESSED):
        ef = (P.tree_map(lambda d: torch.from_numpy(rng.standard_normal(
            (1,) + d.shape).astype(np.float32)), defs)
            if strat.compress_cross_pod else None)
        policy = comm.resolve_policy(strat, mesh)
        ref_g, ref_e = comm.sync_grads(stacked, defs, mesh, policy, strat,
                                       residual=ef)
        for n in BUCKETS:
            bpolicy = collectives.CommPolicy(
                hierarchical=True, compress=policy.compress,
                block=policy.block, pods=policy.pods, buckets=n)
            calls.clear()
            collectives.sync_grads = spy
            try:
                g, e = comm.sync_grads_bucketed(stacked, defs, mesh, bpolicy,
                                                strat, residual=ef)
            finally:
                collectives.sync_grads = real
            diff = max(float((a - b).abs().max()) for a, b in
                       zip(P.tree_leaves(g), P.tree_leaves(ref_g)))
            if ef is not None:
                diff = max(diff, max(float((a - b).abs().max()) for a, b in
                                     zip(P.tree_leaves(e),
                                         P.tree_leaves(ref_e))))
            out[(strat.name, n)] = (diff, len(calls))
    return out


def _train(mesh, strategy, shape=SHAPE, n_steps=N_STEPS, tcfg=TCFG):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = Trainer(TINY, tcfg, shape, mesh=mesh, strategy=strategy,
                     device="cpu")
    n_warn = sum(issubclass(x.category, comm.CommFallbackWarning)
                 for x in w)
    real = comm.sync_grads
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    comm.sync_grads = spy
    try:
        tr.run(n_steps, log_every=0)
    finally:
        comm.sync_grads = real
    ef = (_np_tree(tr.state["comm"]["ef"]) if "comm" in tr.state else None)
    return {"history": _history(tr), "warnings": n_warn,
            "syncs": len(calls), "ef": ef}


def _from_jax_params(mesh, strategy, params):
    """``strategy`` from the JAX package's initial parameters (numpy)."""
    tr = Trainer(TINY, TCFG, SHAPE, mesh=mesh, strategy=strategy,
                 device="cpu")
    tr.init_or_resume()
    tr.state["params"] = P.from_numpy(params)
    tr.run(N_STEPS, log_every=0)
    return _history(tr)


def _checkpoint(mesh, ckpt_dir):
    """COMPRESSED: 2 steps, a checkpoint, 2 more (the uninterrupted run);
    then a fresh Trainer restores step 2 and takes the same 2 steps."""
    tr = Trainer(TINY, TCFG, SHAPE, mesh=mesh, strategy=COMPRESSED,
                 ckpt_dir=ckpt_dir, device="cpu")
    tr.run(2, ckpt_every=2, log_every=0)
    tr.run(2, log_every=0)
    fresh = Trainer(TINY, TCFG, SHAPE, mesh=mesh, strategy=COMPRESSED,
                    ckpt_dir=ckpt_dir, device="cpu")
    how = fresh.init_or_resume()
    fresh.run(2, log_every=0)
    same = all(torch.equal(a, b) for a, b in
               zip(P.tree_leaves(tr.state), P.tree_leaves(fresh.state)))
    return {"whole": _history(tr), "resumed": _history(fresh), "how": how,
            "start": fresh.history[0]["step"], "same_state": same}


def run_rank(rank, init_file, inputs, ckpt_dir, queue):
    torch.set_num_threads(1)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD,
                                timeout=timedelta(seconds=120))
        try:
            pod = dmesh.make_mesh((2, 2), ("pod", "data"),
                                  timeout=timedelta(seconds=120))
            flat = dmesh.make_mesh((WORLD,), ("data",),
                                   timeout=timedelta(seconds=120))
            res = {"rank": rank, "coords": pod.coords}
            res["sync"] = _sync(pod, inputs)
            res["buckets"] = _buckets(pod)
            res["hier"] = _train(pod, HIER)
            res["compressed"] = _train(pod, COMPRESSED)
            res["hier_ga2"] = _train(pod, HIER, tcfg=dataclasses.replace(
                TCFG, grad_accum=2))
            res["from_jax"] = _from_jax_params(pod, COMPRESSED,
                                               inputs["jax_params"])
            res["podless_hier"] = _train(flat, HIER, n_steps=2)
            res["podless_flat"] = _train(flat, BASELINE, n_steps=2)
            res["indivisible"] = _train(
                pod, HIER, WorkloadShape("odd", "train", 16, 6), n_steps=2)
            res["checkpoint"] = _checkpoint(pod, ckpt_dir)
        finally:
            dist.destroy_process_group()
        queue.put(res)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def cuda_sync_rank(rank, init_file, queue):
    """On card 0: a hierarchical and a compressed sync of one gradient
    (8 x 32 x 1024 x 64 float32, seeded by rank) on CUDA tensors, then the
    same on CPU tensors; puts the largest differences and which
    launches the CUDA syncs made."""
    from repro_torch.kernels import build
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=120))
    try:
        mesh = dmesh.make_mesh((2, 2), ("pod", "data"),
                               timeout=timedelta(seconds=120))
        shape = (8, 32, 1024, 64)
        defs = {"w": P.PDef(shape, (None,) * 4)}
        g = torch.Generator().manual_seed(rank)
        x = torch.randn((1,) + shape, generator=g)
        strat = dataclasses.replace(COMPRESSED, compress_block=256)
        out = {"rank": rank}
        for name, s in (("hier", HIER), ("hier-int8", strat)):
            policy = comm.resolve_policy(s, mesh)
            got = {}
            for dev in ("cuda", "cpu"):
                build.reset_launches()
                ef = ({"w": torch.zeros((1,) + shape, device=dev)}
                      if policy.compress else None)
                got[dev] = comm.sync_grads({"w": x.to(dev)}, defs, mesh,
                                           policy, s, residual=ef)
                if dev == "cuda":
                    out[name + "_launches"] = (build.LAUNCHES["quantize"],
                                               build.LAUNCHES["dequantize"])
            diffs = [float((a.cpu() - b).abs().max()) for a, b in zip(
                P.tree_leaves(got["cuda"][0]), P.tree_leaves(got["cpu"][0]))]
            if policy.compress:
                diffs.append(float((got["cuda"][1]["w"].cpu()
                                    - got["cpu"][1]["w"]).abs().max()))
            out[name] = max(diffs)
    finally:
        dist.destroy_process_group()
    queue.put(out)

