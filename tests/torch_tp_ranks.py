"""What each of four gloo ranks runs for ``tests/test_torch_tp.py``: the
port's train step on meshes with a ``model`` axis, a ``pod`` tier or
both, on the CPU.

A module apart from the test file, and without JAX: the ranks are
spawned processes, and each imports this module to find its function.
``run_rank`` joins the process group, builds the meshes, runs every
scenario in one fixed order (each a collective on all four ranks) and
puts its results, or its traceback, on the queue.  Whole trees come
back from rank 0 only (gathered over each leaf's spec).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import traceback
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch.comm import collectives
from repro_torch.configs import registry
from repro_torch.configs.base import (BASELINE, OPTIMIZED, ZERO3,
                                      ShardingStrategy, TrainConfig,
                                      WorkloadShape)
from repro_torch.dist import mesh as dmesh
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps as dsteps
from repro_torch.dist.actsharding import activation_sharding
from repro_torch.models import moe
from repro_torch.models import params as P
from repro_torch.train import Trainer

WORLD = 4
TIMEOUT = timedelta(seconds=120)
YI, GRANITE, WHISPER = "yi-6b", "granite-moe-1b-a400m", "whisper-base"
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-1.3b"
# float32 compute isolates the placement from bf16 noise.  The learning
# rate is 1e-3 for the int8 runs' sake: AdamW's first step moves every
# weight by about lr whatever its gradient, so a near-zero gradient
# element whose int8 rounding flipped its sign moves its weight 2 lr the
# other way; at 1e-3 those flips move the next loss and grad norm by less
# than int8's 1e-2 (at 1e-2 granite's moved by 5%).  A wrong gradient
# still moves a weight by ~lr, ten times the float32 runs' 1e-4
TCFG = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=0,
                   compute_dtype="float32")
SHAPE = WorkloadShape("tp", "train", 16, 8)
N_STEPS = 2
HIER = ShardingStrategy(name="hier-moe", tensor_parallel=True,
                        expert_parallel=True, hierarchical_moe=True,
                        hierarchical_collectives=True)
HIER_INT8 = dataclasses.replace(HIER, name="hier-moe-int8",
                                compress_cross_pod=True, compress_pods=2,
                                compress_block=64)
# (name, arch, mesh, strategy, train config) of each train scenario
OPTIMIZED_INT8 = dataclasses.replace(OPTIMIZED, name="optimized-int8",
                                     compress_cross_pod=True,
                                     compress_pods=2, compress_block=64)
RUNS = (("yi_baseline", YI, "dm", BASELINE, TCFG),
        ("yi_optimized", YI, "dm", OPTIMIZED, TCFG),
        ("yi_zero3", YI, "d4", ZERO3, TCFG),
        # without tensor parallelism the model axis takes batch rows too
        ("yi_zero3_dm", YI, "dm", ZERO3, TCFG),
        # FSDP under a pod tier: the pod phase of the sync alone
        ("yi_optimized_pod", YI, "pd", OPTIMIZED, TCFG),
        ("yi_optimized_pod_int8", YI, "pd", OPTIMIZED_INT8, TCFG),
        ("granite_baseline", GRANITE, "dm", BASELINE, TCFG),
        # experts over a model axis whose ranks take other rows: gathered
        ("granite_zero3_dm", GRANITE, "dm", ZERO3, TCFG),
        ("granite_hier", GRANITE, "pdm", HIER, TCFG),
        ("granite_hier_int8", GRANITE, "pdm", HIER_INT8, TCFG),
        # the encoder and cross-attention on local heads, and gathered
        ("whisper_baseline", WHISPER, "dm", BASELINE, TCFG),
        ("whisper_zero3", WHISPER, "d4", ZERO3, TCFG),
        # the sequence mixers on local channels and heads: jamba's Mamba
        # channels over model 2 (and FSDP over data), xlstm's mLSTM one
        # head a rank on model 4 and its sLSTM recurrence whole
        ("jamba_baseline", JAMBA, "dm", BASELINE, TCFG),
        ("jamba_optimized", JAMBA, "dm", OPTIMIZED, TCFG),
        ("xlstm_baseline", XLSTM, "m4", BASELINE, TCFG))
# the mixer blocks run alone on ranks (``_blocks``): rows x tokens
BLOCK_X = (2, 11)
# (arch, config fields replaced, block kind) of each block case: the
# SMOKE configs' blocks, and two whose channels (d_in 130) or heads (2)
# ``model`` 4 does not divide, which compute whole there
BLOCKS = {"mamba": (JAMBA, {}, "mamba"), "mlstm": (XLSTM, {}, "mlstm"),
          "slstm": (XLSTM, {}, "slstm"),
          "mamba_whole": (JAMBA, {"d_model": 65}, "mamba"),
          "mlstm_whole": (XLSTM, {"xlstm": dict(n_heads=2)}, "mlstm")}


def block_cfg(case):
    """(config, block kind) of a ``BLOCKS`` case."""
    arch, fields, kind = BLOCKS[case]
    cfg = registry.smoke(arch)
    fields = {k: dataclasses.replace(getattr(cfg, k), **v)
              if isinstance(v, dict) else v for k, v in fields.items()}
    return dataclasses.replace(cfg, **fields), kind
# capacity factors of the exchange's byte count (1.0: E * C = M * k)
A2A_CF = (1.0, 1.25)
A2A_X = (4, 16)             # groups x tokens of the exchange's input


def _np_whole(tree, specs, mesh):
    """The tree's leaves gathered whole, as numpy, on rank 0 (None
    elsewhere); a collective."""
    out = P.tree_map(lambda t: None, tree)
    leaves = [shd.gather(t.detach(), s, mesh).float().numpy().copy()
              for t, s in zip(P.tree_leaves(tree), P.tree_leaves(specs))]
    return P.tree_unflatten(out, leaves) if mesh.rank == 0 else None


def _shard_tree(full, specs, mesh):
    return P.tree_unflatten(full, [
        shd.shard(t, s, mesh) for t, s in zip(P.tree_leaves(full),
                                              P.tree_leaves(specs))])


def _history(tr):
    return [{k: h[k] for k in ("loss", "xent", "moe_aux", "grad_norm")}
            for h in tr.history]


def _state_shapes(tr):
    return {"params": P.tree_map(lambda t: tuple(t.shape),
                                 tr.state["params"]),
            "opt": P.tree_map(lambda t: tuple(t.shape), tr.state["opt"])}


def _train(mesh, arch, strategy, tcfg, params):
    """N_STEPS from the JAX package's initial parameters (numpy, whole):
    the history, the warnings, the local state shapes and the updated
    parameters gathered whole."""
    cfg = registry.smoke(arch)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = Trainer(cfg, tcfg, SHAPE, mesh=mesh, strategy=strategy,
                     device="cpu")
    n_warn = sum(issubclass(x.category, comm.CommFallbackWarning)
                 for x in w)
    tr.init_or_resume()
    specs = dsteps.train_state_shardings(cfg, strategy, mesh)
    tr.state["params"] = _shard_tree(P.from_numpy(params), specs["params"],
                                     mesh)
    shapes = _state_shapes(tr)
    collectives.reset_counters()
    tr.run(N_STEPS, log_every=0)
    return {"history": _history(tr), "warnings": n_warn, "shapes": shapes,
            "bytes": dict(collectives.PAYLOAD_BYTES),
            "params": _np_whole(tr.state["params"], specs["params"], mesh)}


def _a2a(mesh, inputs):
    """granite's MoE layer under hierarchical dispatch on (pod 2, data 1,
    model 2), forward only: this rank's rows of the output and the
    bytes its exchange handed to the ``pod`` group, per capacity
    factor."""
    base = registry.smoke(GRANITE)
    g, m = A2A_X
    out = {}
    for cf in A2A_CF:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        specs = shd.tree_shardings(moe.moe_defs(cfg), mesh,
                                   shd.param_rules(HIER))
        p = _shard_tree(P.from_numpy(inputs["moe_params"]), specs, mesh)
        rows = g // mesh.shape["pod"]
        lo = mesh.coords["pod"] * rows
        x = torch.from_numpy(inputs["moe_x"][lo:lo + rows])
        collectives.reset_counters()
        with torch.no_grad(), activation_sharding(mesh, HIER,
                                                  global_rows=g):
            y, aux = moe.moe_apply(cfg, p, x)
        out[cf] = {"rows": (lo, lo + rows), "out": y.numpy().copy(),
                   "dropped": float(aux["moe_dropped_frac"]),
                   "pod_bytes": collectives.PAYLOAD_BYTES.get("pod", 0)}
    return out


def _blocks(meshes, inputs):
    """Each sequence-mixer block (``inputs["blocks"]``: ``BLOCKS`` case
    -> (whole params, x, the output's cotangent), float32) on (data 2,
    model 2) and (data 1, model 4), every rank on the same rows: the output,
    the input's gradient and every parameter's gradient gathered whole,
    and the ``model`` bytes; and ``layers.split_halves`` alone on
    ``inputs["halves"]`` (each rank's contiguous columns of it), its
    output and its input's gradient.  Rank 0's (None elsewhere)."""
    from repro_torch.models import layers, transformer
    out = {}
    for mname in ("dm", "m4"):
        mesh = meshes[mname]
        for case, (full, x, dy) in inputs["blocks"].items():
            cfg, kind = block_cfg(case)
            defs = transformer.position_defs(
                cfg, cfg.block_pattern.index(kind))[kind]
            specs = shd.tree_shardings(defs, mesh, shd.param_rules(BASELINE))
            p = P.tree_map(lambda t: t.requires_grad_(True),
                           _shard_tree(P.from_numpy(full), specs, mesh))
            xt = torch.from_numpy(x).requires_grad_(True)
            collectives.reset_counters()
            with activation_sharding(mesh, BASELINE):
                y, _ = transformer.MIXERS[kind](cfg, p, xt)
            (y * torch.from_numpy(dy)).sum().backward()
            grads = _np_whole(P.tree_map(lambda t: t.grad, p), specs, mesh)
            if mesh.rank == 0:
                out[(mname, case)] = {
                    "y": y.detach().numpy().copy(),
                    "dx": xt.grad.numpy().copy(), "grads": grads,
                    "model_bytes": collectives.PAYLOAD_BYTES.get("model",
                                                                 0)}
        whole, dy = (torch.from_numpy(t) for t in inputs["halves"])
        spec = (None, None, "model")
        xz = shd.shard(whole, spec, mesh).requires_grad_(True)
        collectives.reset_counters()
        u, z = layers.split_halves(xz, mesh)
        (torch.cat([u, z], -1) * shd.shard(dy, spec, mesh)).sum().backward()
        moved = collectives.PAYLOAD_BYTES.get("model", 0)
        got = {"uz": torch.cat([u, z], -1).detach(), "grad": xz.grad}
        got = {k: shd.gather(v, spec, mesh).numpy().copy()
               for k, v in got.items()}
        if mesh.rank == 0:
            out[(mname, "halves")] = dict(got, model_bytes=moved)
    return out


def _checkpoint(meshes, params, ckpt_dir):
    """yi on (data 2, model 2): 2 steps, a checkpoint, 2 more (the
    uninterrupted run); then a Trainer on (data 4, model 1) restores
    step 2 and takes the same 2 steps; and ``Trainer.remesh`` (data 2,
    model 2) -> (data 4, model 1) at step 2, through the checkpoint and
    through host memory."""
    cfg = registry.smoke(YI)
    dm, d4 = meshes["dm"], meshes["d4"]

    def fresh(mesh, ckpt):
        tr = Trainer(cfg, TCFG, SHAPE, mesh=mesh, strategy=BASELINE,
                     ckpt_dir=ckpt, device="cpu")
        tr.init_or_resume()
        specs = dsteps.train_state_shardings(cfg, BASELINE, mesh)
        tr.state["params"] = _shard_tree(P.from_numpy(params),
                                         specs["params"], mesh)
        return tr

    whole = fresh(dm, os.path.join(ckpt_dir, "whole"))
    whole.run(2, ckpt_every=2, log_every=0)
    whole.run(2, log_every=0)
    other = Trainer(cfg, TCFG, SHAPE, mesh=d4, strategy=BASELINE,
                    ckpt_dir=os.path.join(ckpt_dir, "whole"), device="cpu")
    how = other.init_or_resume()
    other.run(2, log_every=0)
    out = {"whole": _history(whole), "restored": _history(other),
           "how": how, "start": other.history[0]["step"]}
    for name, ckpt in (("remesh_ckpt", os.path.join(ckpt_dir, "remesh")),
                       ("remesh_host", None)):
        tr = fresh(dm, ckpt)
        tr.run(2, log_every=0)
        tr.remesh(d4)
        tr.run(2, log_every=0)
        out[name] = _history(tr)[2:]
        out[name + "_shapes"] = _state_shapes(tr)
    return out


def run_rank(rank, init_file, inputs_file, ckpt_dir, queue):
    """``inputs_file``: a pickle of the inputs (the JAX package's
    parameters), read here: passed in the process's arguments they would
    hold its parent until the child had imported torch to unpickle
    them, one child at a time."""
    torch.set_num_threads(2)
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    try:
        with open(inputs_file, "rb") as f:
            inputs = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD,
                                timeout=TIMEOUT)
        try:
            meshes = {
                "dm": dmesh.make_mesh((2, 2), ("data", "model"),
                                      timeout=TIMEOUT),
                "d4": dmesh.make_mesh((4, 1), ("data", "model"),
                                      timeout=TIMEOUT),
                "pdm": dmesh.make_mesh((2, 1, 2), ("pod", "data", "model"),
                                       timeout=TIMEOUT),
                "pd": dmesh.make_mesh((2, 2, 1), ("pod", "data", "model"),
                                      timeout=TIMEOUT),
                "m4": dmesh.make_mesh((1, 4), ("data", "model"),
                                      timeout=TIMEOUT)}
            res = {"rank": rank,
                   "coords": {k: m.coords for k, m in meshes.items()}}
            for name, arch, mesh, strategy, tcfg in RUNS:
                res[name] = _train(meshes[mesh], arch, strategy, tcfg,
                                   inputs["params"][arch])
            res["a2a"] = _a2a(meshes["pdm"], inputs)
            res["blocks"] = _blocks(meshes, inputs)
            res["checkpoint"] = _checkpoint(meshes, inputs["params"][YI],
                                            ckpt_dir)
        finally:
            dist.destroy_process_group()
        queue.put(res)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise
