"""The train step: the port of the JAX package's ``dist/steps.py``
train-state schema, init and train step.

Train state is a plain dict ``{"params", "opt", "step"}`` (plus
``"comm"`` under a compressing strategy) with PDef schemas behind it,
as in the JAX package, so the checkpoint manager can build templates
and a checkpoint carries across both packages.

On a mesh of one rank the step runs the whole batch on one device.  On
a mesh of several ranks (``dist.mesh``: ``pod`` and ``data`` axes, each
rank holding the whole model) every rank runs the same step on its own
rows and the gradients are synced: through the comm layer's two-phase
``sync_grads`` when the strategy asks for it and the mesh has a pod
tier, through one flat all-reduce mean otherwise.  Tensor parallelism
and FSDP wait for a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import comm
from repro_torch.configs.base import (BASELINE, ModelConfig,
                                      ShardingStrategy, TrainConfig,
                                      WorkloadShape)
from repro_torch.device import resolve_device
from repro_torch.dist import mesh as dmesh
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, opt_state_defs

METRIC_KEYS = ("loss", "xent", "moe_aux")


def train_state_defs(cfg: ModelConfig,
                     strategy: Optional[ShardingStrategy] = None) -> Dict:
    """State schema.  A strategy with ``compress_cross_pod`` adds the
    comm layer's error-feedback residual under ``comm/ef``, schema'd by
    (cfg, strategy) alone, never by the live mesh."""
    model_defs = Model(cfg).param_defs()
    defs = {"params": model_defs, "opt": opt_state_defs(cfg, model_defs)}
    if strategy is not None and strategy.compress_cross_pod:
        defs["comm"] = {"ef": comm.ef_defs(model_defs, strategy)}
    return defs


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                         strategy: Optional[ShardingStrategy] = None) -> Dict:
    """Shapes and dtypes of the whole train state, as ``meta`` tensors
    (the residual with all its ``(pods, ...)`` rows, as a checkpoint
    holds it)."""
    defs = train_state_defs(cfg, strategy)
    out = {"params": P.abstract_params(defs["params"],
                                       P.DTYPES[tcfg.param_dtype]),
           "opt": P.abstract_params(defs["opt"]),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    if "comm" in defs:
        out["comm"] = P.abstract_params(defs["comm"])
    return out


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None, *,
                     strategy: Optional[ShardingStrategy] = None,
                     mesh: Optional[dmesh.Mesh] = None) -> Dict:
    """Random parameters from ``generator`` (default: seeded with
    ``tcfg.seed`` on the device), zero optimizer state, step 0, and a
    zero residual: the rows of it that a rank of ``mesh`` holds
    (``comm.ef_rows``).  Runs on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    defs = train_state_defs(cfg, strategy)
    out = {"params": P.init_params(defs["params"], generator,
                                   P.DTYPES[tcfg.param_dtype], device),
           "opt": P.init_params(defs["opt"], generator, torch.float32,
                                device),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    if "comm" in defs:
        rows = comm.ef_rows(mesh, strategy.compress_pods)
        out["comm"] = P.tree_map(lambda d: torch.zeros(
            (rows.stop - rows.start,) + d.shape[1:], dtype=torch.float32,
            device=device), defs["comm"])
    return out


def _row_bounds(rows: int, world: int):
    """Rows ``[b[r], b[r+1])`` of a microbatch of ``rows`` go to rank r."""
    return [rows * r // world for r in range(world + 1)]


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     shape: WorkloadShape, *,
                     strategy: ShardingStrategy = BASELINE,
                     mesh: Optional[dmesh.Mesh] = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``batch`` holds the GLOBAL batch's ``tokens`` and ``labels`` (B, S),
    and an encoder-decoder's ``frames`` or a vision frontend's
    ``patches`` (B, ..., d_model), on the state's device, the same on
    every rank; every entry is cut by rows alike; metrics are float32
    scalars (loss, xent, moe_aux, grad_norm, lr), the same on every rank.
    With ``tcfg.grad_accum > 1`` the batch is cut into that many
    microbatches of consecutive rows whose float32 gradients and metrics
    are averaged.  On a mesh of n ranks rank r takes rows ``[r*b,
    (r+1)*b)`` of each microbatch of n*b rows — chunk (microbatch, rank)
    in the JAX package's ``(accum, pod, data)`` order, ranks pod-major —
    and the ranks' gradients are synced before the update:

    * through ``comm.sync_grads`` (``comm.sync_grads_bucketed`` with
      ``strategy.comm_buckets > 1``) when ``comm.resolve_policy`` says
      hierarchical — two-phase, optionally with int8 error feedback on
      the cross-pod hop, the residual carried in ``state["comm"]``;
    * otherwise through one flat all-reduce over every rank, each
      rank's share weighted by its rows (a batch that does not divide
      over the ranks splits as evenly as it can).

    The state is updated in place (see ``optim``) and returned.  The
    kernels or their plain versions run by the state's device
    (``kernels/ops``).  Every block kind trains: a Mamba position through
    ``models.mamba.SelectiveScan``'s recompute backward, mLSTM and sLSTM
    by autograd."""
    mesh = mesh if mesh is not None else dmesh.make_mesh((1,), ("data",))
    model = Model(cfg)
    update = make_optimizer(cfg, tcfg)
    cdt = P.DTYPES[tcfg.compute_dtype]
    ga = max(tcfg.grad_accum, 1)
    if shape.global_batch % ga:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"divide into grad_accum={ga} microbatches")
    dp_world = dmesh.axis_size(mesh, dmesh.data_axes(mesh))
    if dp_world != mesh.size:
        raise NotImplementedError(
            f"mesh {mesh.shape}: only the data-parallel axes {dmesh.DATA_AXES}"
            " may exceed size 1 (tensor parallelism is not ported)")

    policy = comm.resolve_policy(strategy, mesh)
    n_chunks = ga * dp_world
    if policy.hierarchical and shape.global_batch % n_chunks != 0:
        comm.degrade(strategy, f"global batch {shape.global_batch} does "
                     f"not divide into {n_chunks} chunks "
                     f"(grad_accum={ga} x dp={dp_world})", mesh=mesh)
        policy = comm.CommPolicy()
    mb_rows = shape.global_batch // ga
    bounds = _row_bounds(mb_rows, mesh.size)
    lo, hi = bounds[mesh.rank], bounds[mesh.rank + 1]
    if hi == lo:
        raise ValueError(f"a microbatch of {mb_rows} rows leaves rank "
                         f"{mesh.rank} of {mesh.size} none")
    weight = (hi - lo) / mb_rows              # this rank's share of a mean
    defs = model.param_defs()

    def grads_and_metrics(params, leaves, mb):
        loss, metrics = model.loss(params, mb, remat=tcfg.remat,
                                   compute_dtype=cdt)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: metrics[k].detach().float()
                             for k in METRIC_KEYS}

    def local_grads(params, leaves, batch):
        """This rank's rows of every microbatch: float32 gradients and
        metrics, averaged over the microbatches."""
        if ga == 1 and mesh.size == 1:
            return grads_and_metrics(params, leaves, batch)
        grads, metrics = None, None
        for i in range(ga):
            a, b = i * mb_rows + lo, i * mb_rows + hi
            mb = {k: v[a:b] for k, v in batch.items()}
            g, m = grads_and_metrics(params, leaves, mb)
            if grads is None:
                grads, metrics = [x.float() for x in g], m
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
        if ga > 1:
            for g in grads:
                g.div_(ga)
            metrics = {k: v / ga for k, v in metrics.items()}
        return grads, metrics

    def step_fn(state, batch):
        params = state["params"]
        leaves = P.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads, metrics = local_grads(params, leaves, batch)
        with torch.no_grad():
            if mesh.size > 1:
                m = torch.stack([metrics[k] for k in METRIC_KEYS]) * weight
                comm.collectives.all_reduce_sum(m, mesh)
                metrics = dict(zip(METRIC_KEYS, m.unbind()))
            if policy.hierarchical:
                residual = (state["comm"]["ef"]
                            if policy.compress and "comm" in state else None)
                # one sync per bucket, reverse-layer order, when asked
                sync = (comm.sync_grads_bucketed if policy.buckets > 1
                        else comm.sync_grads)
                stacked = P.tree_unflatten(params, [g[None] for g in grads])
                synced, new_ef = sync(stacked, defs, mesh, policy, strategy,
                                      residual=residual)
                grads = P.tree_leaves(synced)
                if residual is not None:
                    state["comm"]["ef"] = new_ef
            elif mesh.size > 1:
                for g in grads:
                    comm.collectives.all_reduce_sum(g.mul_(weight), mesh)
            _, _, stats = update(P.tree_unflatten(params, grads), state["opt"],
                                 params, state["step"])
            state["step"] += 1
        return state, dict(metrics, grad_norm=stats["grad_norm"],
                           lr=stats["lr"])

    return step_fn
