"""The single-device train step: the port of the JAX package's
``dist/steps.py`` train-state schema, init and step builder.

Train state is a plain dict ``{"params", "opt", "step"}`` with PDef
schemas behind it, as in the JAX package, so the checkpoint manager can
build templates and a checkpoint carries across both packages.  There is
no mesh, sharding strategy or comm residual yet: one device holds the
whole state.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig, WorkloadShape
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, opt_state_defs

METRIC_KEYS = ("loss", "xent", "moe_aux")


def train_state_defs(cfg: ModelConfig) -> Dict:
    model_defs = Model(cfg).param_defs()
    return {"params": model_defs, "opt": opt_state_defs(cfg, model_defs)}


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> Dict:
    """Shapes and dtypes of the train state, as ``meta`` tensors."""
    defs = train_state_defs(cfg)
    return {"params": P.abstract_params(defs["params"],
                                        P.DTYPES[tcfg.param_dtype]),
            "opt": P.abstract_params(defs["opt"]),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Dict:
    """Random parameters from ``generator`` (default: seeded with
    ``tcfg.seed`` on the device), zero optimizer state, step 0.  Runs on
    CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    defs = train_state_defs(cfg)
    return {"params": P.init_params(defs["params"], generator,
                                    P.DTYPES[tcfg.param_dtype], device),
            "opt": P.init_params(defs["opt"], generator, torch.float32,
                                 device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     shape: WorkloadShape):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) on the state's
    device; metrics are float32 scalars (loss, xent, moe_aux, grad_norm,
    lr).  With ``tcfg.grad_accum > 1`` the batch is cut into that many
    microbatches of consecutive rows whose float32 gradients and metrics
    are averaged.  The state is updated in place (see ``optim``) and
    returned.  The kernels or their plain versions run by the state's
    device (``kernels/ops``)."""
    model = Model(cfg)
    update = make_optimizer(cfg, tcfg)
    cdt = P.DTYPES[tcfg.compute_dtype]
    ga = max(tcfg.grad_accum, 1)
    if ga > 1:
        assert shape.global_batch % ga == 0, (shape.global_batch, ga)

    def grads_and_metrics(params, leaves, mb):
        loss, metrics = model.loss(params, mb, remat=tcfg.remat,
                                   compute_dtype=cdt)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: metrics[k].detach().float()
                             for k in METRIC_KEYS}

    def step_fn(state, batch):
        params = state["params"]
        leaves = P.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if ga == 1:
            grads, metrics = grads_and_metrics(params, leaves, batch)
        else:
            n = next(iter(batch.values())).shape[0] // ga
            grads, metrics = None, None
            for i in range(ga):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, m = grads_and_metrics(params, leaves, mb)
                if grads is None:
                    grads, metrics = [x.float() for x in g], m
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x.float())
                    metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
            for g in grads:
                g.div_(ga)
            metrics = {k: v / ga for k, v in metrics.items()}
        with torch.no_grad():
            _, _, stats = update(P.tree_unflatten(params, grads), state["opt"],
                                 params, state["step"])
            state["step"] += 1
        return state, dict(metrics, grad_norm=stats["grad_norm"],
                           lr=stats["lr"])

    return step_fn
