"""AdamW and (factored) Adafactor for the port's single-device trainer.

State schemas are PDef trees derived from the model's PDef tree, with
the JAX package's key names, shapes and dtypes (``m``/``v``;
``vr``/``vc``), so a checkpoint's optimizer state carries across.  The
arithmetic is the JAX package's, leaf by leaf in float32: global-norm
clipping, then the update with weight decay on every leaf.

Unlike the JAX optimizers, which return new trees, ``update`` writes
the new parameters and state into the given tensors: at yi-6b's width
the float32 parameters alone are gigabytes, and a second copy of them
and of the state would not fit beside the first.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import params as P
from repro_torch.models.params import PDef
from repro_torch.optim.schedules import lr_schedule

# ---------------------------------------------------------------------------
# State schemas
# ---------------------------------------------------------------------------


def _adamw_defs(model_defs, dtype: str):
    # zeros whatever the leaf's own init (a named custom init included)
    zero = lambda d: dataclasses.replace(d, init="zeros", custom=None,
                                         dtype=dtype)
    return {"m": P.tree_map(zero, model_defs),
            "v": P.tree_map(zero, model_defs)}


def _adafactor_defs(model_defs, dtype: str):
    def row(d: PDef):
        if len(d.shape) < 2:
            return dataclasses.replace(d, init="zeros", custom=None,
                                       dtype=dtype)
        return PDef(d.shape[:-1], d.axes[:-1], init="zeros", dtype=dtype)

    def col(d: PDef):
        if len(d.shape) < 2:
            # unfactored vectors keep their second moment in vr; a
            # one-element vc keeps the tree structure uniform
            return PDef((1,), (None,), init="zeros", dtype=dtype)
        return PDef(d.shape[:-2] + d.shape[-1:], d.axes[:-2] + d.axes[-1:],
                    init="zeros", dtype=dtype)

    return {"vr": P.tree_map(row, model_defs),
            "vc": P.tree_map(col, model_defs)}


def opt_state_defs(cfg: ModelConfig, model_defs):
    dtype = cfg.opt_state_dtype
    if cfg.optimizer == "adafactor":
        return _adafactor_defs(model_defs, dtype)
    return _adamw_defs(model_defs, dtype)


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------


def _global_norm(leaves):
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-30)


def _store(dst, value):
    """Write ``value`` into ``dst`` unless it already is ``dst`` (a
    float32 leaf updated in place)."""
    if value is not dst:
        dst.copy_(value)


def make_optimizer(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``update(grads, opt_state, params, step) -> (params,
    opt_state, stats)``; params and state are updated in place and
    returned, ``grads`` are consumed (clipped in place)."""

    def lr_at(step):
        return lr_schedule(step, base_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)

    def clip(grads):
        leaves = [g.float() for g in P.tree_leaves(grads)]
        gnorm = _global_norm(leaves)
        scale = torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
        for g in leaves:
            g.mul_(scale)
        return leaves, gnorm

    if cfg.optimizer == "adafactor":
        def upd(g, vr, vc, p, lr):
            d = 1e-30
            g2 = g * g + d
            if g.dim() >= 2:
                vr1 = 0.999 * vr.float() + 0.001 * g2.mean(-1)
                vc1 = 0.999 * vc.float() + 0.001 * g2.mean(-2)
                denom = (vr1[..., None] / (vr1.mean(-1, keepdim=True)[..., None]
                                           + d)) * vc1[..., None, :]
                u = g * torch.rsqrt(denom + d)
            else:
                vr1 = 0.999 * vr.float() + 0.001 * g2
                vc1 = vc.float()
                u = g * torch.rsqrt(vr1 + d)
            u = u / torch.clamp(_rms(u), min=1.0)      # relative step clip
            p32 = p.float()
            p1 = p32 - lr * u - lr * tcfg.weight_decay * p32
            _store(vr, vr1)
            _store(vc, vc1)
            _store(p, p1)

        def update(grads, state, params, step):
            leaves, gnorm = clip(grads)
            lr = lr_at(step)
            for g, vr, vc, p in zip(leaves, P.tree_leaves(state["vr"]),
                                    P.tree_leaves(state["vc"]),
                                    P.tree_leaves(params)):
                upd(g, vr, vc, p, lr)
            return params, state, {"grad_norm": gnorm, "lr": lr}
        return update

    def upd(g, m, v, p, lr, bc1, bc2):              # AdamW
        m1 = m.float().mul_(tcfg.b1).add_(g, alpha=1 - tcfg.b1)
        v1 = v.float().mul_(tcfg.b2).addcmul_(g, g, value=1 - tcfg.b2)
        u = (m1 / bc1).div_(torch.sqrt(v1 / bc2).add_(1e-8))
        p32 = p.float()
        p32.sub_(u.add_(p32, alpha=tcfg.weight_decay).mul_(lr))
        _store(m, m1)
        _store(v, v1)
        _store(p, p32)

    def update(grads, state, params, step):
        leaves, gnorm = clip(grads)
        lr = lr_at(step)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        bc1 = 1 - tcfg.b1 ** t
        bc2 = 1 - tcfg.b2 ** t
        for g, m, v, p in zip(leaves, P.tree_leaves(state["m"]),
                              P.tree_leaves(state["v"]),
                              P.tree_leaves(params)):
            upd(g, m, v, p, lr, bc1, bc2)
        return params, state, {"grad_norm": gnorm, "lr": lr}
    return update
