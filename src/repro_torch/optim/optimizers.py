"""AdamW and (factored) Adafactor for the port's single-device trainer.

State schemas are PDef trees derived from the model's PDef tree, with
the JAX package's key names, shapes and dtypes (``m``/``v``;
``vr``/``vc``), so a checkpoint's optimizer state carries across.  The
arithmetic is the JAX package's, in float32: global-norm clipping, then
the update with weight decay on every leaf (Adafactor's means taken as
sums over the whole dims, so that a shard's sums can be all-reduced).

Unlike the JAX optimizers, which return new trees, ``update`` writes
the new parameters and state into the given tensors: at yi-6b's width
the float32 parameters alone are gigabytes, and a second copy of them
and of the state would not fit beside the first.
"""
from __future__ import annotations

import dataclasses
import math

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


def _global_norm(leaves, axes=None, mesh=None):
    """The global norm.  On a mesh of ranks each leaf is this rank's
    shard and ``axes[i]`` the mesh axes that shard leaf i: its squares
    are summed over those axes (one all-reduce for each distinct tuple,
    in sorted order on every rank), so each element counts once."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    from repro_torch.comm import collectives as coll
    by_axes = {}
    for g, ax in zip(leaves, axes):
        by_axes.setdefault(tuple(ax), []).append(
            torch.sum(torch.square(g.float())))
    total = 0.0
    for ax in sorted(by_axes):
        part = torch.stack(by_axes[ax]).sum().reshape(1)
        total = total + coll.sum_over(part, mesh, ax)
    return torch.sqrt(total).reshape(())


# ---------------------------------------------------------------------------
# Adafactor's factored moments by shard (on a mesh of ranks)
# ---------------------------------------------------------------------------


def _live(entry, mesh):
    """The axes of a spec entry that split a dim on ``mesh`` (size > 1;
    none without a mesh)."""
    if mesh is None:
        return ()
    from repro_torch.dist.sharding import entry_axes
    return tuple(a for a in entry_axes(entry) if mesh.shape.get(a, 1) > 1)


def _sum_groups(parts, mesh):
    """Each ``(tensor, axes)`` of ``parts`` summed over its mesh axes:
    one all-reduce for each distinct axes tuple, in sorted order on every
    rank (the tensors of a tuple flattened into one payload).  Returns
    the sums in the order given."""
    from repro_torch.comm import collectives as coll
    out = [t for t, _ in parts]
    by_axes = {}
    for i, (t, ax) in enumerate(parts):
        if ax:
            by_axes.setdefault(tuple(ax), []).append(i)
    for ax in sorted(by_axes):
        idx = by_axes[ax]
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        coll.sum_over(flat, mesh, ax)
        for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = piece.view_as(out[i])
    return out


def _extra(moment, param, mesh):
    """The axes that split a dim of a moment beyond its parameter's: the
    moment's entry extends the parameter's (``opt_rules`` refine
    ``param_rules``), so its shard is a slice of the parameter's."""
    m, p = _live(moment, mesh), _live(param, mesh)
    if m[:len(p)] != p:
        raise NotImplementedError(f"a moment split over {m} does not "
                                  f"refine its parameter's {p}")
    return m[len(p):]


def _widen(x, have, want, mesh):
    """``x``, a moment's shard laid out by spec ``have``, as the shard of
    its parameter's spec ``want``: an all-gather over each dim's extra
    axes (a collective: every rank of the mesh calls it)."""
    from repro_torch.comm.collectives import gather_along
    for dim, (h, w) in enumerate(zip(have, want)):
        for a in reversed(_extra(h, w, mesh)):
            x = gather_along(x, dim, mesh, a)
    return x


def _narrow(x, have, want, mesh):
    """The inverse of :func:`_widen`: ``x`` (laid out by its parameter's
    spec ``have``) cut to this rank's shard of the moment's spec
    ``want``."""
    from repro_torch.comm.collectives import slice_along
    for dim, (h, w) in enumerate(zip(have, want)):
        for a in _extra(w, h, mesh):
            x = slice_along(x, dim, mesh, a)
    return x.contiguous()


def _whole_shape(shape, spec, mesh):
    """The whole leaf's size along each dim, from a shard's ``shape``."""
    from repro_torch.dist.mesh import axis_size
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return [n * axis_size(mesh, _live(e, mesh)) for n, e in zip(shape, spec)]


def _store(dst, value):
    """Write ``value`` into ``dst`` unless it already is ``dst`` (a
    float32 leaf updated in place)."""
    if value is not dst:
        dst.copy_(value)


def make_optimizer(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``update(grads, opt_state, params, step, norm_axes=None,
    mesh=None, specs=None) -> (params, opt_state, stats)``; params and
    state are updated in place and returned, ``grads`` are consumed
    (clipped in place; Adafactor forms its update in them).  On a mesh of ranks every leaf is this rank's
    shard and ``norm_axes`` holds each leaf's sharding axes, for the
    global norm.  AdamW's gradient, parameter and moments are shards of
    one spec.  Adafactor's factored moments have specs of their own:
    ``specs`` gives each leaf's (parameter, ``vr``, ``vc``) specs, the
    gradient and parameter being the parameter's shard, and each moment
    is reduced over the mesh axes that split the dims it averages."""

    def lr_at(step):
        return lr_schedule(step, base_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)

    def clip(grads, norm_axes, mesh):
        leaves = [g.float() for g in P.tree_leaves(grads)]
        gnorm = _global_norm(leaves, norm_axes, mesh)
        scale = torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
        for g in leaves:
            g.mul_(scale)
        return leaves, gnorm

    if cfg.optimizer == "adafactor":
        def update(grads, state, params, step, norm_axes=None, mesh=None,
                   specs=None):
            """Each leaf's factored moments, widened from their own
            shards to the parameter's (``_widen``), updated there and cut
            back (``_narrow``); each mean a sum over the mesh axes that
            split the dim it averages (``_sum_groups``, a pass at a time)
            over the whole dim's size.  Without ``specs`` (one device)
            every sum is local.  The update is formed in place in each
            clipped gradient, so no second float32 copy of the leaves
            is held."""
            leaves, gnorm = clip(grads, norm_axes, mesh)
            lr = lr_at(step)
            vrs, vcs = P.tree_leaves(state["vr"]), P.tree_leaves(state["vc"])
            ps = P.tree_leaves(params)
            if specs is None:
                specs = [((), (), ())] * len(leaves)
            d = 1e-30
            plans, sums = [], []
            for g, (sp, _, _) in zip(leaves, specs):
                sp = tuple(sp) + (None,) * (g.dim() - len(sp))
                plans.append((sp, _whole_shape(g.shape, sp, mesh)))
                if g.dim() >= 2:
                    g2 = g * g + d
                    sums += [(g2.sum(-1), _live(sp[-1], mesh)),
                             (g2.sum(-2), _live(sp[-2], mesh))]
            sums = iter(_sum_groups(sums, mesh))
            vr1s, vc1s, means = [], [], []
            for g, vr, vc, (_, rs, cs), (sp, whole) in zip(
                    leaves, vrs, vcs, specs, plans):
                if g.dim() >= 2:
                    vr1 = (0.999 * _widen(vr, rs, sp[:-1], mesh).float()
                           + 0.001 * next(sums) / whole[-1])
                    vc1 = (0.999 * _widen(vc, cs, sp[:-2] + sp[-1:],
                                          mesh).float()
                           + 0.001 * next(sums) / whole[-2])
                    means.append((vr1.sum(-1, keepdim=True),
                                  _live(sp[-2], mesh)))
                else:
                    vr1 = (0.999 * _widen(vr, rs, sp, mesh).float()
                           + 0.001 * (g * g + d))
                    vc1 = vc
                vr1s.append(vr1)
                vc1s.append(vc1)
            means = iter(_sum_groups(means, mesh))
            squares = []
            for g, vr1, vc1, (sp, whole) in zip(leaves, vr1s, vc1s, plans):
                if g.dim() >= 2:
                    mean = next(means) / whole[-2]
                    g.mul_(torch.rsqrt((vr1[..., None] / (mean[..., None] + d))
                                       * vc1[..., None, :] + d))
                else:
                    g.mul_(torch.rsqrt(vr1 + d))
                squares.append((torch.square(g).sum().reshape(1),
                                tuple(a for e in sp for a in _live(e, mesh))))
            squares = _sum_groups(squares, mesh)
            for u, vr, vc, p, sq, vr1, vc1, (sp, whole), (_, rs, cs) in zip(
                    leaves, vrs, vcs, ps, squares, vr1s, vc1s, plans, specs):
                rms = torch.sqrt(sq[0] / math.prod(whole) + 1e-30)
                u.div_(torch.clamp(rms, min=1.0))   # relative step clip
                p32 = p.float()
                _store(p, p32 - lr * u - lr * tcfg.weight_decay * p32)
                if u.dim() >= 2:
                    _store(vr, _narrow(vr1, sp[:-1], rs, mesh))
                    _store(vc, _narrow(vc1, sp[:-2] + sp[-1:], cs, mesh))
                else:
                    _store(vr, _narrow(vr1, sp, rs, mesh))
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

    def update(grads, state, params, step, norm_axes=None, mesh=None,
               specs=None):
        leaves, gnorm = clip(grads, norm_axes, mesh)
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
