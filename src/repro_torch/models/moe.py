"""Mixture-of-experts FFN: token-choice top-k routing, capacity dispatch.

The port of the JAX package's ``models/moe.py``.  Dispatch and combine
are gathers (slot positions from a cumulative sum, no one-hot einsum);
the expert FFN is three grouped products on the ``moe_gemm`` kernel over
capacity-packed ``(E, T, D)`` inputs.  Groups are the batch rows:
capacity is per group, so a token is dropped only by tokens of its own
row that come before it (token order, then choice order).

On a mesh of ranks (``dist/actsharding``) the experts are placed by the
rule tables:

* **Expert parallelism** (``expert -> model``): each rank runs
  ``moe_gemm`` over its E/n local experts for every token of its rows
  (the ranks of ``model`` hold the same rows), and the combine is summed
  over ``model``.  Split over an axis whose ranks hold different rows
  (``pod`` without hierarchical dispatch, ``model`` without tensor
  parallelism), the experts are gathered per layer, as FSDP gathers.
* **Hierarchical dispatch** (``strategy.hierarchical_moe`` on a pod
  tier, chosen by ``_hier_homes`` as in the reference): experts split
  over ``("pod", "model")``, pod-major, so expert ``e``'s home pod is
  ``e // (E/P)``.  A rank builds its tokens' dispatch rows for the
  experts of every home at its model index; the rows of its own pod's
  experts stay (stage 1), and only the rows bound for the other pods'
  experts move over the ``pod`` group, out and back (stage 2, an
  all-to-all).  Both stages select the same slot rows as the flat
  gather, so the output is identical to flat, capacity drops included.
  On one rank under a hierarchical context the pods are simulated: the
  exchange is a transpose of the (source pod, home pod) blocks.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm import collectives as coll
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.actsharding import current, gather_leaves, on_ranks
from repro_torch.dist.mesh import axis_size, batch_axes
from repro_torch.dist.sharding import entry_axes, param_rules, resolve_spec
from repro_torch.kernels import ops
from repro_torch.models.layers import mlp_apply, mlp_defs
from repro_torch.models.params import PDef


def moe_defs(cfg: ModelConfig):
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.n_experts
    defs = {
        "router": PDef((d, e), ("embed", None)),
        "w_in": PDef((e, d, f), ("expert", "embed", "ff")),
        "w_out": PDef((e, f, d), ("expert", "ff", "embed")),
    }
    if cfg.mlp_type == "swiglu":
        defs["w_gate"] = PDef((e, d, f), ("expert", "embed", "ff"))
    if mc.dense_residual:
        defs["dense"] = mlp_defs(cfg, mc.d_ff_dense)
    return defs


def _capacity(m_tokens: int, mc) -> int:
    c = int(-(-m_tokens * mc.top_k * mc.capacity_factor // mc.n_experts))
    return max(c, 1)


def _hier_homes(e: int, g: int) -> int:
    """Number of expert HOME pods for hierarchical dispatch (1 = flat).

    Active only inside an activation-sharding context whose strategy
    asks for it, on a mesh with a real pod tier, and when experts and
    groups (the batch's rows, all ranks' together) both split evenly
    across pods; anything else falls back to the flat dispatch (same
    outputs either way)."""
    ctx = current()
    if ctx is None:
        return 1
    st = ctx.strategy
    if not (st.hierarchical_moe and st.expert_parallel):
        return 1
    pods = int(ctx.mesh.shape.get("pod", 1))
    if pods <= 1 or e % pods or g % pods:
        return 1
    return pods


EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def _place_experts(cfg: ModelConfig, p, homes: int, device):
    """(expert weights, ids, partial mesh).

    ``ids`` (H, E_h), on ``device``: the global expert ids of the
    dispatch grid's home blocks, H = ``homes``: on ranks under
    hierarchical dispatch, block q the experts rank (q, this model
    index) holds; otherwise one block, this rank's experts.  None on one
    rank, where every expert is here in order (H blocks of E/H).
    The weights are this rank's experts (on ranks, gathered over every
    axis of their spec whose ranks hold different rows, but ``pod`` under
    hierarchical dispatch).  ``partial``: the mesh where the rank
    computes a part of each token's FFN (experts or their FFN split over
    ``model`` under tensor parallelism), whose sum over ``model`` makes
    it whole; else None."""
    e = cfg.moe.n_experts
    w = {k: p[k] for k in EXPERT_LEAVES if k in p}
    ctx = on_ranks()
    if ctx is None:
        return w, None, None
    mesh, st = ctx.mesh, ctx.strategy
    defs = moe_defs(cfg)
    rules = param_rules(st)
    batch = batch_axes(mesh, st.tensor_parallel)
    kept = set()
    for name in w:
        d = defs[name]
        for dim, entry in enumerate(resolve_spec(d.shape, d.axes, rules,
                                                 mesh)):
            axes = entry_axes(entry)
            over = tuple(a for a in axes if a in batch
                         and not (homes > 1 and a == "pod"))
            w[name] = coll.gather_dim(w[name], dim, over, mesh)
            kept.update(a for a in axes if a not in over
                        and mesh.shape[a] > 1)
            if dim == 0:
                ex, ex_kept = axes, tuple(a for a in axes if a not in over)
    # global ids of the local experts: rank-major over the expert dim's
    # axes, a gathered axis taking every coordinate
    grid = torch.arange(e, device=device).reshape(
        [mesh.shape[a] for a in ex] + [e // axis_size(mesh, ex)])

    def ids_at(coords):
        sel = tuple(coords[a] if a in ex_kept else slice(None) for a in ex)
        return grid[sel].reshape(-1)

    if homes > 1:
        assert "pod" in ex_kept, (ex, ex_kept)
        ids = torch.stack([ids_at(dict(mesh.coords, pod=q))
                           for q in range(homes)])
    else:
        ids = ids_at(mesh.coords)[None]
    partial = mesh if st.tensor_parallel and "model" in kept else None
    return w, ids, partial


def route(cfg: ModelConfig, router, x):
    """The router in float32: (logits, probs (G, M, E), gate values and
    expert ids (G, M, k)), the top k experts by probability, best first,
    their gates renormalized to sum to 1.  (``jax.lax.top_k`` breaks a
    tie by the lower id, ``torch.topk`` promises no order; float32
    scores make ties improbable.)"""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    return logits, probs, gate_vals, expert_idx


class _Gather(torch.autograd.Function):
    """rows[i] = src[idx[i]] (a zero row where idx[i] < 0), with a
    gather for its backward too: grad_src[j] = the sum over r of
    grad_rows[inv[j, r]] (no term where inv[j, r] < 0).  Dispatch and
    combine know which rows read each source row (a token's k slots, a
    slot's one token), so the backward needs no scatter: autograd's
    scatter for an indexed read sorts its indices and took half of a
    granite train step on the card."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        n, r = inv.shape
        return _take(grad, inv.reshape(-1)).reshape(n, r, -1).sum(1), None, None


def _take(src, idx):
    rows = src.index_select(0, idx.clamp_min(0))
    return rows * (idx >= 0).unsqueeze(-1).to(rows.dtype)


def moe_apply(cfg: ModelConfig, p, x, *, impl=None
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (G, M, D) -> (out, {"moe_aux_loss", "moe_dropped_frac"})."""
    mc = cfg.moe
    g, m, d = x.shape
    e, k = mc.n_experts, mc.top_k
    c = _capacity(m, mc)
    dev = x.device
    ranks = on_ranks()
    if ranks is None:
        homes = _hier_homes(e, g)
    else:       # the groups of every rank, where each holds as many
        homes = (_hier_homes(e, ranks.global_rows)
                 if ranks.global_rows else 1)
    p = gather_leaves(p, moe_defs(cfg), skip=EXPERT_LEAVES)   # FSDP
    w, ids, partial = _place_experts(cfg, p, homes, dev)
    n_home, e_h = (homes, e // homes) if ids is None else ids.shape
    # source pods among this rank's groups: every pod on one rank (a
    # simulated exchange), the rank's own on ranks
    n_src = homes if ranks is None else 1
    g_s = g // n_src

    logits, probs, gate_vals, expert_idx = route(cfg, p["router"], x)

    # slot of each (token, choice) in its expert: priority is token
    # order, then choice order (a running count per expert, taken along
    # the innermost axis)
    e_flat = expert_idx.reshape(g, m * k)
    onehot = F.one_hot(e_flat, e).transpose(1, 2).to(torch.int32).contiguous()
    pos = ((torch.cumsum(onehot, -1, dtype=torch.int32) - onehot) * onehot
           ).sum(1).reshape(g, m, k)                            # g m k
    keep = pos < c
    gate_vals = gate_vals * keep

    # the dispatch grid, rows (source pod, home block, expert of the
    # block, group of the source pod, slot): row[t, j] the row of token
    # t's j-th choice (-1: dropped, or an expert held elsewhere),
    # owner[r] the (token, choice) in row r (-1: empty)
    if ids is None:              # every expert here, in order: qj = e
        qj = expert_idx
    else:
        slot_of = torch.full((e,), -1, dtype=torch.long, device=dev)
        slot_of[ids.reshape(-1)] = torch.arange(n_home * e_h, device=dev)
        qj = slot_of[expert_idx]                                # g m k
    gi = torch.arange(g, device=dev)[:, None, None]
    row = (((gi // g_s) * (n_home * e_h) + qj) * g_s + gi % g_s) * c + pos
    row = torch.where(keep & (qj >= 0), row, -1).reshape(g * m, k)
    n_rows = n_src * n_home * e_h * g_s * c
    # a choice with no row scatters into a spare row n_rows, cut off (an
    # index past the end would be a device-side fault on the card)
    owner = torch.full((n_rows + 1,), -1, dtype=torch.long, device=dev)
    owner[torch.where(row >= 0, row, n_rows).reshape(-1)] = torch.arange(
        g * m * k, device=dev)
    owner = owner[:n_rows]
    token = torch.where(owner >= 0, owner // k, -1)

    # expert inputs (empty rows zero), then stage 2's exchange: each home
    # block to its home pod, this pod's own block staying put
    xe = coll.copy_to(x, partial, "model")
    xin = _Gather.apply(xe.reshape(g * m, d), token, row).reshape(
        n_src, n_home, e_h, g_s * c, d)
    hier = homes > 1 and ranks is not None
    xin = (coll.exchange(xin[0], ranks.mesh, "pod")[None] if hier
           else xin.transpose(0, 1))          # (my homes, sources, ...)
    h_loc, n_from = xin.shape[:2]
    xin = xin.permute(0, 2, 1, 3, 4).reshape(h_loc * e_h, -1, d)
    dt = x.dtype
    h = ops.moe_gemm(xin, w["w_in"].to(dt), impl=impl)
    if "w_gate" in w:
        gt = ops.moe_gemm(xin, w["w_gate"].to(dt), impl=impl)
        h = F.silu(gt) * h
    else:
        h = F.gelu(h, approximate="tanh")
    yout = ops.moe_gemm(h, w["w_out"].to(dt), impl=impl)
    yout = yout.reshape(h_loc, e_h, n_from, g_s * c, d).permute(0, 2, 1, 3, 4)
    yout = (coll.exchange(yout[0].contiguous(), ranks.mesh, "pod")[None]
            if hier else yout.transpose(0, 1))          # back to the grid

    # combine: each token's k slots, weighted by their gates (a dropped
    # choice, or one another rank of ``model`` holds, reads a zero row)
    gathered = _Gather.apply(yout.reshape(n_rows, d), row.reshape(-1),
                             owner[:, None]).reshape(g, m, k, d)
    gate = coll.copy_to(gate_vals, partial, "model")
    out = gathered * gate[..., None].to(dt)
    if partial is not None:
        # this rank's experts' terms summed in float32 over every rank,
        # rounded once, as one rank's sum of all k terms is
        out = coll.reduce_from(out.float().sum(dim=2), partial,
                               "model").to(dt)
    else:
        out = out.sum(dim=2)

    if mc.dense_residual:
        out = out + mlp_apply(cfg, p["dense"], x, d_ff=mc.d_ff_dense)

    # aux losses: load balance and router z
    frac_tokens = onehot.float().mean(dim=(0, 2)) * e
    frac_probs = probs.mean(dim=(0, 1))
    lb_loss = (frac_tokens * frac_probs).sum() * e / k
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"moe_aux_loss": mc.router_aux_weight * lb_loss
           + mc.router_z_weight * z_loss,
           "moe_dropped_frac": 1.0 - keep.float().mean()}
    return out.to(dt), aux
