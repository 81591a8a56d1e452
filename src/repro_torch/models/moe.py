"""Mixture-of-experts FFN: token-choice top-k routing, capacity dispatch.

The port of the JAX package's ``models/moe.py`` on one device.
Dispatch and combine are gathers (slot positions from a cumulative sum,
no one-hot einsum); the expert FFN is three grouped products on the
``moe_gemm`` kernel over the capacity-packed ``(E, G * C, D)`` inputs.
Groups are the batch rows: capacity is per group, so a token is dropped
only by tokens of its own row that come before it (token order, then
choice order).

Hierarchical dispatch (experts sharded over a pod tier) needs the
sharding slice; on one device dispatch is always flat.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def moe_apply(cfg: ModelConfig, p, x, *, hierarchical: bool = False,
              impl=None) -> Tuple[torch.Tensor, Dict]:
    """x: (G, M, D) -> (out, {"moe_aux_loss", "moe_dropped_frac"})."""
    if hierarchical:
        raise NotImplementedError(
            "hierarchical MoE dispatch needs the port's sharding")
    mc = cfg.moe
    g, m, d = x.shape
    e, k = mc.n_experts, mc.top_k
    c = _capacity(m, mc)
    dev = x.device

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

    # owner[e, g, c] = the (token, choice) in that slot, as the flat id
    # (g * M + token) * k + choice, -1 where empty.  Dropped choices
    # scatter into a spare slot c that is cut off (an index past the end
    # would be a device-side fault on the card)
    gi = torch.arange(g, device=dev)[:, None].expand(g, m * k)
    owner = torch.full((e, g, c + 1), -1, dtype=torch.long, device=dev)
    owner[e_flat, gi, torch.where(keep, pos, c).reshape(g, m * k)] = \
        torch.arange(g * m * k, device=dev).reshape(g, m * k)
    owner = owner[..., :c].reshape(-1)                          # (E*G*C,)
    token = torch.where(owner >= 0, owner // k, -1)
    slot = torch.where(keep, expert_idx * (g * c)
                       + gi.reshape(g, m, k) * c + pos, -1).reshape(g * m, k)

    # expert inputs in (E, G * C, D) order, empty slots zero
    xin = _Gather.apply(x.reshape(g * m, d), token, slot).reshape(e, g * c, d)
    dt = x.dtype
    h = ops.moe_gemm(xin, p["w_in"].to(dt), impl=impl)
    if "w_gate" in p:
        gt = ops.moe_gemm(xin, p["w_gate"].to(dt), impl=impl)
        h = F.silu(gt) * h
    else:
        h = F.gelu(h, approximate="tanh")
    yout = ops.moe_gemm(h, p["w_out"].to(dt), impl=impl)      # (E, G*C, D)

    # combine: each token's k slots, weighted by their gates (a dropped
    # choice reads a zero row at gate 0)
    gathered = _Gather.apply(yout.reshape(e * g * c, d), slot.reshape(-1),
                             owner[:, None]).reshape(g, m, k, d)
    out = (gathered * gate_vals[..., None].to(dt)).sum(dim=2)

    if mc.dense_residual:
        out = out + mlp_apply(cfg, p["dense"], x)

    # aux losses: load balance and router z
    frac_tokens = onehot.float().mean(dim=(0, 2)) * e
    frac_probs = probs.mean(dim=(0, 1))
    lb_loss = (frac_tokens * frac_probs).sum() * e / k
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"moe_aux_loss": mc.router_aux_weight * lb_loss
           + mc.router_z_weight * z_loss,
           "moe_dropped_frac": 1.0 - keep.float().mean()}
    return out.to(dt), aux
