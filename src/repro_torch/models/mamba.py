"""Mamba (selective SSM) block, Jamba flavor: the port of the JAX
package's ``models/mamba.py``.

Training and prefill run the selective scan chunk by chunk: parallel
within a chunk of ``CHUNK`` steps (a log-step doubling scan), a carry
across chunks, so the working set is one chunk's ``(B, CHUNK, d_in,
d_state)`` float32 at a time.  ``SelectiveScan`` is its autograd
Function, the reference's memory-bounded recompute backward: it keeps
dt, B, C and u in bfloat16 and the state at each chunk's start, never
the ``(B, S, d_in, d_state)`` states (about 2.1 GB a batch row a layer
at jamba's width).  Decode is the one-step recurrence over a conv ring
state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models.params import PDef

CHUNK = 256


def _mc(cfg: ModelConfig) -> MambaConfig:
    return cfg.mamba or MambaConfig()


def _dims(cfg: ModelConfig):
    mc = _mc(cfg)
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_in, dt_rank


def mamba_defs(cfg: ModelConfig):
    mc, d_in, dt_rank = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": PDef((d, 2 * d_in), ("embed", "mamba_in")),
        "conv_w": PDef((mc.d_conv, d_in), (None, "mamba_in"), init="fan_in"),
        "conv_b": PDef((d_in,), ("mamba_in",), init="zeros"),
        "x_proj": PDef((d_in, dt_rank + 2 * mc.d_state), ("mamba_in", None)),
        "dt_proj": PDef((dt_rank, d_in), (None, "mamba_in")),
        "dt_bias": PDef((d_in,), ("mamba_in",), custom="mamba_dt_bias"),
        # float32 in a bf16 tree: the reference reads it in float32
        "a_log": PDef((d_in, mc.d_state), ("mamba_in", None),
                      custom="mamba_a_log", dtype="float32"),
        "d_skip": PDef((d_in,), ("mamba_in",), init="ones"),
        "out_proj": PDef((d_in, d), ("mamba_in", "embed")),
    }


def conv_causal(x, w, b, state=None):
    """Depthwise causal conv.  x (B, S, C), w (K, C), state (B, K-1, C)
    or None (zeros).  Returns (out, the last K-1 inputs: the next
    state).  Terms are summed in the reference's order."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b, xp[:, xp.shape[1] - (k - 1):]


def _ssm_params(cfg, p, u):
    """u (B, S, d_in) -> dt (B, S, d_in), B and C (B, S, d_state) in
    float32, A (d_in, d_state)."""
    mc, _, dt_rank = _dims(cfg)
    proj = u @ p["x_proj"].to(u.dtype)
    dt, bmat, cmat = torch.split(proj, [dt_rank, mc.d_state, mc.d_state],
                                 dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(u.dtype) + p["dt_bias"].to(u.dtype))
    a = -torch.exp(p["a_log"].float())
    return dt.float(), bmat.float(), cmat.float(), a


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t from h = 0 along dim 1,
    in log2(L) doubling steps, in place: a becomes prod a_1..t and b
    h_t.  Each step forms its products before it writes, so no step
    reads what it wrote."""
    s, n = 1, a.shape[1]
    while s < n:
        b[:, s:] += a[:, s:] * b[:, :-s]
        a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return a, b


def _reverse_scan(a, b):
    """The adjoint's scan, ``b_i += a_i * b_{i+1}`` from the last step
    back along dim 1, in log2(L) doubling steps, in place: ``a`` (one
    step shorter than ``b``) links step i to i+1 and is consumed; b
    becomes the scan."""
    s, n = 1, b.shape[1]
    while s < n:
        b[:, :n - s] += a[:, :n - s] * b[:, s:]
        if n > 2 * s:
            a[:, :n - 2 * s] = a[:, :n - 2 * s] * a[:, s:n - s]
        s *= 2
    return b


def _decay_and_input(dt, bmat, u, a):
    """A chunk's exp(dt A) and dt u B, each (B, L, d_in, N) float32."""
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * u)[..., None] * bmat[:, :, None, :]
    return da, dbx


RESIDUAL_DTYPE = torch.bfloat16     # the reference's: half the saved bytes;
                                    # the cotangents lie a few tenths of a
                                    # percent from float32 autograd's


class SelectiveScan(torch.autograd.Function):
    """The chunked scan of ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t``,
    ``y_t = h_t C_t``: dt, u (B, S, d_in), B and C (B, S, N), A (d_in,
    N), h0 (B, d_in, N), all float32, chunks of ``ch`` steps.  A chunk's
    tail past S is never formed, in either direction (the reference pads
    it with dt = 0, a step that leaves h unchanged).  Returns (y (B, S,
    d_in), h after the last step).

    The twin of the reference's ``_fused_ssm``.  The forward keeps dt,
    B, C and u rounded to RESIDUAL_DTYPE and the float32 state at each
    chunk's start.  The backward walks the chunks in reverse: it
    recomputes a chunk's decays and states from its start (from the
    rounded residuals, as the reference does), runs the adjoint
    recurrence ``lam_i = g_i + da_{i+1} lam_{i+1}`` (g = dy C, the
    incoming dh joining the chunk's last step) as a reversed doubling
    scan, forms the chunk's cotangents and carries ``da_0 lam_0`` into
    the chunk before."""

    @staticmethod
    def forward(ctx, dt, bmat, cmat, u, a, h0, ch):
        ys, starts, h = [], [], h0
        for c0 in range(0, dt.shape[1], ch):
            sl = slice(c0, c0 + ch)
            starts.append(h)
            aa, bb = _doubling_scan(*_decay_and_input(dt[:, sl], bmat[:, sl],
                                                      u[:, sl], a))
            hs = bb.addcmul_(aa, h[:, None])
            del aa
            ys.append(torch.einsum("blcn,bln->blc", hs, cmat[:, sl]))
            h = hs[:, -1].clone()           # a view would keep hs alive
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*(t.to(RESIDUAL_DTYPE)
                                    for t in (dt, bmat, cmat, u)),
                                  a, torch.stack(starts))
            ctx.ch = ch
        return torch.cat(ys, dim=1), h

    @staticmethod
    def backward(ctx, dy, dh_last):
        *res, a, starts = ctx.saved_tensors
        ch = ctx.ch
        ddt, dbmat, dcmat, du = (torch.empty(t.shape, dtype=torch.float32,
                                             device=t.device) for t in res)
        grad_a = torch.zeros_like(a)
        dh = (torch.zeros_like(starts[0]) if dh_last is None
              else dh_last.float())
        for i in reversed(range(starts.shape[0])):
            sl = slice(i * ch, (i + 1) * ch)
            dtc, bc, cc, uc = (t[:, sl].float() for t in res)
            dyc, h_start = dy[:, sl].float(), starts[i]
            da, dbx = _decay_and_input(dtc, bc, uc, a)
            aa, hs = _doubling_scan(da.clone(), dbx)
            hs.addcmul_(aa, h_start[:, None])                # B L C N
            del aa
            dcmat[:, sl] = torch.einsum("blcn,blc->bln", hs, dyc)
            lam = dyc[..., None] * cc[:, :, None, :]          # dL/dh_i
            lam[:, -1] += dh
            lam = _reverse_scan(da[:, 1:].clone(), lam)       # dL/d(dbx)
            lb = torch.einsum("blcn,bln->blc", lam, bc)       # dL/d(dt u)
            dbmat[:, sl] = torch.einsum("blcn,blc->bln", lam, dtc * uc)
            du[:, sl] = lb * dtc
            lam.mul_(da)
            del da
            dh = lam[:, 0].clone()                            # da_0 lam_0
            lam[:, 0] *= h_start                              # dL/d(da) da
            lam[:, 1:] *= hs[:, :-1]
            del hs
            ddt[:, sl] = lb * uc + torch.einsum("blcn,cn->blc", lam, a)
            grad_a += torch.einsum("blcn,blc->cn", lam, dtc)
        return ddt, dbmat, dcmat, du, grad_a, dh, None


def mamba_apply(cfg: ModelConfig, p, x, cache=None):
    """x (B, S, D).  cache {"conv": (B, K-1, d_in), "ssm": (B, d_in, N)}
    or None (training: zero state, nothing handed out).  Returns (out,
    new_cache), new_cache in the cache's dtypes, or None without one.
    A cache with S == 1 takes the one-step decode, else the chunked
    scan (prefill)."""
    mc, d_in, _ = _dims(cfg)
    b, s, _ = x.shape
    xz = x @ p["in_proj"].to(x.dtype)
    u, z = xz.chunk(2, dim=-1)
    u, new_conv = conv_causal(u, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype),
                              None if cache is None else cache["conv"])
    u = F.silu(u)
    dt, bmat, cmat, a = _ssm_params(cfg, p, u)
    uf = u.float()

    if cache is None or s > 1:                            # train / prefill
        h0 = (torch.zeros((b, d_in, mc.d_state), dtype=torch.float32,
                          device=x.device)
              if cache is None else cache["ssm"].float())
        y, h_last = SelectiveScan.apply(dt, bmat, cmat, uf, a, h0,
                                        min(CHUNK, s))
    else:                                                 # decode: one step
        da = torch.exp(dt[:, 0, :, None] * a)             # B C N
        dbx = (dt[:, 0] * uf[:, 0])[..., None] * bmat[:, 0, None, :]
        h_last = da * cache["ssm"].float() + dbx
        y = torch.einsum("bcn,bn->bc", h_last, cmat[:, 0])[:, None]

    y = y + uf * p["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"].to(x.dtype)
    if cache is None:
        return out, None
    return out, {"conv": new_conv.to(cache["conv"].dtype),
                 "ssm": h_last.to(cache["ssm"].dtype)}


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    mc, d_in, _ = _dims(cfg)
    return {"conv": (batch, mc.d_conv - 1, d_in),
            "ssm": (batch, d_in, mc.d_state)}
