"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the
port of the JAX package's ``models/xlstm.py``.

mLSTM prefill runs the chunkwise-parallel form (within a chunk the
quadratic form under a decay mask, across chunks a recurrent carry);
decode is the one-step recurrence.  Every exponent is stabilized in log
space by a running max ``m``, as in the xLSTM paper.  sLSTM has
recurrent gate connections and runs step by step.

State per mLSTM head: C (dh x dh), n (dh), m (a scalar); per sLSTM: c,
n, h and m (d_model each).  Without a cache (training) both start at m =
NEG; the serving paths hand in a zeroed cache (m = 0), as the JAX
package's prefill does.  Training differentiates both by autograd, as
the reference differentiates them by autodiff; where a max meets a tie,
the gradient splits as JAX's does (``torch.maximum`` halves it, and
``_cummax`` is JAX's ``cummax``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.models.mamba import conv_causal
from repro_torch.models.params import PDef

NEG = -1e30


def _xc(cfg: ModelConfig) -> XLSTMConfig:
    return cfg.xlstm or XLSTMConfig()


def _dims(cfg: ModelConfig):
    xc = _xc(cfg)
    d_in = xc.expand * cfg.d_model
    return xc, d_in, d_in // xc.n_heads


def _scan_max(x):
    """Running max along the last dim, as JAX's ``associative_scan`` of
    ``maximum`` forms it (pairs reduced, the reduction scanned, the even
    positions combined back): the same combines, so a tie's gradient
    splits as there."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _scan_max(torch.maximum(x[..., 0:n - 1:2], x[..., 1::2]))
    even = torch.maximum(odd[..., :(n - 1) // 2], x[..., 2::2])
    even = torch.cat([x[..., :1], even], dim=-1)
    out = torch.stack([even[..., :n // 2], odd], dim=-1).flatten(-2)
    return torch.cat([out, even[..., n // 2:]], dim=-1)


def _cummax(x):
    """``lax.cummax`` over the last dim.  Its gradient is that of the
    associative scan above (``torch.cummax`` would route a tie's whole
    gradient to one index); the values are the same, so without autograd
    it is ``torch.cummax``, one launch."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _scan_max(x)
    return torch.cummax(x, dim=-1).values


# ==========================================================================
# mLSTM
# ==========================================================================


def mlstm_defs(cfg: ModelConfig):
    xc, d_in, dh = _dims(cfg)
    d, h = cfg.d_model, xc.n_heads
    # the gate biases and the head norm stay float32 in a bf16 tree: the
    # reference reads them in float32
    return {
        "up_proj": PDef((d, 2 * d_in), ("embed", "xl_in")),
        "conv_w": PDef((xc.d_conv, d_in), (None, "xl_in"), init="fan_in"),
        "conv_b": PDef((d_in,), ("xl_in",), init="zeros"),
        # block-diagonal per-head q/k/v
        "wq": PDef((h, dh, dh), ("xl_heads", None, None)),
        "wk": PDef((h, dh, dh), ("xl_heads", None, None)),
        "wv": PDef((h, dh, dh), ("xl_heads", None, None)),
        "w_if": PDef((d_in, 2 * h), ("xl_in", None), init="zeros"),
        "b_i": PDef((h,), (None,), init="zeros", dtype="float32"),
        "b_f": PDef((h,), (None,), custom="slstm_fgate_bias",
                    dtype="float32"),
        "hnorm": PDef((d_in,), ("xl_in",), init="ones", dtype="float32"),
        "down_proj": PDef((d_in, d), ("xl_in", "embed")),
    }


def mlstm_apply(cfg: ModelConfig, p, x, cache=None):
    """x (B, S, D).  cache {"conv", "C", "n", "m"} or None.  Returns
    (out, new_cache in the cache's dtypes, or None without one)."""
    xc, d_in, dh = _dims(cfg)
    h = xc.n_heads
    b, s, _ = x.shape

    xz = x @ p["up_proj"].to(x.dtype)
    u, z = xz.chunk(2, dim=-1)
    uc, new_conv = conv_causal(u, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype),
                               None if cache is None else cache["conv"])
    uc = F.silu(uc)

    def heads(t):  # (B, S, d_in) -> (B, H, S, dh)
        return t.reshape(b, s, h, dh).transpose(1, 2).float()

    q = torch.einsum("bhsd,hde->bhse", heads(uc), p["wq"].float())
    k = torch.einsum("bhsd,hde->bhse", heads(uc), p["wk"].float())
    k = k * (dh ** -0.5)
    v = torch.einsum("bhsd,hde->bhse", heads(u), p["wv"].float())
    gates = u.float() @ p["w_if"].float()
    gates = gates.reshape(b, s, 2, h).permute(0, 3, 1, 2)        # B H S 2
    ig = gates[..., 0] + p["b_i"].float()[None, :, None]
    lf = F.logsigmoid(gates[..., 1] + p["b_f"].float()[None, :, None])

    if cache is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, h, dh, dh), **f32),
                 torch.zeros((b, h, dh), **f32),
                 torch.full((b, h), NEG, **f32))
    else:
        state = tuple(cache[n].float() for n in ("C", "n", "m"))

    if s == 1 and cache is not None:                       # decode
        hy, state = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                               ig[:, :, 0], lf[:, :, 0], state)
        hy = hy[:, :, None]                                # B H 1 dh
    else:                                                  # chunkwise
        hy, state = mlstm_chunked(q, k, v, ig, lf, state,
                                  min(xc.chunk_size, s))

    # per-head norm
    hy = hy.transpose(1, 2)                                # B S H dh
    hy = hy * torch.rsqrt((hy * hy).mean(-1, keepdim=True) + 1e-6)
    hy = hy.reshape(b, s, d_in) * p["hnorm"].float()
    out = (hy.to(x.dtype) * F.silu(z)) @ p["down_proj"].to(x.dtype)
    if cache is None:
        return out, None
    c1, n1, m1 = state
    return out, {"conv": new_conv.to(cache["conv"].dtype),
                 "C": c1.to(cache["C"].dtype), "n": n1.to(cache["n"].dtype),
                 "m": m1.to(cache["m"].dtype)}


def mlstm_step(q, k, v, ig, lf, state):
    """One recurrent step.  q, k, v (B, H, dh); ig, lf (B, H)."""
    c, n, m = state
    m1 = torch.maximum(lf + m, ig)
    fp = torch.exp(lf + m - m1)
    ip = torch.exp(ig - m1)
    c1 = fp[..., None, None] * c + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n1 = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c1)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n1).abs(),
                        torch.exp(-m1))
    return num / den[..., None], (c1, n1, m1)


def mlstm_chunked(q, k, v, ig, lf, state, ch):
    """Chunkwise-parallel mLSTM.  q, k, v (B, H, S, dh); ig, lf (B, H,
    S); chunks of ``ch``.  A chunk's tail is padded as the reference pads
    it (``ig`` with NEG, the rest with 0), so the carry past S is the
    state after the last real step.  Returns (h (B, H, S, dh), state)."""
    b, h, s, dh = q.shape
    pad = (-s) % ch
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, pad), value=NEG)
        lf = F.pad(lf, (0, pad))
    tri = torch.tril(torch.ones((ch, ch), dtype=torch.bool, device=q.device))
    c, n, m = state
    ys = []
    for c0 in range(0, s + pad, ch):
        sl = slice(c0, c0 + ch)
        qc, kc, vc, igc, lfc = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            ig[:, :, sl], lf[:, :, sl]
        bcum = torch.cumsum(lfc, dim=-1)                    # B H ch
        gl = _cummax(igc - bcum)
        mloc = bcum + torch.maximum(m[..., None], gl)       # B H ch
        # intra-chunk decay matrix D[t, j] for j <= t
        dlog = (bcum[..., :, None] - bcum[..., None, :]
                + igc[..., None, :] - mloc[..., :, None])
        dmat = torch.where(tri, torch.exp(dlog), 0.0)       # B H ch ch
        scores = torch.einsum("bhtd,bhjd->bhtj", qc, kc) * dmat
        inter_w = torch.exp(bcum + m[..., None] - mloc)     # B H ch
        num = (torch.einsum("bhtj,bhjd->bhtd", scores, vc)
               + inter_w[..., None] * torch.einsum("bhtd,bhde->bhte", qc, c))
        nloc = (torch.einsum("bhtj,bhjd->bhtd", dmat, kc)
                + inter_w[..., None] * n[..., None, :])
        den = torch.maximum(torch.einsum("bhtd,bhtd->bht", qc, nloc).abs(),
                            torch.exp(-mloc))
        ys.append(num / den[..., None])
        # state update to the end of the chunk
        total = bcum[..., -1]                               # B H
        m1 = total + torch.maximum(m, gl[..., -1])
        wstate = torch.exp(total + m - m1)                  # old-state weight
        wk = torch.exp(total[..., None] - bcum + igc - m1[..., None])
        c = (wstate[..., None, None] * c
             + torch.einsum("bhj,bhjd,bhje->bhde", wk, kc, vc))
        n = wstate[..., None] * n + torch.einsum("bhj,bhjd->bhd", wk, kc)
        m = m1
    return torch.cat(ys, dim=2)[:, :, :s], (c, n, m)


def mlstm_cache_shape(cfg: ModelConfig, batch: int):
    xc, d_in, dh = _dims(cfg)
    return {"conv": (batch, xc.d_conv - 1, d_in),
            "C": (batch, xc.n_heads, dh, dh),
            "n": (batch, xc.n_heads, dh),
            "m": (batch, xc.n_heads)}


# ==========================================================================
# sLSTM
# ==========================================================================


def slstm_defs(cfg: ModelConfig):
    xc, d_in, _ = _dims(cfg)
    d, h = cfg.d_model, xc.n_heads
    dhh = d // h
    f32 = dict(dtype="float32")       # read in float32 by the reference
    return {
        "w": PDef((d, 4 * d), ("embed", "xl_in")),
        "r": PDef((h, dhh, 4 * dhh), ("xl_heads", None, None), scale=0.005,
                  **f32),
        "b_i": PDef((d,), (None,), init="zeros", **f32),
        "b_f": PDef((d,), (None,), custom="slstm_fgate_bias", **f32),
        "b_z": PDef((d,), (None,), init="zeros", **f32),
        "b_o": PDef((d,), (None,), init="zeros", **f32),
        "hnorm": PDef((d,), (None,), init="ones", **f32),
        "up_proj": PDef((d, 2 * d_in), ("embed", "xl_in")),
        "down_proj": PDef((d_in, d), ("xl_in", "embed")),
    }


def slstm_apply(cfg: ModelConfig, p, x, cache=None):
    """x (B, S, D).  cache {"c", "n", "h", "m"}, each (B, D), or None.
    The recurrence runs one step per token on the host's loop."""
    xc, _, _ = _dims(cfg)
    b, s, d = x.shape
    h = xc.n_heads
    dhh = d // h

    wx = x.float() @ p["w"].float()                          # B S 4D
    if cache is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        c, n, hp = (torch.zeros((b, d), **f32) for _ in range(3))
        m = torch.full((b, d), NEG, **f32)
    else:
        c, n, hp, m = (cache[k].float() for k in ("c", "n", "h", "m"))

    r = p["r"].float()
    eps = wx.new_full((), 1e-6)         # a fill: no copy from the host
    bias = torch.cat([p[k].float() for k in ("b_i", "b_f", "b_z", "b_o")])
    hs = []
    for t in range(s):
        rh = torch.einsum("bhd,hde->bhe", hp.reshape(b, h, dhh), r)
        pre = wx[:, t] + rh.reshape(b, 4 * d)
        it, ft, zt, ot = (pre + bias).chunk(4, dim=-1)
        m1 = torch.maximum(ft + m, it)
        ip = torch.exp(it - m1)
        fp = torch.exp(ft + m - m1)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        hp = torch.sigmoid(ot) * c / torch.maximum(n, eps)
        m = m1
        hs.append(hp)
    hs = torch.stack(hs, dim=1) * p["hnorm"].float()         # B S D

    # gated FFN (the sLSTM block's post-projection)
    uz = hs.to(x.dtype) @ p["up_proj"].to(x.dtype)
    u, z = uz.chunk(2, dim=-1)
    out = (F.silu(z) * u) @ p["down_proj"].to(x.dtype)
    if cache is None:
        return out, None
    return out, {"c": c.to(cache["c"].dtype), "n": n.to(cache["n"].dtype),
                 "h": hp.to(cache["h"].dtype), "m": m.to(cache["m"].dtype)}


def slstm_cache_shape(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    return {"c": (batch, d), "n": (batch, d), "h": (batch, d),
            "m": (batch, d)}
