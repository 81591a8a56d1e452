"""Transformer layers: RMSNorm or LayerNorm, RoPE (whole or partial
head dim), sinusoidal positions, GQA attention with optional QKV bias
(prefill, contiguous decode, paged decode, paged chunk prefill) and
cross-attention over an encoder's keys and values, the SwiGLU or GeLU
MLP, embed and (optionally tied) logits.

Each layer has ``*_defs(cfg)`` (the PDef schema, with the JAX package's
key names and logical axes) and ``*_apply(cfg, params, ...)`` (the math
on tensors).  Matmul weights are cast to the activation type at use, as
the JAX layers do; ``impl`` selects the kernels (see ``kernels/ops``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import PDef


class PagedView(NamedTuple):
    """Block-table view over a paged KV pool (built by ``serve``).

    ``lengths`` is each slot's write position for the incoming row(s).
    Chunked prefill (s > 1) also sets ``n_valid``, the real rows of the
    chunk, and ``null_page``, the page that takes the padding rows' KV:
    a (1,) int32 tensor on the device, as the engine passes it (an input
    of a captured tick, like the JAX engine's ``c_null``), or an int.
    """

    block_table: torch.Tensor               # (n_slots, pages_per_slot) int32
    lengths: torch.Tensor                   # (n_slots,) int32
    n_valid: Optional[torch.Tensor] = None  # (B,) int32
    null_page: Union[torch.Tensor, int, None] = None    # (1,) int32


def norm_defs(cfg: ModelConfig):
    # float32 whatever the tree's dtype: the rmsnorm kernel reads it so
    # (LayerNorm's bias too, beside its scale)
    d = {"scale": PDef((cfg.d_model,), (None,), init="ones",
                       dtype="float32")}
    if cfg.norm_type == "layernorm":
        d["bias"] = PDef((cfg.d_model,), (None,), init="zeros",
                         dtype="float32")
    return d


def norm_apply(cfg: ModelConfig, p, x, impl=None):
    """RMSNorm through the ``rmsnorm`` kernel, or LayerNorm in float32
    (plain torch: the JAX package has no LayerNorm kernel either)."""
    if cfg.norm_type == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + cfg.norm_eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    return ops.rmsnorm(x, p["scale"], eps=cfg.norm_eps, impl=impl)


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (B, S, H, D); positions: (S,) or (B, S).  The rotation runs in
    float32 (JAX promotes the activation against f32 cos/sin)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def sinusoidal_positions(seq_len: int, d_model: int, offset=0, device=None):
    """(seq_len, d_model) float32: sin then cos of positions ``offset``
    .. ``offset + seq_len - 1`` over geometric frequencies."""
    pos = torch.arange(seq_len, device=device) + offset
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = pos[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def attention_defs(cfg: ModelConfig, cross: bool = False):
    """A cross-attention's projections take no QKV bias."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": PDef((d, h * hd), ("embed", "heads")),
        "wk": PDef((d, kv * hd), ("embed", "kv_heads")),
        "wv": PDef((d, kv * hd), ("embed", "kv_heads")),
        "wo": PDef((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = PDef((h * hd,), ("heads",), init="zeros")
        defs["bk"] = PDef((kv * hd,), ("kv_heads",), init="zeros")
        defs["bv"] = PDef((kv * hd,), ("kv_heads",), init="zeros")
    return defs


def _project_qkv(cfg, p, x, kv_input=None):
    """q from ``x``; k and v from ``kv_input`` (an encoder's output, for
    cross-attention) or from ``x``."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_in = x if kv_input is None else kv_input
    skv = kv_in.shape[1]
    q = x @ p["wq"].to(x.dtype)
    k = kv_in @ p["wk"].to(x.dtype)
    v = kv_in @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, h, hd), k.reshape(b, skv, kv, hd),
            v.reshape(b, skv, kv, hd))


def attention_apply(cfg: ModelConfig, p, x, *, positions, causal=True,
                    cache=None, cache_index=None, cross_kv=None,
                    paging: Optional[PagedView] = None, impl=None):
    """Self- or cross-attention.  With ``cross_kv``, the (k, v) of an
    encoder's output (B, Skv, kv, hd): q from ``x`` (RoPE'd where
    ``positions`` are given and the config rotates), attending every key
    (non-causal), returning (out, None).  Otherwise self-attention.
    Without ``cache``: the prompt prefill, returning
    (out, (k, v)).  With ``cache`` (one layer's ``{"k", "v"}``) and
    ``paging`` (the cache is then the page pools): paged decode (s == 1)
    or paged chunk prefill (s > 1).  With a contiguous cache (B, S, kv,
    hd) and no ``paging``: decode of one token per row at the int
    ``cache_index``.  The port writes the new KV into the cache in place
    (the JAX package returns an updated copy and its engine donates the
    old one, so the effect is the same) and returns (out, (k, v) of the
    cache)."""
    b, s, _ = x.shape
    if cross_kv is not None:
        q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim)
        if positions is not None and cfg.pos_type == "rope":
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        out = ops.flash_attention(q, *cross_kv, causal=False, impl=impl)
        return out.reshape(b, s, -1) @ p["wo"].to(x.dtype), None
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    if cache is None:                                   # prompt prefill
        out = ops.flash_attention(q, k, v, causal=causal, impl=impl)
        new_kv = (k, v)
    elif paging is None:                                # contiguous decode
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
        out = ops.decode_attention(q, ck, cv, cache_index + 1, impl=impl)
        new_kv = (ck, cv)
    else:
        ck, cv = cache["k"], cache["v"]
        page_size = ck.shape[1]
        rows = torch.arange(b, device=x.device)
        pos = paging.lengths.long()                                 # (B,)
        if s == 1:                                      # paged decode
            page = paging.block_table[rows, pos // page_size].long()
            off = pos % page_size
            ck[page, off] = k[:, 0].to(ck.dtype)
            cv[page, off] = v[:, 0].to(cv.dtype)
            out = ops.paged_decode_attention(q, ck, cv, paging.block_table,
                                             paging.lengths + 1, impl=impl)
        else:                                           # paged chunk prefill
            maxp = paging.block_table.shape[1]
            j = torch.arange(s, device=x.device)
            offs = pos[:, None] + j[None, :]                       # (B, s)
            valid = j[None, :] < paging.n_valid.long()[:, None]
            page = paging.block_table[
                rows[:, None], torch.clamp(offs // page_size, max=maxp - 1)]
            # padding rows sink into the null page: their offsets may lie
            # past the slot's reserved pages, and clamping alone would
            # land them on the slot's last real page
            page = torch.where(valid, page, paging.null_page).long()
            ck[page, offs % page_size] = k.to(ck.dtype)
            cv[page, offs % page_size] = v.to(cv.dtype)
            out = ops.paged_prefill_attention(q, ck, cv, paging.block_table,
                                              paging.lengths, paging.n_valid,
                                              impl=impl)
        new_kv = (ck, cv)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return out, new_kv


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"w_in": PDef((d, f), ("embed", "ff")),
            "w_out": PDef((f, d), ("ff", "embed"))}
    if cfg.mlp_type == "swiglu":
        defs["w_gate"] = PDef((d, f), ("embed", "ff"))
    return defs


def mlp_apply(cfg: ModelConfig, p, x):
    """SwiGLU, or GeLU (the tanh approximation, ``jax.nn.gelu``'s
    default)."""
    h = x @ p["w_in"].to(x.dtype)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"].to(x.dtype)


def embed_defs(cfg: ModelConfig):
    defs = {"tok": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        init="normal", scale=0.02)}
    if not cfg.tie_embeddings:
        defs["head"] = PDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    defs["final_norm"] = norm_defs(cfg)
    return defs


def embed_apply(cfg: ModelConfig, p, tokens, dtype, offset=0):
    """Token embeddings in ``dtype``; with sinusoidal positions, plus
    those of positions ``offset`` .. ``offset + S - 1`` (one offset for
    every row)."""
    x = p["tok"][tokens].to(dtype)
    if cfg.pos_type == "sinusoidal":
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model, offset,
                                     tokens.device).to(dtype)[None]
    return x


def logits_apply(cfg: ModelConfig, p, x, impl=None):
    x = norm_apply(cfg, p["final_norm"], x, impl=impl)
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)
