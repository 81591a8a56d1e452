"""Transformer layers: RMSNorm or LayerNorm, RoPE (whole or partial
head dim), sinusoidal positions, GQA attention with optional QKV bias
(prefill, contiguous decode, paged decode, paged chunk prefill) and
cross-attention over an encoder's keys and values, the SwiGLU or GeLU
MLP, embed and (optionally tied) logits.

Each layer has ``*_defs(cfg)`` (the PDef schema, with the JAX package's
key names and logical axes) and ``*_apply(cfg, params, ...)`` (the math
on tensors).  Matmul weights are cast to the activation type at use, as
the JAX layers do; ``impl`` selects the kernels (see ``kernels/ops``).

Tensor parallelism: inside an ``activation_sharding`` context on a mesh
of ranks whose strategy splits the ``model`` axis, a layer gets this
rank's shard of each weight its spec splits (``dist/sharding.py``).
Attention then runs the rank's heads (the counts read from the weights'
shapes) and the MLP its slice of the FFN, each entered through
``copy_to`` (identity forward, all-reduce backward) and left through
``row_parallel`` (float32 partials, an all-reduce forward, rounded
once); the embedding is a masked local
take summed over ``model``, and ``logits_apply`` returns the rank's
vocabulary columns.  Where ``resolve_spec`` leaves a weight whole, no
collective runs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.comm import collectives as coll
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import actsharding
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


def _attention_tp(cfg, p):
    """(weights, mesh) for tensor parallelism over heads: the mesh where
    this rank holds a whole number of query and KV heads (the rank's
    heads, ``model``'s collectives around them), else None, with any
    weight the spec split over ``model`` gathered back whole (every rank
    then computes the whole attention; its gradient is this rank's
    slice)."""
    mesh, n = actsharding.tp()
    if mesh is None:
        return p, None
    hd = cfg.head_dim
    q_split = actsharding.tp_splits(cfg.n_heads * hd)
    kv_split = actsharding.tp_splits(cfg.n_kv_heads * hd)
    if not (q_split or kv_split):
        return p, None
    if (q_split and kv_split and cfg.n_heads % n == 0
            and cfg.n_kv_heads % n == 0):
        return p, mesh
    whole = dict(p)
    for name, split, dim in (("wq", q_split, 1), ("bq", q_split, 0),
                             ("wo", q_split, 0), ("wk", kv_split, 1),
                             ("wv", kv_split, 1), ("bk", kv_split, 0),
                             ("bv", kv_split, 0)):
        if split and name in p:
            whole[name] = coll.gather_dim(p[name], dim, ("model",), mesh,
                                          sum_grads=False)
    return whole, None


def row_parallel(a, w, mesh):
    """``a @ w`` in ``a``'s type, where ``mesh`` (None: one rank) splits
    ``w``'s rows and ``a``'s columns over ``model``: the rank's partial
    product in float32 (of the same bf16 operands), summed over
    ``model`` in float32 and rounded once, as one rank's product of the
    whole operands is (partials rounded to bf16 and summed in bf16 would
    round twice)."""
    w = w.to(a.dtype)
    if mesh is None:
        return a @ w
    return coll.reduce_from(a.float() @ w.float(), mesh, "model").to(a.dtype)


def tp_whole(p, defs):
    """``p`` (leaves named as in the PDefs ``defs``) with every leaf
    that tensor parallelism split over ``model`` (a dim of the rank's
    shard smaller than its PDef's: ``resolve_spec`` alone decided it)
    gathered back whole; each such leaf's gradient is then this rank's
    slice of the whole gradient every rank computes.  A block whose
    heads or channels do not split computes whole so, as
    ``_attention_tp`` does."""
    mesh, _ = actsharding.tp()
    if mesh is None:
        return p
    out = dict(p)
    for name, t in p.items():
        for dim, (k, full) in enumerate(zip(t.shape, defs[name].shape)):
            if k != full:
                out[name] = coll.gather_dim(out[name], dim, ("model",),
                                            mesh, sum_grads=False)
    return out


def mixer_tp(p, defs, unit: str):
    """(weights, mesh) for a sequence mixer's tensor parallelism: the
    mesh where the leaf ``unit`` (an entry a channel or head of the
    block) came split over ``model`` (the rank's shards as they are),
    else None, with any leaf that did split gathered back whole
    (``tp_whole``)."""
    mesh, _ = actsharding.tp()
    if mesh is None:
        return p, None
    if p[unit].shape != defs[unit].shape:
        return p, mesh
    return tp_whole(p, defs), None


def split_halves(xz, mesh):
    """``(u_r, z_r)``, rank r's channels of each half, from its columns of
    ``x @ w`` where ``w``'s ``2 d`` columns ``[u | z]`` (a mixer's
    in-projection) split contiguously over ``model`` (the stored shard,
    as the rule tables cut it).  Of the 2n column blocks of width d / n,
    rank j holds blocks 2j and 2j + 1 and block s belongs to rank s mod
    n (u's block r and z's block r, i.e. s = r and s = n + r): one
    uneven all-to-all over ``model`` (``comm.collectives.exchange``,
    whose backward is the reverse) moves each block to its rank, which
    receives u's block first (from rank r // 2) and z's second."""
    n, me = mesh.shape["model"], mesh.coords["model"]
    w = xz.shape[-1] // 2
    blocks = sorted((((2 * me + i) % n, xz[..., i * w:(i + 1) * w])
                     for i in range(2)), key=lambda t: t[0])
    send, recv = [0] * n, [0] * n
    for dest, _ in blocks:
        send[dest] = w
    recv[me // 2] += w
    recv[(n + me) // 2] += w
    cols = torch.cat([b for _, b in blocks], dim=-1).movedim(-1, 0)
    out = coll.exchange(cols, mesh, "model", send, recv).movedim(0, -1)
    return out[..., :w], out[..., w:]


def _project_qkv(cfg, p, x):
    """q, k and v from ``x``; the head counts are the weights' (this
    rank's heads under tensor parallelism)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


def cross_kv(cfg: ModelConfig, p, enc_out):
    """A cross-attention's (k, v) from an encoder's output (B, T, D): (B,
    T, kv, hd) each, this rank's KV heads under tensor parallelism (the
    encoder's output then enters through ``copy_to``)."""
    p, mesh = _attention_tp(cfg, p)
    enc_out = coll.copy_to(enc_out, mesh, "model")
    b, t, _ = enc_out.shape
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, t, -1, cfg.head_dim)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, t, -1, cfg.head_dim)
    return k, v


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
    p, mesh = _attention_tp(cfg, p)
    x = coll.copy_to(x, mesh, "model")
    if cross_kv is not None:
        q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, cfg.head_dim)
        if positions is not None and cfg.pos_type == "rope":
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        out = ops.flash_attention(q, *cross_kv, causal=False, impl=impl)
        return row_parallel(out.reshape(b, s, -1), p["wo"], mesh), None
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
    return row_parallel(out.reshape(b, s, -1), p["wo"], mesh), new_kv


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"w_in": PDef((d, f), ("embed", "ff")),
            "w_out": PDef((f, d), ("ff", "embed"))}
    if cfg.mlp_type == "swiglu":
        defs["w_gate"] = PDef((d, f), ("embed", "ff"))
    return defs


def mlp_apply(cfg: ModelConfig, p, x, d_ff: Optional[int] = None):
    """SwiGLU, or GeLU (the tanh approximation, ``jax.nn.gelu``'s
    default).  ``d_ff``: the FFN's whole width (``mlp_defs``'), which
    tells whether tensor parallelism split it: then ``w_in``/``w_gate``
    are column-parallel and ``w_out`` row-parallel."""
    mesh = actsharding.tp()[0] if actsharding.tp_splits(
        d_ff or cfg.d_ff) else None
    x = coll.copy_to(x, mesh, "model")
    h = x @ p["w_in"].to(x.dtype)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return row_parallel(h, p["w_out"], mesh)


def vocab_split(cfg: ModelConfig) -> bool:
    """Whether tensor parallelism splits the vocabulary here: each rank
    then holds V / size rows of ``tok`` (and columns of ``head``),
    rank-major over ``model``."""
    return actsharding.tp_splits(cfg.vocab_size)


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
    if vocab_split(cfg):
        mesh = actsharding.tp()[0]
        # vocab-parallel: this rank's rows, a zero row for every other id,
        # summed over ``model``
        rows = p["tok"].shape[0]
        local = tokens.long() - mesh.coords["model"] * rows
        hit = (local >= 0) & (local < rows)
        x = p["tok"][local.clamp(0, rows - 1)].to(dtype)
        x = coll.reduce_from(x * hit[..., None].to(dtype), mesh, "model")
    else:
        x = p["tok"][tokens].to(dtype)
    if cfg.pos_type == "sinusoidal":
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model, offset,
                                     tokens.device).to(dtype)[None]
    return x


def logits_apply(cfg: ModelConfig, p, x, impl=None):
    """The logits; under a vocab-parallel split (``vocab_split``) only
    this rank's columns."""
    x = norm_apply(cfg, p["final_norm"], x, impl=impl)
    if vocab_split(cfg):
        x = coll.copy_to(x, actsharding.tp()[0], "model")
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)
