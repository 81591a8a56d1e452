"""Layer stack: attention, Mamba, mLSTM and sLSTM positions, each with
a dense or MoE FFN where the JAX package gives it one, a cross-attention
block after each attention position of an encoder-decoder (whisper), and
the encoder stack itself.

Parameters for each block-pattern position are stacked over
``cfg.n_repeats`` under the keys ``p{i}`` (the JAX package's layout, so
a JAX parameter tree carries across unchanged); the stack runs as a
Python loop over the repeats, each stacked leaf unbound once into its
layers' slices.  Attention keeps KV (contiguous, or paged in the
engine's pool) and, under cross-attention, the encoder's projected
``xk``/``xv``; a sequence mixer keeps a recurrent state, slot-major in
the pool.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import actsharding
from repro_torch.models import layers, mamba, moe, xlstm
from repro_torch.models.params import DTYPES, PDef, stack, tree_map

F32_STATES = ("ssm", "C", "n", "m", "c", "h")   # state leaves kept float32
MIXERS = {"mamba": mamba.mamba_apply, "mlstm": xlstm.mlstm_apply,
          "slstm": xlstm.slstm_apply}
_STATE_SHAPES = {"mamba": mamba.mamba_cache_shape,
                 "mlstm": xlstm.mlstm_cache_shape,
                 "slstm": xlstm.slstm_cache_shape}
# each state leaf's logical axes, the JAX package's (dist/sharding.py's
# cache_rules read them); an sLSTM leaf is ("batch", None)
_STATE_AXES = {"mamba": {"conv": ("batch", None, "mamba_in"),
                         "ssm": ("batch", "mamba_in", None)},
               "mlstm": {"conv": ("batch", None, "xl_in"),
                         "C": ("batch", "xl_heads", None, None),
                         "n": ("batch", "xl_heads", None),
                         "m": ("batch", "xl_heads")}}


def _pos_has_ffn(cfg: ModelConfig, i: int) -> bool:
    # xLSTM cells are complete blocks; attn/mamba positions carry an FFN.
    return cfg.block_pattern[i] in ("attn", "mamba") and (
        cfg.d_ff > 0 or cfg.moe is not None)


def _pos_is_moe(cfg: ModelConfig, i: int) -> bool:
    return (cfg.moe is not None and _pos_has_ffn(cfg, i)
            and (i % cfg.moe.every) == (cfg.moe.every - 1))


def position_defs(cfg: ModelConfig, i: int, cross: bool = False):
    kind = cfg.block_pattern[i]
    d = {"norm1": layers.norm_defs(cfg)}
    if kind == "attn":
        d["attn"] = layers.attention_defs(cfg)
    elif kind == "mamba":
        d["mamba"] = mamba.mamba_defs(cfg)
    elif kind == "mlstm":
        d["mlstm"] = xlstm.mlstm_defs(cfg)
    elif kind == "slstm":
        d["slstm"] = xlstm.slstm_defs(cfg)
    else:
        raise ValueError(kind)
    if cross:
        d["norm_x"] = layers.norm_defs(cfg)
        d["xattn"] = layers.attention_defs(cfg, cross=True)
    if _pos_has_ffn(cfg, i):
        d["norm2"] = layers.norm_defs(cfg)
        if _pos_is_moe(cfg, i):
            d["moe"] = moe.moe_defs(cfg)
        else:
            d["mlp"] = layers.mlp_defs(cfg)
    return d


def stack_defs(cfg: ModelConfig, cross: bool = False):
    return {f"p{i}": stack(position_defs(cfg, i, cross), cfg.n_repeats)
            for i in range(cfg.pattern_len)}


def encoder_defs(cfg: ModelConfig):
    """Non-causal attention + MLP encoder stack (whisper)."""
    d = {"norm1": layers.norm_defs(cfg),
         "attn": layers.attention_defs(cfg),
         "norm2": layers.norm_defs(cfg),
         "mlp": layers.mlp_defs(cfg)}
    return {"enc": stack(d, cfg.encoder_layers),
            "enc_norm": layers.norm_defs(cfg)}


def state_defs(cfg: ModelConfig, kind: str, batch: int):
    """A sequence mixer's recurrent state for ``batch`` rows (one layer):
    the conv ring in bfloat16, the rest (``F32_STATES``) in float32."""
    axes = _STATE_AXES.get(kind, {})
    return {n: PDef(sh, axes.get(n, ("batch", None)), init="zeros",
                    dtype="float32" if n in F32_STATES else "bfloat16")
            for n, sh in _STATE_SHAPES[kind](cfg, batch).items()}


def _kv_defs(batch: int, seq_len: int, kv: int, hd: int, axes):
    return {n: PDef((batch, seq_len, kv, hd), axes, init="zeros",
                    dtype="bfloat16") for n in ("k", "v")}


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int,
               enc_len: int = 0):
    """Contiguous decode-state schema per position, stacked over the
    repeats: bf16 KV ``(batch, seq_len, kv, hd)`` for attention (and of
    an encoder-decoder the encoder's ``xk``/``xv``, ``(batch, enc_len,
    kv, hd)``), the recurrent state (``state_defs``) for a sequence
    mixer."""
    axes = ("batch", "kv_seq", "kv_heads", None)
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn":
            c = _kv_defs(batch, seq_len, cfg.n_kv_heads, cfg.head_dim, axes)
            if cfg.encoder_layers:
                cross = _kv_defs(batch, enc_len, cfg.n_kv_heads,
                                 cfg.head_dim, axes)
                c.update(xk=cross["k"], xv=cross["v"])
        else:
            c = state_defs(cfg, kind, batch)
        out[f"p{i}"] = stack(c, cfg.n_repeats)
    return out


def paged_cache_defs(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, n_shards: int = 1):
    """Paged decode-state schema: attention KV in one bf16 pool
    ``(n_pages, page_size, kv, hd)`` per position and layer, indexed by
    the engine's block table (page 0 is the null page, never allocated);
    sequence-mixer state slot-major, ``(n_slots, ...)``.  Decoder-only
    architectures: an encoder-decoder raises, as in the JAX package.

    ``n_shards > 1`` names the page dim with the logical ``pages`` axis,
    so ``cache_rules`` can split the pool over the data tier (the
    allocator's shards: each slot's pages lie in its own shard, see
    ``serve/paging``); otherwise the page dim names no axis."""
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: paged serving supports decoder-only "
                         f"architectures")
    pages_ax = "pages" if n_shards > 1 else None
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        c = (_kv_defs(n_pages, page_size, cfg.n_kv_heads, cfg.head_dim,
                      (pages_ax, None, "kv_heads", None))
             if kind == "attn" else state_defs(cfg, kind, n_slots))
        out[f"p{i}"] = stack(c, cfg.n_repeats)
    return out


def _zero_state(cfg, kind, batch, device):
    """A zeroed state of ``batch`` rows, of the shapes a pool row has:
    under tensor parallelism the rank's part of each leaf
    (``actsharding.tp_state_shape``)."""
    return tree_map(lambda d: torch.zeros(actsharding.tp_state_shape(d),
                                          dtype=DTYPES[d.dtype],
                                          device=device),
                    state_defs(cfg, kind, batch))


def _apply_position(cfg, i, p, x, *, positions, mode, cache=None,
                    cache_index=None, enc_out=None, paging=None, impl=None):
    """One pattern position: (x, its cache leaves or None, its MoE aux
    loss or None).  Attention returns its (k, v) as ``{"k", "v"}``; an
    encoder-decoder's cross-attention then projects ``enc_out`` (train
    and prefill, where the prefill also returns the projections as
    ``xk``/``xv`` in bf16) or reads ``xk``/``xv`` from the cache
    (decode, which leaves them as they are).  A
    sequence mixer starts from m = NEG in training (no cache, as the
    JAX package's loss), from a zeroed state in a prompt prefill (as its
    ``Model.prefill`` threads a zeroed cache), and from ``cache``
    otherwise, whose leaves it overwrites in place."""
    kind = cfg.block_pattern[i]
    h = layers.norm_apply(cfg, p["norm1"], x, impl=impl)
    if kind == "attn":
        out, kvs = layers.attention_apply(
            cfg, p["attn"], h, positions=positions, causal=cfg.causal,
            cache=cache, cache_index=cache_index, paging=paging, impl=impl)
        new = {"k": kvs[0], "v": kvs[1]}
        if cfg.encoder_layers:
            # cross-attention after the self-attention's residual; the
            # residual below adds the cross-attention's
            x = x + out
            hx = layers.norm_apply(cfg, p["norm_x"], x, impl=impl)
            if mode == "decode":
                xk, xv = cache["xk"], cache["xv"]
            else:
                xk, xv = layers.cross_kv(cfg, p["xattn"],
                                         enc_out.to(hx.dtype))
                if mode == "prefill":
                    new.update(xk=xk.to(torch.bfloat16),
                               xv=xv.to(torch.bfloat16))
            out, _ = layers.attention_apply(
                cfg, p["xattn"], hx, positions=None,
                cross_kv=(xk.to(hx.dtype), xv.to(hx.dtype)), impl=impl)
    else:
        state = cache
        if mode == "prefill" and cache is None:
            state = _zero_state(cfg, kind, x.shape[0], x.device)
        out, new = MIXERS[kind](cfg, p[kind], h, cache=state)
        if cache is not None:
            for n, t in new.items():
                cache[n].copy_(t)
            new = cache
    x = x + out
    aux = None
    if _pos_has_ffn(cfg, i):
        h = layers.norm_apply(cfg, p["norm2"], x, impl=impl)
        if _pos_is_moe(cfg, i):
            out, metrics = moe.moe_apply(cfg, p["moe"], h, impl=impl)
            aux = metrics["moe_aux_loss"]
        else:
            out = layers.mlp_apply(cfg, p["mlp"], h)
        x = x + out
    return x, new, aux


def _superblock(cfg, pslice, x, positions, mode, cslice, cache_index,
                enc_out, paging, impl):
    """All pattern positions of one repeat: (x, {"p{i}": cache leaves},
    the sum of their MoE aux losses, 0.0 without MoE)."""
    caches, aux_sum = {}, 0.0
    for i in range(cfg.pattern_len):
        key = f"p{i}"
        x, caches[key], aux = _apply_position(
            cfg, i, pslice[key], x, positions=positions, mode=mode,
            cache=None if cslice is None else cslice[key],
            cache_index=cache_index, enc_out=enc_out, paging=paging,
            impl=impl)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, caches, aux_sum


def _train_superblock(cfg, pslice, x, positions, enc_out, impl, ctx=None):
    # the aux loss is an output of the checkpointed block, so its
    # gradient flows through the recomputation like x's.  FSDP's gather
    # of the repeat's weights happens here, inside the checkpointed
    # region: the recomputation gathers again, and no gathered weight
    # outlives its layer.  ``ctx``: the activation-sharding context the
    # block ran under, for its recomputation
    with actsharding.reenter(ctx):
        cross = bool(cfg.encoder_layers)
        pslice = {key: actsharding.gather_leaves(
            pslice[key], position_defs(cfg, int(key[1:]), cross),
            skip=("moe",)) for key in sorted(pslice)}
        x, _, aux = _superblock(cfg, pslice, x, positions, "train", None,
                                None, enc_out, None, impl)
    return x, aux


def stack_apply(cfg: ModelConfig, blocks, x, *, positions, caches=None,
                cache_index=None, enc_out=None, mode="train", remat=True,
                paging=None, impl=None):
    """Run the layer stack: (x, caches, aux) where ``aux`` is the float32
    sum of every MoE position's aux loss (0 without MoE), as the JAX
    package's stack returns it.

    ``mode="train"`` (the loss) keeps no KV or state and returns caches
    None; with ``remat`` each super-block (all pattern positions of one
    repeat) runs under ``torch.utils.checkpoint`` (non-reentrant), as the
    JAX package checkpoints each scanned super-block: only its input is
    kept for the backward, and everything inside it (the bfloat16 copies
    of its weights included) is recomputed there.  Otherwise, without
    ``caches`` (prompt prefill) it returns each position's prompt KV,
    ``{"k", "v"}``, or a sequence mixer's state after the prompt, stacked
    over the repeats under ``p{i}`` (with an encoder's ``enc_out``, the
    cross-attention's ``xk``/``xv`` beside them); with caches (page pools with
    ``paging``, contiguous caches with the int ``cache_index``) it writes
    the new KV and state into them in place and returns them.

    Each stacked leaf is unbound once, so the backward stacks the layers'
    gradients once instead of scattering every layer into a zero-filled
    copy."""
    per_layer = tree_map(lambda t: t.unbind(0), blocks)
    per_cache = None if caches is None else tree_map(
        lambda t: t.unbind(0), caches)
    new = {f"p{i}": {} for i in range(cfg.pattern_len)}
    aux_total = 0.0
    for r in range(cfg.n_repeats):
        pslice = tree_map(lambda ts: ts[r], per_layer)
        if mode == "train":
            if remat:
                x, aux = checkpoint(_train_superblock, cfg, pslice, x,
                                    positions, enc_out, impl,
                                    actsharding.current(),
                                    use_reentrant=False)
            else:
                x, aux = _train_superblock(cfg, pslice, x, positions,
                                           enc_out, impl)
            aux_total = aux_total + aux
            continue
        cslice = None if caches is None else tree_map(lambda ts: ts[r],
                                                      per_cache)
        # FSDP's gather of the repeat's weights (a serving engine on a
        # mesh of ranks; the identity elsewhere)
        cross = bool(cfg.encoder_layers)
        pslice = {key: actsharding.gather_leaves(
            pslice[key], position_defs(cfg, int(key[1:]), cross),
            skip=("moe",)) for key in sorted(pslice)}
        x, layer_caches, aux = _superblock(cfg, pslice, x, positions, mode,
                                          cslice, cache_index, enc_out,
                                          paging, impl)
        aux_total = aux_total + aux
        if caches is None:
            for key, leaves in layer_caches.items():
                for n, t in leaves.items():
                    new[key].setdefault(n, []).append(t)
    # a float (no MoE position) becomes a tensor by a fill, not a copy
    # from the host, which a CUDA graph's capture would refuse
    aux_total = (aux_total.float() if torch.is_tensor(aux_total) else
                 x.new_full((), aux_total, dtype=torch.float32))
    if mode == "train":
        return x, None, aux_total
    if caches is not None:
        return x, caches, aux_total
    return x, {key: {n: torch.stack(ts) for n, ts in leaves.items()}
               for key, leaves in new.items()}, aux_total


def _encoder_layer(cfg, p, x, impl, ctx=None):
    with actsharding.reenter(ctx):
        p = actsharding.gather_leaves(p, tree_map(      # one layer's defs
            lambda d: PDef(d.shape[1:], d.axes[1:]),
            encoder_defs(cfg)["enc"]))
        h = layers.norm_apply(cfg, p["norm1"], x, impl=impl)
        out, _ = layers.attention_apply(cfg, p["attn"], h, positions=None,
                                        causal=False, impl=impl)
        x = x + out
        h = layers.norm_apply(cfg, p["norm2"], x, impl=impl)
        return x + layers.mlp_apply(cfg, p["mlp"], h)


def encoder_apply(cfg: ModelConfig, enc_params, frames, *, remat=True,
                  mode="train", impl=None):
    """The whisper-style encoder over precomputed frame embeddings
    (B, T, d_model): sinusoidal positions added, then per layer
    non-causal self-attention and the MLP, then ``enc_norm``.  Under
    ``mode="train"`` with ``remat`` each layer runs under
    ``torch.utils.checkpoint``, as the JAX package checkpoints each
    scanned layer."""
    x = frames + layers.sinusoidal_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(
            frames.dtype)[None]
    enc_params = dict(enc_params, enc_norm=actsharding.gather_leaves(
        enc_params["enc_norm"], encoder_defs(cfg)["enc_norm"]))
    per_layer = tree_map(lambda t: t.unbind(0), enc_params["enc"])
    for r in range(cfg.encoder_layers):
        p = tree_map(lambda ts: ts[r], per_layer)
        if mode == "train" and remat:
            x = checkpoint(_encoder_layer, cfg, p, x, impl,
                           actsharding.current(), use_reentrant=False)
        else:
            x = _encoder_layer(cfg, p, x, impl)
    return layers.norm_apply(cfg, enc_params["enc_norm"], x, impl=impl)
