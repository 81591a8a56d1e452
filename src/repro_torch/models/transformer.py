"""Layer stack of the attention-only decoders (dense or MoE FFNs).

Parameters for each block-pattern position are stacked over
``cfg.n_repeats`` under the keys ``p{i}`` (the JAX package's layout, so
a JAX parameter tree carries across unchanged); the stack runs as a
Python loop over the repeats, each stacked leaf unbound once into its
layers' slices.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe
from repro_torch.models.params import PDef, stack, tree_map


def _check_attention_only(cfg: ModelConfig):
    if any(k != "attn" for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: only attention blocks are ported "
            f"(pattern {cfg.block_pattern})")


def _pos_has_ffn(cfg: ModelConfig, i: int) -> bool:
    # xLSTM cells are complete blocks; attn/mamba positions carry an FFN.
    return cfg.block_pattern[i] in ("attn", "mamba") and (
        cfg.d_ff > 0 or cfg.moe is not None)


def _pos_is_moe(cfg: ModelConfig, i: int) -> bool:
    return (cfg.moe is not None and _pos_has_ffn(cfg, i)
            and (i % cfg.moe.every) == (cfg.moe.every - 1))


def position_defs(cfg: ModelConfig, i: int):
    _check_attention_only(cfg)
    d = {"norm1": layers.norm_defs(cfg), "attn": layers.attention_defs(cfg)}
    if _pos_has_ffn(cfg, i):
        d["norm2"] = layers.norm_defs(cfg)
        if _pos_is_moe(cfg, i):
            d["moe"] = moe.moe_defs(cfg)
        else:
            d["mlp"] = layers.mlp_defs(cfg)
    return d


def stack_defs(cfg: ModelConfig):
    return {f"p{i}": stack(position_defs(cfg, i), cfg.n_repeats)
            for i in range(cfg.pattern_len)}


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int):
    """Contiguous KV schema per position, stacked over the repeats."""
    _check_attention_only(cfg)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    c = {n: PDef((batch, seq_len, kv, hd),
                 ("batch", "kv_seq", "kv_heads", None),
                 init="zeros", dtype="bfloat16") for n in ("k", "v")}
    return {f"p{i}": stack(c, cfg.n_repeats) for i in range(cfg.pattern_len)}


def paged_cache_defs(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int):
    """Paged KV schema: one bf16 pool ``(n_pages, page_size, kv, hd)``
    per position and layer, indexed by the engine's block table.  Page 0
    is the null page, never allocated."""
    _check_attention_only(cfg)
    del n_slots                    # attention keeps no slot-major state
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    c = {n: PDef((n_pages, page_size, kv, hd), (None, None, "kv_heads", None),
                 init="zeros", dtype="bfloat16") for n in ("k", "v")}
    return {f"p{i}": stack(c, cfg.n_repeats) for i in range(cfg.pattern_len)}


def _apply_position(cfg, i, p, x, *, positions, cache=None, cache_index=None,
                    paging=None, impl=None):
    """One pattern position: (x, (k, v), its MoE aux loss or None)."""
    h = layers.norm_apply(cfg, p["norm1"], x, impl=impl)
    out, kvs = layers.attention_apply(
        cfg, p["attn"], h, positions=positions, causal=cfg.causal,
        cache=cache, cache_index=cache_index, paging=paging, impl=impl)
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
    return x, kvs, aux


def _superblock(cfg, pslice, x, positions, cslice, cache_index, paging,
                impl):
    """All pattern positions of one repeat: (x, {"p{i}": (k, v)}, the sum
    of their MoE aux losses, 0.0 without MoE)."""
    kvs, aux_sum = {}, 0.0
    for i in range(cfg.pattern_len):
        key = f"p{i}"
        x, kvs[key], aux = _apply_position(
            cfg, i, pslice[key], x, positions=positions,
            cache=None if cslice is None else cslice[key],
            cache_index=cache_index, paging=paging, impl=impl)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, kvs, aux_sum


def _train_superblock(cfg, pslice, x, positions, impl):
    # the aux loss is an output of the checkpointed block, so its
    # gradient flows through the recomputation like x's
    x, _, aux = _superblock(cfg, pslice, x, positions, None, None, None, impl)
    return x, aux


def stack_apply(cfg: ModelConfig, blocks, x, *, positions, caches=None,
                cache_index=None, mode="train", remat=True, paging=None,
                impl=None):
    """Run the layer stack: (x, caches, aux) where ``aux`` is the float32
    sum of every MoE position's aux loss (0 without MoE), as the JAX
    package's stack returns it.

    ``mode="train"`` (the loss) keeps no KV and returns caches None; with
    ``remat`` each super-block (all pattern positions of one repeat) runs
    under ``torch.utils.checkpoint`` (non-reentrant), as the JAX package
    checkpoints each scanned super-block: only its input is kept for the
    backward, and everything inside it (the bfloat16 copies of its
    weights included) is recomputed there.  Otherwise, without ``caches``
    (prompt prefill) it returns each position's prompt KV stacked over
    the repeats, ``{"p{i}": {"k", "v"}}``; with caches (page pools with
    ``paging``, contiguous caches with the int ``cache_index``) it writes
    the new KV into them in place and returns them.

    Each stacked leaf is unbound once, so the backward stacks the layers'
    gradients once instead of scattering every layer into a zero-filled
    copy."""
    per_layer = tree_map(lambda t: t.unbind(0), blocks)
    per_cache = None if caches is None else tree_map(
        lambda t: t.unbind(0), caches)
    new = {f"p{i}": {"k": [], "v": []} for i in range(cfg.pattern_len)}
    aux_total = 0.0
    for r in range(cfg.n_repeats):
        pslice = tree_map(lambda ts: ts[r], per_layer)
        if mode == "train":
            if remat:
                x, aux = checkpoint(_train_superblock, cfg, pslice, x,
                                    positions, impl, use_reentrant=False)
            else:
                x, aux = _train_superblock(cfg, pslice, x, positions, impl)
            aux_total = aux_total + aux
            continue
        cslice = None if caches is None else tree_map(lambda ts: ts[r],
                                                      per_cache)
        x, kvs, aux = _superblock(cfg, pslice, x, positions, cslice,
                                  cache_index, paging, impl)
        aux_total = aux_total + aux
        if caches is None:
            for key, (k, v) in kvs.items():
                new[key]["k"].append(k)
                new[key]["v"].append(v)
    aux_total = torch.as_tensor(aux_total, dtype=torch.float32,
                                device=x.device)
    if mode == "train":
        return x, None, aux_total
    if caches is not None:
        return x, caches, aux_total
    return x, {key: {n: torch.stack(ts) for n, ts in kv.items()}
               for key, kv in new.items()}, aux_total
