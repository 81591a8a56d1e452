"""Layer stack of the attention-only decoder.

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
from repro_torch.models import layers
from repro_torch.models.params import PDef, stack, tree_map


def _check_attention_only(cfg: ModelConfig):
    if any(k != "attn" for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: only attention blocks are ported "
            f"(pattern {cfg.block_pattern})")


def position_defs(cfg: ModelConfig, i: int):
    _check_attention_only(cfg)
    return {"norm1": layers.norm_defs(cfg),
            "attn": layers.attention_defs(cfg),
            "norm2": layers.norm_defs(cfg),
            "mlp": layers.mlp_defs(cfg)}


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


def _apply_position(cfg, p, x, *, positions, cache=None, paging=None,
                    impl=None):
    h = layers.norm_apply(cfg, p["norm1"], x, impl=impl)
    out, kvs = layers.attention_apply(
        cfg, p["attn"], h, positions=positions, causal=cfg.causal,
        cache=cache, paging=paging, impl=impl)
    x = x + out
    h = layers.norm_apply(cfg, p["norm2"], x, impl=impl)
    return x + layers.mlp_apply(cfg, p["mlp"], h), kvs


def _superblock(cfg, pslice, x, positions, cslice, paging, impl):
    """All pattern positions of one repeat: (x, {"p{i}": (k, v)})."""
    kvs = {}
    for i in range(cfg.pattern_len):
        key = f"p{i}"
        x, kvs[key] = _apply_position(
            cfg, pslice[key], x, positions=positions,
            cache=None if cslice is None else cslice[key], paging=paging,
            impl=impl)
    return x, kvs


def _train_superblock(cfg, pslice, x, positions, impl):
    return _superblock(cfg, pslice, x, positions, None, None, impl)[0]


def stack_apply(cfg: ModelConfig, blocks, x, *, positions, caches=None,
                mode="train", remat=True, paging=None, impl=None):
    """Run the layer stack.

    ``mode="train"`` (the loss) keeps no KV and returns (x, None); with
    ``remat`` each super-block (all pattern positions of one repeat) runs
    under ``torch.utils.checkpoint`` (non-reentrant), as the JAX package
    checkpoints each scanned super-block: only its input is kept for the
    backward, and everything inside it (the bfloat16 copies of its
    weights included) is recomputed there.  Otherwise, without ``caches``
    (prompt prefill) it returns (x, {"p{i}": {"k", "v"}}) with each
    position's prompt KV stacked over the repeats; with the page pools it
    writes them in place and returns (x, caches).

    Each stacked leaf is unbound once, so the backward stacks the layers'
    gradients once instead of scattering every layer into a zero-filled
    copy."""
    per_layer = tree_map(lambda t: t.unbind(0), blocks)
    per_cache = None if caches is None else tree_map(
        lambda t: t.unbind(0), caches)
    new = {f"p{i}": {"k": [], "v": []} for i in range(cfg.pattern_len)}
    for r in range(cfg.n_repeats):
        pslice = tree_map(lambda ts: ts[r], per_layer)
        if mode == "train":
            if remat:
                x = checkpoint(_train_superblock, cfg, pslice, x, positions,
                               impl, use_reentrant=False)
            else:
                x = _train_superblock(cfg, pslice, x, positions, impl)
            continue
        cslice = None if caches is None else tree_map(lambda ts: ts[r],
                                                      per_cache)
        x, kvs = _superblock(cfg, pslice, x, positions, cslice, paging, impl)
        if caches is None:
            for key, (k, v) in kvs.items():
                new[key]["k"].append(k)
                new[key]["v"].append(v)
    if mode == "train":
        return x, None
    if caches is not None:
        return x, caches
    return x, {key: {n: torch.stack(ts) for n, ts in kv.items()}
               for key, kv in new.items()}
