"""Plain PyTorch decode attention: the twin of the JAX package's
``decode_attention/ref.py`` (contiguous, paged decode, paged prefill).

q (B, Sq, H, D); contiguous k, v (B, S, Hkv, D); page pools
(P, page_size, Hkv, D) indexed by a (B, pages_per_slot) block table.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, scan_blocks


def decode_ref(q, k, v, cache_len, *, scale=None):
    """Positions >= cache_len (a scalar or one per row) are masked."""
    b, sq, h, d = q.shape
    _, smax, hkv, _ = k.shape
    scale = scale or d ** -0.5
    qg = q.reshape(b, sq, hkv, h // hkv, d).float()
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    pos = torch.arange(smax, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    valid = pos[None] < lens[:, None]
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _gather(pages, block_table):
    b, maxp = block_table.shape
    _, page, hkv, d = pages.shape
    return pages[block_table.long()].reshape(b, maxp * page, hkv, d)


def paged_decode_ref(q, k_pages, v_pages, block_table, lengths, *,
                     scale=None):
    """Gather each slot's pages into a contiguous cache, then
    ``decode_ref`` with per-slot ``lengths``."""
    return decode_ref(q, _gather(k_pages, block_table),
                      _gather(v_pages, block_table), lengths, scale=scale)


def paged_prefill_ref(q, k_pages, v_pages, block_table, start, n_valid, *,
                      scale=None, block_kv=1024):
    """A chunk of C prompt rows at positions ``start[b] + j`` over the
    slot's gathered pages (the chunk's own KV already written).

    Replays the flash ref's block scan (``scan_blocks``: GQA repeat, the
    same blocks, running max and normalizer) with a per-row causal limit,
    so chunked prefill matches the whole-prompt prefill.  Rows at or
    past ``n_valid`` are padding: their output is garbage that callers
    discard.
    """
    b, sq, h, d = q.shape
    g = h // k_pages.shape[2]
    k = _gather(k_pages, block_table)
    v = _gather(v_pages, block_table)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qpos = (torch.as_tensor(start, device=q.device).reshape(-1, 1)
            + torch.arange(sq, device=q.device)[None, :])
    del n_valid                    # padding rows are the caller's problem
    return scan_blocks(q, k, v, qpos, scale=scale or d ** -0.5,
                       block_kv=block_kv)[0]
