"""Decode attention over a contiguous cache, paged decode and paged
chunk-prefill attention: the CUDA kernels (``csrc/decode_attention.cu``,
``csrc/paged_attention.cu``) for CUDA tensors, the plain versions
(``ref.decode_ref``, ``ref.paged_decode_ref``, ``ref.paged_prefill_ref``)
for CPU tensors.  Both decode kernels split each row's keys across
blocks; ``plan_splits`` picks the count from static shapes, and the
wrapper hands the kernel a workspace for the splits' partials."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16                 # query heads per KV head in one decode block
# paged decode's split of each slot's pages: enough blocks to give every
# SM BLOCKS_PER_SM, and no split shorter than MIN_SPLIT_KEYS keys (one
# 16-key chunk for each of a block's four warps)
BLOCKS_PER_SM = 4
MIN_SPLIT_KEYS = 64
KEY_BLOCK = 16                 # contiguous decode splits whole blocks of this


def plan_splits(pages_per_slot, page, slots_heads, sm_count):
    """How paged decode cuts each slot's block-table row (and contiguous
    decode its cache, in blocks of KEY_BLOCK keys): ``(n_split,
    pages_per_split)``, split ``s`` taking pages ``[s * pages_per_split,
    (s + 1) * pages_per_split)`` (the last may be short, none is empty).

    From static shapes alone: the row's width ``pages_per_slot``, the
    ``page`` size, ``slots_heads`` = B * Hkv blocks a split, and the
    card's SM count; never from the lengths, which live on the card.
    The kernel recomputes ``pages_per_split`` from the count by the same
    rule."""
    min_pages = -(-MIN_SPLIT_KEYS // page)
    want = -(-BLOCKS_PER_SM * sm_count // max(1, slots_heads))
    n = max(1, min(want, pages_per_slot // min_pages))
    pps = max(1, -(-pages_per_slot // n))
    n = max(1, -(-pages_per_slot // pps))
    return n, max(1, -(-pages_per_slot // n))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, cache_len, *, scale=None):
    """q: (B, 1, H, D); k, v: (B, S, Hkv, D); cache_len: one number for
    every row (an int, or a one-element tensor read once on the host),
    at least 1.  Keys at or past ``cache_len`` are never read."""
    if q.device.type == "cpu":
        return ref.decode_ref(q, k, v, cache_len, scale=scale)
    b, one, h, d = q.shape
    _, s, hkv, _ = k.shape
    if d not in HEAD_DIMS or h % hkv or h // hkv > MAX_GROUP or one != 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} over "
                         f"{hkv} KV heads (one query row, head dim in "
                         f"{HEAD_DIMS}, at most {MAX_GROUP} heads per KV "
                         f"head)")
    n = int(cache_len)
    if n < 1:
        raise ValueError(f"decode_attention: cache_len {n} < 1")
    build.refuse_autograd("decode_attention", q, k, v)
    build.check(q, "decode_attention q", torch.bfloat16)
    build.check(k, "decode_attention k", torch.bfloat16, (b, s, hkv, d))
    build.check(v, "decode_attention v", torch.bfloat16, (b, s, hkv, d))
    # split as paged decode splits a page pool of KEY_BLOCK-key pages, so
    # a row's keys split alike in both (and give the same bits)
    n_split, _ = plan_splits(-(-s // KEY_BLOCK), KEY_BLOCK, b * hkv,
                             _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    ws = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    build.launch("decode_attention", "decode_attention_bf16", q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), b, s, h, hkv, d, n, n_split,
                 float(scale or d ** -0.5))
    return out


def _check_pool(q, k_pages, v_pages, block_table, what):
    b, _, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"{what}: head dim {d} (takes {HEAD_DIMS}), "
                         f"heads {h} over {hkv} KV heads")
    build.refuse_autograd(what, q, k_pages, v_pages)
    build.check(q, f"{what} q", torch.bfloat16)
    build.check(k_pages, f"{what} k_pages", torch.bfloat16)
    build.check(v_pages, f"{what} v_pages", torch.bfloat16, k_pages.shape)
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"{what}: block_table must be (B={b}, pages_per_slot)")
    build.check(block_table, f"{what} block_table", torch.int32)
    return b, h, hkv, d, page, block_table.shape[1]


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           scale=None):
    """q: (B, 1, H, D); pools (P, page, Hkv, D); block_table (B, pps)
    int32; lengths (B,) int32 visible keys per slot."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, block_table,
                                    lengths, scale=scale)
    b, h, hkv, d, page, maxp = _check_pool(q, k_pages, v_pages, block_table,
                                           "paged_decode")
    if q.shape[1] != 1 or h // hkv > MAX_GROUP:
        raise ValueError(f"paged_decode: one query row per slot and at most "
                         f"{MAX_GROUP} heads per KV head, got {tuple(q.shape)}")
    build.check(lengths, "paged_decode lengths", torch.int32, (b,))
    n_split, _ = plan_splits(maxp, page, b * hkv, _sm_count(q.device.index
                                                           or 0))
    out = torch.empty_like(q)
    # each (slot, head, split): D f32 sums, then its max and normalizer
    ws = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    build.launch("paged_decode", "paged_decode_bf16", q.device, q.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), b, h, hkv, d, page, maxp, n_split,
                 float(scale or d ** -0.5))
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_table, start, n_valid,
                            *, scale=None):
    """q: (B, C, H, D) chunk rows at positions start[b] + j; pools and
    block table as for decode; start, n_valid (B,) int32.  Rows at or
    past n_valid are padding whose output is garbage."""
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, k_pages, v_pages, block_table,
                                     start, n_valid, scale=scale)
    b, h, hkv, d, page, maxp = _check_pool(q, k_pages, v_pages, block_table,
                                           "paged_prefill")
    build.check(start, "paged_prefill start", torch.int32, (b,))
    build.check(n_valid, "paged_prefill n_valid", torch.int32, (b,))
    out = torch.empty_like(q)
    build.launch("paged_prefill", "paged_prefill_bf16", q.device,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), start.data_ptr(), n_valid.data_ptr(),
                 out.data_ptr(), b, q.shape[1], h, hkv, d, page, maxp,
                 float(scale or d ** -0.5))
    return out
