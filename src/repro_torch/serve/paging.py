"""Block-paged KV cache: page pool + block table + free list.

The engine's KV memory is a fixed pool of ``page_size``-token pages per
attention layer (``transformer.paged_cache_defs``).  A host-side
:class:`PageAllocator` (numpy) owns the physical pages: a free list, the
``(n_slots, pages_per_slot)`` block table, and per-slot fill lengths.
Page 0 (with shards, each shard's first page) is the *null page*: never
allocated, it absorbs KV writes from empty slots and prompt padding, so
the steps need no masking.

``scatter_prefill`` moves a legacy prefill's contiguous KV into the
slot's pages.  The port updates the pool in place (the JAX engine
donates its pool to the jitted step, so the effect is the same).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models import transformer

@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Physical layout of the paged KV pool for one engine.

    ``n_pages`` counts the null page(s): never allocated, they absorb
    writes from empty slots and prompt padding.  A slot's capacity is
    ``pages_per_slot * page_size`` tokens.  ``n_shards > 1`` splits the
    pool over data-parallel shards, each with its own null page and free
    list (see :class:`PageAllocator`).
    """

    page_size: int
    pages_per_slot: int
    n_pages: int
    n_shards: int = 1


def round_up(n_tokens: int, page_size: int) -> int:
    """Smallest page-aligned token count >= ``n_tokens``."""
    return -(-n_tokens // page_size) * page_size


def init_pool(cfg: ModelConfig, n_slots: int, layout: PagedLayout, device):
    """The zeroed bf16 page pools, ``{"p{i}": {"k", "v"}}`` of
    ``(reps, n_pages, page_size, kv, hd)``."""
    defs = transformer.paged_cache_defs(cfg, n_slots, layout.n_pages,
                                        layout.page_size)
    return P.tree_map(
        lambda d: torch.zeros(d.shape, dtype=P.DTYPES[d.dtype],
                              device=device), defs)


def pad_prefill_cache(cfg: ModelConfig, pcache, cap: int):
    """Zero-pad a prefill cache's KV seq dim up to ``cap`` (a page
    multiple) so ``scatter_prefill`` can reshape it into pages; the
    padded positions stay masked by the slot's length until decode
    overwrites them."""
    return {key: {n: F.pad(a, (0, 0, 0, 0, 0, cap - a.shape[2]))
                  for n, a in kv.items()}
            for key, kv in pcache.items()}


def scatter_prefill(cfg: ModelConfig, pool, pcache, page_rows):
    """Write a prefill's contiguous KV into the pool, in place.

    pcache leaves are ``(reps, B, prefill_len, kv, hd)``; ``page_rows``
    is ``(B, prefill_len / page_size)`` destination page ids,
    null-padded past each prompt's pages.  Returns the pool."""
    rows = page_rows.long()
    for key, kv in pcache.items():
        for n, src in kv.items():
            dst = pool[key][n]          # (reps, n_pages, page, kv, hd)
            reps, b, cap = src.shape[:3]
            page = dst.shape[2]
            dst[:, rows] = src.reshape(reps, b, cap // page, page,
                                       *src.shape[3:]).to(dst.dtype)
    return pool


class PageAllocator:
    """Host-side page/slot bookkeeping for one engine.

    Admission is length-aware: a request reserves its worst-case page
    count (prompt + max generated tokens) up front, so decode-time page
    allocation can never fail mid-flight; the pages themselves are
    handed out lazily as the sequence grows and returned to the free
    list the moment the slot is evicted.

    With ``layout.n_shards > 1`` (data-parallel page-pool sharding) the
    pool splits into ``n_shards`` contiguous page ranges, one per data
    shard, each with its OWN free list and its own null page (the
    range's first id) — slot ``s`` lives on shard ``s // (n_slots /
    n_shards)`` and only ever owns pages from its shard, so a
    data-sharded pool never writes across shard boundaries.  The
    single-shard layout is bit-compatible with the classic allocator
    (page 0 the null page, one LIFO free list).
    """

    def __init__(self, n_slots: int, layout: PagedLayout):
        self.layout = layout
        self.n_slots = n_slots
        ns = getattr(layout, "n_shards", 1) or 1
        assert layout.n_pages % ns == 0, (layout.n_pages, ns)
        assert n_slots % ns == 0, (n_slots, ns)
        self.n_shards = ns
        self._stride = layout.n_pages // ns
        self._slots_per_shard = n_slots // ns
        # LIFO free lists (one per shard): freed pages are re-used first
        # (the eviction re-use path the tests pin down); each shard's
        # null page (its first id) never enters the list
        self._free: List[List[int]] = [
            list(range((r + 1) * self._stride - 1, r * self._stride, -1))
            for r in range(ns)]
        self.free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self.block_table = np.zeros((n_slots, layout.pages_per_slot),
                                    np.int32)
        for slot in range(n_slots):
            self.block_table[slot, :] = self.null_page_of(slot)
        self.lengths = np.zeros((n_slots,), np.int32)
        self._reserved = np.zeros((n_slots,), np.int64)

    # -- shard mapping ------------------------------------------------------
    def shard_of(self, slot: int) -> int:
        return slot // self._slots_per_shard

    def null_page_of(self, slot: int) -> int:
        return self.shard_of(slot) * self._stride      # 0 when n_shards == 1

    @property
    def free_pages(self) -> List[int]:
        """All free pages, shard-major (THE free list when unsharded)."""
        if self.n_shards == 1:
            return self._free[0]
        return [p for shard in self._free for p in shard]

    @free_pages.setter
    def free_pages(self, pages):
        """Restore path (elastic park/adopt): pages re-bucket into their
        owning shard's list, order preserved."""
        self._free = [[] for _ in range(self.n_shards)]
        for p in pages:
            self._free[int(p) // self._stride].append(int(p))

    # -- capacity queries ---------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.layout.page_size)

    @property
    def reserved(self) -> int:
        return int(self._reserved.sum())

    def _shard_free(self, shard: int) -> int:
        """Unreserved pages available on one shard."""
        lo, hi = (shard * self._slots_per_shard,
                  (shard + 1) * self._slots_per_shard)
        return len(self._free[shard]) - int(self._reserved[lo:hi].sum())

    def _fit_slot(self, need_pages: int):
        """First free slot (in hand-out order) whose shard can hold the
        request; None when no shard fits it."""
        for slot in reversed(self.free_slots):         # pop() order
            if need_pages <= self._shard_free(self.shard_of(slot)):
                return slot
        return None

    def max_admit_pages(self) -> int:
        """Largest worst-case page reservation any admission could make
        right now: the best free-page count over shards that still own a
        free slot (-1 when no slot is free).  Lets the scheduler stop a
        first-fit pass early — once every remaining waiting request
        needs more than this, no candidate can be admitted this tick."""
        best = -1
        seen = set()
        for slot in self.free_slots:
            shard = self.shard_of(slot)
            if shard not in seen:
                seen.add(shard)
                best = max(best, self._shard_free(shard))
        return best

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        total = prompt_len + max_new
        if total > self.layout.pages_per_slot * self.layout.page_size:
            return False
        if not self.free_slots:
            return False
        return self._fit_slot(self.pages_for(total)) is not None

    # -- slot lifecycle -----------------------------------------------------
    def admit(self, prompt_len: int, max_new: int) -> int:
        assert self.can_admit(prompt_len, max_new)
        slot = self._fit_slot(self.pages_for(prompt_len + max_new))
        self.free_slots.remove(slot)
        shard = self.shard_of(slot)
        need = self.pages_for(prompt_len)
        for j in range(need):
            self.block_table[slot, j] = self._free[shard].pop()
        self._reserved[slot] = self.pages_for(prompt_len + max_new) - need
        self.lengths[slot] = prompt_len
        return slot

    def ensure_page(self, slot: int):
        """Allocate the page holding position ``lengths[slot]`` (the next
        write) if the slot does not own it yet."""
        idx = int(self.lengths[slot]) // self.layout.page_size
        if self.block_table[slot, idx] == self.null_page_of(slot):
            self.block_table[slot, idx] = \
                self._free[self.shard_of(slot)].pop()
            self._reserved[slot] -= 1

    def advance(self, slot: int):
        self.lengths[slot] += 1

    def free(self, slot: int):
        """Evict: return the slot's pages to its shard's free list."""
        null = self.null_page_of(slot)
        shard = self.shard_of(slot)
        for page in self.block_table[slot]:
            if page != null:
                self._free[shard].append(int(page))
        self.block_table[slot, :] = null
        self.lengths[slot] = 0
        self._reserved[slot] = 0
        self.free_slots.append(slot)

    # -- stats --------------------------------------------------------------
    def pages_in_use(self) -> int:
        nulls = np.array([self.null_page_of(s) for s in range(self.n_slots)],
                         np.int32)
        return int((self.block_table != nulls[:, None]).sum())

    def pages_in_use_by_shard(self) -> List[int]:
        """Allocated (non-null) page count per pool shard — the
        occupancy gauge the metrics registry exports per tick."""
        nulls = np.array([self.null_page_of(s) for s in range(self.n_slots)],
                         np.int32)
        used = (self.block_table != nulls[:, None]).sum(axis=1)
        return [int(used[r * self._slots_per_shard:
                         (r + 1) * self._slots_per_shard].sum())
                for r in range(self.n_shards)]
