"""Gradient-sync bucketing: byte-balanced buckets in reverse-layer order.
A copy of the JAX package's ``comm/bucketing.py`` over the port's PDef
trees (nested dicts, flattened in sorted key order as ``jax.tree_util``
flattens them, so a bucket's ``flat_idx`` names the same leaves in both
packages).

The two-phase hierarchical sync (``collectives.sync_grads``) moves 3x
fewer cross-pod bytes than a flat ring, but as ONE monolithic schedule
that runs strictly after the full backward pass its DCN time sits
naked on the critical path.  Bucketing restores the overlap: the param
tree is partitioned into ``n_buckets`` ~byte-balanced buckets ordered
the way backward FINALIZES gradients — deepest layers first (their
grads are complete while shallow layers are still differentiating) —
so each bucket's cross-pod phase can launch while the remaining
backward still computes.  ``overlap.schedule_overlap`` prices how much
of the DCN time that hides.

Invariants:

* every parameter leaf lands in EXACTLY one bucket;
* buckets are contiguous runs of the reverse-layer leaf order, so a
  bucket never waits on a shallower layer than its own shallowest;
* byte balance: no bucket exceeds ``2 * total/n_buckets`` unless a
  single leaf alone does (a leaf is never split across buckets).

The partition is a pure function of the PDef tree and the bucket
count — never of the live mesh — so per-bucket error-feedback
residuals keep the existing ``(cfg, strategy)``-only schema and
checkpoints/elastic remesh are untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.models import params as P


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One sync bucket: a contiguous run of reverse-layer-ordered leaves.

    ``flat_idx`` are indices into the tree's canonical flatten order
    (``params.tree_leaves``: sorted keys), so callers can slice any
    matching tree (stacked grads, EF residual) with them.
    """

    index: int
    paths: Tuple[str, ...]           # human-readable leaf paths
    flat_idx: Tuple[int, ...]        # positions in canonical flatten order
    leaf_elems: Tuple[int, ...]      # elements per leaf, same order
    n_bytes: int                     # fp32 bytes of the whole bucket

    @property
    def n_elems(self) -> int:
        return sum(self.leaf_elems)

    def padded_elems(self, unit: int) -> int:
        """Elements after the sync's per-leaf padding to ``unit``."""
        return sum(-(-n // unit) * unit for n in self.leaf_elems)


def leaf_depth(path_str: str) -> float:
    """Layer depth of a param leaf, from its tree path.

    Backward finalizes gradients deep-to-shallow, so depth orders the
    buckets: block pattern position ``p{i}`` sits at depth ``i + 1``
    (later positions are deeper in the stack), the encoder below the
    decoder blocks (its backward runs after all of theirs), and the
    embedding at depth 0 — its gradient is only complete once the very
    first layer has differentiated (and, tied, it also feeds the
    logits), so it must ride the LAST bucket.
    """
    parts = path_str.split("/")
    top = parts[0]
    if top == "embed":
        return 0.0
    if top == "encoder":
        return 0.5
    if top == "blocks" and len(parts) > 1 and parts[1].startswith("p"):
        try:
            return 1.0 + int(parts[1][1:])
        except ValueError:
            return 1.0
    return 1.0


def _flatten_defs(defs, prefix=""):
    """(path, PDef) pairs in ``params.tree_leaves`` order."""
    if isinstance(defs, dict):
        return [pd for k in sorted(defs)
                for pd in _flatten_defs(defs[k], f"{prefix}{k}/")]
    return [(prefix[:-1], defs)]


def partition_buckets(defs, n_buckets: int) -> List[GradBucket]:
    """Partition a PDef tree into ``min(n_buckets, n_leaves)`` buckets.

    Leaves are sorted by DESCENDING :func:`leaf_depth` (stable within a
    depth, preserving flatten order), then greedily grouped: a bucket
    closes once it holds ``>= total/n_buckets`` bytes, except that the
    tail always keeps at least one leaf per remaining bucket.
    """
    n_buckets = max(int(n_buckets), 1)
    flat = _flatten_defs(defs)
    if not flat:
        return []
    order = sorted(range(len(flat)),
                   key=lambda i: -leaf_depth(flat[i][0]))
    sizes = [int(np.prod(flat[i][1].shape, dtype=np.int64)) for i in order]
    total = 4 * sum(sizes)
    n_buckets = min(n_buckets, len(flat))
    target = total / n_buckets

    buckets: List[GradBucket] = []
    start = 0
    acc = 0
    for j in range(len(order)):
        acc += 4 * sizes[j]
        leaves_left = len(order) - (j + 1)        # after this leaf
        buckets_left = n_buckets - len(buckets) - 1   # after closing now
        close = (j == len(order) - 1                  # tail bucket
                 or (buckets_left > 0
                     and (leaves_left == buckets_left  # 1 leaf each left
                          or acc >= target)))
        if close:
            run = order[start:j + 1]
            buckets.append(GradBucket(
                index=len(buckets),
                paths=tuple(flat[i][0] for i in run),
                flat_idx=tuple(run),
                leaf_elems=tuple(
                    int(np.prod(flat[i][1].shape, dtype=np.int64))
                    for i in run),
                n_bytes=acc))
            start, acc = j + 1, 0
    assert start == len(order) and len(buckets) == n_buckets, \
        (start, len(order), len(buckets), n_buckets)
    return buckets


def bucket_subtrees(tree, defs, buckets: Sequence[GradBucket]
                    ) -> List[Dict[str, object]]:
    """Slice ``tree`` (same structure as ``defs``) into one flat dict
    per bucket, keyed by leaf path — the per-bucket trees the sync
    runs on."""
    leaves = P.tree_leaves(tree)
    out = []
    for b in buckets:
        out.append({p: leaves[i] for p, i in zip(b.paths, b.flat_idx)})
    return out


def unbucket_leaves(per_bucket: Sequence[Dict[str, object]],
                    defs, buckets: Sequence[GradBucket]):
    """Inverse of :func:`bucket_subtrees`: reassemble the original tree
    from per-bucket flat dicts."""
    leaves: List[object] = [None] * len(P.tree_leaves(defs))
    for b, d in zip(buckets, per_bucket):
        for p, i in zip(b.paths, b.flat_idx):
            leaves[i] = d[p]
    return P.tree_unflatten(defs, leaves)
