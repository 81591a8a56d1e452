"""Deterministic data pipeline: a copy of the JAX package's
``data/pipeline.py`` (numpy only; ``to_tensors`` moves a batch to
torch).

  * deterministic per-step batches derived from (seed, step, row), so a
    restart at step k reproduces the exact stream with no state files,
    and any split of the global batch over hosts draws the same rows;
  * background prefetch with a bounded queue (host data work overlaps
    device compute);
  * a packed-document token stream (synthetic Zipf text) with next-token
    labels, and for the families that take them the encoder's frames
    (whisper) and the vision patches (pixtral), drawn from the row's
    generator after its tokens, so a batch equals the JAX package's bit
    for bit.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, WorkloadShape


def _tokens_for_step(cfg: ModelConfig, shape: WorkloadShape, seed: int,
                     step: int, lo: int, hi: int) -> Dict[str, np.ndarray]:
    """Rows [lo, hi) of the global batch for one step, seeded per global
    row: tokens and labels, and ``frames`` (B, seq_len // divisor,
    d_model) for an encoder-decoder, ``patches`` (B, min(VISION_PATCHES,
    seq_len // 2), d_model) for a vision frontend, both float32."""
    from repro_torch.models.model import VISION_PATCHES

    s = shape.seq_len
    enc_len = s // max(cfg.encoder_seq_divisor, 1)
    n_patch = min(VISION_PATCHES, s // 2)
    rows, frames, patches = [], [], []
    for row in range(lo, hi):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, row]))
        # Zipf-ish synthetic text: heavy head, long tail, doc boundaries
        ranks = rng.zipf(1.3, size=(s + 1,)).astype(np.int64)
        t = np.clip(ranks, 1, cfg.vocab_size - 1).astype(np.int32)
        t[rng.random(s + 1) < (1.0 / 512)] = 0       # BOS/doc separator
        rows.append(t)
        if cfg.encoder_layers:
            frames.append(rng.standard_normal(
                (enc_len, cfg.d_model)).astype(np.float32) * 0.02)
        if cfg.frontend == "vision":
            patches.append(rng.standard_normal(
                (n_patch, cfg.d_model)).astype(np.float32) * 0.02)
    toks = np.stack(rows)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frames:
        out["frames"] = np.stack(frames)
    if patches:
        out["patches"] = np.stack(patches)
    return out


def to_tensors(batch: Dict[str, np.ndarray], device) -> Dict:
    """A batch's arrays as tensors on ``device``: token ids and labels as
    int64, frames and patches as float32; keys starting with ``_`` (the
    pipeline's step) are left out."""
    import torch

    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        v = np.asarray(v)
        v = v.astype(np.int64 if v.dtype.kind in "iu" else np.float32)
        out[k] = torch.from_numpy(v).to(device)
    return out


def synthetic_batch(cfg: ModelConfig, shape: WorkloadShape, seed: int = 0,
                    step: int = 0) -> Dict[str, np.ndarray]:
    return _tokens_for_step(cfg, shape, seed, step, 0, shape.global_batch)


class DataPipeline:
    """Per-host iterator with background prefetch."""

    def __init__(self, cfg: ModelConfig, shape: WorkloadShape, *,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        assert shape.global_batch % n_hosts == 0, \
            "global batch must divide across hosts"
        self.cfg, self.shape, self.seed = cfg, shape, seed
        per = shape.global_batch // n_hosts
        self.lo, self.hi = host_id * per, (host_id + 1) * per
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = _tokens_for_step(self.cfg, self.shape, self.seed,
                                     step, self.lo, self.hi)
            batch["_step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
