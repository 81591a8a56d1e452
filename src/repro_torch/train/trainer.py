"""The training loop: data pipeline + train step + checkpoint/restart.
The port of the JAX package's ``train/trainer.py``: on one device, or on
every rank of a data-parallel mesh (``dist.mesh``), where each rank
draws the same global batch and its step keeps the rank's rows.
Elastic ``remesh`` waits for a later slice."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import (BASELINE, ModelConfig,
                                      ShardingStrategy, TrainConfig,
                                      WorkloadShape)
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import steps as dsteps


class Trainer:
    """Runs on CUDA (the kernels) unless ``device`` says otherwise (the
    plain versions on the CPU).  ``mesh``: the data-parallel mesh this
    rank belongs to (every rank builds its own Trainer with the same
    arguments); ``strategy``: how its gradients sync."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 shape: WorkloadShape, *, mesh=None,
                 strategy: ShardingStrategy = BASELINE,
                 ckpt_dir: Optional[str] = None, seed: int = 0, device=None):
        self.cfg, self.tcfg, self.shape = cfg, tcfg, shape
        self.mesh, self.strategy = mesh, strategy
        self.seed = seed
        self.device = resolve_device(device)
        self._step = dsteps.build_train_step(cfg, tcfg, shape,
                                             strategy=strategy, mesh=mesh)
        self.ckpt = (CheckpointManager(ckpt_dir, mesh=mesh, strategy=strategy)
                     if ckpt_dir else None)
        self.state = None
        self.start_step = 0
        self.history: List[Dict] = []

    # ------------------------------------------------------------------
    def init_or_resume(self):
        if self.ckpt is not None:
            template = dsteps.abstract_train_state(self.cfg, self.tcfg,
                                                   self.strategy)
            restored, step = self.ckpt.restore_latest(template, self.device)
            if restored is not None:
                self.state = restored
                self.start_step = int(step)
                return "resumed"
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = dsteps.init_train_state(
            self.cfg, self.tcfg, gen, self.device, strategy=self.strategy,
            mesh=self.mesh)
        return "initialized"

    def _put_batch(self, batch):
        return {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                for k, v in batch.items() if not k.startswith("_")}

    # ------------------------------------------------------------------
    def run(self, n_steps: int, *, ckpt_every: int = 0,
            log_every: int = 10) -> List[Dict]:
        if self.state is None:
            self.init_or_resume()
        pipe = DataPipeline(self.cfg, self.shape, seed=self.seed,
                            start_step=self.start_step)
        try:
            for i in range(self.start_step, self.start_step + n_steps):
                batch = self._put_batch(next(pipe))
                t0 = time.perf_counter()
                self.state, metrics = self._step(self.state, batch)
                loss = float(metrics["loss"])          # waits for the step
                dt = time.perf_counter() - t0
                rec = {"step": i, "loss": loss,
                       "xent": float(metrics["xent"]),
                       "moe_aux": float(metrics["moe_aux"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_time_s": dt}
                self.history.append(rec)
                if log_every and (i % log_every == 0):
                    print(f"[train {self.cfg.name}] step {i} "
                          f"loss={rec['loss']:.4f} {dt*1e3:.0f}ms",
                          flush=True)
                if self.ckpt is not None and ckpt_every \
                        and (i + 1) % ckpt_every == 0:
                    self.ckpt.save(self.state, i + 1)
        finally:
            pipe.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        self.start_step += n_steps
        return self.history
