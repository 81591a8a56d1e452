"""The training loop: data pipeline + train step + checkpoint/restart.
The port of the JAX package's ``train/trainer.py``: on one device, or on
every rank of a mesh (``dist.mesh``: ``pod``, ``data`` and ``model``
axes), where each rank holds its shards of the state, draws the same
global batch and its step keeps the rank's rows.  ``remesh`` is the
elastic transition between ``run`` calls."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import (BASELINE, ModelConfig,
                                      ShardingStrategy, TrainConfig,
                                      WorkloadShape)
from repro_torch.data import DataPipeline, to_tensors
from repro_torch.device import resolve_device
from repro_torch.dist import steps as dsteps
from repro_torch.models import params as P


class Trainer:
    """Runs on CUDA (the kernels) unless ``device`` says otherwise (the
    plain versions on the CPU).  ``mesh``: the mesh this rank belongs
    to (every rank builds its own Trainer with the same arguments);
    ``strategy``: how the rule tables place the state on it and how its
    gradients sync.  Every architecture of the registry trains, the
    sequence mixers (jamba, xlstm) included."""

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
        self.ckpt = self._manager(ckpt_dir) if ckpt_dir else None
        self.state = None
        self.start_step = 0
        self.history: List[Dict] = []

    def _specs(self):
        """The state's resolved specs on a mesh of ranks, else None."""
        if self.mesh is None or self.mesh.size == 1:
            return None
        return dsteps.train_state_shardings(self.cfg, self.strategy,
                                            self.mesh)

    def _manager(self, directory, keep: int = 3):
        return CheckpointManager(directory, keep=keep, mesh=self.mesh,
                                 specs=self._specs())

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

    # ------------------------------------------------------------------
    def remesh(self, mesh=None, *, strategy: Optional[ShardingStrategy] = None
               ) -> float:
        """Elastic transition between ``run()`` calls: rebuild the step
        on ``mesh`` (None: one device), checkpoint at ``start_step`` and
        restore (params, opt state and the comm residual) resharded for
        the new mesh, then resume at the same step and global batch.
        Without a checkpoint manager the state goes through host memory
        (each leaf gathered whole, then cut to the new shard).  A
        process's ranks are fixed by its process group, so the new mesh
        must hold as many ranks as the old one, in any shape (say (data
        2, model 2) to (data 4, model 1)): a remesh across rank counts
        raises (ROADMAP Queue 1 item 5(e)).  On one process the new mesh
        is again one device, and the round trip through the checkpoint
        (or the host) is real.  Returns host seconds spent in the
        transition."""
        t0 = time.perf_counter()
        old_n = self.mesh.size if self.mesh is not None else 1
        new_n = mesh.size if mesh is not None else 1
        if new_n != old_n:
            raise NotImplementedError(
                f"remesh from {old_n} to {new_n} ranks: the ranks of a "
                "process group are fixed (resizing one: ROADMAP Queue 1 "
                "item 5(e))")
        old_ckpt, old_mesh, old_specs = self.ckpt, self.mesh, self._specs()
        if strategy is not None:
            self.strategy = strategy
        self.mesh = mesh
        self._step = dsteps.build_train_step(
            self.cfg, self.tcfg, self.shape, strategy=self.strategy,
            mesh=mesh)
        if old_ckpt is not None:
            self.ckpt = self._manager(old_ckpt.dir, old_ckpt.keep)
        if self.state is not None:
            template = dsteps.abstract_train_state(self.cfg, self.tcfg,
                                                   self.strategy)
            if old_ckpt is not None:
                old_ckpt.save(self.state, self.start_step)
                old_ckpt.wait()
                self.state, step = self.ckpt.restore_latest(template,
                                                            self.device)
                assert int(step) == self.start_step
            else:
                self.state = self._reshard(old_mesh, old_specs)
        return time.perf_counter() - t0

    def _reshard(self, old_mesh, old_specs):
        """The state through host memory: each leaf whole (gathered over
        ``old_specs`` on ``old_mesh``), then this rank's shard of it on
        the current mesh."""
        from repro_torch.dist import sharding as shd
        new_specs = self._specs()

        def move(t, old, new):
            if old is not None:
                t = shd.gather(t.detach(), old, old_mesh)
            t = t.detach().to("cpu", copy=True)
            if new is not None:
                t = shd.shard(t, new, self.mesh)
            return t.to(self.device)

        leaves = P.tree_leaves(self.state)
        olds = (P.tree_leaves(old_specs) if old_specs is not None
                else [None] * len(leaves))
        news = (P.tree_leaves(new_specs) if new_specs is not None
                else [None] * len(leaves))
        return P.tree_unflatten(self.state, [
            move(t, o, n) for t, o, n in zip(leaves, olds, news)])

    # ------------------------------------------------------------------
    def run(self, n_steps: int, *, ckpt_every: int = 0,
            log_every: int = 10) -> List[Dict]:
        if self.state is None:
            self.init_or_resume()
        pipe = DataPipeline(self.cfg, self.shape, seed=self.seed,
                            start_step=self.start_step)
        try:
            for i in range(self.start_step, self.start_step + n_steps):
                batch = to_tensors(next(pipe), self.device)
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
