"""The training loop: data pipeline + train step + checkpoint/restart.
The port of the JAX package's ``train/trainer.py``: on one device, on
every rank of a mesh (``dist.mesh``: ``pod``, ``data`` and ``model``
axes), where each rank holds its shards of the state, draws the same
global batch and its step keeps the rank's rows, or, given a mesh of a
``dist.ranks.RankPool``'s slots, from the controller on that mesh's
ranks (``train.remote.RankTrainer``).  ``remesh`` is the elastic
transition between ``run`` calls, across rank counts where the meshes
are a pool's."""
from __future__ import annotations

import os
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
from repro_torch.dist.ranks import pool_of
from repro_torch.models import params as P


class Trainer:
    """Runs on CUDA (the kernels) unless ``device`` says otherwise (the
    plain versions on the CPU).  ``mesh``: the mesh this rank belongs
    to (every rank builds its own Trainer with the same arguments);
    ``strategy``: how the rule tables place the state on it and how its
    gradients sync.  A mesh of a pool's slots runs every step on its
    ranks (``state`` stays None here; ``run`` returns rank 0's
    history).  Every architecture of the registry trains, the sequence
    mixers (jamba, xlstm) included."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 shape: WorkloadShape, *, mesh=None,
                 strategy: ShardingStrategy = BASELINE,
                 ckpt_dir: Optional[str] = None, seed: int = 0, device=None):
        self.cfg, self.tcfg, self.shape = cfg, tcfg, shape
        self.mesh, self.strategy = mesh, strategy
        self.seed = seed
        self.state = None
        self._ranks = None
        self.start_step = 0
        self.history: List[Dict] = []
        # on a pool's mesh the device is the one a later remesh off the
        # ranks lands on (None: the card, resolved then)
        on_ranks = pool_of(mesh) is not None
        self.device = (None if on_ranks and device is None
                       else resolve_device(device))
        if on_ranks:
            self._place_on_ranks(ckpt_dir)
            return
        self._step = dsteps.build_train_step(cfg, tcfg, shape,
                                             strategy=strategy, mesh=mesh)
        self.ckpt = self._manager(ckpt_dir) if ckpt_dir else None

    def _place_on_ranks(self, ckpt_dir) -> None:
        from repro_torch.train.remote import RankTrainer
        self._step = None
        self._ranks = RankTrainer(self.mesh, self.cfg, self.tcfg, self.shape,
                                  self.strategy, ckpt_dir, self.seed)
        # here only to read the ranks' checkpoints (latest_step, restore)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None

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
        if self._ranks is not None:
            status, self.start_step = self._ranks.init()
            return status
        if self.ckpt is not None:
            self._restore_latest()
            if self.state is not None:
                return "resumed"
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = dsteps.init_train_state(
            self.cfg, self.tcfg, gen, self.device, strategy=self.strategy,
            mesh=self.mesh)
        return "initialized"

    # ------------------------------------------------------------------
    def save(self, meta: Optional[Dict] = None) -> None:
        """A committed checkpoint of the state at ``start_step``, on disk
        when this returns (written by rank 0 where the state lives on a
        pool's ranks)."""
        if self._ranks is not None:
            self._ranks.save(self.start_step, meta)
        else:
            self.ckpt.save(self.state, self.start_step, meta=meta)
            self.ckpt.wait()

    def remesh(self, mesh=None, *, strategy: Optional[ShardingStrategy] = None,
               carry: str = "live") -> float:
        """Elastic transition between ``run()`` calls: rebuild the step
        on ``mesh`` (None: one device) and resume there at the same step
        and global batch.  ``carry`` is what the new placement holds:

        * ``"live"``: this state, through a checkpoint at ``start_step``
          restored resharded for the new mesh (params, opt state and the
          comm residual), or, without a checkpoint manager, through host
          memory (each leaf gathered whole, then cut to the new shard);
        * ``"host"``: this state through host memory, no checkpoint
          written (a fault before the first one);
        * ``"latest"``: the newest committed checkpoint, the live state
          dropped (a re-placement after a fault or a save).

        Where either mesh is a pool's, the new mesh may hold any number
        of ranks (``_remesh_ranks``).  Otherwise this process is itself a
        rank, fixed by its process group, so the new mesh must hold as
        many ranks as the old one, in any shape (say (data 2, model 2) to
        (data 4, model 1)).  On one process the new mesh is again one
        device, and the round trip through the checkpoint (or the host)
        is real.  Returns host seconds spent in the transition."""
        if carry not in ("live", "host", "latest"):
            raise ValueError(f"carry={carry!r}")
        t0 = time.perf_counter()
        if pool_of(self.mesh) is not None or pool_of(mesh) is not None:
            self._remesh_ranks(mesh, strategy, carry)
            return time.perf_counter() - t0
        old_n = self.mesh.size if self.mesh is not None else 1
        new_n = mesh.size if mesh is not None else 1
        if new_n != old_n:
            raise ValueError(
                f"remesh from {old_n} to {new_n} ranks of this process's "
                "own group, whose ranks are fixed: a remesh across rank "
                "counts runs on the meshes of a dist.ranks.RankPool")
        if carry == "live" and self.ckpt is not None:
            if self.state is not None:
                self.save()
            carry = "latest"
        old_mesh, old_specs = self.mesh, self._specs()
        if strategy is not None:
            self.strategy = strategy
        self.mesh = mesh
        self._step = dsteps.build_train_step(
            self.cfg, self.tcfg, self.shape, strategy=self.strategy,
            mesh=mesh)
        if self.ckpt is not None:
            self.ckpt = self._manager(self.ckpt.dir, self.ckpt.keep)
        if carry == "latest":
            self.state = None
            self._restore_latest()
        elif self.state is not None:
            self.state = self._reshard(old_mesh, old_specs)
        return time.perf_counter() - t0

    def _restore_latest(self) -> None:
        """The newest committed checkpoint into ``state`` and
        ``start_step``, where there is one."""
        template = dsteps.abstract_train_state(self.cfg, self.tcfg,
                                               self.strategy)
        restored, step = self.ckpt.restore_latest(template, self.device)
        if restored is not None:
            self.state, self.start_step = restored, int(step)

    def _remesh_ranks(self, mesh, strategy, carry) -> None:
        """``remesh`` where either mesh is a pool's: the old placement
        saves a checkpoint at ``start_step`` (or writes its whole state
        to a file: every leaf gathered to rank 0's host) and is freed;
        the new one (the ranks of ``mesh``, or this process's device)
        restores the newest checkpoint or cuts its shards from the
        file."""
        from repro_torch.train.remote import load_state_file
        live = (self._ranks.ready if self._ranks is not None
                else self.state is not None)
        ckpt_dir = self.ckpt.dir if self.ckpt is not None else None
        keep = self.ckpt.keep if self.ckpt is not None else 3
        if carry == "live":
            carry = "latest" if ckpt_dir is not None else "host"
            if live and ckpt_dir is not None:
                self.save()
        path = None
        if live and carry == "host":
            path = (pool_of(mesh) or pool_of(self.mesh)).path("state")
            if self._ranks is not None:
                self._ranks.export(path)
            else:
                torch.save(P.tree_map(lambda t: t.detach().to("cpu"),
                                      self.state), path)
        if self._ranks is not None:
            self._ranks.close()             # freed before the new placement
            self._ranks = None
        self.state = None
        if strategy is not None:
            self.strategy = strategy
        self.mesh = mesh
        try:
            if pool_of(mesh) is not None:
                self._place_on_ranks(ckpt_dir)
                if path is not None:
                    self._ranks.load(path, self.start_step)
                elif carry == "latest":
                    _, self.start_step = self._ranks.init()
                return
            if self.device is None:
                self.device = resolve_device(None)
            self._step = dsteps.build_train_step(
                self.cfg, self.tcfg, self.shape, strategy=self.strategy,
                mesh=mesh)
            self.ckpt = (self._manager(ckpt_dir, keep) if ckpt_dir
                         else None)
            if path is not None:
                self.state = load_state_file(path, self._specs(), mesh,
                                             self.device)
            elif carry == "latest":
                self._restore_latest()
        finally:
            if path is not None and os.path.exists(path):
                os.remove(path)

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
        if self._ranks is not None:
            self.history.extend(self._ranks.run(n_steps, ckpt_every,
                                                log_every))
            self.start_step += n_steps
            return self.history
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
