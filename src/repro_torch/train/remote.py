"""Training on the ranks of a pool mesh, driven from the controller.

``RankTrainer(mesh, ...)`` forms the mesh's group on its
``dist.ranks.RankPool`` and builds on every rank of it a ``Trainer``
on ``dist.mesh.make_mesh`` of the mesh's shape (the sharded step:
each rank holds its shards, draws the same global batch and keeps its
rows).  The controller calls ``init`` (draw or restore), ``run`` (rank
0's history records back), ``save`` (a sharded checkpoint, written by
rank 0 before the call returns), ``export`` (the whole state gathered to
rank 0's host, into a file) and ``load`` (each rank cuts its shard of a
whole state from a file).  ``Trainer(..., mesh=pool_mesh)`` runs on
one, and ``Trainer.remesh`` moves the state between them through a
checkpoint or such a file, across rank counts.

``RankSteps`` is the ``SubmeshExecutor``'s job on ranks: the state drawn
from seed 0 and one batch, a step built and warmed on the ranks, then
timed runs of it, each rank timing its steps on its own clock.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.dist.ranks import RankError, pool_of, slots_of
from repro_torch.models import params as P

_HERE = __name__


class _OnRanks:
    """An object on the ranks of a pool mesh's group, by handle."""

    def __init__(self, mesh, new: str, *args):
        pool = pool_of(mesh)
        if pool is None:
            raise ValueError("a mesh of a RankPool's slots is needed "
                             "(dist.sharding.submesh_for(rset, pool.slots))")
        self.pool, self.slots, self.mesh = pool, slots_of(mesh), mesh
        self.gid = pool.group(self.slots)
        self.handle = pool.handle()
        self._call(new, tuple(mesh.devices.shape), mesh.axis_names, *args)

    @property
    def alive(self) -> bool:
        return self.gid is not None and self.pool.alive(self.gid)

    def _call(self, fn: str, *args):
        if not self.alive:
            raise RankError(f"the job on ranks {self.slots} is gone: its "
                            "group was dissolved or it was closed")
        return self.pool.run(self.slots, f"{_HERE}:{fn}", self.handle, *args)

    def close(self) -> None:
        """Free the object and its state on its ranks."""
        if self.alive:
            self.pool.drop(self.gid, self.handle)
        self.gid = None


class RankTrainer(_OnRanks):
    """A ``Trainer`` on every rank of ``mesh`` (see the module's
    docstring); ``ckpt_dir`` is the directory its ranks save to and
    restore from."""

    def __init__(self, mesh, cfg, tcfg, shape, strategy, ckpt_dir=None,
                 seed: int = 0):
        super().__init__(mesh, "trainer_new", cfg, tcfg, shape, strategy,
                         ckpt_dir, seed)
        self.ready = False

    def init(self) -> Tuple[str, int]:
        """Restore the newest checkpoint or draw from the seed: the
        outcome and the step it starts at."""
        out = self._call("trainer_init")
        self.ready = True
        return out

    def run(self, n_steps: int, ckpt_every: int = 0,
            log_every: int = 0) -> List[Dict]:
        """``n_steps`` steps; rank 0's history records of them."""
        out = self._call("trainer_run", n_steps, ckpt_every, log_every)
        self.ready = True
        return out

    def save(self, step: int, meta: Optional[Dict] = None) -> None:
        self._call("trainer_save", step, meta)

    def export(self, path: str) -> None:
        """The whole state (every leaf gathered to rank 0's host) into
        ``path``."""
        self._call("trainer_export", path)

    def load(self, path: str, start_step: int) -> None:
        """Each rank's shard of the whole state in ``path``; the next
        ``run`` starts at ``start_step``."""
        self._call("trainer_load", path, start_step)
        self.ready = True


class RankSteps(_OnRanks):
    """The SubmeshExecutor's train step on the ranks of ``mesh``: built,
    its state drawn from seed 0 and one warm step taken on the batch of
    ``shape`` (step 0, seed 0) at construction."""

    def __init__(self, mesh, cfg, tcfg, shape, strategy):
        super().__init__(mesh, "steps_new", cfg, tcfg, shape, strategy)

    def run(self, n_steps: int) -> Dict:
        """``n_steps`` steps on the batch: rank 0's loss and the seconds
        its steps took, synchronised (``elapsed``)."""
        return self._call("steps_run", n_steps)


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def _mesh(rk, shape, axes):
    mesh = rk.mesh(shape, axes)
    return mesh if mesh.size > 1 else None


def trainer_new(rk, h, shape, axes, cfg, tcfg, wshape, strategy, ckpt_dir,
                seed):
    from repro_torch.train.trainer import Trainer
    rk.put(h, Trainer(cfg, tcfg, wshape, mesh=_mesh(rk, shape, axes),
                      strategy=strategy, ckpt_dir=ckpt_dir, seed=seed,
                      device=rk.device))


def trainer_init(rk, h):
    tr = rk.get(h)
    return tr.init_or_resume(), tr.start_step


def trainer_run(rk, h, n, ckpt_every, log_every):
    tr = rk.get(h)
    k = len(tr.history)
    tr.run(n, ckpt_every=ckpt_every,
           log_every=log_every if rk.rank == 0 else 0)
    return tr.history[k:]


def trainer_save(rk, h, step, meta):
    tr = rk.get(h)
    tr.ckpt.save(tr.state, step, meta=meta)
    tr.ckpt.wait()


def trainer_export(rk, h, path):
    from repro_torch.dist.sharding import gather_to_host
    tr = rk.get(h)
    specs = tr._specs()
    leaves = P.tree_leaves(tr.state)
    if specs is None:
        host = [t.detach().to("cpu", copy=True) for t in leaves]
    else:
        host = [gather_to_host(t, sp, tr.mesh)
                for t, sp in zip(leaves, P.tree_leaves(specs))]
    if rk.rank == 0:
        torch.save(P.tree_unflatten(tr.state, host), path)


def trainer_load(rk, h, path, start_step):
    tr = rk.get(h)
    tr.state = None
    tr.state = load_state_file(path, tr._specs(), tr.mesh, tr.device)
    tr.start_step = start_step


def load_state_file(path: str, specs, mesh, device):
    """A whole state that ``torch.save`` wrote (host tensors), each leaf
    cut to this rank's shard of ``specs`` on ``mesh`` (None: kept
    whole), on ``device``: what a rank of a new placement, or the
    controller's own device, takes from the old placement's state."""
    from repro_torch.dist.sharding import shard
    whole = torch.load(path, map_location="cpu", weights_only=True)
    leaves = P.tree_leaves(whole)
    if specs is not None:
        leaves = [shard(t, sp, mesh)
                  for t, sp in zip(leaves, P.tree_leaves(specs))]
    return P.tree_unflatten(whole, [t.to(device) for t in leaves])


def steps_new(rk, h, shape, axes, cfg, tcfg, wshape, strategy):
    from repro_torch.data import synthetic_batch, to_tensors
    from repro_torch.dist import steps as dsteps
    mesh = _mesh(rk, shape, axes)
    step = dsteps.build_train_step(cfg, tcfg, wshape, strategy=strategy,
                                   mesh=mesh)
    gen = torch.Generator(device=rk.device).manual_seed(0)
    state = dsteps.init_train_state(cfg, tcfg, gen, rk.device,
                                    strategy=strategy, mesh=mesh)
    batch = to_tensors(synthetic_batch(cfg, wshape), rk.device)
    state, metrics = step(state, batch)         # build outside timing
    float(metrics["loss"])
    rk.put(h, {"step": step, "state": state, "batch": batch})


def steps_run(rk, h, n):
    job = rk.get(h)
    t0 = time.perf_counter()
    metrics = None
    for _ in range(n):
        job["state"], metrics = job["step"](job["state"], job["batch"])
    loss = float(metrics["loss"])               # waits for the steps
    return {"elapsed": time.perf_counter() - t0, "loss": loss}
