"""Executors: how scheduled jobs become actual work.

The port of the JAX package's ``core/executor.py``, all seven of its
executors:

* ``TorchWorkloadExecutor`` (the JAX package's ``JaxWorkloadExecutor``,
  with ``mpi_executor``) runs REAL compute — the loss of the job's
  configured architecture — and converts measured wall time into
  simulated job walltime;
* ``SubmeshExecutor`` runs real train steps (``dist/steps.py``) on the
  mesh its allocation maps to, and ``ElasticTrainExecutor`` does so in
  chunks that survive MiniCluster resizes through the checkpoint;
* ``ServeExecutor``, ``FleetServeExecutor``, ``ElasticServeExecutor``
  and ``ElasticFleetServeExecutor`` host the serving engine, a routed
  replica set, an engine that parks and adopts its state across
  MiniCluster resizes, and a replica set that grows live and takes
  new parameters by rolling canary promotion.

The PMI/bootstrap cost is modeled structurally: Flux bootstraps MPI
ranks through its always-up brokers (flux-pmix; ~O(log N) TBON hops),
while mpirun pays a serial per-rank ssh/PMI wireup — this is the
structural source of the launcher-time gap in the paper's Figure 5.

Every executor runs on the card unless ``device`` says otherwise
(``"cpu"``: the kernels' plain versions).  Given a ``dist.ranks.RankPool``
(``ranks``; ``executor_opts["ranks"]`` through ``apply``),
``sharding.submesh_for`` lays each allocation over the pool's slots, as
the JAX package lays it over ``jax.devices()``, and the job runs on its
mesh's ranks: the train step of ``train.remote.RankSteps``, a
``Trainer`` on the pool mesh, or a ``serve.remote.RemoteEngine`` (eager
ticks; parameters drawn on each rank from the seed, each keeping its
shard).  Without a pool the allocation is laid over the devices of this
process, so on one card every allocation is a ``(1, 1)`` mesh on
``cuda:0``, and a mesh of more than one device raises.  Engines and
train steps are cached by the mesh's shape and its devices' indices
(slot ids on a pool), as the JAX package caches them by device id; a
cached job on ranks whose group has been dissolved (its slots joined a
later placement) is rebuilt.  Every warm-up (the kernels' first nvcc
build among it) runs outside the timed window.  Where the JAX package draws inputs with ``jax.random``, the port
draws them with numpy (``data.synthetic_batch``) and parameters with a
seeded ``torch.Generator``: the same control flow, other numbers.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.jobspec import Job, JobSpec, JobState
from repro_torch.core.resource_graph import ResourceSet
from repro_torch.core.sim import NetModel, SimClock


def smoke_config_for(command: str):
    """Resolve a job command to a reduced arch config (shared by all
    executors; unknown commands fall back to the paper's proxy app)."""
    from repro_torch.configs import registry
    return registry.smoke(command if command in
                          registry.ARCH_IDS + registry.EXTRA_IDS
                          else "lammps-proxy")


def tbon_bootstrap_cost(net: NetModel, n_nodes: int, fanout: int) -> float:
    """flux-pmix wireup through the TBON: O(depth) control RPCs."""
    import math
    depth = max(1, math.ceil(math.log(max(n_nodes, 2), fanout)))
    return depth * net.rpc_latency * 4          # barrier in + out


def clamp_queued_jobs(instance, new_size: int):
    """A shrink must clamp EVERY live request on the cluster, not just
    running ones: a queued/requeued job still asking for more hosts
    than the cluster will have becomes permanently unschedulable
    otherwise.  Shared by every elastic executor's resize listener."""
    for job in instance.queue.jobs.values():
        if (job.state not in (JobState.CLEANUP, JobState.INACTIVE)
                and job.spec.n_nodes > new_size):
            job.spec.n_nodes = new_size


def _sync(device: Optional[torch.device]) -> None:
    """Wait for ``device``'s work (None: a job on ranks, whose commands
    return once the ranks are done)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_key(mesh):
    """The mesh's shape and its devices' indices (the JAX package keys
    on ``d.id``; the one CPU device counts as index 0)."""
    return tuple(mesh.devices.shape), _device_ids(mesh)


def _device_ids(mesh):
    return tuple(d.index if d.index is not None else 0
                 for d in mesh.devices.flat)


def _one_device(mesh) -> torch.device:
    """The device a job without a pool runs on: its mesh's only one."""
    if mesh.size > 1:
        raise NotImplementedError(
            f"a {mesh.shape} mesh over {mesh.size} devices: a job runs on "
            "several devices as ranks of a pool, executor_opts[\"ranks\"] "
            "(a dist.ranks.RankPool)")
    return mesh.devices.flat[0]


def _live(job) -> bool:
    """Whether a cached engine or step may run again: not one on ranks
    whose group has been dissolved."""
    return getattr(job, "alive", True)


def _params(cfg, seed: int, device, dtype=torch.bfloat16):
    """Parameters drawn on ``device`` as ``Engine`` draws its own from
    ``seed``, so engines given them compute what a default engine does."""
    from repro_torch.models.model import Model
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg).init(gen, dtype=dtype, device=device)


def serving_params(cfg, params, device, compute_dtype=torch.bfloat16):
    """``params`` (e.g. a train state's float32 params, on any device)
    as an Engine of ``compute_dtype`` draws its own: each leaf on
    ``device`` in the dtype ``Model.init(dtype=compute_dtype)`` gives it
    (matrices in the compute dtype, norm scales in float32)."""
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    like = P.abstract_params(Model(cfg).param_defs(), compute_dtype)
    return P.tree_unflatten(like, [
        t.detach().to(device, m.dtype)
        for t, m in zip(P.tree_leaves(params), P.tree_leaves(like))])


def _synthetic_prompts(n: int, plen: int, vocab: int) -> List[List[int]]:
    return [[(7 * i + j) % vocab for j in range(plen)] for i in range(n)]


class TorchWorkloadExecutor:
    """Executor for FluxInstance: real compute + structural bootstrap.

    ``cfg``: the payload's config (None resolves the job's command to its
    SMOKE config, as the JAX package always does)."""

    def __init__(self, clock: SimClock, net: NetModel,
                 tbon_fanout: int = 2, steps: int = 3,
                 time_scale: float = 1.0,
                 fixed_measure: Optional[float] = None, cfg=None,
                 device=None):
        from repro_torch.device import resolve_device
        self.clock = clock
        self.net = net
        self.k = tbon_fanout
        self.steps = steps
        self.time_scale = time_scale
        # benchmarks measure the app once and share it across operators
        # (paper: identical binary + problem under both)
        self.fixed_measure = fixed_measure
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cache: Dict[str, Callable] = {}
        self.measured: Dict[int, float] = {}

    # -- real compute ---------------------------------------------------------
    def _step_fn(self, command: str):
        if command in self._cache:
            return self._cache[command]
        from repro_torch.configs.base import WorkloadShape
        from repro_torch.data import synthetic_batch, to_tensors
        from repro_torch.models.model import Model

        cfg = self.cfg or smoke_config_for(command)
        dev = self.device
        model = Model(cfg)
        params = _params(cfg, 0, dev, torch.float32)
        batch = to_tensors(synthetic_batch(
            cfg, WorkloadShape("bench", "train", 32, 2)), dev)

        @torch.no_grad()
        def step():
            loss, _ = model.loss(params, batch, remat=False)
            return loss

        step()
        _sync(dev)                      # build and warm outside timing

        def run() -> float:
            t0 = time.perf_counter()
            for _ in range(self.steps):
                step()
            _sync(dev)
            return time.perf_counter() - t0

        self._cache[command] = run
        return run

    def _bootstrap_cost(self, n_nodes: int) -> float:
        return tbon_bootstrap_cost(self.net, n_nodes, self.k)

    # -- FluxInstance executor signature ---------------------------------------
    def __call__(self, job: Job, rset: ResourceSet, done):
        raw = (self.fixed_measure if self.fixed_measure is not None
               else self._step_fn(job.spec.command)())
        # strong scaling: fixed problem split across the allocation
        measured = raw * self.time_scale / max(rset.n_hosts, 1)
        self.measured[job.jobid] = measured
        wall = measured + self._bootstrap_cost(rset.n_hosts)
        self.clock.call_in(wall, done, "completed", wall)

    # -- MPIJob executor signature ------------------------------------------------
    def mpi_executor(self):
        def ex(spec: JobSpec, hosts, done):
            raw = (self.fixed_measure if self.fixed_measure is not None
                   else self._step_fn(spec.command)())
            measured = raw * self.time_scale / max(len(hosts), 1)
            # app-efficiency gap (paper Fig 3, ~5%) + in-app PMI wireup
            wall = (measured * (1.0 + self.net.mpi_app_overhead)
                    + self.net.ssh_handshake * 0.02 * len(hosts))
            self.clock.call_in(wall, done, wall)
        return ex


class SubmeshExecutor:
    """Executor that runs REAL train steps on the mesh its job's
    ``ResourceSet`` describes.

    The Fluxion graph match produces an allocation (n hosts x
    chips/host), and the allocation — not a global constant — determines
    device placement: ``submesh_for`` maps the chip ids onto this
    process's devices; ``dist/steps.py`` builds the step; the steps run
    and their measured wall time becomes the simulated job walltime
    (same structural bootstrap cost as ``TorchWorkloadExecutor``).
    Per-job records in ``ran`` expose the mesh each allocation actually
    executed on.  The batch is ``data.synthetic_batch`` at step 0 (two
    rows per ``data`` shard) and the state is drawn from seed 0: the
    same as ``Trainer(seed=0)`` stepping that batch.
    """

    def __init__(self, clock: SimClock, net: NetModel,
                 tbon_fanout: int = 2, steps: int = 2,
                 time_scale: float = 1.0, seq_len: int = 32,
                 strategy=None, cfg=None, device=None, ranks=None):
        from repro_torch.dist.sharding import device_list
        self.clock = clock
        self.net = net
        self.k = tbon_fanout
        self.steps = steps
        self.time_scale = time_scale
        self.seq_len = seq_len
        self.strategy = strategy
        self.cfg = cfg                  # None -> resolve from job command
        self.ranks = ranks
        self.devices = device_list(device, ranks)
        self._cache: Dict = {}
        self.ran: Dict[int, Dict] = {}

    def _runner(self, command: str, mesh):
        # keyed on the actual device set AND the mesh shape: a
        # same-shaped allocation on other devices must build onto ITS
        # devices (placement is the point of this executor)
        key = (command,) + _mesh_key(mesh)
        if key in self._cache and _live(self._cache[key]):
            return self._cache[key]
        from repro_torch.configs import BASELINE, TrainConfig
        from repro_torch.configs.base import WorkloadShape
        from repro_torch.data import synthetic_batch, to_tensors
        from repro_torch.dist import steps as dsteps

        cfg = self.cfg or smoke_config_for(command)
        strategy = self.strategy or BASELINE
        tcfg = TrainConfig(total_steps=max(self.steps, 1), warmup_steps=0)
        # batch rows cover the data axis; at least 2 rows per shard
        batch_rows = 2 * mesh.shape.get("data", 1)
        shape = WorkloadShape("submesh", "train", self.seq_len, batch_rows)
        if self.ranks is not None:
            from repro_torch.train.remote import RankSteps
            job = RankSteps(mesh, cfg, tcfg, shape, strategy)
            self._cache[key] = job
            return job
        dev = _one_device(mesh)
        step = dsteps.build_train_step(cfg, tcfg, shape, strategy=strategy)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = dsteps.init_train_state(cfg, tcfg, gen, dev,
                                        strategy=strategy)
        batch = to_tensors(synthetic_batch(cfg, shape), dev)
        state, metrics = step(state, batch)        # build outside timing
        float(metrics["loss"])
        job = _LocalSteps(step, state, batch)
        self._cache[key] = job
        return job

    def __call__(self, job: Job, rset: ResourceSet, done):
        from repro_torch.dist.sharding import submesh_for
        mesh = submesh_for(rset, self.devices)
        # on ranks: the seconds rank 0's steps took, round trips aside
        out = self._runner(job.spec.command, mesh).run(self.steps)
        measured = out["elapsed"] * self.time_scale
        self.ran[job.jobid] = {
            "mesh_shape": tuple(mesh.devices.shape),
            "n_devices": int(mesh.size),
            "device_ids": list(_device_ids(mesh)),
            "hosts": list(rset.hosts),
            "loss": out["loss"],
            "measured_s": measured,
        }
        wall = measured + tbon_bootstrap_cost(self.net, rset.n_hosts,
                                              self.k)
        self.clock.call_in(wall, done, "completed", wall)


class _LocalSteps:
    """The SubmeshExecutor's train step on this process's one device, as
    ``train.remote.RankSteps`` is on ranks."""

    def __init__(self, step, state, batch):
        self.step, self.state, self.batch = step, state, batch

    def run(self, n: int) -> Dict:
        """``n`` steps on the batch: the loss and the seconds they took."""
        t0 = time.perf_counter()
        metrics = None
        for _ in range(n):
            self.state, metrics = self.step(self.state, self.batch)
        loss = float(metrics["loss"])               # waits for the steps
        return {"elapsed": time.perf_counter() - t0, "loss": loss}


@dataclass
class _ElasticSession:
    """One elastic train job's state across resizes and requeues."""

    job: Job
    cfg: object
    tcfg: object
    shape: object
    ckpt: object                      # CheckpointManager (sync saves)
    seed: int
    step: int = 0                     # completed optimizer steps
    losses: List[float] = field(default_factory=list)
    state: object = None              # train state on the current device
    trainer: object = None            # on ranks: its Trainer on the pool mesh
    jitted: object = None             # the train step (the JAX name)
    device: object = None             # the device the state lives on
    mesh: object = None
    generation: int = 0               # bumps on every (re)placement
    pending: Optional[int] = None     # resize target not yet applied
    pending_source: str = ""
    t_resize_sim: Optional[float] = None
    resize_from: Optional[int] = None
    t_start_sim: Optional[float] = None
    segments: List[Dict] = field(default_factory=list)
    resumes: List[Dict] = field(default_factory=list)
    _resume_rec: Optional[Dict] = None


class ElasticTrainExecutor(SubmeshExecutor):
    """Train jobs that SURVIVE MiniCluster grow/shrink.

    The elastic-remesh path end to end: ``FluxMiniCluster.patch_size``
    (user, API or autoscaler — one shared patch path) publishes a
    resize event through ``on_resize``; this executor checkpoints the
    running state via ``CheckpointManager`` (the JAX package's on-disk
    format) inside that graceful window, and at the next step boundary
    — for a grow, once the new ranks have booted into the cluster graph
    — re-matches the job at the new size, rebuilds the mesh from the
    updated ``ResourceSet`` with ``sharding.submesh_for``, restores the
    latest committed checkpoint (params AND optimizer state) resharded
    onto the new mesh's ranks (given a pool; the old ranks saved it and
    are freed first) or onto the job's one device, and resumes the
    train step at the same global batch — the data stream is seeded per
    ``(seed, step, row)``, so host-count changes cannot perturb it.

    Shrinks that tear the job's hosts out from under it ride the
    existing requeue path: the reconciler requeues the job, the
    scheduler re-matches it at the (already patched-down) size, and the
    fresh placement restores from the checkpoint written at the resize
    event.  Unlike :class:`SubmeshExecutor`, steps run in CHUNKS across
    simulator events, so resizes land between optimizer steps exactly
    as they would against a real train loop.  The state is drawn as
    ``Trainer(seed=seed)`` draws it and step ``i`` trains on
    ``synthetic_batch(cfg, shape, seed, i)``, the Trainer's batch, so
    the losses are those of an uninterrupted Trainer run.

    ``sim_step_time`` pins the simulated duration of one optimizer step
    (deterministic event interleaving for tests/benches); when ``None``
    the measured host wall time is used, as in ``SubmeshExecutor``.
    ``ckpt_root`` defaults to a temporary directory the executor owns
    (removed when it is collected).
    """

    def __init__(self, clock: SimClock, net: NetModel,
                 tbon_fanout: int = 2, total_steps: int = 8,
                 chunk_steps: int = 1, seq_len: int = 32,
                 global_batch: int = 8, strategy=None, cfg=None,
                 tcfg=None, seed: int = 0, ckpt_root: Optional[str] = None,
                 time_scale: float = 1.0,
                 sim_step_time: Optional[float] = None, device=None,
                 ranks=None):
        super().__init__(clock, net, tbon_fanout=tbon_fanout,
                         steps=chunk_steps, time_scale=time_scale,
                         seq_len=seq_len, strategy=strategy, cfg=cfg,
                         device=device, ranks=ranks)
        self.total_steps = total_steps
        self.chunk_steps = max(chunk_steps, 1)
        self.global_batch = global_batch
        self.tcfg = tcfg
        self.seed = seed
        self.sim_step_time = sim_step_time
        if ckpt_root is None:
            # a root we created is ours to reclaim: TemporaryDirectory's
            # finalizer removes it when the executor is collected
            self._tmp_root = tempfile.TemporaryDirectory(
                prefix="elastic-ckpt-")
            ckpt_root = self._tmp_root.name
        self.ckpt_root = ckpt_root
        self.mc = None
        self.sessions: Dict[int, _ElasticSession] = {}
        # lifecycle hook: cb(jobid, phase, **detail) — the workload
        # reconciler wires WorkloadHandle transitions through this
        self.phase_cb = None
        # optional obs.trace.Tracer: resize phases become spans on the
        # trace ``resize-<jobid>`` (sim-time axis, wall costs in attrs)
        self.tracer = None

    # -- reconciler event plumbing --------------------------------------------
    def bind(self, minicluster) -> "ElasticTrainExecutor":
        """Subscribe to the MiniCluster's resize events."""
        self.mc = minicluster
        minicluster.on_resize.append(self._on_resize)
        return self

    def _on_resize(self, new_size: int, source: str):
        """Graceful window: pods have not moved yet — checkpoint NOW."""
        if self.mc is not None:
            clamp_queued_jobs(self.mc.instance, new_size)
        for ses in self.sessions.values():
            job = ses.job
            if job.state != JobState.RUN or (ses.state is None
                                             and ses.trainer is None):
                continue
            self._save(ses, source)
            ses.pending = new_size
            ses.pending_source = source
            ses.t_resize_sim = self.clock.now
            ses.resize_from = (job.allocation.n_hosts
                               if job.allocation else None)
            # the job's resource request follows the cluster: a shrink
            # that requeues it must re-match at the NEW size
            job.spec.n_nodes = new_size
            self.clock.trace("elastic_ckpt", jobid=job.jobid,
                             step=ses.step, target=new_size, source=source)
            if self.phase_cb is not None:
                self.phase_cb(job.jobid, "Resizing", target=new_size,
                              source=source, step=ses.step)

    # -- session management ---------------------------------------------------
    def _save(self, ses: _ElasticSession, source: str) -> None:
        """A committed checkpoint of the job's state at ``ses.step``,
        written by its ranks where it lives on them."""
        meta = self._meta(ses, source)
        if ses.trainer is not None:
            ses.trainer.save(meta)
        else:
            ses.ckpt.save(ses.state, ses.step, meta=meta)

    def _meta(self, ses: _ElasticSession, source: str = "") -> Dict:
        return {
            "step": ses.step,
            "strategy": (self.strategy.name if self.strategy is not None
                         else "baseline"),
            "mesh_shape": (list(ses.mesh.devices.shape)
                           if ses.mesh is not None else None),
            "source": source,
        }

    def _session(self, job: Job) -> _ElasticSession:
        ses = self.sessions.get(job.jobid)
        if ses is not None:
            return ses
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.configs import TrainConfig
        from repro_torch.configs.base import WorkloadShape
        cfg = self.cfg or smoke_config_for(job.spec.command)
        tcfg = self.tcfg or TrainConfig(total_steps=self.total_steps,
                                        warmup_steps=0)
        shape = WorkloadShape("elastic", "train", self.seq_len,
                              self.global_batch)
        ckpt = CheckpointManager(
            os.path.join(self.ckpt_root, f"job{job.jobid}"),
            async_save=False)
        ses = _ElasticSession(job=job, cfg=cfg, tcfg=tcfg, shape=shape,
                              ckpt=ckpt, seed=self.seed,
                              t_start_sim=self.clock.now)
        self.sessions[job.jobid] = ses
        return ses

    # -- placement: (re)build the step on this allocation's sub-mesh ----------
    def __call__(self, job: Job, rset: ResourceSet, done):
        from repro_torch.configs import BASELINE
        from repro_torch.dist.sharding import submesh_for

        ses = self._session(job)
        ses.generation += 1
        gen = ses.generation
        strategy = self.strategy or BASELINE
        mesh = submesh_for(rset, self.devices)
        t0 = time.perf_counter()
        latest = ses.ckpt.latest_step()
        if self.ranks is not None:
            step = self._place_on_ranks(ses, mesh, strategy, latest)
        else:
            step = self._place_here(ses, mesh, strategy, latest)
        if latest is not None:
            # every (re)placement restarts the application: in-memory
            # state belongs to devices the job may no longer hold, so
            # the latest COMMITTED checkpoint was restored onto the new
            # placement — params and opt state both
            ses.step = int(step)
            # steps past the checkpoint re-run after restore: drop them
            del ses.losses[ses.step:]
            if ses.t_resize_sim is not None:
                # the resize timestamp travels IN the record: session
                # bookkeeping may be reset (e.g. by a no-op re-patch)
                # before the first post-resume chunk finalizes it
                ses._resume_rec = {
                    "jobid": job.jobid,
                    "transition": f"{ses.resize_from}->{rset.n_hosts}",
                    "source": ses.pending_source,
                    "step": ses.step,
                    "mesh_shape": list(mesh.devices.shape),
                    "restore_s": time.perf_counter() - t0,
                    "t_resize_sim": ses.t_resize_sim,
                    "t_place_sim": self.clock.now,
                }
                ses.t_resize_sim = None
        ses.mesh = mesh
        if ses.pending is not None and rset.n_hosts == ses.pending:
            ses.pending = None
        ses.segments.append({"mesh_shape": list(mesh.devices.shape),
                             "hosts": list(rset.hosts),
                             "from_step": ses.step, "steps": 0,
                             "wall_s": 0.0})
        self.clock.trace("elastic_place", jobid=job.jobid,
                         hosts=list(rset.hosts),
                         mesh=list(mesh.devices.shape), step=ses.step)
        if self.phase_cb is not None and gen > 1:
            # re-placements (remesh, requeue) bypass the dispatch that
            # normally marks Running; first placements don't
            self.phase_cb(job.jobid, "Running",
                          mesh=list(mesh.devices.shape), step=ses.step)
        boot = tbon_bootstrap_cost(self.net, rset.n_hosts, self.k)
        self.clock.call_in(boot, self._chunk, job, ses, gen, done)

    def _place_here(self, ses: _ElasticSession, mesh, strategy, latest):
        """The state on the mesh's one device of this process: restored
        from the checkpoint ``latest`` (returns its step), drawn, or
        moved there."""
        from repro_torch.dist import steps as dsteps
        from repro_torch.models import params as P
        dev = _one_device(mesh)
        ses.jitted = dsteps.build_train_step(ses.cfg, ses.tcfg, ses.shape,
                                             strategy=strategy)
        ses.device = dev
        if latest is not None:
            template = dsteps.abstract_train_state(ses.cfg, ses.tcfg,
                                                   strategy)
            ses.state = None            # the old copy goes before the new
            ses.state, step = ses.ckpt.restore_latest(template, dev)
            return step
        if ses.state is None:
            # drawn as Trainer(seed=seed) draws it
            gen_ = torch.Generator(device=dev).manual_seed(ses.seed)
            ses.state = dsteps.init_train_state(ses.cfg, ses.tcfg, gen_, dev,
                                                strategy=strategy)
        else:
            # re-placed with live state but no committed checkpoint yet
            # (fault-path requeue before the first save): the state is
            # committed to the OLD allocation's device, so move it through
            # host memory onto the new placement's
            host = P.tree_map(lambda t: t.detach().to("cpu", copy=True),
                              ses.state)
            ses.state = P.tree_map(lambda t: t.to(dev), host)
        return None

    def _place_on_ranks(self, ses: _ElasticSession, mesh, strategy, latest):
        """The job's ``Trainer`` on the mesh's ranks, built at the first
        placement (restored from the checkpoint ``latest`` or drawn from
        the seed) and moved by ``Trainer.remesh`` at every later one: to
        the checkpoint ``latest`` (returns its step), or, where the job
        holds live state but no committed checkpoint (a fault-path
        requeue before the first save), through the host.  The old
        ranks' state is freed before the new mesh draws or restores."""
        from repro_torch.train import Trainer
        if ses.trainer is None:
            ses.trainer = Trainer(ses.cfg, ses.tcfg, ses.shape, mesh=mesh,
                                  strategy=strategy, ckpt_dir=ses.ckpt.dir,
                                  seed=ses.seed)
            ses.trainer.init_or_resume()
        else:
            ses.trainer.remesh(mesh, strategy=strategy,
                               carry="host" if latest is None else "latest")
        return ses.trainer.start_step if latest is not None else None

    # -- elastic transition at a step boundary --------------------------------
    def _try_remesh(self, job: Job, ses: _ElasticSession, done) -> bool:
        """Apply a pending resize: re-match at the new size and restart
        placement.  Returns False while new ranks are still booting —
        training continues on the old mesh until the cluster can
        actually satisfy the new size (grow never pauses the job)."""
        want = ses.pending
        if job.allocation is not None and job.allocation.n_hosts == want:
            # no-op resize: drop ALL the pending bookkeeping, or a later
            # unrelated re-placement would fabricate a resume record
            ses.pending = None
            ses.t_resize_sim = None
            ses.resize_from = None
            return False
        graph = self.mc.instance.graph
        held = set(job.allocation.hosts) if job.allocation else set()
        free = [h.hid for h in graph.free_hosts() if h.hid not in held]
        if len(free) + len(held) < want:
            return False
        # capture steps run since the resize event, then trade the old
        # allocation for one at the new size (old hosts are preferred by
        # the matcher, so a grow extends rather than migrates)
        self._save(ses, ses.pending_source)
        graph.free(job.jobid)
        rset = self.mc.instance.match_pod_local(want)
        assert rset is not None, "remesh match must succeed (checked above)"
        graph.alloc(rset, job.jobid)
        job.allocation = rset
        job.spec.n_nodes = want
        self.clock.trace("elastic_remesh", jobid=job.jobid,
                         hosts=list(rset.hosts))
        self(job, rset, done)
        return True

    # -- the chunked train loop -----------------------------------------------
    def _chunk(self, job: Job, ses: _ElasticSession, gen: int, done):
        from repro_torch.data import synthetic_batch, to_tensors

        if gen != ses.generation or job.state != JobState.RUN:
            return                     # superseded by a requeue/remesh
        if ses.pending is not None and self._try_remesh(job, ses, done):
            return
        n = min(self.chunk_steps, self.total_steps - ses.step)
        if ses.trainer is not None:
            # rank 0's steps, timed on the rank (round trips aside)
            k = len(ses.trainer.history)
            recs = ses.trainer.run(n, log_every=0)[k:]
            ses.losses.extend(r["loss"] for r in recs)
            ses.step += n
            elapsed = sum(r["step_time_s"] for r in recs)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                batch = to_tensors(synthetic_batch(ses.cfg, ses.shape,
                                                   ses.seed, ses.step),
                                   ses.device)
                ses.state, metrics = ses.jitted(ses.state, batch)
                ses.losses.append(float(metrics["loss"]))
                ses.step += 1
            elapsed = time.perf_counter() - t0
        seg = ses.segments[-1]
        seg["steps"] += n
        seg["wall_s"] += elapsed
        if ses._resume_rec is not None:
            rec = ses._resume_rec
            rec["first_chunk_s"] = elapsed
            t0sim = rec.pop("t_resize_sim")
            t_place = rec.pop("t_place_sim", self.clock.now)
            rec["time_to_resume_s"] = rec["restore_s"] + elapsed
            rec["sim_resume_gap_s"] = self.clock.now - t0sim
            ses.resumes.append(rec)
            ses._resume_rec = None
            if self.tracer is not None:
                trn = f"resize-{job.jobid}"
                self.tracer.span(
                    "graceful_window", trn, t0sim, t_place,
                    action="checkpoint", transition=rec["transition"],
                    source=rec["source"], step=rec["step"])
                self.tracer.span(
                    "restore", trn, t_place, self.clock.now,
                    restore_s=rec["restore_s"], first_chunk_s=elapsed,
                    mesh_shape=rec["mesh_shape"])
                self.tracer.event(
                    "resumed", trn, t=self.clock.now,
                    time_to_resume_s=rec["time_to_resume_s"],
                    sim_resume_gap_s=rec["sim_resume_gap_s"])
        dt = (self.sim_step_time * n if self.sim_step_time is not None
              else elapsed * self.time_scale)
        if ses.step >= self.total_steps:
            self._save(ses, "final")
            self.ran[job.jobid] = {
                "mesh_shape": tuple(ses.mesh.devices.shape),
                "n_devices": int(ses.mesh.size),
                "hosts": list(job.allocation.hosts),
                "loss": ses.losses[-1],
                "steps": ses.step,
                "n_resumes": len(ses.resumes),
                "segments": ses.segments,
            }
            self.clock.call_in(dt, done, "completed",
                               self.clock.now + dt - (job.t_run or 0.0))
        else:
            self.clock.call_in(dt, self._chunk, job, ses, gen, done)


class ServeExecutor:
    """Executor that hosts a continuous-batching serving engine on the
    mesh its job's ``ResourceSet`` describes — the serving sibling of
    :class:`SubmeshExecutor`.

    A serve job flows through the Flux queue like a train job: the
    Fluxion match produces an allocation, ``submesh_for`` turns it into
    a ``(data=hosts, model=chips)`` mesh, and a
    ``repro_torch.serve.Engine`` on that mesh's device drains the job's
    request batch.  The job's ``spec.args`` may carry ``prompts`` (list
    of token-id lists), ``max_new`` and ``temperature``; absent those,
    ``n_requests`` synthetic prompts are served.  Engines are cached per
    (arch, device-set, mesh-shape), so a long-lived allocation keeps its
    warm engine across jobs.  Per-job records in ``ran`` expose the mesh,
    token counts, throughput and mean TTFT, and each request's tokens.
    """

    def __init__(self, clock: SimClock, net: NetModel,
                 tbon_fanout: int = 2, n_requests: int = 2,
                 prompt_len: int = 8, max_new: int = 4,
                 time_scale: float = 1.0, strategy=None,
                 engine_config=None, cfg=None, device=None, ranks=None):
        from repro_torch.dist.sharding import device_list
        self.clock = clock
        self.net = net
        self.k = tbon_fanout
        self.n_requests = n_requests
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.time_scale = time_scale
        self.strategy = strategy
        self.engine_config = engine_config
        self.cfg = cfg                  # None -> resolve from job command
        self.ranks = ranks
        self.devices = device_list(device, ranks)
        self._engines: Dict = {}
        self.ran: Dict[int, Dict] = {}

    def _default_ecfg(self):
        from repro_torch.serve import EngineConfig
        return self.engine_config or EngineConfig(
            n_slots=4, page_size=8, max_seq_len=64, max_prompt_len=16)

    def _warm(self, eng):
        """Build and warm outside timing (the executor contract shared
        with the train executors): one request drives the prefill and
        the decode step once, as the JAX executor's warm does.  An
        engine that captures CUDA graphs takes a second request, and
        three new tokens each, so that each step kind (the prefill, the
        decode tick and, chunked, the mixed tick) runs twice: eagerly,
        then captured, before timing."""
        prompt = [1] * min(self.prompt_len, eng.ecfg.max_prompt_len)
        n, new = (2, 3) if eng.cuda_graphs else (1, 2)
        warm = [eng.submit(prompt, max_new_tokens=new) for _ in range(n)]
        eng.run()
        _sync(eng.device)
        assert all(r.finished for r in warm)

    def _new_engine(self, cfg, ecfg, mesh, seed: int = 0, params=None):
        """An engine on ``mesh``: on its ranks where the executor has a
        pool (parameters drawn there from ``seed``, each rank keeping its
        shard, or cut from ``params``), else on its one device."""
        if self.ranks is not None:
            from repro_torch.configs import BASELINE
            from repro_torch.serve.remote import RemoteEngine
            return RemoteEngine(cfg, ecfg, mesh=mesh, params=params,
                                strategy=self.strategy or BASELINE,
                                seed=seed)
        from repro_torch.serve import Engine
        return Engine(cfg, ecfg, params=params, seed=seed,
                      device=_one_device(mesh))

    def _engine(self, command: str, mesh):
        key = (command,) + _mesh_key(mesh)
        if key in self._engines and _live(self._engines[key]):
            return self._engines[key]
        eng = self._new_engine(self.cfg or smoke_config_for(command),
                               self._default_ecfg(), mesh)
        self._warm(eng)
        self._engines[key] = eng
        return eng

    def _job_prompts(self, job: Job, cfg, ecfg):
        prompts = job.spec.args.get("prompts")
        if prompts is None:
            prompts = _synthetic_prompts(
                self.n_requests, min(self.prompt_len, ecfg.max_prompt_len),
                cfg.vocab_size)
        prompts = [list(p)[:ecfg.max_prompt_len] for p in prompts]
        max_new = int(job.spec.args.get("max_new", self.max_new))
        # clamp to slot capacity so a misconfigured job degrades rather
        # than killing the simulation loop
        max_new = max(1, min(max_new, ecfg.max_seq_len
                             - max(len(p) for p in prompts)))
        return prompts, max_new, float(job.spec.args.get("temperature", 0.0))

    def __call__(self, job: Job, rset: ResourceSet, done):
        from repro_torch.dist.sharding import submesh_for
        mesh = submesh_for(rset, self.devices)
        eng = self._engine(job.spec.command, mesh)
        prompts, max_new, temp = self._job_prompts(job, eng.cfg, eng.ecfg)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new, temperature=temp)
                for p in prompts]
        eng.run()
        _sync(eng.device)
        elapsed = time.perf_counter() - t0
        n_tok = sum(len(r.tokens) for r in reqs)
        ttfts = [r.ttft for r in reqs if r.ttft is not None]
        measured = elapsed * self.time_scale
        self.ran[job.jobid] = {
            "mesh_shape": tuple(mesh.devices.shape),
            "n_devices": int(mesh.size),
            "device_ids": list(_device_ids(mesh)),
            "hosts": list(rset.hosts),
            "n_requests": len(reqs),
            "n_tokens": n_tok,
            "tokens": [list(r.tokens) for r in reqs],
            "tokens_per_s": n_tok / max(elapsed, 1e-9),
            "ttft_mean_s": sum(ttfts) / max(len(ttfts), 1),
            "measured_s": measured,
        }
        wall = measured + tbon_bootstrap_cost(self.net, rset.n_hosts,
                                              self.k)
        self.clock.call_in(wall, done, "completed", wall)


class FleetServeExecutor(ServeExecutor):
    """A serve job served by N engine REPLICAS behind one Router — the
    Flux-Operator shape (one reconciled allocation, many workers)
    applied to serving.

    The reconciler binds ONE allocation of ``replicas x
    nodes_per_replica`` hosts; this executor slices it pod-major into
    ``replicas`` consecutive host groups, raises a submesh per group,
    and builds one :class:`repro_torch.serve.Router` over shape-identical
    engines that share one set of parameter tensors on the device (never
    copies: so the fleet is a true replica set, the shared prefix
    cache's token-identity guarantee holds, and two replicas of a 6e9
    model on one card hold its 12 GB of weights once).  Dispatch, tenant
    fairness and the prefix cache all live in the router; ``ran``
    records per-replica meshes and the fleet-level stats, plus the
    router's ``desired_replicas`` signal for the autoscaler.
    """

    def __init__(self, clock: SimClock, net: NetModel, replicas: int = 2,
                 nodes_per_replica: int = 1, tenant: str = "default",
                 ttft_slo_s: float = 0.0, **kw):
        super().__init__(clock, net, **kw)
        self.replicas = max(replicas, 1)
        self.nodes_per_replica = max(nodes_per_replica, 1)
        self.tenant = tenant
        self.ttft_slo_s = ttft_slo_s or None
        self._fleets: Dict = {}
        self._meshes: Dict = {}         # fleet key -> per-replica meshes

    def _slices(self, rset: ResourceSet) -> List[ResourceSet]:
        """Pod-major consecutive host groups, one per replica (the match
        already sorted hosts pod-major, so groups stay pod-local when
        the allocation allows it)."""
        npr = self.nodes_per_replica
        assert rset.n_hosts == self.replicas * npr, \
            (rset.n_hosts, self.replicas, npr)
        out = []
        for r in range(self.replicas):
            lo, hi = r * npr, (r + 1) * npr
            out.append(ResourceSet(
                hosts=tuple(rset.hosts[lo:hi]),
                chips_per_host=rset.chips_per_host,
                pods=tuple(rset.pods[lo:hi]) if rset.pods else ()))
        return out

    def _fleet(self, command: str, rset: ResourceSet):
        key = (command, tuple(rset.hosts), rset.chips_per_host)
        fleet = self._fleets.get(key)
        if fleet is not None and all(_live(e) for e in fleet.engines):
            return fleet, self._meshes[key]
        from repro_torch.dist.sharding import submesh_for
        from repro_torch.serve import Engine, Router
        cfg = self.cfg or smoke_config_for(command)
        ecfg = self._default_ecfg()
        meshes = [submesh_for(sub, self.devices) for sub in self._slices(rset)]
        params: Dict = {}                # device -> the one parameter set
        engines = []
        for mesh in meshes:
            if self.ranks is not None:
                # each replica on the disjoint ranks of its host group,
                # its parameters drawn there from seed 0
                eng = self._new_engine(cfg, ecfg, mesh)
            else:
                dev = _one_device(mesh)
                if dev not in params:
                    params[dev] = _params(cfg, 0, dev)
                eng = Engine(cfg, ecfg, params=params[dev], seed=0,
                             device=dev)
            self._warm(eng)
            engines.append(eng)
        fleet = Router(engines)       # prefix cache auto-enables when
        self._fleets[key] = fleet     # the replicas support it
        self._meshes[key] = meshes
        return fleet, meshes

    def __call__(self, job: Job, rset: ResourceSet, done):
        fleet, meshes = self._fleet(job.spec.command, rset)
        eng = fleet.engines[0]
        prompts, max_new, temp = self._job_prompts(job, eng.cfg, eng.ecfg)
        tenant = str(job.spec.args.get("tenant", self.tenant))
        slo = job.spec.args.get("ttft_slo_s", self.ttft_slo_s) or None
        t0 = time.perf_counter()
        reqs = [fleet.submit(p, max_new_tokens=max_new, temperature=temp,
                             tenant=tenant, ttft_slo_s=slo)
                for p in prompts]
        fleet.run()
        _sync(eng.device)
        elapsed = time.perf_counter() - t0
        n_tok = sum(len(r.tokens) for r in reqs)
        ttfts = [r.ttft_e2e for r in reqs if r.ttft_e2e is not None]
        measured = elapsed * self.time_scale
        stats = fleet.stats()
        self.ran[job.jobid] = {
            "replicas": self.replicas,
            "mesh_shapes": [tuple(m.devices.shape) for m in meshes],
            "n_devices": sum(int(m.size) for m in meshes),
            "hosts": list(rset.hosts),
            "n_requests": len(reqs),
            "n_tokens": n_tok,
            "tokens": [list(r.tokens) for r in reqs],
            "tokens_per_s": n_tok / max(elapsed, 1e-9),
            "ttft_mean_s": sum(ttfts) / max(len(ttfts), 1),
            "n_prefills": stats["n_prefills"],
            "prefix_cache": stats.get("prefix_cache"),
            "desired_replicas": fleet.desired_replicas(),
            "measured_s": measured,
        }
        wall = measured + tbon_bootstrap_cost(self.net, rset.n_hosts,
                                              self.k)
        self.clock.call_in(wall, done, "completed", wall)


@dataclass
class _ServeSession:
    """One elastic serve job's state across resizes and requeues."""

    job: Job
    cfg: object
    ecfg: object
    engine: object = None             # live Engine, None while parked
    parked: Optional[Dict] = None     # host-side engine snapshot
    arrivals: List = field(default_factory=list)   # submitted while parked
    requests: List = field(default_factory=list)   # every Request served
    min_total: int = 0                # requests the job must serve
    ticks: int = 0                    # engine ticks that did work
    generation: int = 0
    mesh: object = None
    pending: Optional[int] = None     # resize target not yet applied
    pending_source: str = ""
    t_resize_sim: Optional[float] = None
    resize_from: Optional[int] = None
    resumes: List[Dict] = field(default_factory=list)
    _resume_rec: Optional[Dict] = None
    park_s: List[float] = field(default_factory=list)    # wall, per park
    adopt_s: List[float] = field(default_factory=list)   # wall, per adopt


class ElasticServeExecutor(ServeExecutor):
    """Serve jobs that SURVIVE MiniCluster grow/shrink.  Serving
    checkpoints NOTHING: the engine's entire decode state (the paged KV
    pool, the block table / lengths / free lists, each slot's next
    token, and the sampling generator's state) is parked host-side in
    the graceful window ``FluxMiniCluster.patch_size`` opens
    (``Engine.snapshot_state``), a fresh engine is built on the new
    allocation's mesh (``sharding.submesh_for`` through
    ``match_pod_local``, so resized engines keep packing into one pod),
    and the snapshot is adopted by the new engine
    (``Engine.adopt_state``) — in-flight requests resume at the exact
    token they were parked at, and requests submitted mid-resize are
    admitted on the first tick after the rebuild.  Every engine of a job
    takes the same parameter tensors, drawn once on the device.

    Because parking freezes the tick stream rather than replaying it,
    the generated tokens are TOKEN-FOR-TOKEN identical to an
    uninterrupted run at any temperature.  Engine ticks run in chunks
    across simulator events so resizes land between decode steps,
    exactly as they would against a live serving loop.  The wall
    seconds of each park and adopt are kept in the session
    (``park_s``, ``adopt_s``).
    """

    def __init__(self, clock: SimClock, net: NetModel,
                 tbon_fanout: int = 2, n_requests: int = 2,
                 prompt_len: int = 8, max_new: int = 4,
                 time_scale: float = 1.0, strategy=None,
                 engine_config=None, cfg=None, seed: int = 0,
                 ticks_per_chunk: int = 1,
                 sim_tick_time: Optional[float] = 5.0,
                 drain_ticks: int = 0, device=None, ranks=None):
        super().__init__(clock, net, tbon_fanout=tbon_fanout,
                         n_requests=n_requests, prompt_len=prompt_len,
                         max_new=max_new, time_scale=time_scale,
                         strategy=strategy, engine_config=engine_config,
                         cfg=cfg, device=device, ranks=ranks)
        self.seed = seed
        self.ticks_per_chunk = max(ticks_per_chunk, 1)
        self.sim_tick_time = sim_tick_time
        # ticks granted to in-flight slots inside the graceful window
        # before the rest are parked (requests about to finish get out)
        self.drain_ticks = drain_ticks
        self.mc = None
        self.sessions: Dict[int, _ServeSession] = {}
        self._params: Dict = {}       # (cfg name, device) -> params
        self.phase_cb = None
        # optional obs.trace.Tracer: park/rebuild/adopt become spans on
        # the trace ``resize-<jobid>`` (sim axis, wall costs in attrs)
        self.tracer = None

    # -- reconciler event plumbing -----------------------------------------
    def bind(self, minicluster) -> "ElasticServeExecutor":
        """Subscribe to the MiniCluster's resize events."""
        self.mc = minicluster
        minicluster.on_resize.append(self._on_resize)
        return self

    def _on_resize(self, new_size: int, source: str):
        """Graceful window: pods have not moved yet.  A shrink parks the
        engine NOW (its hosts may be torn down the moment the window
        closes); a grow keeps serving on the old mesh and parks only at
        the remesh boundary, once the new ranks can actually be used."""
        if self.mc is not None:
            clamp_queued_jobs(self.mc.instance, new_size)
        # a CLUSTER shrink can evict any session's hosts — including a
        # session whose own size request does not change — so every live
        # engine parks in the window
        cluster_shrink = (self.mc is not None
                          and new_size < len(self.mc._assigned))
        for ses in self.sessions.values():
            job = ses.job
            if job.state != JobState.RUN:
                continue
            ses.pending = new_size
            ses.pending_source = source
            ses.t_resize_sim = self.clock.now
            ses.resize_from = (job.allocation.n_hosts
                               if job.allocation else None)
            job.spec.n_nodes = new_size
            if cluster_shrink and ses.engine is not None:
                self._drain_and_park(ses)
            if self.phase_cb is not None:
                self.phase_cb(job.jobid, "Resizing", target=new_size,
                              source=source)

    # -- park / restore -----------------------------------------------------
    def _drain_and_park(self, ses: _ServeSession):
        """Give in-flight slots up to ``drain_ticks`` normal ticks to
        finish, then freeze the engine host-side
        (``Engine.snapshot_state``).  Drain ticks are ordinary ticks
        (they happen in an uninterrupted run too), so parking never
        perturbs the token stream."""
        eng = ses.engine
        for _ in range(self.drain_ticks):
            if not eng.scheduler.running:
                break
            if eng.step():
                ses.ticks += 1
        t0 = time.perf_counter()
        ses.parked = eng.snapshot_state()
        ses.park_s.append(time.perf_counter() - t0)
        if self.ranks is not None:
            eng.close()                 # freed before the new mesh draws
        ses.engine = None
        self.clock.trace("serve_park", jobid=ses.job.jobid,
                         in_flight=len(ses.parked["running"]),
                         waiting=len(ses.parked["waiting"]))
        if self.tracer is not None:
            self.tracer.event("park", f"resize-{ses.job.jobid}",
                              t=self.clock.now,
                              in_flight=len(ses.parked["running"]),
                              waiting=len(ses.parked["waiting"]))

    def _restore(self, ses: _ServeSession, eng):
        """Adopt a parked snapshot into a freshly built engine (the pool
        copies onto the new engine's device, host bookkeeping copies
        over), then requests that arrived mid-resize join the waiting
        queue in submission order."""
        t0 = time.perf_counter()
        eng.adopt_state(ses.parked)
        _sync(eng.device)
        ses.adopt_s.append(time.perf_counter() - t0)
        ses.parked = None
        n_arrivals = len(ses.arrivals)
        for req in ses.arrivals:
            eng.scheduler.submit(req)
        ses.arrivals = []
        sch = eng.scheduler
        if self.tracer is not None:
            self.tracer.event("adopt", f"resize-{ses.job.jobid}",
                              t=self.clock.now,
                              in_flight=len(sch.running),
                              adopted_arrivals=n_arrivals)

    def _device_params(self, cfg, device):
        key = (cfg.name, device)
        params = self._params.get(key)
        if params is None:
            params = _params(cfg, self.seed, device)
            self._params[key] = params
        return params

    # -- request API --------------------------------------------------------
    def submit_request(self, job: Job, prompt, max_new: int = None,
                       temperature: float = 0.0):
        """Submit one request to an elastic serve job.  Arrivals before
        the first placement or during a resize queue with everything
        else and are admitted on the first (post-rebuild) tick."""
        from repro_torch.serve.scheduler import Request
        ses = self._session(job)
        req = Request(prompt=list(prompt),
                      max_new_tokens=(self.max_new if max_new is None
                                      else max_new),
                      temperature=temperature)
        ses.requests.append(req)
        ses.min_total += 1
        if ses.engine is not None:
            ses.engine.scheduler.submit(req)
        else:
            ses.arrivals.append(req)
        return req

    # -- session management -------------------------------------------------
    def _session(self, job: Job) -> _ServeSession:
        ses = self.sessions.get(job.jobid)
        if ses is not None:
            return ses
        cfg = self.cfg or smoke_config_for(job.spec.command)
        ses = _ServeSession(job=job, cfg=cfg, ecfg=self._default_ecfg())
        self.sessions[job.jobid] = ses
        return ses

    # -- placement: (re)build the engine on this allocation's mesh ---------
    def __call__(self, job: Job, rset: ResourceSet, done):
        from repro_torch.dist.sharding import submesh_for
        from repro_torch.serve import Engine

        ses = self._session(job)
        ses.generation += 1
        gen = ses.generation
        mesh = submesh_for(rset, self.devices)
        t0 = time.perf_counter()
        if self.ranks is not None:
            if ses.engine is not None:
                ses.engine.close()      # a requeue's unparked engine
                ses.engine = None
            eng = self._new_engine(ses.cfg, ses.ecfg, mesh, seed=self.seed)
        else:
            dev = _one_device(mesh)
            eng = Engine(ses.cfg, ses.ecfg, device=dev, seed=self.seed,
                         params=self._device_params(ses.cfg, dev))
        if ses.parked is not None:
            self._restore(ses, eng)
        else:
            from repro_torch.serve.scheduler import WAITING, Request
            if gen == 1:
                # first placement: the job's declared batch, ahead of
                # any request already submitted through the handle
                prompts = job.spec.args.get("prompts")
                if prompts is None:
                    n = int(job.spec.args.get("n_requests",
                                              self.n_requests))
                    prompts = _synthetic_prompts(
                        n, min(self.prompt_len, ses.ecfg.max_prompt_len),
                        ses.cfg.vocab_size)
                max_new = int(job.spec.args.get("max_new", self.max_new))
                temp = float(job.spec.args.get("temperature", 0.0))
                initial = [
                    Request(prompt=list(p)[:ses.ecfg.max_prompt_len],
                            max_new_tokens=max_new, temperature=temp)
                    for p in prompts]
                ses.requests[:0] = initial
                ses.min_total += len(initial)
            else:
                # fault-path requeue with no parked snapshot: the pool
                # died with the old placement, so unfinished requests
                # restart from their prompt (tokens regenerate; only a
                # RESIZE is pinned lossless — a lost host is a real
                # failure)
                for req in ses.requests:
                    if not req.finished:
                        req.tokens.clear()
                        req.state = WAITING
                        req.slot = None
                        req.t_first = None
            for req in ses.requests:
                if not req.finished:
                    eng.scheduler.submit(req)
            ses.arrivals = []           # all live requests re-queued above
        ses.engine = eng
        ses.mesh = mesh
        if ses.pending is not None and rset.n_hosts == ses.pending:
            ses.pending = None
        if ses.t_resize_sim is not None:
            ses._resume_rec = {
                "jobid": job.jobid,
                "transition": f"{ses.resize_from}->{rset.n_hosts}",
                "source": ses.pending_source,
                "tick": ses.ticks,
                "mesh_shape": list(mesh.devices.shape),
                "rebuild_s": time.perf_counter() - t0,
                "t_resize_sim": ses.t_resize_sim,
                "t_place_sim": self.clock.now,
            }
            ses.t_resize_sim = None
        self.clock.trace("serve_place", jobid=job.jobid,
                         hosts=list(rset.hosts),
                         mesh=list(mesh.devices.shape),
                         in_flight=len(eng.scheduler.running))
        if self.phase_cb is not None and gen > 1:
            self.phase_cb(job.jobid, "Running",
                          mesh=list(mesh.devices.shape))
        boot = tbon_bootstrap_cost(self.net, rset.n_hosts, self.k)
        self.clock.call_in(boot, self._tick, job, ses, gen, done)

    # -- elastic transition at a tick boundary ------------------------------
    def _try_remesh(self, job: Job, ses: _ServeSession, done) -> bool:
        """Apply a pending resize: park (if not already), re-match at
        the new size and rebuild.  Returns False while new ranks are
        still booting — serving continues on the old mesh until the
        cluster can actually satisfy the new size."""
        want = ses.pending
        if job.allocation is not None and job.allocation.n_hosts == want:
            # resize was a no-op for this job's allocation (e.g. a
            # shrink that spared its hosts): resume in place
            ses.pending = None
            if ses.parked is not None:
                self(job, job.allocation, done)
                return True
            ses.t_resize_sim = None
            ses.resize_from = None
            return False
        graph = self.mc.instance.graph
        held = set(job.allocation.hosts) if job.allocation else set()
        free = [h.hid for h in graph.free_hosts() if h.hid not in held]
        if len(free) + len(held) < want:
            return False
        if ses.parked is None and ses.engine is not None:
            self._drain_and_park(ses)        # grow parks at the boundary
        graph.free(job.jobid)
        # serve engines follow the same pod-locality rule as train jobs:
        # pack into one pod whenever the new size fits
        rset = (self.mc.instance.match_pod_local(want)
                if job.spec.attributes.get("pod_local", True)
                else graph.match(want, policy=self.mc.instance.match_policy))
        assert rset is not None, "remesh match must succeed (checked above)"
        graph.alloc(rset, job.jobid)
        job.allocation = rset
        job.spec.n_nodes = want
        self.clock.trace("serve_remesh", jobid=job.jobid,
                         hosts=list(rset.hosts))
        self(job, rset, done)
        return True

    # -- the chunked serving loop -------------------------------------------
    def _tick(self, job: Job, ses: _ServeSession, gen: int, done):
        if gen != ses.generation or job.state != JobState.RUN:
            return                     # superseded by a requeue/remesh
        if ses.pending is not None and self._try_remesh(job, ses, done):
            return
        eng = ses.engine
        t0 = time.perf_counter()
        n = 0
        if eng is not None:
            for _ in range(self.ticks_per_chunk):
                if not eng.step():
                    break
                n += 1
                ses.ticks += 1
        elapsed = time.perf_counter() - t0
        if ses._resume_rec is not None and n:
            rec = ses._resume_rec
            rec["first_chunk_s"] = elapsed
            t0sim = rec.pop("t_resize_sim")
            t_place = rec.pop("t_place_sim", self.clock.now)
            rec["time_to_resume_s"] = rec["rebuild_s"] + elapsed
            rec["sim_resume_gap_s"] = self.clock.now - t0sim
            ses.resumes.append(rec)
            ses._resume_rec = None
            if self.tracer is not None:
                trn = f"resize-{job.jobid}"
                self.tracer.span(
                    "graceful_window", trn, t0sim, t_place,
                    action="park", transition=rec["transition"],
                    source=rec["source"], tick=rec["tick"])
                self.tracer.span(
                    "rebuild", trn, t_place, self.clock.now,
                    rebuild_s=rec["rebuild_s"], first_chunk_s=elapsed,
                    mesh_shape=rec["mesh_shape"])
                self.tracer.event(
                    "resumed", trn, t=self.clock.now,
                    time_to_resume_s=rec["time_to_resume_s"],
                    sim_resume_gap_s=rec["sim_resume_gap_s"])
        served = sum(1 for r in ses.requests if r.finished)
        idle = eng is not None and not eng.scheduler.has_work
        if idle and served >= ses.min_total and ses.pending is None:
            ttfts = [r.ttft for r in ses.requests if r.ttft is not None]
            n_tok = sum(len(r.tokens) for r in ses.requests)
            self.ran[job.jobid] = {
                "mesh_shape": tuple(ses.mesh.devices.shape),
                "n_devices": int(ses.mesh.size),
                "hosts": list(job.allocation.hosts),
                "n_requests": len(ses.requests),
                "n_tokens": n_tok,
                "tokens": [list(r.tokens) for r in ses.requests],
                "ttft_mean_s": sum(ttfts) / max(len(ttfts), 1),
                "ticks": ses.ticks,
                "n_resumes": len(ses.resumes),
                "resumes": ses.resumes,
            }
            dt = (self.sim_tick_time * max(n, 1)
                  if self.sim_tick_time is not None
                  else elapsed * self.time_scale)
            self.clock.call_in(dt, done, "completed",
                               self.clock.now + dt - (job.t_run or 0.0))
        else:
            dt = (self.sim_tick_time * max(n, 1)
                  if self.sim_tick_time is not None
                  else max(elapsed * self.time_scale, 1e-3))
            self.clock.call_in(dt, self._tick, job, ses, gen, done)


@dataclass
class _FleetSession:
    """One elastic fleet serve job's state across scale-ups, requeues
    and rolling promotions."""

    job: Job
    cfg: object
    ecfg: object
    router: object = None             # live Router, None before placement
    rsets: List[ResourceSet] = field(default_factory=list)  # per replica
    meshes: List = field(default_factory=list)              # per replica
    requests: List = field(default_factory=list)   # every Request served
    arrivals: List = field(default_factory=list)   # pre-placement submits
    min_total: int = 0                # requests the job must serve
    ticks: int = 0                    # router ticks that did work
    generation: int = 0
    params: object = None             # CURRENT param tree on the device
    version: int = 0                  # bumps on each completed promotion
    pending_replicas: Optional[int] = None   # scale target not yet met
    pending_source: str = ""
    promo: Optional[Dict] = None      # in-progress rolling promotion
    promotions: List[Dict] = field(default_factory=list)
    scale_events: List[Dict] = field(default_factory=list)


class ElasticFleetServeExecutor(ServeExecutor):
    """A REPLICATED serve fleet that stays live through cluster resizes
    and checkpoint promotions — :class:`FleetServeExecutor`'s Router
    over shape-identical replicas, driven with
    :class:`ElasticServeExecutor`'s chunked tick loop so scale and
    promotion events land between decode steps, exactly as they would
    against a production serving tier.

    Two operations distinguish it from the one-shot fleet:

    * **Live scale-up** — a ``FluxMiniCluster.patch_size`` grow (e.g.
      the autoscaler acting on ``Router.desired_replicas``) sets a
      pending replica target; at the next tick boundary the executor
      matches ``nodes_per_replica`` free hosts per missing replica,
      raises a submesh, warms an engine on the CURRENT params and
      ``Router.add_engine``s it — requests already in flight never
      notice.
    * **Rolling canary promotion** — :meth:`promote` swaps new params
      into the fleet one replica per tick: freeze the replica
      (``Engine.snapshot_state``), build+warm a fresh engine with the
      NEW params on the same mesh, adopt the snapshot
      (``Engine.adopt_state``), ``Router.swap_engine`` it in place.
      In-flight requests on the replica continue at the exact token
      they were parked at; replicas not yet promoted keep generating
      token-for-token what an unpromoted run would (the sampling
      generator's state rides each snapshot).  The shared prefix cache
      is dropped at promotion start: cached KV was computed under the
      old params.

    The replicas share one parameter set on the device, drawn from
    ``seed`` as a default Engine draws its own, until a promotion: its
    params (any tree of tensors, e.g. a train state's float32 params on
    the host) are put on the device once, in the dtypes of the engines'
    own (``serving_params``), and shared by the replicas it promotes.

    A cluster shrink that tears down hosts this fleet holds rides the
    ordinary requeue path (the fleet rebuilds at the new size;
    unfinished requests restart from their prompt) — only grow and
    promotion are pinned lossless.
    """

    def __init__(self, clock: SimClock, net: NetModel, replicas: int = 2,
                 nodes_per_replica: int = 1, tenant: str = "default",
                 ttft_slo_s: float = 0.0, tbon_fanout: int = 2,
                 n_requests: int = 2, prompt_len: int = 8,
                 max_new: int = 4, time_scale: float = 1.0,
                 strategy=None, engine_config=None, cfg=None,
                 seed: int = 0, ticks_per_chunk: int = 1,
                 sim_tick_time: Optional[float] = 5.0, device=None,
                 ranks=None):
        super().__init__(clock, net, tbon_fanout=tbon_fanout,
                         n_requests=n_requests, prompt_len=prompt_len,
                         max_new=max_new, time_scale=time_scale,
                         strategy=strategy, engine_config=engine_config,
                         cfg=cfg, device=device, ranks=ranks)
        self.replicas = max(replicas, 1)
        self.nodes_per_replica = max(nodes_per_replica, 1)
        self.tenant = tenant
        self.ttft_slo_s = ttft_slo_s or None
        self.seed = seed
        self.ticks_per_chunk = max(ticks_per_chunk, 1)
        self.sim_tick_time = sim_tick_time
        self.mc = None
        self.sessions: Dict[int, _FleetSession] = {}
        self._params: Dict = {}       # (cfg name, device) -> init params
        self.phase_cb = None
        # optional obs.trace.Tracer: scale/promotion become events on
        # the trace ``promo-<jobid>`` (sim axis, wall costs in attrs)
        self.tracer = None

    # -- reconciler event plumbing -----------------------------------------
    def bind(self, minicluster) -> "ElasticFleetServeExecutor":
        """Subscribe to the MiniCluster's resize events."""
        self.mc = minicluster
        minicluster.on_resize.append(self._on_resize)
        return self

    def _on_resize(self, new_size: int, source: str):
        """Graceful window.  A grow records a pending replica target to
        apply at the next tick boundary (once the new ranks boot); a
        shrink only clamps the spec — if the reconciler tears down
        hosts this fleet holds, the requeue path rebuilds it."""
        if self.mc is not None:
            clamp_queued_jobs(self.mc.instance, new_size)
        npr = self.nodes_per_replica
        for ses in self.sessions.values():
            job = ses.job
            if job.state != JobState.RUN:
                continue
            want = max(1, new_size // npr)
            have = (len(ses.router.engines) if ses.router is not None
                    else self.replicas)
            job.spec.n_nodes = want * npr
            if want > have:
                ses.pending_replicas = want
                ses.pending_source = source
                if self.phase_cb is not None:
                    self.phase_cb(job.jobid, "Resizing",
                                  target_replicas=want, source=source)

    # -- engine construction -------------------------------------------------
    def _device_params(self, cfg, device):
        key = (cfg.name, device)
        params = self._params.get(key)
        if params is None:
            params = _params(cfg, self.seed, device)
            self._params[key] = params
        return params

    def _slices(self, rset: ResourceSet,
                replicas: int) -> List[ResourceSet]:
        """Pod-major consecutive host groups, one per replica."""
        npr = self.nodes_per_replica
        assert rset.n_hosts == replicas * npr, \
            (rset.n_hosts, replicas, npr)
        out = []
        for r in range(replicas):
            lo, hi = r * npr, (r + 1) * npr
            out.append(ResourceSet(
                hosts=tuple(rset.hosts[lo:hi]),
                chips_per_host=rset.chips_per_host,
                pods=tuple(rset.pods[lo:hi]) if rset.pods else ()))
        return out

    def _build_engine(self, ses: _FleetSession, mesh, params=None):
        """One warmed replica engine on the mesh's device (on its ranks,
        given a pool: drawn there from the seed until a promotion gives
        the fleet other params).  The warm request drives the prefill and
        the decode step once, outside timing (the shared executor
        contract); every replica — including reference runs and promoted
        engines before they adopt a snapshot — warms identically, so
        warmup never perturbs token identity."""
        if self.ranks is not None:
            eng = self._new_engine(ses.cfg, ses.ecfg, mesh, seed=self.seed,
                                   params=(params if params is not None
                                           else ses.params))
            self._warm(eng)
            return eng
        from repro_torch.serve import Engine
        dev = _one_device(mesh)
        if params is None:
            if ses.params is None:
                ses.params = self._device_params(ses.cfg, dev)
            params = ses.params
        eng = Engine(ses.cfg, ses.ecfg, params=params, seed=self.seed,
                     device=dev)
        self._warm(eng)
        return eng

    # -- request API --------------------------------------------------------
    def submit_request(self, job: Job, prompt, max_new: int = None,
                       temperature: float = 0.0, tenant: str = None,
                       ttft_slo_s: float = None):
        """Submit one request to a live fleet job.  Arrivals before the
        first placement queue and are admitted on the first tick."""
        from repro_torch.serve.scheduler import Request
        ses = self._session(job)
        req = Request(prompt=list(prompt),
                      max_new_tokens=(self.max_new if max_new is None
                                      else max_new),
                      temperature=temperature,
                      tenant=self.tenant if tenant is None else tenant,
                      ttft_slo_s=(self.ttft_slo_s if ttft_slo_s is None
                                  else ttft_slo_s) or None)
        ses.requests.append(req)
        ses.min_total += 1
        if ses.router is not None:
            req.t_created = ses.router.clock.now()
            ses.router.enqueue(req)
        else:
            ses.arrivals.append(req)
        return req

    # -- session management -------------------------------------------------
    def _session(self, job: Job) -> _FleetSession:
        ses = self.sessions.get(job.jobid)
        if ses is not None:
            return ses
        cfg = self.cfg or smoke_config_for(job.spec.command)
        ses = _FleetSession(job=job, cfg=cfg, ecfg=self._default_ecfg())
        self.sessions[job.jobid] = ses
        return ses

    # -- placement: (re)build the fleet on this allocation ------------------
    def __call__(self, job: Job, rset: ResourceSet, done):
        from repro_torch.dist.sharding import submesh_for
        from repro_torch.serve import Router
        from repro_torch.serve.scheduler import WAITING

        ses = self._session(job)
        ses.generation += 1
        gen = ses.generation
        if ses.promo is not None:
            # a requeue mid-promotion aborts the roll: the rebuilt fleet
            # serves the OLD params uniformly (promote again to retry)
            ses.promo["rec"]["aborted"] = True
            ses.promotions.append(ses.promo["rec"])
            ses.promo = None
        replicas = max(1, rset.n_hosts // self.nodes_per_replica)
        slices = self._slices(rset, replicas)
        meshes = [submesh_for(sub, self.devices) for sub in slices]
        engines = [self._build_engine(ses, mesh) for mesh in meshes]
        router = Router(engines, tracer=self.tracer)
        ses.rsets = slices
        ses.meshes = meshes
        if gen == 1:
            from repro_torch.serve.scheduler import Request
            vocab = ses.cfg.vocab_size
            plen = min(self.prompt_len, ses.ecfg.max_prompt_len)
            prompts = job.spec.args.get("prompts")
            if prompts is None:
                n = int(job.spec.args.get("n_requests", self.n_requests))
                prompts = _synthetic_prompts(n, plen, vocab)
            max_new = int(job.spec.args.get("max_new", self.max_new))
            temp = float(job.spec.args.get("temperature", 0.0))
            tenant = str(job.spec.args.get("tenant", self.tenant))
            slo = job.spec.args.get("ttft_slo_s", self.ttft_slo_s) or None
            initial = [
                Request(prompt=list(p)[:ses.ecfg.max_prompt_len],
                        max_new_tokens=max_new, temperature=temp,
                        tenant=tenant, ttft_slo_s=slo)
                for p in prompts]
            ses.requests[:0] = initial
            ses.min_total += len(initial)
        else:
            # fault-path requeue: the pools died with the old placement,
            # so unfinished requests restart from their prompt (tokens
            # regenerate; only scale-up and promotion are pinned
            # lossless — a lost host is a real failure)
            for req in ses.requests:
                if not req.finished:
                    req.tokens.clear()
                    req.state = WAITING
                    req.slot = None
                    req.t_first = None
        for req in ses.requests:
            if not req.finished:
                req.t_created = router.clock.now()
                router.enqueue(req)
        ses.arrivals = []               # all live requests queued above
        ses.router = router
        if (ses.pending_replicas is not None
                and replicas >= ses.pending_replicas):
            ses.pending_replicas = None
        self.clock.trace("fleet_place", jobid=job.jobid,
                         replicas=replicas, hosts=list(rset.hosts))
        if self.phase_cb is not None and gen > 1:
            self.phase_cb(job.jobid, "Running", replicas=replicas)
        boot = tbon_bootstrap_cost(self.net, rset.n_hosts, self.k)
        self.clock.call_in(boot, self._tick, job, ses, gen, done)

    # -- live scale-up at a tick boundary -----------------------------------
    def _try_scale(self, job: Job, ses: _FleetSession):
        """Add replicas toward the pending target, one engine per free
        ``nodes_per_replica`` host group.  Partial progress is fine —
        the target stays pending until the cluster can supply the
        rest."""
        if ses.pending_replicas is None or ses.router is None:
            return
        from repro_torch.dist.sharding import submesh_for
        graph = self.mc.instance.graph
        npr = self.nodes_per_replica
        while len(ses.router.engines) < ses.pending_replicas:
            rset = graph.match(npr, policy=self.mc.instance.match_policy,
                               same_pod=True)
            if rset is None:
                rset = graph.match(npr,
                                   policy=self.mc.instance.match_policy)
            if rset is None:
                return                  # new ranks still booting
            graph.alloc(rset, job.jobid)
            old = job.allocation
            job.allocation = ResourceSet(
                hosts=tuple(old.hosts) + tuple(rset.hosts),
                chips_per_host=old.chips_per_host,
                pods=(tuple(old.pods) + tuple(rset.pods)
                      if old.pods and rset.pods else ()))
            mesh = submesh_for(rset, self.devices)
            eng = self._build_engine(ses, mesh)
            idx = ses.router.add_engine(eng)
            ses.rsets.append(rset)
            ses.meshes.append(mesh)
            ses.scale_events.append({
                "t_sim": self.clock.now, "replica": idx,
                "hosts": list(rset.hosts),
                "source": ses.pending_source,
                "replicas": len(ses.router.engines)})
            self.clock.trace("fleet_scale_up", jobid=job.jobid,
                             replica=idx, hosts=list(rset.hosts))
            if self.tracer is not None:
                self.tracer.event("scale_up", f"promo-{job.jobid}",
                                  t=self.clock.now, replica=idx,
                                  replicas=len(ses.router.engines))
        ses.pending_replicas = None
        if self.phase_cb is not None:
            self.phase_cb(job.jobid, "Running",
                          replicas=len(ses.router.engines))

    # -- rolling canary promotion -------------------------------------------
    def promote(self, job: Job, params, note: str = "",
                on_done: Callable = None) -> Dict:
        """Begin rolling NEW params into the live fleet, one replica
        per tick.  Returns the (mutable) promotion record; ``on_done``
        fires with it once every replica runs the new version.  The
        record's ``steps`` carry each replica's wall seconds
        (``wall_s``: freeze, build and warm, adopt, swap)."""
        ses = self._session(job)
        if ses.promo is not None:
            raise RuntimeError(
                f"job {job.jobid}: promotion already in progress")
        n_rep = len(ses.router.engines) if ses.router is not None else 0
        in_flight = (sum(len(e.scheduler.running)
                         for e in ses.router.engines)
                     if ses.router is not None else 0)
        rec = {
            "note": note,
            "from_version": ses.version,
            "to_version": ses.version + 1,
            "t_begin_sim": self.clock.now,
            "replicas_at_begin": n_rep,
            "in_flight_at_begin": in_flight,
            "steps": [],
        }
        ses.promo = {"params": params, "on_device": {}, "next": 0,
                     "rec": rec, "on_done": on_done}
        router = ses.router
        if router is not None and router.prefix_cache is not None:
            # cached KV was computed under the OLD params — drop it
            rec["prefix_cache_dropped"] = True
            router.prefix_cache = None
            for eng in router.engines:
                eng.prefix_cache = None
        self.clock.trace("promote_begin", jobid=job.jobid,
                         replicas=n_rep, in_flight=in_flight)
        if self.tracer is not None:
            self.tracer.event("promote_begin", f"promo-{job.jobid}",
                              t=self.clock.now, note=note,
                              replicas=n_rep, in_flight=in_flight)
        return rec

    def _promoted_params(self, promo: Dict, eng):
        """The promotion's params on ``eng``'s device in its dtypes, put
        there once and shared by every replica it promotes (for an
        engine on ranks, on the host: each replica's ranks cut theirs)."""
        dev = eng.device
        if dev not in promo["on_device"]:
            promo["on_device"][dev] = serving_params(
                eng.cfg, promo["params"], "cpu" if dev is None else dev,
                eng.compute_dtype)
        return promo["on_device"][dev]

    def _promote_step(self, job: Job, ses: _FleetSession):
        """Promote ONE replica: freeze it, build+warm an engine with
        the new params on the same mesh, adopt the snapshot, swap it
        into the router.  In-flight requests ride the snapshot."""
        promo = ses.promo
        if promo is None or ses.router is None:
            return
        router, i = ses.router, promo["next"]
        if i >= len(router.engines):
            rec = promo["rec"]
            rec["t_done_sim"] = self.clock.now
            rec["sim_promote_s"] = self.clock.now - rec["t_begin_sim"]
            rec["replicas"] = len(router.engines)
            if promo["on_device"]:
                ses.params = next(iter(promo["on_device"].values()))
            ses.version = rec["to_version"]
            ses.promotions.append(rec)
            ses.promo = None
            self.clock.trace("promote_done", jobid=job.jobid,
                             version=ses.version,
                             sim_promote_s=rec["sim_promote_s"])
            if self.tracer is not None:
                self.tracer.event("promote_done", f"promo-{job.jobid}",
                                  t=self.clock.now, version=ses.version,
                                  sim_promote_s=rec["sim_promote_s"])
            if promo["on_done"] is not None:
                promo["on_done"](rec)
            return
        t0 = time.perf_counter()
        eng = router.engines[i]
        in_flight = len(eng.scheduler.running)
        waiting = len(eng.scheduler.waiting)
        snap = eng.snapshot_state()
        # tokens generated per request at the swap point: everything up
        # to here came from the OLD params — the prefix-identity pin
        progress = {r.rid: len(r.tokens)
                    for r in (list(snap["running"].values())
                              + list(snap["waiting"]))}
        new_eng = self._build_engine(ses, ses.meshes[i],
                                     params=self._promoted_params(promo,
                                                                  eng))
        new_eng.adopt_state(snap)
        old = router.swap_engine(i, new_eng)
        if self.ranks is not None:
            old.close()                 # the same ranks hold the new one
        _sync(new_eng.device)
        promo["next"] = i + 1
        promo["rec"]["steps"].append({
            "replica": i, "t_sim": self.clock.now,
            "in_flight": in_flight, "waiting": waiting,
            "token_progress": progress,
            "wall_s": time.perf_counter() - t0})
        self.clock.trace("promote_replica", jobid=job.jobid, replica=i,
                         in_flight=in_flight)
        if self.tracer is not None:
            self.tracer.event("promote_replica", f"promo-{job.jobid}",
                              t=self.clock.now, replica=i,
                              in_flight=in_flight, waiting=waiting)
        if self.phase_cb is not None:
            self.phase_cb(job.jobid, "Running", promoted_replica=i,
                          in_flight=in_flight)

    # -- the chunked fleet loop ---------------------------------------------
    def _tick(self, job: Job, ses: _FleetSession, gen: int, done):
        if gen != ses.generation or job.state != JobState.RUN:
            return                     # superseded by a requeue
        self._try_scale(job, ses)
        self._promote_step(job, ses)
        router = ses.router
        t0 = time.perf_counter()
        n = 0
        for _ in range(self.ticks_per_chunk):
            if not router.step():
                break
            n += 1
            ses.ticks += 1
        elapsed = time.perf_counter() - t0
        served = sum(1 for r in ses.requests if r.finished)
        idle = not router.has_work
        if (idle and served >= ses.min_total and ses.promo is None
                and ses.pending_replicas is None):
            ttfts = [r.ttft for r in ses.requests if r.ttft is not None]
            stats = router.stats()
            self.ran[job.jobid] = {
                "replicas": len(router.engines),
                "nodes_per_replica": self.nodes_per_replica,
                "mesh_shapes": [tuple(m.devices.shape)
                                for m in ses.meshes],
                "n_devices": sum(int(m.size) for m in ses.meshes),
                "hosts": (list(job.allocation.hosts)
                          if job.allocation else []),
                "n_requests": len(ses.requests),
                "n_tokens": sum(len(r.tokens) for r in ses.requests),
                "tokens": [list(r.tokens) for r in ses.requests],
                "assignments": [router.assignments.get(r.rid)
                                for r in ses.requests],
                "ttft_mean_s": sum(ttfts) / max(len(ttfts), 1),
                "ticks": ses.ticks,
                "version": ses.version,
                "promotions": ses.promotions,
                "scale_events": ses.scale_events,
                "n_prefills": stats["n_prefills"],
                "prefix_cache": stats.get("prefix_cache"),
                "desired_replicas": router.desired_replicas(),
            }
            dt = (self.sim_tick_time * max(n, 1)
                  if self.sim_tick_time is not None
                  else elapsed * self.time_scale)
            self.clock.call_in(dt, done, "completed",
                               self.clock.now + dt - (job.t_run or 0.0))
        else:
            dt = (self.sim_tick_time * max(n, 1)
                  if self.sim_tick_time is not None
                  else max(elapsed * self.time_scale, 1e-3))
            self.clock.call_in(dt, self._tick, job, ses, gen, done)
