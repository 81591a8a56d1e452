"""An ``Engine`` on the ranks of a pool mesh, driven from the controller.

``RemoteEngine(cfg, ecfg, mesh=pool_mesh)`` forms the mesh's group on
its ``dist.ranks.RankPool`` and builds, on every rank of it, the
sharded engine on ``dist.mesh.make_mesh`` of the mesh's shape (eager
ticks: a CUDA graph cannot capture a gloo collective).  Parameters are
drawn on each rank from ``seed``, leaf by leaf, each rank keeping its
shard, so no rank holds a whole copy; ``params`` (a whole tree) go to
the ranks through a file instead, and each cuts its shard.

The controller side has the Engine API that the executors and the
``Router`` call: ``submit``, ``step``, ``run``, ``stats``, ``metrics``,
``snapshot_state``, ``adopt_state``, and mirrors of the scheduler's
queues and the page allocator.  Requests are the controller's
``Request`` objects: a submit travels with the next command, and after
each command rank 0 returns every live request's new tokens, state and
time stamps (the ranks' ``time.perf_counter``, the clock the
controller's stamps come from too) with the queues and the allocator,
so code that reads ``req.tokens``, ``req.finished`` or
``eng.scheduler.running`` reads them as it does for a local engine.
``ticks`` keeps each tick's kind and rank 0's seconds for it (host time
around ``Engine.step``, which ends with the tokens on the host).

A snapshot is gathered to rank 0's host and written to a file under the
pool's directory; ``snapshot_state`` returns the file's path with the
controller's requests in their queues, and ``adopt_state`` on an
engine of any mesh reads it (each rank cutting its shard) and removes
it.  The prefix cache of a fleet ``Router`` copies pages between
engines of one process, so it stays off for remote engines.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import BASELINE, ModelConfig, ShardingStrategy
from repro_torch.dist.ranks import RankError, pool_of, slots_of
from repro_torch.models import params as P
from repro_torch.obs.trace import Clock, WallClock
from repro_torch.serve.engine import EngineConfig
from repro_torch.serve.paging import PageAllocator
from repro_torch.serve.scheduler import FINISHED, Request, Scheduler

_HERE = __name__


class _MirrorScheduler(Scheduler):
    """The controller's view of the ranks' scheduler: ``check`` and
    ``submit`` run here (the submit also queues the request for the
    ranks); the queues are rank 0's, refreshed after every command."""

    def __init__(self, eng: "RemoteEngine", **kw):
        super().__init__(**kw)
        self._eng = eng

    def submit(self, req: Request) -> Request:
        super().submit(req)
        self._eng._queue(req)
        return req


class RemoteEngine:
    """See the module's docstring.  ``mesh``: a mesh of a pool's slots
    (``dist.sharding.submesh_for(rset, pool.slots)``)."""

    cuda_graphs = False
    device = None                     # the ranks' devices, not this one

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig = EngineConfig(),
                 *, mesh, strategy: ShardingStrategy = BASELINE,
                 params=None, seed: int = 0, compute_dtype=torch.bfloat16,
                 clock: Optional[Clock] = None):
        pool = pool_of(mesh)
        if pool is None:
            raise ValueError(
                "a RemoteEngine runs on a mesh of a RankPool's slots "
                "(dist.sharding.submesh_for(rset, pool.slots))")
        self.pool, self.slots, self.mesh = pool, slots_of(mesh), mesh
        self.cfg, self.ecfg, self.strategy = cfg, ecfg, strategy
        self.compute_dtype = compute_dtype
        self.clock = clock if clock is not None else WallClock()
        self.layout = ecfg.layout()
        self._chunked = ecfg.prefill_chunk > 0 and not cfg.sub_quadratic
        self.alloc = PageAllocator(ecfg.n_slots, self.layout)
        self.scheduler = _MirrorScheduler(
            self, alloc=self.alloc, max_prompt_len=ecfg.max_prompt_len,
            prefill_chunk=ecfg.prefill_chunk if self._chunked else 0,
            clock=self.clock)
        self.prefix_cache = None
        self.tracer = None
        self._reqs: Dict[int, Request] = {}
        self._outbox: List[Dict] = []
        self.ticks: List = []         # (kind, rank 0's seconds) a tick
        self.gid = pool.group(self.slots)
        self.handle = pool.handle()
        path = None
        if params is not None:
            path = pool.path("params")
            torch.save(P.tree_map(lambda t: t.detach().to("cpu"), params),
                       path)
        try:
            self.splits_slots = self._call(
                "engine_new", tuple(mesh.devices.shape), mesh.axis_names,
                cfg, ecfg, strategy, seed, compute_dtype, path)
        finally:
            if path is not None:
                os.remove(path)

    # -- plumbing -----------------------------------------------------------
    @property
    def alive(self) -> bool:
        """False once the engine's group is dissolved (its slots joined
        another group) or the engine is closed."""
        return self.gid is not None and self.pool.alive(self.gid)

    def _call(self, fn: str, *args):
        if not self.alive:
            raise RankError(f"the engine on ranks {self.slots} is gone: its "
                            "group was dissolved or it was closed")
        submits, self._outbox = self._outbox, []
        out = self.pool.run(self.slots, f"{_HERE}:{fn}", self.handle,
                            submits, *args)
        out, report = out
        self._apply(report)
        return out

    def _queue(self, req: Request) -> None:
        self._reqs[req.rid] = req
        self._outbox.append(dict(
            prompt=list(req.prompt), max_new_tokens=req.max_new_tokens,
            temperature=req.temperature, eos_id=req.eos_id,
            tenant=req.tenant, ttft_slo_s=req.ttft_slo_s, rid=req.rid,
            t_created=req.t_created, t_submit=req.t_submit))

    def _apply(self, report) -> None:
        """Rank 0's requests, queues and allocator onto the mirrors."""
        for rid, (state, slot, new, progress, stamps) in report[
                "reqs"].items():
            req = self._reqs[rid]
            req.state, req.slot, req.prefill_progress = state, slot, progress
            req.tokens.extend(new)
            (req.t_submit, req.t_admit, req.t_prefill_done, req.t_first,
             req.t_done) = stamps
            if state == FINISHED:
                del self._reqs[rid]
        sch = self.scheduler
        sch.waiting = deque(self._reqs[r] for r in report["waiting"])
        sch.prefilling = deque(self._reqs[r] for r in report["prefilling"])
        sch.running = {s: self._reqs[r] for s, r in report["running"].items()}
        sch.n_finished = report["n_finished"]
        self.alloc = sch.alloc = report["alloc"]
        self.ticks.extend(report["ticks"])

    # -- the Engine API -----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               tenant: str = "default",
               ttft_slo_s: Optional[float] = None) -> Request:
        return self.scheduler.submit(Request(
            prompt=list(prompt), max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id, tenant=tenant,
            ttft_slo_s=ttft_slo_s, t_created=self.clock.now()))

    def step(self) -> bool:
        """One tick on every rank; False when there was no work."""
        return self._call("engine_step")

    def run(self) -> None:
        """Ticks on the ranks until every submitted request finished."""
        self._call("engine_run")

    def stats(self) -> dict:
        return self._call("engine_stats")

    @property
    def metrics(self):
        """Rank 0's ``MetricsRegistry`` (a copy)."""
        return self._call("engine_metrics")

    def snapshot_state(self) -> dict:
        """Park: the whole decode state gathered to rank 0's host and
        written to a file; returns its ``path`` and the controller's
        requests in their queues."""
        path = self.pool.path("snapshot")
        self._call("engine_snapshot", path)
        sch = self.scheduler
        return {"path": path, "running": dict(sch.running),
                "waiting": list(sch.waiting),
                "prefilling": list(sch.prefilling)}

    def adopt_state(self, snap: dict) -> None:
        """Take over a :meth:`snapshot_state` snapshot of an engine on
        any mesh, then remove its file."""
        path = snap["path"]
        for req in (list(snap["running"].values()) + list(snap["waiting"])
                    + list(snap["prefilling"])):
            self._reqs[req.rid] = req
        try:
            self._call("engine_adopt", path)
        finally:
            if os.path.exists(path):
                os.remove(path)

    def close(self) -> None:
        """Free the engine on its ranks."""
        if self.alive:
            self.pool.drop(self.gid, self.handle)
        self.gid = None


# ---------------------------------------------------------------------------
# the rank side: each function runs on every rank of the engine's group
# ---------------------------------------------------------------------------

_STAMPS = ("t_submit", "t_admit", "t_prefill_done", "t_first", "t_done")


class _Served:
    """A rank's engine and the requests it reports on."""

    def __init__(self, eng):
        self.eng = eng
        self.live: Dict[int, Request] = {}
        self.sent: Dict[int, int] = {}
        self.ticks: List = []

    def tick(self) -> bool:
        """One ``Engine.step``, its kind and seconds kept."""
        eng = self.eng
        n_dec, n_mix = eng.n_decode_steps, eng.n_mixed_steps
        t = time.perf_counter()
        if not eng.step():
            return False
        kind = ("decode" if eng.n_decode_steps > n_dec else "mixed"
                if eng.n_mixed_steps > n_mix else "prefill")
        self.ticks.append((kind, time.perf_counter() - t))
        return True

    def take(self, submits) -> None:
        for spec in submits:
            spec = dict(spec)
            t_submit = spec.pop("t_submit")
            req = self.eng.scheduler.submit(Request(**spec))
            req.t_submit = t_submit
            self.live[req.rid], self.sent[req.rid] = req, 0

    def report(self) -> Dict:
        reqs = {}
        for rid, req in list(self.live.items()):
            n = self.sent[rid]
            reqs[rid] = (req.state, req.slot, list(req.tokens[n:]),
                         req.prefill_progress,
                         tuple(getattr(req, k) for k in _STAMPS))
            self.sent[rid] = len(req.tokens)
            if req.finished:
                del self.live[rid], self.sent[rid]
        sch = self.eng.scheduler
        ticks, self.ticks = self.ticks, []
        return {"reqs": reqs, "ticks": ticks,
                "waiting": [r.rid for r in sch.waiting],
                "prefilling": [r.rid for r in sch.prefilling],
                "running": {s: r.rid for s, r in sch.running.items()},
                "n_finished": sch.n_finished, "alloc": self.eng.alloc}


def _served(rk, h, submits) -> _Served:
    s = rk.get(h)
    s.take(submits)
    return s


def engine_new(rk, h, submits, shape, axes, cfg, ecfg, strategy, seed,
               compute_dtype, path):
    from repro_torch.serve.engine import Engine
    mesh = rk.mesh(shape, axes)
    params = (torch.load(path, map_location="cpu", weights_only=True)
              if path is not None else None)
    eng = Engine(cfg, ecfg, strategy=strategy,
                 mesh=mesh if mesh.size > 1 else None, params=params,
                 seed=seed, device=rk.device, compute_dtype=compute_dtype,
                 cuda_graphs=False)
    del params
    s = _Served(eng)
    rk.put(h, s)
    s.take(submits)
    return eng.splits_slots, s.report()


def engine_step(rk, h, submits):
    s = _served(rk, h, submits)
    return s.tick(), s.report()


def engine_run(rk, h, submits):
    s = _served(rk, h, submits)
    while s.tick():
        pass
    return None, s.report()


def engine_stats(rk, h, submits):
    s = _served(rk, h, submits)
    return s.eng.stats(), s.report()


def engine_metrics(rk, h, submits):
    s = _served(rk, h, submits)
    return s.eng.metrics, s.report()


def engine_snapshot(rk, h, submits, path):
    s = _served(rk, h, submits)
    snap = s.eng.snapshot_state()
    if rk.rank == 0:
        torch.save(snap, path)
    return None, s.report()


def engine_adopt(rk, h, submits, path):
    s = _served(rk, h, submits)
    snap = torch.load(path, map_location="cpu", weights_only=False)
    s.eng.adopt_state(snap)
    for req in (list(snap["running"].values()) + list(snap["waiting"])
                + list(snap["prefilling"])):
        s.live[req.rid], s.sent[req.rid] = req, len(req.tokens)
    return None, s.report()
