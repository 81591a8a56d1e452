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
it.

A fleet ``Router``'s prefix cache works through the same channel: its
``register`` asks the ranks for a prompt's prefix pages
(:meth:`RemoteEngine.prefix_pages`: rank 0 gathers every rank's KV heads
to its host and writes them to a file), and the entry is held on the
controller's host.  Before each tick the controller works out which
waiting requests the tick admits (rank 0's allocator, mirrored, takes
them in the scheduler's order), looks each up in the cache, and the hits
travel with the tick's command, through a file: on every rank a
stand-in for the cache copies the rank's KV heads of an entry into the
admitted slot's pages at admission.  An entry shipped and not adopted,
or a rank's failure in either direction, raises here.  With a
``tracer`` set, each finished request's spans are recorded from the
mirrored stamps.
"""
from __future__ import annotations

import copy
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import BASELINE, ModelConfig, ShardingStrategy
from repro_torch.dist import sharding as shd
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
        self._adopts: Dict[int, tuple] = {}     # rid -> (pages, entry)
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
        """``fn`` on every rank, with the queued submits and (a tick's)
        the prefix entries its admissions adopt, through a file."""
        if not self.alive:
            raise RankError(f"the engine on ranks {self.slots} is gone: its "
                            "group was dissolved or it was closed")
        submits, self._outbox = self._outbox, []
        adopts, self._adopts = self._adopts, {}
        path = None
        if adopts:
            path = self.pool.path("adopt")
            torch.save({rid: (k, P.tree_map(lambda t: t.clone(), entry))
                        for rid, (k, entry) in adopts.items()}, path)
        try:
            out = self.pool.run(self.slots, f"{_HERE}:{fn}", self.handle,
                                (submits, path), *args)
        finally:
            if path is not None and os.path.exists(path):
                os.remove(path)
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
                if self.tracer is not None:
                    self.tracer.record_request(req)
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
        """One tick on every rank; False when there was no work.  With a
        fleet's prefix cache, the requests the tick admits are looked up
        first (:meth:`_admissions`)."""
        if self.prefix_cache is not None and self._chunked:
            for req in self._admissions():
                self.prefix_cache.adopt(self, req)
        return self._call("engine_step")

    def run(self) -> None:
        """Ticks on the ranks until every submitted request finished
        (tick by tick from here under a prefix cache, which looks up
        each tick's admissions)."""
        if self.prefix_cache is not None:
            while self.step():
                pass
            return
        self._call("engine_run")

    def _admissions(self) -> List[Request]:
        """The waiting requests the next tick admits, in its order: the
        scheduler's ``first_fit`` on a copy of rank 0's allocator."""
        return [req for req, _ in
                self.scheduler.first_fit(copy.deepcopy(self.alloc))]

    # -- the fleet's prefix cache (fleet.PrefixCache) ----------------------
    def prefix_pages(self, slot: int, n_pages: int) -> dict:
        """The KV of the first ``n_pages`` pages of ``slot``, every KV
        head, on this host (``Engine.prefix_pages`` on each rank, the
        heads gathered to rank 0 and passed through a file)."""
        path = self.pool.path("prefix")
        try:
            self._call("engine_prefix", slot, n_pages, path)
            return torch.load(path, map_location="cpu", weights_only=True)
        finally:
            if os.path.exists(path):
                os.remove(path)

    def adopt_prefix(self, req: Request, n_pages: int, entry: dict) -> int:
        """Ship ``entry`` with the next tick, which admits ``req``: its
        ranks copy their KV heads of it into the slot's pages at
        admission (``_Adopter``).  Returns the tokens skipped."""
        self._adopts[req.rid] = (n_pages, entry)
        return n_pages * self.ecfg.page_size

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


class _Adopter:
    """Stands in for the fleet's ``PrefixCache`` at a tick's admission on
    a rank: the entries the controller looked up for the requests the
    tick admits, by request id (``Engine.adopt_prefix``: this rank's KV
    heads of each)."""

    def __init__(self, entries: Dict[int, tuple]):
        self.entries = entries

    def adopt(self, engine, req: Request) -> int:
        got = self.entries.pop(req.rid, None)
        return 0 if got is None else engine.adopt_prefix(req, *got)


def _served(rk, h, mail) -> _Served:
    """The rank's engine, given the command's submits and, where the
    controller shipped prefix entries, the ``_Adopter`` of its tick."""
    submits, adopt = mail
    s = rk.get(h)
    s.take(submits)
    if adopt is not None:
        s.eng.prefix_cache = _Adopter(
            torch.load(adopt, map_location="cpu", weights_only=True))
    return s


def engine_new(rk, h, mail, shape, axes, cfg, ecfg, strategy, seed,
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
    s.take(mail[0])
    return eng.splits_slots, s.report()


def engine_step(rk, h, mail):
    s = _served(rk, h, mail)
    try:
        out = s.tick()
    finally:
        left, s.eng.prefix_cache = s.eng.prefix_cache, None
    if left is not None and left.entries:
        raise RuntimeError(f"prefix entries shipped for requests "
                           f"{sorted(left.entries)}, which the tick did not "
                           f"admit")
    return out, s.report()


def engine_run(rk, h, mail):
    s = _served(rk, h, mail)
    while s.tick():
        pass
    return None, s.report()


def engine_stats(rk, h, mail):
    s = _served(rk, h, mail)
    return s.eng.stats(), s.report()


def engine_metrics(rk, h, mail):
    s = _served(rk, h, mail)
    return s.eng.metrics, s.report()


def engine_prefix(rk, h, mail, slot, n_pages, path):
    """``Engine.prefix_pages`` of ``slot`` on every rank, each leaf's KV
    heads gathered to rank 0's host (a collective), written to ``path``
    by rank 0."""
    s = _served(rk, h, mail)
    eng = s.eng
    pages = eng.prefix_pages(slot, n_pages)
    if eng._ranks:
        pages = {lk: {n: shd.gather_to_host(t, eng._pool_specs[lk][n],
                                            eng.mesh)
                      for n, t in sub.items()} for lk, sub in pages.items()}
    if rk.rank == 0:
        torch.save(P.tree_map(lambda t: t.to("cpu"), pages), path)
    return None, s.report()


def engine_snapshot(rk, h, mail, path):
    s = _served(rk, h, mail)
    snap = s.eng.snapshot_state()
    if rk.rank == 0:
        torch.save(snap, path)
    return None, s.report()


def engine_adopt(rk, h, mail, path):
    s = _served(rk, h, mail)
    snap = torch.load(path, map_location="cpu", weights_only=False)
    s.eng.adopt_state(snap)
    for req in (list(snap["running"].values()) + list(snap["waiting"])
                + list(snap["prefilling"])):
        s.live[req.rid], s.sent[req.rid] = req, len(req.tokens)
    return None, s.report()
