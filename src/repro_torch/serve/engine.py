"""Continuous-batching serving engine of the port.

The engine owns a fixed-slot paged decode step, a fixed-capacity prompt
prefill and, with ``prefill_chunk > 0``, a mixed tick that fuses one
prompt chunk with the decode of every running slot.  Requests stream
through ``submit(prompt) -> Request``; each :meth:`Engine.step` tick
prefills newly admitted requests (their prompt KV scattered into pages)
or decodes every in-flight slot, and finished requests are evicted so
their pages are immediately reusable.  Token selection is temperature
sampling (Gumbel-max with noise from the engine's ``torch.Generator``),
exact argmax at ``temperature == 0``.

On CUDA each tick's model step runs as a CUDA graph, the port's
counterpart of the JAX engine's ``jit``: the decode tick and the mixed
tick are captured once, and each prefill length once behind the JAX
engine's LRU cache (``prefill_cache_cap``; a ``sub_quadratic`` config
prefills at its exact length, so one entry a prompt length).  A step
runs eagerly the first time (lazy initialisation stays out of capture),
is captured on its next call and replayed from then on (an evicted
prefill length starts again eagerly on its next miss); the host's
inputs are copied into static device buffers before each replay.
Sampling runs eagerly after the step.  ``cuda_graphs=False`` runs every
step eagerly (the comparison on the card); the CPU has no graphs.

On a mesh of gloo ranks (``dist.mesh.make_mesh``) every rank runs the
same host code (scheduler, allocator, sampling) and holds its shard of
the params and of the pool, placed by the reference's serving rule
tables (``dist.steps``): the ``model`` axis splits the heads (and the
pool's KV heads), the FFN, the vocabulary, the experts and a sequence
mixer's channels or heads (and its state rows), and a data
tier that the pool's shards match (``dp_shards`` equal to its size)
splits the slots: a data rank then runs its slots' rows against its own
pages.  The logits are made whole on every rank before sampling, so
every rank samples the same tokens.  A tick there runs eagerly: a CUDA
graph cannot capture a gloo collective.

    eng = Engine(registry.smoke("yi-6b"), EngineConfig(n_slots=4),
                 device="cpu")
    req = eng.submit([1, 2, 3], max_new_tokens=8)
    for tok in eng.stream(req):
        ...
"""
from __future__ import annotations

import functools
import gc
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm import collectives as coll
from repro_torch.configs.base import BASELINE, ModelConfig, ShardingStrategy
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps as dsteps
from repro_torch.dist.actsharding import activation_sharding
from repro_torch.dist.mesh import Mesh, axis_size
from repro_torch.kernels import build
from repro_torch.models import params as P
from repro_torch.models.layers import PagedView
from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Clock, Tracer, WallClock
from repro_torch.serve import paging
from repro_torch.serve.scheduler import Request, Scheduler, StreamError


def check_mesh(mesh) -> bool:
    """Whether ``mesh`` runs the engine over several ranks; raises for a
    mesh the engine cannot serve on.  A mesh of several devices must span
    a process group (``dist.mesh.make_mesh``, one rank a device): one
    built from a shape alone (or over several devices of one process)
    runs no collective."""
    if mesh is None or mesh.size == 1:
        return False
    if not mesh.spans_ranks:
        raise ValueError(
            f"a {dict(mesh.shape)} mesh over no process group: an engine "
            "on several devices serves on a mesh of ranks, built by "
            "dist.mesh.make_mesh after init_process_group")
    return True


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _counter(metric: str, **labels):
    """A registry-backed counter exposed as a plain int attribute (reads
    hit the registry; writes become absolute registry puts)."""

    def _get(self) -> int:
        return int(self.metrics.value(metric, **labels))

    def _set(self, value) -> None:
        self.metrics.put(metric, value, **labels)

    return property(_get, _set)


def sample_tokens(logits, temps, generator: torch.Generator):
    """Per-row temperature sampling: Gumbel-max at ``temps > 0``, exact
    argmax (the first maximal index) at ``temps == 0``.  The noise is
    drawn for every row on every call, so the generator's stream does not
    depend on which rows are greedy."""
    greedy = torch.argmax(logits, dim=-1)
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    gumbel = -torch.log(e.exponential_(generator=generator))
    t = torch.clamp_min(temps, 1e-6)[:, None]
    sampled = torch.argmax(logits.float() / t + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


@dataclass(frozen=True)
class EngineConfig:
    """Fixed shapes of one engine.  Prompts are right-padded to
    ``max_prompt_len`` for the legacy prefill; causal masking makes the
    padding invisible.  Sequence-mixer (Mamba, xLSTM) recurrences are not
    masked by padding, so ``sub_quadratic`` architectures prefill at the
    exact prompt length and take no chunked ticks."""

    n_slots: int = 4              # concurrent requests per step
    page_size: int = 16           # tokens per KV page
    max_seq_len: int = 128        # per-slot capacity (prompt + generated)
    max_prompt_len: int = 64      # prefill step capacity
    n_pages: int = 0              # 0 -> every slot can reach max_seq_len
    pad_id: int = 0               # prompt padding token
    prefill_chunk: int = 0        # >0: chunked prefill inside decode ticks
    dp_shards: int = 1            # page-pool shards over the data tier
    prefill_cache_cap: int = 8    # LRU bound on per-length prefill steps

    def layout(self) -> paging.PagedLayout:
        assert self.max_seq_len % self.page_size == 0
        assert self.max_prompt_len % self.page_size == 0
        assert self.max_prompt_len <= self.max_seq_len
        ns = max(self.dp_shards, 1)
        assert self.n_slots % ns == 0, \
            f"dp_shards={ns} must divide n_slots={self.n_slots}"
        pps = self.max_seq_len // self.page_size
        n_pages = self.n_pages or self.n_slots * pps + ns
        assert n_pages % ns == 0, \
            f"dp_shards={ns} must divide n_pages={n_pages}"
        return paging.PagedLayout(page_size=self.page_size,
                                  pages_per_slot=pps, n_pages=n_pages,
                                  n_shards=ns)


_CAPTURE_STREAMS: dict = {}


def _capture_stream() -> torch.cuda.Stream:
    """The current device's capture stream, one a device for every
    engine on it: torch's default capture stream is one for all devices
    (on the device of its first use), and each new stream would cost
    cuBLAS a workspace that it keeps for the life of the process."""
    index = torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream()
    return _CAPTURE_STREAMS[index]


class _Step:
    """One model step of the engine (a decode tick, a mixed tick, a
    prefill length): ``fn(engine)`` reads the engine's static inputs
    and returns the logits (a function of the engine, not a bound
    method, so that no engine sits in a reference cycle with its steps
    and its memory goes when the engine does).  ``warm`` once it has run
    eagerly; with graphs on, ``graph`` replays it, writing ``out``, and
    ``launches`` are the kernel launches one run makes."""

    __slots__ = ("fn", "warm", "graph", "out", "launches")

    def __init__(self, fn):
        self.fn, self.warm = fn, False
        self.graph = self.out = self.launches = None


class Engine:
    """Driver loop: admission -> prefill -> continuous decode.

    Runs on CUDA unless ``device`` or ``mesh`` says otherwise: a mesh of
    one device (``launch.mesh.make_local_mesh``) sets the engine's
    device.  A mesh of several ranks (``dist.mesh.make_mesh``; every rank
    builds its engine with the same arguments, ``device`` its own) places
    params and pool by ``strategy`` (see the module's docstring); any
    other mesh of several devices raises ``ValueError``
    (``check_mesh``).  ``strategy`` is the JAX engine's: on one device it
    shards nothing, and ``stats()`` names it.  ``params`` (a whole tree
    from ``Model.init`` or ``params.from_numpy``) move to the device, on
    ranks each rank's shard of each leaf; by default they are drawn from
    ``seed`` in ``compute_dtype``, on ranks leaf by leaf, each rank
    keeping its shard of the tree one rank draws.  Timing
    stamps come from ``clock``, counters live in ``metrics`` (the JAX
    engine's metric names), and an optional ``tracer`` records each
    finished request's lifecycle spans.  ``cuda_graphs``: None captures
    the steps as CUDA graphs on CUDA and runs them eagerly on the CPU
    and on a mesh of ranks; False runs them eagerly; True on the CPU or
    on ranks raises.  A capture or replay that fails raises: nothing
    falls back to an eager run.
    """

    n_prefills = _counter("serve_prefills_total")
    n_prefill_tokens = _counter("serve_prefill_tokens_total")
    n_decode_steps = _counter("serve_ticks_total", kind="decode")
    n_mixed_steps = _counter("serve_ticks_total", kind="mixed")
    n_generated = _counter("serve_generated_tokens_total")
    _pc_hits = _counter("serve_prefill_compile_cache_total", event="hit")
    _pc_misses = _counter("serve_prefill_compile_cache_total", event="miss")
    _pc_evictions = _counter("serve_prefill_compile_cache_total",
                             event="eviction")

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig = EngineConfig(),
                 *, strategy: ShardingStrategy = BASELINE, mesh=None,
                 params=None, seed: int = 0, device=None,
                 compute_dtype=torch.bfloat16, clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 cuda_graphs: Optional[bool] = None):
        assert not cfg.encoder_layers, \
            "serving engine: decoder-only architectures"
        assert cfg.pos_type in ("rope", "none"), \
            "per-slot positions need rope (or no) position encoding"
        ranks = check_mesh(mesh)
        if mesh is not None and not ranks:
            if mesh.devices is not None:
                mdev = mesh.devices.flat[0]
                if device is not None and not _same_device(
                        resolve_device(device), mdev):
                    raise ValueError(f"device {device} is not the mesh's "
                                     f"device {mdev}")
                device = mdev
        self.device = resolve_device(device)
        if mesh is None:
            mesh = Mesh((1, 1), ("data", "model"),
                        devices=np.array([[self.device]], dtype=object))
        self.mesh, self.strategy = mesh, strategy
        self._ranks = ranks
        on_cuda = self.device.type == "cuda" and not ranks
        if cuda_graphs and ranks:
            raise ValueError("cuda_graphs=True on a mesh of ranks: a CUDA "
                             "graph cannot capture the gloo collectives of "
                             "its ticks")
        if cuda_graphs and not on_cuda:
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got "
                             f"{self.device}")
        self.cuda_graphs = on_cuda if cuda_graphs is None else cuda_graphs
        self.cfg = cfg
        self.ecfg = ecfg
        self.compute_dtype = compute_dtype
        self.clock = clock if clock is not None else WallClock()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        self.layout = ecfg.layout()
        self.alloc = paging.PageAllocator(ecfg.n_slots, self.layout)
        # chunked prefill needs causal masking: a sequence mixer's
        # recurrence cannot skip a chunk's padded rows, so those archs
        # keep the legacy prefill-then-decode ticks (as the JAX engine)
        self._chunked = ecfg.prefill_chunk > 0 and not cfg.sub_quadratic
        self.scheduler = Scheduler(
            self.alloc, ecfg.max_prompt_len,
            prefill_chunk=ecfg.prefill_chunk if self._chunked else 0,
            clock=self.clock)
        self.model = Model(cfg)
        self._place(ecfg.n_slots)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if ranks:
                rules = shd.param_rules(strategy)
                params = P.init_params(
                    self.model.param_defs(), gen, compute_dtype, self.device,
                    local=lambda d, t: shd.shard(t, shd.resolve_spec(
                        d.shape, d.axes, rules, mesh), mesh))
            else:
                params = self.model.init(gen, dtype=compute_dtype,
                                         device=self.device)
        elif ranks:
            specs = dsteps.serving_param_shardings(cfg, strategy, mesh)
            params = P.tree_unflatten(params, [
                shd.shard(t, sp, mesh) for t, sp in zip(
                    P.tree_leaves(params), P.tree_leaves(specs))])
        self.params = P.tree_map(lambda t: t.to(self.device), params)
        self.pool = paging.init_pool(cfg, ecfg.n_slots, self.layout,
                                     self.device, mesh=mesh if ranks else
                                     None, strategy=strategy)
        self._next_token = np.zeros((ecfg.n_slots,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.prefix_cache = None      # set by a fleet Router (fleet.py)
        self._holds_prompt = self._runs_prompt = True
        self.n_prefills = 0
        self.n_prefill_tokens = 0
        self.n_decode_steps = 0
        self.n_mixed_steps = 0
        self.n_generated = 0
        self._pc_hits = 0
        self._pc_misses = 0
        self._pc_evictions = 0
        self._static_inputs()
        self._decode = _Step(Engine._decode_fn)
        self._mixed = _Step(Engine._mixed_fn)
        self._prefill_cache: OrderedDict = OrderedDict()
        # every graph shares one memory pool: they never replay at once,
        # and each replay's logits are read before the next one
        self._graph_pool = None
        if self.cuda_graphs:
            with torch.cuda.device(self.device):
                self._graph_pool = torch.cuda.graph_pool_handle()
        self._bound = None            # (params, pool) the graphs read
        self.n_captures = 0
        self.capture_ms = 0.0

    def _place(self, n_slots: int) -> None:
        """Where this rank's work lies on the mesh: ``slot_rows``, the
        slots whose rows it runs (a data shard's where the data tier
        splits the slots, else all), the first page id of its pool
        shard, the specs of its pool leaves and of the logits it makes,
        and whether a prompt's prefill or chunk runs on the data ranks
        that do not own its slot too (``_shadow``: where a data axis
        splits a parameter, whose per-layer gathers every data rank
        must join)."""
        self.slot_rows, self._page_base = (0, n_slots), 0
        self._slot_entry, self._shadow = None, False
        self._pool_specs = self._logit_spec = None
        if not self._ranks:
            return
        mesh, st = self.mesh, self.strategy
        bt_spec, _ = dsteps.paged_table_shardings(mesh, self.layout,
                                                  n_slots)
        vocab = dsteps.logits_sharding(self.cfg, n_slots, st, mesh)[1]
        self._pool_specs = paging.pool_specs(self.cfg, n_slots, self.layout,
                                             mesh, st)
        if bt_spec:
            entry = bt_spec[0]
            shard = shd.shard_index(entry, mesh)
            per = n_slots // axis_size(mesh, shd.entry_axes(entry))
            self.slot_rows = (shard * per, (shard + 1) * per)
            self._page_base = self.alloc.null_page_of(shard * per)
            self._slot_entry = entry
            live = {a for a in shd.entry_axes(entry) if mesh.shape[a] > 1}
            self._shadow = any(
                a in live for spec in P.tree_leaves(
                    dsteps.serving_param_shardings(self.cfg, st, mesh))
                for e in spec for a in shd.entry_axes(e))
        self._logit_spec = (self._slot_entry, vocab)

    def _holds(self, slot: int) -> bool:
        return self.slot_rows[0] <= slot < self.slot_rows[1]

    @property
    def splits_slots(self) -> bool:
        """Whether the data tier splits the slots (and the pool's pages)
        over this engine's ranks."""
        return self._slot_entry is not None

    def _static_inputs(self) -> None:
        """Every input of a step, in buffers allocated once (outside any
        graph's pool), and their host staging (pinned on CUDA; on the
        CPU the buffers themselves)."""
        ecfg, pps = self.ecfg, self.layout.pages_per_slot
        ns, i32, i64 = ecfg.n_slots, torch.int32, torch.int64
        rows = self.slot_rows[1] - self.slot_rows[0]
        shapes = {
            "tokens": ((rows, 1), i64), "block_table": ((rows, pps), i32),
            "lengths": ((rows,), i32), "temps": ((ns,), torch.float32),
            "c_tokens": ((1, max(ecfg.prefill_chunk, 1)), i64),
            "c_pages": ((1, pps), i32), "c_start": ((1,), i32),
            "c_n": ((1,), i32), "c_null": ((1,), i32),
            "p_tokens": ((1, ecfg.max_prompt_len), i64),
            "p_last": ((1,), i64), "p_rows": ((1, pps), i32),
            "p_slot": ((1,), i64)}
        self._in = {k: torch.zeros(shape, dtype=dt, device=self.device)
                    for k, (shape, dt) in shapes.items()}
        pin = self.device.type == "cuda"
        self._host = {k: (torch.zeros(shape, dtype=dt, pin_memory=True)
                          if pin else self._in[k])
                      for k, (shape, dt) in shapes.items()}

    def _put(self, name: str, a) -> torch.Tensor:
        """Copy host array ``a`` into the leading block of static input
        ``name`` (through its staging buffer); returns that block."""
        a = torch.from_numpy(np.ascontiguousarray(a))
        block = tuple(slice(0, n) for n in a.shape)
        host, dev = self._host[name][block], self._in[name][block]
        host.copy_(a)
        if dev.data_ptr() != host.data_ptr():
            dev.copy_(host, non_blocking=True)
        return dev

    # -- park / adopt ---------------------------------------------------------
    def snapshot_state(self) -> dict:
        """Freeze the engine's whole decode state on the host: the page
        pools (host copies), the allocator's block table, lengths,
        reservations and free lists, the scheduler's queues, each slot's
        next token, the sampling generator's state (under ``"key"``, the
        JAX engine's name for its sampling key) and the compute counters.
        An engine of the same shapes, with the same or other params,
        :meth:`adopt_state`s it and goes on from the parked tokens.

        On a mesh of ranks the pools are gathered whole to rank 0's host
        (``dist.sharding.gather_to_host``, a collective: every rank
        calls it), so rank 0's snapshot is the one a one-rank engine
        would take, and any engine of the same shapes, on one rank or on
        a mesh, adopts it; the other ranks' snapshots hold None for
        each pool leaf."""
        al, sch = self.alloc, self.scheduler
        if self._ranks:
            pool = P.tree_unflatten(self.pool, [
                shd.gather_to_host(t, sp, self.mesh) for t, sp in zip(
                    P.tree_leaves(self.pool), P.tree_leaves(self._pool_specs))])
        else:
            pool = P.tree_map(lambda t: t.to("cpu", copy=True), self.pool)
        return {
            "pool": pool,
            "block_table": al.block_table.copy(),
            "lengths": al.lengths.copy(),
            "reserved": al._reserved.copy(),
            "free_pages": list(al.free_pages),
            "free_slots": list(al.free_slots),
            "waiting": list(sch.waiting),
            "prefilling": list(sch.prefilling),
            "running": dict(sch.running),
            "n_finished": sch.n_finished,
            "next_token": self._next_token.copy(),
            "key": self._gen.get_state(),
            "counters": (self.n_prefills, self.n_decode_steps,
                         self.n_generated),
        }

    def adopt_state(self, snap: dict) -> None:
        """Take over a :meth:`snapshot_state` snapshot: the pools copy
        onto this engine's device and the host bookkeeping copies over.
        Parking freezes the tick stream instead of replaying it (the
        generator's state rides the snapshot), so the tokens that follow
        are those of an uninterrupted run at any temperature.  On a mesh
        of ranks each rank takes its shard of each whole pool leaf (every
        rank adopts the same snapshot: rank 0's, where it was taken on
        ranks)."""
        for key, kv in snap["pool"].items():
            for n, t in kv.items():
                if self._ranks:
                    t = shd.shard(t, self._pool_specs[key][n], self.mesh)
                self.pool[key][n].copy_(t)
        al, sch = self.alloc, self.scheduler
        al.block_table[:] = snap["block_table"]
        al.lengths[:] = snap["lengths"]
        al._reserved[:] = snap["reserved"]
        al.free_pages = list(snap["free_pages"])
        al.free_slots = list(snap["free_slots"])
        sch.waiting = deque(snap["waiting"])
        sch.prefilling = deque(snap["prefilling"])
        sch.running = dict(snap["running"])
        sch.n_finished = snap["n_finished"]
        self._next_token[:] = snap["next_token"]
        self._gen.set_state(snap["key"])
        self.n_prefills, self.n_decode_steps, self.n_generated = \
            snap["counters"]

    # -- the fleet's prefix cache (fleet.PrefixCache) ----------------------
    def prefix_pages(self, slot: int, n_pages: int) -> dict:
        """The KV of the first ``n_pages`` pages of ``slot``: one tensor
        per attention leaf, ``(reps, n_pages, page, kv, hd)``, gathered
        out of the pools (this rank's KV heads on a mesh of ranks)."""
        pages = torch.from_numpy(np.asarray(
            self.alloc.block_table[slot, :n_pages], np.int64))
        return {f"p{i}": {n: a.index_select(1, pages.to(a.device))
                          for n, a in self.pool[f"p{i}"].items()}
                for i in range(len(self.cfg.block_pattern))}

    def adopt_prefix(self, req: Request, n_pages: int, entry: dict) -> int:
        """Copy ``entry`` (a :meth:`prefix_pages` of ``n_pages`` pages,
        with every KV head) into the first pages of ``req``'s slot and
        mark those prompt tokens prefilled; on a mesh of ranks this
        rank's KV heads of it.  Returns the tokens skipped."""
        pages = torch.from_numpy(np.asarray(
            self.alloc.block_table[req.slot, :n_pages], np.int64))
        for lk, sub in entry.items():
            for n, src in sub.items():
                dst = self.pool[lk][n]
                if self._ranks:
                    src = shd.shard(src, self._pool_specs[lk][n], self.mesh)
                dst.index_copy_(1, pages.to(dst.device), src.to(dst.device))
        req.prefill_progress = n_pages * self.ecfg.page_size
        return req.prefill_progress

    # -- request API --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               tenant: str = "default",
               ttft_slo_s: Optional[float] = None) -> Request:
        return self.scheduler.submit(Request(
            prompt=list(prompt), max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id, tenant=tenant,
            ttft_slo_s=ttft_slo_s, t_created=self.clock.now()))

    def _owns(self, req: Request) -> bool:
        sch = self.scheduler
        return (any(r is req for r in sch.waiting)
                or any(r is req for r in sch.prefilling)
                or any(r is req for r in sch.running.values()))

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are generated, pumping the
        engine (other in-flight requests advance too).  Raises
        :class:`StreamError` if the engine runs out of work while ``req``
        is unfinished."""
        emitted = 0
        while True:
            while emitted < len(req.tokens):
                yield req.tokens[emitted]
                emitted += 1
            if req.finished:
                return
            if not self.step():
                code = ("starved_request" if self._owns(req)
                        else "foreign_request")
                raise StreamError([{
                    "field": "request", "code": code,
                    "message": (
                        f"engine out of work with request rid={req.rid} "
                        f"unfinished (state={req.state}, "
                        f"{len(req.tokens)}/{req.max_new_tokens} tokens "
                        "emitted)"
                        + ("" if code == "starved_request" else
                           " — it was never submitted to this engine")),
                }])

    def run(self) -> None:
        """Drive until every submitted request has finished."""
        while self.step():
            pass

    # -- engine ticks -------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit + prefill new arrivals, else decode in-flight
        slots.  Returns False when there is no work.  A chunked engine
        runs a mixed tick while any slot is mid-prefill."""
        admitted = self.scheduler.admit()
        if admitted and self.prefix_cache is not None and self._chunked:
            # fleet prefix cache: copy cached pages for the longest
            # page-aligned common prompt prefix into the slot's own
            # pages (copy-on-adopt) and skip those prompt tokens
            for req in admitted:
                self.prefix_cache.adopt(self, req)
        if self._chunked:
            nxt = self.scheduler.next_chunk()
            if nxt is not None:
                self._run_mixed(*nxt)
                return True
            if self.scheduler.running:
                self._run_decode()
                return True
            return False
        if admitted:
            for req in admitted:
                self._run_prefill(req)
            return True
        if self.scheduler.running:
            self._run_decode()
            return True
        return False

    def _tick_obs(self, kind: str, n_tokens: int) -> None:
        m = self.metrics
        if kind == "prefill":
            m.inc("serve_ticks_total", kind="prefill")
        m.observe("serve_tokens_per_tick", n_tokens, kind=kind)
        for shard, used in enumerate(self.alloc.pages_in_use_by_shard()):
            m.set("serve_pages_in_use", used, shard=shard)
            m.set("serve_pages_free", len(self.alloc._free[shard]),
                  shard=shard)

    def _emit(self, req: Request, tok: int) -> None:
        req.tokens.append(tok)
        self.n_generated += 1
        if req.t_first is None:
            req.t_first = self.clock.now()
        if (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self.scheduler.finish(req)
            if req.ttft is not None:
                self.metrics.observe("serve_ttft_s", req.ttft)
                self.metrics.observe("serve_ttft_e2e_s", req.ttft_e2e)
            if self.tracer is not None:
                self.tracer.record_request(req)
        else:
            self._next_token[req.slot] = tok

    def _sample(self, logits, temps: np.ndarray) -> np.ndarray:
        return sample_tokens(logits, self._put("temps", temps),
                             self._gen).cpu().numpy()

    # -- the steps: run eagerly, or captured once and replayed ---------------
    def _run(self, step: _Step):
        """``step``'s logits: eagerly without graphs and on its first
        call, else from its graph (captured on this call if it has none
        yet), whose launches are counted as an eager run's."""
        if self._ranks:
            with activation_sharding(self.mesh, self.strategy):
                return step.fn(self)
        if not (self.cuda_graphs and step.warm):
            step.warm = True
            return step.fn(self)
        if self._bound is not None and (self._bound[0] is not self.params
                                        or self._bound[1] is not self.pool):
            self._drop_graphs()       # a graph reads the tensors it saw
        # capture and replay on the engine's device: the kernels launch
        # on its current stream, which capture must be recording
        with torch.cuda.device(self.device):
            if step.graph is None:
                self._capture(step)
            step.graph.replay()
        build.add_launches(step.launches)
        return step.out

    def _capture(self, step: _Step) -> None:
        """Record ``step`` into a graph.  Capture executes nothing, so a
        step that updates sequence-mixer state in place still runs once:
        at the replay that follows.  The garbage collector waits
        meanwhile: a collection that freed another engine's graph would
        make a call that capture refuses, and fail this one."""
        t = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with build.counting() as launches, \
                    torch.cuda.graph(graph, pool=self._graph_pool,
                                     stream=_capture_stream()):
                out = step.fn(self)
        finally:
            if collecting:
                gc.enable()
        step.graph, step.out, step.launches = graph, out, launches
        self._bound = (self.params, self.pool)
        self.n_captures += 1
        self.capture_ms += (time.perf_counter() - t) * 1e3

    def _drop_graphs(self) -> None:
        for step in (self._decode, self._mixed,
                     *self._prefill_cache.values()):
            step.graph = step.out = step.launches = None
        self._bound = None

    def _decode_fn(self):
        s = self._in
        logits, _ = self.model.decode_step(
            self.params, self.pool, s["tokens"], s["lengths"],
            compute_dtype=self.compute_dtype,
            paging=PagedView(s["block_table"], s["lengths"]))
        return logits

    def _mixed_fn(self):
        s = self._in
        logits = self._decode_fn()
        if not self._runs_prompt:
            return logits, None
        c_logits, _ = self.model.prefill_chunk(
            self.params, self.pool, s["c_tokens"],
            PagedView(s["c_pages"], s["c_start"], n_valid=s["c_n"],
                      null_page=s["c_null"]),
            compute_dtype=self.compute_dtype)
        return logits, c_logits

    def _prefill_fn(self, step_len: int):
        """The prefill of ``step_len`` tokens: the prompt's KV padded to a
        page boundary and scattered into the slot's pages, its state
        into the slot's rows."""
        cfg, s, ps = self.cfg, self._in, self.ecfg.page_size
        cap = paging.round_up(step_len, ps)
        logits, pcache = self.model.prefill(
            self.params, {"tokens": s["p_tokens"][:, :step_len]},
            compute_dtype=self.compute_dtype, last_index=s["p_last"])
        if not self._holds_prompt:
            return logits             # a shadow run (``_place``)
        if cap != step_len:
            pcache = paging.pad_prefill_cache(cfg, pcache, cap)
        paging.scatter_prefill(cfg, self.pool, pcache,
                               s["p_rows"][:, :cap // ps], s["p_slot"])
        return logits

    def _prefill_for(self, prompt_len: int):
        """(step length, the prefill step) for this prompt: one entry at
        ``max_prompt_len`` for attention-only archs, one a prompt length
        for ``sub_quadratic`` ones (padding would run through the
        recurrent state), in an LRU cache of ``prefill_cache_cap``
        entries, as the JAX engine caches its compiles."""
        plen = (prompt_len if self.cfg.sub_quadratic
                else self.ecfg.max_prompt_len)
        step = self._prefill_cache.get(plen)
        if step is not None:
            self._pc_hits += 1
            self._prefill_cache.move_to_end(plen)
            return plen, step
        self._pc_misses += 1
        step = _Step(functools.partial(Engine._prefill_fn, step_len=plen))
        self._prefill_cache[plen] = step
        # an evicted entry drops its graph and the memory it holds
        while len(self._prefill_cache) > max(self.ecfg.prefill_cache_cap, 1):
            self._prefill_cache.popitem(last=False)
            self._pc_evictions += 1
        return plen, step

    def _run_prefill(self, req: Request) -> None:
        """The prompt right-padded to the step's length (``max_prompt_len``,
        a page multiple, or a ``sub_quadratic`` config's exact length),
        through :meth:`_prefill_for`'s step."""
        ecfg, slot, plen = self.ecfg, req.slot, len(req.prompt)
        step_len, step = self._prefill_for(plen)
        tokens = np.full((1, step_len), ecfg.pad_id, np.int64)
        tokens[0, :plen] = req.prompt
        n_pages = paging.round_up(step_len, ecfg.page_size) // ecfg.page_size
        self._prompt_on(slot)
        logits = None
        if self._runs_prompt:
            self._put("p_tokens", tokens)
            self._put("p_last", np.array([plen - 1]))
            self._put("p_rows", self._local_pages(
                self.alloc.block_table[slot:slot + 1, :n_pages], slot))
            self._put("p_slot", np.array([slot - self.slot_rows[0]]))
            logits = self._run(step)
        logits = self._handoff(logits, slot)
        tok = self._sample(logits, np.array([req.temperature], np.float32))
        self.n_prefills += 1
        self.n_prefill_tokens += plen
        req.t_prefill_done = self.clock.now()
        self._emit(req, int(tok[0]))
        self._tick_obs("prefill", 1)

    def _decode_inputs(self, block_table, lengths) -> None:
        """The decode's inputs: this rank's slot rows, their pages as ids
        into its pool shard."""
        lo, hi = self.slot_rows
        self._put("tokens", self._next_token[lo:hi, None])
        self._put("block_table", block_table[lo:hi] - self._page_base)
        self._put("lengths", lengths[lo:hi])

    # -- a mesh of ranks: which ranks run a prompt, whole logits ------------
    def _prompt_on(self, slot: int) -> None:
        """Whether this rank holds ``slot`` (``_holds_prompt``) and runs its
        prompt's prefill or chunk (``_runs_prompt``: where it holds it,
        or as a shadow run, ``_place``, whose KV sinks into its null page
        and whose state it does not keep)."""
        self._holds_prompt = self._holds(slot)
        self._runs_prompt = self._holds_prompt or self._shadow

    def _local_pages(self, rows, slot: int):
        """Page ids ``rows`` of ``slot`` as ids into this rank's pool
        shard; a shadow run's all name its null page."""
        if not self._holds_prompt:
            return np.zeros_like(rows)
        return rows - self._page_base

    def _whole(self, logits):
        """This rank's logits of its slot rows made whole: gathered over
        the data tier where it splits the slots, over ``model`` where it
        splits the vocabulary."""
        if not self._ranks:
            return logits
        return shd.gather(logits, self._logit_spec, self.mesh)

    def _handoff(self, row, slot: int):
        """A prompt's logits row ``(1, V)`` (this rank's vocabulary
        columns; None where this rank did not run it) whole on every
        rank: gathered over ``model`` where it ran, then handed from the
        data shard that holds ``slot`` to the others, an axis at a time
        from the innermost (a rank of the other shards passes a buffer
        of the same shape)."""
        if not self._ranks:
            return row
        if row is not None:
            row = shd.gather(row, (None, self._logit_spec[1]), self.mesh)
        if self._slot_entry is None:
            return row
        if row is None:
            row = torch.empty((1, self.cfg.vocab_size),
                              dtype=self.compute_dtype, device=self.device)
        axes = shd.entry_axes(self._slot_entry)
        shard = self.alloc.shard_of(slot)
        coords = np.unravel_index(shard, [self.mesh.shape[a] for a in axes])
        for a, c in reversed(list(zip(axes, coords))):
            row = coll.broadcast_along(row.to(self.compute_dtype), self.mesh,
                                       a, int(c))
        return row

    def _run_mixed(self, req: Request, start: int, n: int) -> None:
        """One fused tick: decode every fully prefilled slot + consume
        ``n`` prompt tokens (positions ``start..start+n``) of ``req``."""
        ecfg, slot = self.ecfg, req.slot
        final = start + n >= len(req.prompt)
        c_tokens = np.full((1, ecfg.prefill_chunk), ecfg.pad_id, np.int64)
        c_tokens[0, :n] = req.prompt[start:start + n]
        c_pages = self.alloc.block_table[slot:slot + 1]
        active = self.scheduler.decodable()         # slot -> request
        for s in active:
            self.alloc.ensure_page(s)
        bt = self.alloc.block_table.copy()
        lens = self.alloc.lengths.copy()
        # mid-prefill slots must not decode: the view parks them on
        # their null page at length 0 (the empty-slot convention)
        for r_ in self.scheduler.prefilling:
            bt[r_.slot, :] = self.alloc.null_page_of(r_.slot)
            lens[r_.slot] = 0
        temps = np.zeros((ecfg.n_slots,), np.float32)
        for s, r_ in active.items():
            temps[s] = r_.temperature
        self._decode_inputs(bt, lens)
        self._prompt_on(slot)
        if self._runs_prompt:
            self._put("c_tokens", c_tokens)
            self._put("c_pages", self._local_pages(c_pages, slot))
            self._put("c_start", np.array([start]))
            self._put("c_n", np.array([n]))
            self._put("c_null", self._local_pages(
                np.array([self.alloc.null_page_of(slot)]), slot))
        logits, c_logits = self._run(self._mixed)
        logits = self._whole(logits)
        if final:
            # a final chunk samples from its last real prompt row
            row = (None if c_logits is None
                   else c_logits[0, max(n - 1, 0)][None])
            logits[slot] = self._handoff(row, slot)[0]
            temps[slot] = req.temperature
        tok = self._sample(logits, temps)
        self.n_mixed_steps += 1
        if n > 0:
            self.n_prefills += 1          # this tick did prompt work
            self.n_prefill_tokens += n
        for s, r_ in active.items():
            self.alloc.advance(s)
            self._emit(r_, int(tok[s]))
        done = self.scheduler.chunk_done(req, n)
        if done:
            req.t_prefill_done = self.clock.now()
            self._emit(req, int(tok[slot]))
        self._tick_obs("mixed", len(active) + (1 if done else 0))

    def _run_decode(self) -> None:
        active = dict(self.scheduler.running)       # slot -> request
        for slot in active:
            self.alloc.ensure_page(slot)
        temps = np.zeros((self.ecfg.n_slots,), np.float32)
        for slot, req in active.items():
            temps[slot] = req.temperature
        self._decode_inputs(self.alloc.block_table, self.alloc.lengths)
        tok = self._sample(self._whole(self._run(self._decode)), temps)
        self.n_decode_steps += 1
        for slot, req in active.items():
            self.alloc.advance(slot)
            self._emit(req, int(tok[slot]))
        self._tick_obs("decode", len(active))

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "n_prefills": self.n_prefills,
            "n_prefill_tokens": self.n_prefill_tokens,
            "n_decode_steps": self.n_decode_steps,
            "n_mixed_steps": self.n_mixed_steps,
            "n_generated": self.n_generated,
            "pages_in_use": self.alloc.pages_in_use(),
            "free_pages": len(self.alloc.free_pages),
            "mesh_shape": dict(self.mesh.shape),
            "dp_shards": self.layout.n_shards,
            "device": str(self.device),
            "strategy": self.strategy.name,
            "prefill_cache": {
                "size": len(self._prefill_cache),
                "cap": self.ecfg.prefill_cache_cap,
                "hits": self._pc_hits,
                "misses": self._pc_misses,
                "evictions": self._pc_evictions,
            },
        }
