"""Fleet tier: a front-end Router over N replicated serving Engines.

The Flux Operator's shape — one control surface reconciling many
on-demand allocations — applied to serving: the router is the single
queue; engines never hold a backlog.  A request is dispatched only to
an engine that can admit it *now*, picked least-loaded by estimated
queue wait, in SLO-slack order (tightest ``ttft_slo_s`` first), under
per-tenant fair admission: no tenant may hold more than its share of
the fleet's slots while another tenant queues.

A shared :class:`PrefixCache` keyed on the longest page-aligned common
prompt prefix lets replicas skip re-prefilling common system prompts.
Prefix pages are copy-on-adopt — an adopting slot copies the cached KV
into its OWN already-reserved pages, so no cross-slot aliasing or
refcounting exists and eviction stays trivial.  Cached KV is a
deterministic function of the prefix tokens at absolute positions
``0..L-1`` (same in every prompt that shares the prefix), so greedy
output is token-for-token identical to the uncached path — extending
the paged-vs-contiguous invariant ``tests/test_serve.py`` pins.

The port of the JAX package's ``serve/fleet.py``.  There the cache moves
pages between the host and the device; here its entries stay on the
engines' device: ``register`` gathers a prompt's prefix pages out of the
pools (``index_select`` over its block-table row) and ``adopt`` copies
them into the adopting slot's own pages (``index_copy_``).  The replicas
of a fleet share one device, so an entry taken from one engine's pool is
copied into another's without leaving it.
"""
from __future__ import annotations

import math
from collections import OrderedDict, deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Clock, Tracer
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request, StreamError, SubmitError


class PrefixCache:
    """Page-aligned prompt-prefix KV shared across a fleet's replicas.

    Entries are keyed by the exact token tuple of a page-aligned prompt
    prefix and hold device copies of the prefix's KV pages (one tensor
    per attention leaf, shaped ``(reps, n_prefix_pages, page, ...)``).  A
    registering request stores EVERY page-aligned prefix of its prompt
    (so two prompts sharing only the system page still hit); an
    adopting request copies the longest cached prefix into its own
    pages and starts its chunked prefill past it.

    The cap is an LRU bound — correctness never depends on an entry
    being present (a miss just re-prefills).
    """

    def __init__(self, page_size: int, max_entries: int = 32):
        self.page_size = page_size
        self.max_entries = max_entries
        self._store: "OrderedDict[Tuple[int, ...], dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _max_pages(self, prompt_len: int) -> int:
        """Longest adoptable prefix: at least one prompt token must stay
        un-adopted so the final chunk can produce the first-token
        logits."""
        return (prompt_len - 1) // self.page_size

    # -- write side ---------------------------------------------------------
    def register(self, engine: Engine, req: Request) -> None:
        """Store every page-aligned prefix of ``req``'s prompt from the
        pages its slot owns on ``engine`` (call after prefill completes,
        while the request is still running — its prompt pages are
        immutable until eviction)."""
        kmax = self._max_pages(len(req.prompt))
        if kmax <= 0:
            return
        ps = self.page_size
        missing = [k for k in range(1, kmax + 1)
                   if tuple(req.prompt[:k * ps]) not in self._store]
        if not missing:
            return
        pages = torch.from_numpy(np.asarray(
            engine.alloc.block_table[req.slot, :kmax], np.int64))
        # one gather of the full prefix; per-k entries are views
        leaves = {}
        for i, kind in enumerate(engine.cfg.block_pattern):
            key = f"p{i}"
            leaves[key] = {
                n: a.index_select(1, pages.to(a.device))
                for n, a in engine.pool[key].items()}
        for k in missing:
            self._store[tuple(req.prompt[:k * ps])] = {
                lk: {n: a[:, :k] for n, a in sub.items()}
                for lk, sub in leaves.items()}
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)
            self.evictions += 1

    # -- read side ----------------------------------------------------------
    def lookup(self, prompt: Sequence[int]):
        """Longest cached page-aligned prefix as ``(n_pages, entry)``;
        ``(0, None)`` on a miss."""
        ps = self.page_size
        for k in range(self._max_pages(len(prompt)), 0, -1):
            entry = self._store.get(tuple(prompt[:k * ps]))
            if entry is not None:
                self._store.move_to_end(tuple(prompt[:k * ps]))
                return k, entry
        return 0, None

    def adopt(self, engine: Engine, req: Request) -> int:
        """Copy the longest cached prefix into ``req``'s own pages on
        ``engine`` and mark those prompt tokens prefilled.  Returns the
        number of prompt tokens skipped (0 on a miss)."""
        if req.prefill_progress:
            return 0
        k, entry = self.lookup(req.prompt)
        if k == 0:
            self.misses += 1
            return 0
        pages = torch.from_numpy(np.asarray(
            engine.alloc.block_table[req.slot, :k], np.int64))
        for lk, sub in entry.items():
            for n, src in sub.items():
                dst = engine.pool[lk][n]
                dst.index_copy_(1, pages.to(dst.device), src)
        req.prefill_progress = k * self.page_size
        self.hits += 1
        return req.prefill_progress

    def stats(self) -> dict:
        return {"size": len(self._store), "cap": self.max_entries,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


def _cacheable(engines: List[Engine]) -> bool:
    """The prefix cache needs chunked, attention-only, shape-identical
    replicas: adoption resumes a chunked prefill mid-prompt, and only
    attention KV is positionwise (seq-mixer state is a recurrence over
    the whole prefix, not a per-page value).  Nor may a data tier split
    an engine's slots over ranks: a page would then lie on one data
    shard, and a slot of another could not adopt it."""
    e0 = engines[0]
    return all(
        e._chunked and not e.splits_slots
        and all(kind == "attn" for kind in e.cfg.block_pattern)
        and e.ecfg.page_size == e0.ecfg.page_size
        and e.cfg.name == e0.cfg.name
        for e in engines)


class Router:
    """SLO-aware front end over N engine replicas.

    Dispatch rule: pending requests are considered in SLO-slack order
    (tightest ``ttft_slo_s`` deadline first, stable within ties); each
    goes to the admissible engine with the least estimated queue wait
    (fewest in-flight requests, then least remaining token work).  An
    engine is admissible only when it can admit the request NOW — the
    router is the single queue, so least-loaded stays meaningful.

    Fairness invariant: with ``share = total_slots / active_tenants``,
    a tenant already holding ``>= share`` in-flight requests is skipped
    while any other tenant has a request queued.
    """

    def __init__(self, engines: List[Engine], *,
                 prefix_cache: Optional[bool] = None,
                 demand_alpha: float = 0.2,
                 clock: Optional[Clock] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        assert engines, "a fleet needs at least one engine"
        self.engines = list(engines)
        # ONE time source for the whole fleet: SLO slack compares the
        # router's now() against engine-stamped t_created, so the router
        # defaults to the engines' clock (under a tick/sim clock, raw
        # wall time here would make slack ordering nondeterministic)
        self.clock = clock if clock is not None else engines[0].clock
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if tracer is not None:
            for eng in self.engines:
                eng.tracer = tracer
        want_cache = prefix_cache is not False
        self.prefix_cache: Optional[PrefixCache] = None
        if want_cache and _cacheable(self.engines):
            self.prefix_cache = PrefixCache(engines[0].ecfg.page_size)
        elif prefix_cache is True:
            raise ValueError(
                "prefix cache needs chunked (prefill_chunk > 0), "
                "attention-only, shape-identical replicas")
        for eng in self.engines:      # detach any previous router's cache
            eng.prefix_cache = self.prefix_cache
        self.pending: Deque[Request] = deque()
        self._dispatched: Dict[int, Request] = {}    # rid -> in-flight
        self._submitted: set = set()                 # every rid ever seen
        self._registered: set = set()                # rids prefix-registered
        self.assignments: Dict[int, int] = {}        # rid -> engine index
        self.n_dispatched = 0
        self._demand = 0.0
        self._demand_alpha = demand_alpha

    # -- request API --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               tenant: str = "default",
               ttft_slo_s: Optional[float] = None) -> Request:
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_id=eos_id,
                      tenant=tenant, ttft_slo_s=ttft_slo_s,
                      t_created=self.clock.now())
        return self.enqueue(req)

    def enqueue(self, req: Request) -> Request:
        """Queue an externally constructed :class:`Request` (the
        executor tier builds requests before a router exists — e.g.
        arrivals queued while an elastic fleet is still placing).
        Validates against engine shapes at router-submit time, so an
        unservable request fails HERE, not after queueing."""
        errors = self.engines[0].scheduler.check(req)
        if errors:
            raise SubmitError(errors)
        self.pending.append(req)
        self._submitted.add(req.rid)
        self.metrics.inc("router_submits_total", tenant=req.tenant)
        if self.tracer is not None:
            self.tracer.event("router_submit", f"req-{req.rid}",
                              t=req.t_created, rid=req.rid,
                              tenant=req.tenant)
        return req

    # -- replica set mutation ------------------------------------------------
    def add_engine(self, eng: Engine) -> int:
        """Grow the replica set in place (elastic fleet scale-up): the
        new engine joins dispatch on the next pass.  The shared prefix
        cache stays attached only if the grown set still satisfies the
        cacheability contract (chunked, attention-only, shape-identical
        replicas); otherwise it detaches fleet-wide — correctness never
        depends on a cache entry, so detaching is always safe."""
        self.engines.append(eng)
        if self.tracer is not None:
            eng.tracer = self.tracer
        if self.prefix_cache is not None and not _cacheable(self.engines):
            self.prefix_cache = None
        eng.prefix_cache = self.prefix_cache
        self.metrics.set("router_replicas", len(self.engines))
        return len(self.engines) - 1

    def swap_engine(self, index: int, eng: Engine) -> Engine:
        """Replace replica ``index`` in place (the canary-promotion
        path: the new engine has ADOPTED the old one's snapshot, so
        in-flight requests continue where they parked).  Returns the
        replaced engine."""
        old = self.engines[index]
        self.engines[index] = eng
        if self.tracer is not None:
            eng.tracer = self.tracer
        eng.prefix_cache = self.prefix_cache
        return old

    # -- dispatch -----------------------------------------------------------
    def _in_flight(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for req in self._dispatched.values():
            if not req.finished:
                counts[req.tenant] = counts.get(req.tenant, 0) + 1
        return counts

    def _remaining_work(self, eng: Engine) -> int:
        sch = eng.scheduler
        reqs = list(sch.waiting) + list(sch.running.values())
        return sum((len(r.prompt) - r.prefill_progress)
                   + (r.max_new_tokens - len(r.tokens)) for r in reqs)

    def _pick_engine(self, req: Request) -> Optional[Engine]:
        best, best_key = None, None
        for i, eng in enumerate(self.engines):
            sch = eng.scheduler
            # dispatch only what the engine can take this tick: queued
            # submissions it has not admitted yet consume future slots
            if len(sch.waiting) >= len(eng.alloc.free_slots):
                continue
            if not eng.alloc.can_admit(len(req.prompt),
                                       req.max_new_tokens):
                continue
            key = (len(sch.waiting) + len(sch.running),
                   self._remaining_work(eng), i)
            if best_key is None or key < best_key:
                best, best_key = eng, key
        return best

    def _dispatch_pass(self) -> int:
        if not self.pending:
            return 0
        now = self.clock.now()       # the fleet clock, NOT raw wall time

        def slack(req: Request) -> float:
            if req.ttft_slo_s is None:
                return math.inf
            return req.ttft_slo_s - (now - req.t_created)

        order = sorted(self.pending, key=slack)      # stable: FIFO in ties
        total_slots = sum(e.ecfg.n_slots for e in self.engines)
        in_flight = self._in_flight()
        tenants = set(in_flight) | {r.tenant for r in self.pending}
        share = total_slots / max(len(tenants), 1)
        n = 0
        for req in order:
            others_queue = any(r.tenant != req.tenant for r in self.pending)
            if others_queue and in_flight.get(req.tenant, 0) >= share:
                # fairness: tenant over its share while others queue
                self.metrics.inc("router_fairness_skips_total",
                                 tenant=req.tenant)
                if self.tracer is not None:
                    self.tracer.event(
                        "fairness_skip", f"req-{req.rid}", t=now,
                        rid=req.rid, tenant=req.tenant,
                        in_flight=in_flight.get(req.tenant, 0),
                        share=share)
                continue
            eng = self._pick_engine(req)
            if eng is None:
                # no engine can admit it this tick: the request waits
                self.metrics.inc("router_no_admissible_total")
                if self.tracer is not None:
                    self.tracer.event("no_admissible_engine",
                                      f"req-{req.rid}", t=now,
                                      rid=req.rid, slack=slack(req))
                continue
            self.pending.remove(req)
            eng.scheduler.submit(req)
            self._dispatched[req.rid] = req
            in_flight[req.tenant] = in_flight.get(req.tenant, 0) + 1
            self.n_dispatched += 1
            eng_idx = self.engines.index(eng)
            self.assignments[req.rid] = eng_idx
            self.metrics.inc("router_dispatch_total", engine=eng_idx)
            if self.tracer is not None:
                self.tracer.event("dispatch", f"req-{req.rid}", t=now,
                                  rid=req.rid, engine=eng_idx,
                                  slack=slack(req))
            n += 1
        return n

    # -- drive --------------------------------------------------------------
    def step(self) -> bool:
        """One fleet tick: dispatch what fits, then tick every replica.
        Returns False when the whole fleet is idle."""
        n = self._dispatch_pass()
        progressed = n > 0
        for eng in self.engines:
            if eng.step():
                progressed = True
        if self.prefix_cache is not None:
            for eng in self.engines:
                for r in eng.scheduler.running.values():
                    if (r.prefill_progress >= len(r.prompt)
                            and r.rid not in self._registered):
                        self.prefix_cache.register(eng, r)
                        self._registered.add(r.rid)
        live = sum(1 for r in self._dispatched.values() if not r.finished)
        self._demand += self._demand_alpha * (
            live + len(self.pending) - self._demand)
        for rid in [rid for rid, r in self._dispatched.items()
                    if r.finished]:
            del self._dispatched[rid]
            self._registered.discard(rid)
        self.metrics.set("router_pending", len(self.pending))
        self.metrics.set("router_demand_ewma", self._demand)
        return progressed

    def run(self) -> None:
        while self.step():
            pass

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are generated, pumping the
        whole fleet.  Raises :class:`StreamError` if the fleet idles
        with ``req`` unfinished (e.g. it was never submitted here)."""
        emitted = 0
        while True:
            while emitted < len(req.tokens):
                yield req.tokens[emitted]
                emitted += 1
            if req.finished:
                return
            if not self.step():
                code = ("starved_request" if req.rid in self._submitted
                        else "foreign_request")
                raise StreamError([{
                    "field": "request", "code": code,
                    "message": (
                        f"fleet idle with request rid={req.rid} "
                        f"unfinished (state={req.state}, "
                        f"{len(req.tokens)}/{req.max_new_tokens} tokens "
                        "emitted)"
                        + ("" if code == "starved_request" else
                           " — it was never submitted to this router")),
                }])

    # -- autoscaling signal -------------------------------------------------
    def desired_replicas(self, target_occupancy: float = 0.75) -> int:
        """Replica count that would hold the demand EWMA (in-flight +
        queued requests) at ``target_occupancy`` of per-replica slots."""
        slots = self.engines[0].ecfg.n_slots
        return max(1, math.ceil(
            self._demand / max(slots * target_occupancy, 1e-9)))

    # -- stats --------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(
            e.scheduler.has_work for e in self.engines)

    def metrics_view(self) -> MetricsRegistry:
        """One registry over the fleet: the router's own series plus
        every engine's, relabelled ``source=router|engine<i>`` (the
        METRICS_*.json export view; :meth:`stats` stays the legacy
        summed shim)."""
        parts = {"router": self.metrics}
        for i, eng in enumerate(self.engines):
            parts[f"engine{i}"] = eng.metrics
        return MetricsRegistry.merged(parts)

    def stats(self) -> dict:
        per = [e.stats() for e in self.engines]
        out = {
            "replicas": len(self.engines),
            "pending": len(self.pending),
            "n_dispatched": self.n_dispatched,
            "demand_ewma": self._demand,
            "n_prefills": sum(s["n_prefills"] for s in per),
            "n_prefill_tokens": sum(s["n_prefill_tokens"] for s in per),
            "n_generated": sum(s["n_generated"] for s in per),
            "engines": per,
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out
