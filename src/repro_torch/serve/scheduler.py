"""Request admission + slot lifecycle for the continuous-batching engine.

The scheduler mixes prefill of newly arrived requests with decode of
in-flight ones: each engine tick first admits as many waiting requests
as slots/pages allow (first-fit over the arrival queue, so one request
too long for the current free pages does not starve shorter ones behind
it), then decodes every running slot in one fixed-shape step.  Finished
requests are evicted immediately — their slot and pages go back on the
free lists before the next admission pass.

With ``prefill_chunk > 0`` a newly admitted request does not prefill in
one shot: it joins the ``prefilling`` queue and the engine's *mixed*
tick consumes up to ``prefill_chunk`` of its prompt tokens per tick
(head of queue only — one admitting slot per tick) alongside the
single-token decode of every fully prefilled slot.  ``Request.
prefill_progress`` counts prompt tokens already written into the slot's
pages; the request starts decoding the tick its last chunk lands.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs.trace import Clock, WallClock
from repro_torch.serve.paging import PageAllocator

_rids = itertools.count(1)

WAITING, RUNNING, FINISHED = "WAITING", "RUNNING", "FINISHED"


class SubmitError(ValueError):
    """A request the engine can never serve, with every reason.

    ``errors`` is a list of ``{"field", "code", "message"}`` dicts
    so callers can render or
    match on individual problems instead of parsing an assert string.
    """

    def __init__(self, errors: List[Dict[str, str]]):
        self.errors = errors
        lines = [f"  - {e['field']}: [{e['code']}] {e['message']}"
                 for e in errors]
        super().__init__("invalid request:\n" + "\n".join(lines))


class StreamError(RuntimeError):
    """A stream ended with its request unfinished — the engine ran out
    of work while the request was never (or is no longer) its to serve,
    e.g. it was submitted to a different replica of a fleet.  Structured
    like :class:`SubmitError` so callers can match on the code instead
    of parsing the message."""

    def __init__(self, errors: List[Dict[str, str]]):
        self.errors = errors
        lines = [f"  - {e['field']}: [{e['code']}] {e['message']}"
                 for e in errors]
        super().__init__("stream cannot finish:\n" + "\n".join(lines))


@dataclass
class Request:
    """One generation request and its streamed output.

    Timing contract: ``t_created`` is stamped at construction;
    ``t_submit`` is stamped by :meth:`Scheduler.submit` (NOT at
    construction — a router may hold a request arbitrarily long before
    handing it to an engine, and that hold must not be silently folded
    into the engine's queue-wait).  ``ttft`` measures from engine
    submission; ``ttft_e2e`` from creation (the SLO-relevant latency a
    fleet router is judged on).

    Every stamp after construction comes from ONE injectable clock (the
    engine's — see ``repro_torch.obs.trace.Clock``), so sim-time runs get
    sim-time stamps; Engine/Router construct requests through the same
    clock, leaving the wall-clock default only for direct
    ``Request(...)`` construction.
    """

    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None
    tenant: str = "default"          # fair-admission bucket in a fleet
    ttft_slo_s: Optional[float] = None   # None -> no TTFT target
    rid: int = field(default_factory=lambda: next(_rids))
    state: str = WAITING
    slot: Optional[int] = None
    tokens: List[int] = field(default_factory=list)   # generated so far
    prefill_progress: int = 0        # prompt tokens already in the pages
    t_created: float = field(default_factory=time.perf_counter)
    t_submit: Optional[float] = None                  # entered a scheduler
    t_admit: Optional[float] = None                   # left the queue
    t_prefill_done: Optional[float] = None            # prompt fully in pages
    t_first: Optional[float] = None                   # first-token time
    t_done: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.state == FINISHED

    @property
    def ttft(self) -> Optional[float]:
        """First-token latency from engine submission."""
        if self.t_first is None:
            return None
        return self.t_first - (self.t_submit if self.t_submit is not None
                               else self.t_created)

    @property
    def ttft_e2e(self) -> Optional[float]:
        """First-token latency from construction (includes any router /
        dispatch hold before the request reached an engine)."""
        return None if self.t_first is None else self.t_first - self.t_created


class Scheduler:
    def __init__(self, alloc: PageAllocator, max_prompt_len: int,
                 prefill_chunk: int = 0, clock: Optional[Clock] = None):
        self.alloc = alloc
        self.max_prompt_len = max_prompt_len
        self.prefill_chunk = prefill_chunk
        self.clock = clock if clock is not None else WallClock()
        self.waiting: Deque[Request] = deque()
        self.prefilling: Deque[Request] = deque()    # admitted, mid-prefill
        self.running: Dict[int, Request] = {}        # slot -> request
        self.n_finished = 0

    def check(self, req: Request) -> List[Dict[str, str]]:
        """Every reason this scheduler could never serve ``req`` (empty
        when servable).  Factored out of :meth:`submit` so a fleet
        router can validate against an engine's shapes without
        enqueueing."""
        errors: List[Dict[str, str]] = []

        def err(field_, code, msg):
            errors.append({"field": field_, "code": code, "message": msg})

        if not 1 <= len(req.prompt) <= self.max_prompt_len:
            err("prompt", "bad_length",
                f"prompt length {len(req.prompt)} outside "
                f"[1, {self.max_prompt_len}]")
        if req.max_new_tokens < 1:
            err("max_new_tokens", "too_small",
                f"must be >= 1, got {req.max_new_tokens}")
        if req.temperature < 0.0:
            err("temperature", "negative",
                f"must be >= 0, got {req.temperature}")
        total = len(req.prompt) + max(req.max_new_tokens, 0)
        lay = self.alloc.layout
        cap = lay.pages_per_slot * lay.page_size
        if total > cap:
            err("max_new_tokens", "exceeds_slot",
                f"request needs {total} tokens; slot capacity is {cap}")
        # pool capacity too, else an unservable request waits forever; a
        # request must fit inside ONE shard's pages (its slot's shard)
        usable = lay.n_pages // self.alloc.n_shards - 1   # minus null page
        if self.alloc.pages_for(total) > usable:
            err("max_new_tokens", "exceeds_pool",
                f"request needs {self.alloc.pages_for(total)} pages; "
                f"each pool shard has {usable}")
        return errors

    def submit(self, req: Request) -> Request:
        errors = self.check(req)
        if errors:
            raise SubmitError(errors)
        # queue-wait starts NOW — not at construction (a router may have
        # held the request; that hold is t_submit - t_created)
        req.t_submit = self.clock.now()
        self.waiting.append(req)
        return req

    def admit(self) -> List[Request]:
        """Move admissible waiting requests into slots (:meth:`first_fit`
        on this scheduler's allocator)."""
        admitted = []
        for req, slot in self.first_fit(self.alloc):
            req.slot = slot
            req.state = RUNNING
            req.t_admit = self.clock.now()
            self.running[slot] = req
            admitted.append(req)
            if self.prefill_chunk > 0:
                req.prefill_progress = 0
                self.prefilling.append(req)
            else:
                req.prefill_progress = len(req.prompt)
        taken = {id(r) for r in admitted}
        self.waiting = deque(r for r in self.waiting if id(r) not in taken)
        return admitted

    def first_fit(self, alloc: PageAllocator) -> List[Tuple[Request, int]]:
        """The waiting requests an admission pass takes on ``alloc``,
        with their slots, in order (each admitted into ``alloc``; the
        queue is left as it is): length-aware first fit in arrival order.
        A remote engine's controller runs it on a copy of its ranks'
        allocator to learn which requests their next tick admits.

        The pass ends early the moment no remaining candidate can
        possibly fit: when slots run out, or when even the *smallest*
        queued request needs more pages than the best-provisioned shard
        with a free slot has left.  Free pages only shrink during the
        pass, so breaking is sound — and it keeps a long router backlog
        from costing an O(queue) rescan on every page-starved tick.
        """
        taken: List[Tuple[Request, int]] = []
        skipped: List[Request] = []
        min_need = None             # smallest worst-case page need queued
        for i, req in enumerate(self.waiting):
            if alloc.can_admit(len(req.prompt), req.max_new_tokens):
                taken.append((req, alloc.admit(len(req.prompt),
                                               req.max_new_tokens)))
                continue
            skipped.append(req)
            if not alloc.free_slots:
                break
            if min_need is None:
                min_need = min(
                    alloc.pages_for(len(r.prompt) + max(r.max_new_tokens, 0))
                    for r in itertools.chain(
                        skipped, itertools.islice(self.waiting, i + 1, None)))
            if alloc.max_admit_pages() < min_need:
                break
        return taken

    # -- chunked prefill (mixed ticks) --------------------------------------
    def next_chunk(self) -> Optional[Tuple[Request, int, int]]:
        """The head prefilling request's next chunk of prompt work as
        ``(req, start, n)``, capped by the per-tick chunk budget; None
        when no slot is mid-prefill."""
        if not self.prefilling:
            return None
        req = self.prefilling[0]
        start = req.prefill_progress
        return req, start, min(self.prefill_chunk, len(req.prompt) - start)

    def chunk_done(self, req: Request, n: int) -> bool:
        """Account ``n`` consumed prompt tokens; True when the request's
        prefill just completed (it decodes from the next tick on)."""
        req.prefill_progress += n
        if req.prefill_progress >= len(req.prompt):
            self.prefilling.popleft()
            return True
        return False

    def decodable(self) -> Dict[int, Request]:
        """Running slots whose prompt is fully in the pages."""
        mid = {r.rid for r in self.prefilling}
        return {s: r for s, r in self.running.items() if r.rid not in mid}

    def finish(self, req: Request):
        """Evict: free the slot and its pages for re-use."""
        req.state = FINISHED
        req.t_done = self.clock.now()
        del self.running[req.slot]
        self.alloc.free(req.slot)
        self.n_finished += 1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)
