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

    eng = Engine(registry.smoke("yi-6b"), EngineConfig(n_slots=4),
                 device="cpu")
    req = eng.submit([1, 2, 3], max_new_tokens=8)
    for tok in eng.stream(req):
        ...
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.layers import PagedView
from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Clock, Tracer, WallClock
from repro_torch.serve import paging
from repro_torch.serve.scheduler import Request, Scheduler, StreamError


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


class Engine:
    """Driver loop: admission -> prefill -> continuous decode.

    Runs on CUDA unless ``device`` says otherwise.  ``params`` (a tree
    from ``Model.init`` or ``params.from_numpy``) move to the device; by
    default they are drawn from ``seed`` in ``compute_dtype``.  Timing
    stamps come from ``clock``, counters live in ``metrics`` (the JAX
    engine's metric names), and an optional ``tracer`` records each
    finished request's lifecycle spans.
    """

    n_prefills = _counter("serve_prefills_total")
    n_prefill_tokens = _counter("serve_prefill_tokens_total")
    n_decode_steps = _counter("serve_ticks_total", kind="decode")
    n_mixed_steps = _counter("serve_ticks_total", kind="mixed")
    n_generated = _counter("serve_generated_tokens_total")

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig = EngineConfig(),
                 *, params=None, seed: int = 0, device=None,
                 compute_dtype=torch.bfloat16, clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        assert not cfg.encoder_layers, \
            "serving engine: decoder-only architectures"
        assert cfg.pos_type in ("rope", "none"), \
            "per-slot positions need rope (or no) position encoding"
        self.device = resolve_device(device)
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
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, dtype=compute_dtype,
                                     device=self.device)
        self.params = P.tree_map(lambda t: t.to(self.device), params)
        self.pool = paging.init_pool(cfg, ecfg.n_slots, self.layout,
                                     self.device)
        self._next_token = np.zeros((ecfg.n_slots,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.prefix_cache = None      # set by a fleet Router (fleet.py)
        self.n_prefills = 0
        self.n_prefill_tokens = 0
        self.n_decode_steps = 0
        self.n_mixed_steps = 0
        self.n_generated = 0

    # -- park / adopt ---------------------------------------------------------
    def snapshot_state(self) -> dict:
        """Freeze the engine's whole decode state on the host: the page
        pools (host copies), the allocator's block table, lengths,
        reservations and free lists, the scheduler's queues, each slot's
        next token, the sampling generator's state (under ``"key"``, the
        JAX engine's name for its sampling key) and the compute counters.
        An engine of the same shapes, with the same or other params,
        :meth:`adopt_state`s it and goes on from the parked tokens."""
        al, sch = self.alloc, self.scheduler
        return {
            "pool": P.tree_map(lambda t: t.to("cpu", copy=True), self.pool),
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
        are those of an uninterrupted run at any temperature."""
        for key, kv in snap["pool"].items():
            for n, t in kv.items():
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

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        return sample_tokens(logits, self._dev(temps), self._gen).cpu().numpy()

    def _run_prefill(self, req: Request) -> None:
        """The prompt right-padded to ``max_prompt_len`` (a page multiple,
        so its KV reshapes into pages), or for a ``sub_quadratic`` config
        at its exact length (padding would run through the recurrent
        state), its KV then padded to a page boundary; the KV scattered
        into the slot's pages and the state into the slot's rows."""
        ecfg, cfg, slot, plen = self.ecfg, self.cfg, req.slot, len(req.prompt)
        step_len = plen if cfg.sub_quadratic else ecfg.max_prompt_len
        tokens = np.full((1, step_len), ecfg.pad_id, np.int64)
        tokens[0, :plen] = req.prompt
        logits, pcache = self.model.prefill(
            self.params, {"tokens": self._dev(tokens)},
            compute_dtype=self.compute_dtype,
            last_index=self._dev(np.array([plen - 1])))
        cap = paging.round_up(step_len, ecfg.page_size)
        if cap != step_len:
            pcache = paging.pad_prefill_cache(cfg, pcache, cap)
        page_rows = self.alloc.block_table[slot:slot + 1,
                                           :cap // ecfg.page_size]
        paging.scatter_prefill(cfg, self.pool, pcache, self._dev(page_rows),
                               self._dev(np.array([slot])))
        tok = self._sample(logits, np.array([req.temperature], np.float32))
        self.n_prefills += 1
        self.n_prefill_tokens += plen
        req.t_prefill_done = self.clock.now()
        self._emit(req, int(tok[0]))
        self._tick_obs("prefill", 1)

    def _decode_logits(self, block_table, lengths):
        bt, lens = self._dev(block_table), self._dev(lengths)
        logits, _ = self.model.decode_step(
            self.params, self.pool, self._dev(self._next_token[:, None]).long(),
            lens, compute_dtype=self.compute_dtype,
            paging=PagedView(bt, lens))
        return logits

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
        logits = self._decode_logits(bt, lens)
        c_logits, _ = self.model.prefill_chunk(
            self.params, self.pool, self._dev(c_tokens),
            PagedView(self._dev(c_pages), self._dev(np.array([start], np.int32)),
                      n_valid=self._dev(np.array([n], np.int32)),
                      null_page=self.alloc.null_page_of(slot)),
            compute_dtype=self.compute_dtype)
        if final:
            # a final chunk samples from its last real prompt row
            logits[slot] = c_logits[0, max(n - 1, 0)]
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
        logits = self._decode_logits(self.alloc.block_table,
                                     self.alloc.lengths)
        tok = self._sample(logits, temps)
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
            "dp_shards": self.layout.n_shards,
            "device": str(self.device),
        }
