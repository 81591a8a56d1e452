"""Flux brokers + the tree-based overlay network (TBON).

Rank 0 is the lead broker; followers connect to their tree parent over
"ZeroMQ/TCP" (modeled), retrying with exponential backoff when the
parent is not up yet — the startup behaviour the paper calls out
(followers waiting on the lead pays a growing tcp retry timeout).
Control RPCs route through the tree at per-hop latency; heartbeats
aggregate subtree health upward, so the lead learns about a dead node
from its parent, not from N direct probes (the TBON's scalability
argument: state aggregation is O(k) per vertex, O(log_k N) depth).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

from repro_torch.core.sim import NetModel, SimClock


class BrokerState(Enum):
    DOWN = "down"           # registered in system config but absent
    STARTING = "starting"   # pod booting
    CONNECTING = "connecting"
    UP = "up"
    LOST = "lost"           # missed heartbeats


class TBON:
    """Rooted k-ary tree over ranks 0..size-1."""

    def __init__(self, size: int, fanout: int = 2):
        self.size = size
        self.k = max(fanout, 1)

    def parent(self, rank: int) -> Optional[int]:
        return None if rank == 0 else (rank - 1) // self.k

    def children(self, rank: int) -> List[int]:
        lo = rank * self.k + 1
        return [r for r in range(lo, min(lo + self.k, self.size))]

    def depth(self, rank: int) -> int:
        d = 0
        while rank != 0:
            rank = self.parent(rank)
            d += 1
        return d

    def hops_to_root(self, rank: int) -> int:
        return self.depth(rank)


@dataclass
class Broker:
    rank: int
    state: BrokerState = BrokerState.DOWN
    host: Optional[int] = None          # host id from the resource graph
    connect_attempts: int = 0
    last_heartbeat: float = -1.0
    hb_latency: float = 0.0             # per-broker extra latency (straggler)


class BrokerPool:
    """All brokers of one Flux instance + TBON wiring on the sim clock."""

    def __init__(self, clock: SimClock, net: NetModel, max_size: int,
                 fanout: int = 2, hb_interval: float = 2.0,
                 hb_miss_limit: int = 3):
        self.clock = clock
        self.net = net
        self.tbon = TBON(max_size, fanout)
        self.brokers: Dict[int, Broker] = {
            r: Broker(rank=r) for r in range(max_size)}
        self.hb_interval = hb_interval
        self.hb_miss_limit = hb_miss_limit
        self.on_up: List[Callable[[int], None]] = []
        self.on_lost: List[Callable[[int], None]] = []
        self._hb_started = False

    # -- lifecycle ---------------------------------------------------------
    def boot(self, rank: int, host: int, *, straggler_factor: float = 1.0):
        """Pod scheduled: container boots then the broker connects."""
        b = self.brokers[rank]
        b.host = host
        b.state = BrokerState.STARTING
        boot = self.net.boot_time(self.clock.rng) * straggler_factor
        self.clock.trace("broker_boot", rank=rank, dt=boot)
        self.clock.call_in(boot, self._try_connect, rank)

    def _try_connect(self, rank: int):
        b = self.brokers[rank]
        if b.state in (BrokerState.DOWN,):
            return                       # was torn down while booting
        b.state = BrokerState.CONNECTING
        if rank == 0:
            self.clock.call_in(self.net.tcp_connect, self._mark_up, rank)
            return
        parent = self.tbon.parent(rank)
        pb = self.brokers[parent]
        if pb.state == BrokerState.UP:
            self.clock.call_in(self.net.tcp_connect, self._mark_up, rank)
        else:
            # ZeroMQ exponential retry backoff (paper: delayed startup
            # when the lead broker is not up first)
            delay = min(self.net.zmq_retry_base * (2 ** b.connect_attempts),
                        self.net.zmq_retry_max)
            b.connect_attempts += 1
            self.clock.trace("zmq_retry", rank=rank, delay=delay)
            self.clock.call_in(delay, self._try_connect, rank)

    def _mark_up(self, rank: int):
        b = self.brokers[rank]
        if b.state == BrokerState.DOWN:
            return
        b.state = BrokerState.UP
        b.last_heartbeat = self.clock.now
        self.clock.trace("broker_up", rank=rank)
        for cb in self.on_up:
            cb(rank)
        # children blocked on us retry immediately
        for c in self.tbon.children(rank):
            if self.brokers[c].state == BrokerState.CONNECTING:
                self.clock.call_in(self.net.tcp_connect, self._try_connect, c)
        if rank == 0 and not self._hb_started:
            self._hb_started = True
            self.clock.call_in(self.hb_interval, self._heartbeat_sweep)

    def teardown(self, rank: int):
        b = self.brokers[rank]
        b.state = BrokerState.DOWN
        b.connect_attempts = 0
        b.host = None
        self.clock.trace("broker_down", rank=rank)

    def fail(self, rank: int):
        """Abrupt node failure: broker stops heartbeating."""
        b = self.brokers[rank]
        if b.state == BrokerState.UP:
            b.state = BrokerState.LOST
            self.clock.trace("broker_fail", rank=rank)

    # -- heartbeats (aggregated up the TBON) --------------------------------
    def _heartbeat_sweep(self):
        now = self.clock.now
        for b in self.brokers.values():
            if b.state == BrokerState.UP:
                # heartbeat arrives after tree-depth hops (+ straggler lag)
                lat = (self.tbon.hops_to_root(b.rank) * self.net.rpc_latency
                       + b.hb_latency)
                b.last_heartbeat = now - lat
            elif b.state == BrokerState.LOST:
                missed = (now - b.last_heartbeat) / self.hb_interval
                if missed >= self.hb_miss_limit:
                    b.state = BrokerState.DOWN
                    self.clock.trace("broker_declared_down", rank=b.rank)
                    for cb in self.on_lost:
                        cb(b.rank)
        if any(b.state != BrokerState.DOWN for b in self.brokers.values()):
            self.clock.call_in(self.hb_interval, self._heartbeat_sweep)
        else:
            self._hb_started = False

    # -- queries -----------------------------------------------------------
    def up_ranks(self) -> List[int]:
        return [r for r, b in self.brokers.items()
                if b.state == BrokerState.UP]

    def n_up(self) -> int:
        return len(self.up_ranks())

    def rpc_cost(self, rank: int) -> float:
        """Latency of one control RPC rank -> lead via the TBON."""
        return (self.tbon.hops_to_root(rank) + 1) * self.net.rpc_latency

    def stragglers(self, threshold: float = 0.5) -> List[int]:
        """Ranks whose heartbeat lag exceeds ``threshold`` seconds."""
        return [r for r, b in self.brokers.items()
                if b.state == BrokerState.UP and b.hb_latency > threshold]
