"""A pool of ranks that outlives one job: the devices a Flux allocation
maps onto when the operator runs on meshes of several ranks.

The JAX package holds every device in one process, so its
``submesh_for`` lays an allocation over ``jax.devices()``.  The port
runs a mesh as gloo ranks, one process each, and a job's ranks must
exist before the job does and outlive it.  ``RankPool(n)`` spawns ``n``
ranks once (``torch.multiprocessing``, spawn context).  Rank ``i`` runs
on ``device`` (default: the card ``cuda:{i % device_count}``, so that on
one card every rank shares it; ``"cpu"`` for tests) with one intra-op
thread, and loops over commands.

The controller (the process that holds the ``SimClock`` and the
executors) sends a command to a subset of slots: each member runs
``fn(rank_context, *args)`` and the first slot of the subset returns its
result.  The constructor returns once the ranks are started; the first
command waits for them to be up.  Every command has a timeout; an exception on any member raises
in the controller with that rank's traceback; a rank that dies or does
not answer in time raises and closes the pool.  Nothing carries on with
fewer ranks.

Groups.  A subset that takes up an allocation forms a process group of
its own (:meth:`RankPool.group`): each member re-initialises its default
group with a fresh file rendezvous under the pool's temporary directory,
so ``dist.mesh.make_mesh`` runs unchanged on it.  Allocations are
disjoint, so a rank belongs to at most one live group.  Forming a group
over slots that belong to other groups dissolves those groups first, on
all their members: every object a rank keeps for a dissolved group is
dropped (its memory freed), and a controller-side proxy of such an
object reads ``alive`` False, so a cache holding it rebuilds.  A group
over exactly the slots of a live one is that group.

Handles.  Each rank keeps a registry of per-job objects (a ``Trainer``,
an ``Engine``, a step), each under the controller's handle and tagged
with its group.  State too large for a pipe (a parked pool, a whole
train state) passes between subsets as a file under :attr:`tmp`.

``close()`` ends the ranks; the pool is a context manager.
"""
from __future__ import annotations

import gc
import importlib
import itertools
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

# a member that has failed gets this long for the others to answer
# before the pool is taken as hung
ERROR_GRACE_S = 10.0


class Slot:
    """One rank of a pool, as a mesh's device entry: ``index`` is its
    id (what the reference reads as ``d.id``)."""

    __slots__ = ("pool", "index")

    def __init__(self, pool: "RankPool", index: int):
        self.pool, self.index = pool, index

    def __repr__(self) -> str:
        return f"rank{self.index}"


def pool_of(mesh) -> Optional["RankPool"]:
    """The pool whose slots a mesh's devices are, else None."""
    devs = getattr(mesh, "devices", None)
    if devs is None or devs.size == 0:
        return None
    d = devs.flat[0]
    return d.pool if isinstance(d, Slot) else None


def slots_of(mesh) -> Tuple[int, ...]:
    """The slot ids of a pool mesh, in its row-major rank order."""
    return tuple(int(d.index) for d in mesh.devices.flat)


class RankError(RuntimeError):
    """A command failed on a rank (the message holds its traceback), or
    a rank died or did not answer in time."""


class RankPool:
    """``n`` spawned ranks and the groups they form; see the module's
    docstring.  ``timeout``: the seconds a command may take, and each
    collective of a group (gloo's own timeout)."""

    def __init__(self, n: int, device=None, timeout: float = 600.0):
        import torch
        import torch.multiprocessing as mp
        if n < 1:
            raise ValueError(f"a pool of {n} ranks")
        if device is None:
            from repro_torch.device import resolve_device
            resolve_device(None)            # raises where there is no card
        self.n, self.timeout = n, float(timeout)
        count = torch.cuda.device_count() if device is None else 0
        self.devices = [str(device) if device is not None
                        else f"cuda:{i % count}" for i in range(n)]
        self.tmp = tempfile.mkdtemp(prefix="rank_pool_")
        self.slots = [Slot(self, i) for i in range(n)]
        self._cids = itertools.count(1)
        self._handles = itertools.count(1)
        self._gids = itertools.count(1)
        self._groups: Dict[int, Tuple[int, ...]] = {}   # gid -> slots
        self._member: Dict[int, int] = {}               # slot -> gid
        self._closed = False
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(i, self.devices[i], self.tmp, self._inboxes[i],
                  self._results)) for i in range(n)]
        for p in self._procs:
            p.start()               # the first command waits for them

    # -- commands -----------------------------------------------------------
    def run(self, slots: Sequence[int], fn, *args) -> Any:
        """Run ``fn(rank_context, *args)`` on every slot of ``slots`` and
        return the first slot's result.  ``fn``: a module-level function
        (the ranks import its module) or its ``"module:name"``."""
        if self._closed:
            raise RankError("the rank pool is closed")
        slots = tuple(int(s) for s in slots)
        name = fn if isinstance(fn, str) else f"{fn.__module__}:{fn.__name__}"
        cid = next(self._cids)
        for s in slots:
            self._inboxes[s].put((cid, name, slots[0], args))
        deadline = time.monotonic() + self.timeout
        pending, result, errors = set(slots), None, []
        while pending:
            now = time.monotonic()
            if now >= deadline:
                self.close()
                what = errors[0][1] if errors else (
                    f"no answer from ranks {sorted(pending)} to {name} "
                    f"within {self.timeout:.0f} s")
                raise RankError(what)
            try:
                rank, got, ok, out = self._results.get(
                    timeout=min(1.0, deadline - now))
            except queue_mod.Empty:
                dead = [(s, self._procs[s].exitcode) for s in pending
                        if not self._procs[s].is_alive()]
                if dead:
                    self.close()
                    raise RankError(f"ranks exited before answering {name}: "
                                    + ", ".join(f"rank {s} with code {c}"
                                                for s, c in dead))
                continue
            if got != cid:
                continue                    # an answer to a cancelled call
            pending.discard(rank)
            if not ok:
                if not errors:
                    deadline = min(deadline, time.monotonic() + ERROR_GRACE_S)
                errors.append((rank, f"rank {rank} failed in {name}:\n{out}"))
            elif rank == slots[0]:
                result = out
        if errors:
            raise RankError(min(errors)[1])
        return result

    # -- groups -------------------------------------------------------------
    def group(self, slots: Sequence[int]) -> int:
        """The id of the live group over exactly ``slots`` (in this
        order), formed now where there is none: every group that shares
        a slot with it is dissolved first, on all its members."""
        slots = tuple(int(s) for s in slots)
        if len(set(slots)) != len(slots) or not all(
                0 <= s < self.n for s in slots):
            raise ValueError(f"slots {slots} of a pool of {self.n}")
        gid = self._member.get(slots[0])
        if gid is not None and self._groups[gid] == slots:
            return gid
        for old in sorted({self._member[s] for s in slots
                           if s in self._member}):
            members = self._groups.pop(old)
            for s in members:
                del self._member[s]
            self.run(members, _leave, old)
        gid = next(self._gids)
        self.run(slots, _join, gid, slots,
                 os.path.join(self.tmp, f"group{gid}"), self.timeout)
        self._groups[gid] = slots
        for s in slots:
            self._member[s] = gid
        return gid

    def mesh(self, shape: Sequence[int], axes=("data", "model"),
             slots: Optional[Sequence[int]] = None):
        """A mesh of ``shape`` over ``slots`` (default: the first ones),
        laid out as ``dist.sharding.submesh_for`` lays an allocation."""
        import numpy as np
        from repro_torch.dist.mesh import Mesh
        n = int(np.prod(tuple(shape)))
        ids = list(range(n) if slots is None else slots)
        arr = np.empty(n, dtype=object)
        arr[:] = [self.slots[s] for s in ids]
        return Mesh(shape, axes, devices=arr.reshape(tuple(shape)))

    def alive(self, gid: int) -> bool:
        return not self._closed and gid in self._groups

    def handle(self) -> int:
        """A fresh handle for an object on the ranks."""
        return next(self._handles)

    def path(self, stem: str) -> str:
        """A fresh file name under the pool's temporary directory."""
        return os.path.join(self.tmp, f"{stem}-{next(self._handles)}.pt")

    def drop(self, gid: int, handle: int) -> None:
        """Free the object ``handle`` of group ``gid`` on its ranks (a
        no-op where the group is gone: its objects went with it)."""
        if self.alive(gid):
            self.run(self._groups[gid], _drop, handle)

    def launches(self, reset: bool = False) -> Dict[str, int]:
        """The kernels' launch counts summed over every rank (each
        rank's ``kernels.build.LAUNCHES``); ``reset`` sets them to 0
        after reading."""
        out: Dict[str, int] = {}
        for s in range(self.n):
            for k, v in self.run([s], _launches, reset).items():
                out[k] = out.get(k, 0) + v
        return out

    def peak_gb(self, reset: bool = False) -> List[float]:
        """Each rank's peak of allocated device memory, in GB (0 on the
        CPU)."""
        return [self.run([s], _peak_gb, reset) for s in range(self.n)]

    # -- lifetime -----------------------------------------------------------
    def close(self) -> None:
        """End the ranks (killed where they do not stop within 30 s) and
        remove the temporary directory."""
        if self._closed:
            return
        self._closed = True
        self._groups.clear()
        self._member.clear()
        for q in self._inboxes:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        t_end = time.monotonic() + 30.0
        for p in self._procs:
            p.join(timeout=max(0.1, t_end - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in self._inboxes + [self._results]:
            q.cancel_join_thread()
            q.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


class RankContext:
    """What a command sees on its rank: ``index`` (the slot id),
    ``device``, the pool's ``tmp`` directory, the live group (``gid``,
    ``members``, ``rank`` within it), and the registry of objects."""

    def __init__(self, index: int, device, tmp: str):
        self.index, self.device, self.tmp = index, device, tmp
        self.gid: Optional[int] = None
        self.members: Tuple[int, ...] = ()
        self.timeout = 600.0
        self._objects: Dict[int, Tuple[int, Any]] = {}
        self._meshes: Dict = {}

    @property
    def rank(self) -> int:
        return self.members.index(self.index)

    def mesh(self, shape: Sequence[int], axes: Sequence[str]):
        """The ``dist.mesh`` mesh of ``shape`` over the live group (built
        once per shape; a collective the first time)."""
        from repro_torch.dist.mesh import make_mesh
        key = (tuple(shape), tuple(axes))
        if key not in self._meshes:
            self._meshes[key] = make_mesh(
                shape, axes, timeout=timedelta(seconds=self.timeout))
        return self._meshes[key]

    def put(self, handle: int, obj) -> None:
        self._objects[handle] = (self.gid, obj)

    def get(self, handle: int):
        gid, obj = self._objects[handle]
        if gid != self.gid:
            raise RankError(f"object {handle} belongs to dissolved group "
                            f"{gid}")
        return obj

    def pop(self, handle: int):
        return self._objects.pop(handle, (None, None))[1]

    def free(self, gid: int) -> None:
        """Drop every object of group ``gid`` and release its memory."""
        for h in [h for h, (g, _) in self._objects.items() if g == gid]:
            del self._objects[h]
        _release(self.device)


def _release(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _resolve(name: str):
    mod, _, fn = name.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _rank_main(index, device, tmp, inbox, results):
    """One rank's command loop: run each command, answer with its result
    (the subset's first slot) or its traceback.  The rank takes its card
    (a CUDA context) at its first command after the start-up ping, so an
    idle pool holds no device memory."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    dev = torch.device(device)
    on_device = dev.type != "cuda"
    # one intra-op thread: a pool's ranks share the host's cores (and
    # with the CPU device do all the work there), and torch's default of a
    # thread a core each oversubscribes them into spin-waits
    torch.set_num_threads(1)
    rk = RankContext(index, dev, tmp)
    while True:
        msg = inbox.get()
        if msg is None:
            break
        cid, name, lead, args = msg
        try:
            if not on_device and name != _PING:
                torch.cuda.set_device(dev)
                on_device = True
            out = _resolve(name)(rk, *args)
            results.put((index, cid, True, out if index == lead else None))
        except BaseException:
            results.put((index, cid, False, traceback.format_exc()))
    _quit(rk)


def _quit(rk: RankContext) -> None:
    import torch.distributed as dist
    rk._objects.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _ping(rk: RankContext) -> int:
    return rk.index


_PING = f"{__name__}:_ping"


def _join(rk: RankContext, gid: int, members, init_file: str,
          timeout_s: float) -> None:
    """Form group ``gid``: a default process group over ``members`` (none
    for one rank)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    rk.gid, rk.members, rk.timeout = gid, tuple(members), timeout_s
    rk._meshes = {}
    if len(members) > 1:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rk.rank,
            world_size=len(members), timeout=timedelta(seconds=timeout_s))


def _leave(rk: RankContext, gid: int) -> None:
    """Dissolve group ``gid`` here: its objects go, then its process
    group."""
    import torch.distributed as dist
    rk.free(gid)
    if rk.gid == gid:
        rk._meshes = {}
        if dist.is_initialized():
            dist.destroy_process_group()
        rk.gid, rk.members = None, ()


def _drop(rk: RankContext, handle: int) -> None:
    rk.pop(handle)
    _release(rk.device)


def _launches(rk: RankContext, reset: bool) -> Dict[str, int]:
    from repro_torch.kernels import build
    out = dict(build.LAUNCHES)
    if reset:
        build.reset_launches()
    return out


def _peak_gb(rk: RankContext, reset: bool) -> float:
    import torch
    if rk.device.type != "cuda":
        return 0.0
    torch.cuda.synchronize(rk.device)
    out = torch.cuda.max_memory_allocated(rk.device) / 1e9
    if reset:
        torch.cuda.reset_peak_memory_stats(rk.device)
    return out
