"""What each of four gloo ranks runs for ``tests/test_torch_serve_tp.py``:
the port's Engine on meshes of ranks, on the CPU, float32.

A module apart from the test file, and without JAX: the ranks are
spawned processes, and each imports this module to find its function.
``run_rank`` joins the process group, builds the meshes, runs every
scenario in one fixed order (each a collective on all four ranks) and
puts its results, or its traceback, on the queue.  Its inputs (the JAX
package's parameters and a one-rank snapshot) come through a pickle
file; what it returns holds numpy arrays and plain values only.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import STRATEGIES
from repro_torch.dist import mesh as dmesh
from repro_torch.models import params as P
from repro_torch.serve import Engine, EngineConfig

WORLD = 4
TIMEOUT = timedelta(seconds=120)
YI, GRANITE, JAMBA, XLSTM = ("yi-6b", "granite-moe-1b-a400m",
                              "jamba-v0.1-52b", "xlstm-1.3b")
MIXERS = (JAMBA, XLSTM)
MESHES = {"dm": ((2, 2), ("data", "model")),
          "m4": ((1, 4), ("data", "model")),
          "d4": ((4, 1), ("data", "model"))}
ECFG = dict(n_slots=4, page_size=4, max_seq_len=32, max_prompt_len=8)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [2, 4]]
NEW = 5
CHUNK = 3
# (name, arch, mesh, dp_shards, prefill_chunk, strategy) of each greedy
# scenario; ``optimized`` splits params over ``data`` too (FSDP), so a
# prompt runs on every data rank (the ones that do not hold its slot as
# shadow runs, joining the gathers).  The sequence mixers (jamba: Mamba
# channels over ``model``; xlstm: mLSTM heads, one a rank on m4, and the
# sLSTM's recurrence whole on every rank) take no chunked ticks
RUNS = tuple((f"{key}_{mesh}_ds{ds}_{'c' if chunk else 'l'}", arch, mesh,
              ds, chunk, strategy)
             for key, arch, mesh, ds, strategy in (
                 ("yi", YI, "dm", 2, "baseline"),
                 ("yi", YI, "dm", 1, "baseline"),
                 ("yi", YI, "m4", 1, "baseline"),
                 ("yi", YI, "d4", 4, "baseline"),
                 ("yi_fsdp", YI, "dm", 2, "optimized"),
                 ("granite", GRANITE, "dm", 2, "baseline"),
                 ("jamba", JAMBA, "dm", 2, "baseline"),
                 ("jamba", JAMBA, "dm", 1, "baseline"),
                 ("jamba", JAMBA, "m4", 1, "baseline"),
                 ("xlstm", XLSTM, "dm", 2, "baseline"),
                 ("xlstm", XLSTM, "dm", 1, "baseline"),
                 ("xlstm", XLSTM, "m4", 1, "baseline"))
             for chunk in ((0,) if arch in MIXERS else (0, CHUNK)))
PARK_TICKS = 3              # ticks before a snapshot: no request finished


def xlstm_2h():
    """xlstm SMOKE with 2 heads: on (data 1, model 4) its mLSTM channels
    (and conv state rows) split but its heads do not, so the blocks
    compute whole on every rank from gathered weights."""
    cfg = registry.smoke(XLSTM)
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm,
                                                              n_heads=2))
HOT = 0.8                   # the sampled scenario's temperature


def engine_config(dp_shards=1, chunk=0):
    return EngineConfig(**ECFG, dp_shards=dp_shards, prefill_chunk=chunk)


def engine(arch, params, mesh=None, dp_shards=1, chunk=0,
           strategy="baseline", **kw):
    """The scenarios' float32 engine on the CPU from whole numpy params."""
    return Engine(registry.smoke(arch), engine_config(dp_shards, chunk),
                  strategy=STRATEGIES[strategy], mesh=mesh,
                  params=P.from_numpy(params), device="cpu",
                  compute_dtype=torch.float32, **kw)


def drive(eng, temperature=0.0):
    """Every prompt at once, NEW tokens each; per tick, free + in-use
    pages and the ``serve_pages_in_use`` gauge of each shard.  Returns
    (streams, ticks)."""
    reqs = [eng.submit(p, max_new_tokens=NEW, temperature=temperature)
            for p in PROMPTS]
    ticks = []
    while eng.step():
        s = eng.stats()
        ticks.append((s["free_pages"] + s["pages_in_use"],
                      [eng.metrics.value("serve_pages_in_use", shard=r)
                       for r in range(eng.layout.n_shards)]))
    assert all(r.finished for r in reqs)
    return [r.tokens for r in reqs], ticks


def requests_of(snap):
    """The snapshot's requests (none has finished; one mid-prefill is
    also running), by id."""
    reqs = {r.rid: r for r in (list(snap["waiting"])
                               + list(snap["prefilling"])
                               + list(snap["running"].values()))}
    return [reqs[k] for k in sorted(reqs)]


def to_host(snap):
    """A snapshot with numpy leaves in place of tensors (a queue between
    processes carries numpy by value): float32 values of the pool (bf16
    pages exactly; ``adopt_state`` casts them back)."""
    return dict(snap, pool=P.tree_map(
        lambda t: None if t is None else t.float().numpy(), snap["pool"]),
        key=snap["key"].numpy())


def from_host(snap):
    return dict(snap, pool=P.tree_map(torch.from_numpy, snap["pool"]),
                key=torch.from_numpy(snap["key"]))


def park(eng):
    """PARK_TICKS ticks of every prompt; then the snapshot."""
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=NEW)
    for _ in range(PARK_TICKS):
        assert eng.step()
    assert eng.scheduler.n_finished == 0
    return eng.snapshot_state()


def finish(eng, snap):
    """Adopt ``snap`` and run to the end: the streams of its requests."""
    eng.adopt_state(snap)
    reqs = requests_of(snap)
    eng.run()
    return [r.tokens for r in reqs]


def _raises(fn):
    try:
        fn()
    except Exception as e:                  # noqa: BLE001 (the type is kept)
        return type(e).__name__, str(e)
    return None


def run_rank(rank, init_file, inputs_file, queue):
    """``inputs_file``: a pickle of the JAX package's parameters (the
    SMOKE configs of every arch of ``RUNS``, whole) and a one-rank
    engine's snapshot."""
    torch.set_num_threads(2)
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    try:
        with open(inputs_file, "rb") as f:
            inputs = pickle.load(f)
        params = inputs["params"]
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD,
                                timeout=TIMEOUT)
        try:
            meshes = {k: dmesh.make_mesh(*v, timeout=TIMEOUT)
                      for k, v in MESHES.items()}
            res = {"rank": rank}
            for name, arch, mesh, ds, chunk, strategy in RUNS:
                eng = engine(arch, params[arch], meshes[mesh], ds, chunk,
                             strategy)
                streams, ticks = drive(eng)
                res[name] = {"streams": streams, "ticks": ticks,
                             "stats": eng.stats(),
                             "pool": P.tree_map(lambda t: tuple(t.shape),
                                                eng.pool),
                             "params": P.tree_map(lambda t: tuple(t.shape),
                                                  eng.params)}
            # parked on (data 2, model 2), adopted on one rank (the test)
            eng = engine(YI, params[YI], meshes["dm"], 2, CHUNK)
            snap = park(eng)
            res["parked"] = (to_host(snap) if rank == 0 else None)
            # a hybrid's too: its Mamba state rows gathered whole
            snap = park(engine(JAMBA, params[JAMBA], meshes["dm"], 2))
            res["parked_jamba"] = (to_host(snap) if rank == 0 else None)
            # a one-rank snapshot adopted on (data 2, model 2)
            eng = engine(YI, params[YI], meshes["dm"], 2, CHUNK)
            res["adopted"] = finish(eng, from_host(inputs["one_rank_snap"]))
            # heads model 4 does not divide: whole blocks, split conv rows
            eng = Engine(xlstm_2h(), engine_config(), mesh=meshes["m4"],
                         params=P.from_numpy(inputs["xlstm_2h_params"]),
                         device="cpu", compute_dtype=torch.float32)
            res["xlstm_2h"] = {
                "streams": drive(eng)[0],
                "pool": P.tree_map(lambda t: tuple(t.shape), eng.pool)}
            # sampled: every rank draws the same tokens
            res["hot"] = drive(engine(YI, params[YI], meshes["dm"], 2, CHUNK),
                               HOT)[0]
            # graphs raise before any parameter is drawn; a hybrid builds
            res["graphs"] = _raises(lambda: Engine(
                registry.smoke(YI), engine_config(2), mesh=meshes["dm"],
                device="cpu", cuda_graphs=True))
            res["jamba"] = _raises(lambda: Engine(
                registry.smoke(JAMBA), engine_config(), mesh=meshes["dm"],
                device="cpu"))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put(res)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


# the card's case (``tests/test_torch_cuda.py``): yi SMOKE on (data 2,
# model 2) of four ranks of card 0, bf16, legacy and chunked
CUDA_CHUNKS = (0, 16)
CUDA_PROMPTS = [[(5 * i + 3 * j + 1) % 256 for j in range(n)]
                for i, n in enumerate((3, 13, 30, 9))]
CUDA_ECFG = dict(n_slots=4, page_size=8, max_prompt_len=32, max_seq_len=48)
CUDA_NEW = 8


def cuda_streams(mesh=None, chunk=0, dev="cuda"):
    """yi SMOKE from seed 0 on ``dev`` (the mesh's ranks, or one rank
    eagerly): its greedy streams and kernel launches."""
    from repro_torch.kernels import build
    eng = Engine(registry.smoke(YI),
                 EngineConfig(**CUDA_ECFG, prefill_chunk=chunk,
                              dp_shards=2 if mesh is not None else 1),
                 mesh=mesh, seed=0, device=dev, cuda_graphs=False)
    build.reset_launches()
    reqs = [eng.submit(p, max_new_tokens=CUDA_NEW) for p in CUDA_PROMPTS]
    eng.run()
    torch.cuda.synchronize()
    return [r.tokens for r in reqs], dict(build.LAUNCHES)


def cuda_rank(rank, init_file, queue):
    """A rank of the card's case: both modes' streams and launches."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD,
                                timeout=TIMEOUT)
        try:
            mesh = dmesh.make_mesh(*MESHES["dm"], timeout=TIMEOUT)
            res = {"rank": rank}
            for chunk in CUDA_CHUNKS:
                res[chunk] = cuda_streams(mesh, chunk, torch.device("cuda", 0))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put(res)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise
