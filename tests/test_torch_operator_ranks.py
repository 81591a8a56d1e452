"""The port's executors on meshes of gloo ranks (``dist.ranks.RankPool``)
against the JAX package's executors on meshes of CPU devices.

One pool of four ranks, each on one CPU thread, serves every case (a
module fixture).  Each case runs the reference's executor on the same
``ResourceGraph`` over the devices ``tests/conftest.py`` forces; graphs
hold at most four chips, so neither side degrades an allocation.

Held: the ``ran`` records' ``mesh_shape``, ``n_devices``, ``device_ids``
(slot ids here) and ``hosts`` equal the reference's; the
SubmeshExecutor's loss against the port's one-device step on the same
batch and draw; an elastic train grown 2 -> 4 and shrunk 4 -> 2 through
the checkpoint (``tp`` and ``fsdp``) against an uninterrupted one-device
run at the reference test's tolerance, with the reference's transitions
and meshes; a host lost before the first checkpoint (the state moved
through the host onto the new mesh); ``Trainer.remesh`` 1 -> 4 -> 1
ranks, by checkpoint and in memory; elastic serving grown and shrunk
mid-decode, greedy and at temperature, token for token against an
uninterrupted engine on the starting mesh; a fleet of two replicas on
their own slots, and an elastic fleet grown to three replicas and
promoted replica by replica, against the one-device fleets; a cached
engine whose slots joined a later mesh rebuilt; a rank's exception
raised here with its traceback.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.spec as jspec  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.spec as tspec  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import synthetic_batch, to_tensors  # noqa: E402
from repro_torch.dist import steps as dsteps  # noqa: E402
from repro_torch.dist.ranks import RankError, RankPool  # noqa: E402
from repro_torch.serve import EngineConfig  # noqa: E402
from repro_torch.serve.remote import RemoteEngine  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

TIMEOUT_S = 120             # each command on the ranks
RTOL, ATOL = 2e-3, 1e-5     # tests/test_elastic.py's tolerance
# a sharded bf16 step's loss against one device's (chip_smoke.py's
# TP_RTOL): the row-parallel sums round once in float32, as one device's do
TP_RTOL = 5e-4
_TINY = dict(name="tiny-elastic", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)
JTINY, TINY = jbase.ModelConfig(**_TINY), tbase.ModelConfig(**_TINY)
_ESERVE = dict(_TINY, name="tiny-eserve")
JESERVE, ESERVE = jbase.ModelConfig(**_ESERVE), tbase.ModelConfig(**_ESERVE)
_ZERO3 = dict(name="zero3", fsdp_params=True, tensor_parallel=False)
STRATEGIES = {"tp": (jbase.BASELINE, tbase.BASELINE),
              "fsdp": (jbase.ShardingStrategy(**_ZERO3),
                       tbase.ShardingStrategy(**_ZERO3))}
_SHAPE = dict(name="elastic", kind="train", seq_len=16, global_batch=8)
SHAPE = tbase.WorkloadShape(**_SHAPE)
_TCFG = dict(warmup_steps=0, compute_dtype="float32")
TOTAL = 10
SIM_STEP = 20.0
ECFG = dict(n_slots=3, page_size=4, max_seq_len=32, max_prompt_len=8)
GEN = 12
TICKS_BEFORE_RESIZE = 4
_rng = np.random.default_rng(7)
FIRST = [_rng.integers(0, 128, 6).tolist() for _ in range(2)]
LATE = [_rng.integers(0, 128, 5).tolist()]
PKGS = {"jax": (jcore, jspec), "torch": (tcore, tspec)}
MESH_FIELDS = ("mesh_shape", "n_devices", "device_ids", "hosts")


def _need_4():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX devices (conftest forces 8)")


@pytest.fixture(scope="module")
def pool():
    _need_4()
    with RankPool(4, device="cpu", timeout=TIMEOUT_S) as p:
        yield p


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run_until(clock, cond, horizon=100_000.0):
    clock.run(until=clock.now + horizon, stop_when=cond)
    assert cond(), "sim condition not reached within horizon"


def _cluster(pkg, hosts, chips, size, max_size=None, name="r"):
    core = PKGS[pkg][0]
    clock = core.SimClock(seed=0)
    mc = core.FluxMiniCluster(
        clock, core.NetModel(),
        core.ResourceGraph(n_pods=1, hosts_per_pod=hosts,
                           chips_per_host=chips),
        core.MiniClusterSpec(name=name, size=size,
                             max_size=max_size or size))
    mc.create()
    mc.wait_ready()
    return clock, mc


# ---------------------------------------------------------------------------
# placement (tests/test_dist.py's twins)
# ---------------------------------------------------------------------------


def _submesh_jobs(pkg, chips, n_nodes, n_jobs, pool=None):
    core = PKGS[pkg][0]
    clock, mc = _cluster(pkg, 4 // chips, chips, 4 // chips)
    kw = {} if pkg == "jax" else dict(ranks=pool)
    ex = core.SubmeshExecutor(clock, core.NetModel(), steps=1, seq_len=16,
                              **kw)
    mc.instance._set_executor(ex)
    jobs = [mc.instance.submit(core.JobSpec(n_nodes=n_nodes, walltime=1e9,
                                            command="yi-6b"))
            for _ in range(n_jobs)]
    clock.run(until=clock.now + 600)
    assert all(j.result == "completed" for j in jobs)
    return [ex.ran[j.jobid] for j in jobs]


def _one_device_loss(mesh_data, steps):
    """The port's step on one device over the executor's batch and draw:
    the warm step and ``steps`` more."""
    cfg = registry.smoke("yi-6b")
    tcfg = tbase.TrainConfig(total_steps=max(steps, 1), warmup_steps=0)
    shape = tbase.WorkloadShape("submesh", "train", 16, 2 * mesh_data)
    step = dsteps.build_train_step(cfg, tcfg, shape)
    state = dsteps.init_train_state(
        cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = to_tensors(synthetic_batch(cfg, shape), "cpu")
    for _ in range(1 + steps):
        state, metrics = step(state, batch)
    return float(metrics["loss"])


@pytest.mark.parametrize("chips,n_nodes,n_jobs", [(2, 2, 1), (1, 2, 2)],
                         ids=["one_job_2x2", "two_jobs_own_slots"])
def test_submesh_executor_places_jobs_on_their_meshes(pool, chips, n_nodes,
                                                      n_jobs):
    got = _submesh_jobs("torch", chips, n_nodes, n_jobs, pool)
    want = _submesh_jobs("jax", chips, n_nodes, n_jobs)
    for g, w in zip(got, want):
        assert {k: g[k] for k in MESH_FIELDS} == \
            {k: (tuple(w[k]) if k == "mesh_shape" else w[k])
             for k in MESH_FIELDS}
        assert g["measured_s"] > 0
        ref = _one_device_loss(g["mesh_shape"][0], 1)
        assert np.isfinite(g["loss"])
        assert abs(g["loss"] - ref) <= TP_RTOL * abs(ref), (g["loss"], ref)
    if n_jobs == 2:
        assert got[0]["device_ids"] == [0, 1]
        assert got[1]["device_ids"] == [2, 3]


# ---------------------------------------------------------------------------
# elastic training (tests/test_elastic.py's twins)
# ---------------------------------------------------------------------------


def _elastic_train(pkg, strategy, pool=None):
    core, spec = PKGS[pkg]
    base = jbase if pkg == "jax" else tbase
    clock, mc = _cluster(pkg, 4, 1, 2, 4, name="el")
    opts = dict(sim_step_time=SIM_STEP,
                tcfg=base.TrainConfig(total_steps=TOTAL, **_TCFG))
    if pkg == "torch":
        opts.update(ranks=pool)
    h = mc.apply(spec.WorkloadSpec(
        kind="train", arch="tiny-elastic",
        resources=spec.ResourceSpec(n_nodes=2, elastic=True),
        train=spec.TrainSpec(total_steps=TOTAL,
                             global_batch=SHAPE.global_batch,
                             seq_len=SHAPE.seq_len)),
        cfg=JTINY if pkg == "jax" else TINY,
        strategy=STRATEGIES[strategy][pkg == "torch"], executor_opts=opts)
    ex, job = h.executor, h.job
    _run_until(clock, lambda: job.jobid in ex.sessions
               and ex.sessions[job.jobid].step >= 3)
    ses = ex.sessions[job.jobid]
    step_at_grow = ses.step
    mc.patch_size(4)
    _run_until(clock, lambda: ses.step >= 7 and len(ses.resumes) >= 1)
    mc.patch_size(2)
    _run_until(clock, lambda: job.state == core.JobState.INACTIVE)
    assert job.result == "completed"
    return ses, step_at_grow


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_elastic_train_grows_and_shrinks_across_rank_counts(pool, strategy):
    ses, step_at_grow = _elastic_train("torch", strategy, pool)
    ref, _ = _elastic_train("jax", strategy)
    assert ses.step == TOTAL and len(ses.losses) == TOTAL
    assert [r["transition"] for r in ses.resumes] == ["2->4", "4->2"] == \
        [r["transition"] for r in ref.resumes]
    assert ses.resumes[0]["step"] > step_at_grow
    assert [s["mesh_shape"] for s in ses.segments] == \
        [list(s["mesh_shape"]) for s in ref.segments] == \
        [[2, 1], [4, 1], [2, 1]]
    assert [r["mesh_shape"] for r in ses.resumes] == \
        [list(r["mesh_shape"]) for r in ref.resumes]
    one = Trainer(TINY, tbase.TrainConfig(total_steps=TOTAL, **_TCFG), SHAPE,
                  strategy=STRATEGIES[strategy][1], device="cpu")
    want = [h["loss"] for h in one.run(TOTAL, log_every=0)]
    np.testing.assert_allclose(ses.losses, want, rtol=RTOL, atol=ATOL)


def test_node_death_before_first_checkpoint_moves_the_state_by_host(pool):
    """A lost host before any checkpoint requeues the job; its live
    state goes through the host (gathered whole on the old ranks, cut on
    the new) onto the new mesh (tests/test_elastic.py's twin)."""
    out = {}
    for pkg in ("torch", "jax"):
        core, spec = PKGS[pkg]
        base = jbase if pkg == "jax" else tbase
        clock, mc = _cluster(pkg, 4, 1, 2, 4, name="nd")
        opts = dict(sim_step_time=SIM_STEP,
                    tcfg=base.TrainConfig(total_steps=6, **_TCFG))
        if pkg == "torch":
            opts.update(ranks=pool)
        h = mc.apply(spec.WorkloadSpec(
            kind="train", arch="tiny-elastic",
            resources=spec.ResourceSpec(n_nodes=2, elastic=True),
            train=spec.TrainSpec(total_steps=6,
                                 global_batch=SHAPE.global_batch,
                                 seq_len=SHAPE.seq_len)),
            cfg=JTINY if pkg == "jax" else TINY, executor_opts=opts)
        ex, job = h.executor, h.job
        _run_until(clock, lambda: job.jobid in ex.sessions
                   and ex.sessions[job.jobid].step >= 1)
        ses = ex.sessions[job.jobid]
        assert ses.ckpt.latest_step() is None
        core.kill_node(clock, mc, rank=1, at=clock.now + 1.0)
        _run_until(clock, lambda: job.state == core.JobState.INACTIVE)
        assert job.result == "completed" and ses.step == 6
        assert job.requeues >= 1
        out[pkg] = ses
    got, ref = out["torch"], out["jax"]
    assert [(s["mesh_shape"], s["hosts"]) for s in got.segments] == \
        [(list(s["mesh_shape"]), s["hosts"]) for s in ref.segments]
    assert got.segments[-1]["hosts"] != got.segments[0]["hosts"]
    one = Trainer(TINY, tbase.TrainConfig(total_steps=6, **_TCFG), SHAPE,
                  device="cpu")
    np.testing.assert_allclose(got.losses,
                               [h["loss"] for h in one.run(6, log_every=0)],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_ckpt", [True, False],
                         ids=["checkpoint", "memory"])
def test_remesh_across_rank_counts(pool, tmp_path, use_ckpt):
    """1 -> 4 -> 1 ranks (tests/test_elastic.py's Trainer.remesh twin):
    the run on one device, then on a (data 2, model 2) mesh of the
    pool, then on one device again, against an uninterrupted run."""
    tcfg = tbase.TrainConfig(total_steps=9, **_TCFG)
    tr = Trainer(TINY, tcfg, SHAPE, device="cpu",
                 ckpt_dir=str(tmp_path) if use_ckpt else None)
    hist = tr.run(3, log_every=0)
    assert tr.remesh(pool.mesh((2, 2))) >= 0.0
    assert tr.state is None and tr.mesh.shape == {"data": 2, "model": 2}
    hist = tr.run(3, log_every=0)
    tr.remesh(None)
    hist = tr.run(3, log_every=0)
    assert [h["step"] for h in hist] == list(range(9))
    ref = Trainer(TINY, tcfg, SHAPE, device="cpu").run(9, log_every=0)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in ref], rtol=RTOL,
                               atol=ATOL)
    if use_ckpt:
        assert tr.ckpt.latest_step() == 6         # the second remesh's


# ---------------------------------------------------------------------------
# elastic serving (tests/test_elastic_serve.py's twins)
# ---------------------------------------------------------------------------


def _elastic_serve(pkg, size, patch_to, temperature, pool=None):
    core, spec = PKGS[pkg]
    clock, mc = _cluster(pkg, 4, 1, size, 4, name="es")
    opts = dict(sim_tick_time=40.0)
    if pkg == "torch":
        opts.update(ranks=pool)
    h = mc.apply(spec.WorkloadSpec(
        kind="serve", arch="tiny-eserve",
        resources=spec.ResourceSpec(n_nodes=size, elastic=True),
        serve=spec.ServeSpec(max_new=GEN, temperature=temperature,
                             n_requests=len(FIRST), **ECFG)),
        cfg=JESERVE if pkg == "jax" else ESERVE, executor_opts=opts)
    ex, job = h.executor, h.job
    job.spec.args["prompts"] = FIRST
    job.spec.args["temperature"] = temperature
    _run_until(clock, lambda: job.jobid in ex.sessions
               and ex.sessions[job.jobid].ticks >= TICKS_BEFORE_RESIZE)
    mc.patch_size(patch_to)
    assert h.phase == "Resizing"
    late = [h.submit_request(p, max_new_tokens=GEN,
                             temperature=temperature) for p in LATE]
    _run_until(clock, lambda: job.state == core.JobState.INACTIVE)
    assert h.phase == "Completed" and job.result == "completed"
    return ex.ran[job.jobid], late


def _uninterrupted(pool, hosts, temperature):
    """The same prompts on an engine of the starting mesh, the late ones
    submitted after the same ticks."""
    eng = RemoteEngine(ESERVE, EngineConfig(**ECFG),
                       mesh=pool.mesh((hosts, 1)), seed=0)
    first = [eng.submit(p, max_new_tokens=GEN, temperature=temperature)
             for p in FIRST]
    for _ in range(TICKS_BEFORE_RESIZE):
        eng.step()
    late = [eng.submit(p, max_new_tokens=GEN, temperature=temperature)
            for p in LATE]
    eng.run()
    eng.close()
    return [r.tokens for r in first + late]


@pytest.mark.parametrize("size,patch_to,temperature",
                         [(2, 4, 0.0), (4, 2, 0.0), (2, 4, 0.8)],
                         ids=["grow", "shrink", "grow_hot"])
def test_elastic_serve_resizes_token_identically(pool, size, patch_to,
                                                 temperature):
    rec, late = _elastic_serve("torch", size, patch_to, temperature, pool)
    ref, _ = _elastic_serve("jax", size, patch_to, temperature)
    assert rec["tokens"] == _uninterrupted(pool, size, temperature)
    assert rec["n_resumes"] == ref["n_resumes"] == 1
    assert rec["mesh_shape"] == tuple(ref["mesh_shape"]) == (patch_to, 1)
    assert rec["resumes"][0]["transition"] == \
        ref["resumes"][0]["transition"] == f"{size}->{patch_to}"
    assert rec["resumes"][0]["mesh_shape"] == \
        list(ref["resumes"][0]["mesh_shape"])
    assert len(late[0].tokens) == GEN
    if temperature:
        assert rec["tokens"] != _uninterrupted(pool, size, 0.0)


# ---------------------------------------------------------------------------
# serving: a fleet, a rebuilt cache entry, a rank's failure
# ---------------------------------------------------------------------------


def _serve_spec(spec, arch, n_nodes=1, replicas=1):
    return spec.WorkloadSpec(
        kind="serve", arch=arch,
        resources=spec.ResourceSpec(n_nodes=n_nodes),
        serve=spec.ServeSpec(max_new=4, n_requests=3, replicas=replicas,
                             **ECFG))


def test_fleet_replicas_run_on_their_own_slots(pool):
    runs = {}
    for name, opts in (("ranks", dict(ranks=pool)),
                       ("one", dict(device="cpu"))):
        clock, mc = _cluster("torch", 2, 1, 2, name=f"f{name}")
        h = mc.apply(_serve_spec(tspec, "tiny-eserve", replicas=2),
                     cfg=ESERVE, executor_opts=opts)
        _run_until(clock, lambda: h.job.state == tcore.JobState.INACTIVE)
        runs[name] = h.executor.ran[h.job.jobid]
        if name == "ranks":
            router, = h.executor._fleets.values()
            assert [e.slots for e in router.engines] == [(0,), (1,)]
            assert router.prefix_cache is None
    assert runs["ranks"]["mesh_shapes"] == [(1, 1), (1, 1)]
    assert runs["ranks"]["n_devices"] == 2
    assert runs["ranks"]["tokens"] == runs["one"]["tokens"]
    assert all(len(t) == 4 for t in runs["ranks"]["tokens"])


def test_elastic_fleet_scales_up_and_promotes_on_ranks(pool):
    """ElasticFleetServeExecutor on the pool: two replicas grow to three
    mid-decode, then new params roll in replica by replica (each
    replica's snapshot adopted by a fresh engine on its ranks); the
    streams equal the one-device fleet's token for token."""
    from repro_torch.models.model import Model
    runs = {}
    for name, opts in (("ranks", dict(ranks=pool)),
                       ("one", dict(device="cpu"))):
        clock, mc = _cluster("torch", 4, 1, 2, 4, name=f"ef{name}")
        h = mc.apply(tspec.WorkloadSpec(
            kind="serve", arch="tiny-eserve",
            resources=tspec.ResourceSpec(n_nodes=1, elastic=True),
            serve=tspec.ServeSpec(max_new=GEN, n_requests=2, replicas=2,
                                  **ECFG)),
            cfg=ESERVE, executor_opts=dict(opts, sim_tick_time=40.0))
        ex, job = h.executor, h.job
        job.spec.args["prompts"] = FIRST
        _run_until(clock, lambda: job.jobid in ex.sessions
                   and ex.sessions[job.jobid].ticks >= 2)
        ses = ex.sessions[job.jobid]
        mc.patch_size(3)
        late = [ex.submit_request(job, p, max_new=GEN) for p in LATE * 2]
        _run_until(clock, lambda: len(ses.router.engines) == 3)
        params = Model(ESERVE).init(torch.Generator().manual_seed(5),
                                    dtype=torch.float32, device="cpu")
        ex.promote(job, params)
        _run_until(clock, lambda: job.state == tcore.JobState.INACTIVE)
        assert job.result == "completed"
        assert all(len(r.tokens) == GEN for r in late)
        runs[name] = ex.ran[job.jobid]
        if name == "ranks":
            assert [e.slots for e in ses.router.engines] == \
                [(0,), (1,), (2,)]
    got, want = runs["ranks"], runs["one"]
    assert got["replicas"] == want["replicas"] == 3
    assert got["mesh_shapes"] == want["mesh_shapes"] == [(1, 1)] * 3
    assert got["version"] == want["version"] == 1
    assert got["assignments"] == want["assignments"]
    assert got["tokens"] == want["tokens"]


def test_cached_engine_is_rebuilt_after_its_slots_join_another_mesh(pool):
    clock, mc = _cluster("torch", 2, 2, 2, name="c")
    ex = tcore.ServeExecutor(clock, tcore.NetModel(), n_requests=2,
                             max_new=3, cfg=ESERVE,
                             engine_config=EngineConfig(**ECFG), ranks=pool)
    mc.instance._set_executor(ex)
    engines, recs = [], []
    for n in (1, 2, 1):
        job = mc.instance.submit(tcore.JobSpec(n_nodes=n, walltime=1e9,
                                               command="tiny-eserve"))
        _run_until(clock, lambda: job.result is not None)
        assert job.result == "completed"
        recs.append(ex.ran[job.jobid])
        key = ("tiny-eserve", recs[-1]["mesh_shape"],
               tuple(recs[-1]["device_ids"]))
        engines.append(ex._engines[key])
    assert [r["mesh_shape"] for r in recs] == [(1, 2), (2, 2), (1, 2)]
    assert recs[0]["device_ids"] == recs[2]["device_ids"] == [0, 1]
    assert not engines[0].alive and engines[2].alive
    assert engines[2] is not engines[0]
    assert recs[2]["tokens"] == recs[0]["tokens"] == recs[1]["tokens"]


def test_a_rank_failure_raises_with_its_traceback(pool):
    """An engine the ranks refuse (sinusoidal positions: no per-slot
    position; the engine asserts it as it is built on each rank) fails
    the job with rank 0's traceback, and the pool serves on."""
    clock, mc = _cluster("torch", 1, 2, 1, name="x")
    cfg = dataclasses.replace(registry.smoke("yi-6b"), pos_type="sinusoidal")
    ex = tcore.ServeExecutor(clock, tcore.NetModel(), n_requests=1,
                             max_new=2, cfg=cfg,
                             engine_config=EngineConfig(**ECFG), ranks=pool)
    mc.instance._set_executor(ex)
    mc.instance.submit(tcore.JobSpec(n_nodes=1, walltime=1e9,
                                     command="yi-6b"))
    with pytest.raises(RankError, match="(?s)rank 0 failed.*Traceback"
                       ".*rope \\(or no\\) position"):
        clock.run(until=clock.now + 600)
    # the pool serves on
    assert pool.run([0, 1], "repro_torch.dist.ranks:_ping") == 0
