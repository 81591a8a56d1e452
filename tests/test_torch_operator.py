"""The port's operator control plane against the JAX package: the copied
``core`` and ``spec`` (MiniCluster, brokers, queue, Fluxion graph,
``FluxInstance.apply``), ``dist.sharding.submesh_for``, the fleet Router
and the executors, run here on the CPU (the elastic train executor and
the elastic fleet's resizes and promotions are held in
``tests/test_torch_elastic.py`` and ``tests/test_torch_flow.py``).

Held exactly: mesh shapes, axes and device indices; the control plane's
handle event logs (phase, simulated time, detail) and queue stats; the
Router's dispatch, prefix-cache hits and ``desired_replicas``; and greedy
streams token for token (the port's float32 engines against the JAX
contiguous float32 reference with its cache rounded to bf16, the
convention of ``tests/test_torch_serve.py``).  Simulated times are exact
because every executor here has a fixed measure (``fixed_measure``,
``time_scale=0`` or ``sim_tick_time``): no wall clock reaches them.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.spec as jspec  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.spec as tspec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Router as JRouter  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Router  # noqa: E402

_TINY = dict(name="tiny-op", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)
JTINY, TINY = JModelConfig(**_TINY), ModelConfig(**_TINY)
CPU = dict(device="cpu")

# the two packages side by side: (core, spec, cfg, the workload executor,
# executor options the port needs on this host)
PKGS = {"jax": (jcore, jspec, JTINY, jcore.JaxWorkloadExecutor, {}),
        "torch": (tcore, tspec, TINY, tcore.TorchWorkloadExecutor, CPU)}


def _need_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (conftest forces them)")


def _events(handle):
    """A handle's event log without job ids (each package numbers its
    jobs from its own counter)."""
    return [{k: v for k, v in e.items() if k != "jobid"}
            for e in handle.events()]


# ---------------------------------------------------------------------------
# (i) submesh_for
# ---------------------------------------------------------------------------

# hosts, chips per host, pods (parallel to hosts; () for a legacy set)
ALLOCS = {
    "single-host": ((0,), 2, (0,)),
    "single-chip": ((3,), 1, (1,)),
    "multi-host": ((0, 1), 2, (0, 0)),
    "no-pod-info": ((0, 1), 4, ()),
    "pod-spanning": ((0, 1, 2, 3), 2, (0, 0, 1, 1)),
    "ragged-pods": ((0, 1, 2), 2, (0, 0, 1)),
    "oversized": ((0, 1, 2, 3, 4, 5), 2, (0, 0, 0, 1, 1, 1)),
    "past-the-devices": ((2, 4), 2, (0, 1)),
}


@pytest.mark.parametrize("name", ALLOCS)
def test_submesh_for_matches_jax(name):
    """The same mesh shape, axes and device indices as JAX's over its 8
    forced CPU devices, with the port given an 8-entry device list."""
    _need_8()
    hosts, cph, pods = ALLOCS[name]
    jm = jsharding.submesh_for(jcore.ResourceSet(hosts, cph, pods))
    devices = [torch.device("cuda", i) for i in range(8)]
    tm = tsharding.submesh_for(tcore.ResourceSet(hosts, cph, pods), devices)
    assert tuple(tm.devices.shape) == tuple(jm.devices.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape) and tm.size == jm.size
    assert [d.index for d in tm.devices.flat] == [d.id for d in jm.devices.flat]


def test_submesh_for_one_device_gives_one_by_one():
    """The CPU device list is one device, so every allocation degrades to
    (1, 1), as one card's does; without a card the default list raises
    (the executors run on the card unless asked otherwise)."""
    assert tsharding.device_list("cpu") == [torch.device("cpu")]
    for hosts, cph, pods in ALLOCS.values():
        mesh = tsharding.submesh_for(tcore.ResourceSet(hosts, cph, pods),
                                     tsharding.device_list("cpu"))
        assert mesh.shape == {"data": 1, "model": 1}
        assert list(mesh.devices.flat) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsharding.device_list()


# ---------------------------------------------------------------------------
# (ii) the control plane: one scenario in both packages
# ---------------------------------------------------------------------------


def _control_plane(pkg):
    """create, wait_ready, plain jobs through the workload executor (a
    fixed measure), a train and a serve spec applied, a node killed
    under a running job, then patch_size up and down and one more spec
    applied after the shrink."""
    core, spec, cfg, workload, opts = PKGS[pkg]
    clock = core.SimClock(seed=3)
    net = core.NetModel()
    graph = core.ResourceGraph(n_pods=2, hosts_per_pod=4, chips_per_host=2)
    mc = core.FluxMiniCluster(clock, net, graph, core.MiniClusterSpec(
        name="cp", size=4, max_size=8))
    mc.create()
    mc.wait_ready()
    mc.instance.executor = workload(clock, net, fixed_measure=40.0, **opts)
    plain = [mc.instance.submit(core.JobSpec(n_nodes=n, walltime=100.0,
                                             command="lammps-proxy"))
             for n in (1, 2)]
    fixed = dict(time_scale=0.0, **opts)
    train = spec.WorkloadSpec(kind="train", arch="tiny-op",
                              resources=spec.ResourceSpec(n_nodes=1),
                              train=spec.TrainSpec(total_steps=1, seq_len=16))
    serve = spec.WorkloadSpec(kind="serve", arch="tiny-op",
                              resources=spec.ResourceSpec(n_nodes=1),
                              serve=spec.ServeSpec(
                                  n_slots=2, page_size=4, max_seq_len=32,
                                  max_prompt_len=8, max_new=3, n_requests=2))
    handles = [mc.apply(train, cfg=cfg, executor_opts=fixed),
               mc.apply(serve, cfg=cfg, executor_opts=fixed)]
    core.kill_node(clock, mc, 1, at=clock.now + 5.0)
    clock.run(until=clock.now + 300.0)
    mc.patch_size(6)
    clock.run(until=clock.now + 300.0)
    mc.patch_size(3)
    clock.run(until=clock.now + 300.0)
    handles.append(mc.apply(train, cfg=cfg, executor_opts=fixed))
    clock.run(until=clock.now + 300.0)
    return {
        "events": [_events(h) for h in handles],
        "queue": mc.instance.queue.stats(),
        "plain": [(j.state.value, j.requeues, j.t_run, j.t_done, j.result)
                  for j in plain],
        "phases": [h.phase for h in handles],
        "size": (mc.status.phase, len(mc._assigned)),
    }


def test_control_plane_scenario_equals_jax_exactly():
    _need_8()
    got, want = _control_plane("torch"), _control_plane("jax")
    assert got == want
    assert got["phases"] == ["Completed"] * 3
    assert any(r > 0 for _, r, *_ in got["plain"]), \
        "the killed node must requeue a running job"


# ---------------------------------------------------------------------------
# (iii) the Router against JAX's
# ---------------------------------------------------------------------------


class _FrozenClock:
    """One fixed time for router and engines on both sides: SLO slack is
    then the SLO itself, and dispatch cannot depend on the wall clock."""

    def now(self):
        return 0.0


ECFG = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8,
            prefill_chunk=4)
PREFIX = [5, 9, 2, 6]                 # one full page


def _jax_greedy_f32(jp, prompt, gen, cap=32):
    """The JAX contiguous-cache path at float32 compute, its cache rounded
    to bf16 after the prefill (the type a page pool holds)."""
    m = JModel(JTINY)
    toks = np.zeros((1, cap), np.int32)
    toks[0, :len(prompt)] = prompt
    logits, cache = m.prefill(jp, {"tokens": jnp.asarray(toks)},
                              compute_dtype=jnp.float32,
                              last_index=jnp.array([len(prompt) - 1]))
    cache = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), cache)
    step = jax.jit(functools.partial(m.decode_step,
                                     compute_dtype=jnp.float32))
    out = [int(jnp.argmax(logits[0]))]
    for i in range(gen - 1):
        logits, cache = step(jp, cache, jnp.asarray([[out[-1]]], jnp.int32),
                             jnp.int32(len(prompt) + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


def _drive_router(router, wave):
    """The staggered shared-prefix run of tests/test_fleet.py (the first
    prompt alone until its prefix is registered), then a wave of requests
    under two tenants and TTFT SLOs, as (prompt, tenant, slo)."""
    reqs = [router.submit(PREFIX + [10, 20, 3], max_new_tokens=4)]
    for _ in range(8):
        router.step()
        if router.prefix_cache is not None \
                and router.prefix_cache.stats()["size"]:
            break
    reqs += [router.submit(p, max_new_tokens=4, tenant=t, ttft_slo_s=s)
             for p, t, s in wave]
    router.step()
    desired = router.desired_replicas(target_occupancy=0.5)
    router.run()
    return reqs, desired


WAVE = [(PREFIX + [11 + i, 21 + i, 3], t, s) for i, (t, s) in enumerate(
    [("A", None), ("A", None), ("A", 0.5), ("B", None), ("B", 0.01),
     ("A", None)])]


@pytest.fixture(scope="module")
def router_params():
    jp = JModel(JTINY).init(jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.device_get(jp))


def test_router_matches_jax_router(router_params):
    jp, tp = router_params
    clock = _FrozenClock()
    jrouter = JRouter([JEngine(JTINY, JEngineConfig(**ECFG), params=jp,
                               clock=clock) for _ in range(2)], clock=clock)
    trouter = Router([Engine(TINY, EngineConfig(**ECFG), params=tp,
                             device="cpu", compute_dtype=torch.float32,
                             clock=clock) for _ in range(2)], clock=clock)
    jreqs, jdesired = _drive_router(jrouter, WAVE)
    treqs, tdesired = _drive_router(trouter, WAVE)
    assert [trouter.assignments[r.rid] for r in treqs] == \
        [jrouter.assignments[r.rid] for r in jreqs]
    assert trouter.prefix_cache.stats() == jrouter.prefix_cache.stats()
    assert trouter.prefix_cache.hits >= len(WAVE)
    assert tdesired == jdesired and tdesired >= 2
    assert trouter.desired_replicas() == jrouter.desired_replicas()
    assert trouter.metrics.value("router_fairness_skips_total", tenant="A") \
        == jrouter.metrics.value("router_fairness_skips_total", tenant="A")
    for r in treqs:
        assert r.tokens == _jax_greedy_f32(jp, r.prompt, 4)


def test_prefix_cache_adopts_on_the_device_with_identical_streams(
        router_params):
    """The port's cache gathers and copies pages inside the pools: a warm
    router gives the cold router's tokens, hits for every later prompt,
    and prefills fewer tokens."""
    _, tp = router_params
    engines = [Engine(TINY, EngineConfig(**ECFG), params=tp, device="cpu")
               for _ in range(2)]
    wave = [(p, "default", None) for p, _, _ in WAVE]
    before = sum(e.n_prefill_tokens for e in engines)
    cold, _ = _drive_router(Router(engines, prefix_cache=False), wave)
    cold_tokens = sum(e.n_prefill_tokens for e in engines) - before
    warm_router = Router(engines)
    before = sum(e.n_prefill_tokens for e in engines)
    warm, _ = _drive_router(warm_router, wave)
    warm_tokens = sum(e.n_prefill_tokens for e in engines) - before
    assert [r.tokens for r in warm] == [r.tokens for r in cold]
    assert warm_router.prefix_cache.hits >= len(wave)
    assert warm_tokens < cold_tokens
    entry = next(iter(warm_router.prefix_cache._store.values()))
    assert all(t.device.type == "cpu" and t.dtype == torch.bfloat16
               for sub in entry.values() for t in sub.values())


# ---------------------------------------------------------------------------
# (iv) the five executors through apply
# ---------------------------------------------------------------------------


def _mini(core, size=2, max_size=4, seed=0):
    clock = core.SimClock(seed=seed)
    graph = core.ResourceGraph(n_pods=1, hosts_per_pod=4, chips_per_host=2)
    mc = core.FluxMiniCluster(clock, core.NetModel(), graph,
                              core.MiniClusterSpec(name="ex", size=size,
                                                   max_size=max_size))
    mc.create()
    mc.wait_ready()
    return clock, mc


SERVE = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8,
             max_new=5, n_requests=3)
EXECUTOR_SPECS = {
    "train": (dict(kind="train", train=dict(total_steps=2, seq_len=16)),
              dict(time_scale=0.0), "SubmeshExecutor"),
    "serve": (dict(kind="serve", serve=SERVE), dict(time_scale=0.0),
              "ServeExecutor"),
    "serve-chunked": (dict(kind="serve", serve=dict(SERVE, prefill_chunk=4)),
                      dict(time_scale=0.0), "ServeExecutor"),
    "fleet": (dict(kind="serve", serve=dict(SERVE, prefill_chunk=4,
                                            replicas=2, n_requests=4)),
              dict(time_scale=0.0), "FleetServeExecutor"),
    "elastic-serve": (dict(kind="serve", elastic=True, serve=SERVE),
                      dict(sim_tick_time=5.0), "ElasticServeExecutor"),
}


def _apply_one(pkg, name):
    core, spec, cfg, _, opts = PKGS[pkg]
    kw, ex_opts, _ = EXECUTOR_SPECS[name]
    kw = dict(kw)
    elastic = kw.pop("elastic", False)
    sub = {k: getattr(spec, {"train": "TrainSpec", "serve": "ServeSpec"}[k])(
        **kw.pop(k)) for k in ("train", "serve") if k in kw}
    clock, mc = _mini(core)
    h = mc.apply(spec.WorkloadSpec(
        arch="tiny-op", resources=spec.ResourceSpec(n_nodes=1,
                                                    elastic=elastic),
        **kw, **sub), cfg=cfg, executor_opts=dict(ex_opts, **opts))
    clock.run(until=clock.now + 10_000.0,
              stop_when=lambda: h.phase in ("Completed", "Failed"))
    return h


@pytest.mark.parametrize("name", EXECUTOR_SPECS)
def test_executor_lifecycle_and_records_match_jax(name):
    """Each executor, bound by apply, takes its handle through the JAX
    executor's phases at the same simulated times and keeps the JAX
    record's fields (the port adds the served tokens); its mesh is
    (1, 1) on the CPU where JAX's spans its forced devices (ROADMAP
    Queue 3)."""
    _need_8()
    got, want = _apply_one("torch", name), _apply_one("jax", name)
    assert type(got.executor).__name__ == EXECUTOR_SPECS[name][2]
    assert _events(got) == _events(want)
    assert got.phase == "Completed"
    assert [e["phase"] for e in got.events()] == \
        ["Pending", "Bound", "Running", "Completed"]
    rec = got.executor.ran[got.job.jobid]
    jrec = want.executor.ran[want.job.jobid]
    assert set(jrec) <= set(rec)
    for key in ("n_requests", "n_tokens", "replicas", "n_devices", "hosts",
                "ticks", "n_resumes", "n_prefills"):
        if key in jrec and key != "n_devices":
            assert rec[key] == jrec[key], key
    assert all(s == (1, 1) for s in
               rec.get("mesh_shapes", [rec.get("mesh_shape", (1, 1))]))
    result = got.result()
    assert result["outcome"] == "completed"
    if name == "train":
        assert np.isfinite(rec["loss"]) and result["final_loss"] == rec["loss"]
    else:
        assert result["n_tokens"] == rec["n_tokens"] > 0


def test_serve_executor_streams_equal_a_direct_engine():
    """The serve executor's engine is the default Engine of its seed:
    the streams it served equal a fresh engine's over the same prompts."""
    h = _apply_one("torch", "serve-chunked")
    rec = h.executor.ran[h.job.jobid]
    eng = Engine(TINY, h.spec.engine_config(), device="cpu")
    prompts = [[(7 * i + j) % TINY.vocab_size for j in range(8)]
               for i in range(3)]
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert rec["tokens"] == [r.tokens for r in reqs]


def test_fleet_replicas_share_one_parameter_set():
    h = _apply_one("torch", "fleet")
    (fleet, meshes), = [(f, h.executor._meshes[k])
                        for k, f in h.executor._fleets.items()]
    a, b = (P.tree_leaves(e.params) for e in fleet.engines)
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(a, b))
    assert len(meshes) == 2
    rec = h.executor.ran[h.job.jobid]
    assert rec["prefix_cache"] is not None and rec["desired_replicas"] >= 1


def _fig5(pkg):
    """The workload executor under both operators, as the paper's
    Figure 5 runs LAMMPS: the Flux instance (TBON bootstrap) and an
    MPIJob (serial ssh handshake, the app-efficiency gap)."""
    core, _, _, workload, opts = PKGS[pkg]
    clock = core.SimClock(seed=5)
    net = core.NetModel()
    ex = workload(clock, net, fixed_measure=30.0, **opts)
    mc = core.FluxMiniCluster(clock, net, core.ResourceGraph(1, 8, 2),
                              core.MiniClusterSpec(name="f5", size=4))
    mc.create()
    mc.wait_ready()
    mc.instance.executor = ex
    job = mc.instance.submit(core.JobSpec(n_nodes=4, walltime=100.0,
                                          command="lammps-proxy"))
    clock.run(until=clock.now + 500.0)
    mj = core.MPIJob(clock, net, core.ResourceGraph(1, 8, 2), n_workers=4,
                     executor=ex.mpi_executor())
    mj.create()
    clock.run(stop_when=lambda: mj.status.phase == "Running")
    walls = []
    mj.mpirun(core.JobSpec(n_nodes=4, command="lammps-proxy"), walls.append)
    clock.run(until=clock.now + 500.0)
    return (job.state.value, job.t_run, job.t_done, ex.measured[job.jobid],
            walls, mj.status.t_launched, mj.status.t_done)


def test_workload_executor_under_both_operators_matches_jax():
    got, want = _fig5("torch"), _fig5("jax")
    assert got == want
    assert got[0] == "INACTIVE" and len(got[4]) == 1


def test_workload_executor_measures_a_real_step_on_the_cpu():
    from repro_torch.configs import registry
    clock = tcore.SimClock(seed=0)
    ex = tcore.TorchWorkloadExecutor(clock, tcore.NetModel(), steps=2,
                                     cfg=registry.smoke("lammps-proxy"),
                                     device="cpu")
    raw = ex._step_fn("lammps-proxy")()
    assert np.isfinite(raw) and raw > 0


# the elastic-serve invariant (tests/test_elastic_serve.py): a resize
# mid-decode gives the uninterrupted run's tokens, for requests admitted
# before it and during it
GEN, TICKS_BEFORE_RESIZE = 12, 4
_rng = np.random.default_rng(7)
FIRST = [_rng.integers(0, TINY.vocab_size, 6).tolist() for _ in range(2)]
LATE = [_rng.integers(0, TINY.vocab_size, 5).tolist()]
ELASTIC_ECFG = dict(n_slots=3, page_size=4, max_seq_len=32, max_prompt_len=8)


def _uninterrupted(temperature):
    eng = Engine(TINY, EngineConfig(**ELASTIC_ECFG), seed=0, device="cpu")
    first = [eng.submit(p, max_new_tokens=GEN, temperature=temperature)
             for p in FIRST]
    for _ in range(TICKS_BEFORE_RESIZE):
        eng.step()
    late = [eng.submit(p, max_new_tokens=GEN, temperature=temperature)
            for p in LATE]
    eng.run()
    return [r.tokens for r in first + late]


@pytest.mark.parametrize("size,patch_to,temperature", [
    (2, 4, 0.0), (4, 2, 0.0), (2, 4, 0.8)])
def test_elastic_serve_resize_is_token_identical(size, patch_to,
                                                 temperature):
    clock, mc = _mini(tcore, size=size, max_size=4)
    h = mc.apply(tspec.WorkloadSpec(
        kind="serve", arch="tiny-op",
        resources=tspec.ResourceSpec(n_nodes=size, elastic=True),
        serve=tspec.ServeSpec(max_new=GEN, temperature=temperature,
                              n_requests=len(FIRST), **ELASTIC_ECFG)),
        cfg=TINY, executor_opts=dict(sim_tick_time=40.0, **CPU))
    ex, job = h.executor, h.job
    job.spec.args["prompts"] = FIRST
    job.spec.args["temperature"] = temperature
    clock.run(until=clock.now + 100_000.0, stop_when=lambda: (
        job.jobid in ex.sessions
        and ex.sessions[job.jobid].ticks >= TICKS_BEFORE_RESIZE))
    assert ex.sessions[job.jobid].ticks == TICKS_BEFORE_RESIZE
    mc.patch_size(patch_to)
    assert h.phase == "Resizing"
    late = [h.submit_request(p, max_new_tokens=GEN, temperature=temperature)
            for p in LATE]
    clock.run(until=clock.now + 100_000.0,
              stop_when=lambda: job.state == tcore.JobState.INACTIVE)
    assert h.phase == "Completed"
    rec = ex.ran[job.jobid]
    assert rec["tokens"] == _uninterrupted(temperature)
    assert rec["n_resumes"] == 1 and len(late[0].tokens) == GEN
    assert rec["resumes"][0]["transition"] == f"{size}->{patch_to}"
    ses = ex.sessions[job.jobid]
    assert len(ses.park_s) == len(ses.adopt_s) == 1
    phases = [e["phase"] for e in h.events()]
    assert phases[:3] == ["Pending", "Bound", "Running"]
    assert "Resizing" in phases and phases[-1] == "Completed"


# ---------------------------------------------------------------------------
# (v) the elastic executors bind; what the registry lacks fails validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,name", [
    (dict(kind="train", resources=dict(n_nodes=1, elastic=True),
          train=dict(total_steps=2, seq_len=16)), "ElasticTrainExecutor"),
    (dict(kind="serve", resources=dict(n_nodes=1, elastic=True),
          serve=dict(SERVE, replicas=2)), "ElasticFleetServeExecutor")],
    ids=["elastic-train", "elastic-fleet"])
def test_elastic_specs_bind_the_elastic_executors(kw, name):
    """The two specs the port refused before its elastic executors came
    bind them through apply and complete as the reference's do; a
    one-stage pipeline of the same spec runs through apply_pipeline."""
    _need_8()
    out = {}
    for pkg in ("torch", "jax"):
        core, spec, cfg, _, opts = PKGS[pkg]
        clock, mc = _mini(core)
        doc = dict(kw, arch="tiny-op")
        fixed = dict(opts, **({"sim_step_time": 5.0} if doc["kind"] == "train"
                              else {"sim_tick_time": 5.0}))
        h = mc.apply(spec.WorkloadSpec.from_dict(doc), cfg=cfg,
                     executor_opts=fixed)
        clock.run(until=clock.now + 10_000.0, stop_when=lambda: h.done)
        flow = importlib.import_module(f"{spec.__name__.split('.')[0]}.flow")
        p = mc.apply_pipeline(flow.PipelineSpec.from_dict(dict(
            name="one", stages=[dict(name="s", kind="workload",
                                     workload=doc)])),
            cfg=cfg, executor_opts=fixed)
        clock.run(until=clock.now + 10_000.0, stop_when=lambda: p.done)
        out[pkg] = (h, p)
    (h, p), (jh, jp) = out["torch"], out["jax"]
    assert type(h.executor).__name__ == type(jh.executor).__name__ == name
    assert h.phase == "Completed" and p.phase == "Completed"
    assert _events(h) == _events(jh)
    assert [{k: v for k, v in e.items() if k != "jobid"} for e in p.events()] \
        == [{k: v for k, v in e.items() if k != "jobid"} for e in jp.events()]


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_arches_the_port_lacks_fail_validation(arch):
    """The two families the port's registry once lacked (their specs
    failed its validation on ``arch``): a train spec of each now
    validates in both packages, as does a serve spec of pixtral."""
    for spec in (jspec, tspec):
        spec.WorkloadSpec(kind="train", arch=arch).validate()
        if arch == "pixtral-12b":
            spec.WorkloadSpec(kind="serve", arch=arch).validate()


def test_whisper_serve_spec_is_not_servable_in_both_packages():
    """The serving engine hosts decoder-only architectures: applying a
    whisper serve spec raises a SpecError with ``("arch",
    "not-servable")`` in both packages, and nothing is submitted."""
    out = {}
    for pkg in ("torch", "jax"):
        core, spec, _, _, opts = PKGS[pkg]
        _, mc = _mini(core)
        with pytest.raises(spec.SpecError) as exc:
            mc.apply(spec.WorkloadSpec(kind="serve", arch="whisper-base",
                                       serve=spec.ServeSpec(**SERVE)),
                     executor_opts=dict(opts))
        out[pkg] = [(e["field"], e["code"]) for e in exc.value.errors]
    assert out["torch"] == out["jax"] == [("arch", "not-servable")]


# ---------------------------------------------------------------------------
# (vi) the sequence-mixer arches, pixtral and whisper through apply,
# without cfg=
# ---------------------------------------------------------------------------

SEQMIX = ["jamba-v0.1-52b", "xlstm-1.3b"]
# the families the port took last: pixtral serves (its patches stay out of
# the engine, as in the reference); whisper, an encoder-decoder, trains only
SERVE_ARCHS = SEQMIX + ["pixtral-12b"]
# their train specs: tests/test_torch_operator_train_specs.py


def _apply_arch(pkg, arch, name):
    """``_apply_one``'s spec for ``arch``, with no ``cfg=``: the executor
    takes the arch's SMOKE config from its registry."""
    core, spec, _, _, opts = PKGS[pkg]
    kw, ex_opts, _ = EXECUTOR_SPECS[name]
    kw = dict(kw)
    elastic = kw.pop("elastic", False)
    clock, mc = _mini(core)
    h = mc.apply(spec.WorkloadSpec(
        arch=arch, resources=spec.ResourceSpec(n_nodes=1, elastic=elastic),
        serve=spec.ServeSpec(**kw.pop("serve")), **kw),
        executor_opts=dict(ex_opts, **opts))
    clock.run(until=clock.now + 10_000.0,
              stop_when=lambda: h.phase in ("Completed", "Failed"))
    return h


@pytest.mark.parametrize("name", ["serve", "serve-chunked", "elastic-serve"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sequence_mixer_serve_specs_match_jax(arch, name):
    """A serve spec of each sequence-mixer arch and of pixtral validates
    and applies in the port (which refused them before), through the
    reference executor's phases at the same simulated times, with the
    same tokens served; the streams equal a direct Engine's over the
    executor's params (a chunked spec takes chunked ticks on pixtral
    only: the sequence mixers prefill exactly)."""
    _need_8()
    got, want = _apply_arch("torch", arch, name), _apply_arch("jax", arch,
                                                              name)
    assert type(got.executor).__name__ == EXECUTOR_SPECS[name][2]
    assert _events(got) == _events(want)
    assert [e["phase"] for e in got.events()] == \
        ["Pending", "Bound", "Running", "Completed"]
    rec = got.executor.ran[got.job.jobid]
    jrec = want.executor.ran[want.job.jobid]
    for key in ("n_requests", "n_tokens", "ticks"):
        if key in jrec:
            assert rec[key] == jrec[key], key
    if name == "elastic-serve":
        return
    eng, = got.executor._engines.values()
    assert eng.cfg.name == treg.smoke(arch).name
    assert (eng.n_mixed_steps > 0) == (name == "serve-chunked"
                                       and not eng.cfg.sub_quadratic)
    direct = Engine(eng.cfg, got.spec.engine_config(), params=eng.params,
                    device="cpu")
    reqs = [direct.submit([(7 * i + j) % eng.cfg.vocab_size
                           for j in range(8)], max_new_tokens=len(t))
            for i, t in enumerate(rec["tokens"])]
    direct.run()
    assert rec["tokens"] == [r.tokens for r in reqs]


@pytest.mark.parametrize("arch", SEQMIX)
def test_sequence_mixer_elastic_serve_resize_is_token_identical(arch):
    """The elastic-serve invariant on a sequence-mixer arch: a grow
    mid-decode parks the pool, state leaves included, and the adopting
    engine gives the uninterrupted run's tokens."""
    cfg = treg.smoke(arch)
    rng = np.random.default_rng(11)
    first = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (6, 3)]
    eng = Engine(cfg, EngineConfig(**ELASTIC_ECFG), seed=0, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=GEN) for p in first]
    eng.run()
    clock, mc = _mini(tcore, size=2, max_size=4)
    h = mc.apply(tspec.WorkloadSpec(
        kind="serve", arch=arch,
        resources=tspec.ResourceSpec(n_nodes=2, elastic=True),
        serve=tspec.ServeSpec(max_new=GEN, n_requests=len(first),
                              **ELASTIC_ECFG)),
        executor_opts=dict(sim_tick_time=40.0, **CPU))
    ex, job = h.executor, h.job
    job.spec.args["prompts"] = first
    clock.run(until=clock.now + 100_000.0, stop_when=lambda: (
        job.jobid in ex.sessions
        and ex.sessions[job.jobid].ticks >= TICKS_BEFORE_RESIZE))
    mc.patch_size(4)
    assert h.phase == "Resizing"
    clock.run(until=clock.now + 100_000.0,
              stop_when=lambda: job.state == tcore.JobState.INACTIVE)
    assert h.phase == "Completed"
    rec = ex.ran[job.jobid]
    assert rec["n_resumes"] == 1
    assert rec["tokens"] == [r.tokens for r in reqs]
