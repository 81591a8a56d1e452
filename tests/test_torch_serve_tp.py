"""The port's Engine on meshes of gloo ranks (tensor and expert
parallelism, paged pools split by KV head and data shard) against the
JAX package's Engine on meshes of CPU devices.

Four gloo ranks are spawned once for the module (``torch_serve_ranks``
holds what they run, and imports no JAX), each on two intra-op threads;
the JAX engines run here, on the devices ``tests/conftest.py`` forces,
at float32 compute (``Model.prefill``, ``prefill_chunk`` and
``decode_step`` given ``compute_dtype=float32``), both packages keeping
KV in bf16 pages, from the same parameters (the JAX package's, carried
across).

Held exactly: the greedy streams, token for token, on (data 2, model 2)
with ``dp_shards`` 2 and 1, on (data 1, model 4) (yi's 2 KV heads do
not split: the weights are gathered), on (data 4, model 1) with
``dp_shards`` 4, under ``optimized`` (FSDP over ``data``: a prompt's
shadow runs), and granite's with its experts over ``model``, each in
legacy and chunked (chunk 3) mode, on every rank; at every tick, free
plus in-use pages against the usable pool and each shard's
``serve_pages_in_use`` against the reference's; the sequence mixers'
streams, legacy, on (data 2, model 2) with ``dp_shards`` 2 and 1 and on
(data 1, model 4) (jamba SMOKE: Mamba channels, attention heads and
experts over ``model``; xlstm SMOKE: mLSTM heads over ``model``, the
sLSTM's recurrence whole on every rank; and xlstm SMOKE with 2 heads on
(data 1, model 4), whose mLSTM blocks compute whole); the shapes each rank holds
against the reference's resolved specs (the mixers' state rows too);
snapshots across the mesh and one rank, both ways (a hybrid's from the
mesh); sampled streams equal on every rank.

The four ranks have 300 s to finish (about 60 s here; the JAX engines
beside them take about 80, the mixers' a compile a prompt length): a hung
collective fails the module instead of the run.
"""
import dataclasses
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_serve_ranks as R  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.dist import steps as tsteps  # noqa: E402
from repro_torch.dist.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import paging  # noqa: E402

TIMEOUT_S = 300
RUN_NAMES = [r[0] for r in R.RUNS]
RUNS = {r[0]: r[1:] for r in R.RUNS}
STRATEGIES = {"baseline": (tbase.BASELINE, jbase.BASELINE),
              "optimized": (tbase.OPTIMIZED, jbase.OPTIMIZED),
              "zero3": (tbase.ZERO3, jbase.ZERO3)}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _need_4():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX devices (conftest forces 8)")


def _jax_mesh(name):
    shape, axes = R.MESHES[name]
    return jshd.make_mesh(shape, axes, devices=jax.devices()[:4])


def _jax_params(arch):
    return _jax_params_of(jreg.smoke(arch))


def _jax_params_of(cfg):
    p = JModel(cfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(p))


def _jax_xlstm_2h():
    """``R.xlstm_2h``'s config in the JAX package: xlstm SMOKE, 2 heads."""
    cfg = jreg.smoke(R.XLSTM)
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm,
                                                              n_heads=2))


@pytest.fixture(scope="module")
def f32_jax_engine():
    """The JAX Engine at float32 compute: its steps call the model's
    prefill, prefill_chunk and decode_step with the default bf16 compute
    dtype, which this replaces."""
    mp = pytest.MonkeyPatch()
    for name in ("prefill", "prefill_chunk", "decode_step"):
        fn = getattr(JModel, name)
        mp.setattr(JModel, name, lambda self, *a, _fn=fn, **k: _fn(
            self, *a, **dict(k, compute_dtype=jnp.float32)))
    yield
    mp.undo()


# ---------------------------------------------------------------------------
# four gloo ranks, spawned once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks, started on the JAX package's parameters and a
    one-rank engine's snapshot: (processes, their queue, the inputs).
    The ranks work while the JAX engines run (``jax_runs``)."""
    _need_4()
    tmp = tmp_path_factory.mktemp("serve_tp")
    params = {a: _jax_params(a) for a in sorted({r[1] for r in R.RUNS})}
    one = R.engine(R.YI, params[R.YI], None, 2, R.CHUNK)
    inputs = {"params": params, "one_rank_snap": R.to_host(R.park(one)),
              "xlstm_2h_params": _jax_params_of(_jax_xlstm_2h())}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.run_rank,
                         args=(r, str(tmp / "pg"), str(tmp / "inputs.pkl"),
                               queue))
             for r in range(R.WORLD)]
    for p in procs:
        p.start()
    try:
        yield procs, queue, inputs
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)


@pytest.fixture(scope="module")
def jax_runs(spawned, f32_jax_engine):
    """Each scenario through the JAX Engine on a mesh of the same shape,
    from the same parameters: its streams and, per tick, free + in-use
    pages and each shard's ``serve_pages_in_use``."""
    out = {}
    for name, (arch, mesh, ds, chunk, strategy) in RUNS.items():
        eng = JEngine(jreg.smoke(arch),
                      JEngineConfig(**R.ECFG, dp_shards=ds,
                                    prefill_chunk=chunk),
                      strategy=STRATEGIES[strategy][1],
                      mesh=_jax_mesh(mesh),
                      params=spawned[2]["params"][arch])
        out[name] = R.drive(eng)
    out["xlstm_2h"] = R.drive(JEngine(
        _jax_xlstm_2h(), JEngineConfig(**R.ECFG), strategy=jbase.BASELINE,
        mesh=_jax_mesh("m4"), params=spawned[2]["xlstm_2h_params"]))
    return out


@pytest.fixture(scope="module")
def ranks(spawned, jax_runs):
    """Every rank's results, in rank order."""
    procs, queue, _ = spawned
    results = [queue.get(timeout=TIMEOUT_S) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    errors = [r["error"] for r in results if "error" in r]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * R.WORLD
    return sorted(results, key=lambda r: r["rank"])


# ---------------------------------------------------------------------------
# placement against the reference's serving builders
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _same_specs(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path, sh in w.items():
        assert g[path] == tuple(sh.spec), path


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("ds", [1, 2, 4])
@pytest.mark.parametrize("mesh", sorted(R.MESHES))
@pytest.mark.parametrize("arch", [R.YI, R.GRANITE, R.JAMBA, R.XLSTM])
def test_serving_placement_equals_the_reference(arch, mesh, ds, strategy):
    """Params, pool, block table, lengths and logits: the port's plain
    specs are the reference's resolved ``PartitionSpec``s (its serving
    step builders' ``in_shardings``), and the pool each rank allocates
    is its shard of them (less the data axes where the table is not
    split: every data rank then runs every slot)."""
    _need_4()
    ts, js = STRATEGIES[strategy]
    tcfg, jcfg = treg.smoke(arch), jreg.smoke(arch)
    layout = R.engine_config(ds).layout()
    jlayout = jsteps.PagedLayout(**dataclasses.asdict(layout))
    jm, n = _jax_mesh(mesh), R.ECFG["n_slots"]
    tm = Mesh(*R.MESHES[mesh])
    _same_specs(tsteps.serving_param_shardings(tcfg, ts, tm),
                jsteps._serving_param_shardings(jcfg, js, jm))
    _same_specs(tsteps.paged_cache_shardings(tcfg, layout, n, ts, tm),
                jsteps.paged_cache_shardings(jcfg, jlayout, n, js, jm))
    bt, ln = tsteps.paged_table_shardings(tm, layout, n)
    jbt, jln = jsteps._paged_table_shardings(jm, jlayout, n)
    assert (bt, ln) == (tuple(jbt.spec), tuple(jln.spec))
    shape = jbase.WorkloadShape("serve", "decode", R.ECFG["max_seq_len"], n)
    assert tsteps.logits_sharding(tcfg, n, ts, tm) == tuple(
        jsteps._logits_sharding(jcfg, shape, js, jm).spec)
    specs = tsteps.paged_cache_shardings(tcfg, layout, n, ts, tm)
    local = paging.pool_specs(tcfg, n, layout, tm, ts)
    for rank in range(4):
        rm = Mesh(*R.MESHES[mesh], rank=rank)
        pool = paging.init_pool(tcfg, n, layout, "meta", mesh=rm,
                                strategy=ts)
        for (path, t), (_, sp), (_, full) in zip(
                _leaves(pool), _leaves(local), _leaves(specs)):
            assert tuple(t.shape) == tshd.local_shape(
                _paging_shape(tcfg, layout, n, path), sp, rm), path
            if bt:          # the slots split: the pool as the reference
                assert sp == full, path


def _paging_shape(cfg, layout, n_slots, path):
    """The whole shape of the pool leaf at ``path``."""
    d = transformer.paged_cache_defs(cfg, n_slots, layout.n_pages,
                                     layout.page_size, layout.n_shards)
    for k in path:
        d = d[k]
    return d.shape


# ---------------------------------------------------------------------------
# the engines on ranks against the JAX engines on meshes of devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RUN_NAMES)
def test_greedy_streams_equal_the_jax_engine_on_the_same_mesh(
        ranks, jax_runs, name):
    """Every rank's float32 greedy streams are the JAX engine's on a mesh
    of the same shape, token for token (twins of the reference's
    ``test_paged_matches_contiguous_on_8dev_mesh`` and
    ``test_paged_matches_contiguous_dp_sharded_pool``)."""
    want = jax_runs[name][0]
    assert all(len(s) == R.NEW for s in want)
    for r in ranks:
        assert r[name]["streams"] == want, (r["rank"], name)
        st = r[name]["stats"]
        _, mesh, ds, chunk, _ = RUNS[name]
        assert st["mesh_shape"] == dict(zip(R.MESHES[mesh][1],
                                            R.MESHES[mesh][0]))
        assert st["dp_shards"] == ds
        assert (st["n_mixed_steps"] > 0) == (chunk > 0)


@pytest.mark.parametrize("name", RUN_NAMES)
def test_page_conservation_and_shard_gauges_equal_the_reference(
        ranks, jax_runs, name):
    """At every tick free plus in-use pages equal the usable pool (less
    one null page a shard), and each shard's ``serve_pages_in_use``
    equals the reference engine's at that tick (the twin of
    ``test_stats_page_conservation_dp_sharded``)."""
    _, _, ds, _, _ = RUNS[name]
    usable = R.engine_config(ds).layout().n_pages - ds
    want = jax_runs[name][1]
    assert all(total == usable for total, _ in want)
    for r in ranks:
        assert r[name]["ticks"] == want, (r["rank"], name)


def _holds_its_shards(ranks, name):
    """Every rank's params and pool shapes are its shards of the
    reference's resolved specs."""
    arch, mesh, ds, _, strategy = RUNS[name]
    cfg, st = treg.smoke(arch), STRATEGIES[strategy][0]
    layout = R.engine_config(ds).layout()
    defs = Model(cfg).param_defs()
    for r in ranks:
        tm = Mesh(*R.MESHES[mesh], rank=r["rank"])
        specs = tsteps.serving_param_shardings(cfg, st, tm)
        for (path, shape), (_, d), (_, sp) in zip(
                _leaves(r[name]["params"]), _leaves(defs), _leaves(specs)):
            assert shape == tshd.local_shape(d.shape, sp, tm), path
        local = paging.pool_specs(cfg, R.ECFG["n_slots"], layout, tm, st)
        for (path, shape), (_, sp) in zip(_leaves(r[name]["pool"]),
                                          _leaves(local)):
            assert shape == tshd.local_shape(
                _paging_shape(cfg, layout, R.ECFG["n_slots"], path), sp,
                tm), path


@pytest.mark.parametrize("name", ["yi_dm_ds2_l", "yi_m4_ds1_l",
                                  "yi_d4_ds4_l", "yi_fsdp_dm_ds2_l",
                                  "granite_dm_ds2_l"])
def test_each_rank_holds_its_shards(ranks, name):
    """The params and pool each rank holds are its shards of the
    reference's resolved specs (on (data 1, model 4) yi's KV heads stay
    whole; on data-split meshes each data rank holds its pages)."""
    _holds_its_shards(ranks, name)
    _, mesh, ds, _, _ = RUNS[name]
    layout = R.engine_config(ds).layout()
    kv = ranks[0][name]["pool"]["p0"]["k"]
    heads = {"dm": 1, "m4": 2, "d4": 2}[mesh]       # of yi's / granite's 2
    assert kv[3] == heads
    assert kv[1] == layout.n_pages // ds


@pytest.mark.parametrize("name", [n for n in RUN_NAMES
                                  if RUNS[n][0] in R.MIXERS])
def test_each_rank_holds_its_sequence_mixer_shards(ranks, name):
    """A hybrid's and an xLSTM's params and state rows are each rank's
    shards of the reference's specs: the Mamba channels, the mLSTM heads
    and conv channels split over ``model`` (one head a rank on m4), the
    state's slots over ``data`` where ``dp_shards`` matches it, the
    sLSTM's state whole."""
    _holds_its_shards(ranks, name)
    arch, mesh, ds, _, _ = RUNS[name]
    cfg = treg.smoke(arch)
    model = R.MESHES[mesh][0][1]
    slots = R.ECFG["n_slots"] // (ds if ds > 1 else 1)
    pool = ranks[0][name]["pool"]
    if arch == R.JAMBA:
        d_in = cfg.mamba.expand * cfg.d_model
        assert pool["p0"]["ssm"] == (cfg.n_repeats, slots, d_in // model,
                                     cfg.mamba.d_state)
        assert pool["p0"]["conv"][1:] == (slots, cfg.mamba.d_conv - 1,
                                          d_in // model)
    else:
        h = cfg.xlstm.n_heads
        dh = cfg.xlstm.expand * cfg.d_model // h
        assert pool["p0"]["C"] == (cfg.n_repeats, slots, h // model, dh, dh)
        assert pool["p3"]["c"] == (cfg.n_repeats, slots, cfg.d_model)


def test_snapshot_on_ranks_adopted_on_one_rank(spawned, ranks, jax_runs):
    """Parked on (data 2, model 2) after PARK_TICKS ticks: rank 0's
    snapshot holds every pool leaf whole and a one-rank engine finishes
    from it with the uninterrupted run's streams."""
    snap = ranks[0]["parked"]
    assert all(r["parked"] is None for r in ranks[1:])
    one = R.engine(R.YI, spawned[2]["params"][R.YI], None, 2, R.CHUNK)
    full = one.pool["p0"]["k"].shape
    assert snap["pool"]["p0"]["k"].shape == tuple(full)
    assert R.finish(one, R.from_host(snap)) == jax_runs["yi_dm_ds2_c"][0]


def test_hybrid_snapshot_on_ranks_adopted_on_one_rank(spawned, ranks,
                                                     jax_runs):
    """jamba parked on (data 2, model 2), ``dp_shards`` 2, after
    PARK_TICKS ticks: rank 0's snapshot holds every state row whole (the
    Mamba channels gathered over ``model``, the slots over ``data``) and
    a one-rank engine finishes from it with the JAX engine's streams on
    that mesh."""
    snap = ranks[0]["parked_jamba"]
    assert all(r["parked_jamba"] is None for r in ranks[1:])
    one = R.engine(R.JAMBA, spawned[2]["params"][R.JAMBA], None, 2)
    for key in one.pool:
        for n, t in one.pool[key].items():
            assert snap["pool"][key][n].shape == tuple(t.shape), (key, n)
    assert np.abs(snap["pool"]["p0"]["ssm"]).max() > 0
    assert R.finish(one, R.from_host(snap)) == jax_runs["jamba_dm_ds2_l"][0]


def test_one_rank_snapshot_adopted_on_ranks(ranks, jax_runs):
    """A one-rank engine's snapshot, adopted on (data 2, model 2) (each
    rank cutting its shards): every rank finishes with the
    uninterrupted run's streams."""
    for r in ranks:
        assert r["adopted"] == jax_runs["yi_dm_ds2_c"][0], r["rank"]


def test_indivisible_mixer_heads_compute_whole_on_ranks(ranks, jax_runs):
    """xlstm SMOKE with 2 heads on (data 1, model 4): the mLSTM blocks
    compute whole on every rank (weights gathered), reading and writing
    their conv state rows, which the pool still splits over ``model``
    (the reference's spec), while their C rows stay whole; every rank's
    float32 streams equal the JAX engine's on a (1, 4) mesh from the same
    parameters, token for token."""
    cfg = R.xlstm_2h()
    assert (dataclasses.asdict(cfg.xlstm)
            == dataclasses.asdict(_jax_xlstm_2h().xlstm))
    d_in = cfg.xlstm.expand * cfg.d_model
    want = jax_runs["xlstm_2h"][0]
    assert all(len(s) == R.NEW for s in want)
    for r in ranks:
        got = r["xlstm_2h"]
        assert got["streams"] == want, r["rank"]
        assert got["pool"]["p0"]["conv"][-1] == d_in // 4
        assert got["pool"]["p0"]["C"][2] == cfg.xlstm.n_heads


def test_sampled_streams_are_the_same_on_every_rank(ranks):
    hot = ranks[0]["hot"]
    assert all(len(s) == R.NEW for s in hot)
    assert all(r["hot"] == hot for r in ranks)


def test_graphs_and_sequence_mixers_on_a_model_axis_raise(ranks):
    """CUDA graphs on ranks raise; a sequence mixer on a ``model`` axis
    no longer does (its streams: the jamba and xlstm scenarios of
    ``test_greedy_streams_equal_the_jax_engine_on_the_same_mesh``)."""
    for r in ranks:
        kind, msg = r["graphs"]
        assert kind == "ValueError" and "gloo" in msg
        assert r["jamba"] is None

