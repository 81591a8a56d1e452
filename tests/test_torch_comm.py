"""The port's comm layer (``repro_torch.comm``, ``dist.mesh``, the
quantize kernels' plain versions, the data-parallel train step and its
checkpoints) against the JAX package's, on the CPU.

Four gloo ranks are spawned once for the module (``torch_comm_ranks``
holds what they run, and imports no JAX); every other test runs here.

Tolerances: the plain quantize and dequantize equal the JAX reference
bit for bit, and the Pallas kernel in interpret mode in every code (its
scale is amax x (1/127), one ulp off amax / 127 in some rows, see
``test_plain_quantize_matches_jax``).  ``sync_grads`` agrees with JAX's
at rtol 1e-6, atol 1e-7 (float32 sums of the same terms, in another
order where more than two meet).  Train steps in float32 agree with the
single-device step at 1e-4 relative (the gradients summed in another
order), and compressed steps with the JAX package's at 1e-5 (losses) and
1e-4 (grad norms); bucketed and monolithic syncs, and a resumed run and
the uninterrupted one, agree exactly.  The four ranks have 300 s to
finish (about 15 s here): a hung collective fails the module instead of
the run.
"""
import dataclasses
import inspect
import multiprocessing
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_comm_ranks as R  # noqa: E402
from repro import comm as jcomm  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.comm import collectives as jcoll  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.kernels.quantize import kernel as jqk  # noqa: E402
from repro.kernels.quantize import ref as jqref  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import PDef as JPDef  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.dist import mesh as dmesh  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.dist import steps as tsteps  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.quantize import ref as tqref  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

TIMEOUT_S = 300


def _jax_strategy(s):
    return jbase.ShardingStrategy(**dataclasses.asdict(s))


JTINY = jbase.ModelConfig(**{f.name: getattr(R.TINY, f.name) for f in
                             dataclasses.fields(R.TINY)
                             if f.name in {g.name for g in dataclasses.fields(
                                 jbase.ModelConfig)}})
JTCFG = jbase.TrainConfig(**dataclasses.asdict(R.TCFG))
JHIER, JCOMPRESSED = _jax_strategy(R.HIER), _jax_strategy(R.COMPRESSED)
SYNC_DEFS = {"w": ((8, 12), ("embed", "heads")), "b": ((5,), (None,)),
             "e": ((4, 6, 6), ("expert", None, "ff")),
             "big": ((300,), (None,))}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# four gloo ranks, spawned once
# ---------------------------------------------------------------------------


def _sync_inputs():
    rng = np.random.default_rng(1)
    params = jsteps.init_train_state(JTINY, JTCFG, jax.random.PRNGKey(0),
                                     JCOMPRESSED)["params"]
    return {"defs": SYNC_DEFS,
            "jax_params": jax.tree_util.tree_map(np.asarray,
                                                 jax.device_get(params)),
            "stacked": {k: rng.standard_normal((4,) + s).astype(np.float32)
                        for k, (s, _) in SYNC_DEFS.items()},
            "ef": {k: rng.standard_normal((2,) + s).astype(np.float32)
                   for k, (s, _) in SYNC_DEFS.items()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, in rank order."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = _sync_inputs()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.run_rank,
                         args=(r, str(tmp / "pg"), inputs, str(tmp / "ck"),
                               queue))
             for r in range(R.WORLD)]
    for p in procs:
        p.start()
    try:
        results = [queue.get(timeout=TIMEOUT_S) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    errors = [r["error"] for r in results if "error" in r]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * R.WORLD
    out = sorted(results, key=lambda r: r["rank"])
    out.append({"inputs": inputs, "ckpt": str(tmp / "ck")})
    return out


def _rank_results(ranks):
    return ranks[:R.WORLD]


# ---------------------------------------------------------------------------
# quantize: plain versions against the JAX reference and Pallas
# ---------------------------------------------------------------------------


def _quant_input(rows, block, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, block))
         * 10.0 ** rng.uniform(-6, 6, (rows, 1))).astype(np.float32)
    x[min(5, rows - 1)] = 0.0                   # zero block edge case
    if rows > 2 and block >= 6:
        # amax 127 gives scale 1: codes of x.5 are ties, rounded to even
        x[1] = rng.uniform(-100, 100, block)
        x[1, :6] = [127.0, 2.5, 3.5, -0.5, -1.5, 0.5]
    return x


@pytest.mark.parametrize("rows,block", [(37, 128), (300, 64), (9, 100),
                                        (4, 7), (1, 256)])
def test_plain_quantize_matches_jax(rows, block):
    x = _quant_input(rows, block, seed=rows)
    tc, ts = ops.quantize_int8(torch.from_numpy(x))
    jc, js = jqref.quantize_int8_ref(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    td = ops.dequantize_int8(tc, ts)
    np.testing.assert_array_equal(
        td.numpy(), np.asarray(jqref.dequantize_int8_ref(jc, js)))
    if rows > 2 and block >= 6:
        assert tc[1, :6].tolist() == [127, 2, 4, 0, -2, 0]
    # the Pallas kernel (interpret mode): the same codes; its scale is
    # amax x (1/127), within one ulp of amax / 127
    pc, ps = jqk.quantize_int8_kernel(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(ps), maxulp=1)
    pd = jqk.dequantize_int8_kernel(jnp.asarray(tc.numpy()),
                                    jnp.asarray(ts.numpy()), interpret=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(pd))
    # round trip within half a quantum per element
    assert np.all(np.abs(td.numpy() - x) <= 0.5 * ts.numpy()[:, None] + 1e-8)


def test_quantize_zero_block_roundtrips_exactly():
    z = torch.zeros(4, 64)
    codes, scales = ops.quantize_int8(z, impl="ref")
    assert bool((codes == 0).all()) and codes.dtype == torch.int8
    assert torch.equal(scales, torch.ones(4))
    assert torch.equal(ops.dequantize_int8(codes, scales, impl="ref"), z)


def test_quantize_on_cpu_launches_nothing_and_is_registered():
    build.reset_launches()
    x = torch.randn(8, 32)
    assert all(torch.equal(a, b) for a, b in zip(
        ops.quantize_int8(x), tqref.quantize_int8_ref(x, block=32)))
    assert all(n == 0 for n in build.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.quantize_int8(x, impl="cuda")
    with pytest.raises(ValueError):
        ops.quantize_int8(x.reshape(-1))
    assert "quantize.cu" in {p.name for p in build.CSRC.glob("*.cu")}
    assert {"quantize_int8_f32", "dequantize_int8_f32"} <= set(
        build.SIGNATURES)
    assert {"quantize", "dequantize"} <= set(build.LAUNCHES)


def test_error_feedback_converges_where_plain_rounding_stalls():
    """The JAX test's quadratic: one persistently large gradient entry
    sets the block's scale, every true gradient entry (0.3) sits below
    half a quantum, and plain int8 rounding never moves them; error
    feedback accumulates the rounded-away mass until it does."""
    block = 64
    t = np.full(block, 0.3, np.float32)
    lr = 0.2

    def grad(w):
        g = w - t
        g[0] = 100.0
        return g

    def quantized(g):
        deq, err = comm.compress_payload(torch.from_numpy(g), block)
        return deq.numpy(), err.numpy()

    w_plain = np.zeros(block, np.float32)
    w_ef = np.zeros(block, np.float32)
    carry = np.zeros(block, np.float32)
    avg = np.zeros(block, np.float64)
    for i in range(300):
        gq, _ = quantized(grad(w_plain.copy()))
        w_plain = w_plain - lr * gq
        w_plain[0] = 0.0
        gq, carry = quantized(grad(w_ef.copy()) + carry)
        w_ef = w_ef - lr * gq
        w_ef[0] = 0.0
        if i >= 200:
            avg += w_ef
    assert np.all(w_plain[1:] == 0.0)
    np.testing.assert_allclose(w_ef[1:], t[1:], atol=5e-2)
    np.testing.assert_allclose(avg[1:] / 100, t[1:], atol=5e-3)


# ---------------------------------------------------------------------------
# configs, mesh, topology, buckets, schema
# ---------------------------------------------------------------------------


def test_sharding_strategies_are_field_for_field_copies():
    tf = [(f.name, f.default) for f in
          dataclasses.fields(tbase.ShardingStrategy)]
    jf = [(f.name, f.default) for f in
          dataclasses.fields(jbase.ShardingStrategy)]
    assert tf == jf
    assert {k: dataclasses.astuple(v) for k, v in tbase.STRATEGIES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jbase.STRATEGIES.items()}


def test_mesh_is_pod_major_and_one_rank_needs_no_process_group():
    m = dmesh.Mesh((2, 2), ("pod", "data"), rank=2)
    assert m.shape == {"pod": 2, "data": 2} and m.size == 4
    assert m.coords == {"pod": 1, "data": 0}
    assert dmesh.data_axes(m) == ("pod", "data")
    assert dmesh.axis_size(m, ("pod", "data")) == 4
    assert dmesh.axis_size(m, ()) == 1
    with pytest.raises(RuntimeError, match="process group"):
        m.group("pod")                   # a descriptor has no groups
    one = dmesh.make_mesh((1, 1), ("data", "model"))
    assert one.size == 1 and one.group("data") is None
    with pytest.raises(ValueError, match="process group"):
        dmesh.make_mesh((2, 2), ("pod", "data"))
    assert dmesh._axis_rank_sets((2, 2), 0) == [[0, 2], [1, 3]]
    assert dmesh._axis_rank_sets((2, 2), 1) == [[0, 1], [2, 3]]


MESHES = [((2, 2, 2), ("pod", "data", "model")), ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model")), ((4, 2), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_topology_and_sync_bytes_match_jax(shape, axes):
    jm = jshd.make_mesh(shape, axes,
                        devices=jax.devices()[:int(np.prod(shape))])
    tm = dmesh.Mesh(shape, axes)
    jt, tt = jcomm.CommTopology.from_mesh(jm), comm.CommTopology.from_mesh(tm)
    assert [dataclasses.astuple(t) for t in tt.tiers] == \
        [dataclasses.astuple(t) for t in jt.tiers]
    assert (tt.has_pod_tier, tt.pod_size, tt.data_size) == \
        (jt.has_pod_tier, jt.pod_size, jt.data_size)
    for n in (1 << 20, 67_108_864, 1000):
        for hier, comp, block in ((False, False, 256), (True, False, 256),
                                  (True, True, 256), (True, True, 64)):
            kw = dict(hierarchical=hier, compress=comp, block=block)
            assert comm.estimate_sync_bytes(tt, n, **kw) == \
                jcomm.estimate_sync_bytes(jt, n, **kw)
        for comp in (False, True):
            assert comm.payload_bytes(n, compress=comp) == \
                jcomm.payload_bytes(n, compress=comp)
    kw = dict(n_tokens=4096, d_model=1024, n_experts=32, capacity=1280,
              top_k=8)
    for hier in (False, True):
        assert comm.estimate_a2a_bytes(tt, hierarchical=hier, **kw) == \
            jcomm.estimate_a2a_bytes(jt, hierarchical=hier, **kw)


@pytest.mark.parametrize("arch", ["tiny", "granite-moe-1b-a400m",
                                  "yi-6b"])
def test_partition_buckets_matches_jax(arch):
    if arch == "tiny":
        tcfg, jcfg = R.TINY, JTINY
    else:
        tcfg, jcfg = treg.smoke(arch), jreg.smoke(arch)
    tdefs, jdefs = Model(tcfg).param_defs(), JModel(jcfg).param_defs()
    for n in (1, 2, 3, 4, 7, 100):
        tb = comm.partition_buckets(tdefs, n)
        jb = jcomm.partition_buckets(jdefs, n)
        assert [dataclasses.astuple(b) for b in tb] == \
            [dataclasses.astuple(b) for b in jb], n
        assert [b.padded_elems(128) for b in tb] == \
            [b.padded_elems(128) for b in jb]
        sub = comm.bucketing.bucket_subtrees(tdefs, tdefs, tb)
        assert comm.bucketing.unbucket_leaves(sub, tdefs, tb) == tdefs


def test_residual_schema_matches_jax():
    for strat, jstrat in ((R.COMPRESSED, JCOMPRESSED), (R.HIER, JHIER)):
        tdefs = dict(_leaves(tsteps.train_state_defs(R.TINY, strat)))
        jdefs = dict(_leaves(jsteps.train_state_defs(JTINY, jstrat)))
        assert tdefs.keys() == jdefs.keys()
        for path, jd in jdefs.items():
            td = tdefs[path]
            assert (td.shape, td.axes, td.init) == \
                (jd.shape, jd.axes, jd.init), path
        tabs = tsteps.abstract_train_state(R.TINY, R.TCFG, strat)
        jabs = jsteps.abstract_train_state(JTINY, JTCFG, jstrat)
        assert [(p, tuple(t.shape)) for p, t in _leaves(tabs)] == \
            [(p, tuple(j.shape)) for p, j in _leaves(jabs)]
        assert ("comm" in tabs) == strat.compress_cross_pod
    pod = dmesh.Mesh((2, 2), ("pod", "data"), rank=3)
    state = tsteps.init_train_state(R.TINY, R.TCFG, device="cpu",
                                    strategy=R.COMPRESSED, mesh=pod)
    ef = P.tree_leaves(state["comm"])
    assert ef and all(t.shape[0] == 1 and not t.any() for t in ef)
    # the rows a rank holds are those the residual's resolved spec
    # gives it: its pod's on a mesh of two pods (pod coordinate 1 here),
    # every row on one rank
    pods4 = dataclasses.replace(R.COMPRESSED, compress_pods=4)
    for strat, rows in ((R.COMPRESSED, slice(1, 2)), (pods4, slice(2, 4))):
        leaf = P.tree_leaves(tsteps.abstract_train_state(
            R.TINY, R.TCFG, strat)["comm"])[0]
        full = torch.arange(float(leaf.shape[0])).view(
            (-1,) + (1,) * (leaf.dim() - 1)).expand(leaf.shape)
        spec = P.tree_leaves(tsteps.train_state_shardings(
            R.TINY, strat, pod)["comm"])[0]
        assert torch.equal(tshd.shard(full, spec, pod), full[rows])
    one = tsteps.init_train_state(R.TINY, R.TCFG, device="cpu",
                                  strategy=R.COMPRESSED)
    assert all(t.shape[0] == 2 for t in P.tree_leaves(one["comm"]))


# ---------------------------------------------------------------------------
# fallback semantics (resolve_policy and the step build, no collectives)
# ---------------------------------------------------------------------------


def _fallbacks(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w
                 if issubclass(x.category, (comm.CommFallbackWarning,
                                            jcomm.CommFallbackWarning))]


@pytest.mark.parametrize("case", ["podless", "pod-mismatch", "ok"])
def test_resolve_policy_matches_jax(case):
    shape, axes = ((2, 4), ("data", "model")) if case == "podless" \
        else ((2, 2, 2), ("pod", "data", "model"))
    strat = (dataclasses.replace(R.COMPRESSED, compress_pods=4)
             if case == "pod-mismatch" else R.COMPRESSED)
    jm = jshd.make_mesh(shape, axes, devices=jax.devices()[:8])
    tp, tw = _fallbacks(lambda: comm.resolve_policy(
        strat, dmesh.Mesh(shape, axes)))
    jp, jw = _fallbacks(lambda: jcomm.resolve_policy(_jax_strategy(strat),
                                                     jm))
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    assert tw == jw and len(tw) == (0 if case == "ok" else 1)
    if case == "pod-mismatch":
        assert tp.hierarchical and not tp.compress


def test_comm_strict_raises_instead_of_falling_back():
    strict = dataclasses.replace(R.HIER, comm_strict=True)
    with pytest.raises(comm.CommTopologyError, match="pod tier"):
        tsteps.build_train_step(R.TINY, R.TCFG, R.SHAPE, strategy=strict,
                                mesh=dmesh.Mesh((4,), ("data",)))
    with pytest.raises(comm.CommTopologyError, match="divide"):
        tsteps.build_train_step(
            R.TINY, R.TCFG, tbase.WorkloadShape("odd", "train", 16, 6),
            strategy=strict, mesh=dmesh.Mesh((2, 2), ("pod", "data")))
    # one device: the single-device mesh has no pod tier either
    with pytest.raises(comm.CommTopologyError):
        tsteps.build_train_step(R.TINY, R.TCFG, R.SHAPE, strategy=strict)
    tsteps.build_train_step(R.TINY, R.TCFG, R.SHAPE, strategy=strict,
                            mesh=dmesh.Mesh((2, 2), ("pod", "data")))
    # a model axis builds (tensor parallelism: tests/test_torch_tp.py)
    tsteps.build_train_step(R.TINY, R.TCFG, R.SHAPE,
                            mesh=dmesh.Mesh((2, 2), ("data", "model")))


# ---------------------------------------------------------------------------
# sync_grads against the JAX package's, on the same stacked input
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_shard_map_compat(monkeypatch):
    """The reference passes ``check_rep=`` to ``jax.shard_map``; jax
    versions whose shard_map takes ``check_vma`` instead reject it
    (ROADMAP Queue 3).  For this comparison only, the reference's call
    goes through a shim that renames the flag; the reference's source
    is untouched."""
    real = jcoll._shard_map
    if "check_rep" not in inspect.signature(real).parameters:
        def compat(f, **kw):
            kw["check_vma"] = kw.pop("check_rep")
            return real(f, **kw)
        monkeypatch.setattr(jcoll, "_shard_map", compat)


def _jax_sync(inputs, strategy):
    mesh = jshd.make_mesh((2, 2, 2), ("pod", "data", "model"),
                          devices=jax.devices()[:8])
    defs = {k: JPDef(s, a) for k, (s, a) in inputs["defs"].items()}
    policy = jcomm.resolve_policy(strategy, mesh)
    stacked = {k: jnp.asarray(v) for k, v in inputs["stacked"].items()}
    ef = ({k: jnp.asarray(v) for k, v in inputs["ef"].items()}
          if policy.compress else None)
    synced, new_ef = jcomm.sync_grads(stacked, defs, mesh, policy, strategy,
                                      residual=ef)
    return (jax.device_get(synced),
            jax.device_get(new_ef) if ef is not None else None)


# The JAX package quantizes what each device holds of a leaf, so under
# tensor or expert parallelism its int8 blocks follow the model-axis
# shards.  The port's ranks hold whole leaves (it has no model axis):
# the same blocks as the JAX package with both turned off.
JAX_SIDE = {"hier": JHIER,
            "hier-int8": dataclasses.replace(
                JCOMPRESSED, tensor_parallel=False, expert_parallel=False)}


@pytest.mark.parametrize("name", ["hier", "hier-int8"])
def test_sync_grads_matches_jax(ranks, jax_shard_map_compat, name):
    inputs = ranks[-1]["inputs"]
    j_synced, j_ef = _jax_sync(inputs, JAX_SIDE[name])
    for res in _rank_results(ranks):
        got = res["sync"][name]
        for k in SYNC_DEFS:
            np.testing.assert_allclose(got["synced"][k], j_synced[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            if name == "hier-int8":
                pod = res["sync"]["pod"]
                np.testing.assert_allclose(got["ef"][k][0], j_ef[k][pod],
                                           rtol=1e-6, atol=1e-7, err_msg=k)
        if name == "hier":
            # the flat-mean identity
            for k in SYNC_DEFS:
                np.testing.assert_allclose(
                    got["synced"][k], inputs["stacked"][k].mean(0),
                    rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["hier-int8", "hier-int8-zero-ef"])
def test_compressed_sync_error_is_bounded_and_tracked(ranks, name):
    """The JAX test's identities: what the pods sent (their pod-mean
    payloads plus their residual rows) is off the synced sum by at most
    one quantum per block, and the new residuals hold exactly what the
    wire dropped."""
    inputs = ranks[-1]["inputs"]
    res = _rank_results(ranks)
    ef_new = {r["sync"]["pod"]: r["sync"][name]["ef"] for r in res}
    for k in SYNC_DEFS:
        g = inputs["stacked"][k]
        ef_old = inputs["ef"][k] if name == "hier-int8" else 0.0 * \
            inputs["ef"][k]
        payload = g.reshape((2, 2) + g.shape[1:]).mean(1) + ef_old
        want = payload.sum(0) / 2
        synced = res[0]["sync"][name]["synced"][k]
        assert np.abs(synced - want).max() < \
            2 * np.abs(payload).max() / 127 + 1e-6
        assert np.abs(ef_new[0][k]).max() > 0
        np.testing.assert_allclose(ef_new[0][k][0] + ef_new[1][k][0],
                                   payload.sum(0) - 2 * synced, rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the data-parallel train step against the single-device one
# ---------------------------------------------------------------------------


def _single_device(shape=R.SHAPE, grad_accum=R.WORLD, n_steps=R.N_STEPS):
    tcfg = dataclasses.replace(R.TCFG, grad_accum=grad_accum)
    tr = Trainer(R.TINY, tcfg, shape, device="cpu")
    tr.run(n_steps, log_every=0)
    return tr.history


def _assert_histories(got, want, rtol):
    assert len(got) == len(want)
    for k in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in got], [h[k] for h in want],
                                   rtol=rtol, err_msg=k)


def _same_on_every_rank(ranks, key):
    hs = [r[key] if key == "from_jax" else r[key]["history"]
          for r in _rank_results(ranks)]
    assert all(h == hs[0] for h in hs), key
    return hs[0]


def test_hier_train_step_matches_single_device_grad_accum(ranks):
    hier = _same_on_every_rank(ranks, "hier")
    _assert_histories(hier, _single_device(), 1e-4)
    assert all(r["hier"]["syncs"] == R.N_STEPS and r["hier"]["warnings"] == 0
               for r in _rank_results(ranks))


def test_hier_step_with_grad_accum_averages_every_chunk(ranks):
    """grad_accum 2 on four ranks: rank r takes row r of each 4-row
    microbatch, and the step is one device's over the same 8 one-row
    chunks."""
    got = _same_on_every_rank(ranks, "hier_ga2")
    _assert_histories(got, _single_device(grad_accum=8), 1e-4)


def test_compressed_train_steps_match_jax(ranks, jax_shard_map_compat):
    """Three compressed steps from the same parameters and batches in
    both packages: the JAX step on the (2, 2, 2) mesh (tensor and expert
    parallelism off, so its int8 blocks are cut from whole leaves as the
    port's are), the port's on four ranks.  Which rows each pod owns
    decides what each pod quantizes, so this holds the port's chunk
    order to the JAX package's (accum, pod, data): ranks taking their
    rows data-major miss by 5e-4.  Losses at 1e-5 relative, grad norms
    at 1e-4: the two float32 gradients differ in their last bits, which
    can move a code by one where a value sits on a rounding boundary."""
    from repro.data import synthetic_batch
    mesh = jshd.make_mesh((2, 2, 2), ("pod", "data", "model"),
                          devices=jax.devices()[:8])
    strat = JAX_SIDE["hier-int8"]
    jshape = jbase.WorkloadShape(**dataclasses.asdict(R.SHAPE))
    jitted, sshard, bshard = jsteps.jit_train_step(JTINY, JTCFG, strat, mesh,
                                                   jshape)
    state = jsteps.init_train_state(JTINY, JTCFG, jax.random.PRNGKey(0),
                                    strat)
    state = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, s), state,
                                   sshard)
    want = []
    for step in range(R.N_STEPS):
        batch = {k: jax.device_put(v, bshard[k]) for k, v in
                 synthetic_batch(JTINY, jshape, 0, step).items()}
        state, m = jitted(state, batch)
        want.append({k: float(m[k]) for k in ("loss", "xent", "grad_norm")})
    got = _same_on_every_rank(ranks, "from_jax")
    for k, tol in (("loss", 1e-5), ("xent", 1e-5), ("grad_norm", 1e-4)):
        np.testing.assert_allclose([h[k] for h in got], [h[k] for h in want],
                                   rtol=tol, err_msg=k)


def test_compressed_step_updates_residual_and_trains(ranks):
    comp = _same_on_every_rank(ranks, "compressed")
    hier = _same_on_every_rank(ranks, "hier")
    assert comp[0]["loss"] == hier[0]["loss"]       # before any sync
    assert comp[-1]["loss"] < comp[0]["loss"]
    _assert_histories(comp, hier, 1e-2)
    res = _rank_results(ranks)
    for r in res:
        ef = [a for _, a in _leaves(r["compressed"]["ef"])]
        assert all(a.shape[0] == 1 for a in ef)        # its pod's row
        assert any(np.abs(a).max() > 0 for a in ef)
    # the two data ranks of a pod hold the same row; the pods differ
    for a, b in ((0, 1), (2, 3)):
        for (_, x), (_, y) in zip(_leaves(res[a]["compressed"]["ef"]),
                                  _leaves(res[b]["compressed"]["ef"])):
            np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(
        _leaves(res[0]["compressed"]["ef"]),
        _leaves(res[2]["compressed"]["ef"])))


def test_podless_mesh_warns_once_and_syncs_flat(ranks):
    hier = _same_on_every_rank(ranks, "podless_hier")
    flat = _same_on_every_rank(ranks, "podless_flat")
    for r in _rank_results(ranks):
        assert r["podless_hier"]["warnings"] == 1
        assert r["podless_flat"]["warnings"] == 0
        assert r["podless_hier"]["syncs"] == 0
    assert hier == flat
    # the flat all-reduce mean is the single-device mean
    _assert_histories(flat, _single_device(n_steps=2), 1e-4)


def test_indivisible_batch_falls_back_to_flat_sync(ranks):
    odd = tbase.WorkloadShape("odd", "train", 16, 6)
    got = _same_on_every_rank(ranks, "indivisible")
    for r in _rank_results(ranks):
        assert r["indivisible"]["warnings"] == 1
        assert r["indivisible"]["syncs"] == 0
    # rows split 1, 2, 1, 2 over the ranks, weighted by their count
    _assert_histories(got, _single_device(odd, grad_accum=1, n_steps=2),
                      1e-4)


# ---------------------------------------------------------------------------
# checkpoints with the residual
# ---------------------------------------------------------------------------


def test_checkpoint_on_ranks_resumes_like_the_uninterrupted_run(ranks):
    for r in _rank_results(ranks):
        ck = r["checkpoint"]
        assert ck["how"] == "resumed" and ck["start"] == 2
        assert ck["resumed"] == ck["whole"][2:]
        assert ck["same_state"]
    # on disk: the whole (pods, ...) residual, in a format both read
    path = tckpt.CheckpointManager(ranks[-1]["ckpt"])._step_path(2)
    back = tckpt.restore_state(
        tsteps.abstract_train_state(R.TINY, R.TCFG, R.COMPRESSED), path)
    ef = P.tree_leaves(back["comm"])
    assert all(t.shape[0] == 2 for t in ef)
    assert any(bool(t[0].ne(t[1]).any()) for t in ef)
    jback = jckpt.restore_state(
        jsteps.abstract_train_state(JTINY, JTCFG, JCOMPRESSED), path)
    for (p, a), (_, b) in zip(_leaves(back), _leaves(jback)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), err_msg=p)


def test_jax_checkpoint_with_residual_restores_into_the_port(tmp_path):
    state = jsteps.init_train_state(JTINY, JTCFG, jax.random.PRNGKey(0),
                                    JCOMPRESSED)
    rng = np.random.default_rng(3)
    state["comm"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        state["comm"])
    mgr = jckpt.CheckpointManager(str(tmp_path / "j"))
    mgr.save(state, 5)
    mgr.wait()
    template = tsteps.abstract_train_state(R.TINY, R.TCFG, R.COMPRESSED)
    got, step = tckpt.CheckpointManager(
        str(tmp_path / "j")).restore_latest(template)
    assert step == 5
    for (p, a), (_, b) in zip(_leaves(got), _leaves(jax.device_get(state))):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), err_msg=p)
    # a rank of a (pod, data) mesh takes its pod's row
    pod = dmesh.Mesh((2, 2), ("pod", "data"), rank=3)
    specs = {"/".join(k): s for k, s in _leaves(
        tsteps.train_state_shardings(R.TINY, R.COMPRESSED, pod))}
    rows = tckpt.restore_state(
        template, tckpt.CheckpointManager(str(tmp_path / "j"))._step_path(5),
        local=lambda key, t: tshd.shard(t, specs[key], pod))
    for (_, a), (_, b) in zip(_leaves(rows["comm"]),
                              _leaves(jax.device_get(state["comm"]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[1:2])
    # a checkpoint from before the residual existed starts it at zero
    plain = jsteps.init_train_state(JTINY, JTCFG, jax.random.PRNGKey(0))
    jckpt.save_state(plain, str(tmp_path / "old"))
    old = tckpt.restore_state(template, str(tmp_path / "old"))
    assert all(not t.any() for t in P.tree_leaves(old["comm"]))
    # any other leaf must be there
    template["params"]["extra"] = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="extra: missing"):
        tckpt.restore_state(template, str(tmp_path / "old"))
