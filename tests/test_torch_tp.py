"""The port's sharded train step (tensor, expert and FSDP parallelism
placed by the rule tables, hierarchical MoE dispatch) against the JAX
package, on the CPU.

Four gloo ranks are spawned once for the module (``torch_tp_ranks``
holds what they run, and imports no JAX), each on two intra-op threads;
the JAX side runs here, on the devices ``tests/conftest.py`` forces.

Tolerances:

* shard shapes and the slice each rank holds equal the reference's
  ``train_state_shardings`` exactly;
* two sharded float32 steps agree with the reference's single-device
  step at the tolerances of ``tests/test_torch_train.py::
  test_trainer_matches_jax_train_step_for_five_steps``: losses (and
  xent, moe_aux) at rtol 1e-4, grad norms at rtol 1e-3, every updated
  leaf gathered whole at rtol = atol = 1e-4 (float32 sums of the same
  terms in another order: the row-parallel and vocab-parallel sums);
* the int8 cross-pod sync against the uncompressed reference (at lr
  1e-3, ``torch_tp_ranks.TCFG`` says why): losses and grad norms at
  int8's 1e-2 relative; its leaves at rtol 1e-2 and atol ``2 * lr *
  N_STEPS``: AdamW's first steps normalize each element's gradient to
  about +-1, so a compressed element whose sign moved can move its
  weight by up to 2 lr a step, whatever its gradient's error;
* hierarchical MoE equals flat at atol 1e-6, rtol 0 (outputs, in one
  process and on ranks), the dropped fraction exactly, gradients at
  rtol 1e-5, atol 1e-6 (the reference's ``tests/test_moe.py``); against
  the JAX package's MoE (einsums where the port runs grouped products)
  at atol 1e-5;
* checkpoints: a resumed or remeshed run equals the uninterrupted one at
  rtol 1e-4;
* the sequence mixers' blocks on (data 2, model 2) and (data 1, model
  4) (Mamba channels and mLSTM heads over ``model`` through the
  in-projection's u/z exchange, the sLSTM's recurrence whole on every
  rank) against the same block whole, forward and every gradient, at
  rtol 1e-5, atol 1e-6; the exchange alone exactly.

The four ranks have 300 s to finish (about 40 s here; the JAX references
beside them take about 80, jamba's and xlstm's 45 of it): a hung
collective fails the module instead of the run.
"""
import dataclasses
import functools
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from repro import comm as jcomm  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data import DataPipeline as JDataPipeline  # noqa: E402
from repro.dist import actsharding as jact  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.dist import actsharding as tact  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.dist import steps as tsteps  # noqa: E402
from repro_torch.dist.mesh import Mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

TIMEOUT_S = 300
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 1, 2), ("pod", "data", "model")),
          "d4": ((4, 1), ("data", "model")),
          "pd": ((2, 2, 1), ("pod", "data", "model")),
          "m4": ((1, 4), ("data", "model"))}
STRATEGIES = {"baseline": tbase.BASELINE, "optimized": tbase.OPTIMIZED,
              "zero3": tbase.ZERO3, "hier-moe-int8": R.HIER_INT8}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax(x):
    """A port config or strategy as the JAX package's dataclass."""
    cls = getattr(jbase, type(x).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(x).items()
                  if k in names and not isinstance(v, dict)},
               **({"moe": jbase.MoEConfig(**dataclasses.asdict(x.moe))}
                  if getattr(x, "moe", None) is not None else {}))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _jax_params(arch):
    init = jax.jit(lambda key: jsteps.init_train_state(
        jreg.smoke(arch), _jax(R.TCFG), key)["params"])
    return jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(init(jax.random.PRNGKey(0))))


def _block_inputs():
    """Each mixer block's whole float32 params (the port's draw, every
    zero-initialised leaf redrawn: a zero bias tests nothing), its input
    and its output's cotangent; and a (B, S, 2 d) input of
    ``split_halves`` (d = 16, so every block of it is 4 or 8 wide on
    ranks) with its cotangent."""
    from repro_torch.models import transformer
    rng = np.random.default_rng(7)
    out = {}
    for case in R.BLOCKS:
        cfg, kind = R.block_cfg(case)
        defs = transformer.position_defs(cfg, cfg.block_pattern.index(kind))
        full = P.init_params(defs[kind], torch.Generator().manual_seed(7),
                             torch.float32, "cpu")
        full = P.tree_map(lambda t: (t if t.abs().max() > 0 else torch.as_tensor(
            0.1 * rng.standard_normal(t.shape), dtype=t.dtype)).numpy(), full)
        x, dy = (rng.standard_normal(R.BLOCK_X + (cfg.d_model,)).astype(
            np.float32) for _ in range(2))
        out[case] = (full, x, dy)
    halves = tuple(rng.standard_normal(R.BLOCK_X + (32,)).astype(np.float32)
                   for _ in range(2))
    return out, halves


def _moe_inputs():
    cfg = treg.smoke(R.GRANITE)
    params = JP.init_params(jmoe.moe_defs(jreg.smoke(R.GRANITE)),
                            jax.random.PRNGKey(2), jnp.float32)
    x = np.random.default_rng(3).standard_normal(
        R.A2A_X + (cfg.d_model,)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, params), x


# ---------------------------------------------------------------------------
# four gloo ranks, spawned once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks, started on the JAX package's initial parameters:
    (processes, their queue, the inputs, the temporary directory).  The
    ranks work while the JAX references run (``jax_runs``); ``ranks``
    collects them."""
    tmp = tmp_path_factory.mktemp("tp")
    moe_params, moe_x = _moe_inputs()
    blocks, halves = _block_inputs()
    inputs = {"params": {a: _jax_params(a)
                         for a in sorted({r[1] for r in R.RUNS})},
              "moe_params": moe_params, "moe_x": moe_x,
              "blocks": blocks, "halves": halves}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.run_rank,
                         args=(r, str(tmp / "pg"), str(tmp / "inputs.pkl"),
                               str(tmp / "ck"), queue))
             for r in range(R.WORLD)]
    for p in procs:
        p.start()
    try:
        yield procs, queue, inputs, tmp
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)


@pytest.fixture(scope="module")
def ranks(spawned, jax_runs):
    """Every rank's results, in rank order, then the inputs."""
    procs, queue, inputs, tmp = spawned
    results = [queue.get(timeout=TIMEOUT_S) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    errors = [r["error"] for r in results if "error" in r]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * R.WORLD
    out = sorted(results, key=lambda r: r["rank"])
    out.append({"inputs": inputs, "ckpt": str(tmp / "ck")})
    return out


# the reference run each sharded run is held to: key -> (arch,
# grad_accum), at the ranks' train config.  A dense model's loss is a mean over tokens, so
# yi's shards equal one step over the whole batch; a MoE layer's aux loss
# is a product of means over its rows, so granite's equal grad_accum =
# its number of batch shards (the reference's per-chunk step averages
# them so too)
REFERENCES = {"yi": (R.YI, 1), "granite2": (R.GRANITE, 2),
              "granite4": (R.GRANITE, 4), "whisper": (R.WHISPER, 1),
              "jamba2": (R.JAMBA, 2), "xlstm": (R.XLSTM, 1)}
RUN_REFERENCE = {"yi_baseline": "yi", "yi_optimized": "yi",
                 "yi_zero3": "yi", "yi_zero3_dm": "yi",
                 "yi_optimized_pod": "yi", "yi_optimized_pod_int8": "yi",
                 "granite_baseline": "granite2",
                 "granite_zero3_dm": "granite4", "granite_hier": "granite2",
                 "granite_hier_int8": "granite2",
                 "whisper_baseline": "whisper", "whisper_zero3": "whisper",
                 "jamba_baseline": "jamba2", "jamba_optimized": "jamba2",
                 "xlstm_baseline": "xlstm"}
INT8_RUNS = ("yi_optimized_pod_int8", "granite_hier_int8")


@pytest.fixture(scope="module")
def jax_runs(spawned):
    """The reference's single-device Trainer, N_STEPS from the same
    parameters and batches (``REFERENCES``)."""
    out = {}
    for key, (arch, ga) in REFERENCES.items():
        jtcfg = dataclasses.replace(_jax(R.TCFG), grad_accum=ga)
        jtr = JTrainer(jreg.smoke(arch), jtcfg, _jax(R.SHAPE),
                       make_local_mesh(1, 1))
        jtr.init_or_resume()
        jtr.state["params"] = jax.tree_util.tree_map(
            jnp.asarray, spawned[2]["params"][arch])
        # the Trainer's own loop, keeping every metric of the step
        pipe = JDataPipeline(jtr.cfg, jtr.shape, seed=jtr.seed)
        hist = []
        try:
            for _ in range(R.N_STEPS):
                jtr.state, m = jtr._jit_step(jtr.state,
                                             jtr._put_batch(next(pipe)))
                hist.append({k: float(m[k]) for k in
                             ("loss", "xent", "moe_aux", "grad_norm")})
        finally:
            pipe.close()
        out[key] = {"history": hist,
                     "params": jax.device_get(jtr.state["params"])}
    return out


def _rank_results(ranks):
    return ranks[:R.WORLD]


# ---------------------------------------------------------------------------
# placement: each rank's shards against the reference's shardings
# ---------------------------------------------------------------------------


def _jax_mesh(name):
    shape, axes = MESHES[name]
    return jshd.make_mesh(shape, axes, devices=jax.devices()[:4])


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [R.YI, R.GRANITE, R.JAMBA, R.XLSTM])
def test_shards_equal_the_reference_train_state_shardings(arch, mesh,
                                                          strategy):
    """Each rank's init holds, of every parameter, optimizer and residual
    leaf, the slice the reference's ``NamedSharding`` gives its device
    (devices laid out row-major, as the port's ranks), drawn from the
    same generator as a one-rank init."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX devices (conftest forces 8)")
    cfg, st = treg.smoke(arch), STRATEGIES[strategy]
    tcfg = R.TCFG
    jm = _jax_mesh(mesh)
    want = jsteps.train_state_shardings(_jax(cfg), _jax(st), jm)
    whole = tsteps.init_train_state(cfg, tcfg, torch.Generator().manual_seed(5),
                                    "cpu", strategy=st)
    devices = list(jm.devices.flat)
    for rank in range(4):
        tm = Mesh(*MESHES[mesh], rank=rank)
        got = tsteps.init_train_state(cfg, tcfg,
                                      torch.Generator().manual_seed(5),
                                      "cpu", strategy=st, mesh=tm)
        specs = tsteps.train_state_shardings(cfg, st, tm)
        for (path, jsh), (_, t), (_, full), (_, spec) in zip(
                _leaves({k: want[k] for k in got}), _leaves(got),
                _leaves(whole), _leaves(specs)):
            assert tuple(jsh.spec) + (None,) * (t.dim() - len(jsh.spec)) \
                == tuple(spec) + (None,) * (t.dim() - len(spec)), path
            idx = jsh.devices_indices_map(tuple(full.shape))[devices[rank]]
            assert tuple(t.shape) == tuple(
                jsh.shard_shape(tuple(full.shape))), path
            assert tuple(t.shape) == tshd.local_shape(full.shape, spec, tm)
            assert torch.equal(t, full[idx]), path


def test_w_in_spec_and_shard_of_the_reference_case():
    """tests/test_dist.py's case: yi's mlp ``w_in`` under ``optimized``
    on (data 2, model 2) is ``(None, "data", "model")`` once stacked, and
    each rank holds a quarter of it."""
    cfg, tm = treg.smoke(R.YI), Mesh((2, 2), ("data", "model"), rank=3)
    spec = tsteps.train_state_shardings(cfg, tbase.OPTIMIZED, tm)[
        "params"]["blocks"]["p0"]["mlp"]["w_in"]
    assert spec == (None, "data", "model")
    full = torch.arange(2 * 64 * 128.).reshape(2, 64, 128)
    assert torch.equal(tshd.shard(full, spec, tm), full[:, 32:, 64:])


# ---------------------------------------------------------------------------
# the sharded step against the reference's single-device step
# ---------------------------------------------------------------------------


def _assert_run(res, want, rtol, leaf_rtol, leaf_atol):
    for key, ktol in (("loss", rtol), ("xent", rtol), ("moe_aux", rtol),
                      ("grad_norm", 10 * rtol if rtol < 1e-3 else rtol)):
        got = [h[key] for h in res["history"]]
        np.testing.assert_allclose(got, [float(h[key]) for h in
                                         want["history"]],
                                   rtol=ktol, atol=1e-7, err_msg=key)
    for (path, a), (_, b) in zip(_leaves(res["params"]),
                                 _leaves(want["params"])):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   rtol=leaf_rtol, atol=leaf_atol,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", [n for n, *_ in R.RUNS
                                  if n not in INT8_RUNS])
def test_sharded_steps_equal_the_reference_single_device_step(
        ranks, jax_runs, name):
    res = _rank_results(ranks)
    for r in res:
        assert r[name]["history"] == res[0][name]["history"]
    _assert_run(res[0][name], jax_runs[RUN_REFERENCE[name]], 1e-4, 1e-4,
                1e-4)


@pytest.mark.parametrize("name", INT8_RUNS)
def test_compressed_hierarchical_step_is_within_int8_of_the_reference(
        ranks, jax_runs, name):
    res = _rank_results(ranks)[0][name]
    _assert_run(res, jax_runs[RUN_REFERENCE[name]], 1e-2, 1e-2,
                2 * R.TCFG.learning_rate * R.N_STEPS)
    # int8 crossed the pod group: fewer pod bytes than the float32 run's
    f32 = _rank_results(ranks)[0][name[:-len("_int8")]]["bytes"]["pod"]
    assert 0 < res["bytes"]["pod"] < f32


def test_each_run_moves_bytes_on_the_axes_it_shards(ranks):
    """Tensor parallelism talks over ``model``, a data axis over
    ``data`` (the ZeRO-1 gather and the gradient sum), hierarchical
    dispatch over ``pod``; ``optimized`` on a pod-less mesh warns once
    and syncs flat."""
    r = _rank_results(ranks)[0]
    assert r["yi_baseline"]["bytes"]["model"] > 0
    assert r["yi_baseline"]["bytes"]["data"] > 0
    assert "model" not in r["yi_zero3"]["bytes"]
    assert r["granite_hier"]["bytes"]["pod"] > 0
    assert "data" not in r["granite_hier"]["bytes"]
    assert r["yi_optimized"]["warnings"] == 1
    assert r["yi_baseline"]["warnings"] == 0


def test_optimizer_state_is_zero1_sharded_over_data(ranks):
    r = _rank_results(ranks)[0]
    wq = lambda s: s["blocks"]["p0"]["attn"]["wq"]
    shapes = r["yi_baseline"]["shapes"]
    # params: heads over model; their moments also embed over data
    assert wq(shapes["params"]) == (2, 64, 32)
    assert wq(shapes["opt"]["m"]) == (2, 32, 32)
    # zero3 on (data 4, model 1): embed over data for both
    z = r["yi_zero3"]["shapes"]
    assert wq(z["params"]) == wq(z["opt"]["v"]) == (2, 16, 64)


# ---------------------------------------------------------------------------
# the sequence mixers' blocks on ranks against the same blocks whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["dm", "m4"])
def test_split_halves_on_ranks_regroups_the_columns(ranks, mesh):
    """``layers.split_halves`` on ranks: each rank's contiguous columns of
    ``[u | z]`` become ``[u_r | z_r]`` (the forward, gathered over
    ``model``), and the gradient goes back to the columns it came from
    (the reverse exchange).  Rank 0 keeps u's block 0 and sends its
    other block (u's 1) away, and on the way back keeps u_0's gradient
    and sends z_0's: 2 blocks of d / n columns moved in all."""
    whole, dy = ranks[-1]["inputs"]["halves"]
    n, d = MESHES[mesh][0][1], whole.shape[-1] // 2
    w = d // n
    order = np.concatenate([np.r_[r * w:(r + 1) * w, d + r * w:d + (r + 1) * w]
                            for r in range(n)])
    got = _rank_results(ranks)[0]["blocks"][(mesh, "halves")]
    np.testing.assert_array_equal(got["uz"], whole[..., order])
    want = np.empty_like(dy)
    want[..., order] = dy
    np.testing.assert_array_equal(got["grad"], want)
    rows = whole.shape[0] * whole.shape[1]
    assert got["model_bytes"] == 2 * rows * w * 4


@pytest.mark.parametrize("case", list(R.BLOCKS))
@pytest.mark.parametrize("mesh", ["dm", "m4"])
def test_mixer_blocks_on_ranks_equal_the_block_whole(ranks, mesh, case):
    """A Mamba block (its ``in_proj`` halves exchanged over ``model``,
    ``x_proj`` and ``out_proj`` row-parallel), an mLSTM block (the rank's
    heads, one a rank on m4; its gates reduced, then cut by head) and an
    sLSTM block (``w`` and ``r`` gathered, the recurrence whole on every
    rank, its FFN column- then row-parallel) on each mesh of ranks, and
    a Mamba block of 130 channels and an mLSTM block of 2 heads, which
    split on model 2 and compute whole on model 4 (the leaves the spec
    split gathered): the output, the input's gradient and every
    parameter's gradient gathered whole equal the block run whole in
    this process (float32 sums in another order: rtol 1e-5, atol 1e-6).
    Where the block splits, rank 0's ``model`` bytes hold at least the
    exchange of ``in_proj``'s (or ``up_proj``'s) halves forward and
    back."""
    from repro_torch.models import transformer
    full, x, dy = ranks[-1]["inputs"]["blocks"][case]
    cfg, kind = R.block_cfg(case)
    p = P.tree_map(lambda t: t.requires_grad_(True), P.from_numpy(full))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = transformer.MIXERS[kind](cfg, p, xt)
    (y * torch.from_numpy(dy)).sum().backward()
    got = _rank_results(ranks)[0]["blocks"][(mesh, case)]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["y"], y.detach().numpy(), **tol)
    np.testing.assert_allclose(got["dx"], xt.grad.numpy(), **tol)
    for (path, a), (_, b) in zip(_leaves(got["grads"]),
                                 _leaves(P.tree_map(lambda t: t.grad, p))):
        np.testing.assert_allclose(a, b.numpy(), err_msg=str(path), **tol)
    d_in, n = 2 * cfg.d_model, MESHES[mesh][0][1]
    if not case.endswith("_whole") or mesh == "dm":
        assert got["model_bytes"] > 2 * x.shape[0] * x.shape[1] * (
            d_in // n) * 4


# ---------------------------------------------------------------------------
# hierarchical MoE dispatch, in one process (the reference's tests/test_moe)
# ---------------------------------------------------------------------------


def _hier_ctx():
    return tact.activation_sharding(Mesh((2, 2, 2), ("pod", "data", "model")),
                                    R.HIER)


def _jax_hier_ctx():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (conftest forces them)")
    mesh = jshd.make_mesh((2, 2, 2), ("pod", "data", "model"))
    return jact.activation_sharding(mesh, _jax(R.HIER))


def _moe_cfg(cf):
    base = treg.smoke(R.GRANITE)
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.26],
                         ids=["ample", "tight", "forced-drops"])
def test_moe_hierarchical_output_identical_to_flat(cf):
    cfg = _moe_cfg(cf)
    jp, x = _moe_inputs()
    p = P.from_numpy(jp)
    out_flat, aux_flat = tmoe.moe_apply(cfg, p, torch.from_numpy(x))
    with _hier_ctx():
        assert tmoe._hier_homes(8, 4) == 2        # the hier path is live
        out_h, aux_h = tmoe.moe_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(out_h.numpy(), out_flat.numpy(), rtol=0,
                               atol=1e-6)
    assert float(aux_h["moe_dropped_frac"]) == float(
        aux_flat["moe_dropped_frac"])
    if cf == 0.26:
        assert float(aux_flat["moe_dropped_frac"]) > 0
    # the JAX package's flat and hierarchical dispatch (jitted: the
    # context is read as the call traces)
    apply = functools.partial(jmoe.moe_apply, _jax(cfg))
    j_flat, j_aux = jax.jit(apply)(jp, jnp.asarray(x))
    with _jax_hier_ctx():
        j_h, _ = jax.jit(apply)(jp, jnp.asarray(x))
    for want in (j_flat, j_h):
        np.testing.assert_allclose(out_h.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert float(aux_h["moe_dropped_frac"]) == pytest.approx(
        float(j_aux["moe_dropped_frac"]), abs=0)


def test_moe_hierarchical_grads_match_flat():
    cfg = _moe_cfg(1.0)
    jp, x = _moe_inputs()

    def grads(ctx):
        p = P.tree_map(lambda t: t.requires_grad_(True), P.from_numpy(jp))
        with ctx:
            out, aux = tmoe.moe_apply(cfg, p, torch.from_numpy(x))
        loss = (out ** 2).sum() + aux["moe_aux_loss"]
        leaves = P.tree_leaves(p)
        return P.tree_unflatten(p, torch.autograd.grad(loss, leaves))

    import contextlib
    g_flat, g_hier = grads(contextlib.nullcontext()), grads(_hier_ctx())
    for (path, a), (_, b) in zip(_leaves(g_flat), _leaves(g_hier)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


def test_moe_hierarchical_gates_off_when_indivisible():
    with _hier_ctx():
        assert tmoe._hier_homes(4, 4) == 2
        assert tmoe._hier_homes(3, 4) == 1      # e % pods != 0
        assert tmoe._hier_homes(4, 3) == 1      # g % pods != 0
    assert tmoe._hier_homes(4, 4) == 1          # no context at all
    flat = dataclasses.replace(R.HIER, hierarchical_moe=False)
    with tact.activation_sharding(Mesh((2, 2, 2), ("pod", "data", "model")),
                                  flat):
        assert tmoe._hier_homes(4, 4) == 1


# ---------------------------------------------------------------------------
# hierarchical MoE on ranks: the exchange and its bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", R.A2A_CF)
def test_moe_exchange_on_ranks_equals_flat_and_prices_its_bytes(ranks, cf):
    """granite's MoE on (pod 2, data 1, model 2): the rows each pod's
    ranks return equal the flat dispatch in one process, and the pod
    group carries the remote home blocks of the slot grid, out and back:
    2 (P - 1) E_h G_s C D 4 bytes a rank (E_h = E / (P M) experts, G_s =
    G / (P D) groups).  Over all ranks that is
    ``estimate_a2a_bytes(hierarchical=True)``'s price where the grid
    holds every routed row (E C = M k, capacity factor 1); at 1.25 the
    grid's empty slots ride too (PERF.md, "Differences the tests
    allow")."""
    cfg = _moe_cfg(cf)
    jp, x = ranks[-1]["inputs"]["moe_params"], ranks[-1]["inputs"]["moe_x"]
    want, aux = tmoe.moe_apply(cfg, P.from_numpy(jp), torch.from_numpy(x))
    g, m = R.A2A_X
    mc = cfg.moe
    c = tmoe._capacity(m, mc)
    pods, data, model = 2, 1, 2
    per_rank = (2 * (pods - 1) * (mc.n_experts // (pods * model))
                * (g // (pods * data)) * c * cfg.d_model * 4)
    total = 0
    for r in _rank_results(ranks):
        got = r["a2a"][cf]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["out"], want[lo:hi].numpy(), rtol=0,
                                   atol=1e-6)
        assert got["pod_bytes"] == per_rank
        total += got["pod_bytes"]
    est = jcomm.estimate_a2a_bytes(
        jcomm.CommTopology.from_mesh(_jax_mesh("pdm")), n_tokens=g * m,
        d_model=cfg.d_model, n_experts=mc.n_experts, capacity=c,
        top_k=mc.top_k, hierarchical=True, bytes_per_elem=4.0)
    if mc.n_experts * c == m * mc.top_k:
        assert total == est["cross_pod_bytes"]
    else:
        assert total == est["cross_pod_bytes"] * (
            mc.n_experts * c / (m * mc.top_k))


def test_a_recomputed_block_sees_the_context_on_another_thread(
        monkeypatch):
    """A CUDA backward runs on the autograd engine's device thread, where
    the thread-local context of the step is not: the checkpointed block
    takes it along, so its recomputation (FSDP's gathers, the layers'
    tensor parallelism) runs under the same mesh and strategy."""
    import threading

    from repro_torch.models import transformer
    seen = []

    def block(cfg, pslice, x, positions, mode, cslice, cache_index, enc_out,
              paging, impl):
        seen.append(tact.current())
        return x * x, {}, 0.0

    monkeypatch.setattr(transformer, "_superblock", block)
    cfg = treg.smoke(R.YI)
    x = torch.ones(1, 2, cfg.d_model, requires_grad=True)
    blocks = {f"p{i}": {} for i in range(cfg.pattern_len)}
    with _hier_ctx() as ctx:
        y, _, _ = transformer.stack_apply(cfg, blocks, x,
                                          positions=torch.arange(2),
                                          remat=True)
    worker = threading.Thread(target=lambda: y.sum().backward())
    worker.start()
    worker.join()
    assert len(seen) == 2 * cfg.n_repeats
    assert all(c is ctx for c in seen)
    assert torch.equal(x.grad, torch.full_like(x, 2.0 ** cfg.n_repeats))


# ---------------------------------------------------------------------------
# checkpoints across one rank, (data 2, model 2) and (data 4, model 1)
# ---------------------------------------------------------------------------


def test_checkpoint_carries_across_meshes_and_one_rank(ranks, tmp_path):
    res = _rank_results(ranks)
    ck = res[0]["checkpoint"]
    assert ck["how"] == "resumed" and ck["start"] == 2
    rest = [h["loss"] for h in ck["whole"][2:]]
    for name in ("restored", "remesh_ckpt", "remesh_host"):
        np.testing.assert_allclose([h["loss"] for h in ck[name]], rest,
                                   rtol=1e-4, err_msg=name)
        for r in res:
            assert r["checkpoint"][name] == ck[name]
    # after the remesh each rank holds (data 4, model 1)'s shards
    wq = ck["remesh_ckpt_shapes"]["params"]["blocks"]["p0"]["attn"]["wq"]
    assert wq == (2, 64, 64)
    # one rank restores the sharded run's checkpoint: whole leaves on disk
    import shutil
    shutil.copytree(f"{ranks[-1]['ckpt']}/whole", tmp_path / "whole")
    cfg = treg.smoke(R.YI)
    one = Trainer(cfg, R.TCFG, R.SHAPE, ckpt_dir=str(tmp_path / "whole"),
                  device="cpu")
    assert one.init_or_resume() == "resumed"
    one.run(2, log_every=0)
    np.testing.assert_allclose([h["loss"] for h in one.history], rest,
                               rtol=1e-4)
    # and the JAX package reads it
    path = str(tmp_path / "whole" / "step_00000002" / "state")
    back = jckpt.restore_state(jsteps.abstract_train_state(
        _jax(cfg), _jax(R.TCFG)), path)
    assert int(back["step"]) == 2
