"""The port's mixture-of-experts path against the JAX package's, on the
CPU, from the same numpy inputs and the same parameters: the grouped
expert GEMM, ``moe_apply``, granite-moe-1b-a400m's and arctic-480b's
SMOKE models (logits, loss, gradients), the serving engine in both
prefill modes, five Trainer steps, and a JAX checkpoint resumed in the
port.

Tolerances: the GEMM 2e-5 in float32 (sums in another order) and 2e-2
in bfloat16 (one rounding of the output); models in float32 1e-4 and in
bfloat16 3e-2 of each quantity's own scale (both frameworks round every
matmul output to bf16, at places that need not coincide), bf16
gradients as whole leaves and those behind the router at 0.1 (a routing
decision that bf16 tips on one side only moves them); losses over
five steps 1e-4 relative with float32 optimizer state and 1e-3 with
bfloat16 state (a float32 difference in the last bits can round a state
entry to the neighbouring bf16 value).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve.engine as jengine  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels.moe_gemm import kernel as jmoe_kernel  # noqa: E402
from repro.kernels.moe_gemm import ref as jmoe_ref  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as tmoe_kernel  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as tmoe_ops  # noqa: E402
from repro_torch.kernels.moe_gemm import ref as tmoe_ref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

GRANITE, ARCTIC = "granite-moe-1b-a400m", "arctic-480b"
TOL = {"f32": 1e-4, "bf16": 3e-2}
ROUTED_TOL = 0.1     # bf16 gradients behind the router (see the loss test)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol, msg=""):
    """|a - b| <= tol * (|b| + max |b|): relative to the quantity's scale."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * float(np.abs(b).max()),
                               err_msg=msg)


def _both(a, dt):
    return jnp.asarray(a, JDT[dt]), torch.from_numpy(np.asarray(a)).to(TDT[dt])


@pytest.fixture(scope="module", params=[GRANITE, ARCTIC])
def arch(request):
    """(arch id, JAX SMOKE config, port SMOKE config, JAX params, port
    params): the port's params are the JAX draw carried across."""
    jcfg, tcfg = jreg.smoke(request.param), treg.smoke(request.param)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    return request.param, jcfg, tcfg, jp, P.from_numpy(jax.device_get(jp))


# ---------------------------------------------------------------------------
# the grouped expert GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 5, 130, 300])   # 300: three 128-row tiles
@pytest.mark.parametrize("d", [64, 300])
@pytest.mark.parametrize("dt,tol", [("f32", 2e-5), ("bf16", 2e-2)])
def test_moe_gemm_ref_matches_jax_ref_and_pallas(t, d, dt, tol):
    rng = np.random.default_rng(t * 1000 + d)
    x = rng.standard_normal((4, t, d), np.float32)
    w = rng.standard_normal((4, d, 96), np.float32)
    (xj, xt), (wj, wt) = _both(x, dt), _both(w, dt)
    out = ops.moe_gemm(xt, wt)
    assert out.dtype == TDT[dt] and out.shape == (4, t, 96)
    kw = dict(rtol=tol, atol=tol * np.sqrt(d))    # sums of d products
    np.testing.assert_allclose(_np(out), _np(jmoe_ref.moe_gemm_ref(xj, wj)),
                               **kw)
    np.testing.assert_allclose(
        _np(out), _np(jmoe_kernel.moe_gemm_kernel(xj, wj, interpret=True)),
        **kw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_gemm_function_backward_is_two_grouped_products(monkeypatch, dt):
    """The autograd Function (the kernel's route on the card) runs its
    backward as two products of the same wrapper on transposed views,
    dX = dY W^T and dW = X^T dY; on CPU tensors the wrapper takes the
    plain version, so the arrangement is held here against autograd of
    the plain version."""
    rng = np.random.default_rng(0)
    x, w, dy = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        TDT[dt]) for s in ((3, 7, 40), (3, 40, 24), (3, 7, 24)))
    calls = []
    real = tmoe_kernel.moe_gemm

    def counted(a, b):
        calls.append((tuple(a.shape), a.is_contiguous(), b.is_contiguous()))
        return real(a, b)

    monkeypatch.setattr(tmoe_kernel, "moe_gemm", counted)
    grads = []
    for fn in (tmoe_ops.moe_gemm, tmoe_ref.moe_gemm_ref):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(xl, wl), (xl, wl), dy))
    # forward, then dX on W's transposed view and dW on X's
    assert calls == [((3, 7, 40), True, True), ((3, 7, 24), True, False),
                     ((3, 40, 7), False, True)]
    tol = 2e-5 if dt == "f32" else 2e-2
    for g, want in zip(*grads):
        assert g.dtype == want.dtype and g.shape == want.shape
        _close(g, want, tol)


def test_moe_gemm_on_the_cpu_launches_nothing_and_refuses_grad():
    build.reset_launches()
    x, w = torch.randn(2, 3, 8), torch.randn(2, 8, 5)
    assert torch.equal(tmoe_kernel.moe_gemm(x, w), tmoe_ref.moe_gemm_ref(x, w))
    assert torch.equal(ops.moe_gemm(x, w, impl="ref"),
                       tmoe_ref.moe_gemm_ref(x, w))
    assert all(n == 0 for n in build.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.moe_gemm(x, w, impl="cuda")
    with pytest.raises(RuntimeError, match="requires grad"):
        tmoe_kernel.moe_gemm(x.requires_grad_(), w)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _moe_params(cfg, seed=0):
    """One MoE position's parameters, drawn with numpy; the router at a
    larger scale so that routing is far from uniform."""
    rng = np.random.default_rng(seed)
    defs = tmoe.moe_defs(cfg)
    return {k: P.tree_map(lambda d: (rng.standard_normal(d.shape) * (
        0.5 if k == "router" else 0.05)).astype(np.float32), v)
        for k, v in defs.items()}


@pytest.mark.parametrize("name", [GRANITE, ARCTIC])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_matches_jax(name, dt, capacity_factor):
    """Output, expert choice, aux loss and dropped fraction of one MoE
    FFN on 3 groups of 24 tokens; a capacity factor of 0.5 drops
    tokens."""
    tcfg = treg.smoke(name)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    jcfg = jreg.smoke(name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    p = _moe_params(tcfg)
    x = np.random.default_rng(1).standard_normal((3, 24, tcfg.d_model),
                                                 np.float32)
    xj, xt = _both(x, dt)
    jout, jaux = jmoe.moe_apply(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                                xj)
    tout, taux = tmoe.moe_apply(tcfg, P.from_numpy(p), xt)
    assert tout.dtype == TDT[dt] and tout.shape == xt.shape
    _close(tout, jout, TOL[dt])
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-5)
    assert float(taux["moe_dropped_frac"]) == pytest.approx(
        float(jaux["moe_dropped_frac"]), abs=1e-7)
    if capacity_factor < 1:
        assert float(taux["moe_dropped_frac"]) > 0.1
    probs = jax.nn.softmax(xj.astype(jnp.float32) @ jnp.asarray(p["router"]))
    _, jidx = jax.lax.top_k(probs, jcfg.moe.top_k)
    _, _, _, tidx = tmoe.route(tcfg, P.from_numpy(p)["router"], xt)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_moe_apply_hierarchical_dispatch_is_not_ported():
    """Hierarchical dispatch is no flag of ``moe_apply`` any more:
    ``_hier_homes`` chooses it under the activation-sharding context, as
    in the reference (tests/test_torch_tp.py holds it to flat), and
    without a context dispatch is flat."""
    cfg = treg.smoke(GRANITE)
    with pytest.raises(TypeError, match="hierarchical"):
        tmoe.moe_apply(cfg, P.from_numpy(_moe_params(cfg)),
                       torch.zeros(1, 4, cfg.d_model), hierarchical=True)
    assert tmoe._hier_homes(cfg.moe.n_experts, 4) == 1


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def test_param_defs_and_counts_mirror_jax(arch):
    name, jcfg, tcfg, jp, tp = arch
    jdefs = dict(_leaves(JModel(jcfg).param_defs()))
    tdefs = dict(_leaves(Model(tcfg).param_defs()))
    assert jdefs.keys() == tdefs.keys()
    for path, jd in jdefs.items():
        td = tdefs[path]
        assert (td.shape, td.axes, td.init, td.scale) == \
            (jd.shape, jd.axes, jd.init, jd.scale), path
    assert ("embed", "head") not in tdefs if tcfg.tie_embeddings else True
    for cfg_t, cfg_j in ((tcfg, jcfg), (treg.get(name), jreg.get(name))):
        assert Model(cfg_t).n_params() == JModel(cfg_j).n_params()
        assert Model(cfg_t).n_active_params() == \
            JModel(cfg_j).n_active_params()
        assert cfg_t.n_params() == cfg_j.n_params()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_logits_match_jax(arch, dt):
    _, jcfg, tcfg, jp, tp = arch
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    jl, jc = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)},
                                  compute_dtype=JDT[dt])
    tl, tc = Model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 compute_dtype=TDT[dt])
    _close(tl, jl, TOL[dt])
    for (path, a), (_, b) in zip(_leaves(tc), _leaves(jax.device_get(jc))):
        _close(a, b, TOL[dt], str(path))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_loss_and_grads_match_jax(arch, dt):
    _, jcfg, tcfg, jp, tp = arch
    shape = jbase.WorkloadShape("t", "train", 32, 4)
    batch = jpipe.synthetic_batch(jcfg, shape, seed=0, step=0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, batch, compute_dtype=JDT[dt]),
        has_aux=True)(jp)
    tp = P.tree_map(lambda t: t.clone(), tp)
    leaves = P.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = Model(tcfg).loss(
        tp, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        compute_dtype=TDT[dt])
    tg = P.tree_unflatten(tp, torch.autograd.grad(tl, leaves))
    for key in ("loss", "xent", "moe_aux"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=TOL[dt], err_msg=key)
    assert float(tm["moe_aux"].detach()) > 0
    for (path, j), (_, t) in zip(_leaves(jax.device_get(jg)), _leaves(tg)):
        if dt == "f32":
            _close(t, j, TOL[dt], str(path))
        else:
            # bf16 activations can tip a token's routing or its place in
            # an expert's capacity on one side only.  Each such flip moves
            # the gradients that pass through the MoE FFN (its weights,
            # the norm before it) by a few percent, against ~1% of bf16
            # noise (seen on both sides, for either package, across
            # seeds): hold each leaf as a whole, those at ROUTED_TOL
            t, j = _np(t), _np(j)
            rel = np.linalg.norm(t - j) / np.linalg.norm(j)
            tol = ROUTED_TOL if {"moe", "norm2"} & set(path) else TOL[dt]
            assert rel <= tol, (path, rel)


def test_contiguous_decode_matches_jax(arch):
    """Right-padded prefill, then decode steps at a scalar index, in
    float32 compute on both sides."""
    _, jcfg, tcfg, jp, tp = arch
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 16))
    toks[:, 10:] = 0
    jl, jc = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)},
                                  compute_dtype=jnp.float32,
                                  last_index=jnp.array([9, 9]))
    tl, tc = Model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 compute_dtype=torch.float32,
                                 last_index=torch.tensor([9, 9]))
    for i in range(3):
        nxt = np.argmax(np.asarray(jl), -1)[:, None]
        jl, jc = JModel(jcfg).decode_step(jp, jc, jnp.asarray(nxt),
                                          jnp.int32(10 + i),
                                          compute_dtype=jnp.float32)
        tl, tc = Model(tcfg).decode_step(tp, tc, torch.from_numpy(nxt), 10 + i,
                                         compute_dtype=torch.float32)
        _close(tl, jl, TOL["f32"], f"step {i}")
    for (path, a), (_, b) in zip(_leaves(tc), _leaves(jax.device_get(jc))):
        _close(a, b, TOL["f32"], str(path))


# ---------------------------------------------------------------------------
# the serving engine, teacher-forced against the JAX engine
# ---------------------------------------------------------------------------

ECFG = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13], [2, 4]]
NEW = [6, 5, 4]


@pytest.mark.parametrize("chunk", [0, 4], ids=["legacy", "chunked"])
def test_engine_logits_match_the_jax_engine(monkeypatch, chunk):
    """granite SMOKE through both engines (bf16, the same schedule: the
    schedulers are copies).  Every tick's logits, the rows the sampler
    sees, are recorded on both sides; the port's engine is forced onto
    the JAX engine's greedy tokens, so both run the same sequence and
    every tick's logits are compared.  Capacity is per group and grows
    with the tokens in it, so each mode is held against the JAX engine
    in the same mode, not legacy against chunked."""
    jcfg, tcfg = jreg.smoke(GRANITE), treg.smoke(GRANITE)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = []

    def recording_sampler(logits, temps, key):
        jax.debug.callback(
            lambda x: want.append(np.asarray(x).astype(np.float32)), logits)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    monkeypatch.setattr(jengine, "sample_tokens", recording_sampler)
    jeng = JEngine(jcfg, JEngineConfig(**ECFG, prefill_chunk=chunk),
                   params=jp)
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    jeng.run()

    eng = Engine(tcfg, EngineConfig(**ECFG, prefill_chunk=chunk),
                 params=P.from_numpy(jax.device_get(jp)), device="cpu")
    got = []

    def forced(logits, temps):
        got.append(logits.float().numpy())
        return np.argmax(want[len(got) - 1], axis=-1).astype(np.int32)

    eng._sample = forced
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    eng.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert len(got) == len(want) and (eng.n_mixed_steps > 0) == (chunk > 0)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL["bf16"], f"tick {i}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _recording(jtr):
    """Wrap the JAX trainer's jitted step to keep each step's metrics."""
    seen, step = [], jtr._jit_step

    def run(state, batch):
        state, metrics = step(state, batch)
        seen.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    jtr._jit_step = run
    return seen


def test_trainer_matches_jax_trainer_for_five_steps(arch):
    """granite (AdamW, float32 state) and arctic (Adafactor, bf16 state,
    the dense residual) at float32 compute: losses, their xent and aux
    parts and grad norms over five steps."""
    name, jcfg, tcfg, _, _ = arch
    tol = 1e-4
    if name == ARCTIC:
        jcfg = dataclasses.replace(jcfg, opt_state_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, opt_state_dtype="bfloat16")
        tol = 1e-3
    kw = dict(compute_dtype="float32", warmup_steps=2, total_steps=5)
    shape = dict(name="t", kind="train", seq_len=32, global_batch=4)
    jtr = JTrainer(jcfg, jbase.TrainConfig(**kw),
                   jbase.WorkloadShape(**shape), make_local_mesh(1, 1))
    jtr.init_or_resume()
    seen = _recording(jtr)
    tr = Trainer(tcfg, tbase.TrainConfig(**kw), tbase.WorkloadShape(**shape),
                 device="cpu")
    tr.state = P.from_numpy(jax.device_get(jtr.state))
    jtr.run(5, log_every=0)
    th = tr.run(5, log_every=0)
    for key in ("loss", "xent", "moe_aux", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in th],
                                   [m[key] for m in seen], rtol=tol,
                                   err_msg=key)
    assert all(h["moe_aux"] > 0 for h in th)


def test_granite_jax_checkpoint_resumes_in_the_port(tmp_path):
    """Two JAX steps and a checkpoint (no ``head`` leaf, stacked
    ``router``, ``w_in``, ``w_gate``, ``w_out``), then two more steps in
    each package from it: the same losses."""
    jcfg, tcfg = jreg.smoke(GRANITE), treg.smoke(GRANITE)
    kw = dict(compute_dtype="float32", warmup_steps=1, total_steps=4)
    shape = dict(name="t", kind="train", seq_len=32, global_batch=4)
    ck = str(tmp_path / "ck")
    first = JTrainer(jcfg, jbase.TrainConfig(**kw),
                     jbase.WorkloadShape(**shape), make_local_mesh(1, 1),
                     ckpt_dir=ck)
    first.run(2, ckpt_every=2, log_every=0)
    cont = first.run(2, log_every=0)[2:]
    tr = Trainer(tcfg, tbase.TrainConfig(**kw), tbase.WorkloadShape(**shape),
                 ckpt_dir=ck, device="cpu")
    assert tr.init_or_resume() == "resumed" and tr.start_step == 2
    moe_leaves = tr.state["params"]["blocks"]["p0"]["moe"]
    assert set(moe_leaves) == {"router", "w_in", "w_gate", "w_out"}
    assert "head" not in tr.state["params"]["embed"]
    th = tr.run(2, log_every=0)
    assert [h["step"] for h in th] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in cont], rtol=1e-4)
