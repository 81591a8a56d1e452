"""The last two model families against the JAX package's, on the CPU:
whisper-base (an encoder over precomputed frames, cross-attention over
its output) and pixtral-12b (patch embeddings in place of the leading
token embeddings; head dim 160 at full size), each at its SMOKE size,
with parameters from one seeded JAX init carried across by
``params.from_numpy``.

Tolerances: float32 compute, 1e-4 relative (the same math summed in
another order across a few layers; gradients relative to each leaf's
own scale, at least GRAD_FLOOR of the largest leaf's); the data
pipeline's batches bit for bit; greedy streams token for token (float32
engines on both sides).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import VISION_PATCHES, Model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

ARCHS = ["whisper-base", "pixtral-12b"]
TOL = 1e-4
GRAD_FLOOR = 1e-5


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


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, JAX SMOKE config, port SMOKE config, JAX params, the same
    params as torch tensors)."""
    name = request.param
    jcfg, tcfg = jreg.smoke(name), treg.smoke(name)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    return name, jcfg, tcfg, jp, P.from_numpy(jax.device_get(jp))


def _extras(cfg, b, s, seed):
    """The batch's frames (whisper: s // divisor of them) or patches
    (pixtral: min(VISION_PATCHES, s // 2)), drawn with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_layers:
        return {"frames": rng.standard_normal(
            (b, s // cfg.encoder_seq_divisor, cfg.d_model), np.float32) * 0.02}
    return {"patches": rng.standard_normal(
        (b, min(VISION_PATCHES, s // 2), cfg.d_model), np.float32) * 0.02}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# schema and data
# ---------------------------------------------------------------------------


def test_param_and_cache_schemas_mirror_jax(arch):
    """The encoder's and cross-attention's key paths (``encoder/enc/...``,
    ``encoder/enc_norm``, ``blocks/p0/xattn``, ``blocks/p0/norm_x``), shapes,
    axes and inits, and the cache's ``xk``/``xv``."""
    name, jcfg, tcfg, _, _ = arch
    jdefs = dict(_leaves(JModel(jcfg).param_defs()))
    tdefs = dict(_leaves(Model(tcfg).param_defs()))
    assert jdefs.keys() == tdefs.keys()
    for path, jd in jdefs.items():
        td = tdefs[path]
        assert (td.shape, td.axes, td.init, td.scale, td.custom) == \
            (jd.shape, jd.axes, jd.init, jd.scale, jd.custom), path
    assert Model(tcfg).n_params() == JModel(jcfg).n_params()
    cross = {p[:3] for p in tdefs if p[0] in ("encoder", "blocks")
             and len(p) > 2 and p[2] in ("xattn", "norm_x")}
    assert bool(cross) == (name == "whisper-base")
    jc = dict(_leaves(jtransformer.cache_defs(jcfg, 2, 12, 6)))
    tc = dict(_leaves(transformer.cache_defs(tcfg, 2, 12, 6)))
    assert jc.keys() == tc.keys()
    for path, jd in jc.items():
        assert (tc[path].shape, tc[path].dtype) == (jd.shape, jd.dtype), path
    assert (("p0", "xk") in tc) == (name == "whisper-base")


@pytest.mark.parametrize("step", [0, 3])
def test_pipeline_batches_equal_jax_bit_for_bit(arch, step):
    """Tokens, labels and the frames or patches, drawn from each row's
    generator after its tokens, equal the JAX pipeline's; the prefetching
    pipeline too, and ``to_tensors`` keeps frames and patches float32."""
    _, jcfg, tcfg, _, _ = arch
    kw = dict(name="t", kind="train", seq_len=24, global_batch=3)
    tshape, jshape = tbase.WorkloadShape(**kw), jbase.WorkloadShape(**kw)
    t = tpipe.synthetic_batch(tcfg, tshape, seed=4, step=step)
    j = jpipe.synthetic_batch(jcfg, jshape, seed=4, step=step)
    extra = "frames" if jcfg.encoder_layers else "patches"
    assert t.keys() == j.keys() == {"tokens", "labels", extra}
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t[extra].shape == (3, 12, tcfg.d_model)     # 24 // 2 either way
    tp = tpipe.DataPipeline(tcfg, tshape, seed=4, start_step=step)
    jp = jpipe.DataPipeline(jcfg, jshape, seed=4, start_step=step)
    try:
        a, b = next(tp), next(jp)
        for k in t:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        tp.close()
        jp.close()
    tt = tpipe.to_tensors(a, "cpu")
    assert "_step" not in tt and tt["tokens"].dtype == torch.int64
    assert tt[extra].dtype == torch.float32


# ---------------------------------------------------------------------------
# the encoder, the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [True, False])
def test_encoder_apply_matches_jax(remat):
    """whisper's encoder alone (sinusoidal positions, non-causal
    attention, GeLU MLP, LayerNorm, enc_norm) in float32, with its
    gradient of a fixed projection of the output w.r.t. the frames."""
    jcfg, tcfg = jreg.smoke("whisper-base"), treg.smoke("whisper-base")
    jp = JModel(jcfg).init(jax.random.PRNGKey(3))
    tp = P.from_numpy(jax.device_get(jp))
    frames = _extras(jcfg, 2, 22, seed=5)["frames"]
    w = np.random.default_rng(6).standard_normal(frames.shape, np.float32)

    def jf(x):
        out = jtransformer.encoder_apply(jcfg, jp["encoder"], x, remat=remat,
                                         mode="train")
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(frames))
    x = torch.from_numpy(frames).requires_grad_()
    out = transformer.encoder_apply(tcfg, tp["encoder"], x, remat=remat,
                                    mode="train")
    g, = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
    _close(out, jout)
    _close(g, jg)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(arch, remat):
    """Loss, xent and every gradient leaf (the encoder's and the
    cross-attention's among them) against jax.value_and_grad of the
    reference's ``Model.loss`` on the JAX pipeline's batch, float32."""
    _, jcfg, tcfg, jp, _ = arch
    shape = jbase.WorkloadShape("t", "train", 16, 2)
    batch = jpipe.synthetic_batch(jcfg, shape, seed=0, step=0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, batch, remat=remat,
                                    compute_dtype=jnp.float32),
        has_aux=True)(jp)
    tp = P.from_numpy(jax.device_get(jp))
    leaves = P.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = Model(tcfg).loss(tp, tpipe.to_tensors(batch, "cpu"),
                              remat=remat, compute_dtype=torch.float32)
    tg = P.tree_unflatten(tp, torch.autograd.grad(tl, leaves))
    for k, t, j in (("loss", tl, jl), ("xent", tm["xent"], jm["xent"])):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=TOL,
                                   err_msg=k)
    want = [(path, np.asarray(j, np.float32))
            for path, j in _leaves(jax.device_get(jg))]
    got = list(_leaves(tg))
    assert [p for p, _ in want] == [p for p, _ in got]
    top = max(float(np.abs(j).max()) for _, j in want)
    for (path, j), (_, t) in zip(want, got):
        scale = max(float(np.abs(j).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(_np(t), j, rtol=0, atol=TOL * scale,
                                   err_msg=str(path))


def test_frames_and_patches_change_the_loss(arch):
    """As the reference's ``test_whisper_frames_change_output`` and
    ``test_vision_patches_change_output``: scaling the frames (or
    patches) by 3 moves the loss, in both packages alike (float32,
    1e-4)."""
    _, jcfg, tcfg, jp, tp = arch
    shape = jbase.WorkloadShape("t", "train", 16, 2)
    batch = jpipe.synthetic_batch(jcfg, shape, seed=1, step=0)
    extra = "frames" if jcfg.encoder_layers else "patches"
    losses = []
    for scale in (1.0, 3.0):
        b = dict(batch, **{extra: batch[extra] * scale})
        jl, _ = JModel(jcfg).loss(jp, b, compute_dtype=jnp.float32)
        with torch.no_grad():
            tl, _ = Model(tcfg).loss(tp, tpipe.to_tensors(b, "cpu"),
                                     compute_dtype=torch.float32)
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        losses.append(float(tl))
    assert losses[0] != losses[1], f"the {extra} must reach the loss"


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_logits_and_cache_match_jax(arch):
    """``Model.prefill`` with the batch's frames or patches: last logits
    at each row's last real token and every cache leaf (k, v, and the
    encoder's xk, xv in bf16) against the reference's, float32."""
    _, jcfg, tcfg, jp, tp = arch
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12))
    last = np.array([11, 7])
    jb, tb = _both(dict(tokens=toks, **_extras(jcfg, 2, 12, seed=3)))
    jl, jc = JModel(jcfg).prefill(jp, jb, compute_dtype=jnp.float32,
                                  last_index=jnp.asarray(last))
    tl, tc = Model(tcfg).prefill(tp, tb, compute_dtype=torch.float32,
                                 last_index=torch.from_numpy(last))
    assert tuple(tl.shape) == (2, tcfg.vocab_size)
    _close(tl, jl)
    jleaves, tleaves = dict(_leaves(jc)), dict(_leaves(tc))
    assert jleaves.keys() == tleaves.keys()
    for path, j in jleaves.items():
        t = tleaves[path]
        assert tuple(t.shape) == j.shape, path
        if path[-1] in ("xk", "xv"):
            assert t.dtype == torch.bfloat16, path
        _close(t, j, msg=str(path))


def test_decode_continues_the_teacher_forced_forward(arch):
    """The reference's ``test_decode_matches_teacher_forced_forward``
    for these families, held against the JAX package: prefill of P = 12
    tokens equals the forward over them (float32, 1e-4 against the
    reference's ``_trunk``); the prompt right-padded to S = 16 and
    prefilled, then 3 ``decode_step``s at a scalar index (whisper's cross
    KV read from the cache) give the reference's logits (1e-4) and the
    teacher-forced forward's last logits (5e-3, as the reference's test
    holds itself: its decode reads the cross KV rounded to bf16)."""
    _, jcfg, tcfg, jp, tp = arch
    P_, S = 12, 16
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, S))
    extras = _extras(jcfg, 2, S, seed=8)
    if "patches" in extras:            # as many patches at every length
        extras["patches"] = extras["patches"][:, :4]
    jm, tm = JModel(jcfg), Model(tcfg)

    def jax_full(n):
        jb, _ = _both(dict(tokens=toks[:, :n], **extras))
        logits, _, _ = jm._trunk(
            jp, jb["tokens"], mode="prefill", caches=jm.init_cache(2, n),
            cache_index=jnp.int32(0), frames=jb.get("frames"),
            patches=jb.get("patches"), remat=False,
            compute_dtype=jnp.float32)
        return logits

    jb, tb = _both(dict(tokens=toks[:, :P_], **extras))
    tl, _ = tm.prefill(tp, tb, compute_dtype=torch.float32)
    _close(tl, jax_full(P_)[:, -1])

    padded = np.concatenate([toks[:, :P_], np.zeros((2, S - P_), np.int64)],
                            axis=1)
    jb, tb = _both(dict(tokens=padded, **extras))
    last = np.full(2, P_ - 1)
    _, jc = jm.prefill(jp, jb, compute_dtype=jnp.float32,
                       last_index=jnp.asarray(last))
    _, tc = tm.prefill(tp, tb, compute_dtype=torch.float32,
                       last_index=torch.from_numpy(last))
    for i in range(3):
        pos = P_ + i
        tok = toks[:, pos:pos + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(pos),
                                compute_dtype=jnp.float32)
        cache = tc
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos,
                                compute_dtype=torch.float32)
        assert tc is cache                     # written in place
        _close(tl, jl, msg=f"step {i}")
        np.testing.assert_allclose(_np(tl), _np(jax_full(pos + 1)[:, -1]),
                                   rtol=5e-3, atol=5e-3, err_msg=f"step {i}")
    for path, j in _leaves(jc):
        _close(dict(_leaves(tc))[path], j, msg=str(path))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

ECFG = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8)
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [2, 4, 6, 8, 10, 12, 14]]
NEW = [6, 5, 4]


@pytest.fixture(scope="module")
def pixtral():
    jcfg, tcfg = jreg.smoke("pixtral-12b"), treg.smoke("pixtral-12b")
    jp = JModel(jcfg).init(jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, P.from_numpy(jax.device_get(jp))


@pytest.fixture(scope="module")
def pixtral_jax_streams(pixtral):
    """The JAX Engine at float32 compute (its prefill and decode steps
    take the default bf16 compute dtype, which this replaces): tokens
    only, as its engine serves pixtral."""
    jcfg, _, jp, _ = pixtral
    mp = pytest.MonkeyPatch()
    prefill, decode = JModel.prefill, JModel.decode_step
    mp.setattr(JModel, "prefill", lambda self, *a, **k: prefill(
        self, *a, **dict(k, compute_dtype=jnp.float32)))
    mp.setattr(JModel, "decode_step", lambda self, *a, **k: decode(
        self, *a, **dict(k, compute_dtype=jnp.float32)))
    try:
        jeng = JEngine(jcfg, JEngineConfig(**ECFG), params=jp)
        reqs = [jeng.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, NEW)]
        jeng.run()
        return [r.tokens for r in reqs]
    finally:
        mp.undo()


@pytest.mark.parametrize("chunk", [0, 4], ids=["legacy", "chunk4"])
def test_pixtral_paged_greedy_streams_equal_the_jax_engine(
        pixtral, pixtral_jax_streams, chunk):
    """pixtral SMOKE through the paged engine at float32 compute, legacy
    prefill and chunked ticks of 4, with the third prompt waiting for a
    freed slot: token for token the JAX engine's streams."""
    _, tcfg, _, tp = pixtral
    eng = Engine(tcfg, EngineConfig(**dict(ECFG, prefill_chunk=chunk)),
                 params=tp, device="cpu", compute_dtype=torch.float32)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    eng.run()
    assert [r.tokens for r in reqs] == pixtral_jax_streams
    assert (eng.n_mixed_steps > 0) == (chunk > 0)
    assert eng.alloc.pages_in_use() == 0


def test_whisper_is_refused_where_the_reference_refuses_it():
    """Decoder-only serving: the engine and the paged cache refuse an
    encoder-decoder in both packages (a serve spec's refusal is held in
    test_torch_operator.py), and a whisper prefill without frames
    raises."""
    jcfg, tcfg = jreg.smoke("whisper-base"), treg.smoke("whisper-base")
    with pytest.raises(AssertionError):
        JEngine(jcfg, JEngineConfig(**ECFG))
    with pytest.raises(AssertionError):
        Engine(tcfg, EngineConfig(**ECFG), device="cpu")
    with pytest.raises(AssertionError):
        jtransformer.paged_cache_defs(jcfg, 2, 9, 4)
    with pytest.raises(ValueError, match="decoder-only"):
        transformer.paged_cache_defs(tcfg, 2, 9, 4)
    params = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        Model(tcfg).prefill(params, {"tokens": torch.zeros((1, 4),
                                                           dtype=torch.long)})


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_matches_the_jax_trainer(arch, grad_accum):
    """Five Trainer steps from the JAX Trainer's initial state, float32
    compute: losses (1e-4) and grad norms (1e-3) step for step and the
    final parameters (1e-4); under grad_accum = 2 each microbatch takes
    its rows of the frames or patches with its tokens."""
    _, jcfg, tcfg, _, _ = arch
    kw = dict(compute_dtype="float32", grad_accum=grad_accum,
              warmup_steps=2, total_steps=5)
    shape = dict(name="t", kind="train", seq_len=16, global_batch=4)
    jtr = JTrainer(jcfg, jbase.TrainConfig(**kw),
                   jbase.WorkloadShape(**shape), make_local_mesh(1, 1))
    jtr.init_or_resume()
    tr = Trainer(tcfg, tbase.TrainConfig(**kw), tbase.WorkloadShape(**shape),
                 device="cpu")
    tr.state = P.from_numpy(jax.device_get(jtr.state))
    jh, th = jtr.run(5, log_every=0), tr.run(5, log_every=0)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in th],
                               [h["grad_norm"] for h in jh], rtol=1e-3)
    jparams = dict(_leaves(jax.device_get(jtr.state["params"])))
    for path, t in _leaves(tr.state["params"]):
        _close(t, jparams[path], msg=str(path))


def test_configs_are_field_for_field_copies():
    for name in ARCHS:
        for get in ("get", "smoke"):
            t, j = getattr(treg, get)(name), getattr(jreg, get)(name)
            for f in dataclasses.fields(tbase.ModelConfig):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
            assert t.n_params() == j.n_params()
    assert treg.get("pixtral-12b").head_dim == 160
    assert treg.ARCH_IDS == jreg.ARCH_IDS
