"""The dense-decoder variants of the port against the JAX model: QKV bias
(chatglm3-6b, qwen2-72b), partial RoPE (chatglm3-6b), LayerNorm with
sinusoidal positions and no positions at all (yi-6b SMOKE variants),
and the deep and narrow-head configs (deepseek-67b, lammps-proxy), each
at its SMOKE size, on the same parameters and inputs made from numpy
seeds.  The seeded init gives zero biases on both sides, and a zero bias
tests nothing, so every QKV and LayerNorm bias is overwritten with
seeded random values on both sides first.

Tolerances: float32 compute 1e-4 (the same math, summed in another
order across a few layers); bfloat16 compute 3e-2 (both frameworks round
every matmul output to bf16, at places that need not coincide, so
logits differ by a few bf16 ulps).  Gradients are held against each
leaf's own scale.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models.layers import PagedView as JView  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.layers import PagedView  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
BIASES = ("bq", "bk", "bv", "bias")

SERVED = ["chatglm3-6b", "qwen2-72b"]
VARIANTS = {"yi-layernorm-sinusoidal": dict(norm_type="layernorm",
                                            pos_type="sinusoidal"),
            "yi-no-positions": dict(pos_type="none")}
ALL = SERVED + ["deepseek-67b", "lammps-proxy"] + list(VARIANTS)


def _configs(name):
    """(JAX config, port config): an arch's SMOKE, or a yi-6b SMOKE
    variant."""
    if name in VARIANTS:
        return (dataclasses.replace(jreg.smoke("yi-6b"), **VARIANTS[name]),
                dataclasses.replace(treg.smoke("yi-6b"), **VARIANTS[name]))
    return jreg.smoke(name), treg.smoke(name)


def _with_biases(tree, rng):
    """The numpy tree with every QKV and LayerNorm bias drawn from
    normal(0, 0.02), in sorted key order."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, 0.02, np.shape(tree[k])).astype(np.float32)
                    if k in BIASES else _with_biases(tree[k], rng))
                for k in sorted(tree)}
    return np.array(tree)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jcfg, cfg, JAX params, port params) from the JAX init at seed 0
    (jitted: one compile, not one per leaf) with seeded biases."""
    jcfg, cfg = _configs(name)
    jp = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    npp = _with_biases(jax.device_get(jp), np.random.default_rng(100))
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, npp), P.from_numpy(npp)


@functools.lru_cache(maxsize=None)
def _jit(name, method, dtype):
    """``JModel(jcfg).<method>`` at ``dtype`` compute under one ``jax.jit``
    for every test of ``name`` (outside jit each call traces and compiles
    the layer scan anew)."""
    return jax.jit(functools.partial(getattr(JModel(_setup(name)[0]), method),
                                     compute_dtype=JDT[dtype]))


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


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype], err_msg=msg)


# ---------------------------------------------------------------------------
# configs and schema
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_param_defs_mirror_the_jax_schema(name):
    jcfg, cfg = _configs(name)
    jdefs = dict(_leaves(JModel(jcfg).param_defs()))
    tdefs = dict(_leaves(Model(cfg).param_defs()))
    assert jdefs.keys() == tdefs.keys()
    for path, jd in jdefs.items():
        td = tdefs[path]
        assert (td.shape, td.axes, td.init, td.scale) == \
            (jd.shape, jd.axes, jd.init, jd.scale), path
    assert Model(cfg).n_params() == JModel(jcfg).n_params()
    n_bias = sum(1 for p in tdefs if p[-1] in ("bq", "bk", "bv"))
    assert n_bias == (3 if cfg.qkv_bias else 0)
    # LayerNorm's bias, like every norm leaf, is float32 in any tree
    for path, td in tdefs.items():
        if path[-1] == "bias":
            assert cfg.norm_type == "layernorm" and td.dtype == "float32"


def test_seeded_biases_are_not_zero():
    _, _, jp, tp = _setup("chatglm3-6b")
    for n in ("bq", "bk", "bv"):
        b = tp["blocks"]["p0"]["attn"][n]
        assert float(b.abs().min()) > 0
        np.testing.assert_array_equal(b.numpy(),
                                      np.asarray(jp["blocks"]["p0"]["attn"][n]))


# ---------------------------------------------------------------------------
# prefill, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
@DTYPES
def test_prefill_logits_and_cache_match_jax(name, dtype):
    jcfg, cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))   # the shape of the
    last = np.array([15, 6])                          # contiguous test's
    jl, jc = _jit(name, "prefill", dtype)(jp, {"tokens": jnp.asarray(toks)},
                                          last_index=jnp.asarray(last))
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                compute_dtype=dtype,
                                last_index=torch.from_numpy(last))
    assert tl.dtype == dtype and tuple(tl.shape) == (2, cfg.vocab_size)
    _close(tl, jl, dtype)
    for n in ("k", "v"):
        assert tuple(tc["p0"][n].shape) == jc["p0"][n].shape
        _close(tc["p0"][n], jc["p0"][n], dtype, n)


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in ALL]
                         + [(n, "bfloat16") for n in SERVED])
def test_loss_and_grads_match_jax(name, dtype):
    jcfg, cfg, jp, tp = _setup(name)
    tol = TOL[P.DTYPES[dtype]]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, batch, remat=True,
                                    compute_dtype=jnp.dtype(dtype)),
        has_aux=True))(jp)
    tp = P.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    leaves = P.tree_leaves(tp)
    tl, _ = Model(cfg).loss(
        tp, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        remat=True, compute_dtype=P.DTYPES[dtype])
    tg = P.tree_unflatten(tp, torch.autograd.grad(tl, leaves))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol)
    jleaves = dict(_leaves(jax.device_get(jg)))
    tleaves = dict(_leaves(tg))
    assert jleaves.keys() == tleaves.keys()
    for path, j in jleaves.items():
        j, t = np.asarray(j, np.float32), _np(tleaves[path])
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=tol * float(np.abs(j).max()),
                                   err_msg=str(path))
    if cfg.qkv_bias:
        assert float(np.abs(jleaves[("blocks", "p0", "attn", "bq")]).max()) > 0


# ---------------------------------------------------------------------------
# the serving paths: paged decode, paged chunk prefill, contiguous decode
# ---------------------------------------------------------------------------


def _pools(cfg, seed, n_pages=12, page=4):
    """A random bf16 pool (reps, P, page, kv, hd), JAX and port copies,
    and a block table for two slots with disjoint pages."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_repeats, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape, np.float32) for n in ("k", "v")}
    jpool = {"p0": {n: jnp.asarray(a, jnp.bfloat16) for n, a in pool.items()}}
    tpool = {"p0": {n: torch.from_numpy(a).to(torch.bfloat16)
                    for n, a in pool.items()}}
    return jpool, tpool, np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)


@pytest.mark.parametrize("name", SERVED)
@DTYPES
def test_paged_decode_step_matches_jax(name, dtype):
    jcfg, cfg, jp, tp = _setup(name)
    jpool, tpool, bt = _pools(cfg, 3)
    lens = np.array([9, 2], np.int32)
    toks = np.array([[17], [201]])
    jl, jnew = _jit(name, "decode_step", dtype)(
        jp, jpool, jnp.asarray(toks), jnp.asarray(lens),
        paging=JView(jnp.asarray(bt), jnp.asarray(lens)))
    tl, tnew = Model(cfg).decode_step(
        tp, tpool, torch.from_numpy(toks), torch.from_numpy(lens),
        compute_dtype=dtype, paging=PagedView(torch.from_numpy(bt),
                                              torch.from_numpy(lens)))
    _close(tl, jl, dtype)
    for n in ("k", "v"):
        _close(tnew["p0"][n], jnew["p0"][n], dtype, n)


@pytest.mark.parametrize("name", SERVED)
@DTYPES
@pytest.mark.parametrize("start,n_valid", [(0, 6), (5, 3)])
def test_prefill_chunk_matches_jax(name, dtype, start, n_valid):
    jcfg, cfg, jp, tp = _setup(name)
    jpool, tpool, bt = _pools(cfg, 4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 6))
    st, nv = np.array([start], np.int32), np.array([n_valid], np.int32)
    jl, jnew = _jit(name, "prefill_chunk", dtype)(
        jp, jpool, jnp.asarray(toks),
        JView(jnp.asarray(bt[:1]), jnp.asarray(st), n_valid=jnp.asarray(nv),
              null_page=jnp.int32(0)))
    tl, tnew = Model(cfg).prefill_chunk(
        tp, tpool, torch.from_numpy(toks),
        PagedView(torch.from_numpy(bt[:1]), torch.from_numpy(st),
                  n_valid=torch.from_numpy(nv), null_page=0),
        compute_dtype=dtype)
    _close(tl[:, :n_valid], jl[:, :n_valid], dtype)
    for n in ("k", "v"):        # page 0 takes the padding rows: skip it
        _close(tnew["p0"][n][:, 1:], jnew["p0"][n][:, 1:], dtype, n)


@pytest.mark.parametrize("name", SERVED + list(VARIANTS))
@DTYPES
def test_contiguous_decode_steps_match_jax(name, dtype):
    """A right-padded prefill, then decode steps at the scalar
    ``cache_index`` 9 .. 12: the sinusoidal variant's positions start at
    that offset."""
    jcfg, cfg, jp, tp = _setup(name)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16))
    toks[:, 9:] = 0
    last = np.array([8, 8])
    jl, jc = _jit(name, "prefill", dtype)(jp, {"tokens": jnp.asarray(toks)},
                                          last_index=jnp.asarray(last))
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                compute_dtype=dtype,
                                last_index=torch.from_numpy(last))
    for i in range(4):
        nxt = np.argmax(_np(jl), -1)[:, None]
        jl, jc = _jit(name, "decode_step", dtype)(jp, jc, jnp.asarray(nxt),
                                                  jnp.int32(9 + i))
        tl, tc = Model(cfg).decode_step(tp, tc, torch.from_numpy(nxt),
                                        torch.tensor(9 + i),
                                        compute_dtype=dtype)
        _close(tl, jl, dtype, f"step {i}")
    for n in ("k", "v"):
        _close(tc["p0"][n], jc["p0"][n], dtype, n)


# ---------------------------------------------------------------------------
# the engine against the JAX contiguous greedy reference
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13], [2, 4]]
NEW = [8, 6, 5]
ECFG = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8)


@functools.lru_cache(maxsize=None)
def _jax_greedy_f32(name, cap=32):
    """Each prompt alone through the JAX contiguous-cache path at float32
    compute; the cache rounded to bf16 after the prefill, the type a
    page pool holds."""
    jp = _setup(name)[2]
    prefill, step = (_jit(name, m, torch.float32)
                     for m in ("prefill", "decode_step"))
    streams = []
    for prompt, gen in zip(PROMPTS, NEW):
        toks = np.zeros((1, cap), np.int32)
        toks[0, :len(prompt)] = prompt
        logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)},
                                last_index=jnp.array([len(prompt) - 1]))
        cache = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                       cache)
        out = [int(jnp.argmax(logits[0]))]
        for i in range(gen - 1):
            logits, cache = step(jp, cache,
                                 jnp.asarray([[out[-1]]], jnp.int32),
                                 jnp.int32(len(prompt) + i))
            out.append(int(jnp.argmax(logits[0])))
        streams.append(out)
    return streams


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("chunk", [0, 4], ids=["legacy", "c4"])
def test_engine_f32_greedy_matches_jax_reference(name, chunk):
    _, cfg, _, tp = _setup(name)
    want = _jax_greedy_f32(name)
    eng = Engine(cfg, EngineConfig(**ECFG, prefill_chunk=chunk), params=tp,
                 device="cpu", compute_dtype=torch.float32)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    eng.run()
    assert [r.tokens for r in reqs] == want
    assert eng.alloc.pages_in_use() == 0


def test_engine_refuses_sinusoidal_positions():
    """Per-slot positions cannot take one sinusoidal offset: the engine
    refuses the config, as the JAX engine does; no positions at all are
    served."""
    _, cfg, _, tp = _setup("yi-layernorm-sinusoidal")
    with pytest.raises(AssertionError, match="rope"):
        Engine(cfg, EngineConfig(**ECFG), params=tp, device="cpu")
    _, cfg, _, tp = _setup("yi-no-positions")
    eng = Engine(cfg, EngineConfig(**ECFG), params=tp, device="cpu")
    req = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert req.finished and len(req.tokens) == 3
