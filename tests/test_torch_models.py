"""The port's model (params, layers, stack, Model) against the JAX model
on the same parameters and inputs, made from numpy seeds.

Tolerances: float32 compute 1e-4 (the same math, summed in another
order across a few layers); bfloat16 compute 3e-2 (both frameworks round
every matmul output to bf16, at places that need not coincide, so
logits differ by a few bf16 ulps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.layers import PagedView, apply_rope  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

JCFG = jreg.smoke("yi-6b")
CFG = treg.smoke("yi-6b")
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def params():
    jp = JModel(JCFG).init(jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.device_get(jp))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_smoke_config_is_a_field_for_field_copy():
    for f in dataclasses.fields(ModelConfig):
        assert getattr(CFG, f.name) == getattr(JCFG, f.name), f.name
    assert treg.get("yi-6b").n_params() == jreg.get("yi-6b").n_params()
    with pytest.raises(KeyError):
        treg.get("whisper-base")        # a family not ported yet
    # MoEConfig is copied whole, fields and defaults in order
    assert [(f.name, f.default) for f in dataclasses.fields(MoEConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JMoEConfig)]
    assert treg.EXTRA_IDS == jreg.EXTRA_IDS
    for arch in ("yi-6b", "granite-moe-1b-a400m", "arctic-480b",
                 "chatglm3-6b", "qwen2-72b", "deepseek-67b", "lammps-proxy"):
        for get in ("get", "smoke"):
            t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
            for f in dataclasses.fields(ModelConfig):
                a, b = getattr(t, f.name), getattr(j, f.name)
                if f.name == "moe" and a is not None:
                    a, b = dataclasses.astuple(a), dataclasses.astuple(b)
                assert a == b, (arch, get, f.name)
            assert t.n_params() == j.n_params(), (arch, get)


def test_param_defs_mirror_the_jax_schema():
    jdefs = dict(_leaves(JModel(JCFG).param_defs()))
    tdefs = dict(_leaves(Model(CFG).param_defs()))
    assert jdefs.keys() == tdefs.keys()
    for path, jd in jdefs.items():
        td = tdefs[path]
        assert (td.shape, td.axes, td.init, td.scale) == \
            (jd.shape, jd.axes, jd.init, jd.scale), path
    assert Model(CFG).n_params() == JModel(JCFG).n_params()


def test_from_numpy_carries_jax_params_across(params):
    jp, tp = params
    jl, tl = dict(_leaves(jax.device_get(jp))), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for path, a in jl.items():
        t = tl[path]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), a)
    # bf16 leaves go through their bits
    b = jax.device_get(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = P.from_numpy({"x": b})["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), b.astype(np.float32))


def test_init_params_recipes_and_dtypes():
    g = torch.Generator().manual_seed(0)
    tp = Model(CFG).init(g, dtype=torch.bfloat16, device="cpu")
    for path, t in _leaves(tp):
        if "norm" in path[-2]:   # norm scales: f32 ones, as the kernel reads
            assert t.dtype == torch.float32 and bool((t == 1).all()), path
        else:
            assert t.dtype == torch.bfloat16, path
    w = tp["blocks"]["p0"]["attn"]["wq"].float()
    assert abs(w.std().item() - 0.02) < 2e-3
    a = Model(CFG).init(torch.Generator().manual_seed(3), device="cpu")
    b = Model(CFG).init(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(_leaves(a), _leaves(b)))


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(CFG).init()


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16), np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    for p in (pos, pos[1]):
        got = apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(p), 5e6, fraction)
        want = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(p), 5e6, fraction)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(p), 5e6,
                         fraction)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(p), 5e6,
                                  fraction)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_logits_and_cache_match_jax(params, dtype):
    jp, tp = params
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab_size, (2, 12))
    last = np.array([11, 6])
    jl, jc = JModel(JCFG).prefill(jp, {"tokens": jnp.asarray(toks)},
                                  compute_dtype=JDT[dtype],
                                  last_index=jnp.asarray(last))
    tl, tc = Model(CFG).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                compute_dtype=dtype,
                                last_index=torch.from_numpy(last))
    assert tl.dtype == dtype and tuple(tl.shape) == (2, CFG.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=TOL[dtype],
                               atol=TOL[dtype])
    for n in ("k", "v"):
        assert tuple(tc["p0"][n].shape) == jc["p0"][n].shape
        np.testing.assert_allclose(_np(tc["p0"][n]), _np(jc["p0"][n]),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def _paged_state(seed=2, n_pages=12, page=4, maxp=4):
    """A random bf16 pool (reps, P, page, kv, hd) and a block table for
    two slots with disjoint pages."""
    rng = np.random.default_rng(seed)
    shape = (CFG.n_repeats, n_pages, page, CFG.n_kv_heads, CFG.head_dim)
    pool = {n: rng.standard_normal(shape, np.float32) for n in ("k", "v")}
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    return pool, bt


def _pools(pool):
    jpool = {"p0": {n: jnp.asarray(a, jnp.bfloat16) for n, a in pool.items()}}
    tpool = {"p0": {n: torch.from_numpy(a).to(torch.bfloat16)
                    for n, a in pool.items()}}
    return jpool, tpool


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_step_matches_jax(params, dtype):
    from repro.models.layers import PagedView as JView
    jp, tp = params
    pool, bt = _paged_state()
    jpool, tpool = _pools(pool)
    lens = np.array([9, 2], np.int32)
    toks = np.array([[17], [201]])
    jl, jnew = JModel(JCFG).decode_step(
        jp, jpool, jnp.asarray(toks), jnp.asarray(lens),
        compute_dtype=JDT[dtype], paging=JView(jnp.asarray(bt),
                                               jnp.asarray(lens)))
    tl, tnew = Model(CFG).decode_step(
        tp, tpool, torch.from_numpy(toks), torch.from_numpy(lens),
        compute_dtype=dtype, paging=PagedView(torch.from_numpy(bt),
                                              torch.from_numpy(lens)))
    assert tnew is tpool                   # written in place
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=TOL[dtype],
                               atol=TOL[dtype])
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tnew["p0"][n]), _np(jnew["p0"][n]),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("start,n_valid", [(0, 6), (5, 3)])
def test_prefill_chunk_matches_jax(params, dtype, start, n_valid):
    from repro.models.layers import PagedView as JView
    jp, tp = params
    pool, bt = _paged_state(seed=3)
    jpool, tpool = _pools(pool)
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (1, 6))
    st, nv = np.array([start], np.int32), np.array([n_valid], np.int32)
    jl, jnew = JModel(JCFG).prefill_chunk(
        jp, jpool, jnp.asarray(toks),
        JView(jnp.asarray(bt[:1]), jnp.asarray(st), n_valid=jnp.asarray(nv),
              null_page=jnp.int32(0)), compute_dtype=JDT[dtype])
    tl, tnew = Model(CFG).prefill_chunk(
        tp, tpool, torch.from_numpy(toks),
        PagedView(torch.from_numpy(bt[:1]), torch.from_numpy(st),
                  n_valid=torch.from_numpy(nv), null_page=0),
        compute_dtype=dtype)
    assert tuple(tl.shape) == (1, 6, CFG.vocab_size)
    np.testing.assert_allclose(_np(tl[:, :n_valid]), _np(jl[:, :n_valid]),
                               rtol=TOL[dtype], atol=TOL[dtype])
    for n in ("k", "v"):        # page 0 takes the padding rows: skip it
        np.testing.assert_allclose(_np(tnew["p0"][n][:, 1:]),
                                   _np(jnew["p0"][n][:, 1:]),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the contiguous prefill-then-decode path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_contiguous_decode_steps_match_jax(params, dtype):
    """Right-padded prefill (the JAX ``_contiguous_greedy`` recipe), then
    decode steps at a scalar ``cache_index`` writing the contiguous cache
    in place: logits and caches against the JAX package's."""
    jp, tp = params
    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 16))
    toks[:, 9:] = 0
    last = np.array([8, 8])
    jl, jc = JModel(JCFG).prefill(jp, {"tokens": jnp.asarray(toks)},
                                  compute_dtype=JDT[dtype],
                                  last_index=jnp.asarray(last))
    tl, tc = Model(CFG).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                compute_dtype=dtype,
                                last_index=torch.from_numpy(last))
    for i in range(4):
        nxt = np.argmax(_np(jl), -1)[:, None]
        jl, jc = JModel(JCFG).decode_step(jp, jc, jnp.asarray(nxt),
                                          jnp.int32(9 + i),
                                          compute_dtype=JDT[dtype])
        cache = tc
        tl, tc = Model(CFG).decode_step(tp, tc, torch.from_numpy(nxt),
                                        torch.tensor(9 + i),
                                        compute_dtype=dtype)
        assert tc is cache                 # written in place
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"step {i}")
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tc["p0"][n]), _np(jc["p0"][n]),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_contiguous_greedy_stream_equals_the_paged_engine():
    """The port against itself in float32: each prompt alone through the
    contiguous path gives the stream the paged engine gives it."""
    from repro_torch.serve import Engine, EngineConfig
    tp = Model(CFG).init(torch.Generator().manual_seed(1), device="cpu")
    prompts, gen, cap = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 13, 7]], 7, 32
    eng = Engine(CFG, EngineConfig(n_slots=2, page_size=4, max_seq_len=cap,
                                   max_prompt_len=8),
                 params=tp, device="cpu", compute_dtype=torch.float32)
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    model = Model(CFG)
    for prompt, req in zip(prompts, reqs):
        toks = torch.zeros((1, cap), dtype=torch.long)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        logits, cache = model.prefill(tp, {"tokens": toks},
                                      compute_dtype=torch.float32,
                                      last_index=torch.tensor([len(prompt) - 1]))
        # the engine's pool holds bf16 KV: so does this cache
        cache = P.tree_map(lambda t: t.to(torch.bfloat16), cache)
        out = [int(torch.argmax(logits[0]))]
        for i in range(gen - 1):
            logits, cache = model.decode_step(
                tp, cache, torch.tensor([[out[-1]]]), len(prompt) + i,
                compute_dtype=torch.float32)
            out.append(int(torch.argmax(logits[0])))
        assert out == req.tokens, (prompt, out, req.tokens)
