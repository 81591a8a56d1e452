"""The port's sequence mixers (Mamba, mLSTM, sLSTM) and the two models
built from them, jamba-v0.1-52b and xlstm-1.3b (SMOKE), against the JAX
package on the CPU, from the same numpy inputs and the same parameters
(a JAX draw carried across), every JAX call under ``jax.jit``.

Tolerances, float32 on both sides: the mixers 1e-4 (rtol and atol; the
same recurrences with sums and scans in another order, the in-chunk scan
a doubling scan here and ``associative_scan`` there), the models' logits
and losses 2e-4 (four layers of such differences).  A conv ring state is
stored in bfloat16, so it is held within one bf16 rounding (2^-7 of its
value).  Engines are held token for token: the port's float32 Engine
against the JAX Engine run at float32 compute (its ``Model.prefill`` and
``decode_step`` given ``compute_dtype=float32``), both keeping KV in a
bf16 pool and the state in the pool's dtypes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import MambaConfig as JMambaConfig  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import XLSTMConfig as JXLSTMConfig  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import (MambaConfig, ModelConfig,  # noqa: E402
                                      XLSTMConfig)
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.layers import PagedView  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402
from repro_torch.serve import paging as tpaging  # noqa: E402

MIX_TOL = 1e-4
MODEL_TOL = 2e-4
BF16_REL = 2.0 ** -7          # one bf16 rounding of a stored value
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-1.3b"
ARCHS = [JAMBA, XLSTM]

_MIX = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
            n_kv_heads=4, d_ff=0, vocab_size=64, pos_type="none")


def mk_cfgs(kind):
    """(JAX config, port config) of one mixer, as tests/test_seq_mixers.py
    builds it (chunk 4 for mLSTM)."""
    j = JModelConfig(**_MIX, block_pattern=(kind,),
                     mamba=JMambaConfig(d_state=8, d_conv=4, expand=2),
                     xlstm=JXLSTMConfig(n_heads=4, expand=2, d_conv=4,
                                        chunk_size=4))
    t = ModelConfig(**_MIX, block_pattern=(kind,),
                    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
                    xlstm=XLSTMConfig(n_heads=4, expand=2, d_conv=4,
                                      chunk_size=4))
    return j, t


MODULES = {"mamba": (jmamba.mamba_defs, jmamba.mamba_apply,
                     jmamba.mamba_cache_shape, tmamba.mamba_apply,
                     tmamba.mamba_cache_shape),
           "mlstm": (jxlstm.mlstm_defs, jxlstm.mlstm_apply,
                     jxlstm.mlstm_cache_shape, txlstm.mlstm_apply,
                     txlstm.mlstm_cache_shape),
           "slstm": (jxlstm.slstm_defs, jxlstm.slstm_apply,
                     jxlstm.slstm_cache_shape, txlstm.slstm_apply,
                     txlstm.slstm_cache_shape)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


def _close_state(got, want, tol, msg=""):
    """A state dict leaf by leaf; a bfloat16 leaf within one rounding."""
    assert set(got) == set(want), msg
    for n in want:
        bf = got[n].dtype == torch.bfloat16
        np.testing.assert_allclose(
            _np(got[n]), _np(want[n]), rtol=BF16_REL if bf else tol,
            atol=BF16_REL * 1e-2 if bf else tol, err_msg=f"{msg} {n}")


def _mixer(kind, seed=0):
    """(JAX config, port config, JAX params, port params) of one mixer."""
    jcfg, tcfg = mk_cfgs(kind)
    jp = JP.init_params(MODULES[kind][0](jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, P.from_numpy(jax.device_get(jp))


def _state(shapes, rng, m):
    """A cache of the schema's dtypes (conv bf16, the rest float32):
    ``m`` "zero", "neg" (NEG) or "rand"; every other leaf random, or
    zero with m "zero"."""
    out = {}
    for n, sh in shapes.items():
        if n == "m":
            a = {"zero": np.zeros(sh), "neg": np.full(sh, -1e30),
                 "rand": rng.standard_normal(sh) * 0.5}[m]
        elif m == "zero":
            a = np.zeros(sh)
        else:
            a = rng.standard_normal(sh) * 0.5
            if n == "n" and len(sh) == 2:          # sLSTM's n stays positive
                a = np.abs(a) + 0.5
        dt = "bfloat16" if n == "conv" else "float32"
        out[n] = a.astype(np.float32)
        if dt == "bfloat16":
            out[n] = np.array(jnp.asarray(out[n], jnp.bfloat16)
                              .astype(jnp.float32))
    return out


def _both_states(st):
    j = {n: jnp.asarray(a, jnp.bfloat16 if n == "conv" else jnp.float32)
         for n, a in st.items()}
    t = {n: torch.from_numpy(a).to(torch.bfloat16 if n == "conv"
                                   else torch.float32)
         for n, a in st.items()}
    return j, t


def _run_both(kind, x, state=None, seed=0):
    """The mixer on x, JAX (jitted) and port, optionally from ``state``
    (numpy leaves): ((jax out, jax cache), (port out, port cache))."""
    jcfg, tcfg, jp, tp = _mixer(kind, seed)
    japply, tapply = MODULES[kind][1], MODULES[kind][3]
    jstate, tstate = (None, None) if state is None else _both_states(state)
    jout = jax.jit(lambda p, x, c: japply(jcfg, p, x, cache=c))(
        jp, jnp.asarray(x), jstate)
    tout = tapply(tcfg, tp, torch.from_numpy(x), cache=tstate)
    return jout, tout


# ---------------------------------------------------------------------------
# the mixers against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [11, 300])          # a chunk tail; 2 chunks
@pytest.mark.parametrize("start", ["none", "zero", "rand"])
def test_mamba_apply_matches_jax(s, start):
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((2, s, 32)) * 0.5).astype(np.float32)
    state = None if start == "none" else _state(
        jmamba.mamba_cache_shape(mk_cfgs("mamba")[0], 2), rng, start)
    (jo, jc), (to, tc) = _run_both("mamba", x, state)
    _close(to, jo, MIX_TOL)
    assert (tc is None) == (jc is None)
    if jc is not None:
        _close_state(tc, jc, MIX_TOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_one_step_decode_matches_jax(kind):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 1, 32)) * 0.5).astype(np.float32)
    state = _state(MODULES[kind][2](mk_cfgs(kind)[0], 3), rng, "rand")
    (jo, jc), (to, tc) = _run_both(kind, x, state)
    _close(to, jo, MIX_TOL)
    _close_state(tc, jc, MIX_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("start", ["none", "zero", "rand"])
def test_xlstm_apply_matches_jax(kind, start):
    """S = 13 over chunks of 4 (a tail of 1): without a cache (m = NEG,
    the training start), from a zeroed cache (m = 0, the serving start)
    and from a random state."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 13, 32)) * 0.5).astype(np.float32)
    state = None if start == "none" else _state(
        MODULES[kind][2](mk_cfgs(kind)[0], 2), rng, start)
    (jo, jc), (to, tc) = _run_both(kind, x, state)
    _close(to, jo, MIX_TOL)
    if jc is not None:
        _close_state(tc, jc, MIX_TOL)


# ---------------------------------------------------------------------------
# training: the scan's recompute backward and the mixers' gradients
# ---------------------------------------------------------------------------

SCAN_TOL = 1e-4       # against jax.vjp of _fused_ssm: the same bf16
                      # residuals, float32 sums in another order
# against float32 autograd: the backward recomputes from dt, B, C and u
# rounded to bf16, whose rounding alone moves a value by 2^-8 / sqrt(3) =
# 2.3e-3 in RMS (the reference's "~0.2%"); a cotangent takes two or three
# such factors, so it lies several such roundings from float32's
RESIDUAL_TOL = 1e-2
GRAD_FLOOR = 1e-5     # a gradient leaf's scale, at least this share of
                      # the largest leaf's: below it lies rounding noise


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scan_inputs(s, h0, seed=0, b=2, c=6, n=4):
    """dt, B, C, u, A, h0 and the cotangents dy, dh_last (numpy float32):
    dt positive and small as softplus gives it, A = -exp(.)."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    ins = [np.abs(f(b, s, c)) * 0.3, f(b, s, n), f(b, s, n), f(b, s, c),
           -np.exp(f(c, n) * 0.5), f(b, c, n) if h0 else
           np.zeros((b, c, n), np.float32)]
    return ins, f(b, s, c), f(b, c, n)


def _plain_scan(dt, bmat, cmat, u, a, h0):
    """The recurrence one step at a time, out of place, for autograd."""
    h, ys = h0, []
    for t in range(dt.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[..., None] * bmat[:, t, None, :])
        ys.append(torch.einsum("bcn,bn->bc", h, cmat[:, t]))
    return torch.stack(ys, dim=1), h


def _scan_grads(fn, ins, dy, dh):
    leaves = [torch.from_numpy(x).requires_grad_() for x in ins]
    y, h = fn(*leaves)
    return (y, h) + torch.autograd.grad(
        (y, h), leaves, (torch.from_numpy(dy), torch.from_numpy(dh)))


@pytest.mark.parametrize("s,ch", [(20, 8), (16, 8)])      # a tail; whole
@pytest.mark.parametrize("h0", [False, True], ids=["h0-zero", "h0-drawn"])
@pytest.mark.parametrize("dh", [False, True], ids=["dh-zero", "dh-drawn"])
def test_selective_scan_matches_jax_vjp(s, ch, h0, dh):
    """SelectiveScan's y, h_last and six cotangents (dt, B, C, u, A, h0)
    against jax.vjp of the reference's ``_fused_ssm``, float32, a
    ragged last chunk (20 over 8) and none (16 over 8)."""
    ins, dy, dh_last = _scan_inputs(s, h0)
    if not dh:
        dh_last = np.zeros_like(dh_last)
    (jy, jh), vjp = jax.vjp(lambda *x: jmamba._fused_ssm(*x, ch),
                            *map(jnp.asarray, ins))
    want = (jy, jh) + vjp((jnp.asarray(dy), jnp.asarray(dh_last)))
    got = _scan_grads(lambda *x: tmamba.SelectiveScan.apply(*x, ch), ins,
                      dy, dh_last)
    names = ("y", "h_last", "dt", "B", "C", "u", "A", "h0")
    for name, g, w in zip(names, got, want):
        assert _rel(g, w) <= SCAN_TOL, name


@pytest.mark.parametrize("s,ch", [(20, 8), (13, 4)])
def test_selective_scan_matches_float32_autograd(s, ch):
    """The Function against autograd through the plain step-by-step
    recurrence in float32: the cotangents within the bf16 residuals'
    rounding (RESIDUAL_TOL), the forward (float32 throughout) within
    SCAN_TOL."""
    ins, dy, dh_last = _scan_inputs(s, True, seed=1)
    got = _scan_grads(lambda *x: tmamba.SelectiveScan.apply(*x, ch), ins,
                      dy, dh_last)
    want = _scan_grads(_plain_scan, ins, dy, dh_last)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= (SCAN_TOL if i < 2 else RESIDUAL_TOL), i


def test_selective_scan_saves_residuals_not_states():
    """What the Function keeps for its backward: dt, B, C, u in bfloat16
    (O(S (d_in + 2N))), A, and one float32 state a chunk, never the
    (B, S, d_in, N) states; nothing when no input needs a gradient."""
    b, s, c, n, ch = 2, 40, 6, 4, 8
    ins, _, _ = _scan_inputs(s, True, b=b, c=c, n=n)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    leaves = [torch.from_numpy(x).requires_grad_() for x in ins]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tmamba.SelectiveScan.apply(*leaves, ch)
    bf, f32 = torch.bfloat16, torch.float32
    assert saved == [((b, s, c), bf), ((b, s, n), bf), ((b, s, n), bf),
                     ((b, s, c), bf), ((c, n), f32),
                     ((s // ch, b, c, n), f32)]
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tmamba.SelectiveScan.apply(*map(torch.from_numpy, ins), ch)
    assert saved == []


def test_selective_scan_forward_keeps_the_serving_bits():
    """The Function's forward is the chunked in-place scan the serving
    path ran before the backward existed, bit for bit (a prefill gives
    the same logits and state as before)."""
    ins, _, _ = _scan_inputs(300, True, seed=2, c=16, n=8)
    dt, bmat, cmat, u, a, h = map(torch.from_numpy, ins)
    ys = []
    for c0 in range(0, 300, 256):
        sl = slice(c0, c0 + 256)
        da = torch.exp(dt[:, sl][..., None] * a)
        dbx = (dt[:, sl] * u[:, sl])[..., None] * bmat[:, sl, None, :]
        aa, bb = tmamba._doubling_scan(da, dbx)
        hs = bb.addcmul_(aa, h[:, None])
        ys.append(torch.einsum("blcn,bln->blc", hs, cmat[:, sl]))
        h = hs[:, -1]
    with torch.no_grad():
        y, h_last = tmamba.SelectiveScan.apply(*map(torch.from_numpy, ins),
                                               256)
    assert torch.equal(y, torch.cat(ys, dim=1)) and torch.equal(h_last, h)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_gradients_match_jax(kind):
    """Each mixer in training (no cache: xLSTM from m = NEG) under
    autograd, against jax.grad of the reference's mixer: the gradients
    of sum(out * w) for the input and every parameter leaf, float32.
    S = 13 leaves a ragged chunk in mLSTM (chunks of 4)."""
    jcfg, tcfg, jp, tp = _mixer(kind, seed=5)
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, 13, 32)) * 0.5).astype(np.float32)
    w = rng.standard_normal((2, 13, 32)).astype(np.float32)
    japply, tapply = MODULES[kind][1], MODULES[kind][3]
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(
        japply(jcfg, p, x, cache=None)[0] * w), argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = P.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out, cache = tapply(tcfg, tp, tx)
    assert cache is None
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             [tx] + leaves)
    _close(tg[0], jg[1], MIX_TOL, "x")
    want = {n: np.asarray(j, np.float32)
            for n, j in jax.device_get(jg[0]).items()}
    got = P.tree_unflatten(tp, tg[1:])
    assert set(got) == set(want)
    # each leaf to its own scale, floored at GRAD_FLOOR of the largest
    # gradient: the sLSTM's input-gate bias has none in exact arithmetic
    # (a shift of every input gate cancels in c / n), only rounding noise
    top = max(float(np.abs(j).max()) for j in want.values())
    for name, j in want.items():
        scale = max(float(np.abs(j).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(_np(got[name]), j, rtol=0,
                                   atol=MIX_TOL * scale, err_msg=name)


def test_cummax_routes_a_tie_as_jax():
    """``_cummax``'s gradient on tied running maxima equals JAX's
    ``lax.cummax`` (an associative scan of maximum: each combine splits
    a tie's gradient), where ``torch.cummax`` sends it to one index;
    ``torch.maximum`` halves a tie as ``jnp.maximum`` does.  The values
    equal torch.cummax's."""
    for row in ([1., 3., 3., 2., 3., 0.], [2.] * 5, [0., 1., 1.],
                [1., 1., 0., 1., 1., 1., 1.]):
        x = np.array(row, np.float32)
        wt = np.arange(1, len(row) + 1, dtype=np.float32)
        t = torch.from_numpy(x).requires_grad_()
        v = txlstm._cummax(t)
        assert torch.equal(v, torch.cummax(t, dim=0).values)
        got = torch.autograd.grad((v * torch.from_numpy(wt)).sum(), t)[0]
        want = jax.grad(lambda a: jnp.sum(jax.lax.cummax(a, 0) * wt))(
            jnp.asarray(x))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    a = torch.tensor([1., 2.], requires_grad=True)
    b = torch.tensor([1., 3.], requires_grad=True)
    ja, jb = jax.grad(lambda a, b: jnp.sum(jnp.maximum(a, b)), (0, 1))(
        jnp.array([1., 2.]), jnp.array([1., 3.]))
    ga, gb = torch.autograd.grad(torch.maximum(a, b).sum(), (a, b))
    np.testing.assert_array_equal(_np(ga), np.asarray(ja))
    np.testing.assert_array_equal(_np(gb), np.asarray(jb))


def test_custom_inits_deterministic_leaves_equal_jax():
    """a_log = log 1..d_state (within one float32 ulp: the two libraries'
    logs round differently) and the forget-gate biases 3.0 equal the JAX
    init; dt_bias is softplus^-1 of a dt in [1e-3, 1e-1]; the
    reference reads a_log, the gate biases, r and hnorm in float32, so a
    bf16 draw keeps them float32."""
    for kind, leaves in (("mamba", ("a_log",)), ("mlstm", ("b_f",)),
                         ("slstm", ("b_f",))):
        jcfg, tcfg = mk_cfgs(kind)
        jp = JP.init_params(MODULES[kind][0](jcfg), jax.random.PRNGKey(0))
        defs = {"mamba": tmamba.mamba_defs, "mlstm": txlstm.mlstm_defs,
                "slstm": txlstm.slstm_defs}[kind](tcfg)
        tp = P.init_params(defs, torch.Generator().manual_seed(0),
                           torch.bfloat16, "cpu")
        for n in leaves:
            assert tp[n].dtype == torch.float32
            np.testing.assert_allclose(_np(tp[n]), _np(jp[n]), rtol=2 ** -23,
                                       atol=0)
        if kind == "mamba":
            dt = torch.nn.functional.softplus(tp["dt_bias"].float())
            assert float(dt.min()) >= 1e-3 * 0.99
            assert float(dt.max()) <= 1e-1 * 1.01
            assert tp["in_proj"].dtype == torch.bfloat16
        if kind == "slstm":
            for n in ("r", "b_i", "b_z", "b_o", "hnorm"):
                assert tp[n].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_schemas_equal_jax(arch):
    jcfg, tcfg = jreg.smoke(arch), treg.smoke(arch)
    for jd, td in ((jtr.cache_defs(jcfg, 3, 16), ttr.cache_defs(tcfg, 3, 16)),
                   (jtr.paged_cache_defs(jcfg, 2, 9, 4),
                    ttr.paged_cache_defs(tcfg, 2, 9, 4))):
        assert set(jd) == set(td)
        for key in jd:
            assert set(jd[key]) == set(td[key]), key
            for n, j in jd[key].items():
                t = td[key][n]
                assert (t.shape, t.init, t.dtype) == (j.shape, j.init,
                                                      j.dtype), (key, n)


# ---------------------------------------------------------------------------
# the port's own oracles (tests/test_seq_mixers.py's five)
# ---------------------------------------------------------------------------


def _tmixer(kind, seed=0):
    _, tcfg = mk_cfgs(kind)
    defs = {"mamba": tmamba.mamba_defs, "mlstm": txlstm.mlstm_defs,
            "slstm": txlstm.slstm_defs}[kind](tcfg)
    return tcfg, P.init_params(defs, torch.Generator().manual_seed(seed),
                               torch.float32, "cpu")


def _tcache(kind, cfg, b, m):
    return {n: (torch.full(sh, m) if n == "m" else torch.zeros(sh))
            for n, sh in MODULES[kind][4](cfg, b).items()}


@pytest.mark.parametrize("kind,s,m", [("mlstm", 13, -1e30),
                                      ("mamba", 11, 0.0)])
def test_chunked_equals_stepwise_decode(kind, s, m):
    cfg, p = _tmixer(kind)
    x = torch.randn((2, s, 32), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    apply = MODULES[kind][3]
    par, _ = apply(cfg, p, x)
    cache = _tcache(kind, cfg, 2, m)
    outs = []
    for t in range(s):
        o, cache = apply(cfg, p, x[:, t:t + 1], cache=cache)
        outs.append(o)
    torch.testing.assert_close(par, torch.cat(outs, 1), rtol=2e-4, atol=2e-4)


def test_mamba_prefill_state_continues_decode():
    cfg, p = _tmixer("mamba")
    x = torch.randn((1, 12, 32), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    full, _ = tmamba.mamba_apply(cfg, p, x)
    pre, cache = tmamba.mamba_apply(cfg, p, x[:, :8],
                                    cache=_tcache("mamba", cfg, 1, 0.0))
    outs = [pre]
    for t in range(8, 12):
        o, cache = tmamba.mamba_apply(cfg, p, x[:, t:t + 1], cache=cache)
        outs.append(o)
    torch.testing.assert_close(full, torch.cat(outs, 1), rtol=2e-4, atol=2e-4)


def test_mlstm_gates_stabilized_no_overflow():
    cfg, p = _tmixer("mlstm")
    p = P.tree_map(lambda a: a * 5.0, p)
    x = torch.randn((1, 32, 32), generator=torch.Generator().manual_seed(1)) \
        * 3.0
    out, _ = txlstm.mlstm_apply(cfg, p, x)
    assert torch.isfinite(out).all()


def test_slstm_sequential_finite_and_stateful():
    cfg, p = _tmixer("slstm")
    x = torch.randn((2, 9, 32), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    out, _ = txlstm.slstm_apply(cfg, p, x)
    assert torch.isfinite(out).all()
    p = dict(p, r=p["r"] * 100.0)
    cache = _tcache("slstm", cfg, 2, -1e30)
    o1, cache = txlstm.slstm_apply(cfg, p, x[:, :1], cache=cache)
    o2, _ = txlstm.slstm_apply(cfg, p, x[:, :1], cache=cache)
    assert not torch.allclose(o1, o2, atol=1e-9)


# ---------------------------------------------------------------------------
# jamba and xlstm SMOKE: the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch id, JAX SMOKE config, port SMOKE config, JAX params, port
    params): the port's params are the JAX draw carried across."""
    jcfg, tcfg = jreg.smoke(request.param), treg.smoke(request.param)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    return request.param, jcfg, tcfg, jp, P.from_numpy(jax.device_get(jp))


def test_param_counts_equal_jax(arch):
    _, jcfg, tcfg, _, _ = arch
    assert Model(tcfg).n_params() == JModel(jcfg).n_params()
    assert tcfg.n_params() == jcfg.n_params()
    for name in ARCHS:
        assert treg.get(name).n_params() == jreg.get(name).n_params()
        assert (Model(treg.get(name)).n_params()
                == JModel(jreg.get(name)).n_params())


def test_train_logits_and_loss_match_jax(arch):
    """Training starts each xLSTM state at m = NEG (no cache)."""
    _, jcfg, tcfg, jp, tp = arch
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 13))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, _, _ = jax.jit(lambda p, t: JModel(jcfg)._trunk(
        p, t, mode="train", remat=False, compute_dtype=jnp.float32))(
        jp, jnp.asarray(toks))
    jloss, jm = jax.jit(lambda p, b: JModel(jcfg).loss(
        p, b, remat=False, compute_dtype=jnp.float32))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tt = torch.from_numpy(toks)
        tl, _, _ = Model(tcfg)._trunk(tp, tt, torch.arange(13),
                                      mode="train",
                                      compute_dtype=torch.float32)
        tloss, tm = Model(tcfg).loss(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()},
            compute_dtype=torch.float32)
    _close(tl, jl, MODEL_TOL)
    for k in ("loss", "xent", "moe_aux"):
        _close(tm[k], jm[k], MODEL_TOL, k)


def test_prefill_and_contiguous_decode_match_jax(arch):
    """Model.prefill at the exact prompt length (zeroed state: m = 0),
    the KV padded for headroom, then 4 decode steps at a scalar index:
    last logits and every cache leaf."""
    _, jcfg, tcfg, jp, tp = arch
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9))
    forced = rng.integers(0, jcfg.vocab_size, (4, 2, 1))
    jl, jc = jax.jit(lambda p, t: JModel(jcfg).prefill(
        p, {"tokens": t}, compute_dtype=jnp.float32))(jp, jnp.asarray(toks))
    tl, tc = Model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 compute_dtype=torch.float32)
    _close(tl, jl, MODEL_TOL, "prefill")
    jc = jpaging.pad_prefill_cache(jcfg, jc, 16)
    tc = tpaging.pad_prefill_cache(tcfg, tc, 16)
    step = jax.jit(functools.partial(JModel(jcfg).decode_step,
                                     compute_dtype=jnp.float32))
    for i in range(4):
        jl, jc = step(jp, jc, jnp.asarray(forced[i]), jnp.int32(9 + i))
        tl, tc = Model(tcfg).decode_step(tp, tc, torch.from_numpy(forced[i]),
                                         9 + i, compute_dtype=torch.float32)
        _close(tl, jl, MODEL_TOL, f"step {i}")
    for key in jc:
        _close_state(tc[key], jc[key], MODEL_TOL, key)


def test_chunk_prefill_refuses_sequence_mixers(arch):
    """A sequence mixer's recurrence cannot skip a chunk's padded rows
    (training them is held in tests/test_torch_train.py)."""
    _, _, tcfg, _, tp = arch
    with pytest.raises(ValueError, match="prefill exactly"):
        Model(tcfg).prefill_chunk(tp, None, torch.zeros((1, 4), dtype=torch.long),
                                  PagedView(torch.zeros((1, 1)),
                                            torch.zeros(1)))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ECFG = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8)
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [2, 4, 6, 8, 10, 12, 14]]
NEW = [6, 5, 4]


def _f32_jax_engine(monkeypatch):
    """The JAX Engine at float32 compute: its prefill and decode steps
    call ``Model.prefill`` / ``Model.decode_step`` with the default bf16
    compute dtype, which this replaces."""
    prefill, decode = JModel.prefill, JModel.decode_step
    monkeypatch.setattr(JModel, "prefill", lambda self, *a, **k: prefill(
        self, *a, **dict(k, compute_dtype=jnp.float32)))
    monkeypatch.setattr(JModel, "decode_step", lambda self, *a, **k: decode(
        self, *a, **dict(k, compute_dtype=jnp.float32)))


def _engine(tcfg, tp, **kw):
    return Engine(tcfg, EngineConfig(**dict(ECFG, **kw)), params=tp,
                  device="cpu", compute_dtype=torch.float32)


def _drive(eng):
    """The three prompts on two slots: the third waits for an eviction
    and reuses the freed slot (its state rows) and pages."""
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    eng.run()
    assert all(r.finished for r in reqs) and eng.alloc.pages_in_use() == 0
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(arch):
    mp = pytest.MonkeyPatch()
    try:
        _f32_jax_engine(mp)
        _, jcfg, _, jp, _ = arch
        jeng = JEngine(jcfg, JEngineConfig(**ECFG), params=jp)
        reqs = [jeng.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, NEW)]
        jeng.run()
        assert jeng._pc_misses == 3       # one prefill a prompt length
        return [r.tokens for r in reqs]
    finally:
        mp.undo()


@pytest.mark.parametrize("chunk", [0, 4], ids=["legacy", "chunk4"])
def test_engine_f32_greedy_matches_jax_engine(arch, jax_streams, chunk):
    """Prompts of 3, 5 and 7 tokens (no page multiple), prefilled at
    their exact lengths; a prefill_chunk > 0 engine takes no chunked
    tick on these arches, as the JAX engine does."""
    _, _, tcfg, _, tp = arch
    eng = _engine(tcfg, tp, prefill_chunk=chunk)
    assert _drive(eng) == jax_streams
    assert eng.n_mixed_steps == 0 and eng.stats()["n_mixed_steps"] == 0
    assert eng.metrics.value("serve_ticks_total", kind="mixed") == 0
    assert eng.n_prefills == 3 and eng.n_prefill_tokens == 15


def test_snapshot_then_adopt_carries_the_state(arch, jax_streams):
    """Parked after 2 decode ticks, adopted by a fresh engine: the state
    leaves ride the snapshot and the streams stay the uninterrupted
    run's, token for token."""
    _, _, tcfg, _, tp = arch
    eng = _engine(tcfg, tp)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    while eng.n_decode_steps < 2:
        assert eng.step()
    snap = eng.snapshot_state()
    states = {(k, n) for i, kind in enumerate(tcfg.block_pattern)
              if kind != "attn" for k in [f"p{i}"] for n in snap["pool"][k]}
    # m may stay 0 (zero-initialized input gates); every other leaf moved
    assert states and all(snap["pool"][k][n].abs().sum() > 0
                          for k, n in states if n != "m")
    for k, n in states:
        assert torch.equal(snap["pool"][k][n], eng.pool[k][n])
    new = _engine(tcfg, tp)
    new.adopt_state(snap)
    for k, n in states:
        assert torch.equal(new.pool[k][n], snap["pool"][k][n])
    new.run()
    assert [r.tokens for r in reqs] == jax_streams


def test_reused_slot_equals_a_fresh_engine(arch):
    """One slot: the second request is admitted into the slot the first
    just left, and its stream equals a fresh engine's (its prefill
    overwrote every state leaf)."""
    _, _, tcfg, _, tp = arch
    eng = _engine(tcfg, tp, n_slots=1)
    first = eng.submit(PROMPTS[2], max_new_tokens=5)
    eng.run()
    second = eng.submit(PROMPTS[1], max_new_tokens=5)
    eng.run()
    assert first.slot == second.slot == 0
    fresh = _engine(tcfg, tp, n_slots=1)
    want = fresh.submit(PROMPTS[1], max_new_tokens=5)
    fresh.run()
    assert second.tokens == want.tokens


TINY_HYBRID = dict(name="tiny-hybrid", family="hybrid", n_layers=2,
                   d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                   vocab_size=128, block_pattern=("attn", "mamba"))


def test_tiny_hybrid_paged_equals_contiguous():
    """tests/test_serve.py's TINY_HYBRID: the paged engine's greedy
    streams equal the contiguous path's (exact-length prefill, KV padded
    for headroom, decode steps at a scalar index)."""
    cfg = ModelConfig(**TINY_HYBRID, mamba=MambaConfig())
    jcfg = JModelConfig(**TINY_HYBRID, mamba=JMambaConfig())
    tp = P.from_numpy(jax.device_get(JModel(jcfg).init(
        jax.random.PRNGKey(0))))
    eng = Engine(cfg, EngineConfig(**ECFG), params=tp, device="cpu",
                 compute_dtype=torch.float32)
    reqs = [eng.submit(p, max_new_tokens=6) for p in ([1, 2, 3, 4, 5],
                                                      [7, 8, 9])]
    eng.run()
    model = Model(cfg)
    for req in reqs:
        logits, cache = model.prefill(tp, {"tokens": torch.tensor(
            [req.prompt])}, compute_dtype=torch.float32)
        cache = tpaging.pad_prefill_cache(cfg, cache, 32)
        # the engine's pool holds bf16 KV
        cache = {k: {n: (t.to(torch.bfloat16) if n in ("k", "v") else t)
                     for n, t in c.items()} for k, c in cache.items()}
        out = [int(torch.argmax(logits[0]))]
        for i in range(5):
            logits, cache = model.decode_step(
                tp, cache, torch.tensor([[out[-1]]]), len(req.prompt) + i,
                compute_dtype=torch.float32)
            out.append(int(torch.argmax(logits[0])))
        assert req.tokens == out


def test_tiny_hybrid_prefill_cache_equals_the_jax_engines():
    """tests/test_serve.py's LRU sequence: TINY_HYBRID prefills at the
    exact prompt length, prompts of 2, 3, 4, 2 tokens one after another
    at ``prefill_cache_cap=2`` (4 evicts 2, then 2 misses again): the
    stats and ``serve_prefill_compile_cache_total{event}`` equal the JAX
    engine's, and so do the greedy streams (float32 compute)."""
    cfg = ModelConfig(**TINY_HYBRID, mamba=MambaConfig())
    jcfg = JModelConfig(**TINY_HYBRID, mamba=JMambaConfig())
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    ecfg = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8,
                prefill_cache_cap=2)
    mp = pytest.MonkeyPatch()
    try:
        _f32_jax_engine(mp)
        jeng = JEngine(jcfg, JEngineConfig(**ecfg), params=jp)
        eng = Engine(cfg, EngineConfig(**ecfg),
                     params=P.from_numpy(jax.device_get(jp)), device="cpu",
                     compute_dtype=torch.float32)
        streams = []
        for e in (jeng, eng):
            reqs = []
            for plen in (2, 3, 4, 2):
                reqs.append(e.submit(list(range(1, plen + 1)),
                                     max_new_tokens=2))
                e.run()
            streams.append([r.tokens for r in reqs])
    finally:
        mp.undo()

    def counts(e):
        return ({k: e.metrics.value("serve_prefill_compile_cache_total",
                                    event=k)
                 for k in ("hit", "miss", "eviction")},
                e.stats()["prefill_cache"])

    assert counts(eng) == counts(jeng)
    assert counts(eng)[1] == {"size": 2, "cap": 2, "hits": 0, "misses": 4,
                              "evictions": 2}
    assert streams[0] == streams[1]
    assert list(eng._prefill_cache) == [4, 2]
