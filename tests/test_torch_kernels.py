"""The port's kernel modules against the JAX package's.

On the CPU each kernel wrapper runs its plain PyTorch version; those are
held against the JAX refs and against the Pallas kernels in interpret
mode on the same numpy inputs, at the tolerances of test_kernels.py
(2e-5 for float32: sums in another order; 2e-2 for bfloat16: one
rounding of the output, a few bf16 ulps).  The CUDA kernels are held
against the plain versions in test_torch_cuda.py.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import ref as jdec  # noqa: E402
from repro.kernels.flash_attention import kernel as jfa_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as jfa  # noqa: E402
from repro.kernels.rmsnorm import ref as jrn  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tdec  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tfa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfa  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as trn_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as trn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as trn  # noqa: E402

SHAPES = [
    # b, sq, skv, h, hkv, d, causal   (test_kernels.py:12-19)
    (2, 128, 128, 4, 2, 64, True),
    (1, 100, 100, 4, 4, 32, True),      # ragged (padding paths)
    (2, 64, 192, 6, 2, 32, False),      # cross-attention shape
    (1, 48, 48, 8, 1, 16, True),        # MQA
    (1, 33, 65, 2, 2, 128, True),       # odd sizes, offset
    (2, 130, 130, 8, 8, 32, True),      # lammps-proxy's heads (head dim 32)
    (1, 70, 70, 4, 2, 160, True),       # head dim 160 (pixtral-12b's)
    (2, 1, 150, 4, 4, 64, False),       # a decode step's cross-attention
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, jdt, tdt):
    """The same numpy values as a JAX and a torch array (bf16 rounds
    to nearest even on both sides, so the bits agree)."""
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _qkv(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


def _pool(n_pages, page, hkv, d, fills, maxp, seed=1):
    """Random pools and a block table whose rows own disjoint pages
    (page 0 the null page, unused entries pointing at it)."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages, page, hkv, d), np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d), np.float32)
    bt = np.zeros((len(fills), maxp), np.int32)
    nxt = 1
    for r, fill in enumerate(fills):
        for j in range(-(-fill // page)):
            bt[r, j] = nxt
            nxt += 1
    assert nxt <= n_pages
    return kp, vp, bt


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(8, 64), (100, 128), (256, 32)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_ref_matches_jax_ref_and_pallas(rows, d, dt):
    _, jdt, tdt, tol = DTYPES[dt]
    tol = 1e-5 if dt == "f32" else tol
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((2, rows, d), np.float32), jdt, tdt)
    w = rng.standard_normal((d,), np.float32)
    out = ops.rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == tdt and out.shape == xt.shape
    _close(out, jrn.rmsnorm_ref(xj, jnp.asarray(w)), tol)
    _close(out, jops.rmsnorm(xj, jnp.asarray(w), impl="interpret"), tol)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_chunked_matches_jax_ref_and_pallas(shape, dt):
    b, sq, skv, h, hkv, d, causal = shape
    _, jdt, tdt, tol = DTYPES[dt]
    q, k, v = _qkv(b, sq, skv, h, hkv, d)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, k, v))
    qo = skv - sq
    out = ops.flash_attention(qt, kt, vt, causal=causal, q_offset=qo)
    assert out.dtype == tdt and out.shape == qt.shape
    _close(out, jfa.chunked(qj, kj, vj, causal=causal, q_offset=qo), tol)
    pal, pal_lse = jfa_kernel.flash_fwd(qj, kj, vj, causal=causal,
                                        q_offset=qo, interpret=True)
    out2, lse = tfa.fwd(qt, kt, vt, causal=causal, q_offset=qo)
    _close(out2, pal, tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pal_lse),
                               rtol=2e-5, atol=2e-5)
    _close(tfa.naive(qt, kt, vt, causal=causal, q_offset=qo),
           jfa.naive(qj, kj, vj, causal=causal, q_offset=qo), tol)


@pytest.mark.parametrize("sq,skv,causal,qo", [
    (130, 200, True, 70),
    (200, 130, True, -70),              # rows 0..69 see no key
    (96, 257, False, 0),
])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,hkv", [(2, 2), (8, 2), (8, 1)])     # g 1, 4, 8
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_fwd_ref_at_the_kernel_tiles_matches_jax_ref_and_pallas(
        sq, skv, causal, qo, d, h, hkv, dt):
    """The plain forward at the CUDA kernel's geometry (a step of 64 keys
    at head dim 64, 128 at head dim 128), on shapes that cross several
    64-row tiles with ragged ends (head dim 32 steps as 64: the kernel
    runs it on 64-wide tiles), against the JAX ref at the same block
    and the Pallas forward with 64 x 64 blocks.  Out at the file's
    tolerance, lse within 2e-5 (float32 on every side).  A row that sees
    no key is held against the JAX ref only: the Pallas kernel skips the
    tiles above its tile's diagonal, so such a row averages only the keys
    of the tiles it does not skip."""
    _, jdt, tdt, tol = DTYPES[dt]
    q, k, v = _qkv(1, sq, skv, h, hkv, d, seed=3)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, k, v))
    kw = dict(causal=causal, q_offset=qo)
    step = 128 if d == 128 else 64
    out, lse = tfa.fwd(qt, kt, vt, block_kv=step, **kw)
    assert out.dtype == tdt and out.shape == qt.shape
    assert lse.dtype == torch.float32 and lse.shape == (1, sq, h)
    _close(out, jfa.chunked(qj, kj, vj, block_kv=step, **kw), tol)
    pal, pal_lse = jfa_kernel.flash_fwd(qj, kj, vj, bq=64, bkv=64,
                                        interpret=True, **kw)
    seen = slice(max(0, -qo) if causal else 0, sq)
    _close(out[:, seen], pal[:, seen], tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pal_lse), rtol=2e-5,
                               atol=2e-5)
    if causal and qo < 0:
        assert bool((lse[:, :-qo] == -1e30).all())


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_chunked_small_blocks_match_naive(shape):
    b, sq, skv, h, hkv, d, causal = shape
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, sq, skv, h, hkv, d))
    qo = skv - sq
    _close(tfa.chunked(q, k, v, causal=causal, q_offset=qo, block_kv=37),
           tfa.naive(q, k, v, causal=causal, q_offset=qo), 2e-5)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------


def _grad_inputs(shape, jdt, tdt):
    b, sq, skv, h, hkv, d, causal = shape
    q, k, v = _qkv(b, sq, skv, h, hkv, d)
    do = np.random.default_rng(5).standard_normal((b, sq, h, d), np.float32)
    return [_both(a, jdt, tdt) for a in (q, k, v, do)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_ref_matches_pallas_flash_bwd(shape, dt):
    """``ref.bwd`` on the Pallas forward's out and lse against the Pallas
    backward in interpret mode (GQA native on both sides)."""
    causal, qo = shape[-1], shape[2] - shape[1]
    _, jdt, tdt, tol = DTYPES[dt]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _grad_inputs(shape, jdt, tdt)
    out, lse = jfa_kernel.flash_fwd(qj, kj, vj, causal=causal, q_offset=qo,
                                    interpret=True)
    want = jfa_kernel.flash_bwd(qj, kj, vj, out, lse, doj, causal=causal,
                                q_offset=qo, interpret=True)
    got = tfa.bwd(qt, kt, vt, _both(np.array(out.astype(jnp.float32)),
                                    jdt, tdt)[1],
                  torch.from_numpy(np.array(lse)), dot, causal=causal,
                  q_offset=qo)
    for g, w, ref_t in zip(got, want, (qt, kt, vt)):
        assert g.dtype == tdt and g.shape == ref_t.shape
        _close(g, w, tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_grads_match_jax_grad_through_the_ref(shape, dt):
    """Autograd through the port's facade on the CPU (``ref.chunked``:
    KV repeated for GQA, ``ref.bwd`` as the custom backward) against
    ``jax.grad`` through the JAX facade's ref."""
    causal, qo = shape[-1], shape[2] - shape[1]
    _, jdt, tdt, tol = DTYPES[dt]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _grad_inputs(shape, jdt, tdt)

    def f(q, k, v):
        out = jops.flash_attention(q, k, v, causal=causal, q_offset=qo,
                                   impl="ref")
        return jnp.sum(out.astype(jnp.float32) * doj.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = ops.flash_attention(*leaves, causal=causal, q_offset=qo)
    got = torch.autograd.grad(out, leaves, dot)
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_flash_function_on_the_cpu_matches_autograd_of_naive(shape):
    """The kernel route's autograd Function, run on the CPU through the
    plain versions (GQA native in ``ref.bwd``), against autograd through
    the materialized oracle, in float32."""
    b, sq, skv, h, hkv, d, causal = shape
    qo = skv - sq
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(b, sq, skv, h, hkv, d))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, sq, h, d), np.float32))
    got = torch.autograd.grad(tfa_ops.flash_attention(
        q, k, v, causal=causal, q_offset=qo), (q, k, v), do)
    want = torch.autograd.grad(tfa.naive(q, k, v, causal=causal,
                                         q_offset=qo), (q, k, v), do)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_function_grads_match_jax_grad(dt):
    _, jdt, tdt, tol = DTYPES[dt]
    tol = 1e-5 if dt == "f32" else tol
    rng = np.random.default_rng(3)
    (xj, xt), (dyj, dyt) = (_both(rng.standard_normal((3, 20, 64),
                                                      np.float32), jdt, tdt)
                            for _ in range(2))
    w = rng.standard_normal((64,), np.float32)

    def f(x, w):
        y = jrn.rmsnorm_ref(x, w)
        return jnp.sum(y.astype(jnp.float32) * dyj.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1))(xj, jnp.asarray(w))
    xl, wl = xt.clone().requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(trn_ops.rmsnorm(xl, wl), (xl, wl), dyt)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    _close(got[0], want[0], tol)
    # dweight sums 60 rows of bf16-rounded terms
    _close(got[1], want[1], tol if dt == "f32" else 5e-2)


def test_raw_kernel_wrappers_refuse_to_cut_gradients():
    """The kernels launch through raw pointers and return tensors with
    no autograd history: under grad mode a raw wrapper refuses an input
    that requires grad (on every device, before it picks a route), and
    the facade takes the differentiable route instead."""
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    k = torch.randn(1, 8, 2, 64)
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.ones(64)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa_kernel.flash_fwd(q, k, k)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa_kernel.flash_bwd(q, k, k, q, torch.zeros(1, 8, 2), q)
    with pytest.raises(RuntimeError, match="requires grad"):
        trn_kernel.rmsnorm(x, w)
    with pytest.raises(RuntimeError, match="requires grad"):
        build.refuse_autograd("x", w, x)
    build.refuse_autograd("x", w, k)          # nothing requires grad
    with torch.no_grad():
        tfa_kernel.flash_fwd(q, k, k)
        trn_kernel.rmsnorm(x, w)
    assert ops.rmsnorm(x, w).requires_grad
    assert ops.flash_attention(q, k, k).requires_grad


@pytest.mark.parametrize("part", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_kernel_wrappers_check_their_own_inputs(part):
    """The dq and dk/dv wrappers launch through raw pointers themselves,
    so each refuses grad-mode inputs and anything but CUDA tensors
    without going through ``flash_bwd``."""
    fn = getattr(tfa_kernel, part)
    q = torch.randn(1, 8, 2, 64, dtype=torch.bfloat16)
    k = torch.randn(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(q.clone().requires_grad_(), k, k, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(q, k, k, q, lse, lse)
    build.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(q, k, k, q, lse, lse[..., :1])
    assert build.LAUNCHES[part] == 0


# ---------------------------------------------------------------------------
# decode attention (contiguous and paged)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smax,fill", [(96, 96), (96, 40), (64, 1)])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 8), (8, 1)])
def test_decode_ref_matches_jax_ref(smax, fill, h, hkv):
    q, k, v = _qkv(2, 1, smax, h, hkv, 32)
    out = tdec.decode_ref(*(torch.from_numpy(a) for a in (q, k, v)), fill)
    _close(out, jdec.decode_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), fill), 2e-5)


@pytest.mark.parametrize("fills", [
    [64, 33, 1], [40, 17, 16], [1, 1, 2],
    # slots over many pages (40 a slot), filled across where the CUDA
    # kernel's splits of whole pages fall (every 4 pages, 64 keys, at
    # these shapes: decode_attention.kernel.plan_splits), and the full slot
    [63, 64, 65], [640, 129, 448]])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 8), (8, 1)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_matches_jax_ref_and_pallas(fills, h, hkv, dt):
    _, jdt, tdt, tol = DTYPES[dt]
    page, d = 16, 32
    maxp = 4 if max(fills) <= 64 else 40
    n_pages = max(16, 1 + sum(-(-f // page) for f in fills))
    kp, vp, bt = _pool(n_pages, page, hkv, d, fills, maxp)
    q = np.random.default_rng(2).standard_normal((3, 1, h, d), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, kp, vp))
    lens = np.asarray(fills, np.int32)
    out = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                     torch.from_numpy(lens))
    assert out.dtype == tdt and out.shape == qt.shape
    _close(out, jdec.paged_decode_ref(qj, kj, vj, jnp.asarray(bt),
                                      jnp.asarray(lens)), tol)
    _close(out, jops.paged_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                            jnp.asarray(lens),
                                            impl="interpret"), tol)


@pytest.mark.parametrize("maxp,page,slots_heads,sms", [
    (64, 16, 32, 132), (64, 16, 64, 132), (40, 16, 6, 132), (1, 16, 8, 132),
    (0, 16, 8, 132), (100, 1, 1, 132), (7, 3, 1000, 132), (65, 16, 2, 16)])
def test_paged_decode_split_plan_covers_every_key_once(maxp, page,
                                                       slots_heads, sms):
    """The CUDA paged decode cuts each slot's block-table row into
    n_split splits of pages_per_split whole pages (the kernel takes
    ceil(maxp / n_split) itself): every key position of the row lies in
    exactly one split, no split is empty by construction, and the plan
    is a function of static shapes alone (no lengths)."""
    from repro_torch.kernels.decode_attention import kernel as tdk
    n, pps = tdk.plan_splits(maxp, page, slots_heads, sms)
    assert (n, pps) == tdk.plan_splits(maxp, page, slots_heads, sms)
    assert n >= 1 and pps == max(1, -(-maxp // n))
    seen = np.zeros(maxp * page, np.int32)
    for s in range(n):
        lo, hi = s * pps * page, min((s + 1) * pps * page, maxp * page)
        assert lo % page == 0 and (hi % page == 0 or hi == maxp * page)
        assert maxp == 0 or lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert n <= max(1, maxp)
    # each split holds at least MIN_SPLIT_KEYS keys unless the row is short
    if maxp * page >= tdk.MIN_SPLIT_KEYS and n > 1:
        assert pps * page >= tdk.MIN_SPLIT_KEYS


def _prefill_case(h, hkv, start, valid, chunk=8, page=8, d=32, b=2):
    rng = np.random.default_rng(3)
    fills = [start + chunk] * b
    maxp = max(4, -(-(start + chunk) // page))
    kp, vp, bt = _pool(max(16, 1 + b * maxp), page, hkv, d, fills, maxp,
                       seed=4)
    q = rng.standard_normal((b, chunk, h, d), np.float32)
    return q, kp, vp, bt, np.full((b,), start, np.int32), \
        np.full((b,), valid, np.int32)


PREFILL_CASES = [(4, 2, 0, 8), (4, 2, 8, 8), (8, 8, 5, 3), (8, 1, 13, 8),
                 (4, 2, 5, 6)]
# where the CUDA kernel's tiles bite: 64 packed rows span 64 / g chunk
# positions (g = H / Hkv of 1, 2, 7 and 8), steps of 64 keys, a fill
# (start + n_valid) on either side of a step, pages of 8, 16 and 64, and
# chunks of up to 128 rows: (h, hkv, start, n_valid, chunk, page)
PREFILL_TILE_CASES = [
    (8, 1, 0, 64, 64, 16), (2, 2, 0, 1, 64, 8), (14, 2, 37, 63, 64, 16),
    (4, 2, 37, 65, 128, 8), (8, 1, 64, 64, 128, 64), (7, 1, 64, 128, 128, 16),
    (4, 2, 250, 65, 96, 64), (8, 1, 250, 1, 32, 8), (2, 1, 0, 128, 128, 64),
    (1, 1, 37, 64, 64, 8),
    (8, 8, 37, 63, 64, 16)]             # lammps-proxy's heads: g = 1


@pytest.mark.parametrize("h,hkv,start,valid", PREFILL_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_prefill_matches_jax_ref_and_pallas(h, hkv, start, valid, dt):
    _, jdt, tdt, tol = DTYPES[dt]
    q, kp, vp, bt, st, nv = _prefill_case(h, hkv, start, valid)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, kp, vp))
    args_t = (torch.from_numpy(bt), torch.from_numpy(st), torch.from_numpy(nv))
    args_j = (jnp.asarray(bt), jnp.asarray(st), jnp.asarray(nv))
    out = ops.paged_prefill_attention(qt, kt, vt, *args_t)
    assert out.dtype == tdt and out.shape == qt.shape
    _close(out, jdec.paged_prefill_ref(qj, kj, vj, *args_j), tol)
    # the Pallas kernel skips pages past start + n_valid, so only the
    # real rows are defined alike
    pal = jops.paged_prefill_attention(qj, kj, vj, *args_j, impl="interpret")
    _close(out[:, :valid], pal[:, :valid], tol)


@pytest.mark.parametrize("h,hkv,start,valid,chunk,page", PREFILL_TILE_CASES)
def test_paged_prefill_ref_at_the_kernel_tiles_matches_jax_ref_and_pallas(
        h, hkv, start, valid, chunk, page):
    """The plain paged prefill in bf16 at the shapes the CUDA kernel's
    tiles cut differently (PREFILL_TILE_CASES), two slots each, against
    the JAX ref on every row and the Pallas kernel in interpret mode on
    the real rows (it skips pages past start + n_valid), at the file's
    bf16 tolerance."""
    _, jdt, tdt, tol = DTYPES["bf16"]
    q, kp, vp, bt, st, nv = _prefill_case(h, hkv, start, valid, chunk, page)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, kp, vp))
    args_t = (torch.from_numpy(bt), torch.from_numpy(st), torch.from_numpy(nv))
    args_j = (jnp.asarray(bt), jnp.asarray(st), jnp.asarray(nv))
    out = ops.paged_prefill_attention(qt, kt, vt, *args_t)
    assert out.dtype == tdt and out.shape == qt.shape
    _close(out, jdec.paged_prefill_ref(qj, kj, vj, *args_j), tol)
    pal = jops.paged_prefill_attention(qj, kj, vj, *args_j, impl="interpret")
    _close(out[:, :valid], pal[:, :valid], tol)


@pytest.mark.parametrize("h,hkv,start,valid,chunk,page", [
    pytest.param(*c, 8, 8, id="-".join(map(str, c))) for c in PREFILL_CASES]
    + PREFILL_TILE_CASES)
def test_paged_prefill_rows_equal_flash_chunked_bitwise(h, hkv, start, valid,
                                                        chunk, page):
    """The chunk's rows equal the same rows of the whole-prefix flash
    forward over the slot's gathered pages, bit for bit: both run the
    same block scan over the same keys."""
    q, kp, vp, bt, st, nv = _prefill_case(h, hkv, start, valid, chunk, page)
    kt, vt = torch.from_numpy(kp), torch.from_numpy(vp)
    out = tdec.paged_prefill_ref(torch.from_numpy(q), kt, vt,
                                 torch.from_numpy(bt), torch.from_numpy(st),
                                 torch.from_numpy(nv))
    b, chunk = q.shape[:2]
    kg = kt[torch.from_numpy(bt).long()].reshape(b, -1, hkv, q.shape[-1])
    vg = vt[torch.from_numpy(bt).long()].reshape(b, -1, hkv, q.shape[-1])
    qf = torch.zeros((b, kg.shape[1]) + q.shape[2:])
    qf[:, start:start + chunk] = torch.from_numpy(q)
    whole = tfa.chunked(qf, kg, vg)[:, start:start + chunk]
    assert torch.equal(out[:, :valid], whole[:, :valid])


@pytest.mark.parametrize("smax,fill", [(96, 96), (96, 40), (64, 1),
                                       (600, 517)])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_matches_jax_ref_and_pallas(smax, fill, h, hkv, d,
                                                      dt):
    """The facade's contiguous decode (the plain version on the CPU)
    against the JAX ref and the Pallas decode kernel in interpret mode,
    which walks the cache in blocks of 512 and skips those past the
    fill (600 positions: a ragged second block)."""
    _, jdt, tdt, tol = DTYPES[dt]
    q, k, v = _qkv(2, 1, smax, h, hkv, d, seed=5)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, jdt, tdt) for a in (q, k, v))
    out = ops.decode_attention(qt, kt, vt, fill)
    assert out.dtype == tdt and out.shape == qt.shape
    _close(out, jdec.decode_ref(qj, kj, vj, fill), tol)
    _close(out, jops.decode_attention(qj, kj, vj, fill, impl="interpret"),
           tol)


# ---------------------------------------------------------------------------
# rows that see no key (causal, negative q_offset)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rows_that_see_no_key_match_jax_chunked(dt):
    """At q_offset = -3 the first three query rows see no key.  The JAX
    reference masks their scores at -1e30, so each such row's output is
    the mean of V; the plain version (which the CUDA kernels are held to
    on the card) gives the same forward and gradients."""
    _, jdt, tdt, tol = DTYPES[dt]
    b, sq, skv, h, hkv, d = 2, 20, 24, 4, 2, 32
    q, k, v = _qkv(b, sq, skv, h, hkv, d, seed=6)
    do = np.random.default_rng(7).standard_normal((b, sq, h, d), np.float32)
    (qj, qt), (kj, kt), (vj, vt), (dj, dtt) = (
        _both(a, jdt, tdt) for a in (q, k, v, do))
    kw = dict(causal=True, q_offset=-3)
    jout, jvjp = jax.vjp(lambda *a: jfa.chunked(*a, **kw), qj, kj, vj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = ops.flash_attention(*leaves, **kw)
    _close(out.detach(), jout, tol)
    mean_v = v.mean(axis=1).repeat(h // hkv, axis=1)         # (b, h, d)
    for i in range(3):
        _close(out[:, i].detach(), mean_v, tol)
    for g, jg in zip(torch.autograd.grad(out, leaves, dtt), jvjp(dj)):
        _close(g, jg, tol)
    # the raw forward's lse for such a row is -1e30, as the reference's
    _, lse = tfa.fwd(qt, kt, vt, **kw)
    assert bool((lse[:, :3] == -1e30).all())


# ---------------------------------------------------------------------------
# facade dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    build.reset_launches()
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64)
    assert torch.equal(ops.rmsnorm(x, w), trn.rmsnorm_ref(x, w))
    assert torch.equal(ops.rmsnorm(x, w, impl="ref"), trn.rmsnorm_ref(x, w))
    assert all(n == 0 for n in build.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.rmsnorm(x, w, impl="cuda")
    with pytest.raises(ValueError):
        ops.rmsnorm(x, w, impl="pallas")


def test_kernel_sources_are_present_and_hashed(tmp_path, monkeypatch):
    names = {p.name for p in build.CSRC.glob("*.cu")}
    assert {"rmsnorm.cu", "flash_fwd.cu", "flash_bwd.cu",
            "paged_attention.cu", "decode_attention.cu",
            "moe_gemm.cu"} <= names
    # the tensor-core attention kernels share one header (flash_fwd and
    # paged prefill through the forward body they share, flash_fwd.cuh),
    # which the library's hash covers with the sources
    for header, users in (("wgmma.cuh", ("flash_fwd.cuh", "flash_bwd.cu")),
                          ("flash_fwd.cuh", ("flash_fwd.cu",
                                             "paged_attention.cu"))):
        assert (build.CSRC / header).is_file()
        for src in users:
            assert f'#include "{header}"' in (build.CSRC / src).read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    for header in ("wgmma.cuh", "flash_fwd.cuh"):
        before = build.library_path()
        with open(copy / header, "a") as f:
            f.write("\n")
        assert build.library_path() != before
    monkeypatch.undo()
    assert {"flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
            "decode_attention_bf16", "moe_gemm_bf16"} <= set(build.SIGNATURES)
    assert {"flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
            "moe_gemm"} <= set(build.LAUNCHES)
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path()          # stable for one tree


def test_ptxas_report_names_each_kernel():
    """``build.ptxas_report`` reads nvcc's ``-Xptxas -v`` log by kernel:
    the mangled name as its last name and integer template arguments,
    the registers, spilled bytes and ptxas's C75xx notes."""
    fn = ("_ZN5repro4ffwd16flash_fwd_kernelILi128ELi3ELi1ELi2EEEvPK13__nv_"
          "bfloat16S4_S4_PS2_Pfiiiiiif")
    # ptxas may print a kernel's C75xx note before compiling it
    log = "\n".join([
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line "
        f"5025 by compiler to allow use of registers in GMMA in function '{fn}'",
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fn}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 80 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z14rmsnorm_kernelPKfS0_Pfiif'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _Z14rmsnorm_kernelPKfS0_Pfiif",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers"])
    assert build.ptxas_report(log) == [
        "flash_fwd_kernel<128,3,1,2>: C7519, 0 B spilled, 168 registers",
        "rmsnorm_kernel: 8 B spilled, 32 registers"]
    assert build.ptxas_report(log, "rmsnorm") == [
        "rmsnorm_kernel: 8 B spilled, 32 registers"]
