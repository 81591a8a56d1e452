"""The port's kernel modules against the JAX package's.

On the CPU each kernel wrapper runs its plain PyTorch version; those are
held against the JAX refs and against the Pallas kernels in interpret
mode on the same numpy inputs, at the tolerances of test_kernels.py
(2e-5 for float32: sums in another order; 2e-2 for bfloat16: one
rounding of the output, a few bf16 ulps).  The CUDA kernels are held
against the plain versions in test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import ref as jdec  # noqa: E402
from repro.kernels.flash_attention import kernel as jfa_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as jfa  # noqa: E402
from repro.kernels.rmsnorm import ref as jrn  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tdec  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfa  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as trn  # noqa: E402

SHAPES = [
    # b, sq, skv, h, hkv, d, causal   (test_kernels.py:12-19)
    (2, 128, 128, 4, 2, 64, True),
    (1, 100, 100, 4, 4, 32, True),      # ragged (padding paths)
    (2, 64, 192, 6, 2, 32, False),      # cross-attention shape
    (1, 48, 48, 8, 1, 16, True),        # MQA
    (1, 33, 65, 2, 2, 128, True),       # odd sizes, offset
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


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_chunked_small_blocks_match_naive(shape):
    b, sq, skv, h, hkv, d, causal = shape
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, sq, skv, h, hkv, d))
    qo = skv - sq
    _close(tfa.chunked(q, k, v, causal=causal, q_offset=qo, block_kv=37),
           tfa.naive(q, k, v, causal=causal, q_offset=qo), 2e-5)


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


@pytest.mark.parametrize("fills", [[64, 33, 1], [40, 17, 16], [1, 1, 2]])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 8), (8, 1)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_matches_jax_ref_and_pallas(fills, h, hkv, dt):
    _, jdt, tdt, tol = DTYPES[dt]
    page, maxp, d = 16, 4, 32
    kp, vp, bt = _pool(16, page, hkv, d, fills, maxp)
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


def _prefill_case(h, hkv, start, valid, chunk=8, page=8, maxp=4, d=32, b=2):
    rng = np.random.default_rng(3)
    fills = [start + chunk] * b
    kp, vp, bt = _pool(16, page, hkv, d, fills, maxp, seed=4)
    q = rng.standard_normal((b, chunk, h, d), np.float32)
    return q, kp, vp, bt, np.full((b,), start, np.int32), \
        np.full((b,), valid, np.int32)


PREFILL_CASES = [(4, 2, 0, 8), (4, 2, 8, 8), (8, 8, 5, 3), (8, 1, 13, 8),
                 (4, 2, 5, 6)]


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


@pytest.mark.parametrize("h,hkv,start,valid", PREFILL_CASES)
def test_paged_prefill_rows_equal_flash_chunked_bitwise(h, hkv, start, valid):
    """The chunk's rows equal the same rows of the whole-prefix flash
    forward over the slot's gathered pages, bit for bit: both run the
    same block scan over the same keys."""
    q, kp, vp, bt, st, nv = _prefill_case(h, hkv, start, valid)
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


def test_kernel_sources_are_present_and_hashed():
    names = {p.name for p in build.CSRC.glob("*.cu")}
    assert {"rmsnorm.cu", "flash_fwd.cu", "paged_attention.cu"} <= names
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path()          # stable for one tree
