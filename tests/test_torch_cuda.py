"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device each test skips with its reason.  Tolerance:
|kernel - plain| <= 2e-2 * (1 + |plain|), the bf16 tolerance of the
kernel tests (one rounding of a bf16 output after f32 sums taken in
another order).  flash_bwd's gradients are also held as whole tensors,
||kernel - plain|| <= 1e-2 * ||plain||, which holds the bulk of small
gradients that the per-element limit lets through.  The grouped GEMM
sums D products per output: |kernel - plain| <= 2e-2 * (1 + |plain|)
after scaling both by 1 / sqrt(D), the size of such a sum of unit
products.  The int8 quantize and dequantize kernels equal their plain
versions exactly (``torch.equal``): the same IEEE divisions, rounding
half to even, and an order-free maximum.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as moe_kernel  # noqa: E402
from repro_torch.kernels.moe_gemm import ref as moe_ref  # noqa: E402
from repro_torch.kernels.quantize import kernel as q_kernel  # noqa: E402
from repro_torch.kernels.quantize import ref as q_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402

TOL = 2e-2
REL_L2_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    got, want = got.float().cpu(), want.float().cpu()
    assert bool(((got - want).abs() <= tol * (1 + want.abs())).all()), \
        float((got - want).abs().max())


def _rnd(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 64), (5, 4096), (300, 1000)])
def test_rmsnorm_kernel(dev, rows, d):
    x = _rnd(dev, 2, rows, d)
    w = torch.randn(d, device=dev)
    build.reset_launches()
    _close(ops.rmsnorm(x, w), rn_ref.rmsnorm_ref(x, w))
    assert build.LAUNCHES["rmsnorm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal", [
    (2, 70, 90, 8, 2, 128, True), (1, 33, 65, 2, 2, 64, True),
    (2, 64, 192, 6, 2, 64, False), (1, 17, 17, 8, 1, 128, True),
    # the kernel's tile edges: 64 query rows a warpgroup, 64 keys a step
    (1, 63, 63, 8, 1, 128, True),       # g = 8
    (2, 64, 64, 8, 8, 64, True),        # g = 1
    (1, 65, 1000, 16, 2, 128, True),    # g = 8, offset 935
    (2, 130, 130, 8, 2, 64, True),      # g = 4
    (1, 63, 1000, 8, 1, 64, False),
    (1, 65, 257, 8, 2, 128, False),
    (2, 130, 1000, 4, 4, 128, False),
    (1, 64, 130, 16, 2, 64, False),
    (1, 130, 130, 32, 2, 128, True),    # g = 16: chatglm3-6b's heads
    (2, 65, 200, 16, 1, 64, True)])     # g = 16, offset 135
def test_flash_fwd_kernel(dev, b, sq, skv, h, hkv, d, causal):
    q, k, v = (_rnd(dev, b, s, n, d, seed=i) for i, (s, n) in
               enumerate([(sq, h), (skv, hkv), (skv, hkv)]))
    qo = skv - sq
    build.reset_launches()
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=causal, q_offset=qo)
    assert build.LAUNCHES["flash_fwd"] == 1
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=causal, q_offset=qo)
    _close(out, ref_out)
    _close(lse, ref_lse, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,qo", [
    (2, 300, 300, 8, 1, 128, True, 0), (1, 130, 257, 16, 2, 64, False, 0),
    (1, 200, 130, 8, 2, 64, True, -70)])
def test_flash_fwd_kernel_is_deterministic(dev, b, sq, skv, h, hkv, d, causal,
                                           qo):
    """Each block owns its output rows and sums in a fixed order (no
    atomics): two runs on the same inputs give the same bits."""
    q, k, v = (_rnd(dev, b, s, n, d, seed=i) for i, (s, n) in
               enumerate([(sq, h), (skv, hkv), (skv, hkv)]))
    kw = dict(causal=causal, q_offset=qo)
    first = fa_kernel.flash_fwd(q, k, v, **kw)
    second = fa_kernel.flash_fwd(q, k, v, **kw)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_flash_fwd_launches_once_a_layer_and_forward(dev):
    """A 2-layer ``Model.loss`` with remat at head dim 64: the forward
    launches flash_fwd once a layer, and the backward once more a layer
    (the checkpointed block's forward runs again), with one dq and one
    dk/dv launch a layer."""
    import dataclasses

    from repro_torch.configs import TrainConfig, WorkloadShape, yi_6b
    from repro_torch.data import synthetic_batch
    from repro_torch.dist.steps import init_train_state
    from repro_torch.models import params as P
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(yi_6b.SMOKE, d_model=256, n_heads=4,
                              n_kv_heads=2, n_layers=2)
    assert cfg.head_dim == 64
    params = init_train_state(cfg, TrainConfig(), device=dev)["params"]
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in
             synthetic_batch(cfg, WorkloadShape("t", "train", 128, 2)).items()}
    leaves = P.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    build.reset_launches()
    loss, _ = Model(cfg).loss(params, batch, remat=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == cfg.n_layers
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == 2 * cfg.n_layers
    assert build.LAUNCHES["flash_bwd_dq"] == cfg.n_layers
    assert build.LAUNCHES["flash_bwd_dkv"] == cfg.n_layers
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def _pool(dev, n_pages=40, page=16, hkv=2, d=128):
    return (_rnd(dev, n_pages, page, hkv, d, seed=5),
            _rnd(dev, n_pages, page, hkv, d, seed=6))


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4), (16, 1)])
def test_paged_decode_kernel(dev, h, hkv):
    kp, vp = _pool(dev, hkv=hkv)
    bt = torch.randperm(39, device=dev)[:36].add(1).to(torch.int32).reshape(3, 12)
    lens = torch.tensor([1, 100, 192], dtype=torch.int32, device=dev)
    q = _rnd(dev, 3, 1, h, 128, seed=7)
    _close(ops.paged_decode_attention(q, kp, vp, bt, lens),
           dec_ref.paged_decode_ref(q, kp, vp, bt, lens))


def _split_pool(dev, b, maxp, hkv, d, page=16, seed=11):
    """Pools of b slots of maxp pages each, every slot its own pages
    (page 0 unused), in a shuffled block table."""
    n_pages = b * maxp + 1
    kp = _rnd(dev, n_pages, page, hkv, d, seed=seed)
    vp = _rnd(dev, n_pages, page, hkv, d, seed=seed + 1)
    g = torch.Generator(device=dev).manual_seed(seed)
    bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)[:b * maxp]
          ).to(torch.int32).reshape(b, maxp)
    return kp, vp, bt


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d", [
    (8, 8, 128), (16, 8, 128), (32, 4, 128), (16, 1, 128),   # g = 1, 2, 8, 16
    (8, 8, 64), (16, 8, 64), (64, 8, 64), (16, 1, 64),
    (32, 2, 128), (64, 8, 128)])         # chatglm3-6b's and qwen2-72b's heads
def test_paged_decode_kernel_splits_keys_across_blocks(dev, h, hkv, d):
    """Slots of 80 pages (many splits): lengths 1, page - 1, page, page +
    1, a split boundary - 1, + 0 and + 1 (the wrapper's plan), and the
    full slot; the same bits twice, one launch a call, and pool entries
    past each slot's length (later pages and the rest of its last page)
    never read: poisoned with NaN, they change nothing."""
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    b, maxp, page = 8, 80, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, pps = dec_kernel.plan_splits(maxp, page, b * hkv, sms)
    assert n_split > 1
    edge = pps * page
    kp, vp, bt = _split_pool(dev, b, maxp, hkv, d)
    lens = torch.tensor([1, page - 1, page, page + 1, edge - 1, edge,
                         edge + 1, maxp * page], dtype=torch.int32, device=dev)
    q = _rnd(dev, b, 1, h, d, seed=12)
    build.reset_launches()
    got = ops.paged_decode_attention(q, kp, vp, bt, lens)
    assert build.LAUNCHES["paged_decode"] == 1
    _close(got, dec_ref.paged_decode_ref(q, kp, vp, bt, lens))
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, lens), got)
    for i, n in enumerate(lens.tolist()):
        pages = bt[i].long()
        kp[pages[-(-n // page):]] = float("nan")
        vp[pages[-(-n // page):]] = float("nan")
        if n % page:
            kp[pages[n // page], n % page:] = float("nan")
            vp[pages[n // page], n % page:] = float("nan")
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, lens), got)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_kernel_with_more_splits_than_filled_pages(dev, d):
    """Short slots in wide block tables: most splits start past their
    slot's length and write empty partials, which the merge skips."""
    b, maxp, page, h, hkv = 4, 96, 16, 16, 2
    kp, vp, bt = _split_pool(dev, b, maxp, hkv, d, seed=21)
    lens = torch.tensor([1, 2, 17, 40], dtype=torch.int32, device=dev)
    q = _rnd(dev, b, 1, h, d, seed=22)
    got = ops.paged_decode_attention(q, kp, vp, bt, lens)
    _close(got, dec_ref.paged_decode_ref(q, kp, vp, bt, lens))
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d", [(32, 4, 128), (16, 8, 64), (16, 1, 64)])
def test_decode_attention_gives_paged_decodes_bits(dev, h, hkv, d):
    """One split kernel behind two KV addressers: a contiguous cache and
    a page pool holding the same keys give the same bits, at every
    cache_len (the engine and the contiguous path decode alike)."""
    b, s, page = 3, 1000, 16
    k, v = _rnd(dev, b, s + 8, hkv, d, seed=31), _rnd(dev, b, s + 8, hkv, d, seed=32)
    q = _rnd(dev, b, 1, h, d, seed=33)
    bt = torch.arange(b * (s + 8) // page, dtype=torch.int32,
                      device=dev).reshape(b, -1)
    kp, vp = k.reshape(-1, page, hkv, d), v.reshape(-1, page, hkv, d)
    for n in (1, 63, 64, 65, 500, 1000):
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        assert torch.equal(ops.decode_attention(q, k, v, n),
                           ops.paged_decode_attention(q, kp, vp, bt, lens))


@pytest.mark.cuda
def test_flash_fwd_keeps_its_bits(dev):
    """flash_fwd runs the kernel body it shares with paged prefill
    (flash_fwd.cuh) and gives the bits it gave before the body was
    shared, at chip_smoke.py's three flash_fwd shapes
    (tools/attention_bits.py holds the older tree's digests)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import attention_bits
    assert attention_bits.differ_from_parent(torch, dev, fa_kernel) == []


# (h, hkv, start, n_valid, chunk, page): where paged prefill's tiles bite:
# 64 packed rows span 64 / g chunk positions (g = H / Hkv of 1, 2, 7, 8
# and 16), 64-key steps, fills on either side of a step, pages of 8, 16
# and 64; short chunks; and chip_smoke.py's yi-6b, chatglm3-6b (g = 16:
# 4 positions a tile) and qwen2-72b chunks
PREFILL_CASES = [
    (8, 1, 0, 64, 64, 16), (2, 2, 0, 1, 64, 8), (14, 2, 37, 63, 64, 16),
    (4, 2, 37, 65, 128, 8), (8, 1, 64, 64, 128, 64), (7, 1, 64, 128, 128, 16),
    (4, 2, 250, 65, 96, 64), (8, 1, 250, 1, 32, 8), (2, 1, 0, 128, 128, 64),
    (8, 2, 0, 24, 24, 16), (8, 2, 16, 10, 24, 16), (8, 2, 100, 24, 24, 16),
    (8, 2, 170, 20, 24, 16), (32, 4, 256, 180, 256, 16),
    (32, 2, 256, 180, 256, 16), (64, 8, 256, 180, 256, 16),
    (16, 1, 37, 63, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,start,n_valid,chunk,page", PREFILL_CASES)
@pytest.mark.parametrize("d", [64, 128])
def test_paged_prefill_kernel(dev, h, hkv, start, n_valid, chunk, page, d):
    """Two slots (the second at an earlier start with fewer real rows):
    the real rows within TOL per element and 4e-3 in relative L2 (both
    sides round p to bf16 before p V) of the plain version, and within
    TOL of flash_fwd over each slot's gathered keys at q_offset = start;
    every row finite (padding rows too); one launch; the same bits
    twice; and pool entries at or past each slot's fill never read:
    poisoned with NaN, they change nothing."""
    b = 2
    starts = [start, max(0, start - 13)]
    valids = [n_valid, max(1, n_valid - 7)]
    maxp = -(-(start + chunk) // page) + 1
    kp, vp, bt = _split_pool(dev, b, maxp, hkv, d, page=page, seed=41)
    q = _rnd(dev, b, chunk, h, d, seed=42)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    nv = torch.tensor(valids, dtype=torch.int32, device=dev)
    build.reset_launches()
    got = ops.paged_prefill_attention(q, kp, vp, bt, st, nv)
    assert build.LAUNCHES["paged_prefill"] == 1
    want = dec_ref.paged_prefill_ref(q, kp, vp, bt, st, nv)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, st, nv), got)
    real = [(i, slice(0, valids[i])) for i in range(b)]
    g_real = torch.cat([got[i, r].flatten() for i, r in real]).float()
    w_real = torch.cat([want[i, r].flatten() for i, r in real]).float()
    _close(g_real, w_real)
    assert float((g_real - w_real).norm() / w_real.norm()) <= 4e-3
    for i, r in real:
        fill = starts[i] + valids[i]
        kg = kp[bt[i].long()].reshape(1, -1, hkv, d)[:, :fill].contiguous()
        vg = vp[bt[i].long()].reshape(1, -1, hkv, d)[:, :fill].contiguous()
        flash, _ = fa_kernel.flash_fwd(q[i:i + 1], kg, vg, causal=True,
                                       q_offset=starts[i])
        _close(got[i:i + 1, r], flash[:, r])
    for i in range(b):
        fill, pages = starts[i] + valids[i], bt[i].long()
        kp[pages[-(-fill // page):]] = float("nan")
        vp[pages[-(-fill // page):]] = float("nan")
        if fill % page:
            kp[pages[fill // page], fill % page:] = float("nan")
            vp[pages[fill // page], fill % page:] = float("nan")
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, st, nv), got)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _rnd(dev, 4, 64)
    with pytest.raises(ValueError):
        ops.rmsnorm(x.float(), torch.ones(64, device=dev))
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.ones(64, device=dev, dtype=torch.bfloat16))
    q = _rnd(dev, 1, 8, 4, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)          # head dim 32 is not built


@pytest.mark.cuda
def test_lammps_proxy_head_dim_32_is_refused_on_the_card(dev):
    """lammps-proxy has head dim 32 (d 256 over 8 heads), which no
    attention kernel takes: on the card its prefill, its loss and both
    engine modes raise, and nothing falls back to a plain version."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, EngineConfig
    cfg = registry.get("lammps-proxy")
    assert cfg.head_dim == 32
    params = Model(cfg).init(device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=dev)
    build.reset_launches()
    with pytest.raises(ValueError, match="head dim 32"):
        Model(cfg).prefill(params, {"tokens": toks})
    with pytest.raises(ValueError, match="head dim 32"):
        Model(cfg).loss(params, {"tokens": toks, "labels": toks})
    for chunk in (0, 16):
        eng = Engine(cfg, EngineConfig(n_slots=2, page_size=16, max_seq_len=64,
                                       max_prompt_len=32, prefill_chunk=chunk),
                     params=params, device=dev)
        eng.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(ValueError, match="head dim 32"):
            eng.run()
    assert all(build.LAUNCHES[k] == 0 for k in
               ("flash_fwd", "paged_prefill", "paged_decode", "decode_attention"))


# ---------------------------------------------------------------------------
# flash attention backward and the autograd Functions
# ---------------------------------------------------------------------------

BWD_SHAPES = [
    # b, sq, skv, h, hkv, d, causal  (q_offset = skv - sq)
    (2, 70, 90, 8, 2, 128, True),       # GQA, ragged tiles, offset
    (1, 128, 128, 8, 1, 64, True),      # MQA
    (1, 33, 65, 2, 2, 64, True),        # odd sizes, offset
    (2, 64, 192, 6, 2, 64, False),      # non-causal, cross shape
    (1, 200, 200, 4, 4, 128, True),     # several tiles each way
    # lengths off the kernels' 64-row tiles, and g = 1, 2 and 8 at both
    # head dims
    (1, 129, 129, 8, 1, 128, True),     # g = 8
    (1, 300, 300, 8, 8, 128, True),     # g = 1
    (2, 129, 300, 4, 2, 128, True),     # g = 2, offset 171
    (2, 300, 300, 4, 4, 64, True),      # g = 1
    (1, 300, 129, 16, 2, 64, False),    # g = 8, non-causal, Skv < Sq
    (1, 129, 300, 4, 2, 64, True),      # g = 2, offset 171
    # non-causal cross shapes with Skv > Sq
    (1, 129, 300, 8, 1, 128, False),
    (2, 100, 300, 4, 2, 64, False),
    # g = 16: dk and dv summed over 16 query heads (chatglm3-6b's heads)
    (1, 130, 130, 32, 2, 128, True),
    (2, 129, 300, 16, 1, 64, True),
]


def _bwd_inputs(dev, b, sq, skv, h, hkv, d):
    return (_rnd(dev, b, sq, h, d, seed=1), _rnd(dev, b, skv, hkv, d, seed=2),
            _rnd(dev, b, skv, hkv, d, seed=3), _rnd(dev, b, sq, h, d, seed=4))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal", BWD_SHAPES)
def test_flash_bwd_kernels(dev, b, sq, skv, h, hkv, d, causal):
    """dq, dk, dv of the kernels against ``ref.bwd`` on the same out and
    lse.  Both round p and ds to bf16 before the products that take them,
    as the JAX ref does, and sum in float32 in another order: within the
    bf16 tolerance."""
    q, k, v, do = _bwd_inputs(dev, b, sq, skv, h, hkv, d)
    qo = skv - sq
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=causal, q_offset=qo)
    build.reset_launches()
    got = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=causal,
                              q_offset=qo)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_bwd_dq"] == 1
    assert build.LAUNCHES["flash_bwd_dkv"] == 1
    want = fa_ref.bwd(q, k, v, out, lse, do, causal=causal, q_offset=qo)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w)
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= REL_L2_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal", [
    (2, 300, 300, 8, 2, 128, True), (1, 129, 300, 16, 8, 64, False)])
def test_flash_bwd_kernels_are_deterministic(dev, b, sq, skv, h, hkv, d,
                                             causal):
    """Each block owns its output rows and sums in a fixed order (no
    atomics): two runs on the same inputs give the same bits."""
    q, k, v, do = _bwd_inputs(dev, b, sq, skv, h, hkv, d)
    qo = skv - sq if causal else 0
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=causal, q_offset=qo)
    first = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=causal,
                                q_offset=qo)
    second = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=causal,
                                 q_offset=qo)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal", BWD_SHAPES[:3])
def test_flash_function_grads_match_the_plain_path(dev, b, sq, skv, h, hkv,
                                                   d, causal):
    q, k, v, do = _bwd_inputs(dev, b, sq, skv, h, hkv, d)
    qo = skv - sq
    grads = []
    for impl in (None, "ref"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=causal, q_offset=qo,
                                  impl=impl)
        grads.append(torch.autograd.grad(out, leaves, do))
    for g, w in zip(*grads):
        _close(g, w)


@pytest.mark.cuda
def test_rmsnorm_function_grads_match_the_plain_path(dev):
    x = _rnd(dev, 3, 40, 512)
    w = 1 + 0.1 * torch.randn(512, device=dev)
    dy = _rnd(dev, 3, 40, 512, seed=9)
    grads = []
    for impl in (None, "ref"):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(
            ops.rmsnorm(xl, wl, impl=impl), (xl, wl), dy))
    _close(grads[0][0], grads[1][0])
    # dweight sums 120 rows: relative to its own scale
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-2,
                               atol=1e-2 * float(grads[1][1].abs().max()))


@pytest.mark.cuda
def test_raw_wrappers_refuse_grad_and_strided_grads_are_made_dense(dev):
    q = _rnd(dev, 1, 16, 4, 64).requires_grad_()
    k = _rnd(dev, 1, 16, 2, 64, seed=1)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa_kernel.flash_fwd(q, k, k)
    with torch.no_grad():
        fa_kernel.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        build.check(k.transpose(1, 2), "k", torch.bfloat16)
    # the output feeds a reshape and a matmul, so its grad is strided
    w = torch.randn(256, 8, device=dev, dtype=torch.bfloat16)
    out = ops.flash_attention(q, k, k).reshape(1, 16, 256) @ w
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad.float()).all())


# ---------------------------------------------------------------------------
# head dim 64 (granite-moe-1b-a400m: 16 heads over 8 KV heads)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,hkv", [(1, 300, 16, 8), (2, 129, 16, 8)])
def test_attention_kernels_at_head_dim_64(dev, b, sq, h, hkv):
    q, k, v, do = _bwd_inputs(dev, b, sq, sq, h, hkv, 64)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True)
    _close(out, ref_out)
    _close(lse, ref_lse, 1e-3)
    got = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=True)
    want = fa_ref.bwd(q, k, v, out, lse, do, causal=True)
    for g, w in zip(got, want):
        _close(g, w)
        assert float((g.float() - w.float()).norm() / w.float().norm()) \
            <= REL_L2_TOL
    kp, vp = _pool(dev, hkv=hkv, d=64)
    bt = torch.randperm(39, device=dev)[:36].add(1).to(torch.int32).reshape(3, 12)
    lens = torch.tensor([1, 100, 192], dtype=torch.int32, device=dev)
    qd = _rnd(dev, 3, 1, h, 64, seed=7)
    _close(ops.paged_decode_attention(qd, kp, vp, bt, lens),
           dec_ref.paged_decode_ref(qd, kp, vp, bt, lens))
    qc = _rnd(dev, 1, 24, h, 64, seed=8)
    st = torch.tensor([100], dtype=torch.int32, device=dev)
    nv = torch.tensor([20], dtype=torch.int32, device=dev)
    got = ops.paged_prefill_attention(qc, kp, vp, bt[:1], st, nv)
    want = dec_ref.paged_prefill_ref(qc, kp, vp, bt[:1], st, nv)
    _close(got[:, :20], want[:, :20])


# ---------------------------------------------------------------------------
# rows that see no key (causal, q_offset < 0)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,qo", [
    (2, 70, 90, 8, 2, 128, -3), (1, 130, 100, 16, 8, 64, -70),
    (1, 33, 65, 2, 2, 64, -40)])
def test_rows_that_see_no_key(dev, b, sq, skv, h, hkv, d, qo):
    """The first -q_offset query rows see no key: forward (the mean of V,
    lse -1e30) and backward as the plain version, which is the JAX
    reference's (scores masked at -1e30, not dropped).  Such a row has
    p = 1 on every key, so its dq (and the dk it adds to every key) is a
    sum of Skv terms of size ~1 that cancel, and the bf16 rounding of ds
    (2^-9 each) moves it by more than the per-element limit would allow
    against a float32 run.  The kernels round ds to bf16 where the plain
    version does, so they are held per element and as whole tensors
    against the plain version in bf16."""
    q, k, v, do = _bwd_inputs(dev, b, sq, skv, h, hkv, d)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True, q_offset=qo)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True, q_offset=qo)
    _close(out, ref_out)
    _close(lse, ref_lse, 1e-3)
    assert bool((lse[:, :-qo] == -1e30).all())
    mean_v = v.float().mean(1).repeat_interleave(h // hkv, dim=1)
    _close(out[:, 0], mean_v)
    got = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=True, q_offset=qo)
    want = fa_ref.bwd(q, k, v, out, lse, do, causal=True, q_offset=qo)
    for g, w in zip(got, want):
        _close(g, w)
        assert float((g.float() - w.float()).norm() / w.float().norm()) \
            <= REL_L2_TOL


# ---------------------------------------------------------------------------
# decode attention over a contiguous cache
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d", [(32, 4, 128), (16, 8, 64), (8, 8, 64),
                                     (16, 1, 128)])
@pytest.mark.parametrize("cache_len", [1, 37, 700])
def test_decode_attention_kernel(dev, h, hkv, d, cache_len):
    q = _rnd(dev, 3, 1, h, d, seed=1)
    k, v = _rnd(dev, 3, 1024, hkv, d, seed=2), _rnd(dev, 3, 1024, hkv, d, seed=3)
    build.reset_launches()
    got = ops.decode_attention(q, k, v, cache_len)
    assert build.LAUNCHES["decode_attention"] == 1
    _close(got, dec_ref.decode_ref(q, k, v, cache_len))
    # keys past cache_len are never read: poisoning them changes nothing
    k[:, cache_len:] = float("nan")
    v[:, cache_len:] = float("nan")
    assert torch.equal(ops.decode_attention(q, k, v, cache_len), got)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v, 0)


# ---------------------------------------------------------------------------
# the grouped expert GEMM
# ---------------------------------------------------------------------------


def _moe_close(got, want, d):
    s = d ** -0.5
    _close(got.float() * s, want.float() * s)


@pytest.mark.cuda
@pytest.mark.parametrize("e,t,d,f", [
    (4, 1, 64, 96), (4, 5, 300, 96), (4, 130, 64, 96), (3, 77, 129, 33),
    (32, 8, 1024, 512), (32, 160, 1024, 512), (32, 80, 512, 1024)])
def test_moe_gemm_kernel(dev, e, t, d, f):
    x, w = _rnd(dev, e, t, d, seed=1), _rnd(dev, e, d, f, seed=2)
    build.reset_launches()
    got = ops.moe_gemm(x, w)
    assert build.LAUNCHES["moe_gemm"] == 1 and got.shape == (e, t, f)
    _moe_close(got, moe_ref.moe_gemm_ref(x, w), d)
    # strided operands: the transposed views the backward passes
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(moe_kernel.moe_gemm(xt, wt), got)
    # and a view that no 16-byte load can take
    xs = _rnd(dev, e, t, d + 1, seed=3)[..., 1:]
    _moe_close(moe_kernel.moe_gemm(xs, w), moe_ref.moe_gemm_ref(xs, w), d)


@pytest.mark.cuda
@pytest.mark.parametrize("e,t,d,f", [(4, 130, 64, 96), (3, 77, 129, 33),
                                     (32, 320, 1024, 512)])
def test_moe_gemm_backward_launches_the_kernel_twice(dev, e, t, d, f):
    x, w = _rnd(dev, e, t, d, seed=1), _rnd(dev, e, d, f, seed=2)
    dy = _rnd(dev, e, t, f, seed=3)
    grads = []
    for impl in (None, "ref"):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = ops.moe_gemm(xl, wl, impl=impl)
        build.reset_launches()
        grads.append(torch.autograd.grad(out, (xl, wl), dy))
        if impl is None:
            assert build.LAUNCHES["moe_gemm"] == 2
    _moe_close(grads[0][0], grads[1][0], f)          # dX sums over F
    _moe_close(grads[0][1], grads[1][1], t)          # dW sums over T


def _moe_grads(x, w, dy):
    """dX and dW through the kernel's autograd Function and through
    autograd of the plain version."""
    grads = []
    for impl in (None, "ref"):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(ops.moe_gemm(xl, wl, impl=impl),
                                         (xl, wl), dy))
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("e,t,d,f", [
    (32, 5120, 1024, 512),              # granite's train step
    # ragged edges on every axis, at 128- and 256-column tiles
    (2, 129, 72, 264), (32, 300, 136, 264), (5, 130, 8, 130)])
def test_moe_gemm_kernel_forward_and_backward_views(dev, e, t, d, f):
    """The forward and the backward's two products on transposed views
    (dX = dY W^T, dW = X^T dY) against the plain version and its
    autograd, per element after scaling by 1 / sqrt(depth) and in
    relative L2, and the same bits on a second run."""
    x, w = _rnd(dev, e, t, d, seed=1), _rnd(dev, e, d, f, seed=2)
    dy = _rnd(dev, e, t, f, seed=3)
    got = moe_kernel.moe_gemm(x, w)
    want = moe_ref.moe_gemm_ref(x, w)
    _moe_close(got, want, d)
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) <= REL_L2_TOL
    assert torch.equal(moe_kernel.moe_gemm(x, w), got)
    (dx, dw), (dx_ref, dw_ref) = _moe_grads(x, w, dy)
    for a, b, depth in ((dx, dx_ref, f), (dw, dw_ref, t)):
        _moe_close(a, b, depth)
        assert float((a.float() - b.float()).norm()
                     / b.float().norm()) <= REL_L2_TOL
    assert torch.equal(moe_kernel.moe_gemm(dy, w.transpose(1, 2)), dx)
    assert torch.equal(moe_kernel.moe_gemm(x.transpose(1, 2), dy), dw)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block", [(37, 128), (1000, 256), (300, 64),
                                        (9, 100), (5, 7), (3, 4096)])
def test_quantize_kernels_equal_the_plain_versions_exactly(dev, rows, block):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = (torch.randn((rows, block), generator=g, device=dev)
         * 10.0 ** (torch.rand((rows, 1), generator=g, device=dev) * 12 - 6))
    x[min(5, rows - 1)] = 0.0                      # a zero row: scale 1.0
    if rows > 2 and block >= 6:                    # amax 127: ties at .5
        x[1] = torch.rand(block, generator=g, device=dev) * 200 - 100
        x[1, :6] = torch.tensor([127.0, 2.5, 3.5, -0.5, -1.5, 0.5])
    build.reset_launches()
    codes, scales = q_kernel.quantize_int8(x)
    want_c, want_s = q_ref.quantize_int8_ref(x, block=block)
    assert torch.equal(codes, want_c) and torch.equal(scales, want_s)
    if rows > 2 and block >= 6:
        assert codes[1, :6].tolist() == [127, 2, 4, 0, -2, 0]
    assert torch.equal(q_kernel.dequantize_int8(codes, scales),
                       q_ref.dequantize_int8_ref(codes, scales))
    assert build.LAUNCHES["quantize"] == 1
    assert build.LAUNCHES["dequantize"] == 1
    with pytest.raises(ValueError):
        q_kernel.quantize_int8(x.double())
    with pytest.raises(ValueError):
        q_kernel.dequantize_int8(codes, scales[:-1])


@pytest.mark.cuda
def test_sync_on_the_card_equals_the_sync_on_the_cpu(dev, tmp_path):
    """Four ranks on one card over gloo: the hierarchical and the int8
    compressed ``sync_grads`` on CUDA tensors (the quantize kernels) give
    the bits the same syncs give on CPU tensors (the plain versions)."""
    import multiprocessing
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_comm_ranks as R

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=R.cuda_sync_rank,
                         args=(r, str(tmp_path / "pg"), q))
             for r in range(R.WORLD)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * R.WORLD
    for r in res:
        assert r["hier"] == 0.0 and r["hier-int8"] == 0.0, r
        assert r["hier_launches"] == (0, 0)
        assert r["hier-int8_launches"] == (1, 1)

