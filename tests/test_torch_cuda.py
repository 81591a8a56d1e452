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
    (2, 65, 200, 16, 1, 64, True),      # g = 16, offset 135
    # head dim 32 (lammps-proxy: 8 heads over 8 KV heads)
    (2, 130, 130, 8, 8, 32, True), (1, 65, 257, 8, 2, 32, True),
    (2, 64, 192, 4, 4, 32, False), (1, 17, 17, 8, 1, 32, True),
    # head dims 16 (the SMOKE configs') and 8 (qwen2-72b's SMOKE)
    (2, 130, 130, 4, 2, 16, True), (1, 65, 257, 8, 2, 16, True),
    (2, 64, 192, 4, 4, 16, False), (2, 130, 130, 8, 2, 8, True),
    (1, 65, 257, 8, 1, 8, True), (2, 64, 192, 4, 4, 8, False),
    # head dim 160 (pixtral-12b: 32 heads over 8), and whisper's
    # cross-attention: one query row over every key, non-causal
    (2, 130, 130, 8, 2, 160, True), (1, 65, 257, 32, 8, 160, True),
    (2, 64, 192, 4, 4, 160, False), (1, 17, 17, 8, 1, 160, True),
    (3, 1, 1500, 8, 8, 64, False), (2, 1, 150, 32, 8, 160, False)])
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
    (1, 200, 130, 8, 2, 64, True, -70), (2, 300, 300, 8, 8, 32, True, 0),
    (2, 300, 300, 4, 2, 16, True, 0), (1, 200, 130, 8, 2, 8, True, -70),
    (2, 300, 300, 32, 8, 160, True, 0), (2, 1, 1500, 8, 8, 64, False, 0)])
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
    (32, 2, 128), (64, 8, 128),          # chatglm3-6b's and qwen2-72b's heads
    (32, 8, 128),                        # jamba-v0.1-52b's heads (g = 4)
    (8, 8, 32), (16, 2, 32),             # head dim 32 (lammps-proxy's: g = 1)
    (4, 2, 16), (16, 1, 16), (8, 2, 8), (16, 2, 8),    # head dims 16 and 8
    (32, 8, 160), (8, 8, 160), (32, 2, 160)])           # head dim 160
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
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 160])
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
@pytest.mark.parametrize("h,hkv,d", [(32, 4, 128), (16, 8, 64), (16, 1, 64),
                                     (8, 8, 32), (4, 2, 16), (8, 2, 8),
                                     (32, 8, 160)])
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
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 160])
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
    q = _rnd(dev, 1, 8, 4, 24)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)          # head dim 24 is not built
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :1], q, q, 8)


@pytest.mark.cuda
def test_lammps_proxy_runs_on_the_card(dev):
    """lammps-proxy has head dim 32 (d 256 over 8 heads, g = 1).  On the
    card its prefill, its loss with gradients and both engine modes run
    the attention kernels (each launch count above 0) and agree with the
    plain path on the same parameters: prefill logits and the loss within
    2e-2 relative (bf16 arithmetics in another order), each gradient
    within 5 * REL_L2_TOL in relative L2, and every greedy token of
    either engine within 5e-2 (relative to the logits' scale) of the
    plain model's max logit when the stream so far is fed back through
    it (a bf16 near-tie may flip)."""
    from repro_torch.configs import registry
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, EngineConfig
    cfg = registry.get("lammps-proxy")
    assert cfg.head_dim == 32 and cfg.n_heads == cfg.n_kv_heads
    params = Model(cfg).init(device=dev, dtype=torch.bfloat16)
    plain = Model(cfg, impl="ref")
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(1, cfg.vocab_size, (2, 128), device=dev, generator=g)
    build.reset_launches()
    got, _ = Model(cfg).prefill(params, {"tokens": toks})
    want, _ = plain.prefill(params, {"tokens": toks})
    assert build.LAUNCHES["flash_fwd"] == cfg.n_layers
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= 2e-2, rel

    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    losses, grads = [], []
    for model in (Model(cfg), plain):
        leaves = [t.float().clone().requires_grad_() for t in
                  P.tree_leaves(params)]
        loss, _ = model.loss(P.tree_unflatten(params, leaves), batch)
        grads.append(torch.autograd.grad(loss, leaves))
        losses.append(float(loss))
    assert build.LAUNCHES["flash_bwd_dq"] == cfg.n_layers
    assert build.LAUNCHES["flash_bwd_dkv"] == cfg.n_layers
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1]), losses
    for a, b_ in zip(*grads):
        rel = float((a - b_).norm() / b_.norm().clamp_min(1e-12))
        assert rel <= 5 * REL_L2_TOL, rel

    prompts = [toks[0, :37].tolist(), toks[1, :70].tolist()]
    for chunk in (0, 32):
        build.reset_launches()
        eng = Engine(cfg, EngineConfig(n_slots=2, page_size=16, max_seq_len=128,
                                       max_prompt_len=96, prefill_chunk=chunk),
                     params=params, device=dev)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        assert build.LAUNCHES["paged_decode"] > 0
        assert build.LAUNCHES["paged_prefill" if chunk else "flash_fwd"] > 0
        for p, r in zip(prompts, reqs):
            assert len(r.tokens) == 6
            for i, tok in enumerate(r.tokens):
                seq = torch.tensor([p + r.tokens[:i]], device=dev)
                logits, _ = plain.prefill(params, {"tokens": seq})
                logits = logits[0].float()
                gap = float(logits.max() - logits[tok])
                assert gap <= 5e-2 * max(1.0, float(logits.abs().max())), gap


@pytest.mark.cuda
def test_apply_serve_and_train_specs_on_the_card(dev):
    """A FluxMiniCluster applies a serve and a train WorkloadSpec of
    lammps-proxy (full config, head dim 32) on the card: both handles
    complete through Pending, Bound and Running; the served streams equal
    a direct Engine's over the executor's parameters; the train loss is
    finite; the attention kernels launched."""
    from repro_torch.configs import registry
    from repro_torch.core import (FluxMiniCluster, MiniClusterSpec,
                                  NetModel, ResourceGraph, SimClock)
    from repro_torch.serve import Engine
    from repro_torch.spec import (ResourceSpec, ServeSpec, TrainSpec,
                                  WorkloadSpec)
    cfg = registry.get("lammps-proxy")
    clock = SimClock(seed=0)
    mc = FluxMiniCluster(clock, NetModel(), ResourceGraph(1, 4, 8),
                         MiniClusterSpec(name="cuda", size=2))
    mc.create()
    mc.wait_ready()
    build.reset_launches()
    serve = mc.apply(WorkloadSpec(
        kind="serve", arch="lammps-proxy", resources=ResourceSpec(n_nodes=1),
        serve=ServeSpec(n_slots=4, page_size=16, max_prompt_len=64,
                        max_seq_len=128, max_new=8, n_requests=5,
                        prefill_chunk=32)),
        cfg=cfg, executor_opts=dict(device=dev, prompt_len=64))
    train = mc.apply(WorkloadSpec(
        kind="train", arch="lammps-proxy", resources=ResourceSpec(n_nodes=1),
        train=TrainSpec(total_steps=2, seq_len=256)),
        cfg=cfg, executor_opts=dict(device=dev))
    clock.run(until=clock.now + 1e5, stop_when=lambda: serve.done and train.done)
    torch.cuda.synchronize()
    for h in (serve, train):
        assert [e["phase"] for e in h.events()] == \
            ["Pending", "Bound", "Running", "Completed"]
    rec = serve.executor.ran[serve.job.jobid]
    eng, = serve.executor._engines.values()
    direct = Engine(cfg, serve.spec.engine_config(), params=eng.params,
                    device=dev)
    reqs = [direct.submit([(7 * i + j) % cfg.vocab_size for j in range(64)],
                          max_new_tokens=8) for i in range(5)]
    direct.run()
    assert rec["tokens"] == [r.tokens for r in reqs]
    assert rec["mesh_shape"] == (1, 1)
    loss = train.executor.ran[train.job.jobid]["loss"]
    assert loss == loss and abs(loss) < 1e3
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_prefill",
              "paged_decode", "rmsnorm"):
        assert build.LAUNCHES[k] > 0, k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-72b"])
def test_apply_smoke_specs_on_the_card(dev, arch):
    """Without ``cfg=`` the executors take the arch's SMOKE config (head
    dim 16, and 8 for qwen2-72b), as the JAX package's do: a train, a
    chunked serve and an elastic fleet spec complete on the card through
    Pending, Bound and Running, and the attention kernels launched."""
    from repro_torch.configs import registry
    from repro_torch.core import (FluxMiniCluster, MiniClusterSpec,
                                  NetModel, ResourceGraph, SimClock)
    from repro_torch.spec import (ResourceSpec, ServeSpec, TrainSpec,
                                  WorkloadSpec)
    assert registry.smoke(arch).head_dim == (8 if arch == "qwen2-72b" else 16)
    clock = SimClock(seed=0)
    mc = FluxMiniCluster(clock, NetModel(), ResourceGraph(1, 8, 8),
                         MiniClusterSpec(name="smoke", size=4))
    mc.create()
    mc.wait_ready()
    build.reset_launches()
    serve = dict(n_slots=4, page_size=8, max_prompt_len=16, max_seq_len=48,
                 max_new=8, n_requests=3)
    handles = [
        mc.apply(WorkloadSpec(kind="train", arch=arch,
                              train=TrainSpec(total_steps=2, seq_len=32)),
                 executor_opts=dict(device=dev)),
        mc.apply(WorkloadSpec(kind="serve", arch=arch,
                              serve=ServeSpec(prefill_chunk=8, **serve)),
                 executor_opts=dict(device=dev)),
        mc.apply(WorkloadSpec(kind="serve", arch=arch,
                              resources=ResourceSpec(n_nodes=1, elastic=True),
                              serve=ServeSpec(replicas=2, **serve)),
                 executor_opts=dict(device=dev))]
    clock.run(until=clock.now + 1e5, stop_when=lambda: all(h.done
                                                          for h in handles))
    torch.cuda.synchronize()
    for h in handles:
        assert [e["phase"] for e in h.events()] == \
            ["Pending", "Bound", "Running", "Completed"]
    assert handles[0].result()["final_loss"] == handles[0].result()[
        "final_loss"]
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_prefill",
              "paged_decode", "rmsnorm"):
        assert build.LAUNCHES[k] > 0, k


# the plain versions a kernel replaces: none may run on the card's path
PLAIN = {"flash_attention.ref": ("naive", "fwd", "bwd", "chunked"),
         "decode_attention.ref": ("decode_ref", "paged_decode_ref",
                                  "paged_prefill_ref"),
         "rmsnorm.ref": ("rmsnorm_ref",), "moe_gemm.ref": ("moe_gemm_ref",)}


def _refuse_plain(monkeypatch):
    import importlib

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"the plain version {name} ran on the card")
        return f

    for mod, names in PLAIN.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        for n in names:
            monkeypatch.setattr(m, n, refuse(f"{mod}.{n}"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_sequence_mixer_smoke_serves_on_the_card(dev, arch, monkeypatch):
    """jamba and xlstm SMOKE through the Engine on the card with every
    plain version refused: prompts of lengths off the page size and the
    kernels' 64-row tiles prefill at their exact lengths; a second engine
    over the same params and the same batch gives the same streams, and a
    chunked engine takes no chunked tick."""
    from repro_torch.configs import registry
    from repro_torch.serve import Engine, EngineConfig
    cfg = registry.smoke(arch)
    _refuse_plain(monkeypatch)
    ecfg = dict(n_slots=4, page_size=8, max_prompt_len=80, max_seq_len=96)
    prompts = [[(5 * i + 3 * j) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate((3, 13, 77, 65, 9))]
    build.reset_launches()
    streams = []
    for chunk in (0, 0, 16):
        eng = Engine(cfg, EngineConfig(**ecfg, prefill_chunk=chunk),
                     seed=0, device=dev)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        assert eng.n_mixed_steps == 0
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1] == streams[2]
    assert all(0 <= t < cfg.vocab_size for s in streams[0] for t in s)
    kernels = ("rmsnorm",) + (("flash_fwd", "paged_decode", "moe_gemm")
                              if arch.startswith("jamba") else ())
    for k in kernels:
        assert build.LAUNCHES[k] > 0, k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_sequence_mixer_smoke_trains_on_the_card(dev, arch, monkeypatch):
    """jamba and xlstm SMOKE through the Trainer on the card (remat, bf16
    compute) with every plain version refused: finite losses, and a
    checkpoint round trip resumes with the uninterrupted run's losses."""
    import math

    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.train import Trainer
    cfg = registry.smoke(arch)
    _refuse_plain(monkeypatch)
    shape = WorkloadShape("t", "train", 300, 2)
    build.reset_launches()
    tr = Trainer(cfg, TrainConfig(), shape, device=dev)
    hist = tr.run(3, log_every=0)
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    kernels = ("rmsnorm",) + (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                               "moe_gemm") if arch.startswith("jamba")
                              else ())
    for k in kernels:
        assert build.LAUNCHES[k] > 0, k
    again = Trainer(cfg, TrainConfig(), shape, device=dev).run(3,
                                                               log_every=0)
    assert [h["loss"] for h in again] == pytest.approx(
        [h["loss"] for h in hist], rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_encdec_and_vision_smoke_train_on_the_card(dev, arch, monkeypatch):
    """whisper SMOKE (frames through the encoder, cross-attention) and
    pixtral SMOKE (patches) through the Trainer on the card with every
    plain version refused: finite losses that a second Trainer repeats,
    and the attention kernels launched (whisper's LayerNorm is no
    kernel; pixtral's RMSNorm is)."""
    import math

    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.train import Trainer
    cfg = registry.smoke(arch)
    _refuse_plain(monkeypatch)
    shape = WorkloadShape("t", "train", 300, 2)
    build.reset_launches()
    hist = Trainer(cfg, TrainConfig(), shape, device=dev).run(3, log_every=0)
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") + (
        ("rmsnorm",) if arch == "pixtral-12b" else ())
    for k in kernels:
        assert build.LAUNCHES[k] > 0, k
    again = Trainer(cfg, TrainConfig(), shape, device=dev).run(3,
                                                               log_every=0)
    assert [h["loss"] for h in again] == pytest.approx(
        [h["loss"] for h in hist], rel=1e-4)


@pytest.mark.cuda
def test_whisper_smoke_decodes_on_the_card(dev, monkeypatch):
    """whisper SMOKE on the card: a prefill with frames, then contiguous
    decode steps whose cross-attention is one query row over every frame,
    through the kernels (plain versions refused), the plain versions in
    bf16 and in float32: the kernel path's logits stay as close to
    float32 as the plain bf16 path's, within 1.5x (chip_smoke.py's
    LOGIT_NOISE_FACTOR), and every kernel launch is counted."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    cfg = registry.smoke("whisper-base")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 24), generator=g, device=dev)
    frames = torch.randn((3, 150, cfg.d_model), generator=g, device=dev) * 0.02
    pad = torch.zeros_like(toks)
    pad[:, :16] = toks[:, :16]
    got = {}
    for name, impl, dtype in (("f32", "ref", torch.float32),
                              ("plain", "ref", torch.bfloat16),
                              ("kernels", None, torch.bfloat16)):
        model = Model(cfg, impl=impl)
        if impl is None:
            _refuse_plain(monkeypatch)
        build.reset_launches()
        lg, cache = model.prefill(params, {"tokens": pad, "frames": frames},
                                  compute_dtype=dtype,
                                  last_index=torch.full((3,), 15, device=dev))
        out = [lg]
        for i in range(4):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, 16 + i:17 + i], 16 + i,
                                          compute_dtype=dtype)
            out.append(lg)
        got[name] = torch.cat(out).float()

    def rel(a):
        return float(((got[a] - got["f32"]).norm(dim=-1)
                      / got["f32"].norm(dim=-1)).max())

    assert rel("kernels") <= 1.5 * rel("plain"), (rel("kernels"), rel("plain"))
    # the prefill: the encoder's, the decoder's and the cross
    # attentions; a step: the cross-attention over the frames
    L = cfg.n_layers
    assert build.LAUNCHES["flash_fwd"] == cfg.encoder_layers + 2 * L + 4 * L
    assert build.LAUNCHES["decode_attention"] == 4 * L


def _plain_scan(dt, bmat, cmat, u, a, h0):
    """The selective scan one step at a time, out of place, for
    autograd: h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t, y_t = h_t C_t."""
    h, ys = h0, []
    for t in range(dt.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[..., None] * bmat[:, t, None, :])
        ys.append(torch.einsum("bcn,bn->bc", h, cmat[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.cuda
def test_selective_scan_backward_on_the_card(dev):
    """SelectiveScan at jamba SMOKE's width (d_in 128, N 8) over 300
    steps (a chunk of 256 and a ragged one of 44) on the card: its
    outputs and six cotangents against float32 autograd through the
    plain recurrence on the card, within the bf16 residuals' rounding
    (1e-2 relative L2; the forward keeps float32: 1e-4), and against the
    same Function on the CPU (1e-4: the same algorithm)."""
    from repro_torch.models.mamba import SelectiveScan
    g = torch.Generator().manual_seed(7)
    b, s, c, n = 2, 300, 128, 8
    ins = [torch.randn(b, s, c, generator=g).abs() * 0.1,
           torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g),
           torch.randn(b, s, c, generator=g),
           -torch.exp(torch.randn(c, n, generator=g) * 0.5),
           torch.randn(b, c, n, generator=g)]
    cts = (torch.randn(b, s, c, generator=g), torch.randn(b, c, n, generator=g))

    def run(fn, device):
        leaves = [t.to(device).requires_grad_() for t in ins]
        outs = fn(*leaves)
        grads = torch.autograd.grad(outs, leaves,
                                    tuple(t.to(device) for t in cts))
        return [t.detach().cpu() for t in tuple(outs) + grads]

    def rel(a, b_):
        return float((a - b_).norm() / b_.norm())

    card = run(lambda *x: SelectiveScan.apply(*x, 256), dev)
    plain = run(_plain_scan, dev)
    cpu = run(lambda *x: SelectiveScan.apply(*x, 256), "cpu")
    for i, (a, p, c_) in enumerate(zip(card, plain, cpu)):
        assert rel(a, p) <= (1e-4 if i < 2 else 1e-2), i
        assert rel(a, c_) <= 1e-4, i


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
    # head dim 32 (lammps-proxy's 8 heads over 8 KV heads), g = 1 and 4
    (2, 300, 300, 8, 8, 32, True), (1, 129, 300, 8, 2, 32, True),
    (2, 100, 300, 4, 4, 32, False),
    # head dims 16 (the SMOKE configs': 4 heads over 2) and 8 (qwen2-72b's
    # SMOKE: the QK^T and dO V^T products over one 16-deep step whose
    # depth 8..15 is zero)
    (2, 300, 300, 4, 2, 16, True), (1, 129, 300, 4, 4, 16, False),
    (2, 300, 300, 8, 2, 8, True), (1, 129, 300, 8, 1, 8, True),
    (2, 100, 300, 4, 4, 8, False),
    # g = 4 at head dim 128: jamba-v0.1-52b's 32 heads over 8 KV heads
    (2, 300, 300, 32, 8, 128, True), (1, 129, 300, 32, 8, 128, False),
    # head dim 160 (pixtral-12b's 32 heads over 8: dk and dv in two
    # passes), and whisper's cross-attention backward (8 heads of 64,
    # non-causal, query rows far fewer than keys)
    (2, 300, 300, 32, 8, 160, True), (1, 129, 300, 8, 1, 160, True),
    (2, 100, 300, 4, 4, 160, False), (1, 33, 65, 2, 2, 160, True),
    (2, 64, 750, 8, 8, 64, False),
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
    (2, 300, 300, 8, 2, 128, True), (1, 129, 300, 16, 8, 64, False),
    (2, 300, 300, 32, 8, 160, True)])
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
    (1, 33, 65, 2, 2, 64, -40), (1, 130, 100, 8, 8, 32, -70),
    (1, 130, 100, 4, 2, 16, -70), (1, 130, 100, 8, 2, 8, -70)])
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
                                     (16, 1, 128), (8, 8, 32), (4, 2, 16),
                                     (8, 2, 8), (32, 8, 160), (16, 1, 160)])
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
    (16, 40, 4096, 14336),              # jamba's widths, a small T
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



# ---------------------------------------------------------------------------
# the engine's CUDA graphs: captured ticks against eager ones
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ["yi-6b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
               "xlstm-1.3b"]
GRAPH_ECFG = dict(n_slots=4, page_size=8, max_prompt_len=80, max_seq_len=96)
GRAPH_LENS = (3, 13, 77, 65, 9, 13)
GRAPH_TEMPS = (0.0, 0.7, 0.0, 0.7, 0.0, 0.7)


def _graph_prompts(cfg):
    return [[(5 * i + 3 * j + 1) % cfg.vocab_size for j in range(n)]
            for i, n in enumerate(GRAPH_LENS)]


def _graph_engine(cfg, dev, graphs, **kw):
    from repro_torch.serve import Engine, EngineConfig
    return Engine(cfg, EngineConfig(**dict(GRAPH_ECFG, **kw)), seed=0,
                  device=dev, cuda_graphs=graphs)


def _served(eng, prompts, temps, new=8):
    reqs = [eng.submit(p, max_new_tokens=new, temperature=t)
            for p, t in zip(prompts, temps)]
    eng.run()
    assert all(r.finished for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 16], ids=["legacy", "chunk16"])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_captured_engine_equals_the_eager_one(dev, arch, chunk):
    """The same prompts (greedy and t = 0.7 rows) through a captured and
    an eager engine of one seed: the same streams token for token, the
    same launch counts (a replay adds its graph's), the same prefill
    cache; the captured engine replayed every step kind it ran."""
    from repro_torch.configs import registry
    cfg = registry.smoke(arch)
    prompts = _graph_prompts(cfg)
    got = {}
    for graphs in (False, True):
        eng = _graph_engine(cfg, dev, graphs, prefill_chunk=chunk)
        build.reset_launches()
        streams = _served(eng, prompts, GRAPH_TEMPS)
        torch.cuda.synchronize()
        got[graphs] = (streams, dict(build.LAUNCHES),
                       eng.stats()["prefill_cache"], eng.n_mixed_steps)
        if graphs:
            assert eng._decode.graph is not None
            mixed = chunk and not cfg.sub_quadratic
            assert (eng._mixed.graph is not None) == bool(mixed)
            if not mixed:
                assert any(s.graph is not None
                           for s in eng._prefill_cache.values())
        else:
            assert eng.n_captures == 0
    assert got[True] == got[False]
    assert got[True][1]["rmsnorm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_park_and_adopt_across_captured_and_eager_engines(dev, arch):
    """Parked after 3 decode ticks by an eager engine and adopted by a
    captured one, and the reverse: the streams (greedy and t = 0.7) are
    the uninterrupted eager run's."""
    from repro_torch.configs import registry
    cfg = registry.smoke(arch)
    prompts = _graph_prompts(cfg)
    want = _served(_graph_engine(cfg, dev, False), prompts, GRAPH_TEMPS)
    for first, second in ((False, True), (True, False)):
        eng = _graph_engine(cfg, dev, first)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=t)
                for p, t in zip(prompts, GRAPH_TEMPS)]
        while eng.n_decode_steps < 3:
            assert eng.step()
        snap = eng.snapshot_state()
        new = _graph_engine(cfg, dev, second)
        new.adopt_state(snap)
        new.run()
        assert [r.tokens for r in reqs] == want, (first, second)


@pytest.mark.cuda
def test_captured_two_shard_chunks_pad_into_their_own_null_page(dev):
    """dp_shards = 2, chunked and captured: the chunk padding of a slot
    in shard 1 lands on shard 1's null page, not on the null page of the
    slot whose chunk was captured (page 0), and the streams equal the
    one-shard captured run's."""
    from repro_torch.configs import registry
    cfg = registry.smoke("yi-6b")
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate((40, 45, 37, 37))]
    temps = (0.0,) * 4
    want = _served(_graph_engine(cfg, dev, True, prefill_chunk=16),
                   prompts, temps, new=16)
    eng = _graph_engine(cfg, dev, True, prefill_chunk=16, dp_shards=2)
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    assert eng.step()
    assert [eng.alloc.shard_of(r.slot) for r in reqs] == [0, 0, 1, 1]
    while not reqs[1].tokens:          # shard 0's prompts are in
        assert eng.step()
    assert eng._mixed.graph is not None
    null1 = eng.alloc.null_page_of(2)
    assert null1 != 0
    pools = [kv for kv in eng.pool.values() if "k" in kv]

    def page(p):
        return [t[:, p].clone() for kv in pools for t in kv.values()]

    before0, before1 = page(0), page(null1)
    while not reqs[3].tokens:          # shard 1's prompts, chunk by chunk
        assert eng.step()
    assert not any(r.finished for r in reqs[:2])   # slots 0, 1 decoding
    assert all(torch.equal(a, b) for a, b in zip(page(0), before0))
    assert not all(torch.equal(a, b) for a, b in zip(page(null1), before1))
    eng.run()
    assert [r.tokens for r in reqs] == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_evicted_prefill_entry_recaptures_after_its_next_miss(dev, arch):
    """Exact-length prefill at ``prefill_cache_cap=1``: lengths 13, 13,
    9, 13, 13 one after another.  A length runs eagerly on its miss and
    is captured on its hit; 9 evicts 13, whose next miss runs eagerly
    again and whose hit after that captures anew; every stream equals an
    eager engine's."""
    from repro_torch.configs import registry
    cfg = registry.smoke(arch)
    prompts = [_graph_prompts(cfg)[i] for i in (1, 5, 4, 1, 5)]
    got = {}
    for graphs in (False, True):
        eng = _graph_engine(cfg, dev, graphs, prefill_cache_cap=1)
        streams, captured = [], []
        for p in prompts:
            streams += _served(eng, [p], (0.7,))
            entry, = eng._prefill_cache.items()
            captured.append((entry[0], entry[1].graph is not None))
        got[graphs] = streams
        assert eng.stats()["prefill_cache"] == {
            "size": 1, "cap": 1, "hits": 2, "misses": 3, "evictions": 2}
    assert got[True] == got[False]
    assert captured == [(13, False), (13, True), (9, False), (13, False),
                        (13, True)]


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs a second CUDA device")
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_captured_engine_on_a_second_device_equals_the_eager_one(arch):
    """An engine on cuda:1 while cuda:0 is the current device (a fleet
    replica on another chip): its graphs capture and replay its own
    device's stream, so the streams equal an eager engine's there and
    the captured engine replayed its decode tick."""
    from repro_torch.configs import registry
    cfg = registry.smoke(arch)
    prompts = _graph_prompts(cfg)
    assert torch.cuda.current_device() == 0
    got = {}
    for graphs in (False, True):
        eng = _graph_engine(cfg, torch.device("cuda:1"), graphs)
        build.reset_launches()
        got[graphs] = (_served(eng, prompts, GRAPH_TEMPS),
                       dict(build.LAUNCHES))
    assert eng._decode.graph is not None and eng.n_captures >= 2
    assert got[True] == got[False]
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_rebound_params_drop_the_graphs(dev):
    """A graph reads the tensors it was captured on: rebinding
    ``eng.params`` (to a copy) mid-run drops every graph, the next ticks
    capture anew, and the streams stay the eager run's."""
    from repro_torch.configs import registry
    from repro_torch.models import params as P
    cfg = registry.smoke("yi-6b")
    prompts = _graph_prompts(cfg)
    want = _served(_graph_engine(cfg, dev, False), prompts, GRAPH_TEMPS)
    eng = _graph_engine(cfg, dev, True)
    reqs = [eng.submit(p, max_new_tokens=8, temperature=t)
            for p, t in zip(prompts, GRAPH_TEMPS)]
    while eng.n_decode_steps < 3:
        assert eng.step()
    captured = eng.n_captures
    assert eng._decode.graph is not None
    eng.params = P.tree_map(lambda t: t.clone(), eng.params)
    eng.run()
    assert [r.tokens for r in reqs] == want
    assert eng.n_captures > captured
    assert eng._bound[0] is eng.params


@pytest.mark.cuda
def test_the_collector_waits_while_an_engine_captures(dev):
    """A collection inside a capture could free a dead engine's graphs (a
    call the capture refuses, which fails it): the engine pauses the
    garbage collector while it captures and resumes it after."""
    import gc
    from repro_torch.configs import registry
    cfg = registry.smoke("yi-6b")
    eng = _graph_engine(cfg, dev, True)
    decode, seen = eng.model.decode_step, []

    def probe(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return decode(*a, **k)

    eng.model.decode_step = probe
    assert gc.isenabled()
    _served(eng, _graph_prompts(cfg)[:2], (0.0, 0.7))
    assert seen == [False] and gc.isenabled()


@pytest.mark.cuda
def test_a_step_that_reads_the_device_during_capture_raises(dev):
    """A step that reads a device tensor on the host runs eagerly on its
    first tick and raises at its capture: no eager retry, and the failed
    capture counts no launch.  (Last in this file: after a failed
    capture, torch's CUDA generator stays in its capture state.)"""
    from repro_torch.configs import registry
    cfg = registry.smoke("yi-6b")
    eng = _graph_engine(cfg, dev, True)
    decode = eng.model.decode_step

    def reads_the_device(params, caches, tokens, lengths, **kw):
        int(lengths[0])
        return decode(params, caches, tokens, lengths, **kw)

    eng.model.decode_step = reads_the_device
    eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.step() and eng.step()        # the prefill, an eager decode
    assert eng.n_decode_steps == 1
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError):
        eng.step()
    assert dict(build.LAUNCHES) == before
    assert eng._decode.graph is None and eng.n_decode_steps == 1


@pytest.mark.cuda
def test_engine_on_four_ranks_of_the_card_holds_to_one_rank(dev, tmp_path):
    """yi-6b SMOKE on a (data 2, model 2) mesh of four gloo ranks of the
    card (``dp_shards`` 2, eager ticks), legacy and chunked: every rank
    launches the serving kernels at its local shapes and gives the same
    greedy streams, each held to the one-rank engine of the same seed by
    the bf16 stream rule: every token lies within 3e-2 of the one-rank
    model's max logit with the stream before it as the prompt (sums over
    halved heads round otherwise, so a stream may part from the one-rank
    engine's, shown on failure, where two logits lie that close)."""
    import multiprocessing
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_serve_ranks as R
    from repro_torch.configs import registry
    from repro_torch.models.model import Model

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=R.cuda_rank,
                         args=(r, str(tmp_path / "pg"), q))
             for r in range(R.WORLD)]
    for p in procs:
        p.start()
    try:
        res = sorted((q.get(timeout=300) for _ in procs),
                     key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [r["error"] for r in res if "error" in r]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * R.WORLD
    cfg = registry.smoke(R.YI)
    eng = R.Engine(cfg, R.EngineConfig(**R.CUDA_ECFG), seed=0, device=dev,
                   cuda_graphs=False)
    model = Model(cfg)
    for chunk in R.CUDA_CHUNKS:
        streams, _ = res[0][chunk]
        one, _ = R.cuda_streams(None, chunk, dev)
        kernels = ("paged_prefill" if chunk else "flash_fwd",
                   "paged_decode", "rmsnorm")
        for r in res:
            assert r[chunk][0] == streams, (r["rank"], chunk)
            assert all(r[chunk][1][k] > 0 for k in kernels), r[chunk][1]
        for prompt, got, want in zip(R.CUDA_PROMPTS, streams, one):
            n = len(got)
            assert n == R.CUDA_NEW
            toks = torch.tensor([prompt + got[:-1]] * n, device=dev)
            last = torch.arange(n, device=dev) + len(prompt) - 1
            logits, _ = model.prefill(eng.params, {"tokens": toks},
                                      last_index=last)
            logits = logits.float()
            chosen = logits[torch.arange(n, device=dev),
                            torch.tensor(got, device=dev)]
            assert bool((chosen >= logits.amax(-1) - 3e-2).all()), \
                (chunk, got, want)
