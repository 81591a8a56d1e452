#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  - ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build   - nvcc builds every kernel from ``src/repro_torch/csrc``;
3. kernels - each CUDA kernel against its plain PyTorch version at the
             shapes the served, trained and synced paths give it (bf16
             within tolerances, int8 quantize exactly): max
             error against the stated tolerance, and CUDA-event medians
             of the kernel, the plain version and one PyTorch library
             call, beside the least time the card could take.  The
             attention kernels are held at yi-6b's head dim 128 and
             granite's 64, flash attention also on query rows that see
             no key (a negative query offset), and flash_fwd's output
             also in relative L2; flash attention's
             kernels also give their achieved TFLOP/s beside SDPA's at
             the training shapes and the same bits on a second run, as
             do paged decode (split across blocks: both head dims beside
             SDPA on the gathered KV) and the grouped expert GEMM (T 8,
             160 and 5120 and the backward's dX and dW, each beside
             torch.bmm); decode over a contiguous cache gives the same
             bits as paged decode over the same keys (one split kernel);
             paged prefill (a 256-row chunk at both head dims, beside SDPA
             on the gathered KV) also in relative L2, the same bits twice
             and against flash_fwd over the same keys; and flash_fwd gives
             the bits it gave before its kernel body was shared with
             paged prefill (tools/attention_bits.py);
4. serve   - yi-6b at full width and depth (random weights from a seeded
             generator) through the port's Engine, legacy prefill and
             chunked prefill, with the kernels' launch counts read around
             each run; one prompt and 4 decode steps teacher-forced
             through the kernel path and the plain path; then 4 of the
             prompts alone through the contiguous path (Model.prefill
             right-padded to 1024, then decode steps at a scalar index)
             against the legacy engine's streams; then granite-moe-1b-
             a400m at full width and depth through the Engine in both
             modes, and teacher-forced;
5. train   - the gradients of yi-6b and of granite-moe-1b-a400m at full
             width and 2 layers on one 2 x 4096 batch through the kernel
             path, the plain path in bf16 and the plain path in float32;
             yi-6b at full width and 8 of its 32 layers trained 4 steps
             through the port's Trainer (AdamW, float32 master weights,
             bf16 compute, remat) with the launch counts read around the
             run and a checkpoint saved at step 2, restored into a fresh
             Trainer and stepped on to 4; then granite-moe-1b-a400m at
             full width and all 24 layers trained 4 steps, batch 4 x 4096;
6. comm    - granite-moe-1b-a400m at full width and 8 of its 24 layers,
             4 steps of 4 x 4096 tokens: on one device with grad_accum=4,
             then on four ranks of the one card (spawned processes, gloo,
             a (pod=2, data=2) mesh, one row each) under hierarchical
             sync and under int8 error-feedback sync (both comm_strict):
             losses against the one-device run, the quantize kernels'
             launches per step, a traced compressed step on rank 0, and
             one sync of a gradient of the largest leaf's shape against
             its exact mean.

Then the ``kernels`` JSON line, the card's line, and the result line.
Any failure raises and exits non-zero; without CUDA, or without the port
beside this file, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16 flop/s,
# float32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12
# kernel vs plain version, bf16 outputs: |a - b| <= TOL * (1 + |b|).  Both
# round once to bf16 after f32 sums taken in another order (and the
# attention kernels round p where their plain versions do: to bf16 before
# p @ v in flash_fwd and paged_prefill, not at all in the decode kernels),
# so they differ by a few bf16 ulps (2^-8 relative each).
TOL = 2e-2
# lse is f32 on both sides: only the summation order differs
LSE_TOL = 1e-3
# flash_bwd's dq, dk and dv, whole tensor: ||kernel - plain|| <= REL_L2_TOL
# * ||plain||.  The element check above is loose for the bulk of small
# gradients (late query rows and keys); this holds all of them.  Both
# round p and ds to bf16 before the products that take them (2^-9
# relative each), from f32 values summed in another order, and both
# round the output once.
REL_L2_TOL = 1e-2
# flash_fwd's out, whole tensor, and paged_prefill's real rows:
# ||kernel - plain|| <= FWD_REL_L2_TOL * ||plain||.  With randn inputs
# |out| is ~0.04 at 4096 keys, where the element check above allows ~2/3
# of a value.  Each side rounds p and out to bf16 (2^-9 relative each)
# from f32 values summed in another order, so two correct versions lie
# about two such roundings (3.9e-3) apart at most; this file prints the
# measured error at each shape.
FWD_REL_L2_TOL = 4e-3
# teacher-forced logits through 32 layers: both bf16 paths (kernels and
# plain versions) round activations at other places in every layer, so
# they drift apart by the bf16 noise of the model itself.  The kernel
# path must stay as close to float32 compute (plain versions) as the
# plain bf16 path is, within this factor.
LOGIT_NOISE_FACTOR = 1.5

# the grouped expert GEMM sums D products of unit-scale bf16 values per
# output: kernel and plain version are compared after scaling both by
# 1 / sqrt(D), the size of such a sum, at TOL

# the contiguous path against the engine's stream: where the two greedy
# streams part, the engine's token must be within this much of the
# contiguous path's largest logit at that step (bf16 logits of yi-6b's
# random head: about one bf16 step at the top of the range)
STREAM_LOGIT_TOL = 3e-2

# resumed training: the losses of steps 2 and 3 after a checkpoint
# round trip against the uninterrupted run (the embedding's backward
# sums with atomics, so the last bits may differ)
RESUME_RTOL = 1e-4

# the comm phase (four ranks on one card, gloo): hier's losses against one
# device's grad_accum=4 run over the same rows (only the float32 order of
# the sync's sums differs, and a flipped bf16 rounding or MoE route can
# follow from it)
COMM_RTOL = 1e-4
# hier-int8's losses against hier's at steps 1-3: int8 with error
# feedback moves each synced gradient value by at most one quantum of its
# block (1/127 of its absmax), and AdamW's step is bounded by the learning
# rate whatever the gradient, so three steps move the loss far less than 1%
COMPRESS_RTOL = 1e-2
COMM_LAYERS = 8             # of granite's 24: four ranks of all 24 need ~150 GB
COMM_STEPS = 4
COMM_TIMEOUT_S = 300        # each collective (gloo's own timeout)
COMM_DEADLINE_S = 900       # the whole phase, children included

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:27",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:86",
    "paged_decode": "src/repro/kernels/decode_attention/kernel.py:148",
    "paged_prefill": "src/repro/kernels/decode_attention/kernel.py:240",
    "flash_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:249",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention/kernel.py:249",
    "moe_gemm": "src/repro/kernels/moe_gemm/kernel.py:39",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:62",
    "quantize": "src/repro/kernels/quantize/kernel.py:40",
    "dequantize": "src/repro/kernels/quantize/kernel.py:61",
}
SOURCES = {
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_fwd": "src/repro_torch/csrc/flash_fwd.cu",
    "paged_decode": "src/repro_torch/csrc/paged_attention.cu",
    "paged_prefill": "src/repro_torch/csrc/paged_attention.cu",
    "flash_bwd_dq": "src/repro_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "src/repro_torch/csrc/flash_bwd.cu",
    "moe_gemm": "src/repro_torch/csrc/moe_gemm.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "quantize": "src/repro_torch/csrc/quantize.cu",
    "dequantize": "src/repro_torch/csrc/quantize.cu",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sleep_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def median_ms(cycles_per_ms, fn, n=10, reps=7):
    """Device time of one call: the median over ``reps`` of CUDA events
    around ``n`` calls back to back, divided by ``n``.  A GPU sleep
    queued first holds the card while the host enqueues the calls, so
    the host's launch overhead stays out of the time."""
    import torch
    fn()                                    # warm: first calls pick kernels
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    cycles = int(cycles_per_ms * (4 * n * sorted(host)[1] + 2.0))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops, flops_s=BF16_FLOPS_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flops_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def err_within(got, want, tol):
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol * (1 + want.float().abs())).all())


def rel_l2(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref

    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    H, HKV, D, PAGE = 32, 4, 128, 16
    cpm = sleep_cycles_per_ms(torch)
    rows_out = {}

    # rmsnorm at the decode tick's (8, 4096), the prefill's (512, 4096)
    # and a train step's (2 x 4096, 4096); timed at the prefill's
    w = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    errs = []
    for rows in (8, 512, 8192):
        xr = rnd(rows, 4096)
        e, ok = err_within(ops.rmsnorm(xr, w), rn_ref.rmsnorm_ref(xr, w), TOL)
        check(ok, f"rmsnorm ({rows}, 4096) differs from the plain version")
        errs.append(e)
        if rows == 512:
            x = xr
    wb = w.to(bf)
    rows_out["rmsnorm"] = dict(
        max_abs_err=max(errs),
        ms=median_ms(cpm, lambda: ops.rmsnorm(x, w)),
        plain_ms=median_ms(cpm, lambda: rn_ref.rmsnorm_ref(x, w)),
        library_ms=median_ms(cpm, lambda: F.rms_norm(x, (4096,), wb, 1e-5)),
        bound=bound(2 * x.numel() * 2 + w.numel() * 4, 4 * x.numel()),
        shape="x (512, 4096) bf16, w (4096,) f32")

    # flash forward: the legacy prefill of a 512-token prompt
    S = 512
    q, k, v = rnd(1, S, H, D), rnd(1, S, HKV, D), rnd(1, S, HKV, D)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True)
    e, ok = err_within(out, ref_out, TOL)
    check(ok, "flash_fwd out differs from the plain version")
    e_lse = float((lse - ref_lse).abs().max())
    check(e_lse <= LSE_TOL, f"flash_fwd lse differs by {e_lse}")
    fwd_rel_l2(out, ref_out, "(1,512)")
    fwd_rate(torch, cpm, "q (1,512,32,128) kv (1,512,4,128) causal", q, k, v)
    rows_out["flash_fwd"] = dict(
        max_abs_err=e, lse_err=e_lse,
        shape="q (1,512,32,128), kv (1,512,4,128) bf16, causal")

    # paged decode: 8 slots of ragged lengths up to 1024, page 16
    B, MAXP = 8, 1024 // PAGE
    n_pages = B * MAXP + 1
    kp, vp = rnd(n_pages, PAGE, HKV, D), rnd(n_pages, PAGE, HKV, D)
    bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)[:B * MAXP]
          ).to(torch.int32).reshape(B, MAXP)
    lens = torch.tensor([1, 17, 100, 256, 511, 700, 1000, 1024],
                        dtype=torch.int32, device=dev)
    qd = rnd(B, 1, H, D)
    got = ops.paged_decode_attention(qd, kp, vp, bt, lens)
    e, ok = err_within(got, dec_ref.paged_decode_ref(qd, kp, vp, bt, lens), TOL)
    check(ok, "paged_decode differs from the plain version")
    check(torch.equal(got, ops.paged_decode_attention(qd, kp, vp, bt, lens)),
          "paged_decode gave other bits on a second run of the same inputs")
    kg = kp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
    mask = (torch.arange(MAXP * PAGE, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    filled = int(lens.sum())
    rows_out["paged_decode"] = dict(
        max_abs_err=e,
        ms=median_ms(cpm, lambda: ops.paged_decode_attention(qd, kp, vp, bt, lens)),
        plain_ms=median_ms(cpm, lambda: dec_ref.paged_decode_ref(qd, kp, vp, bt,
                                                            lens)),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)),
        bound=bound(2 * filled * HKV * D * 2 + 2 * qd.numel() * 2
                    + bt.numel() * 4, 4 * filled * H * D),
        shape="q (8,1,32,128), pools (1025,16,4,128) bf16, lengths 1..1024")
    paged_decode_rate(torch, rows_out["paged_decode"], "yi-6b", B * HKV, MAXP)

    # paged prefill: a 256-row chunk at start 0 and at start 256, timed
    # at start 256
    rows_out["paged_prefill"] = paged_prefill_row(
        torch, dev, rnd, cpm, "yi-6b", H, kp, vp, bt[:1], ((0, 200), (256, 180)))
    rows_out["paged_prefill"]["shape"] = (
        "q (1,256,32,128) at start 256, n_valid 180, page 16")

    # flash forward and backward at yi-6b's published 4K training context
    # and the Trainer's batch of 2
    S, B2 = 4096, 2
    q, k, v = rnd(B2, S, H, D), rnd(B2, S, HKV, D), rnd(B2, S, HKV, D)
    do = rnd(B2, S, H, D)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True)
    e, ok = err_within(out, ref_out, TOL)
    check(ok, "flash_fwd out at (2, 4096) differs from the plain version")
    e_lse = float((lse - ref_lse).abs().max())
    check(e_lse <= LSE_TOL, f"flash_fwd lse at (2, 4096) differs by {e_lse}")
    fwd_rel_l2(out, ref_out, "(2,4096)")
    again = fa_kernel.flash_fwd(q, k, v, causal=True)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash_fwd gave other bits on a second run of the same inputs")
    del again, ref_out, ref_lse
    # the row: yi-6b's training shape, where the forward costs most
    fwd_row = rows_out["flash_fwd"]
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], e)
    fwd_row["lse_err"] = max(fwd_row["lse_err"], e_lse)
    fwd_row["shape"] = ("q (2,4096,32,128), kv (2,4096,4,128) bf16, causal; "
                        "held at (1,512) and (2,4096)")
    ms, lib = fwd_rate(torch, cpm, "q (2,4096,32,128) kv (2,4096,4,128) "
                       "causal", q, k, v)
    pairs = S * (S + 1) // 2                 # (query, key) pairs under the mask
    fwd_row.update(
        ms=ms, library_ms=lib,
        plain_ms=median_ms(cpm, lambda: fa_ref.chunked(q, k, v, causal=True),
                           n=2, reps=3),
        bound=bound((2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4,
                    4 * B2 * pairs * H * D))
    got = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=True)
    want = fa_ref.bwd(q, k, v, out, lse, do, causal=True)
    errs, rels = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e, ok = err_within(a, b, TOL)
        check(ok, f"flash_bwd {name} differs from the plain version")
        r = rel_l2(a, b)
        check(r <= REL_L2_TOL, f"flash_bwd {name} differs from the plain "
              f"version by {r:.3g} in relative L2 (tol {REL_L2_TOL})")
        errs.append(e)
        rels.append(r)
    print(f"[kernels] flash_bwd (2,4096): relative L2 error against the "
          f"plain version dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv "
          f"{rels[2]:.3g} (tol {REL_L2_TOL})")
    first = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=True)
    again = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=True)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "flash_bwd gave other bits on a second run of the same inputs")
    del got, want, first, again
    delta = (out.float() * do.float()).sum(-1)
    # the plain version and the library call compute dq, dk and dv
    # together: both rows carry the whole backward's time
    plain = median_ms(cpm, lambda: fa_ref.bwd(q, k, v, out, lse, do,
                                              causal=True), n=2, reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k.repeat_interleave(H // HKV, dim=2),
                            v.repeat_interleave(H // HKV, dim=2)))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    library = median_ms(cpm, sdpa_fwd_bwd) - median_ms(cpm, sdpa_fwd)
    matmul = 2 * B2 * pairs * H * D          # flops of one S x S x D product
    in_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * lse.numel() * 4
    print(f"[kernels] flash_bwd: the whole backward does 5 products (s, dp, "
          f"dq, dk, dv) = {5 * matmul:.3e} flops, "
          f"{5 * matmul / BF16_FLOPS_S * 1e3:.4f} ms at the bf16 peak; the dq "
          f"kernel does 3 of them, the dk/dv kernel 4 (s and dp again)")
    kw = dict(causal=True)
    shape = "q (2,4096,32,128), kv (2,4096,4,128) bf16, causal"
    rows_out["flash_bwd_dq"] = dict(
        max_abs_err=errs[0],
        ms=median_ms(cpm, lambda: fa_kernel.flash_bwd_dq(q, k, v, do, lse,
                                                         delta, **kw)),
        plain_ms=plain, library_ms=library,
        bound=bound(in_bytes + q.numel() * 2, 3 * matmul), shape=shape)
    rows_out["flash_bwd_dkv"] = dict(
        max_abs_err=max(errs[1:]),
        ms=median_ms(cpm, lambda: fa_kernel.flash_bwd_dkv(q, k, v, do, lse,
                                                          delta, **kw)),
        plain_ms=plain, library_ms=library,
        bound=bound(in_bytes + 2 * k.numel() * 2, 4 * matmul), shape=shape)
    print(bwd_rate("q (2,4096,32,128) kv (2,4096,4,128) causal",
                   rows_out["flash_bwd_dq"]["ms"],
                   rows_out["flash_bwd_dkv"]["ms"], matmul, library))

    head_dim_64(torch, dev, rows_out, rnd, cpm)
    parent_bits(torch, dev)
    decode_paths_agree(torch, dev, rnd)
    unseen_rows(torch, dev, rows_out, rnd)
    rows_out["moe_gemm"] = moe_gemm_row(torch, dev, rnd, cpm)
    rows_out["decode_attention"] = decode_attention_row(torch, dev, rnd, cpm)
    rows_out.update(quantize_rows(torch, dev, cpm))

    for name, r in rows_out.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        tol = r.get("tol", f"{TOL} x (1+|ref|)")
        print(f"[kernels] {name}: {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3g} (tol {tol}) "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound'][0]:.4f} "
              f"ms ({r['bound'][1]})")
    return rows_out


def fwd_rel_l2(out, ref_out, shape):
    """Hold flash_fwd's whole output against the plain version's in
    relative L2 (FWD_REL_L2_TOL) and print the error."""
    r = rel_l2(out, ref_out)
    check(r <= FWD_REL_L2_TOL, f"flash_fwd out at {shape} differs from the "
          f"plain version by {r:.3g} in relative L2 (tol {FWD_REL_L2_TOL})")
    print(f"[kernels] flash_fwd {shape}: relative L2 error of out against "
          f"the plain version {r:.3g} (tol {FWD_REL_L2_TOL})")


def fwd_rate(torch, cpm, shape, q, k, v):
    """Time flash_fwd and SDPA's forward (no grad, causal, GQA without a
    KV repeat, on the (B, H, S, D) transposes) at one shape and print
    each one's time, achieved TFLOP/s of the two products under the
    causal mask and share of their bound at the bf16 peak.  Returns
    (kernel ms, SDPA ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    b, s, h, d = q.shape
    flops = 2 * 2 * b * (s * (s + 1) // 2) * h * d
    least = flops / BF16_FLOPS_S * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    t = median_ms(cpm, lambda: fa_kernel.flash_fwd(q, k, v, causal=True))
    lib = median_ms(cpm, sdpa)
    parts = [f"{name} {x:.4f} ms = {flops / x / 1e9:.1f} TFLOP/s "
             f"({least / x:.3f} of the bound)"
             for name, x in (("flash_fwd", t), ("SDPA forward", lib))]
    print(f"[kernels] flash_fwd {shape}: {flops:.4g} flops, bound "
          f"{least:.4f} ms; " + "; ".join(parts)
          + f"; flash_fwd {t / lib:.2f}x SDPA")
    return t, lib


def bwd_rate(shape, t_dq, t_dkv, matmul, library=None):
    """flash_bwd's two kernels at one shape: each one's time, achieved
    TFLOP/s (3 and 4 products of ``matmul`` flops) and share of its bound
    at the bf16 peak, and their sum beside SDPA's backward where timed."""
    parts = []
    for name, t, n in (("flash_bwd_dq", t_dq, 3), ("flash_bwd_dkv", t_dkv, 4)):
        least = n * matmul / BF16_FLOPS_S * 1e3
        parts.append(f"{name} {t:.4f} ms = {n * matmul / t / 1e9:.1f} TFLOP/s"
                     f" (bound {least:.4f} ms, {least / t:.3f} of it)")
    lib = "" if library is None else (
        f", {(t_dq + t_dkv) / library:.2f}x SDPA's backward ({library:.4f} ms)")
    return (f"[kernels] flash_bwd {shape}: " + "; ".join(parts)
            + f"; both {t_dq + t_dkv:.4f} ms{lib}")


def paged_decode_rate(torch, row, label, slots_heads, maxp, page=16):
    """Print paged decode's time beside SDPA on the gathered KV and its
    byte bound, with the split plan the wrapper launched."""
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    n, pps = dec_kernel.plan_splits(
        maxp, page, slots_heads,
        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"[kernels] paged_decode {label} (8 slots, lengths 1..1024): "
          f"kernel {row['ms']:.4f} ms in {n} splits of {pps * page} keys, "
          f"SDPA on the gathered KV {row['library_ms']:.4f} ms "
          f"({row['ms'] / row['library_ms']:.2f}x), bound "
          f"{row['bound'][0]:.5f} ms ({row['bound'][0] / row['ms']:.3f} of "
          f"it)")


def paged_prefill_row(torch, dev, rnd, cpm, label, h, kp, vp, bt1, fills):
    """paged_prefill of a 256-row chunk of ``h`` query heads over the
    slot's pages ``bt1`` at each (start, n_valid) of ``fills``: within
    TOL per element and FWD_REL_L2_TOL in relative L2 of the plain
    version over the real rows, the same bits twice, every row finite
    (padding rows too: the engine writes their K/V into the null page),
    and the real rows within TOL of flash_fwd over the same keys gathered
    (q_offset = start).  Timed at the last fill beside the plain version
    and SDPA on the gathered KV; returns the kernels row."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    _, page, hkv, d = kp.shape
    C, maxp = 256, bt1.shape[1]
    kg = kp[bt1.long()].reshape(1, maxp * page, hkv, d)
    vg = vp[bt1.long()].reshape(1, maxp * page, hkv, d)
    errs = []
    for start, n_valid in fills:
        qc = rnd(1, C, h, d)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        got = ops.paged_prefill_attention(qc, kp, vp, bt1, st, nv)
        want = dec_ref.paged_prefill_ref(qc, kp, vp, bt1, st, nv)
        where = f"paged_prefill {label} at start {start}"
        e, ok = err_within(got[:, :n_valid], want[:, :n_valid], TOL)
        check(ok, f"{where} differs from the plain version")
        r = rel_l2(got[:, :n_valid], want[:, :n_valid])
        check(r <= FWD_REL_L2_TOL, f"{where} differs from the plain version "
              f"by {r:.3g} in relative L2 (tol {FWD_REL_L2_TOL})")
        check(torch.equal(got, ops.paged_prefill_attention(qc, kp, vp, bt1, st,
                                                           nv)),
              f"{where} gave other bits on a second run of the same inputs")
        check(bool(torch.isfinite(got.float()).all()),
              f"{where} has rows that are not finite")
        fill = start + n_valid
        flash, _ = fa_kernel.flash_fwd(qc, kg[:, :fill].contiguous(),
                                       vg[:, :fill].contiguous(), causal=True,
                                       q_offset=start)
        e_fa, ok = err_within(got[:, :n_valid], flash[:, :n_valid], TOL)
        check(ok, f"{where} differs from flash_fwd over the same keys")
        print(f"[kernels] {where}, n_valid {n_valid}: max error {e:.3g} and "
              f"relative L2 {r:.3g} against the plain version (tol {TOL}, "
              f"{FWD_REL_L2_TOL}) over the real rows; the same bits twice; "
              f"against flash_fwd over the gathered keys max error "
              f"{e_fa:.3g}, bit-equal "
              f"{torch.equal(got[:, :n_valid], flash[:, :n_valid])}")
        errs.append(e)
    # the keys each row sees: its causal prefix, cut at the fill
    seen = sum(min(start + j + 1, fill) for j in range(C))
    qpos = start + torch.arange(C, device=dev)
    kpos = torch.arange(maxp * page, device=dev)
    cmask = ((kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < fill))[None, None]
    kt, vt = kg.transpose(1, 2), vg.transpose(1, 2)
    row = dict(
        max_abs_err=max(errs),
        ms=median_ms(cpm, lambda: ops.paged_prefill_attention(qc, kp, vp, bt1, st,
                                                              nv)),
        plain_ms=median_ms(cpm, lambda: dec_ref.paged_prefill_ref(
            qc, kp, vp, bt1, st, nv)),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qc.transpose(1, 2), kt, vt, attn_mask=cmask, enable_gqa=True)),
        bound=bound(2 * fill * hkv * d * 2 + 2 * qc.numel() * 2,
                    4 * seen * h * d))
    print(f"[kernels] paged_prefill {label} q (1,256,{h},{d}) at start 256, "
          f"n_valid 180, page {page}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, SDPA on the gathered KV "
          f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}x), "
          f"bound {row['bound'][0]:.5f} ms ({row['bound'][1]}, "
          f"{row['bound'][0] / row['ms']:.3f} of it)")
    return row


def parent_bits(torch, dev):
    """flash_fwd's kernel body is the template paged prefill shares
    (flash_fwd.cuh): flash_fwd must give the bits it gave before
    (tools/attention_bits.py holds that tree's digests at this file's
    three flash_fwd shapes)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import attention_bits
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    differ = attention_bits.differ_from_parent(torch, dev, fa_kernel)
    check(not differ, f"flash_fwd gives other bits than before its body was "
          f"shared with paged prefill: {differ}")
    print(f"[kernels] flash_fwd: the same bits as before its body was shared "
          f"with paged prefill, at {len(attention_bits.PARENT)} shapes "
          f"(tools/attention_bits.py)")


def decode_paths_agree(torch, dev, rnd):
    """The engine decodes through paged_decode and the contiguous path
    through decode_attention: one split kernel behind two KV addressers.
    A row's keys, split alike, must give the same bits through both: a
    yi-6b-wide (8, 1024) cache against the same keys in a page pool (the
    serve phase then holds the two paths' greedy streams together)."""
    from repro_torch.kernels import ops
    B, S, H, HKV, D, PAGE = 8, 1024, 32, 4, 128, 16
    k, v, q = rnd(B, S, HKV, D), rnd(B, S, HKV, D), rnd(B, 1, H, D)
    bt = torch.arange(B * S // PAGE, dtype=torch.int32, device=dev).reshape(B, -1)
    pages = (k.reshape(-1, PAGE, HKV, D), v.reshape(-1, PAGE, HKV, D))
    for n in (1, 333, 700, 1024):
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        check(torch.equal(ops.decode_attention(q, k, v, n),
                          ops.paged_decode_attention(q, *pages, bt, lens)),
              f"decode_attention and paged_decode differ at cache_len {n}")
    print("[kernels] decode_attention and paged_decode: the same bits over "
          "the same keys, cache_len 1, 333, 700, 1024")


def _fold(row, err, note):
    """Count one more shape's error into a kernel's row."""
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["shape"] += note


def head_dim_64(torch, dev, rows_out, rnd, cpm):
    """The attention kernels at granite-moe-1b-a400m's head dim 64 (16
    query heads over 8 KV heads): flash forward and backward at its
    training shape (batch 4 x 4096), paged decode and prefill at its
    serving shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    H, HKV, D, PAGE = 16, 8, 64, 16
    q, k, v = rnd(4, 4096, H, D), rnd(4, 4096, HKV, D), rnd(4, 4096, HKV, D)
    do = rnd(4, 4096, H, D)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True)
    e, ok = err_within(out, ref_out, TOL)
    check(ok, "flash_fwd at head dim 64 differs from the plain version")
    e_lse = float((lse - ref_lse).abs().max())
    check(e_lse <= LSE_TOL, f"flash_fwd lse at head dim 64 differs by {e_lse}")
    fwd_rel_l2(out, ref_out, "(4,4096) head dim 64")
    _fold(rows_out["flash_fwd"], e, "; and q (4,4096,16,64), kv (4,4096,8,64)")
    again = fa_kernel.flash_fwd(q, k, v, causal=True)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash_fwd at head dim 64 gave other bits on a second run")
    del again, ref_out, ref_lse
    got = fa_kernel.flash_bwd(q, k, v, out, lse, do, causal=True)
    want = fa_ref.bwd(q, k, v, out, lse, do, causal=True)
    rels = []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e, ok = err_within(a, b, TOL)
        r = rel_l2(a, b)
        check(ok and r <= REL_L2_TOL, f"flash_bwd {name} at head dim 64 "
              f"differs from the plain version (relative L2 {r:.3g})")
        rels.append(r)
        _fold(rows_out["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"],
              e, "")
    del got, want
    delta = (out.float() * do.float()).sum(-1)
    t_fwd, _ = fwd_rate(torch, cpm, "q (4,4096,16,64) kv (4,4096,8,64) "
                        "causal", q, k, v)
    t_dq = median_ms(cpm, lambda: fa_kernel.flash_bwd_dq(
        q, k, v, do, lse, delta, causal=True), n=3, reps=5)
    t_dkv = median_ms(cpm, lambda: fa_kernel.flash_bwd_dkv(
        q, k, v, do, lse, delta, causal=True), n=3, reps=5)
    pairs = 4096 * 4097 // 2
    mm = 2 * 4 * pairs * H * D
    print(bwd_rate("q (4,4096,16,64) kv (4,4096,8,64) causal", t_dq, t_dkv, mm))
    print(f"[kernels] head dim 64, q (4,4096,16,64) kv (4,4096,8,64) causal: "
          f"flash_fwd {t_fwd:.4f} ms (bound {2 * mm / BF16_FLOPS_S * 1e3:.4f}),"
          f" flash_bwd_dq {t_dq:.4f} ms (bound {3 * mm / BF16_FLOPS_S * 1e3:.4f})"
          f", flash_bwd_dkv {t_dkv:.4f} ms (bound "
          f"{4 * mm / BF16_FLOPS_S * 1e3:.4f}); relative L2 dq {rels[0]:.3g}, "
          f"dk {rels[1]:.3g}, dv {rels[2]:.3g}")
    del q, k, v, do, out, lse, delta

    g = torch.Generator(device=dev).manual_seed(99)
    B, MAXP = 8, 1024 // PAGE
    n_pages = B * MAXP + 1
    kp, vp = rnd(n_pages, PAGE, HKV, D), rnd(n_pages, PAGE, HKV, D)
    bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)[:B * MAXP]
          ).to(torch.int32).reshape(B, MAXP)
    lens = torch.tensor([1, 17, 100, 256, 511, 700, 1000, 1024],
                        dtype=torch.int32, device=dev)
    qd = rnd(B, 1, H, D)
    got = ops.paged_decode_attention(qd, kp, vp, bt, lens)
    e, ok = err_within(got, dec_ref.paged_decode_ref(qd, kp, vp, bt, lens), TOL)
    check(ok, "paged_decode at head dim 64 differs from the plain version")
    check(torch.equal(got, ops.paged_decode_attention(qd, kp, vp, bt, lens)),
          "paged_decode at head dim 64 gave other bits on a second run")
    _fold(rows_out["paged_decode"], e, "; and at (8,1,16,64) over 8 KV heads")
    t_dec = median_ms(cpm, lambda: ops.paged_decode_attention(qd, kp, vp, bt,
                                                              lens))
    kg = kp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
    mask = (torch.arange(MAXP * PAGE, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    filled = int(lens.sum())
    paged_decode_rate(torch, dict(
        ms=t_dec,
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)),
        bound=bound(2 * filled * HKV * D * 2 + 2 * qd.numel() * 2
                    + bt.numel() * 4, 4 * filled * H * D)),
        "granite", B * HKV, MAXP)
    del kg, vg
    pre = paged_prefill_row(torch, dev, rnd, cpm, "granite", H, kp, vp, bt[:1],
                            ((256, 180),))
    _fold(rows_out["paged_prefill"], pre["max_abs_err"],
          "; and at (1,256,16,64) over 8 KV heads")
    print(f"[kernels] head dim 64 serving shapes: paged_decode (8 slots, "
          f"lengths 1..1024) {t_dec:.4f} ms, paged_prefill (256 rows at start "
          f"256, n_valid 180) {pre['ms']:.4f} ms")


def unseen_rows(torch, dev, rows_out, rnd):
    """Causal attention with a negative query offset: the first rows see
    no key.  The kernels must give the plain version's answer (the JAX
    reference's: scores masked at -1e30, so the mean of V forward, and
    ``ref.bwd``'s gradients).  Such a row has p = 1 on every key, and its
    dq (and the dk it adds to every key) sums many terms of size ~1 that
    cancel, which the bf16 rounding of ds moves by more than TOL against
    a float32 run: the kernels round ds where the plain version does, and
    are held per element and in relative L2 against the plain version in
    bf16."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    for b, sq, skv, h, hkv, d, qo in ((1, 256, 256, 16, 8, 64, -100),
                                      (2, 128, 192, 32, 4, 128, -60)):
        q, k, v, do = (rnd(b, sq, h, d), rnd(b, skv, hkv, d),
                       rnd(b, skv, hkv, d), rnd(b, sq, h, d))
        kw = dict(causal=True, q_offset=qo)
        out, lse = fa_kernel.flash_fwd(q, k, v, **kw)
        ref_out, ref_lse = fa_ref.fwd(q, k, v, **kw)
        e_fwd, ok = err_within(out, ref_out, TOL)
        e_lse = float((lse - ref_lse).abs().max())
        check(ok and e_lse <= LSE_TOL, f"flash_fwd at q_offset {qo} differs "
              f"from the plain version (lse by {e_lse})")
        check(bool((lse[:, :-qo] == -1e30).all()), "rows that see no key "
              "must have lse -1e30")
        _fold(rows_out["flash_fwd"], e_fwd, f"; and at q_offset {qo}")
        got = fa_kernel.flash_bwd(q, k, v, out, lse, do, **kw)
        want = fa_ref.bwd(q, k, v, out, lse, do, **kw)
        rels = []
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            e, ok = err_within(a, w, TOL)
            r = rel_l2(a, w)
            check(ok and r <= REL_L2_TOL, f"flash_bwd {name} at q_offset {qo}"
                  f" differs from the plain version (relative L2 {r:.3g})")
            rels.append(round(r, 5))
        print(f"[kernels] q_offset {qo}, q ({b},{sq},{h},{d}), kv ({b},{skv},"
              f"{hkv},{d}): rows 0..{-qo - 1} see no key; forward max error "
              f"{e_fwd:.3g}, lse error {e_lse:.3g}, backward relative L2 {rels}")


def moe_gemm_row(torch, dev, rnd, cpm):
    """The grouped expert GEMM at the three shapes granite-moe-1b-a400m's
    path gives it (32 experts, D 1024, F 512): a decode tick's 8 rows
    per expert (8 slots x capacity 1), a legacy prefill's 160 (a
    512-token group's capacity), a train step's 5120 (4 groups x 1280);
    the backward's two products at the train shape, on the transposed
    views the autograd Function passes.  Each beside torch.bmm on the
    same operands (a transposed view made contiguous first, outside the
    timing), with its achieved TFLOP/s and share of its bound, and the
    same bits on a second run.  The row is the train shape's forward."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ref as moe_ref

    E, D, F_ = 32, 1024, 512

    def rate(label, a, b, got):
        """Time the kernel and torch.bmm on a @ b and print both."""
        check(torch.equal(got, moe_kernel.moe_gemm(a, b)),
              f"moe_gemm {label} gave other bits on a second run")
        e, m, k = a.shape
        flops = 2 * e * m * k * b.shape[2]
        ac, bc = a.contiguous(), b.contiguous()
        row = dict(
            ms=median_ms(cpm, lambda: moe_kernel.moe_gemm(a, b)),
            library_ms=median_ms(cpm, lambda: torch.bmm(ac, bc)),
            bound=bound((a.numel() + b.numel() + got.numel()) * 2, flops))
        t, lib, (least, by) = row["ms"], row["library_ms"], row["bound"]
        print(f"[kernels] moe_gemm {label} ({e},{m},{k}) x ({e},{k},"
              f"{b.shape[2]}): kernel {t:.4f} ms = {flops / t / 1e9:.1f} "
              f"TFLOP/s ({least / t:.3f} of the bound), torch.bmm {lib:.4f} "
              f"ms = {flops / lib / 1e9:.1f} TFLOP/s ({t / lib:.2f}x), bound "
              f"{least:.4f} ms ({by})")
        return row

    errs = []
    for label, T in (("decode", 8), ("legacy prefill", 160), ("train", 5120)):
        x, w = rnd(E, T, D), rnd(E, D, F_)
        got, want = moe_kernel.moe_gemm(x, w), moe_ref.moe_gemm_ref(x, w)
        e, ok = err_within(got.float() * D ** -0.5, want.float() * D ** -0.5,
                           TOL)
        check(ok, f"moe_gemm at T {T} differs from the plain version")
        errs.append(e)
        row = rate(label, x, w, got)
        row["plain_ms"] = median_ms(cpm, lambda: moe_ref.moe_gemm_ref(x, w))
    dy = rnd(E, T, F_)
    grads = []
    for impl in (None, "ref"):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(ops.moe_gemm(xl, wl, impl=impl),
                                         (xl, wl), dy))
    for name, a, b, depth in (("dX", grads[0][0], grads[1][0], F_),
                              ("dW", grads[0][1], grads[1][1], T)):
        e, ok = err_within(a.float() * depth ** -0.5,
                           b.float() * depth ** -0.5, TOL)
        r = rel_l2(a, b)
        check(ok and r <= REL_L2_TOL, f"moe_gemm backward {name} differs from "
              f"the plain version's autograd (relative L2 {r:.3g})")
        errs.append(e)
    rate("backward dX = dY W^T", dy, w.transpose(1, 2), grads[0][0])
    rate("backward dW = X^T dY", x.transpose(1, 2), dy, grads[0][1])
    del grads
    row["max_abs_err"] = max(errs)
    row["shape"] = ("x (32,5120,1024), w (32,1024,512) bf16; held at T 8, "
                    "160, 5120 and the backward's dX, dW (errors x 1/sqrt(depth))")
    return row


def decode_attention_row(torch, dev, rnd, cpm):
    """Decode over a contiguous cache, B 8, S 1024, cache_len 700, at
    yi-6b's widths (the row) and granite's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref

    B, S, L = 8, 1024, 700
    errs = []
    for label, H, HKV, D in (("granite", 16, 8, 64), ("yi-6b", 32, 4, 128)):
        q, k, v = rnd(B, 1, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D)
        got = ops.decode_attention(q, k, v, L)
        e, ok = err_within(got, dec_ref.decode_ref(q, k, v, L), TOL)
        check(ok, f"decode_attention ({label}) differs from the plain version")
        check(torch.equal(got, ops.decode_attention(q, k, v, L)),
              f"decode_attention ({label}) gave other bits on a second run")
        errs.append(e)
        g = H // HKV
        qt = q.transpose(1, 2)
        kr = k[:, :L].repeat_interleave(g, dim=2).transpose(1, 2)
        vr = v[:, :L].repeat_interleave(g, dim=2).transpose(1, 2)
        row = dict(
            ms=median_ms(cpm, lambda: ops.decode_attention(q, k, v, L)),
            plain_ms=median_ms(cpm, lambda: dec_ref.decode_ref(q, k, v, L)),
            library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
                qt, kr, vr)),
            bound=bound(2 * B * L * HKV * D * 2 + 2 * q.numel() * 2,
                        4 * B * L * H * D))
        print(f"[kernels] decode_attention {label} q (8,1,{H},{D}), cache "
              f"(8,1024,{HKV},{D}), cache_len 700: kernel {row['ms']:.4f} ms,"
              f" plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} "
              f"ms, bound {row['bound'][0]:.5f} ms ({row['bound'][1]})")
    row["max_abs_err"] = max(errs)
    row["shape"] = ("q (8,1,32,128), cache (8,1024,4,128) bf16, cache_len "
                    "700; also held at (8,1,16,64) over 8 KV heads")
    return row


def quantize_rows(torch, dev, cpm):
    """The int8 quantize and dequantize kernels against their plain
    versions, exactly (``torch.equal``), at the largest payloads of the
    comm phase's compressed sync: quantize gets a rank's shard of
    granite's largest leaf (8 x 32 x 1024 x 512 values, halved over the
    data axis) as (262144, 256) rows; dequantize gets both pods' codes of
    it at once, (524288, 256), and is also held at (262144, 256).  Each
    input has a zero row (scale 1.0) and a row of ties at .5 (amax 127,
    scale 1.0).  No single PyTorch call computes the scales, so quantize
    has no library time; ``torch.mul`` of the int8 codes and the scales
    computes dequantize in one call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import ref as q_ref

    g = torch.Generator(device=dev).manual_seed(77)
    out, errs = {}, [0.0, 0.0]
    for rows in (262144, 524288):
        x = torch.randn((rows, 256), generator=g, device=dev) * 1e-3
        x[5] = 0.0
        x[1] = torch.rand(256, generator=g, device=dev) * 200 - 100
        x[1, :6] = torch.tensor([127.0, 2.5, 3.5, -0.5, -1.5, 0.5])
        codes, scales = ops.quantize_int8(x)
        want_c, want_s = q_ref.quantize_int8_ref(x, block=256)
        check(torch.equal(codes, want_c) and torch.equal(scales, want_s),
              f"quantize ({rows}, 256) differs from the plain version")
        check(codes[1, :6].tolist() == [127, 2, 4, 0, -2, 0]
              and float(scales[5]) == 1.0,
              "quantize rounds ties or zero rows unlike the reference")
        deq = ops.dequantize_int8(codes, scales)
        want_d = q_ref.dequantize_int8_ref(codes, scales)
        check(torch.equal(deq, want_d),
              f"dequantize ({rows}, 256) differs from the plain version")
        n = x.numel()
        err = max(float((codes.int() - want_c.int()).abs().max()),
                  float((scales - want_s).abs().max()))
        errs[0] = max(errs[0], err)
        errs[1] = max(errs[1], float((deq - want_d).abs().max()))
        if rows == 262144:
            # per value: abs, max, divide, round, clamp (2): 6 f32 operations
            out["quantize"] = dict(
                max_abs_err=0.0, tol="exact",
                ms=median_ms(cpm, lambda: ops.quantize_int8(x)),
                plain_ms=median_ms(cpm, lambda: q_ref.quantize_int8_ref(
                    x, block=256)),
                library_ms=None,
                bound=bound(4 * n + n + 4 * rows, 6 * n, F32_FLOPS_S),
                shape="x (262144, 256) f32 -> int8 codes, f32 scales; also "
                      "held at (524288, 256)")
        else:
            sc = scales[:, None]
            out["dequantize"] = dict(
                max_abs_err=0.0, tol="exact",
                ms=median_ms(cpm, lambda: ops.dequantize_int8(codes,
                                                              scales)),
                plain_ms=median_ms(cpm, lambda: q_ref.dequantize_int8_ref(
                    codes, scales)),
                library_ms=median_ms(cpm, lambda: torch.mul(codes, sc)),
                bound=bound(n + 4 * rows + 4 * n, n, F32_FLOPS_S),
                shape="codes (524288, 256) int8, scales f32 -> f32; also "
                      "held at (262144, 256)")
        del x, codes, scales, deq, want_c, want_s, want_d
    out["quantize"]["max_abs_err"] = errs[0]
    out["dequantize"]["max_abs_err"] = errs[1]
    return out


# ---------------------------------------------------------------------------
# phase 4: serve yi-6b and granite-moe-1b-a400m through the Engine
# ---------------------------------------------------------------------------


def serve_engine(cfg, params, dev, chunk):
    """The serve phase's engine: 8 slots of page-16 pools, prompts up to
    512 tokens, 1024 in all; chunked prefill when ``chunk``."""
    from repro_torch.serve import Engine, EngineConfig
    ecfg = EngineConfig(n_slots=8, page_size=16, max_prompt_len=512,
                        max_seq_len=1024, prefill_chunk=chunk)
    return Engine(cfg, ecfg, params=params, device=dev)


def serve_run(torch, dev, cfg, params, chunk, prompts, build):
    """The prompts through ``serve_engine``, 32 new tokens each, with the
    host time of each tick by kind (decode, and mixed: every running
    slot's decode and a prompt chunk).  Returns the launch counts and
    the token streams."""
    eng = serve_engine(cfg, params, dev, chunk)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    decode_ms, mixed_ms = [], []
    while True:
        n_dec, n_mix = eng.n_decode_steps, eng.n_mixed_steps
        t = time.perf_counter()
        if not eng.step():
            break
        dt = (time.perf_counter() - t) * 1e3      # each tick ends on the host
        if eng.n_decode_steps > n_dec:
            decode_ms.append(dt)
        elif eng.n_mixed_steps > n_mix:
            mixed_ms.append(dt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for r in reqs:
        check(r.finished and len(r.tokens) == 32,
              f"request {r.rid} did not finish with 32 tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} has tokens outside the vocabulary")
    ttft = sorted(r.ttft * 1e3 for r in reqs)
    decode_ms.sort()
    mixed_ms.sort()
    n_tok = sum(len(r.tokens) for r in reqs)
    mode = f"chunked({chunk})" if chunk else "legacy"
    mixed = (f"; mixed tick median {mixed_ms[len(mixed_ms) // 2]:.2f} ms over "
             f"{len(mixed_ms)} ticks" if mixed_ms else "")
    print(f"[serve] {mode}: {len(reqs)} requests, {n_tok} tokens in "
          f"{elapsed:.3f} s = {n_tok / elapsed:.1f} tok/s; TTFT median "
          f"{ttft[len(ttft) // 2]:.1f} ms (min {ttft[0]:.1f}, max "
          f"{ttft[-1]:.1f}); decode tick median "
          f"{decode_ms[len(decode_ms) // 2]:.2f} ms over {len(decode_ms)} "
          f"ticks{mixed}; stats {eng.stats()}; launches {launches}")
    return launches, [r.tokens for r in reqs]


def contiguous_phase(torch, dev, cfg, params, prompts, streams, build):
    """Each prompt alone through the contiguous path, as the JAX
    package's ``_contiguous_greedy`` runs it: ``Model.prefill``
    right-padded to 1024 positions, then 31 ``decode_step`` calls at a
    scalar index, greedy.  Each stream is held against the engine's for
    that prompt: where they part, the engine's token must be within
    STREAM_LOGIT_TOL of the contiguous path's largest logit at that step.
    Returns the launch counts of the run."""
    from repro_torch.models.model import Model

    model, cap, n_new = Model(cfg), 1024, 32
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    report = []
    for prompt, engine_stream in zip(prompts, streams):
        toks = torch.zeros((1, cap), dtype=torch.long, device=dev)
        toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
        logits, cache = model.prefill(
            params, {"tokens": toks},
            last_index=torch.tensor([len(prompt) - 1], device=dev))
        out, parted = [], None
        for i in range(n_new):
            lg = logits[0].float()
            out.append(int(torch.argmax(lg)))
            if parted is None and out[-1] != engine_stream[i]:
                parted = (i, float(lg.max() - lg[engine_stream[i]]))
            if i + 1 < n_new:
                logits, cache = model.decode_step(
                    params, cache, torch.tensor([[out[-1]]], device=dev),
                    len(prompt) + i)
        report.append((len(prompt), parted))
        if parted is not None:
            check(parted[1] <= STREAM_LOGIT_TOL,
                  f"contiguous and engine streams part at step {parted[0]} "
                  f"with the engine's token {parted[1]:.4f} below the max")
        check(all(0 <= t < cfg.vocab_size for t in out),
              "contiguous stream has tokens outside the vocabulary")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"[serve] contiguous path, {len(prompts)} prompts alone (prefill "
          f"right-padded to {cap}, then {n_new - 1} decode steps each) in "
          f"{time.perf_counter() - t0:.2f} s; (prompt length, first step "
          f"where the stream parts from the engine's and the engine token's "
          f"logit gap, or None) {report}; launches {launches}")
    want = cfg.n_layers * (n_new - 1) * len(prompts)
    check(launches["decode_attention"] == want,
          f"the contiguous path launched decode_attention "
          f"{launches['decode_attention']} times, expected {want}")
    return launches


def teacher_force(torch, dev, cfg, params):
    """One prompt, then 4 forced decode steps, through the kernels in bf16,
    the plain versions in bf16 and the plain versions in float32."""
    import numpy as np
    from repro_torch.models.layers import PagedView
    from repro_torch.models.model import Model
    from repro_torch.serve import paging

    rng = np.random.default_rng(7)
    plen, chunk = 200, 256
    toks = rng.integers(0, cfg.vocab_size, plen + 4)
    layout = paging.PagedLayout(page_size=16, pages_per_slot=64, n_pages=65)
    bt = torch.arange(1, 65, dtype=torch.int32, device=dev)[None]
    i32 = dict(dtype=torch.int32, device=dev)
    got = {}
    for name, impl, dtype in (("kernels", None, torch.bfloat16),
                              ("plain", "ref", torch.bfloat16),
                              ("plain_f32", "ref", torch.float32)):
        model = Model(cfg, impl=impl)
        pool = paging.init_pool(cfg, 1, layout, dev)
        prompt = torch.tensor(toks[None, :plen], device=dev)
        lg, _ = model.prefill(params, {"tokens": prompt},
                              compute_dtype=dtype)           # flash_fwd
        logits = [lg]
        c = torch.zeros((1, chunk), dtype=torch.long, device=dev)
        c[0, :plen] = prompt[0]
        lc, _ = model.prefill_chunk(params, pool, c, PagedView(
            bt, torch.tensor([0], **i32), n_valid=torch.tensor([plen], **i32),
            null_page=0), compute_dtype=dtype)                # paged_prefill
        logits.append(lc[:, plen - 1])
        for i in range(4):                                    # paged_decode
            pos = torch.tensor([plen + i], **i32)
            ld, _ = model.decode_step(
                params, pool, torch.tensor([[toks[plen + i]]], device=dev),
                pos, compute_dtype=dtype, paging=PagedView(bt, pos))
            logits.append(ld)
        got[name] = torch.cat(logits).float()

    def rel(a, b):
        return [round(float(x), 5) for x in
                (got[a] - got[b]).norm(dim=-1) / got[b].norm(dim=-1)]

    k_p, k_f, p_f = (rel("kernels", "plain"), rel("kernels", "plain_f32"),
                     rel("plain", "plain_f32"))
    print(f"[serve] teacher-forced logits (prefill, chunk, 4 decode steps), "
          f"relative L2 error per step: kernels vs plain {k_p}; kernels vs "
          f"f32 {k_f}; plain vs f32 {p_f}; logit scale "
          f"{float(got['plain_f32'].abs().max()):.3g}")
    check(max(k_f) <= LOGIT_NOISE_FACTOR * max(p_f),
          f"kernel path drifts from f32 by {max(k_f)}, plain bf16 by "
          f"{max(p_f)}")


# ---------------------------------------------------------------------------
# phase 5: train yi-6b through the port's Trainer
# ---------------------------------------------------------------------------


def _rel_by_group(params, a, b):
    """Relative L2 error of gradient tree ``a`` against ``b``, per leaf
    group: embedding, head, final norm, each block module, and a MoE
    FFN's router apart from its experts."""
    from repro_torch.models import params as P
    num, den = {}, {}

    def walk(tree, x, y, path):
        if isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key], x[key], y[key], path + (key,))
            return
        # ("embed", "tok") or ("blocks", "p0", "attn", "wq") -> blocks/attn;
        # ("blocks", "p0", "moe", "w_in") -> blocks/moe/experts
        group = "/".join(path[:2] if path[0] == "embed"
                         else (path[0], path[2]))
        if path[2:3] == ("moe",):
            group += "/router" if path[3] == "router" else "/experts"
        num[group] = num.get(group, 0.0) + float((x - y).float().norm()) ** 2
        den[group] = den.get(group, 0.0) + float(y.float().norm()) ** 2

    walk(params, P.tree_unflatten(params, a), P.tree_unflatten(params, b), ())
    return {g: round((num[g] / den[g]) ** 0.5, 5) for g in sorted(num)}


def grad_check(torch, dev, arch):
    """``arch`` at full width and 2 layers, one 2 x 4096 batch: gradients
    through the kernels (bf16), the plain versions (bf16) and the plain
    versions (float32).  The kernel path must be as close to float32 as
    the plain bf16 path is, within LOGIT_NOISE_FACTOR, in every group."""
    import dataclasses

    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.data import synthetic_batch
    from repro_torch.dist.steps import init_train_state
    from repro_torch.models import params as P
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(registry.get(arch), n_layers=2)
    params = init_train_state(cfg, TrainConfig(), device=dev)["params"]
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in
             synthetic_batch(cfg, WorkloadShape("chip", "train", 4096, 2)
                             ).items()}
    leaves = P.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    got, losses = {}, {}
    for name, impl, dtype in (("plain_f32", "ref", torch.float32),
                              ("plain", "ref", torch.bfloat16),
                              ("kernels", None, torch.bfloat16)):
        t = time.perf_counter()
        loss, _ = Model(cfg, impl=impl).loss(params, batch, remat=True,
                                             compute_dtype=dtype)
        got[name] = torch.autograd.grad(loss, leaves)
        losses[name] = round(float(loss.detach()), 5)
        torch.cuda.synchronize()
        print(f"[train] grad check: {name} loss {losses[name]} in "
              f"{time.perf_counter() - t:.2f} s")
    k_f = _rel_by_group(params, got["kernels"], got["plain_f32"])
    p_f = _rel_by_group(params, got["plain"], got["plain_f32"])
    print(f"[train] grad check ({cfg.name} at 2 layers, batch 2 x 4096), "
          f"relative L2 error per group: kernels vs f32 {k_f}; plain bf16 "
          f"vs f32 {p_f}")
    for group in k_f:
        check(k_f[group] <= LOGIT_NOISE_FACTOR * p_f[group],
              f"kernel-path gradients of {group} drift from f32 by "
              f"{k_f[group]}, plain bf16 by {p_f[group]}")
    del got, params
    torch.cuda.empty_cache()


def step_table(prof, step_s, tag="train"):
    """Device time of one traced train step by kernel, and the share of
    the step's host-clock time in which the card ran none (one stream,
    so kernels do not overlap).  Only device rows count: an operator row
    (``aten::mm``, the ``FlashAttention`` Function) repeats the time of
    the kernels it launched, a user annotation on the device (gloo's
    ``gloo:all_gather`` around its copies) the time of what it spans,
    and CUPTI's "Command Buffer Full" records a full launch queue, not
    device work."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.key != "Command Buffer Full"),
                  key=dev_us, reverse=True)
    busy = max(sum(dev_us(e) for e in rows) / 1e6, 1e-9)
    print(f"[{tag}] traced step: {step_s * 1e3:.1f} ms on the host clock "
          f"(under the profiler), card busy {busy * 1e3:.1f} ms, idle "
          f"share {max(0.0, 1 - busy / step_s):.3f}; device time by "
          f"kernel:")
    # the top 12, and the port's own kernels below them
    for e in rows[:12] + [e for e in rows[12:] if "repro::" in e.key]:
        print(f"[{tag}]   {dev_us(e) / 1e3:10.2f} ms "
              f"{100 * dev_us(e) / 1e6 / busy:5.1f}%  {e.count:6d} calls  "
              f"{e.key[:70]}")


def _check_history(history):
    import math
    for h in history:
        print(f"[train] step {h['step']}: loss {h['loss']:.5f} (xent "
              f"{h['xent']:.5f}, moe_aux {h['moe_aux']:.5f}) grad_norm "
              f"{h['grad_norm']:.5f} step {h['step_time_s'] * 1e3:.1f} ms")
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"step {h['step']} is not finite")


def train_granite(torch, dev, build):
    """granite-moe-1b-a400m at full width and all 24 layers, 4 steps of
    4 x 4096 tokens through the Trainer (the ``train_4k`` shape with its
    batch of 256 cut to one card), the last one traced.  Returns the
    launch counts of the run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.models.model import Model
    from repro_torch.train import Trainer

    cfg = registry.get("granite-moe-1b-a400m")
    tcfg = TrainConfig()
    shape = WorkloadShape("chip", "train", 4096, 4)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tcfg, shape, seed=0, device=dev)
    t = time.perf_counter()
    tr.init_or_resume()
    torch.cuda.synchronize()
    m = Model(cfg)
    print(f"[train] {cfg.name}, all {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}: {m.n_params() / 1e9:.3f} B params "
          f"({m.n_active_params() / 1e9:.3f} B active per token), float32 "
          f"with AdamW state, drawn in {time.perf_counter() - t:.1f} s; "
          f"batch {shape.global_batch} x {shape.seq_len}, {tcfg}")
    build.reset_launches()
    t = time.perf_counter()
    tr.run(3, log_every=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(1, log_every=0)                   # step 3, traced
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_history(tr.history)
    print(f"[train] 4 steps in {time.perf_counter() - t:.1f} s; peak device "
          f"memory {peak:.2f} GB; launches {launches}")
    step_table(prof, tr.history[-1]["step_time_s"])
    L, steps = cfg.n_layers, 4
    # per layer and step: 3 expert products forward, 3 again under remat,
    # 2 per product backward
    want = {"moe_gemm": 12 * L * steps, "flash_fwd": 2 * L * steps,
            "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
            "rmsnorm": (2 * 2 * L + 1) * steps}
    for name, n in want.items():
        check(launches[name] == n, f"granite train launched {name} "
              f"{launches[name]} times, expected {n}")
    del tr, prof
    torch.cuda.empty_cache()
    return launches


def train_phase(torch, dev, build):
    """yi-6b at full width and 8 of 32 layers, 4 steps of 2 x 4096 tokens
    through the Trainer, a checkpoint at step 2, then a fresh Trainer
    restored from it and stepped on to 4.  Returns the launch counts of
    the uninterrupted run."""
    import dataclasses
    import gc
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig, WorkloadShape, yi_6b
    from repro_torch.models.model import Model
    from repro_torch.train import Trainer

    cfg = dataclasses.replace(yi_6b.CONFIG, n_layers=8)
    tcfg = TrainConfig()
    shape = WorkloadShape("chip", "train", 4096, 2)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tcfg, shape, ckpt_dir=str(ckpt_dir), seed=0,
                 device=dev)
    t = time.perf_counter()
    tr.init_or_resume()
    torch.cuda.synchronize()
    print(f"[train] {cfg.name} at {cfg.n_layers} of 32 layers, d_model "
          f"{cfg.d_model}: {Model(cfg).n_params() / 1e9:.3f} B params, "
          f"float32 with AdamW state, drawn in {time.perf_counter() - t:.1f} "
          f"s; batch {shape.global_batch} x {shape.seq_len}, {tcfg}")
    build.reset_launches()
    t = time.perf_counter()
    tr.run(2, ckpt_every=2, log_every=0)
    t_save = time.perf_counter()
    tr.run(1, log_every=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(1, log_every=0)                   # step 3, traced
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_history(tr.history)
    save_s = t_save - t - sum(h["step_time_s"] for h in tr.history[:2])
    print(f"[train] 4 steps and one checkpoint in {time.perf_counter() - t:.1f}"
          f" s (the save at step 2, {save_s:.1f} s of it, host copy and npz "
          f"write); peak device memory {peak:.2f} GB; launches {launches}")
    step_table(prof, tr.history[-1]["step_time_s"])
    L, steps = cfg.n_layers, 4
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps, "rmsnorm": (2 * 2 * L + 1) * steps}
    for name, n in want.items():
        check(launches[name] == n, f"train launched {name} {launches[name]} "
              f"times, expected {n} (each forward runs twice under remat)")

    ref = tr.history
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    tr2 = Trainer(cfg, tcfg, shape, ckpt_dir=str(ckpt_dir), seed=0,
                  device=dev)
    check(tr2.init_or_resume() == "resumed" and tr2.start_step == 2,
          "the fresh Trainer did not resume at step 2")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t
    resumed = tr2.run(2, log_every=0)
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(resumed, ref[2:])]
    print(f"[train] resumed from step 2 in {t_restore:.1f} s: losses "
          f"{[round(h['loss'], 5) for h in resumed]} against "
          f"{[round(h['loss'], 5) for h in ref[2:]]}, relative {rel}")
    check(len(rel) == 2 and max(rel) <= RESUME_RTOL,
          f"resumed losses differ by {rel}")
    del tr2
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: data-parallel training with hierarchical int8 gradient sync
# ---------------------------------------------------------------------------


def _comm_setup():
    """granite-moe-1b-a400m at COMM_LAYERS layers, train_4k (seq 4096) at
    a global batch of 4, and the two strategies of the comm phase."""
    import dataclasses

    from repro_torch.configs import (SHAPES, ShardingStrategy, WorkloadShape,
                                     registry)

    cfg = dataclasses.replace(registry.get("granite-moe-1b-a400m"),
                              n_layers=COMM_LAYERS)
    shape = WorkloadShape("train_4k", "train", SHAPES["train_4k"].seq_len, 4)
    strategies = {
        "hier": ShardingStrategy(name="hier", hierarchical_collectives=True,
                                 comm_strict=True),
        "hier-int8": ShardingStrategy(
            name="hier-int8", hierarchical_collectives=True,
            compress_cross_pod=True, compress_pods=2, compress_block=256,
            comm_strict=True)}
    return cfg, shape, strategies


def _function_sync(torch, dist, mesh, strategy, dev):
    """One random stacked gradient of the largest leaf's shape, (1, 8, 32,
    1024, 512) float32 on each rank (its own seed), through ``sync_grads``
    under ``strategy`` with a zero residual: the largest error against the
    exact mean and its bound (2 max|exact| / 127, the JAX test's), and the
    residual identity's largest violation beyond rtol 1e-4, atol 1e-6:
    the pods' new residuals sum to what they sent (their pod-mean
    payloads) less what crossed (2 x the synced mean)."""
    from repro_torch import comm
    from repro_torch.models.params import PDef

    shape = (1, 8, 32, 1024, 512)

    def chunk(r):
        g = torch.Generator(device=dev).manual_seed(1000 + r)
        return torch.randn(shape, generator=g, device=dev)

    defs = {"w_in": PDef(shape[1:], (None, "expert", "embed", "ff"))}
    policy = comm.resolve_policy(strategy, mesh)
    synced, ef = comm.sync_grads(
        {"w_in": chunk(mesh.rank)}, defs, mesh, policy, strategy,
        residual={"w_in": torch.zeros(shape, device=dev)})
    synced, ef = synced["w_in"], ef["w_in"][0]
    exact = sum(chunk(r)[0] for r in range(mesh.size)) / mesh.size
    err = float((synced - exact).abs().max())
    lim = 2 * float(exact.abs().max()) / 127
    del exact
    rows = torch.empty((2,) + ef.shape)
    dist.all_gather_into_tensor(rows, ef.cpu()[None], group=mesh.group("pod"))
    # each pod's payload as the sync forms it: its two chunks x 2/4, summed
    sent = [chunk(2 * p)[0] * 0.5 + chunk(2 * p + 1)[0] * 0.5
            for p in range(2)]
    lhs = rows[0].to(dev) + rows[1].to(dev)
    rhs = (sent[0] + sent[1]) - 2 * synced
    excess = float(((lhs - rhs).abs() - (1e-6 + 1e-4 * rhs.abs())).max())
    return err, lim, excess


def comm_rank(rank, init_file, queue):
    """One of the comm phase's four ranks: its own process, on card 0,
    in a gloo process group of four as rank ``rank`` of a (pod=2, data=2)
    mesh.  Trains under each strategy, then syncs one large gradient, and
    puts what it measured on ``queue``.  Any failure raises: the process
    exits non-zero and the parent fails."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import comm
    from repro_torch.comm import collectives
    from repro_torch.configs import TrainConfig
    from repro_torch.dist import mesh as dmesh
    from repro_torch.kernels import build
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.train import Trainer

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    timeout = timedelta(seconds=COMM_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4, timeout=timeout)
    mesh = dmesh.make_mesh((2, 2), ("pod", "data"), timeout=timeout)
    cfg, shape, strategies = _comm_setup()
    out = {"rank": rank, "coords": mesh.coords, "runs": {},
           "n_leaves": len(P.tree_leaves(Model(cfg).param_defs()))}
    launches = {k: 0 for k in build.LAUNCHES}
    for name, strategy in strategies.items():
        build.reset_launches()
        collectives.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, TrainConfig(), shape, mesh=mesh, strategy=strategy,
                     seed=0, device=dev)
        tr.init_or_resume()
        sync_s, per_step, ef_max = [], [], []
        real = comm.sync_grads

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = real(*a, **kw)
            torch.cuda.synchronize()
            sync_s.append(time.perf_counter() - t)
            return res

        comm.sync_grads = timed
        try:
            for i in range(COMM_STEPS):
                before = dict(build.LAUNCHES)
                if rank == 0 and name == "hier-int8" and i == COMM_STEPS - 1:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        tr.run(1, log_every=0)
                    torch.cuda.synchronize()
                    print(f"[comm] rank 0, {name}, step {i} traced:",
                          flush=True)
                    step_table(prof, tr.history[-1]["step_time_s"], "comm")
                    sys.stdout.flush()
                    del prof
                else:
                    tr.run(1, log_every=0)
                per_step.append({k: build.LAUNCHES[k] - before[k]
                                 for k in ("quantize", "dequantize")})
                if "comm" in tr.state:
                    ef_max.append(max(float(x.abs().max()) for x in
                                      P.tree_leaves(tr.state["comm"])))
        finally:
            comm.sync_grads = real
        torch.cuda.synchronize()
        for k, v in build.LAUNCHES.items():
            launches[k] += v
        out["runs"][name] = {
            "history": tr.history, "sync_s": sync_s, "per_step": per_step,
            "ef_max": ef_max, "launches": dict(build.LAUNCHES),
            "pod_bytes": collectives.PAYLOAD_BYTES.get("pod", 0) // COMM_STEPS,
            "data_bytes": (collectives.PAYLOAD_BYTES.get("data", 0)
                           // COMM_STEPS),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del tr
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["sync_check"] = _function_sync(torch, dist, mesh,
                                       strategies["hier-int8"], dev)
    dist.destroy_process_group()
    queue.put(out)


def comm_phase(torch, dev, build, smi):
    """granite-moe-1b-a400m at full width and COMM_LAYERS of its 24
    layers, 4 steps of 4 x 4096 tokens (``TrainConfig()``, seed 0):
    first on this process's device with grad_accum=4 (one row per
    microbatch, the chunks the ranks take), then on four ranks of one
    card over gloo as a (pod=2, data=2) mesh, each rank one row, under
    ``hier`` and ``hier-int8`` (both ``comm_strict``).  Returns the launch
    counts of these runs (the ranks' summed)."""
    import gc
    import queue as queue_mod

    import torch.multiprocessing as tmp

    from repro_torch.configs import TrainConfig
    from repro_torch.train import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    cfg, shape, strategies = _comm_setup()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ref = Trainer(cfg, TrainConfig(grad_accum=4), shape, seed=0, device=dev)
    t = time.perf_counter()
    ref.run(COMM_STEPS, log_every=0)
    ref_hist = ref.history
    ref_launches = dict(build.LAUNCHES)
    print(f"[comm] {cfg.name} at {cfg.n_layers} of 24 layers, batch "
          f"{shape.global_batch} x {shape.seq_len}, one device, grad_accum 4: "
          f"{time.perf_counter() - t:.1f} s for {COMM_STEPS} steps, losses "
          f"{[round(h['loss'], 5) for h in ref_hist]}, steps "
          f"{[round(h['step_time_s'] * 1e3, 1) for h in ref_hist]} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    init_file = ROOT / "build" / f"comm_pg_{os.getpid()}"
    init_file.unlink(missing_ok=True)
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=comm_rank, args=(r, str(init_file), q))
             for r in range(4)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < len(procs):
            try:
                r = q.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                check(not dead, f"a comm rank failed (exit codes {dead})")
                check(time.perf_counter() - t < COMM_DEADLINE_S,
                      f"the comm ranks did not finish in {COMM_DEADLINE_S} s")
                continue
            results[r["rank"]] = r
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        init_file.unlink(missing_ok=True)
    check(all(p.exitcode == 0 for p in procs),
          f"comm ranks exited with {[p.exitcode for p in procs]}")
    res = [results[r] for r in range(4)]
    print(f"[comm] 4 ranks on one card, gloo (CUDA payloads through host "
          f"memory), (pod=2, data=2), each rank one row of each step, in "
          f"{time.perf_counter() - t:.1f} s")

    def losses(r, name):
        return [h["loss"] for h in r["runs"][name]["history"]]

    hier, int8 = losses(res[0], "hier"), losses(res[0], "hier-int8")
    for r in res:
        check(losses(r, "hier") == hier and losses(r, "hier-int8") == int8,
              f"rank {r['rank']} has other losses than rank 0")
    want = [h["loss"] for h in ref_hist]
    gaps = [abs(a - b) / abs(b) for a, b in zip(hier, want)]
    print(f"[comm] hier losses {[round(x, 5) for x in hier]} against one "
          f"device's {[round(x, 5) for x in want]}: largest relative gap "
          f"{max(gaps):.3g} (tol {COMM_RTOL})")
    check(max(gaps) <= COMM_RTOL, f"hier losses differ from one device's "
          f"grad_accum=4 run by {gaps}")
    check(int8[0] == hier[0], f"hier-int8's step-0 loss {int8[0]} is not "
          f"hier's {hier[0]}")
    cgaps = [abs(a - b) / abs(b) for a, b in zip(int8[1:], hier[1:])]
    print(f"[comm] hier-int8 losses {[round(x, 5) for x in int8]}: step 0 "
          f"equal to hier's; steps 1-3 relative gaps to hier "
          f"{[round(x, 6) for x in cgaps]} (bound {COMPRESS_RTOL})")
    check(max(cgaps) <= COMPRESS_RTOL, f"hier-int8 drifts from hier by "
          f"{cgaps}")
    n_leaves = res[0]["n_leaves"]
    for r in res:
        runs = r["runs"]
        check(runs["hier-int8"]["ef_max"][0] > 0, f"rank {r['rank']}: the "
              f"residual is zero after step 0")
        check(all(s == {"quantize": n_leaves, "dequantize": n_leaves}
                  for s in runs["hier-int8"]["per_step"]),
              f"rank {r['rank']}: compressed steps launched "
              f"{runs['hier-int8']['per_step']}, expected {n_leaves} of each")
        check(all(s == {"quantize": 0, "dequantize": 0}
                  for s in runs["hier"]["per_step"]),
              f"rank {r['rank']}: hier launched the quantize kernels")
        err, lim, excess = r["sync_check"]
        check(err < lim, f"rank {r['rank']}: compressed sync error {err} "
              f"over its bound {lim}")
        check(excess <= 0, f"rank {r['rank']}: residual identity off by "
              f"{excess} beyond rtol 1e-4, atol 1e-6")
        for name, run in runs.items():
            h = run["history"]
            print(f"[comm] rank {r['rank']} {r['coords']} {name}: steps "
                  f"{[round(x['step_time_s'] * 1e3, 1) for x in h]} ms, sync "
                  f"(host) {[round(s * 1e3, 1) for s in run['sync_s']]} ms; "
                  f"per step {run['pod_bytes']} B to the pod group, "
                  f"{run['data_bytes']} B to the data group; peak "
                  f"{run['peak_gb']:.2f} GB ({smi})")
        print(f"[comm] rank {r['rank']}: sync of a (1, 8, 32, 1024, 512) "
              f"float32 gradient under hier-int8: largest error {err:.4g} "
              f"(bound {lim:.4g}); residual identity within tolerance")
    print(f"[comm] {n_leaves} leaves: {n_leaves} quantize and {n_leaves} "
          f"dequantize launches per compressed step on every rank, none "
          f"under hier; residual max after step 0 "
          f"{res[0]['runs']['hier-int8']['ef_max'][0]:.4g}")
    total = {k: sum(r["launches"][k] for r in res) for k in build.LAUNCHES}
    return [ref_launches, total]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    lib = build.build()
    build.lib()
    print(f"[build] {lib.name} in {time.perf_counter() - t:.1f} s")
    for part in lib.with_suffix(".log").read_text().split("== ")[1:]:
        source, _, log = part.partition("\n")
        for line in build.ptxas_report(log):
            print(f"[build]   {source}: {line}")

    rows = kernel_phase(torch, dev)
    import numpy as np
    runs = []                       # launch counts of every main-path run

    def serve_phase(arch):
        """Both engine modes on ``arch`` at full size, then teacher-forced
        logits; returns (params, prompts, legacy streams)."""
        cfg = registry.get(arch)
        t = time.perf_counter()
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {Model(cfg).n_params() / 1e9:.2f} B params in "
              f"bf16, drawn in {time.perf_counter() - t:.1f} s")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(64, 513, 12)]
        legacy, streams = serve_run(torch, dev, cfg, params, 0, prompts, build)
        chunked, _ = serve_run(torch, dev, cfg, params, 256, prompts, build)
        moe = ("moe_gemm",) if cfg.moe is not None else ()
        for name in ("rmsnorm", "flash_fwd", "paged_decode") + moe:
            check(legacy[name] > 0, f"legacy serve never launched {name}")
        for name in ("rmsnorm", "paged_prefill", "paged_decode") + moe:
            check(chunked[name] > 0, f"chunked serve never launched {name}")
        runs.extend([legacy, chunked])
        teacher_force(torch, dev, cfg, params)
        return cfg, params, prompts, streams

    cfg, params, prompts, streams = serve_phase("yi-6b")
    tie = torch.zeros((2, 64000), dtype=torch.bfloat16, device=dev)
    tie[:, 5] = tie[:, 70] = 1.0
    check(torch.argmax(tie, dim=-1).tolist() == [5, 5],
          "argmax over bf16 logits must return the first maximal index")
    runs.append(contiguous_phase(torch, dev, cfg, params, prompts[:4],
                                 streams[:4], build))
    del params
    torch.cuda.empty_cache()
    params = serve_phase("granite-moe-1b-a400m")[1]
    del params
    torch.cuda.empty_cache()

    grad_check(torch, dev, "yi-6b")
    grad_check(torch, dev, "granite-moe-1b-a400m")
    runs.append(train_phase(torch, dev, build))
    runs.append(train_granite(torch, dev, build))
    runs.extend(comm_phase(torch, dev, build, smi))

    kernels = []
    for name, r in rows.items():
        launches = sum(run[name] for run in runs)
        check(launches > 0, f"no main-path run launched {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
