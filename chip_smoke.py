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
             paged prefill (tools/attention_bits.py); then, from a
             generator of their own, paged decode and prefill at
             chatglm3-6b's heads (32 over 2 KV heads, g = 16) and
             qwen2-72b's (64 over 8), flash_fwd at chatglm3-6b's prompt,
             rmsnorm at d 8192 (and an empty kernel, the launch floor,
             timed beside its row), and rmsnorm timed again late in the call
             beside F.rms_norm; the seqmix phase's shapes: rmsnorm at d
             2048, flash_fwd at a 77-token prompt and moe_gemm at
             jamba-v0.1-52b's widths (16 experts, 4096 <-> 14336), each
             beside its library call; the seqmix_train phase's: flash_fwd
             and flash_bwd at jamba's (2, 4096, 32 over 8 heads, 128) and
             moe_gemm forward, dX and dW at its training capacity (T
             1280); then, each from a generator of its own,
             the attention kernels at lammps-proxy's head dim 32 (8 heads
             over 8 KV heads), the SMOKE configs' 16 (4 over 2),
             qwen2-72b SMOKE's 8 (8 over 2) and pixtral-12b's 160 (32
             over 8): flash_fwd and flash_bwd at (2, 2048) (pixtral's at
             (2, 4096), each head dim 160 kernel a row of its own in the
             kernels line with its plain version's time), paged decode
             and decode over a contiguous cache at 8 slots, paged prefill
             at a 256-row chunk, each beside SDPA and its bound; and
             flash attention at whisper-base's non-causal shapes: the
             encoder's (8, 1500, 8 heads of 64), a decode step's
             cross-attention (one query row over the 1500 frames) and the
             training cross-attention (2 x 4096 over 2048 frames, with
             flash_bwd); and the tp phase's local shapes (flash_fwd and
             flash_bwd at yi-6b's heads on model 2 and granite's, rmsnorm
             at (4096, 4096), moe_gemm over granite's 8 local experts; the
             serve_tp part's paged decode at 4 slots of 16 over 2 heads
             and paged prefill at a 256-row chunk of 16 over 2 heads),
             each a row of its own in the kernels line; flash_bwd on
             rows that see no key is held against a float32 run of its
             plain version within a bound derived from bf16's rounding;
4. serve   - yi-6b at full width and depth (random weights from a seeded
             generator) through the port's Engine, legacy prefill and
             chunked prefill, with the kernels' launch counts read around
             each run; every engine captures its ticks and prefills as
             CUDA graphs (its prefill cache and capture ms printed), and
             yi-6b's and granite's runs go again eagerly
             (cuda_graphs=False): the same streams token for token and
             the same launch counts; one prompt and 4 decode steps teacher-forced
             through the kernel path and the plain path; then 4 of the
             prompts alone through the contiguous path (Model.prefill
             right-padded to 1024, then decode steps at a scalar index)
             against the legacy engine's streams; then granite-moe-1b-
             a400m at full width and depth through the Engine in both
             modes, and teacher-forced; then chatglm3-6b (QKV bias drawn
             from its own generator, half the head dim rotated, g = 16)
             at full width and depth the same way, its legacy run again
             parked after 5 decode ticks and adopted by a fresh engine
             (token for token the uninterrupted run), and a chunked run
             over two pool shards (token for token the one-shard chunked
             run); where a chunked stream (yi-6b's, the sharded one)
             parts from the legacy stream, the legacy run's own logits
             there pick the legacy token and the chunked token's gap is
             printed; then
             qwen2-72b (QKV bias, d_model 8192) at full width and 16 of
             its 80 layers, both modes, teacher-forced;
   launch  - the launchers at the JAX launchers' flags:
             ``repro_torch.launch.serve --spec
             examples/specs/serve_fleet.json`` (yi-6b at full width and
             depth, two captured replicas behind the Router, its prefix
             cache on; each stream held by logit against one eager
             Engine of the same seed), ``--arch yi-6b --prompt-len 256
             --gen 32 --batch 8 --prefill-chunk 256`` with ``--replicas
             1`` then ``2`` (tok/s, TTFT median, peak memory), and
             ``launch.train --spec`` of granite-moe-1b-a400m at full size
             (strategy optimized, 3 steps of 4 x 4096; first loss against
             a direct Trainer's, the CommFallbackWarning printed);
   seqmix  - the sequence mixers: xlstm-1.3b at full size and
             jamba-v0.1-52b at full width and 16 of its 32 layers through
             the serve cell's engine (exact-length prefill; every plain
             version refused): legacy, prefill_chunk=256 (no chunked tick
             on these arches: the same streams) and the legacy run parked
             and adopted (token for token); the legacy run again
             eagerly (the same streams and launches; peak memory with
             and without graphs); one prompt length prefilled three
             times (a miss runs eagerly, the first hit captures and
             replays, the second replays); prefill
             ms by prompt length, pool bytes and peak memory; teacher-forced logits through the
             kernels, plain bf16 and (xlstm, and a 2-layer jamba) plain
             float32;
5. train   - the gradients of yi-6b, granite-moe-1b-a400m and chatglm3-6b
             at full width and 2 layers on one 2 x 4096 batch through the
             kernel path, the plain path in bf16 and the plain path in
             float32;
             yi-6b at full width and 2 of its 32 layers trained 4 steps
             through the port's Trainer (AdamW, float32 master weights,
             bf16 compute, remat) with the launch counts read around the
             run and a checkpoint saved at step 2, restored into a fresh
             Trainer and stepped on to 4; then granite-moe-1b-a400m at
             full width and all 24 layers trained 4 steps, batch 4 x 4096;
   seqmix_train - the sequence mixers trained: gradient checks (as
             above) of a 2-layer ("attn", "mamba") jamba-v0.1-52b and a
             2-layer ("mlstm", "slstm") xlstm-1.3b (2 x 256); then
             jamba-v0.1-52b
             at full width and those 2 layers and xlstm-1.3b at full
             width and 8 of its 48 layers (one 7 mLSTM : 1 sLSTM
             super-block; rows of 256 tokens, for time) trained as
             yi-6b is (every plain version
             refused), each traced step's shares of the Mamba scan's
             forward and backward, flash_bwd, moe_gemm and the optimizer;
   encdec  - whisper-base at full size: 8 rows of 1500 frames and
             prompts of 4-64 tokens through Model.prefill and 128 greedy
             contiguous decode steps a row (prefill time, the encoder's
             share, the tick, tokens/s; every plain version refused),
             teacher-forced against the plain path, then train_4k at
             batch 2 (2048 frames a row) trained 4 steps with a
             checkpoint resume;
   pixtral - pixtral-12b (head dim 160) served at full size in both
             modes and teacher-forced, prefilled with 64 patches and
             decoded on the contiguous path, then trained at full width
             and 4 of its 40 layers, 3 steps of 2 x 4096;
6. comm    - granite-moe-1b-a400m at full width and 4 of its 24 layers,
             4 steps of 4 x 4096 tokens: on one device with grad_accum=4,
             then on four ranks of the one card (spawned processes, gloo,
             a (pod=2, data=2) mesh, one row each) under hierarchical
             sync and under int8 error-feedback sync (both comm_strict):
             losses against the one-device run, the quantize kernels'
             launches per step, a traced compressed step on rank 0, and
             one sync of a gradient of the largest leaf's shape against
             its exact mean;
   tp      - tensor, expert and FSDP parallelism on four ranks of the
             one card (spawned processes, gloo): yi-6b at full width and
             2 of its 32 layers, 3 steps of 2 x 4096 on (data 2, model
             2) under baseline (tensor parallelism, ZeRO-1) and
             optimized (and FSDP), and granite-moe-1b-a400m at full
             width and 8 of its 24 layers (GRANITE_TP_LAYERS: the
             script's time limit), 3 steps of 4 x 4096 on (pod 2, data
             1, model 2) with expert
             parallelism, hierarchical MoE dispatch and int8
             hierarchical sync; losses against one rank's run of the
             same draw and batch (TP_RTOL) and their grad_norm at every
             step (TP_GRAD_RTOL), each rank's state bytes
             against its resolved shards (exactly), granite's exchange
             bytes in one forward against the count the CPU tests pin,
             every kernel's launches at the local shapes, step times,
             payload bytes by axis and peak memory; yi's sharded
             checkpoint restored on one rank and stepped once; then the
             same four ranks serve (``serve_tp``) on (data 2, model 2),
             the pools split by KV head and data shard (dp_shards 2):
             yi-6b at full size (8 requests of 64-512 tokens) and
             granite-moe-1b-a400m at full size with expert parallelism
             (4 requests), 32 greedy tokens each, legacy then chunked
             (256), eager ticks; every rank's streams equal, held to the
             one-rank eager engine of the same seed (where a stream
             parts, its token within STREAM_LOGIT_TOL of the one-rank
             max), tick times, TTFT, tok/s, peak memory and payload bytes
             a tick by axis printed, every kernel of the path launched;
             then (``seqmix_tp``) the same ranks serve jamba-v0.1-52b at
             full width and 8 of its 32 layers (8 requests) and
             xlstm-1.3b at full width and 8 of its 48 (4 requests) on
             (data 2, model 2) by the same rule (the Mamba channels and
             mLSTM heads over ``model``, the in-projection's u/z halves
             exchanged, the sLSTM's recurrence whole on every rank), time
             that exchange alone, and train the seqmix_train phase's
             2-layer cuts on (data 1, model 4) (jamba 2 x 4096, xlstm 1 x
             256, 2 steps) against one rank's losses and grad_norm;
   operator_ranks - the operator on meshes of ranks: one RankPool of
             four ranks of the card, whose slots FluxMiniCluster
             allocations map onto: yi-6b at full width and 4 of its 32
             layers elastic-served through a grow from (1, 2) to (2, 2)
             mid-decode and a shrink back, each run token for token the
             uninterrupted run on its starting mesh, and served chunked
             on (2, 2) by the ServeExecutor (held to the one-rank eager
             engine by the tp phase's parting rule); lammps-proxy (head
             dim 32) trained by the SubmeshExecutor on (2, 2) and by the
             ElasticTrainExecutor 2 -> 4 -> 2 hosts through the
             checkpoint, against one rank's losses; each placement's
             mesh, slots and ``ran`` record, each resize's seconds, rank
             0's ticks, TTFT and tok/s, each rank's peak memory;
7. operator - the Flux-operator control plane over the port: a
             FluxMiniCluster on a simulated ResourceGraph reaches Ready,
             and WorkloadSpecs are applied with the full configs (every
             plain version refused throughout): yi-6b served at full size
             in both modes and lammps-proxy chunked (streams against a
             direct Engine), yi-6b as two replicas over one parameter set
             behind the Router (its prefix cache on and off), yi-6b
             elastic through a grow and a shrink mid-decode (parked and
             adopted, streams against the uninterrupted run), lammps-proxy
             trained through the SubmeshExecutor (loss against the
             Trainer's), and lammps-proxy as the workload under a Flux
             job and an MPIJob (the paper's Figure 5); each handle's
             lifecycle and the phase's launch counts are printed;
8. smoke   - the executors' default SMOKE configs (head dims 16 and 8)
             on the card: a WorkloadSpec of every executor kind applied
             without cfg=, and jamba-v0.1-52b and xlstm-1.3b served,
             elastic-served, trained and elastic-trained (no plain version
             may run); then
             ``repro_torch.launch.pipeline`` on pipeline_canary.json
             (yi-6b SMOKE) with its trace held to tools/validate_trace.py;
             then the pipeline at full width: granite-moe-1b-a400m (8 of
             its 24 layers) trained
             elastically (6 steps of 4 x 4096, grown 2 -> 4 nodes and
             shrunk back, every checkpoint timed and sized; the losses
             against an uninterrupted Trainer), gated on its final loss,
             and promoted replica by replica into a live 2-replica
             elastic fleet (no request dropped, streams before each swap
             equal the unpromoted run's, streams after the roll equal a
             direct Engine's over the restored trained params).

Then the ``kernels`` JSON line, the card's line, and the result line.
Any failure raises and exits non-zero; without CUDA, or without the port
beside this file, it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
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
# flash_fwd's out, whole tensor, paged_prefill's real rows and the
# decode kernels' outputs below head dim 64:
# ||kernel - plain|| <= FWD_REL_L2_TOL * ||plain||.  With randn inputs
# |out| is ~0.04 at 4096 keys, where the element check above allows ~2/3
# of a value.  Each side rounds p and out to bf16 (2^-9 relative each)
# from f32 values summed in another order, so two correct versions lie
# about two such roundings (3.9e-3) apart at most (the decode kernels
# keep p in f32 and round once); this file prints the measured error at
# each shape.
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
# depths cut for the script's time limit (each path keeps its checks; the
# checkpoints through host memory and npz are what take the time)
COMM_LAYERS = 4             # of granite's 24: four ranks of all 24 need ~150 GB
YI_TRAIN_LAYERS = 2         # of yi-6b's 32, here and in the tp phase (4
                            # before the tp phase's seqmix_tp part: the
                            # seconds each cut saves, PERF.md section 5)
PIPE_LAYERS = 8             # of granite's 24 in the pipeline: 5.6 GB a step
QWEN2_LAYERS = 16           # of qwen2-72b's 80: 16.5e9 params, 33 GB in bf16
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
    # the launch floor the smallest rows are read against: an empty
    # kernel (torch.cuda._sleep of 0 cycles) timed the same way
    floor = median_ms(cpm, lambda: torch.cuda._sleep(0))
    print(f"[kernels] an empty kernel (torch.cuda._sleep(0)), CUDA events "
          f"around 10 calls behind a GPU sleep, median of 7: {floor:.5f} ms "
          f"a call; rmsnorm (512, 4096) {rows_out['rmsnorm']['ms']:.5f} ms, "
          f"{rows_out['rmsnorm']['ms'] / floor:.2f}x it")

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
    rows_out["paged_decode"], (kp, vp, bt) = paged_decode_row(
        torch, dev, g, rnd, cpm, H, HKV, [1, 17, 100, 256, 511, 700, 1000, 1024],
        "yi-6b")
    rows_out["paged_decode"]["shape"] = (
        "q (8,1,32,128), pools (1025,16,4,128) bf16, lengths 1..1024")

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
    dense_shapes(torch, dev, cpm)
    seqmix_shapes(torch, dev, cpm)
    seqmix_train_shapes(torch, dev, rows_out, cpm)
    # lammps-proxy's head dim 32 (8 heads over 8), the SMOKE configs' 16
    # (4 over 2) and qwen2-72b SMOKE's 8 (8 over 2)
    head_dim_rows(torch, dev, rows_out, cpm, 32, 8, 8, 3232, "lammps-proxy")
    head_dim_rows(torch, dev, rows_out, cpm, 16, 4, 2, 1616, "SMOKE")
    head_dim_rows(torch, dev, rows_out, cpm, 8, 8, 2, 808, "qwen2-72b SMOKE")
    # pixtral-12b's head dim 160 at its training shape: each kernel a row
    # of its own in the kernels line, its launches the pixtral phase's
    for name, row in head_dim_rows(torch, dev, rows_out, cpm, 160, 32, 8,
                                   16016, "pixtral-12b", seq=4096,
                                   plain=True).items():
        rows_out[f"{name}{D160}"] = dict(row, kernel=name)
    encdec_shapes(torch, dev, rows_out, cpm)
    tp_shapes(torch, dev, rows_out, cpm)
    seqmix_tp_shapes(torch, dev, rows_out, cpm)

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


def dense_shapes(torch, dev, cpm):
    """The serving kernels at the shapes chatglm3-6b (32 query heads over
    2 KV heads: g = 16, the most a decode block takes, and 4 positions a
    packed prefill tile) and qwen2-72b (64 over 8, d_model 8192) give
    them, from a generator of their own: paged decode and paged prefill
    at both, flash_fwd at chatglm3-6b's 512-token prompt, rmsnorm at
    (8, 8192) and (512, 8192).  Each is held against its plain version
    as the rows above are; none is a row of its own.  Then rmsnorm is
    timed again, late in the call, at (512, 4096) and (512, 8192) beside
    F.rms_norm."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref

    g = torch.Generator(device=dev).manual_seed(4321)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    D, PAGE, B, MAXP = 128, 16, 8, 1024 // 16
    n_pages = B * MAXP + 1
    lens = torch.tensor([1, 17, 100, 256, 511, 700, 1000, 1024],
                        dtype=torch.int32, device=dev)
    for label, H, HKV in (("chatglm3-6b", 32, 2), ("qwen2-72b", 64, 8)):
        kp, vp = rnd(n_pages, PAGE, HKV, D), rnd(n_pages, PAGE, HKV, D)
        bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)
              [:B * MAXP]).to(torch.int32).reshape(B, MAXP)
        qd = rnd(B, 1, H, D)
        got = ops.paged_decode_attention(qd, kp, vp, bt, lens)
        e, ok = err_within(got, dec_ref.paged_decode_ref(qd, kp, vp, bt, lens),
                           TOL)
        check(ok, f"paged_decode at {label}'s heads differs from the plain "
              f"version")
        check(torch.equal(got, ops.paged_decode_attention(qd, kp, vp, bt, lens)),
              f"paged_decode at {label}'s heads gave other bits on a second run")
        kg = kp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
        mask = (torch.arange(MAXP * PAGE, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        filled = int(lens.sum())
        print(f"[kernels] paged_decode {label} q (8,1,{H},{D}) over {HKV} KV "
              f"heads: max error {e:.3g} against the plain version (tol "
              f"{TOL}); the same bits twice")
        paged_decode_rate(torch, dict(
            ms=median_ms(cpm, lambda: ops.paged_decode_attention(
                qd, kp, vp, bt, lens)),
            library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
                qd.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)),
            bound=bound(2 * filled * HKV * D * 2 + 2 * qd.numel() * 2
                        + bt.numel() * 4, 4 * filled * H * D)),
            label, B * HKV, MAXP)
        del kg, vg
        paged_prefill_row(torch, dev, rnd, cpm, label, H, kp, vp, bt[:1],
                          ((0, 200), (256, 180)))
        del kp, vp

    q, k, v = rnd(1, 512, 32, D), rnd(1, 512, 2, D), rnd(1, 512, 2, D)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True)
    e, ok = err_within(out, ref_out, TOL)
    e_lse = float((lse - ref_lse).abs().max())
    check(ok and e_lse <= LSE_TOL, f"flash_fwd at chatglm3-6b's prompt "
          f"differs from the plain version (lse by {e_lse})")
    again = fa_kernel.flash_fwd(q, k, v, causal=True)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash_fwd at chatglm3-6b's prompt gave other bits on a second run")
    print(f"[kernels] flash_fwd chatglm3-6b q (1,512,32,128) kv "
          f"(1,512,2,128) causal: max error {e:.3g} (tol {TOL}), lse error "
          f"{e_lse:.3g} (tol {LSE_TOL}); the same bits twice")
    fwd_rel_l2(out, ref_out, "(1,512) over 2 KV heads")
    fwd_rate(torch, cpm, "q (1,512,32,128) kv (1,512,2,128) causal", q, k, v)

    w = 1 + 0.1 * torch.randn(8192, generator=g, device=dev)
    for rows in (8, 512):
        xr = rnd(rows, 8192)
        e, ok = err_within(ops.rmsnorm(xr, w), rn_ref.rmsnorm_ref(xr, w), TOL)
        check(ok, f"rmsnorm ({rows}, 8192) differs from the plain version")
        print(f"[kernels] rmsnorm ({rows}, 8192): max error {e:.3g} against "
              f"the plain version (tol {TOL})")
    for d in (4096, 8192):
        x, wd = rnd(512, d), 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        wb = wd.to(bf)
        t = median_ms(cpm, lambda: ops.rmsnorm(x, wd))
        lib = median_ms(cpm, lambda: F.rms_norm(x, (d,), wb, 1e-5))
        least, _ = bound(2 * x.numel() * 2 + wd.numel() * 4, 4 * x.numel())
        print(f"[kernels] rmsnorm (512, {d}) timed late in the call: kernel "
              f"{t:.4f} ms, F.rms_norm {lib:.4f} ms ({t / lib:.2f}x), bound "
              f"{least:.5f} ms (bytes, {least / t:.3f} of it)")


def seqmix_shapes(torch, dev, cpm):
    """The kernels at the shapes the seqmix phase gives them, from a
    generator of their own, each held against its plain version as the
    rows above are (none is a row of its own): rmsnorm at xlstm-1.3b's d
    2048 (a decode tick's 8 rows and a 512-token prefill's), timed at
    the prefill's beside F.rms_norm; flash_fwd at jamba-v0.1-52b's exact
    prompt of 77 tokens (32 heads over 8, D 128: no multiple of the
    kernel's 64-row tiles or of a page); paged decode at jamba's decode
    tick (8 slots, 32 query heads over 8 KV heads: g = 4 at D 128, no
    other served arch's split kernel) over contexts of 1..1024 tokens,
    timed beside SDPA; and moe_gemm at jamba's widths
    (16 experts, 4096 -> 14336 and back): a decode tick's 8 rows an
    expert (8 slots, capacity 1) and a 512-token prefill's 80 (capacity
    ceil(512 x 2 x 1.25 / 16)), each timed beside torch.bmm."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ref as moe_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref

    g = torch.Generator(device=dev).manual_seed(2222)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    w = 1 + 0.1 * torch.randn(2048, generator=g, device=dev)
    for rows in (8, 512):
        x = rnd(rows, 2048)
        e, ok = err_within(ops.rmsnorm(x, w), rn_ref.rmsnorm_ref(x, w), TOL)
        check(ok, f"rmsnorm ({rows}, 2048) differs from the plain version")
    wb = w.to(bf)
    t = median_ms(cpm, lambda: ops.rmsnorm(x, w))
    lib = median_ms(cpm, lambda: F.rms_norm(x, (2048,), wb, 1e-5))
    plain = median_ms(cpm, lambda: rn_ref.rmsnorm_ref(x, w))
    least, _ = bound(2 * x.numel() * 2 + w.numel() * 4, 4 * x.numel())
    print(f"[kernels] rmsnorm xlstm-1.3b (512, 2048), held also at (8, 2048): "
          f"max error {e:.3g} (tol {TOL}); kernel {t:.4f} ms, plain "
          f"{plain:.4f} ms, F.rms_norm {lib:.4f} ms ({t / lib:.2f}x), bound "
          f"{least:.5f} ms (bytes, {least / t:.3f} of it)")

    q, k, v = rnd(1, 77, 32, 128), rnd(1, 77, 8, 128), rnd(1, 77, 8, 128)
    out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=True)
    e, ok = err_within(out, ref_out, TOL)
    e_lse = float((lse - ref_lse).abs().max())
    check(ok and e_lse <= LSE_TOL, f"flash_fwd at jamba's 77-token prompt "
          f"differs from the plain version (lse by {e_lse})")
    least, by = bound((2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4,
                      2 * 2 * 32 * (77 * 78 // 2) * 128)
    print(f"[kernels] flash_fwd jamba-v0.1-52b q (1,77,32,128) kv "
          f"(1,77,8,128) causal: max error {e:.3g} (tol {TOL}), lse error "
          f"{e_lse:.3g} (tol {LSE_TOL}); bound {least:.5f} ms ({by})")
    fwd_rel_l2(out, ref_out, "(1,77) over 8 KV heads")
    fwd_rate(torch, cpm, "q (1,77,32,128) kv (1,77,8,128) causal", q, k, v)
    del q, k, v, out, ref_out

    PAGE, B, MAXP = 16, 8, 1024 // 16
    n_pages = B * MAXP + 1
    kp, vp = rnd(n_pages, PAGE, 8, 128), rnd(n_pages, PAGE, 8, 128)
    bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)
          [:B * MAXP]).to(torch.int32).reshape(B, MAXP)
    lens = torch.tensor([1, 17, 77, 256, 511, 544, 1000, 1024],
                        dtype=torch.int32, device=dev)
    qd = rnd(B, 1, 32, 128)
    got = ops.paged_decode_attention(qd, kp, vp, bt, lens)
    want = dec_ref.paged_decode_ref(qd, kp, vp, bt, lens)
    e, ok = err_within(got, want, TOL)
    r = rel_l2(got, want)
    check(ok and r <= FWD_REL_L2_TOL, f"paged_decode at jamba's heads differs "
          f"from the plain version (relative L2 {r:.3g})")
    check(torch.equal(got, ops.paged_decode_attention(qd, kp, vp, bt, lens)),
          "paged_decode at jamba's heads gave other bits on a second run")
    print(f"[kernels] paged_decode jamba-v0.1-52b q (8,1,32,128) over 8 KV "
          f"heads, lengths {lens.tolist()}: max error {e:.3g} (tol {TOL}), "
          f"relative L2 {r:.3g} (tol {FWD_REL_L2_TOL}); the same bits twice")
    kg = kp[bt.long()].reshape(B, MAXP * PAGE, 8, 128).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, MAXP * PAGE, 8, 128).transpose(1, 2)
    mask = (torch.arange(MAXP * PAGE, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    filled = int(lens.sum())
    paged_decode_rate(torch, dict(
        ms=median_ms(cpm, lambda: ops.paged_decode_attention(
            qd, kp, vp, bt, lens)),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)),
        bound=bound(2 * filled * 8 * 128 * 2 + 2 * qd.numel() * 2
                    + bt.numel() * 4, 4 * filled * 32 * 128)),
        "jamba-v0.1-52b", B * 8, MAXP)
    del kp, vp, kg, vg

    E, D, F_ = 16, 4096, 14336
    w_in, w_out = rnd(E, D, F_, scale=0.02), rnd(E, F_, D, scale=0.02)
    for label, T in (("jamba decode", 8), ("jamba prefill 512", 80)):
        for a, b, depth, name in ((rnd(E, T, D), w_in, D, "up"),
                                  (rnd(E, T, F_), w_out, F_, "down")):
            got, want = moe_kernel.moe_gemm(a, b), moe_ref.moe_gemm_ref(a, b)
            e, ok = err_within(got.float() * depth ** -0.5 / 0.02,
                               want.float() * depth ** -0.5 / 0.02, TOL)
            check(ok, f"moe_gemm at {label} {name} differs from the plain "
                  f"version")
            row = moe_rate(torch, cpm, f"{label} {name}", a, b, got)
            plain = median_ms(cpm, lambda: moe_ref.moe_gemm_ref(a, b), n=3,
                              reps=5)
            print(f"[kernels] moe_gemm {label} {name}: max error {e:.3g} "
                  f"(x 1/(0.02 sqrt({depth})), tol {TOL}); plain "
                  f"{plain:.4f} ms; kernel {row['ms']:.4f} ms")
    del w_in, w_out


def flash_holds(torch, cpm, rnd, rows_out, B, S, H, HKV, D, what, skv=None,
                causal=True, plain=False):
    """flash_fwd and flash_bwd at (B, S) queries over ``skv`` keys (S by
    default), causal or not, H query heads over HKV KV heads of dim D
    (``what``: whose): each held against its plain version per element
    at TOL (lse at LSE_TOL) and in relative L2 (FWD_REL_L2_TOL,
    REL_L2_TOL), the same bits on a second run, its error folded into its
    kernel's row; each timed beside SDPA (GQA through ``enable_gqa``, the
    backward on a KV repeat) and its bound.  Returns the three kernels'
    rows at this shape (with the plain versions' times where ``plain``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    skv = S if skv is None else skv
    kw = dict(causal=causal, q_offset=skv - S if causal else 0)
    q, k, v, do = rnd(B, S, H, D), rnd(B, skv, HKV, D), rnd(B, skv, HKV, D), \
        rnd(B, S, H, D)
    out, lse = fa_kernel.flash_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa_ref.fwd(q, k, v, **kw)
    e_fwd, ok = err_within(out, ref_out, TOL)
    e_lse = float((lse - ref_lse).abs().max())
    check(ok and e_lse <= LSE_TOL, f"flash_fwd at {what} differs from "
          f"the plain version (lse by {e_lse})")
    fwd_rel_l2(out, ref_out, f"({B},{S}) {what}")
    again = fa_kernel.flash_fwd(q, k, v, **kw)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash_fwd at {what} gave other bits on a second run")
    qkv = f"q ({B},{S},{H},{D}), kv ({B},{skv},{HKV},{D})"
    _fold(rows_out["flash_fwd"], e_fwd, f"; and {qkv}")
    got = fa_kernel.flash_bwd(q, k, v, out, lse, do, **kw)
    want = fa_ref.bwd(q, k, v, out, lse, do, **kw)
    rels, errs = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e, ok = err_within(a, b, TOL)
        r = rel_l2(a, b)
        check(ok and r <= REL_L2_TOL, f"flash_bwd {name} at {what} "
              f"differs from the plain version (relative L2 {r:.3g})")
        rels.append(r)
        errs.append(e)
        _fold(rows_out["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"],
              e, "")
    again = fa_kernel.flash_bwd(q, k, v, out, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_bwd at {what} gave other bits on a second run")
    del got, want, again, ref_out, ref_lse
    delta = (out.float() * do.float()).sum(-1)
    shape = f"{qkv} {'causal' if causal else 'non-causal'}"
    t_fwd, sdpa_fwd_ms = fwd_rate(torch, cpm, shape, q, k, v, causal)
    t_dq = median_ms(cpm, lambda: fa_kernel.flash_bwd_dq(
        q, k, v, do, lse, delta, **kw))
    t_dkv = median_ms(cpm, lambda: fa_kernel.flash_bwd_dkv(
        q, k, v, do, lse, delta, **kw))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k.repeat_interleave(H // HKV, dim=2),
                            v.repeat_interleave(H // HKV, dim=2)))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    sdpa_bwd_ms = median_ms(cpm, sdpa_fwd_bwd) - median_ms(cpm, sdpa_fwd)
    mm = 2 * B * _pairs(S, skv, causal) * H * D
    print(bwd_rate(shape, t_dq, t_dkv, mm, sdpa_bwd_ms))
    io = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * lse.numel() * 4
    bounds = (bound(io, 2 * mm), bound(io + q.numel() * 2, 3 * mm),
              bound(io + 2 * k.numel() * 2, 4 * mm))
    print(f"[kernels] {what}, {shape}: "
          f"flash_fwd {t_fwd:.4f} ms (bound {bounds[0][0]:.5f} ms, SDPA "
          f"{sdpa_fwd_ms:.4f} ms), flash_bwd_dq {t_dq:.4f} ms (bound "
          f"{bounds[1][0]:.5f} ms), flash_bwd_dkv {t_dkv:.4f} ms (bound "
          f"{bounds[2][0]:.5f} ms), SDPA backward {sdpa_bwd_ms:.4f} ms; "
          f"relative L2 dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv {rels[2]:.3g}")
    plain_fwd = plain_bwd = None
    if plain:
        plain_fwd = median_ms(cpm, lambda: fa_ref.chunked(q, k, v, **kw),
                              n=2, reps=3)
        plain_bwd = median_ms(cpm, lambda: fa_ref.bwd(q, k, v, out, lse, do,
                                                      **kw), n=2, reps=3)
    rows = {
        "flash_fwd": dict(max_abs_err=e_fwd, lse_err=e_lse, ms=t_fwd,
                          plain_ms=plain_fwd, library_ms=sdpa_fwd_ms,
                          bound=bounds[0]),
        # the plain version and SDPA compute dq, dk and dv together:
        # both rows carry the whole backward's time
        "flash_bwd_dq": dict(max_abs_err=errs[0], ms=t_dq,
                             plain_ms=plain_bwd, library_ms=sdpa_bwd_ms,
                             bound=bounds[1]),
        "flash_bwd_dkv": dict(max_abs_err=max(errs[1:]), ms=t_dkv,
                              plain_ms=plain_bwd, library_ms=sdpa_bwd_ms,
                              bound=bounds[2])}
    for r in rows.values():
        r["shape"] = shape
    del q, k, v, do, out, lse, delta, qt, kt, vt, dot
    return rows


def _pairs(sq, skv, causal):
    """(query, key) pairs attended: every pair, or under the causal mask
    with q_offset = skv - sq those at or below the diagonal."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(max(0, min(skv, i + off + 1)) for i in range(sq))


def seqmix_train_shapes(torch, dev, rows_out, cpm):
    """The kernels at the shapes the seqmix_train phase gives them, from
    a generator of their own: flash_fwd and flash_bwd at jamba-v0.1-52b's
    training attention (2 x 4096, 32 query heads over 8 KV heads: g = 4
    at D 128, an instance no other trained arch takes) through
    ``flash_holds``; moe_gemm at jamba's training capacity (16 experts,
    2 groups of ceil(4096 x 2 x 1.25 / 16) = 640 slots: T 1280 an
    expert), the two forward products (4096 -> 14336 and back) and the
    backward's dX and dW of the first on the views the autograd Function
    passes, each against its plain version (errors scaled to the size of
    such a sum, as in ``seqmix_shapes``; the backward's also in relative
    L2) and timed beside torch.bmm and its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ref as moe_ref

    g = torch.Generator(device=dev).manual_seed(2323)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    flash_holds(torch, cpm, rnd, rows_out, 2, 4096, 32, 8, 128,
                "jamba-v0.1-52b's training attention (g = 4)")

    E, T, D, F_ = 16, 1280, 4096, 14336
    w_in, w_out = rnd(E, D, F_, scale=0.02), rnd(E, F_, D, scale=0.02)
    x = rnd(E, T, D)
    for a, b, depth, name in ((x, w_in, D, "up"), (rnd(E, T, F_), w_out, F_,
                                                   "down")):
        got, want = moe_kernel.moe_gemm(a, b), moe_ref.moe_gemm_ref(a, b)
        e, ok = err_within(got.float() * depth ** -0.5 / 0.02,
                           want.float() * depth ** -0.5 / 0.02, TOL)
        check(ok, f"moe_gemm at jamba's training capacity {name} differs "
              f"from the plain version")
        row = moe_rate(torch, cpm, f"jamba train {name}", a, b, got)
        plain = median_ms(cpm, lambda: moe_ref.moe_gemm_ref(a, b), n=3,
                          reps=5)
        print(f"[kernels] moe_gemm jamba train (T {T}) {name}: max error "
              f"{e:.3g} (x 1/(0.02 sqrt({depth})), tol {TOL}); plain "
              f"{plain:.4f} ms; kernel {row['ms']:.4f} ms")
        del got, want
    dy = rnd(E, T, F_)
    grads = []
    for impl in (None, "ref"):
        xl, wl = x.clone().requires_grad_(), w_in.clone().requires_grad_()
        grads.append(torch.autograd.grad(ops.moe_gemm(xl, wl, impl=impl),
                                         (xl, wl), dy))
        del xl, wl
    # dX = dY W^T sums F unit x 0.02 products, dW = X^T dY T unit ones
    for name, a, b, depth, w in (("dX", grads[0][0], grads[1][0], F_, 0.02),
                                 ("dW", grads[0][1], grads[1][1], T, 1.0)):
        e, ok = err_within(a.float() * depth ** -0.5 / w,
                           b.float() * depth ** -0.5 / w, TOL)
        r = rel_l2(a, b)
        check(ok and r <= REL_L2_TOL, f"moe_gemm backward {name} at jamba's "
              f"training capacity differs from the plain version's autograd "
              f"(relative L2 {r:.3g})")
        print(f"[kernels] moe_gemm jamba train backward {name}: max error "
              f"{e:.3g} (x 1/({w} sqrt({depth})), tol {TOL}), relative L2 "
              f"{r:.3g} (tol {REL_L2_TOL})")
    moe_rate(torch, cpm, "jamba train backward dX = dY W^T", dy,
             w_in.transpose(1, 2), grads[0][0])
    moe_rate(torch, cpm, "jamba train backward dW = X^T dY",
             x.transpose(1, 2), dy, grads[0][1])
    del grads, w_in, w_out, x, dy


def head_dim_rows(torch, dev, rows_out, cpm, D, H, HKV, seed, label,
                  seq=2048, plain=False):
    """The attention kernels at head dim D other than 64 and 128
    (``label``: whose), H query heads over HKV KV heads, from a generator
    of their own (``seed``): flash_fwd and flash_bwd at a train shape (2
    x ``seq``, causal), paged decode and decode over a contiguous cache
    at the serve cell's 8 slots, paged prefill at its 256-row chunk.  The
    wgmma kernels run D below 64 on 64-wide tiles whose columns D..63 are
    zero, and D = 160 on 192-wide ones (wgmma.cuh); the split decode
    kernel gives each of lanes 0..D-1 one column below D = 32.  Each
    kernel is held against its plain version at the head dim 64 rows'
    tolerances, its error folded into its kernel's row, and timed beside
    SDPA (GQA through ``enable_gqa``, the backward on a KV repeat) and
    its bound.  Returns each kernel's row at this head dim (the plain
    versions timed where ``plain``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    gqa = H != HKV

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    PAGE, what = 16, f"head dim {D}"
    rows = flash_holds(torch, cpm, rnd, rows_out, 2, seq, H, HKV, D, what,
                       plain=plain)

    MAXP = 1024 // PAGE
    n_pages = 8 * MAXP + 1
    kp, vp = rnd(n_pages, PAGE, HKV, D), rnd(n_pages, PAGE, HKV, D)
    bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)[:8 * MAXP]
          ).to(torch.int32).reshape(8, MAXP)
    lens = torch.tensor([1, 17, 100, 256, 511, 700, 1000, 1024],
                        dtype=torch.int32, device=dev)
    qd = rnd(8, 1, H, D)
    got = ops.paged_decode_attention(qd, kp, vp, bt, lens)
    want = dec_ref.paged_decode_ref(qd, kp, vp, bt, lens)
    e, ok = err_within(got, want, TOL)
    r_paged = rel_l2(got, want)
    check(ok and r_paged <= FWD_REL_L2_TOL, f"paged_decode at {what} "
          f"differs from the plain version (relative L2 {r_paged:.3g})")
    check(torch.equal(got, ops.paged_decode_attention(qd, kp, vp, bt, lens)),
          f"paged_decode at {what} gave other bits on a second run")
    _fold(rows_out["paged_decode"], e,
          f"; and at (8,1,{H},{D}) over {HKV} KV heads")
    kg = kp[bt.long()].reshape(8, MAXP * PAGE, HKV, D).transpose(1, 2)
    vg = vp[bt.long()].reshape(8, MAXP * PAGE, HKV, D).transpose(1, 2)
    mask = (torch.arange(MAXP * PAGE, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    filled = int(lens.sum())
    rows["paged_decode"] = dict(
        max_abs_err=e,
        ms=median_ms(cpm, lambda: ops.paged_decode_attention(qd, kp, vp, bt,
                                                             lens)),
        plain_ms=(median_ms(cpm, lambda: dec_ref.paged_decode_ref(
            qd, kp, vp, bt, lens)) if plain else None),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=gqa)),
        bound=bound(2 * filled * HKV * D * 2 + 2 * qd.numel() * 2
                    + bt.numel() * 4, 4 * filled * H * D),
        shape=f"q (8,1,{H},{D}), pools ({n_pages},16,{HKV},{D}), lengths "
              f"1..1024")
    paged_decode_rate(torch, rows["paged_decode"], f"{label} ({what})",
                      8 * HKV, MAXP)
    del kg, vg
    pre = paged_prefill_row(torch, dev, rnd, cpm, f"{label} ({what})",
                            H, kp, vp, bt[:1], ((0, 200), (256, 180)))
    _fold(rows_out["paged_prefill"], pre["max_abs_err"],
          f"; and at (1,256,{H},{D}) over {HKV} KV heads")
    pre["shape"] = f"q (1,256,{H},{D}) at start 256, n_valid 180, page 16"
    rows["paged_prefill"] = pre
    del kp, vp

    L = 700
    qc, kc, vc = rnd(8, 1, H, D), rnd(8, 1024, HKV, D), rnd(8, 1024, HKV, D)
    got = ops.decode_attention(qc, kc, vc, L)
    want = dec_ref.decode_ref(qc, kc, vc, L)
    e, ok = err_within(got, want, TOL)
    r = rel_l2(got, want)
    check(ok and r <= FWD_REL_L2_TOL, f"decode_attention at {what} differs "
          f"from the plain version (relative L2 {r:.3g})")
    print(f"[kernels] {what}: relative L2 error against the plain version, "
          f"paged_decode {r_paged:.3g}, decode_attention {r:.3g} (tol "
          f"{FWD_REL_L2_TOL})")
    check(torch.equal(got, ops.decode_attention(qc, kc, vc, L)),
          f"decode_attention at {what} gave other bits on a second run")
    _fold(rows_out["decode_attention"], e,
          f"; and at (8,1,{H},{D}) over {HKV} KV heads")
    qt, kt, vt = (x.transpose(1, 2) for x in (qc, kc[:, :L], vc[:, :L]))
    t = median_ms(cpm, lambda: ops.decode_attention(qc, kc, vc, L))
    lib = median_ms(cpm, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=gqa))
    least, by = bound(2 * 8 * L * HKV * D * 2 + 2 * qc.numel() * 2,
                      4 * 8 * L * H * D)
    print(f"[kernels] decode_attention {label} ({what}) q (8,1,{H},{D}),"
          f" cache (8,1024,{HKV},{D}), cache_len 700: max error {e:.3g} (tol "
          f"{TOL}); kernel {t:.4f} ms, SDPA {lib:.4f} ms ({t / lib:.2f}x), "
          f"bound {least:.5f} ms ({by}, {least / t:.3f} of it)")
    rows["decode_attention"] = dict(
        max_abs_err=e, ms=t, library_ms=lib, bound=(least, by),
        plain_ms=(median_ms(cpm, lambda: dec_ref.decode_ref(qc, kc, vc, L))
                  if plain else None),
        shape=f"q (8,1,{H},{D}), cache (8,1024,{HKV},{D}), cache_len 700")
    return rows


def encdec_shapes(torch, dev, rows_out, cpm):
    """flash attention at whisper-base's non-causal shapes, from a
    generator of its own: the encoder's self-attention over 1500 frames
    (8 rows, 8 heads of 64) and a decode step's cross-attention (one
    query row a head over the 1500 frames), each held against its plain
    version (TOL, LSE_TOL, FWD_REL_L2_TOL), the same bits twice, and
    timed beside SDPA and its bound; then flash_fwd and flash_bwd at
    the training cross-attention (2 x 4096 queries over 2048 frames)
    through ``flash_holds``, with the plain versions' times.  Errors
    fold into flash_fwd's and flash_bwd's rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    g = torch.Generator(device=dev).manual_seed(1500)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    B, T, H, D = 8, 1500, 8, 64
    k, v = rnd(B, T, H, D), rnd(B, T, H, D)
    for sq, what in ((T, "the encoder's self-attention"),
                     (1, "a decode step's cross-attention")):
        q = rnd(B, sq, H, D)
        out, lse = fa_kernel.flash_fwd(q, k, v, causal=False)
        ref_out, ref_lse = fa_ref.fwd(q, k, v, causal=False)
        e, ok = err_within(out, ref_out, TOL)
        e_lse = float((lse - ref_lse).abs().max())
        check(ok and e_lse <= LSE_TOL, f"flash_fwd at whisper's {what} "
              f"differs from the plain version (lse by {e_lse})")
        fwd_rel_l2(out, ref_out, f"({B},{sq}) over {T} keys, non-causal")
        again = fa_kernel.flash_fwd(q, k, v, causal=False)
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"flash_fwd at whisper's {what} gave other bits on a second "
              f"run")
        shape = f"q ({B},{sq},{H},{D}), kv ({B},{T},{H},{D}) non-causal"
        _fold(rows_out["flash_fwd"], e, f"; and {shape}")
        t, lib = fwd_rate(torch, cpm, shape, q, k, v, causal=False)
        plain = median_ms(cpm, lambda: fa_ref.chunked(q, k, v, causal=False),
                          n=2, reps=3)
        least, by = bound((2 * q.numel() + 2 * k.numel()) * 2
                          + lse.numel() * 4, 4 * B * sq * T * H * D)
        print(f"[kernels] flash_fwd whisper-base {what}, {shape}: max error "
              f"{e:.3g} (tol {TOL}), lse {e_lse:.3g}; kernel {t:.4f} ms, "
              f"plain {plain:.4f} ms, SDPA {lib:.4f} ms ({t / lib:.2f}x), "
              f"bound {least:.5f} ms ({by}, {least / t:.3f} of it)")
    rows = flash_holds(torch, cpm, rnd, rows_out, 2, 4096, H, H, D,
                       "whisper-base's training cross-attention", skv=2048,
                       causal=False, plain=True)
    print(f"[kernels] whisper-base's training cross-attention, the plain "
          f"versions: forward {rows['flash_fwd']['plain_ms']:.4f} ms, the "
          f"whole backward (dq, dk, dv) {rows['flash_bwd_dq']['plain_ms']:.4f}"
          f" ms")


def fwd_rel_l2(out, ref_out, shape):
    """Hold flash_fwd's whole output against the plain version's in
    relative L2 (FWD_REL_L2_TOL) and print the error."""
    r = rel_l2(out, ref_out)
    check(r <= FWD_REL_L2_TOL, f"flash_fwd out at {shape} differs from the "
          f"plain version by {r:.3g} in relative L2 (tol {FWD_REL_L2_TOL})")
    print(f"[kernels] flash_fwd {shape}: relative L2 error of out against "
          f"the plain version {r:.3g} (tol {FWD_REL_L2_TOL})")


def fwd_rate(torch, cpm, shape, q, k, v, causal=True):
    """Time flash_fwd and SDPA's forward (no grad, GQA without a KV
    repeat, on the (B, H, S, D) transposes) at one shape, causal (q and
    k of one length) or not, and print each one's time, achieved TFLOP/s
    of the two products over the pairs attended and share of their bound
    at the bf16 peak.  Returns (kernel ms, SDPA ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    b, s, h, d = q.shape
    flops = 2 * 2 * b * _pairs(s, k.shape[1], causal) * h * d
    least = flops / BF16_FLOPS_S * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
    t = median_ms(cpm, lambda: fa_kernel.flash_fwd(q, k, v, causal=causal))
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


def paged_decode_rate(torch, row, label, slots_heads, maxp, page=16,
                      slots=8):
    """Print paged decode's time beside SDPA on the gathered KV and its
    byte bound, with the split plan the wrapper launched."""
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    n, pps = dec_kernel.plan_splits(
        maxp, page, slots_heads,
        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"[kernels] paged_decode {label} ({slots} slots, lengths up to "
          f"1024): "
          f"kernel {row['ms']:.4f} ms in {n} splits of {pps * page} keys, "
          f"SDPA on the gathered KV {row['library_ms']:.4f} ms "
          f"({row['ms'] / row['library_ms']:.2f}x), bound "
          f"{row['bound'][0]:.5f} ms ({row['bound'][0] / row['ms']:.3f} of "
          f"it)")


def paged_decode_row(torch, dev, g, rnd, cpm, h, hkv, lens, label, d=128,
                     page=16):
    """Paged decode of ``len(lens)`` slots of ``h`` query heads over
    ``hkv`` KV heads of ``d``, pages of ``page``, each slot at its length
    of ``lens`` (rows of 1024 tokens, pages from ``g`` in random order):
    within TOL of its plain version, the same bits twice, timed beside
    the plain version and SDPA on the gathered KV, with its bound.
    Returns (the kernels row, (the pools and block table))."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import ref as dec_ref

    b, maxp = len(lens), 1024 // page
    n_pages = b * maxp + 1
    kp, vp = rnd(n_pages, page, hkv, d), rnd(n_pages, page, hkv, d)
    bt = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)[:b * maxp]
          ).to(torch.int32).reshape(b, maxp)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = rnd(b, 1, h, d)
    got = ops.paged_decode_attention(qd, kp, vp, bt, lens)
    e, ok = err_within(got, dec_ref.paged_decode_ref(qd, kp, vp, bt, lens), TOL)
    check(ok, f"paged_decode {label} differs from the plain version")
    check(torch.equal(got, ops.paged_decode_attention(qd, kp, vp, bt, lens)),
          f"paged_decode {label} gave other bits on a second run of the same "
          f"inputs")
    kg = kp[bt.long()].reshape(b, maxp * page, hkv, d).transpose(1, 2)
    vg = vp[bt.long()].reshape(b, maxp * page, hkv, d).transpose(1, 2)
    mask = (torch.arange(maxp * page, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    filled = int(lens.sum())
    row = dict(
        max_abs_err=e,
        ms=median_ms(cpm, lambda: ops.paged_decode_attention(qd, kp, vp, bt,
                                                             lens)),
        plain_ms=median_ms(cpm, lambda: dec_ref.paged_decode_ref(
            qd, kp, vp, bt, lens)),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)),
        bound=bound(2 * filled * hkv * d * 2 + 2 * qd.numel() * 2
                    + bt.numel() * 4, 4 * filled * h * d))
    paged_decode_rate(torch, row, label, b * hkv, maxp, page, slots=b)
    return row, (kp, vp, bt)


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
    cancel: the bf16 rounding of ds moves such a sum by about TOL, and
    two bf16 runs that round differently (the kernel and the bf16 plain
    version, f32 sums in other orders) can part by more.  So the
    backward is held per element against a float32 run of the plain
    version (no rounding of p or ds) within ``_bf16_bwd_bound``, and in
    relative L2 against the bf16 plain version."""
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
        f32 = fa_ref.bwd(q.float(), k.float(), v.float(), out.float(), lse,
                         do.float(), **kw)
        bounds = _bf16_bwd_bound(torch, q, k, v, out, lse, do, f32, qo)
        rels, used = [], []
        for name, a, w, w32, lim in zip(("dq", "dk", "dv"), got, want, f32,
                                        bounds):
            over = (a.float() - w32).abs() - lim
            used.append(round(float(((a.float() - w32).abs() / lim).max()),
                              4))
            r = rel_l2(a, w)
            check(float(over.max()) <= 0, f"flash_bwd {name} at q_offset "
                  f"{qo} is off the float32 plain version by more than its "
                  f"bf16 bound (by {float(over.max()):.3g})")
            check(r <= REL_L2_TOL, f"flash_bwd {name} at q_offset {qo}"
                  f" differs from the plain version (relative L2 {r:.3g})")
            rels.append(round(r, 5))
        print(f"[kernels] q_offset {qo}, q ({b},{sq},{h},{d}), kv ({b},{skv},"
              f"{hkv},{d}): rows 0..{-qo - 1} see no key; forward max error "
              f"{e_fwd:.3g}, lse error {e_lse:.3g}, backward relative L2 {rels}"
              f" (bf16 plain); against the float32 plain version, the "
              f"largest share of the bf16 bound used by dq, dk, dv: {used}")


def _bf16_bwd_bound(torch, q, k, v, out, lse, do, f32, q_offset):
    """Per-element bounds on |kernel - float32 plain| for flash_bwd's
    (dq, dk, dv), both from the same q, k, v, dO, out and lse.

    The kernel rounds p to bf16 before p^T dO, and ds = p (dp - delta)
    scale to bf16 before ds k and ds^T q, as the plain version in bf16
    does (the float32 run rounds neither); each rounding moves a value
    by at most u |value|, u = 2^-8 (bf16's unit roundoff: 8 significant
    bits).  So with the float32 run's |p| and |ds|:

        |d dv_j| <= u sum_i |p_ij| |dO_i|,
        |d dk_j| <= u sum_i |ds_ij| |q_i|,   |d dq_i| <= u sum_j |ds_ij| |k_j|,

    (summed over the query heads of a KV head for dk and dv), plus the
    output's own rounding to bf16, u |x| of the float32 value x (and the
    term's u^2 second order: u (1 + u) in all), plus the float32 sums'
    order, n 2^-24 of the sum of the |terms| of a sum of n, at most 256
    here, below the 2^-14 taken: of the products above, and of dp =
    dO . v and delta = dO . out before ds takes their difference, whose
    error is relative to sum |dO| |v| and sum |dO| |out|, not to the
    difference (a no-key row's dp - delta cancels).  Nothing here depends
    on TOL."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, scale, u = h // hkv, d ** -0.5, 2.0 ** -8
    qg = q.float().reshape(b, sq, hkv, g, d)
    dog = do.float().reshape(b, sq, hkv, g, d)
    delta = (out.float().reshape(b, sq, hkv, g, d) * dog).sum(-1)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    valid = torch.arange(skv, device=q.device)[None, :] <= qpos[:, None]
    logits = torch.where(valid[None, :, None, None, :], logits,
                         fa_ref.NEG_INF)
    p = torch.exp(logits - lse.reshape(b, sq, hkv, g)[..., None])
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    # the size of dp's and delta's sums: their float32 error's scale
    sizes = p * scale * (
        torch.einsum("bqhgd,bkhd->bqhgk", dog.abs(), v.float().abs())
        + (out.float().reshape(b, sq, hkv, g, d).abs() * dog.abs()
           ).sum(-1)[..., None])
    ds = (u + 2.0 ** -14) * ds + 2.0 ** -14 * sizes
    sums = (torch.einsum("bqhgk,bkhd->bqhgd", ds, k.float().abs()
                         ).reshape(b, sq, h, d),
            torch.einsum("bqhgk,bqhgd->bkhd", ds, qg.abs()),
            (u + 2.0 ** -14) * torch.einsum("bqhgk,bqhgd->bkhd", p,
                                            dog.abs()))
    return [s + u * (1 + u) * x.abs() + 1e-30 for s, x in zip(sums, f32)]


TP = "_tp"                  # the kernels line's rows at the tp phase's shapes


def tp_shapes(torch, dev, rows_out, cpm):
    """The kernels at the local shapes a rank of the tp phase gives them,
    from a generator of their own: flash_fwd and flash_bwd at yi-6b's
    heads on model 2 (one row of 4096, 16 query heads over 2 KV heads of
    128: a data shard's row, the rank's half of the heads) and at
    granite's (2 x 4096, 8 over 4 of 64: a pod's rows); rmsnorm at yi's
    (4096, 4096); moe_gemm at granite's four expert homes, (8, 5120, 1024)
    x (8, 1024, 512) (8 local experts, 2 pods x 2 groups x capacity 1280
    rows each after the exchange).  Each held against its plain version
    as at the other shapes and timed beside its library call and bound;
    each a row of its own in the kernels line, its launches the tp
    phase's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ref as moe_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref

    g = torch.Generator(device=dev).manual_seed(2727)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    for label, shape in (("yi", (1, 4096, 16, 2, 128)),
                         ("granite", (2, 4096, 8, 4, 64))):
        rows = flash_holds(torch, cpm, rnd, rows_out, *shape,
                           f"{label} on model 2", plain=True)
        for name, row in rows.items():
            rows_out[f"{name}{TP}_{label}"] = dict(row, kernel=name,
                                                   runs="tp")
    w = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    x = rnd(4096, 4096)
    e, ok = err_within(ops.rmsnorm(x, w), rn_ref.rmsnorm_ref(x, w), TOL)
    check(ok, "rmsnorm (4096, 4096) differs from the plain version")
    rows_out[f"rmsnorm{TP}"] = dict(
        max_abs_err=e, kernel="rmsnorm", runs="tp",
        ms=median_ms(cpm, lambda: ops.rmsnorm(x, w)),
        plain_ms=median_ms(cpm, lambda: rn_ref.rmsnorm_ref(x, w)),
        library_ms=median_ms(cpm, lambda: F.rms_norm(x, (4096,), w.to(bf),
                                                     1e-5)),
        bound=bound(2 * x.numel() * 2 + w.numel() * 4, 4 * x.numel()),
        shape="x (4096, 4096) bf16, w (4096,) f32")
    xe, we = rnd(8, 5120, 1024), rnd(8, 1024, 512)
    got = moe_kernel.moe_gemm(xe, we)
    e, ok = err_within(got.float() * 1024 ** -0.5,
                       moe_ref.moe_gemm_ref(xe, we).float() * 1024 ** -0.5,
                       TOL)
    check(ok, "moe_gemm at (8, 5120, 1024) differs from the plain version")
    row = moe_rate(torch, cpm, "tp: granite's 8 local experts", xe, we, got)
    row.update(max_abs_err=e, kernel="moe_gemm", runs="tp",
               plain_ms=median_ms(cpm, lambda: moe_ref.moe_gemm_ref(xe, we)),
               shape="x (8,5120,1024), w (8,1024,512) bf16 (errors x "
                     "1/sqrt(1024))")
    rows_out[f"moe_gemm{TP}"] = row
    del x, xe, we, got
    serve_tp_shapes(torch, dev, rows_out, cpm, g, rnd)


def serve_tp_shapes(torch, dev, rows_out, cpm, g, rnd):
    """Paged decode and paged prefill at the local shapes a rank of the
    tp phase's serving part gives them: yi-6b on (data 2, model 2), so a
    data shard's 4 of the 8 slots and the rank's 16 of 32 query heads
    over 2 of 4 KV heads of 128, pages of 16, lengths up to 1024; the
    prefill a 256-row chunk at those heads.  Each held against its plain
    version, timed beside it, SDPA on the gathered KV and its bound, a
    row of its own in the kernels line whose launches are the serving
    part's."""
    row, (kp, vp, bt) = paged_decode_row(torch, dev, g, rnd, cpm, 16, 2,
                                         [17, 300, 700, 1024], "serve_tp")
    row.update(kernel="paged_decode", runs="serve_tp",
               shape="q (4,1,16,128), pools (257,16,2,128) bf16, lengths "
                     "17..1024")
    rows_out[f"paged_decode{TP}"] = row
    pre = paged_prefill_row(torch, dev, rnd, cpm, "serve_tp", 16, kp, vp,
                            bt[:1], ((0, 200), (256, 180)))
    pre.update(kernel="paged_prefill", runs="serve_tp",
               shape="q (1,256,16,128) at start 256, n_valid 180, page 16, "
                     "2 KV heads")
    rows_out[f"paged_prefill{TP}"] = pre


SEQMIX_TP = "_seqmix_tp"     # the kernels line's rows at seqmix_tp's shapes


def seqmix_tp_shapes(torch, dev, rows_out, cpm):
    """The kernels at the local shapes a rank of the tp phase's seqmix_tp
    part gives them, from a generator of their own: flash_fwd and
    flash_bwd at jamba's training attention on model 4 (2 x 4096, 8 of
    its 32 query heads over 2 of 8 KV heads of 128); rmsnorm at those
    rows' (8192, 4096); paged decode at a serving rank's jamba heads on
    (data 2, model 2) (a data shard's 4 of 8 slots, 16 query heads over
    4 KV heads, lengths up to 1024); moe_gemm at jamba's 4 local experts
    on model 4, two 4096-token groups' capacity (2 x 640 slots) x (4096
    -> 14336).  Each held against its plain version, timed beside its
    library call and bound, a row of its own in the kernels line whose
    launches are the seqmix_tp part's."""
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ref as moe_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.models.moe import _capacity

    g = torch.Generator(device=dev).manual_seed(3030)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    rows = flash_holds(torch, cpm, rnd, rows_out, 2, 4096, 8, 2, 128,
                       "jamba on model 4", plain=True)
    for name, row in rows.items():
        rows_out[f"{name}{SEQMIX_TP}"] = dict(row, kernel=name,
                                              runs="seqmix_tp")
    w = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    x = rnd(8192, 4096)
    e, ok = err_within(ops.rmsnorm(x, w), rn_ref.rmsnorm_ref(x, w), TOL)
    check(ok, "rmsnorm (8192, 4096) differs from the plain version")
    rows_out[f"rmsnorm{SEQMIX_TP}"] = dict(
        max_abs_err=e, kernel="rmsnorm", runs="seqmix_tp",
        ms=median_ms(cpm, lambda: ops.rmsnorm(x, w)),
        plain_ms=median_ms(cpm, lambda: rn_ref.rmsnorm_ref(x, w)),
        library_ms=median_ms(cpm, lambda: F.rms_norm(x, (4096,), w.to(bf),
                                                     1e-5)),
        bound=bound(2 * x.numel() * 2 + w.numel() * 4, 4 * x.numel()),
        shape="x (8192, 4096) bf16, w (4096,) f32")
    row, _ = paged_decode_row(torch, dev, g, rnd, cpm, 16, 4,
                              [77, 300, 545, 1024], "seqmix_tp")
    row.update(kernel="paged_decode", runs="seqmix_tp",
               shape="q (4,1,16,128), pools (257,16,4,128) bf16, lengths "
                     "77..1024")
    rows_out[f"paged_decode{SEQMIX_TP}"] = row
    c = 2 * _capacity(4096, registry.get("jamba-v0.1-52b").moe)
    xe, we = rnd(4, c, 4096), rnd(4, 4096, 14336, scale=0.02)
    got = moe_kernel.moe_gemm(xe, we)
    e, ok = err_within(got.float() * 4096 ** -0.5 / 0.02,
                       moe_ref.moe_gemm_ref(xe, we).float() * 4096 ** -0.5
                       / 0.02, TOL)
    check(ok, f"moe_gemm at (4, {c}, 4096) x (4, 4096, 14336) differs from "
          f"the plain version")
    row = moe_rate(torch, cpm, "seqmix_tp: jamba's 4 local experts", xe, we,
                   got)
    row.update(max_abs_err=e, kernel="moe_gemm", runs="seqmix_tp",
               plain_ms=median_ms(cpm, lambda: moe_ref.moe_gemm_ref(xe, we)),
               shape=f"x (4,{c},4096), w (4,4096,14336) bf16 (errors x "
                     f"1/(0.02 sqrt(4096)))")
    rows_out[f"moe_gemm{SEQMIX_TP}"] = row
    del x, xe, we, got


def moe_rate(torch, cpm, label, a, b, got):
    """The same bits again, then the grouped GEMM's kernel and torch.bmm
    timed on a @ b and printed beside the bound: (E, M, K) x (E, K, N)."""
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
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

    errs = []
    for label, T in (("decode", 8), ("legacy prefill", 160), ("train", 5120)):
        x, w = rnd(E, T, D), rnd(E, D, F_)
        got, want = moe_kernel.moe_gemm(x, w), moe_ref.moe_gemm_ref(x, w)
        e, ok = err_within(got.float() * D ** -0.5, want.float() * D ** -0.5,
                           TOL)
        check(ok, f"moe_gemm at T {T} differs from the plain version")
        errs.append(e)
        row = moe_rate(torch, cpm, label, x, w, got)
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
    moe_rate(torch, cpm, "backward dX = dY W^T", dy, w.transpose(1, 2),
             grads[0][0])
    moe_rate(torch, cpm, "backward dW = X^T dY", x.transpose(1, 2), dy,
             grads[0][1])
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


def serve_engine(cfg, params, dev, chunk, dp_shards=1, cuda_graphs=None):
    """The serve phase's engine: 8 slots of page-16 pools, prompts up to
    512 tokens, 1024 in all; chunked prefill when ``chunk``; the pool
    split into ``dp_shards`` shards.  ``cuda_graphs`` goes to the Engine
    only when given (None: the Engine's default, graphs on the card), so
    an older tree's Engine, which has no such argument, takes the call."""
    from repro_torch.serve import Engine, EngineConfig
    ecfg = EngineConfig(n_slots=8, page_size=16, max_prompt_len=512,
                        max_seq_len=1024, prefill_chunk=chunk,
                        dp_shards=dp_shards)
    kw = {} if cuda_graphs is None else {"cuda_graphs": cuda_graphs}
    return Engine(cfg, ecfg, params=params, device=dev, **kw)


def serve_run(torch, dev, cfg, params, chunk, prompts, build, dp_shards=1,
              report=None, cuda_graphs=None):
    """The prompts through ``serve_engine``, 32 new tokens each, with the
    host time of each tick by kind (decode, and mixed: every running
    slot's decode and a prompt chunk).  Returns the launch counts and
    the token streams.  With a ``report`` dict it also keeps each
    prefill's milliseconds by prompt length (a prefill ends when its
    sampled token reaches the host), the pool's bytes, the run's peak
    device memory and the engine's capture milliseconds."""
    eng = serve_engine(cfg, params, dev, chunk, dp_shards, cuda_graphs)
    if report is not None:
        run_prefill = eng._run_prefill

        def timed_prefill(req):
            t = time.perf_counter()
            run_prefill(req)
            report["prefill_ms"].append((len(req.prompt),
                                         (time.perf_counter() - t) * 1e3))

        eng._run_prefill = timed_prefill
        report.update(prefill_ms=[], pool_bytes=sum(
            x.numel() * x.element_size() for leaves in eng.pool.values()
            for x in leaves.values()))
        # the peaks from this engine alone: no block another run left
        # cached (a capture empties the cache, an eager run does not)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
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
    # an older tree's Engine captures nothing
    captures = (getattr(eng, "n_captures", 0), getattr(eng, "capture_ms", 0.0))
    if report is not None:
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        # a graph's pool stays reserved between replays
        report["peak_reserved"] = torch.cuda.max_memory_reserved()
        del eng._run_prefill        # the wrapper's cycle would keep eng
        report["mixed_ticks"] = eng.n_mixed_steps
        report["capture_ms"] = captures[1]
    for r in reqs:
        check(r.finished and len(r.tokens) == 32,
              f"request {r.rid} did not finish with 32 tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} has tokens outside the vocabulary")
    ttft = sorted(r.ttft * 1e3 for r in reqs)
    decode_ms.sort()
    mixed_ms.sort()
    n_tok = sum(len(r.tokens) for r in reqs)
    mode = (f"chunked({chunk})" if chunk else "legacy") + (
        f", {dp_shards} pool shards" if dp_shards > 1 else "") + (
        ", eager" if cuda_graphs is False else "")
    mixed = (f"; mixed tick median {mixed_ms[len(mixed_ms) // 2]:.2f} ms over "
             f"{len(mixed_ms)} ticks" if mixed_ms else "")
    print(f"[serve] {mode}: {len(reqs)} requests, {n_tok} tokens in "
          f"{elapsed:.3f} s = {n_tok / elapsed:.1f} tok/s; TTFT median "
          f"{ttft[len(ttft) // 2]:.1f} ms (min {ttft[0]:.1f}, max "
          f"{ttft[-1]:.1f}); decode tick median "
          f"{decode_ms[len(decode_ms) // 2]:.2f} ms over {len(decode_ms)} "
          f"ticks{mixed}; {captures[0]} graphs captured in "
          f"{captures[1]:.1f} ms; stats {eng.stats()}; launches {launches}")
    return launches, [r.tokens for r in reqs]


def eager_run(torch, dev, cfg, params, chunk, prompts, build, captured,
              report=None):
    """The prompts again through an engine with ``cuda_graphs=False``:
    its streams and launch counts must equal the ``captured`` run's
    (launches, streams), token for token and kernel for kernel."""
    launches, streams = serve_run(torch, dev, cfg, params, chunk, prompts,
                                  build, report=report, cuda_graphs=False)
    differ = [i for i, (a, b) in enumerate(zip(streams, captured[1]))
              if a != b]
    check(not differ, f"{cfg.name} chunk={chunk}: the eager streams differ "
          f"from the captured run's at requests {differ}")
    check(launches == captured[0], f"{cfg.name} chunk={chunk}: eager "
          f"launches {launches}, captured {captured[0]}")
    print(f"[serve] {cfg.name} {'chunked' if chunk else 'legacy'}: the "
          f"eager run's {len(streams)} streams and launch counts equal the "
          f"captured run's")


def prefill_hit_miss(torch, dev, cfg, params, prompt):
    """One prompt three times on one captured engine, each request alone
    with one new token: its length's miss (an eager prefill), its first
    hit (the capture, then a replay) and its second (a replay).  Returns
    the line that reports their milliseconds."""
    eng = serve_engine(cfg, params, dev, 0)
    out = []
    for what in ("miss, eager", "hit, capture and replay", "hit, replay"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        req = eng.submit(prompt, max_new_tokens=1)
        eng.run()
        out.append((what, round((time.perf_counter() - t) * 1e3, 2)))
        check(req.finished, "a prefill-only request did not finish")
    pc = eng.stats()["prefill_cache"]
    check((pc["misses"], pc["hits"]) == (1, 2) and eng.n_captures == 1,
          f"{cfg.name}: prefill cache {pc}, {eng.n_captures} captures "
          f"after one length three times")
    return (f"{len(prompt)} tokens, (prefill, ms) {out}; prefill cache "
            f"{pc}; {eng.n_captures} graph captured in "
            f"{eng.capture_ms:.1f} ms")


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


def park_run(torch, dev, cfg, params, prompts, want, build):
    """The legacy serve run again, parked after 5 decode ticks
    (``snapshot_state``: the pools to the host), adopted by a fresh
    engine of the same shapes and finished there.  The kernels give the
    same bits on the same inputs, so every stream must equal the
    uninterrupted run's ``want`` token for token.  Returns the launch
    counts of the run, both engines together."""
    eng = serve_engine(cfg, params, dev, 0)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    while eng.n_decode_steps < 5:
        check(eng.step(), "the engine ran out of work before it was parked")
    t = time.perf_counter()
    snap = eng.snapshot_state()
    del eng
    new = serve_engine(cfg, params, dev, 0)
    new.adopt_state(snap)
    torch.cuda.synchronize()
    t_park = time.perf_counter() - t
    running = len(snap["running"])
    waiting = len(snap["waiting"])
    pool_gb = sum(x.numel() * x.element_size() for kv in snap["pool"].values()
                  for x in kv.values()) / 1e9
    del snap
    new.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    differ = [i for i, (r, w) in enumerate(zip(reqs, want)) if r.tokens != w]
    check(all(r.finished for r in reqs), "a parked request did not finish")
    check(not differ, f"parked and adopted streams differ from the "
          f"uninterrupted run's at requests {differ}")
    print(f"[serve] parked after 5 decode ticks ({running} running, "
          f"{waiting} waiting; {pool_gb:.3f} GB of pools to the host and "
          f"back in {t_park:.2f} s), adopted by a fresh engine, finished: "
          f"all {len(reqs)} streams equal the uninterrupted legacy run's "
          f"token for token; {time.perf_counter() - t0:.2f} s in all; "
          f"launches {launches}")
    return launches


def legacy_gaps(torch, dev, cfg, params, prompts, got, legacy):
    """Where a stream of ``got`` first parts from the legacy engine's
    stream of the same prompt, the legacy run's own logits at that step
    (its arithmetic: ``Model.prefill`` right-padded, flash_fwd, then
    ``decode_step`` over the shared tokens, the split decode kernel; the
    engine's legacy run gives the same bits) must pick the legacy token,
    and the gap of ``got``'s token below their max is measured.  Returns
    the line that reports them."""
    from repro_torch.models.model import Model

    model, out = Model(cfg), []
    for prompt, a, b in zip(prompts, got, legacy):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            out.append((len(prompt), None, None))
            continue
        toks = torch.zeros((1, 1024), dtype=torch.long, device=dev)
        toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
        lg, cache = model.prefill(
            params, {"tokens": toks},
            last_index=torch.tensor([len(prompt) - 1], device=dev))
        for j, tok in enumerate(b[:i]):
            lg, cache = model.decode_step(
                params, cache, torch.tensor([[tok]], device=dev),
                len(prompt) + j)
        lg = lg[0].float()
        check(int(torch.argmax(lg)) == b[i], f"the legacy arithmetic does "
              f"not give the legacy token at step {i}")
        out.append((len(prompt), i, float(lg.max() - lg[a[i]])))
    worst = max([g for _, _, g in out if g is not None], default=0.0)
    return (f"(prompt length, first step where the streams part, the "
            f"token's logit gap below the legacy run's max there, or None) "
            f"{[(n, i, g if g is None else round(g, 5)) for n, i, g in out]}; "
            f"largest gap {worst:.5f} ({worst / STREAM_LOGIT_TOL:.2f}x "
            f"STREAM_LOGIT_TOL)")


def draw_biases(torch, dev, cfg, params, seed):
    """Overwrite the QKV biases, zeros from the seeded init (which test
    nothing), with normal(0, 0.02) values from a generator of their own
    (so no other draw moves)."""
    if not cfg.qkv_bias:
        return
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for pos in params["blocks"].values():
            for n in ("bq", "bk", "bv"):
                b = pos["attn"][n]
                b.copy_(torch.randn(b.shape, generator=g, device=dev) * 0.02)


def _rel_steps(got, a, b):
    """The relative L2 error of ``got[a]`` against ``got[b]`` at each
    teacher-forced step (a row of logits each)."""
    return [round(float(x), 5) for x in
            (got[a] - got[b]).norm(dim=-1) / got[b].norm(dim=-1)]


FORCED_PLEN, FORCED_CHUNK = 200, 256


def forced_logits(torch, dev, cfg, params, impl=None, dtype=None, pool=None):
    """The teacher-forced logits rows (6, V) of one prompt of FORCED_PLEN
    tokens (seed 7): its prefill's last row (flash_fwd), the same prompt
    as one chunk into the pool's pages (paged_prefill), then 4 forced
    decode steps (paged_decode); in ``dtype`` (bf16 by default) through
    ``impl``'s kernels.  ``pool``: a one-slot page pool of 65 pages (a
    rank's shard of one on a mesh of ranks, whose context the caller
    enters; the rows are then this rank's vocabulary columns)."""
    import numpy as np
    from repro_torch.models.layers import PagedView
    from repro_torch.models.model import Model
    from repro_torch.serve import paging

    dtype = torch.bfloat16 if dtype is None else dtype
    rng = np.random.default_rng(7)
    plen, chunk = FORCED_PLEN, FORCED_CHUNK
    toks = rng.integers(0, cfg.vocab_size, plen + 4)
    if pool is None:
        pool = paging.init_pool(cfg, 1, forced_layout(), dev)
    bt = torch.arange(1, 65, dtype=torch.int32, device=dev)[None]
    i32 = dict(dtype=torch.int32, device=dev)
    model = Model(cfg, impl=impl)
    prompt = torch.tensor(toks[None, :plen], device=dev)
    lg, _ = model.prefill(params, {"tokens": prompt},
                          compute_dtype=dtype)               # flash_fwd
    logits = [lg]
    c = torch.zeros((1, chunk), dtype=torch.long, device=dev)
    c[0, :plen] = prompt[0]
    lc, _ = model.prefill_chunk(params, pool, c, PagedView(
        bt, torch.tensor([0], **i32), n_valid=torch.tensor([plen], **i32),
        null_page=0), compute_dtype=dtype)                    # paged_prefill
    logits.append(lc[:, plen - 1])
    for i in range(4):                                        # paged_decode
        pos = torch.tensor([plen + i], **i32)
        ld, _ = model.decode_step(
            params, pool, torch.tensor([[toks[plen + i]]], device=dev),
            pos, compute_dtype=dtype, paging=PagedView(bt, pos))
        logits.append(ld)
    return torch.cat(logits).float()


def forced_layout():
    from repro_torch.serve import paging
    return paging.PagedLayout(page_size=16, pages_per_slot=64, n_pages=65)


def teacher_force(torch, dev, cfg, params):
    """One prompt, then 4 forced decode steps, through the kernels in bf16,
    the plain versions in bf16 and the plain versions in float32."""
    got = {name: forced_logits(torch, dev, cfg, params, impl, dtype)
           for name, impl, dtype in (("kernels", None, torch.bfloat16),
                                     ("plain", "ref", torch.bfloat16),
                                     ("plain_f32", "ref", torch.float32))}

    k_p, k_f, p_f = (_rel_steps(got, "kernels", "plain"),
                     _rel_steps(got, "kernels", "plain_f32"),
                     _rel_steps(got, "plain", "plain_f32"))
    print(f"[serve] teacher-forced logits (prefill, chunk, 4 decode steps), "
          f"relative L2 error per step: kernels vs plain {k_p}; kernels vs "
          f"f32 {k_f}; plain vs f32 {p_f}; logit scale "
          f"{float(got['plain_f32'].abs().max()):.3g}")
    check(max(k_f) <= LOGIT_NOISE_FACTOR * max(p_f),
          f"kernel path drifts from f32 by {max(k_f)}, plain bf16 by "
          f"{max(p_f)}")


# ---------------------------------------------------------------------------
# phase 4b: the sequence mixers, xlstm-1.3b and jamba-v0.1-52b, served
# ---------------------------------------------------------------------------

JAMBA_LAYERS = 16           # of jamba's 32: 26.05e9 params, 52.1 GB in bf16
# the f32 check's jamba: the attention position and one Mamba position at
# a MoE index (pattern index 1), at full width
JAMBA_F32_PATTERN = ("attn", "mamba")


def seqmix_teacher_force(torch, dev, cfg, params, modes, plen=77,
                         mesh=None, strategy=None):
    """One prompt of ``plen`` tokens (77: no multiple of a page or of the
    kernels' 64-row tiles) prefilled at its exact length, its KV padded
    to a page boundary and scattered with its state into slot 0 of a
    pool, then 4 forced decode steps, through each of ``modes`` (name,
    impl, compute dtype).  Returns {name: logits (5, V) float32}.  On a
    ``mesh`` of ranks (whose context the caller enters) the pool is the
    rank's shard of one and the rows are its vocabulary columns."""
    import numpy as np
    from repro_torch.models.layers import PagedView
    from repro_torch.models.model import Model
    from repro_torch.serve import paging

    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, plen + 4)
    layout = paging.PagedLayout(page_size=16, pages_per_slot=64, n_pages=65)
    bt = torch.arange(1, 65, dtype=torch.int32, device=dev)[None]
    cap = paging.round_up(plen, 16)
    got = {}
    for name, impl, dtype in modes:
        model = Model(cfg, impl=impl)
        pool = paging.init_pool(cfg, 1, layout, dev, mesh=mesh,
                                strategy=strategy)
        lg, pc = model.prefill(
            params, {"tokens": torch.tensor(toks[None, :plen], device=dev)},
            compute_dtype=dtype)                             # flash_fwd
        paging.scatter_prefill(cfg, pool, paging.pad_prefill_cache(
            cfg, pc, cap), bt[:, :cap // 16], torch.tensor([0], device=dev))
        del pc
        logits = [lg]
        for i in range(4):                                   # paged_decode
            pos = torch.tensor([plen + i], dtype=torch.int32, device=dev)
            ld, _ = model.decode_step(
                params, pool, torch.tensor([[toks[plen + i]]], device=dev),
                pos, compute_dtype=dtype, paging=PagedView(bt, pos))
            logits.append(ld)
        got[name] = torch.cat(logits).float()
        del pool
    return got


def seqmix_phase(torch, dev, build):
    """xlstm-1.3b at full size and jamba-v0.1-52b at full width and
    JAMBA_LAYERS of its 32 layers through the serve cell's engine (8
    slots, page 16, prompts up to 512, 1024 in all), both exact-length
    prefill: 12 greedy prompts of 64-512 tokens (jamba's first cut to
    77), 32 new, with every plain version refused; then
    ``prefill_chunk=256`` (no chunked tick on these arches: the same
    streams), and the legacy run parked after 5 decode ticks and adopted
    (token for token).  Prefill ms by prompt length, pool bytes and peak
    memory beside the serve lines.  Then teacher-forced logits (a
    77-token prompt and 4 decode steps): xlstm through the kernels, the
    plain versions in bf16 and in float32 at full depth; jamba through
    the kernels and plain bf16 at the served depth, and all three on a
    2-layer jamba of JAMBA_F32_PATTERN (one float32 copy of 16 layers'
    weights would not fit).  Returns the launch counts of the runs."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    held_before = torch.cuda.memory_allocated()
    runs, f32_drift = [], {}
    modes3 = (("kernels", None, torch.bfloat16),
              ("plain", "ref", torch.bfloat16),
              ("plain_f32", "ref", torch.float32))
    for arch in ("xlstm-1.3b", "jamba-v0.1-52b"):
        t_arch = time.perf_counter()
        cfg = registry.get(arch)
        depth = f"{cfg.n_layers} layers"
        if arch.startswith("jamba"):
            depth = (f"{JAMBA_LAYERS} of {cfg.n_layers} layers (cut: all 32 "
                     f"need 103 GB of bf16 weights)")
            # the f32 check first, on its own 2-layer draw
            small = dataclasses.replace(cfg, n_layers=2,
                                        block_pattern=JAMBA_F32_PATTERN)
            p2 = Model(small).init(torch.Generator(device=dev).manual_seed(1),
                                   dtype=torch.bfloat16, device=dev)
            got = seqmix_teacher_force(torch, dev, small, p2, modes3)
            del p2
            torch.cuda.empty_cache()
            k_f, p_f = (_rel_steps(got, "kernels", "plain_f32"),
                        _rel_steps(got, "plain", "plain_f32"))
            print(f"[seqmix] jamba 2 layers {JAMBA_F32_PATTERN} (the Mamba "
                  f"at a MoE index), teacher-forced logits (77-token "
                  f"prefill, 4 decode steps), relative L2 per step: kernels "
                  f"vs f32 {k_f}; plain vs f32 {p_f}")
            check(max(k_f) <= LOGIT_NOISE_FACTOR * max(p_f),
                  f"jamba 2 layers: the kernel path drifts from f32 by "
                  f"{max(k_f)}, plain bf16 by {max(p_f)}")
            f32_drift[arch] = max(p_f)
            cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        print(f"[seqmix] {cfg.name}: {depth}, d_model {cfg.d_model}, "
              f"pattern {cfg.block_pattern}, "
              f"{Model(cfg).n_params() / 1e9:.2f} B params in bf16, drawn "
              f"in {time.perf_counter() - t_arch:.1f} s")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(64, 513, 12)]
        if arch.startswith("jamba"):
            prompts[0] = prompts[0][:77]
        check(any(len(p) % 16 for p in prompts),
              "no prompt off a page multiple")
        report, c_report, e_report = {}, {}, {}
        with _NoPlain():
            legacy, streams = serve_run(torch, dev, cfg, params, 0, prompts,
                                        build, report=report)
            chunked, c_streams = serve_run(torch, dev, cfg, params, 256,
                                           prompts, build, report=c_report)
            eager_run(torch, dev, cfg, params, 0, prompts, build,
                      (legacy, streams), report=e_report)
            print(f"[seqmix] {cfg.name} one prompt length prefilled "
                  f"three times: " + prefill_hit_miss(
                      torch, dev, cfg, params, min(prompts, key=len)))
        check(c_report["mixed_ticks"] == 0 and c_streams == streams,
              f"{arch}: the prefill_chunk=256 engine ran "
              f"{c_report['mixed_ticks']} mixed ticks or its streams differ "
              f"from the legacy engine's")
        by_len = sorted(report["prefill_ms"])
        print(f"[seqmix] {cfg.name} exact-length prefill, (prompt length, "
              f"ms) {[(n, round(ms, 2)) for n, ms in by_len]}; eager "
              f"{[(n, round(ms, 2)) for n, ms in sorted(e_report['prefill_ms'])]}; "
              f"pool {report['pool_bytes'] / 1e9:.3f} GB; peak device "
              f"memory {report['peak_bytes'] / 1e9:.2f} GB allocated, "
              f"{report['peak_reserved'] / 1e9:.2f} GB reserved with graphs "
              f"({report['capture_ms']:.1f} ms of captures), "
              f"{e_report['peak_bytes'] / 1e9:.2f} and "
              f"{e_report['peak_reserved'] / 1e9:.2f} GB eager; "
              f"prefill_chunk=256: 0 "
              f"mixed ticks, all {len(streams)} streams equal the legacy "
              f"run's token for token")
        with _NoPlain():
            parked = park_run(torch, dev, cfg, params, prompts, streams, build)
        runs += [legacy, chunked, parked]
        for name in ("rmsnorm",) + (("flash_fwd", "paged_decode", "moe_gemm")
                                    if arch.startswith("jamba") else ()):
            for label, launches in (("legacy", legacy), ("chunked", chunked),
                                    ("parked", parked)):
                check(launches[name] > 0, f"{arch} {label} serve never "
                      f"launched {name}")
        if arch.startswith("jamba"):
            got = seqmix_teacher_force(torch, dev, cfg, params, modes3[:2])
            k_p = _rel_steps(got, "kernels", "plain")
            # a loose model-level check on an assumed rule (bf16 noise
            # grows at most linearly with depth); the tight ones are the
            # kernels phase's holds at jamba's shapes (seqmix_shapes)
            limit = (LOGIT_NOISE_FACTOR * JAMBA_LAYERS / 2
                     * f32_drift[arch])
            print(f"[seqmix] {cfg.name} {JAMBA_LAYERS} layers, teacher-"
                  f"forced logits, relative L2 per step: kernels vs plain "
                  f"{k_p} (limit {limit:.5f} = {LOGIT_NOISE_FACTOR} x "
                  f"{JAMBA_LAYERS}/2 x the 2-layer plain-vs-f32 drift); "
                  f"logit scale {float(got['plain'].abs().max()):.3g}")
            check(max(k_p) <= limit, f"jamba {JAMBA_LAYERS} layers: kernels "
                  f"vs plain bf16 {max(k_p)} over {limit}")
        else:
            got = seqmix_teacher_force(torch, dev, cfg, params, modes3)
            k_p, k_f, p_f = (_rel_steps(got, "kernels", "plain"),
                             _rel_steps(got, "kernels", "plain_f32"),
                             _rel_steps(got, "plain", "plain_f32"))
            print(f"[seqmix] {cfg.name} teacher-forced logits (77-token "
                  f"prefill, 4 decode steps), relative L2 per step: kernels "
                  f"vs plain {k_p} (tol {FWD_REL_L2_TOL}); kernels vs f32 "
                  f"{k_f}; plain vs f32 {p_f}; logit scale "
                  f"{float(got['plain_f32'].abs().max()):.3g}")
            # rmsnorm is xlstm's only kernel, so the two bf16 paths differ
            # by its rounding alone; the f32 ratio below is far looser
            check(max(k_p) <= FWD_REL_L2_TOL,
                  f"xlstm: kernels vs plain bf16 {max(k_p)} over "
                  f"{FWD_REL_L2_TOL}")
            check(max(k_f) <= LOGIT_NOISE_FACTOR * max(p_f),
                  f"xlstm: the kernel path drifts from f32 by {max(k_f)}, "
                  f"plain bf16 by {max(p_f)}")
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - held_before
        check(held < 1e8, f"{arch}: {held / 1e9:.2f} GB still held after "
              f"its runs")
        print(f"[seqmix] {cfg.name}: {time.perf_counter() - t_arch:.1f} s")
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    print(f"[seqmix] launches in the phase's runs: "
          + ", ".join(f"{k} {n}" for k, n in total.items() if n)
          + f"; no plain version ran in them; "
          f"{time.perf_counter() - t_phase:.1f} s")
    for k in ("rmsnorm", "flash_fwd", "paged_decode", "moe_gemm"):
        check(total[k] > 0, f"the seqmix phase never launched {k}")
    return runs


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


def grad_check(torch, dev, arch, pattern=None, seq=4096):
    """``arch`` at full width and 2 layers (of ``pattern`` where given),
    one batch of 2 x ``seq`` tokens: gradients through the kernels (bf16), the plain
    versions (bf16) and the plain versions (float32).  The kernel path
    must be as close to float32 as the plain bf16 path is, within
    LOGIT_NOISE_FACTOR, in every group.  Each bf16 set is compared as it
    comes and dropped, so at most two sets are held."""
    import dataclasses

    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.data import synthetic_batch, to_tensors
    from repro_torch.dist.steps import init_train_state
    from repro_torch.models import params as P
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(registry.get(arch), n_layers=2)
    if pattern is not None:
        cfg = dataclasses.replace(cfg, block_pattern=pattern)
    params = init_train_state(cfg, TrainConfig(), device=dev)["params"]
    draw_biases(torch, dev, cfg, params, seed=12)
    batch = to_tensors(synthetic_batch(
        cfg, WorkloadShape("chip", "train", seq, 2)), dev)
    leaves = P.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    f32, rel = None, {}
    for name, impl, dtype in (("plain_f32", "ref", torch.float32),
                              ("plain", "ref", torch.bfloat16),
                              ("kernels", None, torch.bfloat16)):
        t = time.perf_counter()
        loss, _ = Model(cfg, impl=impl).loss(params, batch, remat=True,
                                             compute_dtype=dtype)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        print(f"[train] grad check: {name} loss "
              f"{round(float(loss.detach()), 5)} in "
              f"{time.perf_counter() - t:.2f} s")
        del loss
        if f32 is None:
            f32 = grads
        else:
            rel[name] = _rel_by_group(params, grads, f32)
        del grads
    k_f, p_f = rel["kernels"], rel["plain"]
    print(f"[train] grad check ({cfg.name} at 2 layers"
          f"{'' if pattern is None else f' {pattern}'}, batch 2 x {seq}), "
          f"relative L2 error per group: kernels vs f32 {k_f}; plain bf16 "
          f"vs f32 {p_f}")
    for group in k_f:
        check(k_f[group] <= LOGIT_NOISE_FACTOR * p_f[group],
              f"kernel-path gradients of {group} drift from f32 by "
              f"{k_f[group]}, plain bf16 by {p_f[group]}")
    del f32, params, leaves
    gc.collect()
    torch.cuda.empty_cache()


def step_table(prof, step_s, tag="train", spans=(), kernels=()):
    """Device time of one traced train step by kernel, and the share of
    the step's host-clock time in which the card ran none (one stream,
    so kernels do not overlap).  Only device rows count: an operator row
    (``aten::mm``, the ``FlashAttention`` Function) repeats the time of
    the kernels it launched, a user annotation on the device (gloo's
    ``gloo:all_gather`` around its copies) the time of what it spans,
    and CUPTI's "Command Buffer Full" records a full launch queue, not
    device work.  Then the share of the busy time of each of ``spans``
    (operators by their exact name, an autograd Function's
    ``SelectiveScan`` and ``SelectiveScanBackward``: the kernels launched
    inside them) and of ``kernels`` (device rows whose name holds the
    word).  Returns the busy seconds and the shares."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    averages = prof.key_averages()
    rows = sorted((e for e in averages
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
    def inside_us(e):
        return (sum(k.duration for k in e.kernels)
                + sum(inside_us(c) for c in e.cpu_children))

    shares = []
    for name in spans:
        hit = [e for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name == name]
        shares.append((name, sum(inside_us(e) for e in hit), len(hit)))
    for word in kernels:
        hit = [e for e in rows if word in e.key]
        shares.append((word, sum(dev_us(e) for e in hit),
                       sum(e.count for e in hit)))
    if shares:
        print(f"[{tag}] shares of the busy time: " + "; ".join(
            f"{name} {us / 1e3:.2f} ms {100 * us / 1e6 / busy:.1f}% "
            f"({n} calls)" for name, us, n in shares))
    return busy, {name: us / 1e6 / busy for name, us, _ in shares}


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
    _check_launches("granite train", launches, {
        "moe_gemm": 12 * L * steps, "flash_fwd": 2 * L * steps,
        "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
        "rmsnorm": (2 * 2 * L + 1) * steps})
    del tr, prof
    torch.cuda.empty_cache()
    return launches


class _TimedOptimizer:
    """Within the block, a train step that ``dist.steps`` builds times its
    optimizer update with CUDA events, a synchronize before it, so the
    events hold the update alone: ``ms``, one time a step, for as long as
    the step lives.  Timed so because a named range around the update in
    a trace taken late in this script read about 2.5x what the events
    give, more than the busy time the step had left."""

    def __enter__(self):
        import torch
        from repro_torch.dist import steps
        self.steps, self.real, self.ms = steps, steps.make_optimizer, []

        def make(cfg, tcfg):
            update = self.real(cfg, tcfg)

            def timed(*a, **k):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = update(*a, **k)
                end.record()
                end.synchronize()
                self.ms.append(start.elapsed_time(end))
                return out
            return timed

        steps.make_optimizer = make
        return self

    def __exit__(self, *exc):
        self.steps.make_optimizer = self.real


def train_and_resume(torch, dev, build, cfg, shape, heading, spans=(),
                     kernels=(), steps=4, resume=True):
    """``cfg`` trained ``steps`` steps of ``shape`` through the Trainer
    (AdamW, float32 master weights, bf16 compute, remat), the last traced
    (``step_table`` with ``spans`` and ``kernels``); with ``resume`` (and
    4 steps) a checkpoint at step 2 (its save timed), then a fresh
    Trainer restored from the checkpoint and stepped on to 4: its losses
    against the uninterrupted run's (RESUME_RTOL).  The uninterrupted
    run's optimizer updates are timed (``_TimedOptimizer``).
    ``heading`` says what was cut and why.  Returns
    (launch counts of the uninterrupted run, its history, peak device
    memory in GB, the traced step's shares with the optimizer's among
    them)."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig
    from repro_torch.models.model import Model
    from repro_torch.train import Trainer

    tcfg = TrainConfig()
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    with _TimedOptimizer() as opt:
        tr = Trainer(cfg, tcfg, shape,
                     ckpt_dir=str(ckpt_dir) if resume else None, seed=0,
                     device=dev)
    t = time.perf_counter()
    tr.init_or_resume()
    torch.cuda.synchronize()
    print(f"[train] {heading}: {Model(cfg).n_params() / 1e9:.3f} B params, "
          f"float32 with AdamW state, drawn in {time.perf_counter() - t:.1f} "
          f"s; batch {shape.global_batch} x {shape.seq_len}, {tcfg}")
    check(not resume or steps == 4, "a resumed run takes 4 steps")
    build.reset_launches()
    t = time.perf_counter()
    if resume:
        tr.run(2, ckpt_every=2, log_every=0)
        t_save = time.perf_counter()
        tr.run(1, log_every=0)
    else:
        tr.run(steps - 1, log_every=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(1, log_every=0)                   # the last step, traced
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_history(tr.history)
    saved = ""
    if resume:
        save_s = t_save - t - sum(h["step_time_s"] for h in tr.history[:2])
        saved = (f" and one checkpoint (the save at step 2, {save_s:.1f} s "
                 f"of it, host copy and npz write)")
    print(f"[train] {steps} steps{saved} in {time.perf_counter() - t:.1f} s; "
          f"peak device memory {peak:.2f} GB; launches {launches}")
    busy, shares = step_table(prof, tr.history[-1]["step_time_s"],
                              spans=spans, kernels=kernels)
    shares["optimizer"] = opt.ms[-1] / 1e3 / busy
    print(f"[train] the optimizer's update (CUDA events, steps 0-"
          f"{steps - 1}): "
          f"{[round(ms, 2) for ms in opt.ms]} ms, the traced step's "
          f"{100 * shares['optimizer']:.1f}% of its busy time")

    ref = tr.history
    del tr, prof
    gc.collect()
    torch.cuda.empty_cache()
    if not resume:
        return launches, ref, peak, shares
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
    return launches, ref, peak, shares


# one-rank histories the tp phase holds its sharded runs against
ONE_RANK = {}


def _check_launches(label, launches, want):
    for name, n in want.items():
        check(launches[name] == n, f"{label} launched {name} "
              f"{launches[name]} times, expected {n}")


def train_phase(torch, dev, build):
    """yi-6b at full width and YI_TRAIN_LAYERS of 32 layers, 4 steps of
    2 x 4096 tokens
    through ``train_and_resume``.  Returns the launch counts of the
    uninterrupted run."""
    from repro_torch.configs import WorkloadShape, yi_6b

    cfg = dataclasses.replace(yi_6b.CONFIG, n_layers=YI_TRAIN_LAYERS)
    launches, ONE_RANK["yi-6b"] = train_and_resume(
        torch, dev, build, cfg, WorkloadShape("chip", "train", 4096, 2),
        f"{cfg.name} at {cfg.n_layers} of 32 layers, d_model "
        f"{cfg.d_model}")[:2]
    L, steps = cfg.n_layers, 4
    # each forward runs twice under remat
    _check_launches("train", launches, {
        "flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
        "flash_bwd_dkv": L * steps, "rmsnorm": (2 * 2 * L + 1) * steps})
    return launches


# the seqmix_train phase's cuts.  jamba at 2 layers of JAMBA_F32_PATTERN:
# the attention position, one Mamba block and one MoE FFN, every kernel
# jamba trains through (3.68e9 params, ~59 GB of float32 weights,
# gradients and AdamW moments); in the natural order the attention
# position is the 5th layer (7.2e9 params, ~115 GB).  xlstm at one whole
# 7 mLSTM : 1 sLSTM super-block of its 48 layers, for time: the sLSTM
# recurrence is the host's loop (a step about a minute at 48 layers); and
# at 2 x XLSTM_SEQ tokens: at 2 x 4096 its step took 20-26 s on an H100,
# and reading the trace of one step about 400 s more; 512 before the tp
# phase's seqmix_tp part took the script past 1200 s on slower hosts (the
# trace of a 512-token step took ~80 s to read there).
XLSTM_TRAIN_LAYERS = 8
XLSTM_SEQ = 256
SEQMIX_SPANS = ("SelectiveScan", "SelectiveScanBackward")
SEQMIX_KERNELS = ("flash_fwd", "flash_bwd", "moe_gemm", "rmsnorm")


def seqmix_train_phase(torch, dev, build):
    """The sequence mixers trained on the card with every plain version
    refused: the gradient checks (``grad_check``) of a 2-layer jamba of
    JAMBA_F32_PATTERN and a 2-layer ("mlstm", "slstm") xlstm; then
    jamba-v0.1-52b at full width and 2 layers (JAMBA_F32_PATTERN) and
    xlstm-1.3b at full width and XLSTM_TRAIN_LAYERS of 48, each 4 steps
    of 2 rows (``train_4k``'s batch cut to 2; xlstm's rows cut to
    XLSTM_SEQ tokens, jamba's 4096) through ``train_and_resume``, the
    traced step's shares of the Mamba scan's forward and backward,
    flash_bwd, moe_gemm and the optimizer printed.  Returns the launch counts of the two runs."""
    from repro_torch.configs import WorkloadShape, registry

    t_phase = time.perf_counter()
    grad_check(torch, dev, "jamba-v0.1-52b", JAMBA_F32_PATTERN)
    grad_check(torch, dev, "xlstm-1.3b", ("mlstm", "slstm"), XLSTM_SEQ)
    runs = []
    jamba = dataclasses.replace(registry.get("jamba-v0.1-52b"), n_layers=2,
                                block_pattern=JAMBA_F32_PATTERN)
    xlstm = dataclasses.replace(registry.get("xlstm-1.3b"),
                                n_layers=XLSTM_TRAIN_LAYERS)
    for cfg, seq, heading, want in (
            (jamba, 4096, f"{jamba.name} at full width (d_model {jamba.d_model}), "
             f"2 of 32 layers, pattern {JAMBA_F32_PATTERN} (cut: every "
             f"kernel jamba trains through; reaching the attention position "
             f"in the natural order takes 5 layers, 7.2e9 params, ~115 GB "
             f"of float32 state)",
             # per step: rmsnorm 2 a layer a forward (twice under remat)
             # and the final norm; moe_gemm 3 forward, 3 again, 6 backward
             {"rmsnorm": 9 * 4, "flash_fwd": 2 * 4, "flash_bwd_dq": 4,
              "flash_bwd_dkv": 4, "moe_gemm": 12 * 4}),
            (xlstm, XLSTM_SEQ,
             f"{xlstm.name} at full width (d_model {xlstm.d_model}), "
             f"{XLSTM_TRAIN_LAYERS} of 48 layers, one 7 mLSTM : 1 sLSTM "
             f"super-block, {XLSTM_SEQ}-token rows (cut for time: the "
             f"sLSTM steps and the mLSTM chunks are the host's loops)",
             {"rmsnorm": (2 * XLSTM_TRAIN_LAYERS + 1) * 4})):
        t = time.perf_counter()
        shape = WorkloadShape("chip", "train", seq, 2)
        with _NoPlain():
            launches, hist, peak, shares = train_and_resume(
                torch, dev, build, cfg, shape, heading, SEQMIX_SPANS,
                SEQMIX_KERNELS)
        _check_launches(f"{cfg.name} train", launches, want)
        steps_ms = [round(h["step_time_s"] * 1e3, 1) for h in hist]
        best = min(h["step_time_s"] for h in hist[1:])
        scan = ""
        if "mamba" in cfg.block_pattern:
            share = shares["SelectiveScan"] + shares["SelectiveScanBackward"]
            scan = (f"; the Mamba scan {100 * share:.1f}% of the traced "
                    f"step's busy time")
        print(f"[seqmix_train] {cfg.name}: step ms {steps_ms} (the last "
              f"traced), {shape.global_batch * shape.seq_len / best:.0f} "
              f"tokens/s at the fastest; peak {peak:.2f} GB{scan}; "
              f"{time.perf_counter() - t:.1f} s")
        runs.append(launches)
    print(f"[seqmix_train] no plain version ran in the trains; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 5c: the encoder-decoder, whisper-base, served and trained
# ---------------------------------------------------------------------------

ENC_ROWS = 8                # rows served together
ENC_FRAMES = 1500           # whisper's 30 s window after the stride-2 stem
ENC_NEW = 128               # greedy tokens a row
ENC_CAP = 256               # the contiguous cache: 64 prompt + 128 new fit


def whisper_serve(torch, dev, cfg, params, build):
    """ENC_ROWS rows of ENC_FRAMES frames and decoder prompts of 4-64
    tokens through ``Model.prefill`` (the encoder, its cross KV into the
    cache, the decoder over the shortest prompt) and contiguous
    ``decode_step``s at one scalar index for every row: a row whose
    prompt is longer takes its own next prompt token (teacher-forced)
    until its prompt is in, then its greedy choice; ENC_NEW greedy tokens
    a row.  The prefill, then the encoder alone, timed three times each
    (medians); every decode step on the device clock.  Returns the launch
    counts of the run."""
    import numpy as np
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    model = Model(cfg)
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 65, ENC_ROWS)
    lens[:2] = (4, 64)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ENC_ROWS, 64))
                               ).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randn((ENC_ROWS, ENC_FRAMES, cfg.d_model), generator=g,
                         device=dev) * 0.02
    p0 = int(lens.min())
    toks = torch.zeros((ENC_ROWS, ENC_CAP), dtype=torch.long, device=dev)
    toks[:, :p0] = prompts[:, :p0]
    batch = {"tokens": toks, "frames": frames}
    last = torch.full((ENC_ROWS,), p0 - 1, device=dev)
    lens_t = torch.from_numpy(lens).to(dev)
    torch.cuda.synchronize()
    build.reset_launches()
    with _NoPlain():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, last_index=last)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        out, steps = [], int(lens.max()) - p0 + ENC_NEW - 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        for pos in range(p0, p0 + steps + 1):
            nxt = torch.argmax(logits.float(), dim=-1)
            nxt = torch.where(pos < lens_t, prompts[:, min(pos, 63)], nxt)
            out.append(nxt)
            if pos < p0 + steps:
                logits, cache = model.decode_step(params, cache, nxt[:, None],
                                                  pos)
        end.record()
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t1
        launches = dict(build.LAUNCHES)

        def prefill():
            model.prefill(params, batch, last_index=last)

        def encoder():
            transformer.encoder_apply(cfg, params["encoder"],
                                      frames.to(torch.bfloat16),
                                      mode="prefill")
        t_pre, t_enc = [], []
        for fn, ts in ((prefill, t_pre), (encoder, t_enc)) * 3:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
    t_pre, t_enc = sorted(t_pre)[1], sorted(t_enc)[1]
    seq = torch.stack(out, dim=1).cpu()                  # (rows, p0 + steps)
    gen = [seq[b, int(lens[b]) - p0:int(lens[b]) - p0 + ENC_NEW].tolist()
           for b in range(ENC_ROWS)]
    check(all(len(x) == ENC_NEW for x in gen), "a row has too few tokens")
    check(all(0 <= t < cfg.vocab_size for x in gen for t in x),
          "whisper's streams have tokens outside the vocabulary")
    for b in range(ENC_ROWS):          # the forced tokens are the prompt's
        n = int(lens[b]) - p0
        check(seq[b, :n].tolist() == prompts[b, p0:p0 + n].tolist(),
              f"row {b} did not take its own prompt tokens")
    tick = start.elapsed_time(end) / steps
    n_gen = ENC_ROWS * ENC_NEW
    print(f"[encdec] served {ENC_ROWS} rows x {ENC_FRAMES} frames, prompts "
          f"of {sorted(lens.tolist())} tokens, {ENC_NEW} greedy tokens a "
          f"row: prefill (the encoder, its cross KV, the decoder over "
          f"{p0} tokens padded to {ENC_CAP}) {t_first * 1e3:.2f} ms first, "
          f"median {t_pre:.2f} ms of 3, the encoder alone {t_enc:.2f} ms "
          f"({100 * t_enc / t_pre:.1f}% of it); {steps} decode steps "
          f"(the longer prompts' tokens forced) in {t_decode:.3f} s, a "
          f"tick {tick:.3f} ms on the device clock, "
          f"{t_decode / steps * 1e3:.3f} ms on the host's; "
          f"{n_gen / (t_first + t_decode):.1f} generated tokens/s "
          f"({n_gen} tokens, prefill and decode); launches {launches}")
    L, Le = cfg.n_layers, cfg.encoder_layers
    # the prefill: the encoder's self-attention, the decoder's and its
    # cross-attention; a step: the cross-attention over the frames
    _check_launches("whisper serve", launches, {
        "flash_fwd": Le + 2 * L + L * steps, "decode_attention": L * steps,
        "rmsnorm": 0, "paged_decode": 0, "paged_prefill": 0})
    return launches


def encdec_teacher_force(torch, dev, cfg, params):
    """2 rows of ENC_FRAMES frames and a 16-token prompt, then 4 forced
    decode steps (contiguous), through the kernels in bf16, the plain
    versions in bf16 and the plain versions in float32: the kernel path
    must stay as close to float32 as the plain bf16 path is
    (LOGIT_NOISE_FACTOR)."""
    import numpy as np
    from repro_torch.models.model import Model

    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20))).to(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randn((2, ENC_FRAMES, cfg.d_model), generator=g,
                         device=dev) * 0.02
    pad = torch.zeros((2, 32), dtype=torch.long, device=dev)
    pad[:, :16] = toks[:, :16]
    got = {}
    for name, impl, dtype in (("kernels", None, torch.bfloat16),
                              ("plain", "ref", torch.bfloat16),
                              ("plain_f32", "ref", torch.float32)):
        model = Model(cfg, impl=impl)
        lg, cache = model.prefill(params, {"tokens": pad, "frames": frames},
                                  compute_dtype=dtype,
                                  last_index=torch.full((2,), 15, device=dev))
        logits = [lg]
        for i in range(4):
            lg, cache = model.decode_step(params, cache, toks[:, 16 + i:17 + i],
                                          16 + i, compute_dtype=dtype)
            logits.append(lg)
        got[name] = torch.cat(logits).float()
    k_p, k_f, p_f = (_rel_steps(got, "kernels", "plain"),
                     _rel_steps(got, "kernels", "plain_f32"),
                     _rel_steps(got, "plain", "plain_f32"))
    print(f"[encdec] teacher-forced logits (prefill, 4 decode steps; 2 rows "
          f"of {ENC_FRAMES} frames), relative L2 per step and row: kernels vs "
          f"plain {k_p}; kernels vs f32 {k_f}; plain vs f32 {p_f}; logit "
          f"scale {float(got['plain_f32'].abs().max()):.3g}")
    check(max(k_f) <= LOGIT_NOISE_FACTOR * max(p_f),
          f"whisper: the kernel path drifts from f32 by {max(k_f)}, plain "
          f"bf16 by {max(p_f)}")


def encdec_phase(torch, dev, build):
    """whisper-base at full size (6 encoder and 6 decoder layers, d 512,
    8 heads of 64, vocab 51865): served (``whisper_serve``) with every
    plain version refused, held against the plain path by
    ``encdec_teacher_force``, then trained: ``train_4k`` at batch 2 (2 x
    4096 tokens, 2048 frames a row) through ``train_and_resume`` (4
    steps, a checkpoint at step 2, resumed).  Returns the launch counts
    of the serve and train runs."""
    from repro_torch.configs import WorkloadShape, registry
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    cfg = registry.get("whisper-base")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    print(f"[encdec] {cfg.name}: {cfg.encoder_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, "
          f"{Model(cfg).n_params() / 1e6:.1f} M params in bf16")
    runs = [whisper_serve(torch, dev, cfg, params, build)]
    encdec_teacher_force(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    shape = WorkloadShape("chip", "train", 4096, 2)
    with _NoPlain():
        launches, hist, peak, _ = train_and_resume(
            torch, dev, build, cfg, shape, f"{cfg.name} at full size, "
            f"train_4k at batch 2 ({shape.seq_len // cfg.encoder_seq_divisor}"
            f" frames a row)", kernels=("flash_fwd", "flash_bwd"))
    n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    # each attention (the encoder's, the decoder's, the cross) runs its
    # forward twice under remat
    _check_launches(f"{cfg.name} train", launches, {
        "flash_fwd": 2 * n_attn * 4, "flash_bwd_dq": n_attn * 4,
        "flash_bwd_dkv": n_attn * 4, "rmsnorm": 0})
    best = min(h["step_time_s"] for h in hist[1:])
    print(f"[encdec] {cfg.name} train: step ms "
          f"{[round(h['step_time_s'] * 1e3, 1) for h in hist]} (the last "
          f"traced), {shape.global_batch * shape.seq_len / best:.0f} "
          f"tokens/s at the fastest; peak {peak:.2f} GB; no plain version "
          f"ran in the serve or train runs; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return runs + [launches]


# ---------------------------------------------------------------------------
# phase 5d: pixtral-12b (head dim 160) served, with patches, and trained
# ---------------------------------------------------------------------------

D160 = "_d160"              # the kernels line's rows at pixtral's head dim
PIX_TRAIN_LAYERS = 4        # of pixtral's 40: 2.5e9 params, ~40 GB of state


def pixtral_patches(torch, dev, cfg, params, build):
    """``Model.prefill`` with VISION_PATCHES patch embeddings in place of
    the leading token embeddings (2 rows of 256-token prompts, right-
    padded to 512), then 31 contiguous ``decode_step``s: finite logits,
    tokens in the vocabulary, and the patches moving the prefill's
    logits.  Returns the launch counts of the run."""
    from repro_torch.models.model import VISION_PATCHES, Model

    model = Model(cfg)
    g = torch.Generator(device=dev).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), generator=g, device=dev)
    toks[:, 256:] = 0
    patches = torch.randn((2, VISION_PATCHES, cfg.d_model), generator=g,
                          device=dev) * 0.02
    last = torch.full((2,), 255, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    t = time.perf_counter()
    with _NoPlain():
        logits, cache = model.prefill(params, {"tokens": toks,
                                               "patches": patches},
                                      last_index=last)
        first = logits.float()
        out = []
        for i in range(32):
            out.append(torch.argmax(logits.float(), dim=-1))
            if i < 31:
                logits, cache = model.decode_step(params, cache,
                                                  out[-1][:, None], 256 + i)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        token_logits, _ = model.prefill(params, {"tokens": toks},
                                        last_index=last)
    seq = torch.stack(out, dim=1)
    moved = rel_l2(first, token_logits)
    check(bool(torch.isfinite(first).all()) and bool(
        ((seq >= 0) & (seq < cfg.vocab_size)).all()),
          "pixtral's patch-prefilled stream is not finite or in the "
          "vocabulary")
    check(moved > 0, "the patches did not reach the logits")
    print(f"[pixtral] Model.prefill with {VISION_PATCHES} patches (2 rows of "
          f"256 tokens, padded to 512), then 31 contiguous decode steps, in "
          f"{time.perf_counter() - t:.2f} s; the patches move the prefill's "
          f"last logits by {moved:.3g} (relative L2 against the tokens "
          f"alone); launches {launches}")
    _check_launches("pixtral patches", launches, {
        "flash_fwd": cfg.n_layers, "decode_attention": 31 * cfg.n_layers})
    return launches


def pixtral_phase(torch, dev, build):
    """pixtral-12b, every attention launch at head dim 160: served at full
    size (40 layers) through the serve cell in both modes and
    teacher-forced (``serve_phase``), the chunked streams against the
    legacy run's (``legacy_gaps``), prefilled with patches and decoded
    on the contiguous path (``pixtral_patches``), then trained at
    PIX_TRAIN_LAYERS layers (``pixtral_train``).  Returns the launch
    counts of its runs."""
    t_pix, runs = time.perf_counter(), []
    cfg, params, prompts, streams, c_streams = serve_phase(
        torch, dev, build, runs, "pixtral-12b")
    print(f"[serve] {cfg.name} chunked(256) against legacy: "
          + legacy_gaps(torch, dev, cfg, params, prompts, c_streams, streams))
    runs.append(pixtral_patches(torch, dev, cfg, params, build))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(pixtral_train(torch, dev, build))
    print(f"[pixtral] the phase (served, patches, trained) "
          f"{time.perf_counter() - t_pix:.1f} s")
    return runs


def pixtral_train(torch, dev, build):
    """pixtral-12b at full width and PIX_TRAIN_LAYERS of 40 layers,
    ``train_4k`` at batch 2 (64 patches a row), 3 steps through the
    Trainer, the last traced; no checkpoint (the round trip is held by
    the other trains).  Returns the launch counts of the run."""
    from repro_torch.configs import WorkloadShape, registry

    cfg = dataclasses.replace(registry.get("pixtral-12b"),
                              n_layers=PIX_TRAIN_LAYERS)
    shape = WorkloadShape("chip", "train", 4096, 2)
    with _NoPlain():
        launches, hist, peak, _ = train_and_resume(
            torch, dev, build, cfg, shape,
            f"{cfg.name} at full width (d_model {cfg.d_model}, head dim "
            f"{cfg.head_dim}), {PIX_TRAIN_LAYERS} of 40 layers (cut: all "
            f"40 need ~205 GB of float32 state)",
            kernels=("flash_fwd", "flash_bwd", "rmsnorm"), steps=3,
            resume=False)
    L, n = cfg.n_layers, 3
    _check_launches(f"{cfg.name} train", launches, {
        "flash_fwd": 2 * L * n, "flash_bwd_dq": L * n,
        "flash_bwd_dkv": L * n, "rmsnorm": (2 * 2 * L + 1) * n})
    best = min(h["step_time_s"] for h in hist[1:])
    print(f"[pixtral] {cfg.name} train ({PIX_TRAIN_LAYERS} layers): step ms "
          f"{[round(h['step_time_s'] * 1e3, 1) for h in hist]} (the last "
          f"traced), {shape.global_batch * shape.seq_len / best:.0f} "
          f"tokens/s at the fastest; peak {peak:.2f} GB")
    check(peak < 75, f"pixtral's train peaked at {peak:.2f} GB")
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
    mesh, on torch's default intra-op threads (PERF.md section 5).
    Trains under each strategy, then syncs one large gradient, and puts
    what it measured on ``queue``.  Any failure
    raises: the process exits non-zero and the parent fails."""
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
           "n_leaves": len(P.tree_leaves(Model(cfg).param_defs())),
           "threads": torch.get_num_threads()}
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
    procs = [ctx.Process(target=comm_rank,
                         args=(r, str(init_file), q))
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
          f"memory), (pod=2, data=2), each rank one row of each step, "
          f"{res[0]['threads']} torch threads a rank, in "
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


# ---------------------------------------------------------------------------
# phase 6b: tensor, expert and FSDP parallelism on four ranks of one card
# ---------------------------------------------------------------------------

# the tp phase's sharded runs against one rank's run of the same config,
# draw and batch (steps 0-2; and step 3 taken on one rank from the sharded
# run's checkpoint), in losses and in grad_norm at every step.  The ranks
# compute what the one rank computes, in bf16, except where a sum is
# split: a row-parallel product (attention's wo, the MLP's w_out, the
# experts' combine) sums the ranks' bf16 partial results, one bf16
# rounding (u = 2^-8) more of each element of the residual stream at each
# such sum; the gradient sums are float32 in other orders.  Those
# roundings are independent and the loss a mean over 8192 (yi-6b) or
# 16384 (granite) tokens, so it moves by a small fraction of u.
# TrainConfig()'s warm-up learning rates (0, 3e-6, 6e-6) leave the losses
# of steps 0-1 nearly blind to the gradient, so grad_norm, which a wrong
# or missing gradient sum moves at every step, is held too.  Read on an
# NVIDIA H100 80GB HBM3 at 700.00 W, the largest loss gaps were 4.01e-5
# (yi-6b at 4 layers), 1.18e-5 (at 2) and 1.01e-5 (granite), the largest
# grad_norm gaps 1.5e-4 (yi-6b, step 2) and 7.7e-5 (granite, step 0); each
# limit is about ten times the largest gap read, so a missing or wrong
# sum, which moves both by far more, fails.
TP_RTOL = 5e-4
TP_GRAD_RTOL = 2e-3
TP_STEPS = 3
# granite's tp run at 8 of its 24 layers (the pipeline's cut): with the
# seqmix_tp part the script took 1169.4 s uncut on one host (NVIDIA H100
# 80GB HBM3, 700.00 W), where its three steps on ranks took 97.6 s
# (39.8-40.3 s at 8 layers; PERF.md section 5)
GRANITE_TP_LAYERS = 8
TP_TIMEOUT_S = 300          # each collective (gloo's own timeout)
TP_DEADLINE_S = 900         # the ranks' whole run, children included


def _tp_setup():
    """The tp phase's runs: (name, config, shape, mesh shape, mesh axes,
    strategy).  yi-6b at full width and YI_TRAIN_LAYERS of 32 layers,
    2 x 4096 on (data 2, model 2) under ``baseline`` (tensor parallelism,
    ZeRO-1) then ``optimized`` (and FSDP; no pod tier, so one
    CommFallbackWarning); granite-moe-1b-a400m at full width and
    GRANITE_TP_LAYERS of 24 layers, 4 x 4096 on (pod 2, data 1, model 2)
    with tensor and expert parallelism, hierarchical MoE dispatch and
    hierarchical int8 sync."""
    from repro_torch.configs import (STRATEGIES, ShardingStrategy,
                                     WorkloadShape, registry, yi_6b)

    yi = dataclasses.replace(yi_6b.CONFIG, n_layers=YI_TRAIN_LAYERS)
    granite = dataclasses.replace(registry.get("granite-moe-1b-a400m"),
                                  n_layers=GRANITE_TP_LAYERS)
    hier = ShardingStrategy(
        name="tp-hier-int8", tensor_parallel=True, expert_parallel=True,
        hierarchical_moe=True, hierarchical_collectives=True,
        compress_cross_pod=True, compress_pods=2, compress_block=256)
    yi_shape = WorkloadShape("chip", "train", 4096, 2)
    dm, pdm = ((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data",
                                                        "model"))
    return [("yi-6b baseline", yi, yi_shape, *dm, STRATEGIES["baseline"]),
            ("yi-6b optimized", yi, yi_shape, *dm, STRATEGIES["optimized"]),
            ("granite hier", granite, WorkloadShape("chip", "train", 4096, 4),
             *pdm, hier)]


def _exchange_bytes(cfg, shape, mesh_shape):
    """What granite's hierarchical exchange hands the pod group in one
    forward, per rank: for each MoE layer the remote home blocks of its
    slot grid, out and back, bf16: 2 (P - 1) E_h G_s C D 2 bytes (E_h = E /
    (P M) experts, G_s = G / (P D) groups), as tests/test_torch_tp.py
    pins it (on the CPU, float32: 4 bytes an element)."""
    from repro_torch.models.moe import _capacity
    pods, data, model = mesh_shape
    mc = cfg.moe
    per_layer = (2 * (pods - 1) * (mc.n_experts // (pods * model))
                 * (shape.global_batch // (pods * data))
                 * _capacity(shape.seq_len, mc) * cfg.d_model * 2)
    return cfg.n_layers * per_layer


# the tp phase's serving part: (arch, requests), both at full size
SERVE_TP_ARCHS = (("yi-6b", 8), ("granite-moe-1b-a400m", 4))
SERVE_TP_CHUNK = 256
SERVE_TP_NEW = 32


def serve_tp_prompts(cfg, n):
    """``n`` prompts of 64..512 random tokens (seed 0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, int(k)).tolist()
            for k in rng.integers(64, 513, n)]


def serve_tp_engine(cfg, dev, chunk, mesh=None):
    """8 slots of page-16 pools in 2 shards, prompts up to 512 tokens,
    1024 in all, weights from seed 0, eager ticks: on ``mesh`` (the
    ranks' (data 2, model 2): each data shard's slots on its ranks) or
    on one rank."""
    from repro_torch.serve import Engine, EngineConfig
    ecfg = EngineConfig(n_slots=8, page_size=16, max_prompt_len=512,
                        max_seq_len=1024, prefill_chunk=chunk, dp_shards=2)
    return Engine(cfg, ecfg, mesh=mesh, seed=0, device=dev,
                  cuda_graphs=False)


def serve_tp_drive(torch, eng, prompts, build):
    """The prompts through ``eng``, SERVE_TP_NEW greedy tokens each, the
    launch counts and the collectives' payload bytes read around the run,
    and each tick's host time by kind (a tick ends when its tokens reach
    the host)."""
    from repro_torch.comm import collectives
    torch.cuda.synchronize()
    build.reset_launches()
    collectives.reset_counters()
    reqs = [eng.submit(p, max_new_tokens=SERVE_TP_NEW) for p in prompts]
    ticks = {"decode": [], "mixed": [], "prefill": []}
    t0 = time.perf_counter()
    while True:
        n_dec, n_mix = eng.n_decode_steps, eng.n_mixed_steps
        t = time.perf_counter()
        if not eng.step():
            break
        kind = ("decode" if eng.n_decode_steps > n_dec else "mixed"
                if eng.n_mixed_steps > n_mix else "prefill")
        ticks[kind].append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    for r in reqs:
        check(r.finished and len(r.tokens) == SERVE_TP_NEW,
              f"request {r.rid} did not finish with {SERVE_TP_NEW} tokens")
        check(all(0 <= t < eng.cfg.vocab_size for t in r.tokens),
              f"request {r.rid} has tokens outside the vocabulary")
    return {"streams": [r.tokens for r in reqs],
            "launches": dict(build.LAUNCHES),
            "bytes": dict(collectives.PAYLOAD_BYTES), "ticks": ticks,
            "ttft_ms": sorted(r.ttft * 1e3 for r in reqs),
            "tok_s": sum(len(r.tokens) for r in reqs) / elapsed,
            "seconds": elapsed}


def serve_tp_rank(torch, dev, mesh, build, archs=SERVE_TP_ARCHS,
                  chunks=(0, SERVE_TP_CHUNK), cfg_of=None):
    """A rank's serving part: each arch of ``archs`` (its config
    ``cfg_of(arch)``: full size by default) on ``mesh``, each of
    ``chunks``' modes, each engine built (its weights drawn, this rank
    keeping its shards) and dropped in turn; per run what
    ``serve_tp_drive`` measures, the build's seconds, the bytes of the
    rank's params and pool and its peak allocation; and per arch the
    teacher-forced logits (``forced_logits``, a sequence mixer's
    ``seqmix_teacher_force``) through the legacy engine's shards, made
    whole (rank 0's, float32 on the host)."""
    from repro_torch.configs import registry
    cfg_of = cfg_of or registry.get
    out = {}
    for arch, n in archs:
        cfg = cfg_of(arch)
        prompts = serve_tp_prompts(cfg, n)
        for chunk in chunks:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            eng = serve_tp_engine(cfg, dev, chunk, mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            run = serve_tp_drive(torch, eng, prompts, build)
            run.update(
                build_s=build_s, coords=mesh.coords,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                params_gb=sum(x.numel() * x.element_size() for x in
                              _leaves_of(eng.params)) / 1e9,
                pool_gb=sum(x.numel() * x.element_size() for x in
                            _leaves_of(eng.pool)) / 1e9)
            out[(arch, chunk)] = run
            if not chunk:
                out[(arch, "forced")] = ranks_forced(torch, dev, cfg, eng,
                                                     mesh)
            del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ranks_forced(torch, dev, cfg, eng, mesh):
    """The teacher-forced logits (``forced_logits``, a sequence mixer's
    ``seqmix_teacher_force``) through the engine ``eng``'s shards on
    ``mesh``, made whole: rank 0's, float32 on the host (None on the
    other ranks).  A collective: every rank calls it."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps as dsteps
    from repro_torch.dist.actsharding import activation_sharding
    from repro_torch.serve import paging
    with activation_sharding(mesh, eng.strategy):
        if cfg.sub_quadratic:
            rows = seqmix_teacher_force(
                torch, dev, cfg, eng.params,
                (("ranks", None, torch.bfloat16),), mesh=mesh,
                strategy=eng.strategy)["ranks"]
        else:
            pool = paging.init_pool(cfg, 1, forced_layout(), dev, mesh=mesh,
                                    strategy=eng.strategy)
            rows = forced_logits(torch, dev, cfg, eng.params, pool=pool)
            del pool
    vocab = dsteps.logits_sharding(cfg, 1, eng.strategy, mesh)[1]
    rows = shd.gather(rows, (None, vocab), mesh)
    return rows.cpu() if mesh.rank == 0 else None


def _leaves_of(tree):
    from repro_torch.models import params as P
    return P.tree_leaves(tree)


def serve_tp_reference(torch, dev, build, archs=SERVE_TP_ARCHS,
                       chunks=(0, SERVE_TP_CHUNK), cfg_of=None):
    """The one-rank eager engine of each serving run on ranks (same
    config, seed and prompts), on this card: its streams, and per
    request the float32 logits row each of its tokens came from
    (``_record_logits``); per arch the teacher-forced logits of its
    weights through the kernels in bf16 and the plain versions in bf16
    and float32."""
    from repro_torch.configs import registry
    cfg_of = cfg_of or registry.get
    out = {}
    for arch, n in archs:
        cfg = cfg_of(arch)
        prompts = serve_tp_prompts(cfg, n)
        for chunk in chunks:
            gc.collect()
            torch.cuda.empty_cache()
            eng = serve_tp_engine(cfg, dev, chunk)
            logits_of = _record_logits(eng)
            run = serve_tp_drive(torch, eng, prompts, build)
            # the requests in submission order: ids rise with it
            run["logits"] = [logits_of[k] for k in sorted(logits_of)]
            out[(arch, chunk)] = run
            if not chunk:
                out[(arch, "forced")] = one_rank_forced(torch, dev, cfg,
                                                        eng.params)
            del eng, logits_of
    gc.collect()
    torch.cuda.empty_cache()
    return out


def one_rank_forced(torch, dev, cfg, params):
    """The teacher-forced logits of ``params`` on this card (as
    ``ranks_forced`` takes them on ranks) through the kernels in bf16
    and the plain versions in bf16 and float32, on the host."""
    modes = (("kernels", None, torch.bfloat16), ("plain", "ref",
                                                 torch.bfloat16),
             ("plain_f32", "ref", torch.float32))
    if cfg.sub_quadratic:
        return {k: v.cpu() for k, v in seqmix_teacher_force(
            torch, dev, cfg, params, modes).items()}
    return {name: forced_logits(torch, dev, cfg, params, impl, dtype).cpu()
            for name, impl, dtype in modes}


def _parting(streams, ref_streams, ref_logits):
    """(request, first step where ``streams`` part from ``ref_streams``,
    the parting token's gap below the max of the reference's logits
    row there) of each stream that parts."""
    out = []
    for i, (got, want) in enumerate(zip(streams, ref_streams)):
        k = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if k is not None:
            row = ref_logits[i][k]
            out.append((i, k, round(float(row.max() - row[got[k]]), 5)))
    return out


def serve_tp_report(res, refs, smi, archs=SERVE_TP_ARCHS,
                    chunks=(0, SERVE_TP_CHUNK), key="serve", tag="serve_tp",
                    forced="prefill, chunk, 4 decode steps"):
    """The serving part's checks and lines (``key``: the ranks' results
    under it; ``archs``, ``chunks``: its runs).  Per arch, the
    teacher-forced logits through the ranks' shards must stay as close
    to float32 compute as one rank's plain bf16 path is, within
    LOGIT_NOISE_FACTOR (``teacher_force``'s rule for the kernel path).
    Per run: every rank's streams equal rank 0's; rank 0's equal the
    one-rank eager engine's token for token until they part, and where
    one parts, its token lies below the one-rank max by no more than two
    bf16 paths within that rule can disagree: (1 + LOGIT_NOISE_FACTOR)
    times the one-rank bf16 path's largest teacher-forced logit error
    against float32 (the line also counts the partings within
    STREAM_LOGIT_TOL, and, for scale, how the one-rank engine's own
    chunked and legacy streams part); every kernel of the path launched
    (``_served_kernels``).  Returns the ranks' launch counts, summed."""
    total = {}
    for arch, _ in archs:
        got = dict(refs[(arch, "forced")],
                   sharded=res[0][key][(arch, "forced")])
        s_f, s_k, p_f = (_rel_steps(got, "sharded", "plain_f32"),
                         _rel_steps(got, "sharded", "kernels"),
                         _rel_steps(got, "plain", "plain_f32"))
        err = float((got["kernels"] - got["plain_f32"]).abs().max())
        limit = (1 + LOGIT_NOISE_FACTOR) * err
        own = ("" if len(chunks) == 1 else
               "; the one-rank engine's own chunked streams part from its "
               "legacy ones at (request, step, gap) "
               + str(_parting(refs[(arch, chunks[1])]["streams"],
                              refs[(arch, 0)]["streams"],
                              refs[(arch, 0)]["logits"])))
        print(f"[{tag}] {arch} teacher-forced logits ({forced}), relative "
              f"L2 error per step: ranks vs f32 {s_f}; ranks vs one rank's "
              f"kernels {s_k}; one rank's plain bf16 vs f32 {p_f} (limit "
              f"{LOGIT_NOISE_FACTOR} x its max); one rank's kernels' largest "
              f"logit error against f32 {err:.5f}, so a parting token's gap "
              f"limit {limit:.5f}{own}")
        check(max(s_f) <= LOGIT_NOISE_FACTOR * max(p_f), f"{tag} {arch}: "
              f"the ranks' path drifts from f32 by {max(s_f)}, one rank's "
              f"plain bf16 by {max(p_f)}")
        for chunk in chunks:
            ref = refs[(arch, chunk)]
            mode = f"chunked({chunk})" if chunk else "legacy"
            runs = [r[key][(arch, chunk)] for r in res]
            streams = runs[0]["streams"]
            for r, run in zip(res, runs):
                check(run["streams"] == streams, f"{tag} {arch} {mode}: "
                      f"rank {r['rank']} has other streams than rank 0")
            gaps = _parting(streams, ref["streams"], ref["logits"])
            for i, k, gap in gaps:
                check(gap <= limit, f"{tag} {arch} {mode}: request {i} "
                      f"parts from the one-rank stream at step {k} by a token "
                      f"{gap:.5f} below the one-rank max (limit {limit:.5f})")
            report_run(arch, mode, chunk, runs, res, ref, gaps, smi, tag)
            for run in runs:
                for k, v in run["launches"].items():
                    total[k] = total.get(k, 0) + v
    return total


def _served_kernels(arch, chunk):
    """(the kernels every rank launches, those some rank launches) in a
    serve run on (data 2, model 2): an xLSTM's norms alone; an
    attention arch's decode and norms on every rank (and a MoE arch's
    experts), its prefill kernel on the ranks of the data shards that
    held a prompt."""
    if arch.startswith("xlstm"):
        return ("rmsnorm",), ()
    moe = ("moe_gemm",) if arch.startswith(("granite", "jamba")) else ()
    return (("paged_decode", "rmsnorm") + moe,
            ("paged_prefill" if chunk else "flash_fwd",))


def report_run(arch, mode, chunk, runs, res, ref, gaps, smi,
               tag="serve_tp"):
    """A serve run on ranks: its launch checks and its lines."""
    each, some = _served_kernels(arch, chunk)
    for r, run in zip(res, runs):
        for name in each:
            check(run["launches"].get(name, 0) > 0, f"{tag} {arch} "
                  f"{mode}: rank {r['rank']} never launched {name}")
    for name in some:
        check(sum(run["launches"].get(name, 0) for run in runs) > 0,
              f"{tag} {arch} {mode}: no rank launched {name}")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    r0 = runs[0]
    n_req, n_ticks = len(r0["streams"]), sum(map(len, r0["ticks"].values()))
    within = sum(g <= STREAM_LOGIT_TOL for _, _, g in gaps)
    kind = "mixed" if chunk else "prefill"
    print(f"[{tag}] {arch} {mode} on (data 2, model 2), dp_shards 2, "
          f"{n_req} requests: every rank's streams equal; {len(gaps)} of "
          f"{n_req} part from the one-rank eager engine's (request, step, "
          f"gap below its max) {gaps}, {within} within STREAM_LOGIT_TOL "
          f"({STREAM_LOGIT_TOL}); rank 0: decode tick median "
          f"{med(r0['ticks']['decode']):.2f} ms over "
          f"{len(r0['ticks']['decode'])}, {kind} tick median "
          f"{med(r0['ticks'][kind]):.2f} ms over {len(r0['ticks'][kind])}, "
          f"TTFT median {med(r0['ttft_ms']):.1f} ms, {r0['tok_s']:.1f} tok/s "
          f"({r0['seconds']:.2f} s); one rank eager: decode tick median "
          f"{med(ref['ticks']['decode']):.2f} ms, TTFT median "
          f"{med(ref['ttft_ms']):.1f} ms, {ref['tok_s']:.1f} tok/s ({smi})")
    for r, run in zip(res, runs):
        per_tick = {a: b // n_ticks for a, b in sorted(run["bytes"].items())}
        print(f"[{tag}] {arch} {mode} rank {r['rank']} {run['coords']}: "
              f"built in {run['build_s']:.1f} s, params "
              f"{run['params_gb']:.2f} GB, pool {run['pool_gb']:.3f} GB, peak "
              f"{run['peak_gb']:.2f} GB allocated; payload bytes a tick by "
              f"axis {per_tick} over {n_ticks} ticks; launches "
              f"{ {k: v for k, v in run['launches'].items() if v} }")


# the tp phase's seqmix_tp part: the sequence mixers on the same four
# ranks.  Served on (data 2, model 2), dp_shards 2, legacy (no chunked
# tick on these archs), at full width and SEQMIX_TP_LAYERS layers of
# their own: jamba's one whole Jamba block (7 Mamba, 1 attention and 4
# MoE FFNs: 13.3e9 params, 27 GB of bf16 weights a data replica, so
# ~54 GB on the card), xlstm's 7 mLSTM and the sLSTM of its 48, 4
# requests (the sLSTM's recurrence is a host loop every rank runs).
# Trained on (data 1, model 4) at the seqmix_train phase's 2-layer cuts
# (jamba 3.68e9 params, ~15 GB of float32 state a rank): xlstm one row of
# 256; jamba the seqmix_train phase's 2 x 4096.  At 1 x 1024 jamba's
# routing (16 experts, top 2, over 1024 tokens) puts one rank's own bf16
# paths 0.9e-3 (plain) and 1.6e-3 (kernels) from float32 in grad_norm,
# too near TP_GRAD_RTOL to tell a sharding fault from bf16 rounding; at
# 2 x 4096 0.4e-3 and 0.2e-3 (tools/tp_grad_noise.py; without the MoE
# FFN the ranks lie 1.2e-5 from float32 at 1 x 1024).  The routing moves
# the served logits too: jamba's ranks sit nearer the teacher-forced
# rule's edge than a dense arch's, so the ranks also take jamba with dense
# FFNs through that rule (``seqmix_tp_dense_cfg``).
SEQMIX_TP_LAYERS = 8
SEQMIX_TP_SERVE = (("jamba-v0.1-52b", 8), ("xlstm-1.3b", 4))
SEQMIX_TP_TRAIN = (("jamba-v0.1-52b", JAMBA_F32_PATTERN, 2, 4096),
                   ("xlstm-1.3b", ("mlstm", "slstm"), 1, 256))
SEQMIX_TP_STEPS = 2
# (label, mesh shape, rows) of the in-projection exchange timed alone: a
# decode tick's rows of a data shard (4 slots), a 512-token prefill, a
# jamba training batch (2 x 4096) on model 4
SEQMIX_TP_EXCHANGES = (("decode", (2, 2), 4), ("prefill", (2, 2), 512),
                       ("train", (1, 4), 8192))


def seqmix_tp_cfg(arch):
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get(arch), n_layers=SEQMIX_TP_LAYERS)


def seqmix_tp_dense_cfg():
    """jamba at SEQMIX_TP_LAYERS layers with a dense FFN in place of each
    MoE one: its teacher-forced logits on the ranks hold the Mamba and
    attention blocks' split without the experts' routing, which parts
    any two bf16 paths (``seqmix_tp_report``)."""
    return dataclasses.replace(seqmix_tp_cfg("jamba-v0.1-52b"), moe=None)


def seqmix_tp_train_setup():
    """(arch, config, shape) of each seqmix_tp train cut."""
    from repro_torch.configs import WorkloadShape, registry
    return [(arch, dataclasses.replace(registry.get(arch), n_layers=2,
                                       block_pattern=pattern),
             WorkloadShape("chip", "train", seq, rows))
            for arch, pattern, rows, seq in SEQMIX_TP_TRAIN]


def seqmix_tp_reference(torch, dev, build):
    """The seqmix_tp part's one-rank references on this card: the eager
    engine's serving runs (``serve_tp_reference``), the dense jamba's
    teacher-forced logits (``seqmix_tp_dense_cfg``) and each train cut's
    SEQMIX_TP_STEPS steps (``TrainConfig()``, seed 0): its history."""
    from repro_torch.configs import TrainConfig
    from repro_torch.train import Trainer
    out = serve_tp_reference(torch, dev, build, SEQMIX_TP_SERVE, (0,),
                             seqmix_tp_cfg)
    cfg = seqmix_tp_dense_cfg()
    eng = serve_tp_engine(cfg, dev, 0)
    out["dense_forced"] = one_rank_forced(torch, dev, cfg, eng.params)
    del eng
    for arch, cfg, shape in seqmix_tp_train_setup():
        gc.collect()
        torch.cuda.empty_cache()
        tr = Trainer(cfg, TrainConfig(), shape, seed=0, device=dev)
        tr.run(SEQMIX_TP_STEPS, log_every=0)
        out[(arch, "train")] = tr.history
        del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _exchange_ms(torch, dev, mesh, cfg, rows, reps=7):
    """The median host ms of one ``layers.split_halves`` exchange of a
    mixer layer of ``cfg`` (its in-projection's (1, rows, 2 d_in / model)
    bf16 columns, to the host and back), on every rank of ``mesh`` (a
    collective)."""
    from repro_torch.models import layers
    d_in = 2 * cfg.d_model                  # jamba's and xlstm's expand 2
    xz = torch.randn((1, rows, 2 * d_in // mesh.shape["model"]),
                     device=dev).to(torch.bfloat16)
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        layers.split_halves(xz, mesh)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return sorted(ts)[reps // 2]


def seqmix_tp_rank(torch, dev, meshes, build):
    """A rank's seqmix_tp part: SEQMIX_TP_SERVE served on (data 2, model
    2) (``serve_tp_rank``), the dense jamba's teacher-forced logits there
    (``seqmix_tp_dense_cfg``), the in-projection exchange timed alone at
    SEQMIX_TP_EXCHANGES, then each train cut on (data 1, model 4)
    (``_tp_train_run``, ``baseline``: tensor and expert parallelism, no
    data sync)."""
    from repro_torch.configs import BASELINE
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out = {"held_gb": (torch.cuda.memory_allocated() / 1e9,
                       torch.cuda.memory_reserved() / 1e9)}
    out["serve"] = serve_tp_rank(torch, dev, meshes[(2, 2)], build,
                                 SEQMIX_TP_SERVE, (0,), seqmix_tp_cfg)
    cfg = seqmix_tp_dense_cfg()
    eng = serve_tp_engine(cfg, dev, 0, meshes[(2, 2)])
    out["dense_forced"] = ranks_forced(torch, dev, cfg, eng, meshes[(2, 2)])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["exchange_ms"] = {
        (arch, label): _exchange_ms(torch, dev, meshes[mshape],
                                    seqmix_tp_cfg(arch), rows)
        for arch, _ in SEQMIX_TP_SERVE
        for label, mshape, rows in SEQMIX_TP_EXCHANGES}
    out["train"] = {
        arch: _tp_train_run(torch, dev, build, arch, cfg, shape,
                            meshes[(1, 4)], BASELINE, SEQMIX_TP_STEPS)
        for arch, cfg, shape in seqmix_tp_train_setup()}
    out["seconds"] = time.perf_counter() - t
    return out


def seqmix_tp_report(res, refs, smi):
    """The seqmix_tp part's checks and lines: the serving runs by
    ``serve_tp_report``'s rule against the one-rank eager engine, the
    dense jamba's teacher-forced logits by the same rule (the MoE
    jamba's ratio beside it), the exchange's times, and each train cut by ``_tp_train_report`` against
    its one-rank run (launches: jamba's every kernel of the 2-layer cut,
    as the seqmix_train phase counts them; xlstm's norms).  Returns the
    ranks' summed launch counts."""
    from repro_torch.configs import BASELINE
    total = serve_tp_report(
        [dict(r, seqmix=r["seqmix"]["serve"]) for r in res], refs, smi,
        SEQMIX_TP_SERVE, (0,), key="seqmix", tag="seqmix_tp",
        forced="a 77-token exact-length prefill, 4 decode steps")
    # the same rule without the MoE routing: jamba with dense FFNs
    jamba = "jamba-v0.1-52b"
    ratio = {}
    for name, ref, rows in (
            ("MoE", refs[(jamba, "forced")],
             res[0]["seqmix"]["serve"][(jamba, "forced")]),
            ("dense", refs["dense_forced"], res[0]["seqmix"]["dense_forced"])):
        got = dict(ref, sharded=rows)
        s_f = _rel_steps(got, "sharded", "plain_f32")
        p_f = _rel_steps(got, "plain", "plain_f32")
        ratio[name] = (s_f, p_f, max(s_f) / max(p_f))
    s_f, p_f, r = ratio["dense"]
    print(f"[seqmix_tp] {jamba} with dense FFNs (moe=None) teacher-forced "
          f"on (data 2, model 2): relative L2 error per step: ranks vs f32 "
          f"{s_f}; one rank's plain bf16 vs f32 {p_f}; the ranks' largest "
          f"{r:.4f} x one rank's (limit {LOGIT_NOISE_FACTOR}); with its MoE "
          f"FFNs {ratio['MoE'][2]:.4f} x ({smi})")
    check(r <= LOGIT_NOISE_FACTOR, f"seqmix_tp {jamba} dense: the ranks' "
          f"path drifts from f32 by {max(s_f)}, one rank's plain bf16 by "
          f"{max(p_f)}")
    print(f"[seqmix_tp] the part took {res[0]['seqmix']['seconds']:.1f} s "
          f"on the ranks; at its start each rank held (allocated, "
          f"reserved) GB "
          f"{[tuple(round(x, 2) for x in r['seqmix']['held_gb']) for r in res]}")
    ms = res[0]["seqmix"]["exchange_ms"]
    print(f"[seqmix_tp] the in-projection's u/z exchange over model, one "
          f"layer, rank 0's median host ms (bf16 to the host, gloo "
          f"all-to-all, back): "
          + "; ".join(f"{arch} {label} ({rows} rows on "
                      f"{dict(zip(('data', 'model'), mshape))}) "
                      f"{ms[(arch, label)]:.3f}"
                      for arch, _ in SEQMIX_TP_SERVE
                      for label, mshape, rows in SEQMIX_TP_EXCHANGES)
          + f" ({smi})")
    steps = SEQMIX_TP_STEPS
    for arch, cfg, shape in seqmix_tp_train_setup():
        counts = ({"rmsnorm": 9 * steps, "flash_fwd": 2 * steps,
                   "flash_bwd_dq": steps, "flash_bwd_dkv": steps,
                   "moe_gemm": 12 * steps} if cfg.moe is not None else
                  {"rmsnorm": 5 * steps})
        _tp_train_report(
            "seqmix_tp", f"{cfg.name} {cfg.block_pattern} "
            f"{shape.global_batch} x {shape.seq_len}", cfg, shape, (1, 4),
            ("data", "model"),
            BASELINE, [(r["rank"], r["seqmix"]["train"][arch])
                       for r in res], refs[(arch, "train")], steps, counts,
            smi, total)
    return total


def _tp_train_run(torch, dev, build, name, cfg, shape, mesh, strategy,
                  steps, ckpt=None):
    """One train run on this rank's ``mesh`` (``TrainConfig()``, seed 0,
    ``steps`` steps, a checkpoint at the last where ``ckpt``): losses,
    step times, the bytes the allocator gave the state against its
    resolved shards, payload bytes by axis, peak memory and launch
    counts; on a pod tier also the exchange's bytes in one forward."""
    import math
    import warnings

    from repro_torch import comm
    from repro_torch.comm import collectives
    from repro_torch.configs import TrainConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps as dsteps
    from repro_torch.dist.actsharding import activation_sharding
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.train import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = Trainer(cfg, TrainConfig(), shape, mesh=mesh, strategy=strategy,
                     ckpt_dir=ckpt, seed=0, device=dev)
    n_warn = sum(issubclass(x.category, comm.CommFallbackWarning)
                 for x in caught)
    # the state's bytes: the bytes the allocator was asked for and still
    # holds ("requested_bytes": a block's own size rounds up and may take
    # a whole cached block), against each leaf's shard
    def asked():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    before, before_blocks = asked(), torch.cuda.memory_allocated()
    t = time.perf_counter()
    tr.init_or_resume()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    held = asked() - before
    blocks = torch.cuda.memory_allocated() - before_blocks
    specs = P.tree_leaves(dsteps.train_state_shardings(cfg, strategy, mesh))
    template = P.tree_leaves(dsteps.abstract_train_state(
        cfg, TrainConfig(), strategy))
    shards = [math.prod(shd.local_shape(t.shape, sp, mesh))
              * t.element_size() for t, sp in zip(template, specs)]
    check([tuple(x.shape) for x in P.tree_leaves(tr.state)]
          == [shd.local_shape(t.shape, sp, mesh)
              for t, sp in zip(template, specs)],
          f"rank {mesh.rank} {name}: state leaves are not their shards")
    build.reset_launches()
    collectives.reset_counters()
    t = time.perf_counter()
    tr.run(steps, ckpt_every=steps if ckpt else 0, log_every=0)
    torch.cuda.synchronize()
    run = {"history": tr.history, "seconds": time.perf_counter() - t,
           "launches": dict(build.LAUNCHES),
           "bytes": dict(collectives.PAYLOAD_BYTES),
           "held": held, "shards": sum(shards), "blocks": blocks,
           "init_s": init_s, "warnings": n_warn,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "coords": mesh.coords}
    if "pod" in mesh.shape:
        # one forward of the loss over this rank's rows: the exchange's
        # bytes alone (no gradient sync), the launches not counted
        rows = shape.global_batch // mesh.shape["pod"]
        g = torch.Generator(device=dev).manual_seed(99)
        tok = torch.randint(0, cfg.vocab_size, (rows, shape.seq_len),
                            generator=g, device=dev)
        collectives.reset_counters()
        with torch.no_grad(), activation_sharding(
                mesh, strategy, global_rows=shape.global_batch):
            Model(cfg).loss(tr.state["params"],
                            {"tokens": tok, "labels": tok}, remat=False)
        torch.cuda.synchronize()
        run["fwd_pod_bytes"] = collectives.PAYLOAD_BYTES.get("pod", 0)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return run


def tp_rank(rank, init_file, ckpt_dir, queue):
    """One of the tp phase's four ranks: its own process, on card 0, in
    a gloo process group of four, on torch's default intra-op threads
    (PERF.md section 5).  Runs each of ``_tp_setup``'s runs
    (``_tp_train_run``, TP_STEPS steps; yi's baseline run writes a
    checkpoint at its last step), then, the training's memory freed, the
    serving part on (data 2, model 2) (``serve_tp_rank``), then the
    seqmix_tp part (``seqmix_tp_rank``), and puts what it measured on
    ``queue``.  Any failure raises: the process exits non-zero and the
    parent fails."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.dist import mesh as dmesh
    from repro_torch.kernels import build

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # four ranks share the card: segments that grow in place keep a rank's
    # freed blocks reusable across its parts (fixed segments left 4.6 GB
    # of one rank's reserve unusable when jamba's weights were drawn)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    timeout = timedelta(seconds=TP_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4, timeout=timeout)
    meshes = {}
    out = {"rank": rank, "runs": {}, "threads": torch.get_num_threads()}
    for name, cfg, shape, mshape, axes, strategy in _tp_setup():
        if mshape not in meshes:
            meshes[mshape] = dmesh.make_mesh(mshape, axes, timeout=timeout)
        out["runs"][name] = _tp_train_run(
            torch, dev, build, name, cfg, shape, meshes[mshape], strategy,
            TP_STEPS, ckpt_dir if name == "yi-6b baseline" else None)
    # serving on (data 2, model 2), the training's memory freed
    out["serve"] = serve_tp_rank(torch, dev, meshes[(2, 2)], build)
    meshes[(1, 4)] = dmesh.make_mesh((1, 4), ("data", "model"),
                                     timeout=timeout)
    out["seqmix"] = seqmix_tp_rank(torch, dev, meshes, build)
    dist.destroy_process_group()
    queue.put(out)


def _tp_train_report(tag, name, cfg, shape, mshape, axes, strategy, runs,
                     want, steps, counts, smi, total):
    """A train run on ranks (``runs``: (rank, its run) each) against one
    rank's history ``want``: every rank's losses equal rank 0's, within TP_RTOL of one rank's at every
    step, grad_norm within TP_GRAD_RTOL, the state bytes its resolved
    shards' exactly, the launches ``counts`` on every rank (added to
    ``total``); and its lines."""
    hist0 = runs[0][1]["history"]
    losses = [h["loss"] for h in hist0]
    for rank, run in runs:
        check([h["loss"] for h in run["history"]] == losses,
              f"rank {rank} has other {name} losses than rank 0")
    gaps = [abs(a - b["loss"]) / abs(b["loss"])
            for a, b in zip(losses, want)]
    g_gaps = [[abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
               for a, b in zip(run["history"], want)] for _, run in runs]
    print(f"[{tag}] {name} on {dict(zip(axes, mshape))} ({strategy.name}): "
          f"losses {[round(x, 5) for x in losses]} against one rank's "
          f"{[round(h['loss'], 5) for h in want[:steps]]}: largest "
          f"relative gap {max(gaps):.3g} (tol {TP_RTOL}); grad_norm "
          f"{[round(h['grad_norm'], 5) for h in hist0]}"
          f" against {[round(h['grad_norm'], 5) for h in want[:steps]]}"
          f": relative gaps by step {[f'{max(c):.3g}' for c in zip(*g_gaps)]}"
          f" over the ranks (tol {TP_GRAD_RTOL})")
    check(len(gaps) == steps and max(gaps) <= TP_RTOL,
          f"{name}: sharded losses differ from one rank's by {gaps}")
    check(all(len(g) == steps for g in g_gaps)
          and max(map(max, g_gaps)) <= TP_GRAD_RTOL,
          f"{name}: sharded grad_norms differ from one rank's by {g_gaps}")
    n_warn = runs[0][1]["warnings"]
    check(n_warn == (1 if strategy.name == "optimized" else 0),
          f"{name}: {n_warn} CommFallbackWarnings")
    for rank, run in runs:
        _check_launches(f"{tag} {name} rank {rank}", run["launches"], counts)
        check(run["held"] == run["shards"], f"rank {rank} {name}: the state "
              f"holds {run['held']} B, its resolved shards {run['shards']} B")
        if strategy.compress_cross_pod:
            check(run["launches"]["quantize"] > 0
                  and run["launches"]["dequantize"] > 0,
                  f"rank {rank} {name}: no int8 launch on the pod hop")
        if "fwd_pod_bytes" in run:
            exp = _exchange_bytes(cfg, shape, mshape)
            check(run["fwd_pod_bytes"] == exp, f"rank {rank} {name}: the "
                  f"exchange handed the pod group {run['fwd_pod_bytes']} B "
                  f"in one forward, not {exp}")
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
        step_ms = sorted(h["step_time_s"] * 1e3 for h in run["history"][1:])
        per_step = {a: b // steps for a, b in sorted(run["bytes"].items())}
        print(f"[{tag}] rank {rank} {run['coords']} {name}: steps "
              f"{[round(h['step_time_s'] * 1e3, 1) for h in run['history']]}"
              f" ms (median after the first "
              f"{step_ms[len(step_ms) // 2]:.1f}); state drawn in "
              f"{run['init_s']:.1f} s, {run['held']} B held = its resolved "
              f"shards' ({run['blocks']} B of allocator blocks); "
              f"{run['seconds']:.1f} s for {steps} steps; payload bytes a "
              f"step by axis {per_step}"
              + (f"; the exchange's pod bytes in one forward "
                 f"{run['fwd_pod_bytes']} (= the pinned count)"
                 if "fwd_pod_bytes" in run else "")
              + f"; peak {run['peak_gb']:.2f} GB allocated, "
              f"{run['peak_reserved_gb']:.2f} reserved; launches "
              f"{ {k: v for k, v in run['launches'].items() if v} } ({smi})")


def tp_phase(torch, dev, build, smi):
    """Tensor, expert and FSDP parallelism on four gloo ranks of the one
    card (``_tp_setup``), each run held against one rank's run of the
    same config, draw and batch on this card (yi-6b's: the train phase's
    run; granite's: grad_accum=2 here, the two pods' rows as two
    microbatches, whose MoE aux losses are averaged alike) by
    ``_tp_train_report``, granite's exchange bytes equal to
    ``_exchange_bytes``, the kernels launched at their local shapes, and
    yi's sharded checkpoint restored on this one rank, whose next step's
    loss is held to the one-rank run's.  Then the serving part
    (``serve_tp_report``): yi-6b and granite-moe-1b-a400m at full size
    served by the same four ranks on (data 2, model 2), against the
    one-rank eager engine run here before the ranks start; then the
    seqmix_tp part (``seqmix_tp_report``), its one-rank references run
    here too.  Returns the ranks' summed launch counts of the training,
    of the serving part and of the seqmix_tp part."""
    import queue as queue_mod
    import shutil

    import torch.multiprocessing as tmp

    from repro_torch.configs import TrainConfig
    from repro_torch.train import Trainer

    setup = _tp_setup()
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    serve_refs = serve_tp_reference(torch, dev, build)
    print(f"[tp] serving's one-rank eager references in "
          f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    seqmix_refs = seqmix_tp_reference(torch, dev, build)
    print(f"[tp] seqmix_tp's one-rank references in "
          f"{time.perf_counter() - t:.1f} s")
    name, gcfg, gshape = setup[2][:3]
    t = time.perf_counter()
    ref = Trainer(gcfg, TrainConfig(grad_accum=2), gshape, seed=0,
                  device=dev)
    ref.run(TP_STEPS, log_every=0)
    refs = {"yi-6b": ONE_RANK["yi-6b"], "granite": ref.history}
    print(f"[tp] one-rank reference: {gcfg.name}, batch "
          f"{gshape.global_batch} x {gshape.seq_len}, grad_accum 2: losses "
          f"{[round(h['loss'], 5) for h in ref.history]} in "
          f"{time.perf_counter() - t:.1f} s; yi-6b's: the train phase's "
          f"{[round(h['loss'], 5) for h in refs['yi-6b']]}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[tp] this process holds {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"reserved as the ranks start; the card "
          f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB free")
    ckpt_dir = ROOT / "build" / "chip_smoke_tp_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    init_file = ROOT / "build" / f"tp_pg_{os.getpid()}"
    init_file.unlink(missing_ok=True)
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=tp_rank,
                         args=(r, str(init_file), str(ckpt_dir), q))
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
                check(not dead, f"a tp rank failed (exit codes {dead})")
                check(time.perf_counter() - t < TP_DEADLINE_S,
                      f"the tp ranks did not finish in {TP_DEADLINE_S} s")
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
          f"tp ranks exited with {[p.exitcode for p in procs]}")
    res = [results[r] for r in range(4)]
    print(f"[tp] 4 ranks on one card, gloo (CUDA payloads through host "
          f"memory), {res[0]['threads']} torch threads a rank, in "
          f"{time.perf_counter() - t:.1f} s")

    total = {k: 0 for k in build.LAUNCHES}
    for name, cfg, shape, mshape, axes, strategy in setup:
        want = refs["granite" if name.startswith("granite") else "yi-6b"]
        L, steps = cfg.n_layers, TP_STEPS
        counts = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                  "flash_bwd_dkv": L * steps,
                  "rmsnorm": (2 * 2 * L + 1) * steps}
        if cfg.moe is not None:
            counts["moe_gemm"] = 12 * L * steps
        _tp_train_report("tp", name, cfg, shape, mshape, axes, strategy,
                         [(r["rank"], r["runs"][name]) for r in res], want,
                         steps, counts, smi, total)

    # yi's sharded checkpoint (step 3), restored whole on this one rank
    cfg, shape = setup[0][1], setup[0][2]
    t = time.perf_counter()
    one = Trainer(cfg, TrainConfig(), shape, ckpt_dir=str(ckpt_dir), seed=0,
                  device=dev)
    check(one.init_or_resume() == "resumed" and one.start_step == TP_STEPS,
          "one rank did not resume the sharded run's checkpoint")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t
    one.run(1, log_every=0)
    got, want = one.history[0], refs["yi-6b"][TP_STEPS]
    gap = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    g_gap = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    print(f"[tp] yi-6b's checkpoint from (data 2, model 2), restored on one "
          f"rank in {t_restore:.1f} s: step {TP_STEPS} loss "
          f"{got['loss']:.5f} against the one-rank run's {want['loss']:.5f}, "
          f"relative {gap:.3g} (tol {TP_RTOL}); grad_norm "
          f"{got['grad_norm']:.5f} against {want['grad_norm']:.5f}, relative "
          f"{g_gap:.3g} (tol {TP_GRAD_RTOL})")
    check(gap <= TP_RTOL, f"the restored step's loss differs by {gap}")
    check(g_gap <= TP_GRAD_RTOL,
          f"the restored step's grad_norm differs by {g_gap}")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return (total, serve_tp_report(res, serve_refs, smi),
            seqmix_tp_report(res, seqmix_refs, smi))


# ---------------------------------------------------------------------------
# phase 7: the Flux-operator control plane over the port
# ---------------------------------------------------------------------------

OP_PROMPT_LEN = 512       # the serve cell's max_prompt_len
OP_NEW = 32
OP_REQUESTS = 12
# the plain versions a kernel replaces: none may run in the operator,
# SMOKE and pipeline phases
PLAIN = {"flash_attention.ref": ("naive", "fwd", "bwd", "chunked"),
         "decode_attention.ref": ("decode_ref", "paged_decode_ref",
                                  "paged_prefill_ref"),
         "rmsnorm.ref": ("rmsnorm_ref",), "moe_gemm.ref": ("moe_gemm_ref",)}


class _NoPlain:
    """Within the block every plain version of a kernel raises, so a run
    inside it went through the kernels alone."""

    def __enter__(self):
        import importlib
        self.saved = []
        for mod, names in PLAIN.items():
            m = importlib.import_module(f"repro_torch.kernels.{mod}")
            for n in names:
                self.saved.append((m, n, getattr(m, n)))
                setattr(m, n, self._refuse(f"{mod}.{n}"))
        return self

    @staticmethod
    def _refuse(name):
        def f(*a, **k):
            raise RuntimeError(f"chip_smoke: the plain version {name} ran "
                               f"where only the kernels may run")
        return f

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _lifecycle(h, elastic=False):
    """Print a handle's phases with their simulated times and hold it to
    Pending -> Bound -> Running (-> Resizing ...) -> Completed."""
    ev = [(e["phase"], round(e["t"], 3)) for e in h.events()]
    phases = [p for p, _ in ev]
    print(f"[operator] {h.spec.name or h.spec.kind} (job {h.job.jobid}): "
          f"lifecycle {ev}")
    check(phases[:3] == ["Pending", "Bound", "Running"]
          and phases[-1] == "Completed",
          f"{h.spec.name}: lifecycle {phases} does not run Pending -> Bound "
          f"-> Running -> ... -> Completed")
    check(("Resizing" in phases) == elastic,
          f"{h.spec.name}: Resizing {'missing' if elastic else 'unexpected'}"
          f" in {phases}")


def _release(mc):
    """Drop what every executor the instance's reconciler bound holds
    (engines, parameters, parked pools; the handles keep their records)
    before the next spec draws its own."""
    import torch
    for ex in mc.instance._workloads._executors.values():
        for attr in ("_engines", "_fleets", "_meshes", "_cache", "_params"):
            getattr(ex, attr, {}).clear()
        for ses in getattr(ex, "sessions", {}).values():
            ses.engine = ses.parked = ses.state = ses.router = None
            ses.params = None
    mc.instance._workloads._executors.clear()
    torch.cuda.empty_cache()


def operator_phase(torch, dev, build):
    """A FluxMiniCluster on a simulated ResourceGraph reaches ready, and
    WorkloadSpecs are applied with ``cfg=`` the full config:

    * yi-6b served (all 32 layers, the serve cell's engine), legacy and
      ``prefill_chunk=256``: 12 synthetic prompts of 512 tokens, 32 new
      tokens each, the streams held token for token against a direct
      Engine over the executor's parameters and the same prompts;
    * lammps-proxy (head dim 32) served the same way, chunked;
    * yi-6b with ``replicas=2`` (FleetServeExecutor: two engines on the
      one card over one parameter set): the batch, then through the
      executor's Router staggered requests sharing a 256-token prefix
      (one chunk, 16 pages) with the prefix cache on, then the same
      through a Router with the cache off: the same streams, and a hit
      for every request but the first;
    * yi-6b ``elastic=True`` (ElasticServeExecutor): the MiniCluster grows
      then shrinks mid-decode; each resize parks the engine and a fresh
      one adopts it; the streams equal the uninterrupted legacy run's;
    * lammps-proxy trained 4 steps through the SubmeshExecutor: the loss
      finite and within RESUME_RTOL of the port's Trainer stepping the
      same batch from the same seed;
    * lammps-proxy as the workload executor's payload under both
      operators (a FluxInstance job and an MPIJob on 4 hosts): the
      measured app time and both simulated walls, the paper's Figure 5.

    Every handle's lifecycle is printed and held; every plain version of
    a kernel is refused throughout (``_NoPlain``).  Returns the launch
    counts of the phase."""
    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.core import (FluxMiniCluster, JobSpec, MiniClusterSpec,
                                  MPIJob, NetModel, ResourceGraph, SimClock,
                                  TorchWorkloadExecutor)
    from repro_torch.data import synthetic_batch, to_tensors
    from repro_torch.models import params as P
    from repro_torch.serve import Engine, Router
    from repro_torch.spec import (ResourceSpec, ServeSpec, TrainSpec,
                                  WorkloadSpec)
    from repro_torch.train import Trainer

    import numpy as np

    t_phase = time.perf_counter()
    yi, lammps = registry.get("yi-6b"), registry.get("lammps-proxy")
    check(lammps.head_dim == 32, "lammps-proxy's head dim must be 32")
    clock = SimClock(seed=0)
    net = NetModel()
    mc = FluxMiniCluster(clock, net, ResourceGraph(n_pods=2, hosts_per_pod=4,
                                                   chips_per_host=8),
                         MiniClusterSpec(name="smoke", size=2, max_size=4))
    mc.create()
    ready_s = mc.wait_ready()
    print(f"[operator] MiniCluster 'smoke' (2 pods x 4 hosts x 8 chips, size "
          f"2, max 4) Ready after {ready_s:.3f} simulated s")
    opts = dict(device=dev, prompt_len=OP_PROMPT_LEN)

    def serve_spec(name, chunk=0, replicas=1, elastic=False, n_nodes=1):
        return WorkloadSpec(
            kind="serve", name=name, arch=name.split(":")[0],
            resources=ResourceSpec(n_nodes=n_nodes, elastic=elastic),
            serve=ServeSpec(n_slots=8, page_size=16, max_prompt_len=512,
                            max_seq_len=1024, max_new=OP_NEW,
                            n_requests=OP_REQUESTS, prefill_chunk=chunk,
                            replicas=replicas))

    def run_to_end(h):
        clock.run(until=clock.now + 1e6,
                  stop_when=lambda: h.phase in ("Completed", "Failed"))
        torch.cuda.synchronize()

    def prompts_of(cfg):
        return [[(7 * i + j) % cfg.vocab_size for j in range(OP_PROMPT_LEN)]
                for i in range(OP_REQUESTS)]

    def direct_streams(h, cfg, params):
        eng = Engine(cfg, h.spec.engine_config(), params=params, device=dev)
        reqs = [eng.submit(p, max_new_tokens=OP_NEW) for p in prompts_of(cfg)]
        eng.run()
        torch.cuda.synchronize()
        return [r.tokens for r in reqs]

    build.reset_launches()
    legacy = None
    with _NoPlain():
        for cfg, name, chunk in ((yi, "yi-6b:legacy", 0),
                                 (yi, "yi-6b:chunked", 256),
                                 (lammps, "lammps-proxy:chunked", 256)):
            h = mc.apply(serve_spec(name, chunk), cfg=cfg, executor_opts=opts)
            run_to_end(h)
            _lifecycle(h)
            rec = h.executor.ran[h.job.jobid]
            eng, = h.executor._engines.values()
            want = direct_streams(h, cfg, eng.params)
            differ = [i for i, (a, b) in enumerate(zip(rec["tokens"], want))
                      if a != b]
            check(len(rec["tokens"]) == OP_REQUESTS and not differ,
                  f"{name}: the executor's streams differ from a direct "
                  f"Engine's at requests {differ}")
            print(f"[operator] {name}: mesh {rec['mesh_shape']} on "
                  f"{rec['device_ids']}, {rec['n_requests']} requests, "
                  f"{rec['n_tokens']} tokens, {rec['tokens_per_s']:.1f} tok/s,"
                  f" TTFT mean {rec['ttft_mean_s'] * 1e3:.1f} ms; all streams "
                  f"equal a direct Engine's token for token")
            if name == "yi-6b:legacy":
                legacy = rec["tokens"]
            del eng
            _release(mc)

        # two replicas over one parameter set on the one card
        h = mc.apply(serve_spec("yi-6b:fleet", 256, replicas=2), cfg=yi,
                     executor_opts=opts)
        run_to_end(h)
        _lifecycle(h)
        rec = h.executor.ran[h.job.jobid]
        router, = h.executor._fleets.values()
        a, b = (P.tree_leaves(e.params) for e in router.engines)
        check(all(x.data_ptr() == y.data_ptr() for x, y in zip(a, b)),
              "the fleet's replicas must share one parameter set")
        check(rec["tokens"] == direct_streams(h, yi, router.engines[0].params),
              "the fleet's streams differ from a direct Engine's")
        print(f"[operator] yi-6b:fleet: {rec['replicas']} replicas, meshes "
              f"{rec['mesh_shapes']}, one parameter set; {rec['n_tokens']} "
              f"tokens, {rec['tokens_per_s']:.1f} tok/s; prefix cache "
              f"{rec['prefix_cache']}, desired replicas "
              f"{rec['desired_replicas']}; streams equal a direct Engine's")
        rng = np.random.default_rng(5)
        prefix = rng.integers(0, yi.vocab_size, 256).tolist()
        shared = [prefix + rng.integers(0, yi.vocab_size, 64).tolist()
                  for _ in range(6)]

        def staggered(r):
            """The first request alone until its prompt is prefilled (and,
            with the cache on, registered: the same tick), then the rest."""
            reqs = [r.submit(shared[0], max_new_tokens=8)]
            while not reqs[0].tokens:
                check(r.step(), "the fleet idled mid-prefill")
            reqs += [r.submit(p, max_new_tokens=8) for p in shared[1:]]
            r.run()
            torch.cuda.synchronize()
            return [q.tokens for q in reqs]

        hits0 = router.prefix_cache.hits
        t = time.perf_counter()
        warm = staggered(router)
        t_warm = time.perf_counter() - t
        hits = router.prefix_cache.hits - hits0
        t = time.perf_counter()
        cold = staggered(Router(router.engines, prefix_cache=False))
        t_cold = time.perf_counter() - t
        check(warm == cold, "prefix adoption changed the greedy streams")
        check(hits >= len(shared) - 1, f"the prefix cache hit {hits} times "
              f"for {len(shared) - 1} requests sharing a cached prefix")
        print(f"[operator] fleet prefix cache: {len(shared)} staggered "
              f"requests sharing a 256-token prefix, {hits} hits; cache on "
              f"{t_warm:.2f} s, off {t_cold:.2f} s; the same streams token "
              f"for token")
        del router, a, b
        _release(mc)

        # elastic: grow, then shrink, mid-decode
        h = mc.apply(serve_spec("yi-6b:elastic", n_nodes=2, elastic=True),
                     cfg=yi, executor_opts=opts)
        ex, job = h.executor, h.job

        def ticks():
            ses = ex.sessions.get(job.jobid)
            return 0 if ses is None else ses.ticks

        clock.run(until=clock.now + 1e6, stop_when=lambda: ticks() >= 6)
        mc.patch_size(4)
        check(h.phase == "Resizing", "the grow did not open a resize")
        clock.run(until=clock.now + 1e6, stop_when=lambda: (
            len(ex.sessions[job.jobid].resumes) >= 1 and ticks() >= 14))
        mc.patch_size(2)
        check(h.phase == "Resizing", "the shrink did not open a resize")
        run_to_end(h)
        _lifecycle(h, elastic=True)
        rec, ses = ex.ran[job.jobid], ex.sessions[job.jobid]
        check(rec["n_resumes"] == 2, f"{rec['n_resumes']} resumes, expected 2")
        differ = [i for i, (a, b) in enumerate(zip(rec["tokens"], legacy))
                  if a != b]
        check(not differ, f"the resized run's streams differ from the "
              f"uninterrupted legacy run's at requests {differ}")
        print(f"[operator] yi-6b:elastic: resumes "
              f"{[(r['transition'], r['tick']) for r in rec['resumes']]}; "
              f"park {[round(x, 4) for x in ses.park_s]} s, adopt "
              f"{[round(x, 4) for x in ses.adopt_s]} s, rebuild "
              f"{[round(r['rebuild_s'], 4) for r in rec['resumes']]} s; all "
              f"{len(rec['tokens'])} streams equal the uninterrupted legacy "
              f"run's token for token")
        del ex, ses
        _release(mc)

        # lammps-proxy trained through the SubmeshExecutor
        steps, seq = 4, 2048
        h = mc.apply(WorkloadSpec(kind="train", name="lammps-proxy:train",
                                  arch="lammps-proxy",
                                  train=TrainSpec(total_steps=steps,
                                                  seq_len=seq)),
                     cfg=lammps, executor_opts=dict(device=dev))
        run_to_end(h)
        _lifecycle(h)
        rec = h.executor.ran[h.job.jobid]
        shape = WorkloadShape("submesh", "train", seq, 2)
        tr = Trainer(lammps, TrainConfig(total_steps=steps, warmup_steps=0),
                     shape, seed=0, device=dev)
        tr.init_or_resume()
        batch = to_tensors(synthetic_batch(lammps, shape), dev)
        for _ in range(1 + steps):            # the executor's warm step too
            tr.state, metrics = tr._step(tr.state, batch)
        loss = float(metrics["loss"])
        check(np.isfinite(rec["loss"]) and abs(rec["loss"] - loss)
              <= RESUME_RTOL * abs(loss), f"the train executor's loss "
              f"{rec['loss']} differs from the Trainer's {loss}")
        print(f"[operator] lammps-proxy:train: mesh {rec['mesh_shape']}, "
              f"{steps} steps of 2 x {seq} in {rec['measured_s'] * 1e3:.1f} ms"
              f", loss {rec['loss']:.6f} (the Trainer over the same batch "
              f"{loss:.6f}, rtol {RESUME_RTOL})")
        del tr, batch
        _release(mc)

        # the paper's Figure 5: one app under both operators
        ex = TorchWorkloadExecutor(clock, net, steps=3, cfg=lammps,
                                   device=dev)
        mc.instance._set_executor(ex)      # plain JobSpecs route to it
        job = mc.instance.submit(JobSpec(n_nodes=2, walltime=100.0,
                                         command="lammps-proxy"))
        clock.run(until=clock.now + 1e6, stop_when=lambda: job.t_done)
        mj = MPIJob(clock, net, ResourceGraph(1, 8, 8), n_workers=2,
                    executor=ex.mpi_executor())
        mj.create()
        clock.run(until=clock.now + 1e6,
                  stop_when=lambda: mj.status.phase == "Running")
        walls = []
        mj.mpirun(JobSpec(n_nodes=2, command="lammps-proxy"), walls.append)
        clock.run(until=clock.now + 1e6, stop_when=lambda: walls)
        check(job.result == "completed" and walls, "a Figure 5 run did not "
              "finish")
        print(f"[operator] lammps-proxy workload (3 forward steps of 2 x 32): "
              f"Flux job on 2 hosts, measured {ex.measured[job.jobid] * 1e3:.3f}"
              f" ms a host, simulated wall {job.t_done - job.t_run:.4f} s "
              f"(TBON bootstrap {job.t_done - job.t_run - ex.measured[job.jobid]:.4f} s);"
              f" MPIJob on 2 workers: app wall {walls[0]:.4f} s, launcher "
              f"handshake {mj.status.t_launched:.4f} s")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"[operator] launches in the phase: "
          + ", ".join(f"{k} {launches[k]}" for k in (
              "rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "paged_prefill", "paged_decode", "decode_attention"))
          + f"; no plain version ran; {time.perf_counter() - t_phase:.1f} s")
    for k in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "paged_prefill", "paged_decode"):
        check(launches[k] > 0, f"the operator phase never launched {k}")
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the operator on meshes of ranks: a pool of four gloo ranks of
# the one card that Flux allocations map onto
# ---------------------------------------------------------------------------

OPR_LAYERS = 4              # of yi-6b's 32 (8 took the script past 1150 s)
OPR_REQUESTS = 4            # 8 with yi at 4 layers: the script 1171.2 s
OPR_NEW = 16
OPR_CHUNK = 256
OPR_TRAIN_STEPS = 9
OPR_SEQ = 2048
OPR_TIMEOUT_S = 600         # each command on the ranks (and gloo's timeout)


def _slot_ids(mesh):
    return [d.index for d in mesh.devices.flat]


def _first_parting(got, want):
    """(request, tick) where ``got`` first parts from ``want``, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i, next((k for k, (x, y) in enumerate(zip(a, b))
                            if x != y), min(len(a), len(b)))
    return None if len(got) == len(want) else (min(len(got), len(want)), 0)


def _tick_line(ticks, reqs, n_tok):
    """Rank 0's decode tick median (ms), TTFT median (ms) and tok/s over
    the seconds its ticks took."""
    ttft = sorted(r.ttft for r in reqs if r.ttft is not None)
    busy = sum(s for _, s in ticks)
    return (f"{_decode_median(ticks)}, TTFT median "
            f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, {n_tok / busy:.1f} tok/s "
            f"over its {busy:.2f} s of ticks")


def _decode_median(ticks):
    """Rank 0's decode tick median (ms) over ``ticks``, (kind, s) each."""
    dec = sorted(s for k, s in ticks if k == "decode")
    return (f"rank 0's decode tick median {dec[len(dec) // 2] * 1e3:.2f} ms "
            f"over {len(dec)}")


def operator_ranks_phase(torch, dev, build, smi):
    """The executors on meshes of ranks: one ``RankPool(4)`` of the one
    card, whose slots Flux allocations map onto (``ResourceGraph`` of 1
    pod x 2 hosts x 2 chips: a host's chips are the ``model`` axis, and
    no allocation degrades):

    * yi-6b at full width and OPR_LAYERS of 32 layers, elastic serving
      (8 slots, page 16, prompts up to 512, 1024 in all; OPR_REQUESTS
      greedy requests of 64-512 tokens, OPR_NEW new each, legacy,
      ``dp_shards`` 1): grown from 1 to 2 hosts mid-decode, (1, 2) ->
      (2, 2), then a second run shrunk from 2 to 1; with ``model`` 2 on
      both meshes each data rank repeats the one-data-rank tick, so the
      streams must equal the uninterrupted run's on the starting mesh
      token for token;
    * yi-6b the same depth through the ServeExecutor on a 2-host
      allocation, (2, 2), chunked (OPR_CHUNK), 4 requests, against the
      one-rank eager engine of the same seed (the serve_tp parting rule);
    * lammps-proxy at full size (head dim 32) through the
      SubmeshExecutor on (2, 2), its loss against one rank's step over
      the same batch; then through the ElasticTrainExecutor on 1 pod x
      4 hosts x 1 chip, OPR_TRAIN_STEPS steps of 8 x OPR_SEQ, grown 2 ->
      4 and shrunk 4 -> 2 hosts through the checkpoint, (2, 1) -> (4, 1)
      -> (2, 1), the losses against a one-rank Trainer's within TP_RTOL.

    Prints each placement's mesh, slot ids and ``ran`` record, each
    resize's transition and its park/adopt or save/restore seconds, rank
    0's decode tick, TTFT and tok/s, each rank's peak allocation and the
    phase's seconds.  Returns the ranks' launch counts over the
    executors' runs (the uninterrupted references' aside).  The pool
    opens at the phase's start; the one-rank references run on this
    process's card while its ranks start."""
    import numpy as np
    from repro_torch.configs import TrainConfig, WorkloadShape, registry, yi_6b
    from repro_torch.core import (FluxMiniCluster, JobState, MiniClusterSpec,
                                  NetModel, ResourceGraph, SimClock)
    from repro_torch.data import synthetic_batch, to_tensors
    from repro_torch.dist.ranks import RankPool
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.remote import RemoteEngine
    from repro_torch.spec import (ResourceSpec, ServeSpec, TrainSpec,
                                  WorkloadSpec)
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    yi = dataclasses.replace(yi_6b.CONFIG, n_layers=OPR_LAYERS)
    lammps = registry.get("lammps-proxy")
    prompts = serve_tp_prompts(yi, OPR_REQUESTS)
    ecfg = dict(n_slots=8, page_size=16, max_prompt_len=512,
                max_seq_len=1024)
    sub_steps = 3
    gc.collect()
    torch.cuda.empty_cache()
    # the ranks start (spawn, import torch) while this process runs the
    # one-rank references; they take the card at their first command
    pool = RankPool(4, timeout=OPR_TIMEOUT_S)
    total = {}

    def tally():
        for k, v in pool.launches(reset=True).items():
            total[k] = total.get(k, 0) + v

    def cluster(name, hosts, chips, size, max_size):
        clock = SimClock(seed=0)
        mc = FluxMiniCluster(clock, NetModel(), ResourceGraph(
            n_pods=1, hosts_per_pod=hosts, chips_per_host=chips),
            MiniClusterSpec(name=name, size=size, max_size=max_size))
        mc.create()
        mc.wait_ready()
        return clock, mc

    def until(clock, cond, what):
        clock.run(until=clock.now + 1e6, stop_when=cond)
        check(cond(), f"operator_ranks: {what} not reached")

    def uninterrupted(shape):
        eng = RemoteEngine(yi, EngineConfig(**ecfg), mesh=pool.mesh(shape),
                           seed=0)
        reqs = [eng.submit(p, max_new_tokens=OPR_NEW) for p in prompts]
        eng.run()
        eng.close()
        check(all(r.finished and len(r.tokens) == OPR_NEW for r in reqs),
              "an uninterrupted request did not finish")
        return [r.tokens for r in reqs], eng, reqs

    def elastic_serve(size, patch_to, want):
        clock, mc = cluster(f"es{size}", 2, 2, size, 2)
        name = f"yi-6b:elastic {size}->{patch_to}"
        h = mc.apply(WorkloadSpec(
            kind="serve", name=name, arch="yi-6b",
            resources=ResourceSpec(n_nodes=size, elastic=True),
            serve=ServeSpec(max_new=OPR_NEW, n_requests=OPR_REQUESTS,
                            **ecfg)), cfg=yi,
            # 40 simulated s a tick: the grow's new host boots (~115 s)
            # while the old mesh decodes, as in tests/test_elastic_serve.py
            executor_opts=dict(ranks=pool, sim_tick_time=40.0))
        ex, job = h.executor, h.job
        job.spec.args["prompts"] = prompts
        pool.launches(reset=True)
        until(clock, lambda: job.jobid in ex.sessions
              and ex.sessions[job.jobid].ticks >= 4, "4 ticks")
        ses = ex.sessions[job.jobid]
        first, old = (tuple(ses.mesh.devices.shape),
                      _slot_ids(ses.mesh)), ses.engine
        mc.patch_size(patch_to)
        check(h.phase == "Resizing", f"{name}: the patch opened no resize")
        until(clock, lambda: job.state == JobState.INACTIVE, f"{name}'s end")
        tally()
        _lifecycle(h, elastic=True)
        rec = ex.ran[job.jobid]
        res = rec["resumes"]
        print(f"[operator_ranks] {name}: placed on {first[0]} slots "
              f"{first[1]}, then {rec['mesh_shape']} slots "
              f"{_slot_ids(ses.mesh)}; resumes "
              f"{[(r['transition'], r['tick'], r['mesh_shape']) for r in res]}"
              f"; park {[round(x, 3) for x in ses.park_s]} s, adopt "
              f"{[round(x, 3) for x in ses.adopt_s]} s, rebuild "
              f"{[round(r['rebuild_s'], 3) for r in res]} s; ran "
              f"{ {k: rec[k] for k in ('n_devices', 'hosts', 'n_requests', 'n_tokens', 'ticks', 'n_resumes')} }; "
              + _tick_line(old.ticks + ses.engine.ticks, ses.requests,
                           rec["n_tokens"]))
        check(rec["n_resumes"] == 1 and res[0]["transition"] ==
              f"{size}->{patch_to}", f"{name}: resumes {res}")
        check(rec["mesh_shape"] == (patch_to, 2), f"{name}: ended on "
              f"{rec['mesh_shape']}")
        part = _first_parting(rec["tokens"], want)
        check(part is None, f"{name}: the streams part from the "
              f"uninterrupted run's at (request, tick) {part}")
        print(f"[operator_ranks] {name}: all {len(want)} streams equal the "
              f"uninterrupted run's on {first[0]} token for token")

    try:
        # the one-rank references on this process's card: the chunked
        # engine (streams, logits and the bf16 logit error), lammps-proxy's
        # loss over the submesh batch and its uninterrupted losses
        t = time.perf_counter()
        one = Engine(yi, EngineConfig(**ecfg, prefill_chunk=OPR_CHUNK),
                     seed=0, device=dev, cuda_graphs=False)
        logits_of = _record_logits(one)
        reqs = [one.submit(p, max_new_tokens=OPR_NEW) for p in prompts[:4]]
        one.run()
        err = float((forced_logits(torch, dev, yi, one.params) -
                     forced_logits(torch, dev, yi, one.params, "ref",
                                   torch.float32)).abs().max())
        one_streams = [r.tokens for r in reqs]
        one_logits = [logits_of[r.rid] for r in reqs]
        del one, logits_of, reqs
        torch.cuda.empty_cache()
        tr = Trainer(lammps, TrainConfig(total_steps=sub_steps,
                                         warmup_steps=0),
                     WorkloadShape("submesh", "train", OPR_SEQ, 4), seed=0,
                     device=dev)
        tr.init_or_resume()
        batch = to_tensors(synthetic_batch(lammps, tr.shape), dev)
        for _ in range(1 + sub_steps):        # the executor's warm step too
            tr.state, metrics = tr._step(tr.state, batch)
        sub_loss = float(metrics["loss"])
        del tr, batch, metrics
        one = Trainer(lammps, TrainConfig(total_steps=OPR_TRAIN_STEPS,
                                          warmup_steps=0),
                      WorkloadShape("elastic", "train", OPR_SEQ, 8), seed=0,
                      device=dev)
        el_want = [r["loss"] for r in one.run(OPR_TRAIN_STEPS, log_every=0)]
        del one
        gc.collect()
        torch.cuda.empty_cache()
        t_refs = time.perf_counter() - t
        pool.run(range(pool.n), "repro_torch.dist.ranks:_ping")
        print(f"[operator_ranks] one-rank references in {t_refs:.1f} s; "
              f"RankPool(4) on {pool.devices} answering "
              f"{time.perf_counter() - t:.1f} s into the phase")

        # elastic serving across (1, 2) and (2, 2)
        t = time.perf_counter()
        ref12, eng12, reqs12 = uninterrupted((1, 2))
        ref22, eng22, reqs22 = uninterrupted((2, 2))
        check(ref22 == ref12, f"(2, 2)'s uninterrupted streams part from "
              f"(1, 2)'s at {_first_parting(ref22, ref12)}")
        for shape, eng, reqs in (((1, 2), eng12, reqs12),
                                 ((2, 2), eng22, reqs22)):
            print(f"[operator_ranks] yi-6b ({OPR_LAYERS} of 32 layers) "
                  f"uninterrupted on {shape}, {OPR_REQUESTS} requests of "
                  f"{min(map(len, prompts))}-{max(map(len, prompts))} "
                  f"tokens: " + _tick_line(eng.ticks, reqs,
                                           OPR_REQUESTS * OPR_NEW))
        elastic_serve(1, 2, ref12)
        elastic_serve(2, 1, ref22)
        print(f"[operator_ranks] elastic serving: "
              f"{time.perf_counter() - t:.1f} s")

        # the ServeExecutor on a 2-host allocation, chunked
        t = time.perf_counter()
        clock, mc = cluster("serve", 2, 2, 2, 2)
        h = mc.apply(WorkloadSpec(
            kind="serve", name="yi-6b:chunked", arch="yi-6b",
            resources=ResourceSpec(n_nodes=2),
            serve=ServeSpec(max_new=OPR_NEW, n_requests=4,
                            prefill_chunk=OPR_CHUNK, **ecfg)),
            cfg=yi, executor_opts=dict(ranks=pool))
        h.job.spec.args["prompts"] = prompts[:4]
        pool.launches(reset=True)
        until(clock, lambda: h.phase in ("Completed", "Failed"), "the end")
        tally()
        _lifecycle(h)
        rec = h.executor.ran[h.job.jobid]
        eng, = h.executor._engines.values()
        limit = (1 + LOGIT_NOISE_FACTOR) * err
        gaps = _parting(rec["tokens"], one_streams, one_logits)
        for i, k, gap in gaps:
            check(gap <= limit, f"yi-6b:chunked on (2, 2): request {i} parts "
                  f"from the one-rank stream at step {k} by {gap:.5f} (limit "
                  f"{limit:.5f})")
        print(f"[operator_ranks] yi-6b:chunked: mesh {rec['mesh_shape']} "
              f"slots {rec['device_ids']}, ran "
              f"{ {k: rec[k] for k in ('n_devices', 'hosts', 'n_requests', 'n_tokens', 'tokens_per_s', 'ttft_mean_s', 'measured_s')} }; "
              f"{len(gaps)} of 4 streams part from the one-rank eager "
              f"engine's (request, step, gap) {gaps}, limit {limit:.5f} "
              f"(1 + {LOGIT_NOISE_FACTOR}) x one rank's largest teacher-"
              f"forced logit error {err:.5f}; "
              + _decode_median(eng.ticks)
              + f"; {time.perf_counter() - t:.1f} s")
        eng.close()

        # lammps-proxy through the SubmeshExecutor on (2, 2)
        t = time.perf_counter()
        clock, mc = cluster("submesh", 2, 2, 2, 2)
        h = mc.apply(WorkloadSpec(
            kind="train", name="lammps-proxy:submesh", arch="lammps-proxy",
            resources=ResourceSpec(n_nodes=2),
            train=TrainSpec(total_steps=sub_steps, seq_len=OPR_SEQ)),
            cfg=lammps, executor_opts=dict(ranks=pool))
        pool.launches(reset=True)
        until(clock, lambda: h.phase in ("Completed", "Failed"), "the end")
        tally()
        placed_s = time.perf_counter() - t
        _lifecycle(h)
        rec = h.executor.ran[h.job.jobid]
        loss = sub_loss
        gap = abs(rec["loss"] - loss) / abs(loss)
        print(f"[operator_ranks] lammps-proxy:submesh: mesh "
              f"{rec['mesh_shape']} slots {rec['device_ids']}, ran "
              f"{ {k: rec[k] for k in ('n_devices', 'hosts', 'loss', 'measured_s')} }; "
              f"one rank's loss over the same batch {loss:.6f}, relative "
              f"{gap:.3g} (tol {TP_RTOL}); placed, built, warmed and run in "
              f"{placed_s:.1f} s; {time.perf_counter() - t:.1f} s")
        check(np.isfinite(rec["loss"]) and gap <= TP_RTOL,
              f"lammps-proxy on (2, 2): loss {rec['loss']} against {loss}")

        # lammps-proxy elastic: 2 -> 4 -> 2 hosts through the checkpoint
        t = time.perf_counter()
        clock, mc = cluster("el", 4, 1, 2, 4)
        h = mc.apply(WorkloadSpec(
            kind="train", name="lammps-proxy:elastic", arch="lammps-proxy",
            resources=ResourceSpec(n_nodes=2, elastic=True),
            train=TrainSpec(total_steps=OPR_TRAIN_STEPS, global_batch=8,
                            seq_len=OPR_SEQ)),
            cfg=lammps, executor_opts=dict(ranks=pool, sim_step_time=60.0))
        ex, job = h.executor, h.job
        saves, save = [], ex._save

        def timed_save(ses, source):
            t0 = time.perf_counter()
            save(ses, source)
            saves.append((source, round(time.perf_counter() - t0, 3)))

        ex._save = timed_save
        pool.launches(reset=True)
        until(clock, lambda: job.jobid in ex.sessions
              and ex.sessions[job.jobid].step >= 2, "step 2")
        ses = ex.sessions[job.jobid]
        at_grow = ses.step
        mc.patch_size(4)
        until(clock, lambda: ses.step >= 5 and len(ses.resumes) >= 1,
              "the grow's resume")
        mc.patch_size(2)
        until(clock, lambda: job.state == JobState.INACTIVE, "the end")
        tally()
        _lifecycle(h, elastic=True)
        rec = ex.ran[job.jobid]
        want = el_want
        gaps = [abs(a - b) / abs(b) for a, b in zip(ses.losses, want)]
        meshes = [tuple(s["mesh_shape"]) for s in ses.segments]
        print(f"[operator_ranks] lammps-proxy:elastic: segments "
              f"{[(s['mesh_shape'], s['hosts'], s['from_step'], s['steps']) for s in ses.segments]}"
              f"; resumes {[(r['transition'], r['step'], r['mesh_shape'], round(r['restore_s'], 3)) for r in ses.resumes]}"
              f" (restore s); saves (source, s) {saves}; ran "
              f"{ {k: rec[k] for k in ('mesh_shape', 'n_devices', 'hosts', 'loss', 'steps', 'n_resumes')} }; "
              f"losses against one rank's Trainer: largest relative gap "
              f"{max(gaps):.3g} (tol {TP_RTOL}); steps on rank 0 "
              f"{[round(s['wall_s'], 3) for s in ses.segments]} s a segment"
              f"; {time.perf_counter() - t:.1f} s")
        check([r["transition"] for r in ses.resumes] == ["2->4", "4->2"],
              f"lammps-proxy:elastic: resumes {ses.resumes}")
        check(meshes == [(2, 1), (4, 1), (2, 1)],
              f"lammps-proxy:elastic: meshes {meshes}")
        check(ses.resumes[0]["step"] > at_grow, "the grow paused training")
        check(len(ses.losses) == OPR_TRAIN_STEPS and max(gaps) <= TP_RTOL,
              f"lammps-proxy:elastic: losses {ses.losses} against {want}")
        peaks = pool.peak_gb()
    finally:
        pool.close()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[operator_ranks] peak GB allocated a rank {[round(p, 2) for p in peaks]}"
          f"; launches on the ranks in the executors' runs "
          + ", ".join(f"{k} {total.get(k, 0)}" for k in (
              "rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "paged_prefill", "paged_decode"))
          + f"; {time.perf_counter() - t_phase:.1f} s ({smi})")
    for k in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "paged_prefill", "paged_decode"):
        check(total.get(k, 0) > 0, f"the operator_ranks phase never "
              f"launched {k} on a rank")
    return total


# ---------------------------------------------------------------------------
# phase 8: the SMOKE configs on the card, the pipeline launcher, and the
# train -> gate -> canary-promote pipeline at full width
# ---------------------------------------------------------------------------

SMOKE_ARCHS = {"yi-6b": 16, "granite-moe-1b-a400m": 16, "lammps-proxy": 16,
               "jamba-v0.1-52b": 16, "xlstm-1.3b": 16,
               "qwen2-72b": 8}      # arch -> its SMOKE config's head dim


def smoke_phase(torch, dev, build):
    """The executors' default configs, SMOKE, on the card: WorkloadSpecs
    applied without ``cfg=`` (every plain version refused throughout),
    one for each executor kind: the reference's quickstart (yi-6b,
    granite-moe-1b-a400m and lammps-proxy trained on 4, 2 and 2 nodes),
    yi-6b served legacy and chunked, granite served chunked, qwen2-72b
    (head dim 8) trained and served both ways, the committed
    ``serve_fleet.json`` (two replicas) and ``serve_batch.json`` (elastic
    serve), an elastic train of yi-6b and an elastic fleet of two yi-6b
    replicas, jamba-v0.1-52b and xlstm-1.3b served, elastic-served,
    trained and elastic-trained, and a plain Flux job whose payload is qwen2-72b's SMOKE
    forward.  Every
    handle completes through Pending, Bound and Running; each served
    stream equals a direct Engine's over the executor's parameters; each
    head dim's specs launched every attention kernel but the contiguous
    decode (counted before the checks' Engines run).  Returns the launch
    counts."""
    import shutil
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.core import (FluxMiniCluster, JobSpec, MiniClusterSpec,
                                  NetModel, ResourceGraph, SimClock,
                                  TorchWorkloadExecutor)
    from repro_torch.serve import Engine
    from repro_torch.spec import (ResourceSpec, ServeSpec, TrainSpec,
                                  WorkloadSpec, load_spec)

    for arch, d in SMOKE_ARCHS.items():
        check(registry.smoke(arch).head_dim == d,
              f"{arch}'s SMOKE config has head dim "
              f"{registry.smoke(arch).head_dim}, not {d}")
    t0 = time.perf_counter()
    clock = SimClock(seed=0)
    net = NetModel()
    mc = FluxMiniCluster(clock, net, ResourceGraph(n_pods=2, hosts_per_pod=16,
                                                   chips_per_host=4),
                         MiniClusterSpec(name="smoke-cfg", size=16,
                                         max_size=16))
    mc.create()
    mc.wait_ready()
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_smoke_",
                                 dir=ROOT / "build"))
    opts = dict(device=dev)
    serve = dict(n_slots=4, page_size=8, max_prompt_len=16, max_seq_len=48,
                 max_new=12, n_requests=3)

    def spec(kind, arch, nodes=1, elastic=False, **kw):
        sub = ({"train": TrainSpec(**kw)} if kind == "train"
               else {"serve": ServeSpec(**kw)})
        return WorkloadSpec(kind=kind, arch=arch, name=f"smoke-{arch}",
                            resources=ResourceSpec(n_nodes=nodes,
                                                   elastic=elastic), **sub)

    # head dim 16 first, then 8 (qwen2-72b), each group's launches apart
    groups = {16: [spec("train", a, n, total_steps=1, seq_len=16) for a, n in
                   (("yi-6b", 4), ("granite-moe-1b-a400m", 2),
                    ("lammps-proxy", 2))] + [
        spec("serve", "yi-6b", **serve),
        spec("serve", "yi-6b", prefill_chunk=8, **serve),
        spec("serve", "granite-moe-1b-a400m", prefill_chunk=8, **serve),
        load_spec(str(ROOT / "examples/specs/serve_fleet.json")),
        load_spec(str(ROOT / "examples/specs/serve_batch.json")),
        spec("train", "yi-6b", 2, elastic=True, total_steps=4, chunk_steps=2,
             global_batch=4, seq_len=32, ckpt_dir=str(ckpt)),
        spec("serve", "yi-6b", elastic=True, replicas=2, **serve)] + [
        spec("serve", a, elastic=elastic, **serve)
        for a in ("jamba-v0.1-52b", "xlstm-1.3b") for elastic in (False, True)
    ] + [spec("train", a, 1, total_steps=1, seq_len=16)
         for a in ("jamba-v0.1-52b", "xlstm-1.3b")] + [
        spec("train", a, 2, elastic=True, total_steps=4, chunk_steps=2,
             global_batch=4, seq_len=32, ckpt_dir=str(ckpt))
        for a in ("jamba-v0.1-52b", "xlstm-1.3b")],
        8: [spec("train", "qwen2-72b", 2, total_steps=1, seq_len=16),
            spec("serve", "qwen2-72b", **serve),
            spec("serve", "qwen2-72b", prefill_chunk=8, **serve)]}
    ex = TorchWorkloadExecutor(clock, net, steps=2, device=dev)
    total = dict.fromkeys(build.LAUNCHES, 0)
    try:
        for d, specs in groups.items():
            build.reset_launches()
            with _NoPlain():
                handles = [mc.apply(s, executor_opts=opts) for s in specs]
                job = None
                if d == 8:
                    mc.instance._set_executor(ex)   # plain JobSpecs go here
                    job = mc.instance.submit(JobSpec(
                        n_nodes=1, walltime=100.0, command="qwen2-72b"))
                clock.run(until=clock.now + 1e6, stop_when=lambda: all(
                    h.done for h in handles) and (job is None or job.t_done))
                torch.cuda.synchronize()
                launches = dict(build.LAUNCHES)  # the specs' own, no check's
                for h in handles:
                    phases = [e["phase"] for e in h.events()]
                    check(phases[:3] == ["Pending", "Bound", "Running"]
                          and phases[-1] == "Completed",
                          f"{h.spec.name} ({h.spec.kind}): lifecycle {phases}")
                    rec = h.executor.ran[h.job.jobid]
                    engines = getattr(h.executor, "_engines", {})
                    streams = ""
                    if type(h.executor).__name__ == "ServeExecutor":
                        eng, = [e for k, e in engines.items()
                                if k[0] == h.spec.arch]
                        direct = Engine(eng.cfg, h.spec.engine_config(),
                                        params=eng.params, device=dev)
                        plen = min(8, eng.ecfg.max_prompt_len)
                        reqs = [direct.submit([(7 * i + j) % eng.cfg.vocab_size
                                               for j in range(plen)],
                                              max_new_tokens=len(t))
                                for i, t in enumerate(rec["tokens"])]
                        direct.run()
                        check(rec["tokens"] == [r.tokens for r in reqs],
                              f"{h.spec.name}: the served streams differ from a "
                              f"direct Engine's")
                        streams = "; streams equal a direct Engine's"
                    res = h.result()
                    print(f"[smoke] {h.spec.kind} {h.spec.arch} (head dim "
                          f"{SMOKE_ARCHS[h.spec.arch]}, "
                          f"{type(h.executor).__name__}): {' -> '.join(phases)};"
                          f" {({k: v for k, v in res.items() if k in ('final_loss', 'steps', 'n_tokens', 'replicas')})}"
                          f"{streams}")
                if job is not None:
                    check(job.result == "completed", "the plain Flux job failed")
                    print(f"[smoke] plain Flux job, payload qwen2-72b SMOKE "
                          f"(head dim 8): 2 forward steps measured "
                          f"{ex.measured[job.jobid] * 1e3:.3f} ms")
            print(f"[smoke] launches at head dim {d}: " + ", ".join(
                f"{k} {n}" for k, n in launches.items() if n))
            moe = ("moe_gemm",) if d == 16 else ()   # qwen2-72b is dense
            for k in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "paged_prefill", "paged_decode") + moe:
                check(launches[k] > 0, f"the SMOKE specs at head dim {d} "
                      f"never launched {k}")
            for k, n in launches.items():
                total[k] += n
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[smoke] no plain version ran; {time.perf_counter() - t0:.1f} s")
    _release(mc)
    return total


def pipeline_cli(torch):
    """``python -m repro_torch.launch.pipeline`` on the committed
    ``pipeline_canary.json`` (yi-6b SMOKE, head dim 16) on the card, with
    its trace written and held to ``tools/validate_trace.py``."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pipe_", dir=ROOT / "build"))
    trace = tmp / "TRACE_pipeline.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.pipeline",
             "--pipeline", str(ROOT / "examples/specs/pipeline_canary.json"),
             "--trace", str(trace)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        check(run.returncode == 0, f"launch.pipeline exited {run.returncode}:"
              f" {run.stdout[-2000:]} {run.stderr[-2000:]}")
        status = json.loads(run.stdout[run.stdout.index("{"):
                                       run.stdout.rindex("}") + 1])
        val = subprocess.run([sys.executable, str(ROOT / "tools" /
                                                  "validate_trace.py"),
                              str(trace)], capture_output=True, text=True,
                             timeout=120)
        check(val.returncode == 0, f"validate_trace.py refused the "
              f"pipeline's trace: {val.stdout} {val.stderr}")
        doc = json.loads(trace.read_text())
        print(f"[pipeline] launch.pipeline on pipeline_canary.json (yi-6b "
              f"SMOKE, head dim 16): {status['phase']}, stages "
              f"{ {n: st['phase'] for n, st in status['stages'].items()} }; "
              f"trace of {len(doc['traceEvents'])} events passes "
              f"validate_trace.py (backend {doc['otherData']['backend']}, "
              f"device {doc['otherData'].get('device')}); "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PIPE_STEPS, PIPE_CHUNK, PIPE_BATCH, PIPE_SEQ = 6, 2, 4, 4096
PIPE_EXTRA = 4              # requests submitted once the promotion is done


def _timed(torch, ckpt, log):
    """Record each save's and restore's seconds and the step's bytes on
    disk (and the whole root's, for the peak) in ``log``."""
    save, restore = ckpt.save, ckpt.restore_latest

    def du(path):
        return sum(f.stat().st_size for f in Path(path).rglob("*")
                   if f.is_file())

    def timed_save(state, step, meta=None):
        t = time.perf_counter()
        save(state, step, meta=meta)
        ckpt.wait()
        log.append(("save", step, time.perf_counter() - t,
                    du(Path(ckpt.dir) / f"step_{step:08d}"), du(ckpt.dir)))

    def timed_restore(template, device=None):
        t = time.perf_counter()
        out = restore(template, device)
        torch.cuda.synchronize()
        log.append(("restore", out[1], time.perf_counter() - t, None,
                    du(ckpt.dir)))
        return out

    ckpt.save, ckpt.restore_latest = timed_save, timed_restore


def granite_pipeline(torch, dev, build):
    """The slice's path at full width: a PipelineSpec with the DAG of
    ``pipeline_canary.json`` over granite-moe-1b-a400m (PIPE_LAYERS of 24,
    d_model 1024, 32 experts top-8):

    * ``train``: an elastic train on 2 nodes, 6 steps of 4 x 4096 in
      chunks of 2, grown to 4 nodes after the first chunk
      (``patch_size(4)``) and shrunk to 2 once the grow has landed;
      every checkpoint (the JAX format, under a temporary directory of
      ``build/`` that the phase removes) timed and sized; its losses
      against an uninterrupted Trainer of the same config and seed;
    * ``eval-gate``: ``final_loss lt 12.0``;
    * ``fleet``: an elastic fleet of 2 replicas (n_slots 8, page 16,
      prompts up to 512, 12 requests of 512 tokens, 32 new), fired once
      the train stage has completed, where ``pipeline_canary.json``
      starts it at once: an elastic fleet follows a MiniCluster resize
      as the elastic train does (both want the cluster's new size), so
      the two cannot both grow in one cluster at once;
    * ``promote``: the trained params rolled into the live fleet replica
      by replica; then PIPE_EXTRA more requests, which the promoted
      replicas serve.

    Held: no request dropped; every stream's tokens up to its replica's
    swap equal a direct Engine's over the fleet's first params; the
    extra requests' streams equal a direct Engine's over the trained
    params restored from the checkpoint.  The caller refuses every plain
    version throughout (``_NoPlain``).  Returns the launch counts of the
    pipeline's run, taken before the checks' Engines run."""
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.core import (FluxMiniCluster, MiniClusterSpec, NetModel,
                                  ResourceGraph, SimClock)
    from repro_torch.core.executor import serving_params
    from repro_torch.dist import steps as dsteps
    from repro_torch.flow import (GateSpec, PipelineSpec, PromoteSpec,
                                  StageSpec, TriggerSpec)
    from repro_torch.serve import Engine
    from repro_torch.spec import (ResourceSpec, ServeSpec, TrainSpec,
                                  WorkloadSpec)
    from repro_torch.train import Trainer

    import numpy as np

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get("granite-moe-1b-a400m"),
                              n_layers=PIPE_LAYERS)
    tcfg = TrainConfig(total_steps=PIPE_STEPS, warmup_steps=0)
    shape = WorkloadShape("elastic", "train", PIPE_SEQ, PIPE_BATCH)
    tr = Trainer(cfg, tcfg, shape, seed=0, device=dev)
    ref = [h["loss"] for h in tr.run(PIPE_STEPS, log_every=0)]
    del tr
    torch.cuda.empty_cache()
    print(f"[pipeline] {cfg.name} at full width and {cfg.n_layers} of 24 "
          f"layers (cut for time: a checkpoint at every resize), "
          f"uninterrupted Trainer, {PIPE_STEPS} steps of {PIPE_BATCH} x "
          f"{PIPE_SEQ}: losses {[round(x, 6) for x in ref]}")

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_",
                                 dir=ROOT / "build"))
    log = []
    try:
        serve = ServeSpec(n_slots=8, page_size=16, max_prompt_len=512,
                          max_seq_len=1024, max_new=OP_NEW, prefill_chunk=0,
                          n_requests=OP_REQUESTS, replicas=2, tenant="canary")
        pspec = PipelineSpec(name="canary-promote", stages=[
            StageSpec(name="fleet", kind="workload",
                      trigger=TriggerSpec(on="interval", every=1e5, count=1),
                      workload=WorkloadSpec(
                          kind="serve", arch=cfg.name, name="canary-fleet",
                          resources=ResourceSpec(n_nodes=1, elastic=True),
                          serve=serve)),
            StageSpec(name="train", kind="workload", workload=WorkloadSpec(
                kind="train", arch=cfg.name, name="canary-train",
                resources=ResourceSpec(n_nodes=2, elastic=True),
                train=TrainSpec(total_steps=PIPE_STEPS,
                                global_batch=PIPE_BATCH, seq_len=PIPE_SEQ,
                                chunk_steps=PIPE_CHUNK,
                                ckpt_dir=str(root)))),
            StageSpec(name="eval-gate", kind="gate", depends_on=["train"],
                      gate=GateSpec(metric="final_loss", op="lt",
                                    value=12.0)),
            StageSpec(name="promote", kind="promote",
                      depends_on=["eval-gate"],
                      promote=PromoteSpec(from_stage="train", target="fleet",
                                          note="canary rollout"))])
        clock = SimClock(seed=0)
        mc = FluxMiniCluster(clock, NetModel(),
                             ResourceGraph(n_pods=1, hosts_per_pod=4,
                                           chips_per_host=8),
                             MiniClusterSpec(name="canary", size=2,
                                             max_size=4))
        mc.create()
        mc.wait_ready()
        stage_opts = {
            "fleet": {"cfg": cfg, "executor_opts": dict(
                device=dev, prompt_len=OP_PROMPT_LEN, sim_tick_time=1.0)},
            "train": {"cfg": cfg, "executor_opts": dict(
                device=dev, tcfg=tcfg, sim_step_time=100.0)}}
        build.reset_launches()
        h = mc.apply_pipeline(pspec, stage_opts=stage_opts)

        def run(cond):
            clock.run(until=clock.now + 1e6, stop_when=cond)
            check(cond(), "the pipeline stalled")

        run(lambda: h.stages["train"].handle is not None
            and h.stages["train"].handle.job.jobid
            in h.stages["train"].handle.executor.sessions)
        th = h.stages["train"].handle
        ses = th.executor.sessions[th.job.jobid]
        _timed(torch, ses.ckpt, log)
        run(lambda: ses.step >= PIPE_CHUNK)
        mc.patch_size(4)
        check(th.phase == "Resizing", "the grow did not open a resize")
        run(lambda: len(ses.resumes) >= 1)
        mc.patch_size(2)
        check(th.phase == "Resizing", "the shrink did not open a resize")
        run(lambda: h.stages["train"].phase == "Completed")
        _lifecycle(th, elastic=True)
        torch.cuda.synchronize()
        rel = [abs(a - b) / abs(b) for a, b in zip(ses.losses, ref)]
        check(len(ses.losses) == PIPE_STEPS and max(rel) <= RESUME_RTOL,
              f"the elastic train's losses {ses.losses} differ from the "
              f"uninterrupted run's {ref} by {rel}")
        print(f"[pipeline] train: {[r['transition'] for r in ses.resumes]} at"
              f" steps {[r['step'] for r in ses.resumes]}, segments "
              f"{[(s['from_step'], s['steps'], len(s['hosts'])) for s in ses.segments]}"
              f"; losses {[round(x, 6) for x in ses.losses]}, relative to the "
              f"uninterrupted run's at most {max(rel):.3g} (rtol "
              f"{RESUME_RTOL}), bit-equal {ses.losses == ref}")
        for kind, step, sec, nbytes, total in log:
            size = "" if nbytes is None else f", {nbytes / 1e9:.2f} GB"
            print(f"[pipeline] checkpoint {kind} at step {step}: {sec:.2f} s"
                  f"{size}; {total / 1e9:.2f} GB under the root")
        print(f"[pipeline] checkpoint bytes on disk at the peak "
              f"{max(x[4] for x in log) / 1e9:.2f} GB (keep "
              f"{ses.ckpt.keep})")
        run(lambda: h.stages["eval-gate"].phase in ("Completed", "Skipped"))
        gate = h.stages["eval-gate"].result
        check(gate["passed"], f"the gate refused the train: {gate}")
        print(f"[pipeline] eval-gate: final_loss {gate['value']:.6f} lt "
              f"{gate['threshold']}: passed")
        check(h.fire("fleet"), "the fleet stage did not fire")
        run(lambda: h.stages["promote"].phase in ("Completed", "Failed",
                                                  "Skipped"))
        check(h.stages["promote"].phase == "Completed",
              f"the promote stage ended {h.stages['promote'].phase}: "
              f"{h.status()}")
        fh = h.stages["fleet"].handle
        fex, fses = fh.executor, fh.executor.sessions[fh.job.jobid]
        check(not fh.done, "the fleet finished its requests before the "
              "promotion was done")
        rng = np.random.default_rng(21)
        extra_prompts = [rng.integers(0, cfg.vocab_size, 300).tolist()
                         for _ in range(PIPE_EXTRA)]
        extra = [fex.submit_request(fh.job, p, max_new=OP_NEW)
                 for p in extra_prompts]
        run(lambda: h.done)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)     # the pipeline's own run
        check(h.phase == "Completed", f"the pipeline ended {h.phase}")
        rec = fex.ran[fh.job.jobid]
        promo = rec["promotions"][0]
        check(all(len(t) == OP_NEW for t in rec["tokens"])
              and rec["n_requests"] == OP_REQUESTS + PIPE_EXTRA,
              f"requests were dropped: {[len(t) for t in rec['tokens']]}")
        check(rec["version"] == 1 and len(promo["steps"]) == 2,
              f"the promotion did not roll both replicas: {promo}")
        # the streams before each swap: the fleet's first params
        first, = fex._params.values()
        prompts = [[(7 * i + j) % cfg.vocab_size for j in range(OP_PROMPT_LEN)]
                   for i in range(OP_REQUESTS)]
        control = Engine(cfg, fh.spec.engine_config(), params=first,
                         device=dev)
        creqs = [control.submit(p, max_new_tokens=OP_NEW) for p in prompts]
        control.run()
        idx = {r.rid: i for i, r in enumerate(fses.requests)}
        checked = 0
        for step in promo["steps"]:
            for rid, n in step["token_progress"].items():
                i = idx[rid]
                check(rec["tokens"][i][:n] == creqs[i].tokens[:n],
                      f"request {i}'s tokens before its replica's swap "
                      f"differ from the unpromoted run's")
                checked += 1
        del control
        # the promoted replicas: a direct Engine on the restored params
        mgr = CheckpointManager(str(Path(root) / f"job{th.job.jobid}"))
        template = {"params": dsteps.abstract_train_state(
            cfg, tcfg)["params"]}
        restored, step = mgr.restore_latest(template)
        trained = serving_params(cfg, restored["params"], dev)
        direct = Engine(cfg, fh.spec.engine_config(), params=trained,
                        device=dev)
        dreqs = [direct.submit(p, max_new_tokens=OP_NEW)
                 for p in extra_prompts]
        direct.run()
        torch.cuda.synchronize()
        check([r.tokens for r in extra] == [r.tokens for r in dreqs],
              "the promoted replicas' streams differ from a direct Engine's "
              "over the trained params")
        differ = sum(a != b.tokens for a, b in zip(rec["tokens"], creqs))
        print(f"[pipeline] fleet + promote: {rec['replicas']} replicas, "
              f"{rec['n_requests']} requests, none dropped; promotion began "
              f"with {promo['in_flight_at_begin']} in flight, replicas "
              f"promoted at sim t {[round(s['t_sim'], 3) for s in promo['steps']]}"
              f" in {[round(s['wall_s'], 4) for s in promo['steps']]} s wall "
              f"each; {checked} streams equal the unpromoted run's up to "
              f"their swap, {differ} of {OP_REQUESTS} part after it; the "
              f"{PIPE_EXTRA} requests after the roll equal a direct Engine's "
              f"over the params restored from step {step} token for token")
        ev = h.events()
        spans = {}
        for e in ev:
            if e.get("stage") and e["phase"] in ("Running", "Completed"):
                spans.setdefault(e["stage"], []).append(e["t"])
        print(f"[pipeline] stage sim times (Running, Completed): "
              + ", ".join(f"{n} {[round(t, 2) for t in ts]}"
                          for n, ts in spans.items()))
        del direct, trained, restored, fex, fses, ses, th, fh
        _release(mc)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[pipeline] launches in the pipeline's run: " + ", ".join(
        f"{k} {launches[k]}" for k in ("rmsnorm", "flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv", "moe_gemm",
                                       "paged_decode"))
        + f"; {time.perf_counter() - t_phase:.1f} s")
    for k in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "moe_gemm", "paged_decode"):
        check(launches[k] > 0, f"the pipeline never launched {k}")
    return launches


# ---------------------------------------------------------------------------
# the launchers at the JAX launchers' flags
# ---------------------------------------------------------------------------

LAUNCH_TPUT = ["--arch", "yi-6b", "--prompt-len", "256", "--gen", "32",
               "--batch", "8", "--prefill-chunk", "256"]


def _quiet(fn, *a):
    """``fn(*a)`` with its standard output kept; returns (result, the
    lines it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    return out, buf.getvalue().splitlines()


def _record_logits(eng):
    """Keep, per request id, the float32 logits row each of ``eng``'s
    sampled tokens came from (a prefill's one row, a tick's row of the
    request's slot)."""
    logits_of, last = {}, {}
    sample, emit = eng._sample, eng._emit

    def kept_sample(logits, temps):
        last["rows"] = logits.float().cpu()
        return sample(logits, temps)

    def kept_emit(req, tok):
        rows = last["rows"]
        logits_of.setdefault(req.rid, []).append(
            rows[0] if rows.shape[0] == 1 else rows[req.slot])
        emit(req, tok)

    eng._sample, eng._emit = kept_sample, kept_emit
    return logits_of


def _served(reqs, n_new, vocab):
    """tok/s over the run (first request created to last finished), the
    TTFT median (ms), and every request finished with ``n_new`` tokens
    inside the vocabulary."""
    for r in reqs:
        check(r.finished and len(r.tokens) == n_new,
              f"request {r.rid} did not finish with {n_new} tokens")
        check(all(0 <= t < vocab for t in r.tokens),
              f"request {r.rid} has tokens outside the vocabulary")
    span = max(r.t_done for r in reqs) - min(r.t_created for r in reqs)
    ttft = sorted(r.ttft * 1e3 for r in reqs)
    return sum(len(r.tokens) for r in reqs) / span, ttft[len(ttft) // 2]


def launch_phase(torch, dev, build):
    """``repro_torch.launch.serve`` and ``launch.train`` at the JAX
    launchers' flags, on the card:

    * ``--spec examples/specs/serve_fleet.json``: yi-6b at full width and
      depth, two replicas behind the Router (each engine its own weights
      from seed 0, its ticks captured as CUDA graphs, the fleet's prefix
      cache on); each stream held by logit against one eager Engine of
      the same seed over the same prompts (where the two first part, the
      fleet's token within STREAM_LOGIT_TOL of the eager engine's max
      logit there);
    * ``LAUNCH_TPUT`` with ``--replicas 1``, then ``--replicas 2``:
      tok/s, TTFT median and peak device memory of each;
    * ``--spec`` of a granite-moe-1b-a400m train spec at full size
      (strategy ``optimized``, 3 steps of 4 x 4096, train_granite's
      shape): its first loss against a direct Trainer's (RESUME_RTOL),
      and the CommFallbackWarning the one-device mesh gives.

    Returns the launch counts of the launchers' runs (no check's)."""
    import tempfile
    import warnings

    from repro_torch.comm import CommFallbackWarning
    from repro_torch.configs import TrainConfig, WorkloadShape, registry
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.serve import Engine, Router
    from repro_torch.spec import load_spec
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    runs = []
    spec = ROOT / "examples" / "specs" / "serve_fleet.json"
    wspec = load_spec(str(spec))
    torch.cuda.synchronize()
    build.reset_launches()
    (fleet, reqs), out = _quiet(lserve.main, ["--spec", str(spec)])
    torch.cuda.synchronize()
    runs.append(dict(build.LAUNCHES))
    for line in out:
        print(f"[launch] {line}")
    check(isinstance(fleet, Router) and len(fleet.engines) == 2,
          "--spec serve_fleet.json must build a Router over 2 engines")
    bad = [(str(e.device), e.n_captures) for e in fleet.engines
           if not (e.cuda_graphs and e.n_captures > 0
                   and e.device.type == "cuda")]
    check(not bad, f"replicas (device, graphs captured) {bad}")
    cfg = fleet.engines[0].cfg
    check(cfg == registry.get("yi-6b"), "the fleet must serve yi-6b's full "
          "config")
    _served(reqs, wspec.serve.max_new, cfg.vocab_size)
    for name in ("rmsnorm", "paged_prefill", "paged_decode"):
        check(runs[-1][name] > 0, f"the fleet never launched {name}")
    st = fleet.stats()
    print(f"[launch] serve_fleet.json: {len(reqs)} requests over "
          f"{st['replicas']} captured replicas, prefix cache "
          f"{st['prefix_cache']}, launches {runs[-1]}")
    del fleet
    gc.collect()
    torch.cuda.empty_cache()

    # one eager engine of the same seed: where a stream first parts from
    # its, the fleet's token lies within STREAM_LOGIT_TOL of its max
    eager = Engine(cfg, wspec.engine_config(), seed=0, device=dev,
                   cuda_graphs=False)
    logits_of = _record_logits(eager)
    ereqs = [eager.submit(r.prompt, max_new_tokens=wspec.serve.max_new,
                          temperature=wspec.serve.temperature) for r in reqs]
    eager.run()
    torch.cuda.synchronize()
    gaps = []
    for r, e in zip(reqs, ereqs):
        i = next((j for j, (a, b) in enumerate(zip(r.tokens, e.tokens))
                  if a != b), None)
        if i is None:
            gaps.append(None)
            continue
        lg = logits_of[e.rid][i]
        gaps.append(round(float(lg.max() - lg[r.tokens[i]]), 5))
        check(gaps[-1] <= STREAM_LOGIT_TOL, f"request {r.rid}: the fleet's "
              f"token at step {i} lies {gaps[-1]} below the eager engine's "
              f"max logit (tol {STREAM_LOGIT_TOL})")
    same = sum(g is None for g in gaps)
    print(f"[launch] against one eager Engine of seed 0: {same} of "
          f"{len(reqs)} streams equal token for token; where they part, the "
          f"fleet token's gap below the eager max logit {gaps} (tol "
          f"{STREAM_LOGIT_TOL})")
    del eager, logits_of
    gc.collect()
    torch.cuda.empty_cache()

    # the fleet's throughput: one engine, then two captured replicas
    for n in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        (eng, reqs), out = _quiet(lserve.main,
                                  LAUNCH_TPUT + ["--replicas", str(n)])
        torch.cuda.synchronize()
        runs.append(dict(build.LAUNCHES))
        tok_s, ttft = _served(reqs, 32, cfg.vocab_size)
        # the peaks take in each engine's weight draw (float32 draws
        # cast to bf16, one stacked leaf at a time); what stays
        # allocated after the run is the replicas' serving footprint
        print(f"[launch] {' '.join(LAUNCH_TPUT)} --replicas {n}: "
              f"{len(reqs)} requests, {tok_s:.1f} tok/s, TTFT median "
              f"{ttft:.1f} ms; peak {torch.cuda.max_memory_allocated() / 1e9:.3f}"
              f" GB allocated / {torch.cuda.max_memory_reserved() / 1e9:.3f}"
              f" GB reserved (weight draws included), "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated / "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved after "
              f"the run; {out[2]}; {out[3]}")
        del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()

    # the train launcher on a spec: granite at full size, strategy
    # optimized on the (1, 1) mesh
    train = {"kind": "train", "arch": "granite-moe-1b-a400m",
             "name": "launch-granite", "strategy": "optimized",
             "resources": {"n_nodes": 1, "pod_local": True,
                           "elastic": False},
             "train": {"total_steps": 3, "global_batch": 4,
                       "seq_len": 4096, "chunk_steps": 1, "ckpt_dir": None}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_granite.json")
        with open(path, "w") as f:
            json.dump(train, f)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (tr, hist), out = _quiet(ltrain.main, ["--spec", path])
        torch.cuda.synchronize()
    runs.append(dict(build.LAUNCHES))
    for w in caught:
        if issubclass(w.category, CommFallbackWarning):
            print(f"[launch] CommFallbackWarning: {w.message}")
    for line in out:
        print(f"[launch] {line}")
    _check_history(hist)
    check(tr.cfg == registry.get("granite-moe-1b-a400m") and len(hist) == 3,
          "the train spec must run granite's full config 3 steps")
    for name in ("moe_gemm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "rmsnorm"):
        check(runs[-1][name] > 0, f"the train launcher never launched {name}")
    print(f"[launch] train spec: peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{runs[-1]}")
    first = hist[0]["loss"]
    strategy, shape = tr.strategy, tr.shape
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", CommFallbackWarning)
        direct = Trainer(registry.get("granite-moe-1b-a400m"),
                         TrainConfig(learning_rate=3e-4, total_steps=3,
                                     warmup_steps=1),
                         WorkloadShape("chip", "train", 4096, 4),
                         strategy=strategy, seed=0, device=dev)
        want = direct.run(1, log_every=0)[0]["loss"]
    check(abs(first - want) <= RESUME_RTOL * abs(want),
          f"the launcher's first loss {first} is not a direct Trainer's "
          f"{want} (rtol {RESUME_RTOL})")
    check((shape.seq_len, shape.global_batch) == (4096, 4),
          f"the train spec ran {shape}")
    print(f"[launch] first loss {first:.6f}, a direct Trainer's {want:.6f} "
          f"(rtol {RESUME_RTOL}); phase {time.perf_counter() - t_phase:.1f} s")
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def serve_phase(torch, dev, build, runs, arch, n_layers=None, cut="",
                eager=False):
    """Both engine modes on ``arch`` at full width and depth, or at
    ``n_layers`` (the reason in ``cut``), then teacher-forced logits;
    returns (cfg, params, prompts, legacy streams, chunked streams) and
    appends the two runs' launch counts to ``runs``.  QKV biases are
    drawn after the init (``draw_biases``).  With ``eager``, both modes
    again with ``cuda_graphs=False`` (``eager_run``)."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models.model import Model

    cfg = registry.get(arch)
    depth = f"{cfg.n_layers} layers"
    if n_layers is not None:
        depth = f"{n_layers} of {cfg.n_layers} layers (cut: {cut})"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    draw_biases(torch, dev, cfg, params, seed=11)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {depth}, d_model "
          f"{cfg.d_model}, {Model(cfg).n_params() / 1e9:.2f} B params in "
          f"bf16, drawn in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, 12)]
    legacy, streams = serve_run(torch, dev, cfg, params, 0, prompts, build)
    chunked, c_streams = serve_run(torch, dev, cfg, params, 256, prompts,
                                   build)
    if eager:
        eager_run(torch, dev, cfg, params, 0, prompts, build,
                  (legacy, streams))
        eager_run(torch, dev, cfg, params, 256, prompts, build,
                  (chunked, c_streams))
    moe = ("moe_gemm",) if cfg.moe is not None else ()
    for name in ("rmsnorm", "flash_fwd", "paged_decode") + moe:
        check(legacy[name] > 0, f"legacy serve never launched {name}")
    for name in ("rmsnorm", "paged_prefill", "paged_decode") + moe:
        check(chunked[name] > 0, f"chunked serve never launched {name}")
    runs.extend([legacy, chunked])
    teacher_force(torch, dev, cfg, params)
    return cfg, params, prompts, streams, c_streams


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
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = t = time.perf_counter()

    def stamp(phase):
        print(f"[phase] {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    lib = build.build()
    build.lib()
    print(f"[build] {lib.name} in {time.perf_counter() - t:.1f} s")
    for part in lib.with_suffix(".log").read_text().split("== ")[1:]:
        source, _, log = part.partition("\n")
        for line in build.ptxas_report(log):
            print(f"[build]   {source}: {line}")

    rows = kernel_phase(torch, dev)
    stamp("kernels")
    runs = []                       # launch counts of every main-path run

    cfg, params, prompts, streams, c_streams = serve_phase(
        torch, dev, build, runs, "yi-6b", eager=True)
    tie = torch.zeros((2, 64000), dtype=torch.bfloat16, device=dev)
    tie[:, 5] = tie[:, 70] = 1.0
    check(torch.argmax(tie, dim=-1).tolist() == [5, 5],
          "argmax over bf16 logits must return the first maximal index")
    runs.append(contiguous_phase(torch, dev, cfg, params, prompts[:4],
                                 streams[:4], build))
    # the chunked prefill (paged_prefill over 256-row chunks) and the
    # legacy one (flash_fwd over the padded prompt) round differently,
    # and greedy streams part where two tokens' logits lie that close
    print(f"[serve] {cfg.name} chunked(256) against legacy: "
          + legacy_gaps(torch, dev, cfg, params, prompts, c_streams, streams))
    del params
    torch.cuda.empty_cache()
    params = serve_phase(torch, dev, build, runs,
                         "granite-moe-1b-a400m", eager=True)[1]
    del params
    torch.cuda.empty_cache()

    # chatglm3-6b: QKV bias, half the head dim rotated, 16 query heads a
    # KV head; then parked and adopted, and served over two pool shards
    cfg, params, prompts, streams, c_streams = serve_phase(
        torch, dev, build, runs, "chatglm3-6b")
    runs.append(park_run(torch, dev, cfg, params, prompts, streams, build))
    sharded, got = serve_run(torch, dev, cfg, params, 256, prompts, build,
                             dp_shards=2)
    runs.append(sharded)
    differ = [i for i, (a, b) in enumerate(zip(got, c_streams)) if a != b]
    check(not differ, f"the 2-shard chunked run's streams differ from the "
          f"one-shard chunked run's at requests {differ}")
    print(f"[serve] chunked(256) over 2 pool shards: all {len(got)} streams "
          f"equal the one-shard chunked run's token for token; against the "
          f"legacy run: "
          + legacy_gaps(torch, dev, cfg, params, prompts, got, streams))
    del params
    torch.cuda.empty_cache()
    params = serve_phase(torch, dev, build, runs, "qwen2-72b", QWEN2_LAYERS,
                         "all 80 need ~145 GB of bf16 weights")[1]
    del params
    torch.cuda.empty_cache()
    stamp("serve")
    runs.extend(launch_phase(torch, dev, build))
    stamp("launch")
    runs.extend(seqmix_phase(torch, dev, build))
    stamp("seqmix")
    runs.append(operator_phase(torch, dev, build))
    stamp("operator")
    runs.append(smoke_phase(torch, dev, build))
    stamp("smoke")
    pipeline_cli(torch)
    with _NoPlain():
        runs.append(granite_pipeline(torch, dev, build))
    stamp("pipeline")

    grad_check(torch, dev, "yi-6b")
    grad_check(torch, dev, "granite-moe-1b-a400m")
    grad_check(torch, dev, "chatglm3-6b")
    runs.append(train_phase(torch, dev, build))
    runs.append(train_granite(torch, dev, build))
    stamp("train")
    runs.extend(seqmix_train_phase(torch, dev, build))
    stamp("seqmix_train")
    runs.extend(encdec_phase(torch, dev, build))
    stamp("encdec")

    pix_runs = pixtral_phase(torch, dev, build)
    runs.extend(pix_runs)
    stamp("pixtral")
    runs.extend(comm_phase(torch, dev, build, smi))
    stamp("comm")
    tp_total, serve_tp_total, seqmix_tp_total = tp_phase(torch, dev, build,
                                                         smi)
    tp_runs, serve_tp_runs = [tp_total], [serve_tp_total]
    seqmix_tp_runs = [seqmix_tp_total]
    runs.extend(tp_runs + serve_tp_runs + seqmix_tp_runs)
    stamp("tp")
    runs.append(operator_ranks_phase(torch, dev, build, smi))
    stamp("operator_ranks")

    kernels = []
    for name, r in rows.items():
        # a head dim 160 row counts the pixtral phase's launches, a tp
        # shape's row the tp phase's training, serving or seqmix_tp part
        base = r.get("kernel", name)
        which = r.get("runs", "pixtral" if base != name else "all")
        launches = sum(run.get(base, 0) for run in {
            "pixtral": pix_runs, "tp": tp_runs, "serve_tp": serve_tp_runs,
            "seqmix_tp": seqmix_tp_runs, "all": runs}[which])
        check(launches > 0, f"no main-path run launched {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "launches": launches,
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
