#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  - ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build   - nvcc builds every kernel from ``src/repro_torch/csrc``;
3. kernels - each CUDA kernel against its plain PyTorch version at yi-6b
             shapes in bf16: max error against the stated tolerance, and
             CUDA-event medians of the kernel, the plain version and one
             PyTorch library call, beside the least time the card could take;
4. serve   - yi-6b at full width and depth (random weights from a seeded
             generator) through the port's Engine, legacy prefill and
             chunked prefill, with the kernels' launch counts read around
             each run; then one prompt and 4 decode steps teacher-forced
             through the kernel path and the plain path.

Then the ``kernels`` JSON line, the card's line, and the result line.
Any failure raises and exits non-zero; without CUDA, or without the port
beside this file, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16 flop/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
# kernel vs plain version, bf16 outputs: |a - b| <= TOL * (1 + |b|).  Both
# round once to bf16 after f32 sums taken in another order (and the plain
# attention rounds p to bf16 before p @ v, the kernel does not), so they
# differ by a few bf16 ulps (2^-8 relative each).
TOL = 2e-2
# lse is f32 on both sides: only the summation order differs
LSE_TOL = 1e-3
# teacher-forced logits through 32 layers: both bf16 paths (kernels and
# plain versions) round activations at other places in every layer, so
# they drift apart by the bf16 noise of the model itself.  The kernel
# path must stay as close to float32 compute (plain versions) as the
# plain bf16 path is, within this factor.
LOGIT_NOISE_FACTOR = 1.5

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:27",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:86",
    "paged_decode": "src/repro/kernels/decode_attention/kernel.py:148",
    "paged_prefill": "src/repro/kernels/decode_attention/kernel.py:240",
}
SOURCES = {
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_fwd": "src/repro_torch/csrc/flash_fwd.cu",
    "paged_decode": "src/repro_torch/csrc/paged_attention.cu",
    "paged_prefill": "src/repro_torch/csrc/paged_attention.cu",
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


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def err_within(got, want, tol):
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol * (1 + want.float().abs())).all())


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

    # rmsnorm at the decode tick's (8, 4096) and the prefill's (512, 4096)
    w = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    errs = []
    for rows in (8, 512):
        x = rnd(rows, 4096)
        e, ok = err_within(ops.rmsnorm(x, w), rn_ref.rmsnorm_ref(x, w), TOL)
        check(ok, f"rmsnorm ({rows}, 4096) differs from the plain version")
        errs.append(e)
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
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = S * (S + 1) // 2
    rows_out["flash_fwd"] = dict(
        max_abs_err=e, lse_err=e_lse,
        ms=median_ms(cpm, lambda: ops.flash_attention(q, k, v, causal=True)),
        plain_ms=median_ms(cpm, lambda: fa_ref.chunked(q, k, v, causal=True)),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound=bound((2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4,
                    4 * pairs * H * D),
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

    # paged prefill: a 256-row chunk at start 0 and at start 256
    C = 256
    MAXP1 = 1024 // PAGE
    bt1 = bt[:1]
    errs = []
    for start, n_valid in ((0, 200), (256, 180)):
        qc = rnd(1, C, H, D)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        got = ops.paged_prefill_attention(qc, kp, vp, bt1, st, nv)
        want = dec_ref.paged_prefill_ref(qc, kp, vp, bt1, st, nv)
        e, ok = err_within(got[:, :n_valid], want[:, :n_valid], TOL)
        check(ok, f"paged_prefill at start {start} differs")
        errs.append(e)
    fill = start + n_valid
    kg1 = kp[bt1.long()].reshape(1, MAXP1 * PAGE, HKV, D).transpose(1, 2)
    vg1 = vp[bt1.long()].reshape(1, MAXP1 * PAGE, HKV, D).transpose(1, 2)
    qpos = start + torch.arange(C, device=dev)
    kpos = torch.arange(MAXP1 * PAGE, device=dev)
    cmask = ((kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < fill))[None, None]
    # keys each row sees: its causal prefix, cut at the fill
    seen = sum(min(start + j + 1, fill) for j in range(C))
    rows_out["paged_prefill"] = dict(
        max_abs_err=max(errs),
        ms=median_ms(cpm, lambda: ops.paged_prefill_attention(qc, kp, vp, bt1, st,
                                                         nv)),
        plain_ms=median_ms(cpm, lambda: dec_ref.paged_prefill_ref(
            qc, kp, vp, bt1, st, nv)),
        library_ms=median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qc.transpose(1, 2), kg1, vg1, attn_mask=cmask, enable_gqa=True)),
        bound=bound(2 * fill * HKV * D * 2 + 2 * qc.numel() * 2,
                    4 * seen * H * D),
        shape="q (1,256,32,128) at start 256, n_valid 180, page 16")

    for name, r in rows_out.items():
        print(f"[kernels] {name}: {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3g} (tol {TOL} x (1+|ref|)) "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {r['library_ms']:.4f} ms  bound {r['bound'][0]:.4f} "
              f"ms ({r['bound'][1]})")
    return rows_out


# ---------------------------------------------------------------------------
# phase 4: serve yi-6b through the Engine
# ---------------------------------------------------------------------------


def serve_run(torch, dev, cfg, params, chunk, prompts, build):
    from repro_torch.serve import Engine, EngineConfig
    ecfg = EngineConfig(n_slots=8, page_size=16, max_prompt_len=512,
                        max_seq_len=1024, prefill_chunk=chunk)
    eng = Engine(cfg, ecfg, params=params, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    decode_ms = []
    while True:
        n_dec = eng.n_decode_steps
        t = time.perf_counter()
        if not eng.step():
            break
        dt = (time.perf_counter() - t) * 1e3      # each tick ends on the host
        if eng.n_decode_steps > n_dec:
            decode_ms.append(dt)
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
    n_tok = sum(len(r.tokens) for r in reqs)
    mode = f"chunked({chunk})" if chunk else "legacy"
    print(f"[serve] {mode}: {len(reqs)} requests, {n_tok} tokens in "
          f"{elapsed:.3f} s = {n_tok / elapsed:.1f} tok/s; TTFT median "
          f"{ttft[len(ttft) // 2]:.1f} ms (min {ttft[0]:.1f}, max "
          f"{ttft[-1]:.1f}); decode tick median "
          f"{decode_ms[len(decode_ms) // 2]:.2f} ms over {len(decode_ms)} "
          f"ticks; stats {eng.stats()}; launches {launches}")
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
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")

    rows = kernel_phase(torch, dev)

    cfg = registry.get("yi-6b")
    t = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {Model(cfg).n_params() / 1e9:.2f} B params in "
          f"bf16, drawn in {time.perf_counter() - t:.1f} s")
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, 12)]
    legacy = serve_run(torch, dev, cfg, params, 0, prompts, build)
    chunked = serve_run(torch, dev, cfg, params, 256, prompts, build)
    for name in ("rmsnorm", "flash_fwd", "paged_decode"):
        check(legacy[name] > 0, f"legacy serve never launched {name}")
    for name in ("rmsnorm", "paged_prefill", "paged_decode"):
        check(chunked[name] > 0, f"chunked serve never launched {name}")
    tie = torch.zeros((2, 64000), dtype=torch.bfloat16, device=dev)
    tie[:, 5] = tie[:, 70] = 1.0
    check(torch.argmax(tie, dim=-1).tolist() == [5, 5],
          "argmax over bf16 logits must return the first maximal index")
    teacher_force(torch, dev, cfg, params)

    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": legacy[name] + chunked[name],
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
