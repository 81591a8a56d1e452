#!/usr/bin/env python3
"""What each design choice of ``src/repro_torch/csrc/flash_fwd.cu`` is
worth on the card: the kernel as it is, and rebuilt without one choice,
timed in one run at yi-6b's and granite-moe-1b-a400m's training shapes
and at yi-6b's 512-token prompt (all causal).

    python3 tools/flash_fwd_variants.py [--parent DIR]

Each variant is a textual edit of the source or of the body it shares
with paged prefill (``flash_fwd.cuh``), built beside the kernel (all of
them, every run) the way ``tools/flash_bwd_variants.py`` builds its own:

* ``masked``: every step through the masked softmax (no fast path for
  steps that every row of a warpgroup sees whole);
* ``natural``: the grid's query tiles in natural order, the first first
  (not the heaviest first);
* ``wg1``: one warpgroup (64 query rows) a block at both head dims, in
  place of the three (head dim 128) or two (64) that share each K and V
  tile, with the blocks an SM raised to keep the warps an SM;
* ``kt1``: at head dim 128, steps of one 64-key tile (not two);
* ``load_tile``: the K, V (and q) copies through ``load_tile`` of
  wgmma.cuh, which works out each copy's addresses anew every step (not
  once, as TileCopy does);
* ``exp2f``: the exponentials through ``exp2f`` (not ``ex2.approx.ftz``);
* ``parent`` (with ``--parent DIR``): ``DIR/flash_fwd.cu`` with the
  headers in DIR before those of ``csrc/``: an older tree's kernel, e.g.
  unpacked from ``git archive`` into a directory .gitignore lists.

The ``kt1`` variant takes its maxima over other keys than the kernel, so
its p round elsewhere, and ``exp2f`` may round p in another last bit: both
are held to the kernel within 2e-2 x (1 + |out|) (``chip_smoke.py``'s TOL)
and 1e-3 in lse.  Every other variant must give the same bits as the
kernel (the same sums in the same order).  The script fails otherwise.
It prints each build's registers, spills and ptxas's C75xx notes on
wgmma (``-Xptxas -v``: C7515 and C7511 say it serialized every wgmma,
C7519 that it added a fence of its own), each one's CUDA-event time (as
``chip_smoke.py`` takes it), achieved TFLOP/s and share of the bf16
bound, and SDPA's forward on the same inputs, beside
the card's name and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

CFG128 = "struct Cfg<128> {\n  static constexpr int WGS = 3, MIN_BLOCKS = 1, KT = 2;"
CFG64 = "struct Cfg<64> {\n  static constexpr int WGS = 2, MIN_BLOCKS = 2, KT = 1;"
VARIANTS = {
    "kernel": [],
    "masked": [("const bool whole =\n        (!rows.causal()",
                "const bool whole = false &&\n        (!rows.causal()")],
    "natural": [("(rows, keys, gridDim.x - 1 - blockIdx.x, scale, smem_raw);",
                 "(rows, keys, blockIdx.x, scale, smem_raw);")],
    "wg1": [(CFG128, CFG128.replace("WGS = 3, MIN_BLOCKS = 1",
                                    "WGS = 1, MIN_BLOCKS = 2")),
            (CFG64, CFG64.replace("WGS = 2, MIN_BLOCKS = 2",
                                  "WGS = 1, MIN_BLOCKS = 4"))],
    "kt1": [(CFG128, CFG128.replace("KT = 2", "KT = 1"))],
    "load_tile": [("    rows(s, base, [stride](int r) { return (long long)r * stride; }, r0, n);",
                   "    load_tile<D, NT>(s, base, stride, r0, n);")],
    "exp2f": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
               "  y = exp2f(x);")],
}
ROUNDS_ELSEWHERE = {"kt1", "exp2f"}
SHAPES = [(2, 4096, 32, 4, 128), (4, 4096, 16, 8, 64),
          (1, 512, 32, 4, 128)]                        # B, S, H, Hkv, D


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flash_bwd_variants import build_variants, card
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding an older "
                    "flash_fwd.cu to build and hold beside the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[variants] {card(torch)}", flush=True)
    libs = build_variants(build, "flash_fwd.cu", VARIANTS, ("flash_fwd_bf16",),
                          args.parent, only="flash_fwd")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cpm = cs.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream().cuda_stream

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    for B, S, H, HKV, D in SHAPES:
        q, k, v = rnd(B, S, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D)
        out = torch.empty_like(q)
        lse = torch.empty((B, S, H), dtype=torch.float32, device=dev)
        flops = 2 * 2 * B * (S * (S + 1) // 2) * H * D
        least = flops / cs.BF16_FLOPS_S * 1e3
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        t_lib = cs.median_ms(cpm, sdpa)
        print(f"[variants] q ({B},{S},{H},{D}) kv ({B},{S},{HKV},{D}): "
              f"{flops:.4g} flops, bound {least:.4f} ms; SDPA forward "
              f"{t_lib:.4f} ms = {flops / t_lib / 1e9:.1f} TFLOP/s",
              flush=True)
        kernel = None                    # the shipped kernel's bits
        for name, so in libs.items():      # "kernel" first
            def run():
                err = so.flash_fwd_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), B, S, S, H, HKV, D, 1, 0, D ** -0.5,
                    stream)
                cs.check(err == 0, f"{name}: launch failed ({err})")
            run()
            torch.cuda.synchronize()
            if name == "kernel":
                kernel = (out.clone(), lse.clone())
            if name in ROUNDS_ELSEWHERE:
                _, ok = cs.err_within(out, kernel[0], cs.TOL)
                ok = ok and float((lse - kernel[1]).abs().max()) <= cs.LSE_TOL
            else:
                ok = torch.equal(out, kernel[0]) and torch.equal(lse, kernel[1])
            cs.check(ok, f"variant {name} differs from the kernel")
            t = cs.median_ms(cpm, run)
            print(f"[variants] {name} q ({B},{S},{H},{D}): {t:.4f} ms = "
                  f"{flops / t / 1e9:.1f} TFLOP/s, {least / t:.3f} of the "
                  f"bound, {t / t_lib:.2f}x SDPA", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
