#!/usr/bin/env python3
"""What each design choice of ``src/repro_torch/csrc/moe_gemm.cu`` is
worth on the card: the kernel as it is, and rebuilt without one choice,
timed in one run at granite-moe-1b-a400m's shapes (32 experts, D 1024,
F 512): the forward at 8, 160 and 5120 rows an expert (a decode tick, a
legacy prefill, a train step) and the train step's two backward
products on their transposed views, dX = dY W^T and dW = X^T dY.

    python3 tools/moe_gemm_variants.py [--parent DIR]

Each variant is a textual edit of the source, built beside the kernel
(all of them, every run) as ``tools/flash_bwd_variants.py`` builds its
own:

* ``bn128``: 128 output columns a block at every shape (the kernel takes
  256 where that still gives every SM two tiles);
* ``bn256``: 256 output columns a block wherever N > 128;
* ``stages3``: a ring of three stages (not four);
* ``bn128_stages5``: 128 columns and five stages;
* ``wait0``: each step's products waited for at once (not one step
  later);
* ``scattered_stores``: the epilogue writes each thread's sums straight
  from its registers, two columns at a time (not through shared memory,
  16 bytes a lane);
* ``parent`` (with ``--parent DIR``): ``DIR/moe_gemm.cu`` as it is, with
  the headers in DIR before those of ``csrc/``: an older tree's kernel,
  e.g. ``git show HEAD~1:src/repro_torch/csrc/moe_gemm.cu``.

Every variant but ``parent`` must give the same bits as the kernel (the
same products summed in the same order); ``parent`` sums in another
order and is held to the kernel at ``chip_smoke.py``'s TOL after scaling
by 1 / sqrt(depth).  The script fails otherwise, after timing every
variant.  It prints each build's registers, spills and ptxas's C75xx
notes on wgmma (``-Xptxas -v``), and each one's CUDA-event time (as
``chip_smoke.py`` takes it), achieved TFLOP/s and share of its bound,
beside ``torch.bmm`` on the same operands (transposed views made
contiguous first, outside the timing) and the card's name and power
limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

WIDE = "  if (wide_tiles(E, M, N)) return launch_modes<256>"
STAGES = "constexpr int STAGES = 4;"
# scattered_stores: the shared-memory epilogue turned off, and in its
# place each thread's sums stored two columns at a time
EPILOGUE = ('  asm volatile("bar.sync 2, %0;\\n" ::"n"(CONSUMERS * WG_THREADS) : '
            '"memory");\n')
EPILOGUE_END = "        if (col + x < N) dst[x] = h[x];\n    }\n  }\n"
SCATTER = """  }
  const int r = m0 + 64 * cw + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  const int c0 = n0 + 2 * (threadIdx.x & 3);
  bf16* p0 = out + (long long)e * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 8 * j;
      if (r + 8 * h >= M) continue;
      bf16* p = p0 + (long long)(r + 8 * h) * N + col;
      if ((N & 1) == 0 && col + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(c[j][2 * h], c[j][2 * h + 1]);
      } else {
        if (col < N) p[0] = __float2bfloat16(c[j][2 * h]);
        if (col + 1 < N) p[1] = __float2bfloat16(c[j][2 * h + 1]);
      }
    }
"""
VARIANTS = {
    "kernel": [],
    "bn128": [(WIDE, WIDE.replace("if (wide_tiles", "if (false && wide_tiles"))],
    "bn256": [(WIDE, WIDE.replace("if (wide_tiles", "if (N > 128 || wide_tiles"))],
    "stages3": [(STAGES, "constexpr int STAGES = 3;")],
    "bn128_stages5": [(WIDE, WIDE.replace("if (wide_tiles",
                                          "if (false && wide_tiles")),
                      (STAGES, "constexpr int STAGES = 5;")],
    "wait0": [("    wg_wait<1>();", "    wg_wait<0>();")],
    "scattered_stores": [(EPILOGUE, "  if (false) {\n"),
                         (EPILOGUE_END, EPILOGUE_END + SCATTER)],
}
E, D, F = 32, 1024, 512


def main() -> int:
    import torch

    import chip_smoke as cs
    from flash_bwd_variants import build_variants, card
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding an older "
                    "moe_gemm.cu to build and hold beside the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[variants] {card(torch)}", flush=True)
    libs = build_variants(build, "moe_gemm.cu", VARIANTS, ("moe_gemm_bf16",),
                          args.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cpm = cs.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream().cuda_stream

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    x5, w = rnd(E, 5120, D), rnd(E, D, F)
    dy = rnd(E, 5120, F)
    cases = [("forward T 8", rnd(E, 8, D), w),
             ("forward T 160", rnd(E, 160, D), w),
             ("forward T 5120", x5, w),
             ("dX = dY W^T", dy, w.transpose(1, 2)),
             ("dW = X^T dY", x5.transpose(1, 2), dy)]
    failed = []
    for label, a, b in cases:
        e, m, k = a.shape
        n = b.shape[2]
        out = torch.empty((e, m, n), dtype=torch.bfloat16, device=dev)
        flops = 2 * e * m * k * n
        least, by = cs.bound((a.numel() + b.numel() + out.numel()) * 2, flops)
        ac, bc = a.contiguous(), b.contiguous()
        t_lib = cs.median_ms(cpm, lambda: torch.bmm(ac, bc))
        print(f"[variants] {label}: ({e},{m},{k}) x ({e},{k},{n}), "
              f"{flops:.4g} flops, bound {least:.4f} ms ({by}); torch.bmm "
              f"{t_lib:.4f} ms = {flops / t_lib / 1e9:.1f} TFLOP/s",
              flush=True)
        kernel = None                    # the shipped kernel's bits
        for name, so in libs.items():      # "kernel" first
            def run():
                err = so.moe_gemm_bf16(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), e, m, n, k,
                                       *a.stride(), *b.stride(), stream)
                cs.check(err == 0, f"{name}: launch failed ({err})")
            run()
            torch.cuda.synchronize()
            if name == "kernel":
                kernel = out.clone()
                ok = True
            elif name == "parent":
                _, ok = cs.err_within(out.float() * k ** -0.5,
                                      kernel.float() * k ** -0.5, cs.TOL)
            else:
                ok = torch.equal(out, kernel)
            if not ok:
                failed.append(f"{name} at {label}")
            t = cs.median_ms(cpm, run)
            print(f"[variants] {name} {label}: {t:.4f} ms = "
                  f"{flops / t / 1e9:.1f} TFLOP/s, {least / t:.3f} of the "
                  f"bound, {t / t_lib:.2f}x torch.bmm"
                  + ("" if ok else "  OTHER BITS"), flush=True)
    cs.check(not failed, "variants differ from the kernel: "
             + ", ".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
