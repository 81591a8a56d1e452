#!/usr/bin/env python3
"""Paged decode (``src/repro_torch/csrc/paged_attention.cu``) on the card
at ``chip_smoke.py``'s serving shape (8 slots of lengths 1..1024 over
page-16 pools) at yi-6b's widths (32 query heads over 4 KV heads of 128)
and granite-moe-1b-a400m's (16 over 8 of 64), with each slot's pages cut
into as many splits as the wrapper's planner picks and into other
counts, timed in one run:

    python3 tools/paged_decode_variants.py [--parent DIR]

* ``planner``: ``kernel.plan_splits`` (what the wrapper launches);
* ``1 split``, ``half``, ``double`` and ``a page a split``: other counts,
  through the same library;
* ``spill: ...``: the split kernel rebuilt with one edit each (launch
  bounds asking for 2 or 4 blocks an SM, the p V loop unrolled by 4 key
  pairs instead of all 8), timed at the planner's count at every shape:
  ptxas spills 4 B in ``split_kernel<64,8>`` (head dim 64, g = 8) as the
  kernel is, and each edit drops that spill, so its time is taken with
  and without it at 64 query heads over 8 KV heads of 64;
* ``parent`` (with ``--parent DIR``): ``DIR/paged_attention.cu`` with
  the headers in DIR before those of ``csrc/``, an older tree's kernel
  with its own C signature (no workspace, no split count): the one block
  per (KV head, slot) that this file's split kernel replaced, e.g.
  unpacked from ``git show HEAD~1:src/repro_torch/csrc/...``.

Each is held to the plain version (``ref.paged_decode_ref``) at
``chip_smoke.py``'s TOL, and printed with its CUDA-event time (as
``chip_smoke.py`` takes it) beside SDPA on the gathered KV, the byte
bound, and the card's name and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# edits of attention.cuh that move ptxas's register allocation in the
# split kernel
SPILL_VARIANTS = {
    "spill: bounds (128, 2)": [(
        "__launch_bounds__(THREADS)\nsplit_kernel(",
        "__launch_bounds__(THREADS, 2)\nsplit_kernel(")],
    "spill: bounds (128, 4)": [(
        "__launch_bounds__(THREADS)\nsplit_kernel(",
        "__launch_bounds__(THREADS, 4)\nsplit_kernel(")],
    "spill: p V by 4 pairs": [(
        "#pragma unroll (D >= 32 ? CK / 2 : 1)",
        "#pragma unroll (D >= 32 ? CK / 4 : 1)")],
}
# the signature before the split: q, k_pages, v_pages, block_table,
# lengths, out, B, H, Hkv, D, page, pages_per_slot, scale, stream
PARENT_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flash_bwd_variants import build_variants, card
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dr

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding an older "
                    "paged_attention.cu to build and time beside the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_decode_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[variants] {card(torch)}", flush=True)
    libs = build_variants(build, "paged_attention.cu",
                          {"kernel": [], **SPILL_VARIANTS}, (), args.parent,
                          only="split_kernel<")
    for name, so in libs.items():
        so.paged_decode_bf16.argtypes = (PARENT_SIGNATURE if name == "parent"
                                         else build.SIGNATURES["paged_decode_bf16"])
        so.paged_decode_bf16.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cpm = cs.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    B, MAXP, PAGE = 8, 64, 16
    lens = torch.tensor([1, 17, 100, 256, 511, 700, 1000, 1024],
                        dtype=torch.int32, device=dev)
    filled = int(lens.sum())
    failed = []
    for label, H, HKV, D in (("yi-6b", 32, 4, 128), ("granite", 16, 8, 64),
                             ("g = 8 at head dim 64", 64, 8, 64)):
        n_pages = B * MAXP + 1
        kp, vp = rnd(n_pages, PAGE, HKV, D), rnd(n_pages, PAGE, HKV, D)
        bt = (1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
              [:B * MAXP]).to(torch.int32).reshape(B, MAXP)
        q = rnd(B, 1, H, D)
        want = dr.paged_decode_ref(q, kp, vp, bt, lens)
        least, by = cs.bound(2 * filled * HKV * D * 2 + 2 * q.numel() * 2
                             + bt.numel() * 4, 4 * filled * H * D)
        kg = kp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, MAXP * PAGE, HKV, D).transpose(1, 2)
        mask = (torch.arange(MAXP * PAGE, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        qt = q.transpose(1, 2)
        t_lib = cs.median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True))
        print(f"[variants] {label} q (8,1,{H},{D}), pools ({n_pages},16,"
              f"{HKV},{D}), lengths 1..1024: bound {least:.5f} ms ({by}); "
              f"SDPA on gathered KV {t_lib:.4f} ms", flush=True)
        plan, _ = dk.plan_splits(MAXP, PAGE, B * HKV, sms)
        counts = {"planner": plan, "1 split": 1,
                  "half": max(1, plan // 2), "double": min(MAXP, 2 * plan),
                  "a page a split": MAXP}
        out = torch.empty_like(q)
        runs = {}
        for name, n in counts.items():
            ws = torch.empty(B * H * n * (D + 2), dtype=torch.float32,
                             device=dev)
            runs[f"{name} ({n})"] = (libs["kernel"], (
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, HKV, D,
                PAGE, MAXP, n, D ** -0.5, stream), ws)
        for name in SPILL_VARIANTS:
            ws = torch.empty(B * H * plan * (D + 2), dtype=torch.float32,
                             device=dev)
            runs[f"{name} ({plan})"] = (libs[name], (
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, HKV, D,
                PAGE, MAXP, plan, D ** -0.5, stream), ws)
        if "parent" in libs:
            runs["parent"] = (libs["parent"], (
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), out.data_ptr(), B, H, HKV, D, PAGE, MAXP,
                D ** -0.5, stream), None)
        for name, (so, argv, _ws) in runs.items():
            def run():
                err = so.paged_decode_bf16(*argv)
                cs.check(err == 0, f"{name}: launch failed ({err})")
            run()
            torch.cuda.synchronize()
            e, ok = cs.err_within(out, want, cs.TOL)
            if not ok:
                failed.append(f"{name} at {label}")
            t = cs.median_ms(cpm, run)
            print(f"[variants] {label} {name}: {t:.4f} ms, max error "
                  f"{e:.3g}, {least / t:.3f} of the bound, "
                  f"{t / t_lib:.2f}x SDPA" + ("" if ok else "  DIFFERS"),
                  flush=True)
    cs.check(not failed, "variants differ from the plain version: "
             + ", ".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
