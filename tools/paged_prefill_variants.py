#!/usr/bin/env python3
"""What each design choice of paged chunk prefill
(``src/repro_torch/csrc/paged_attention.cu``, on the attention forward
body of ``flash_fwd.cuh``) is worth on the card: the kernel as shipped,
and rebuilt without one choice, timed in one run at ``chip_smoke.py``'s
chunk (256 rows at start 256, 180 of them real, page 16) at yi-6b's
widths (32 query heads over 4 KV heads of 128) and
granite-moe-1b-a400m's (16 over 8 of 64):

    python3 tools/paged_prefill_variants.py [--parent DIR]

Each variant is a textual edit of the source or of the body, built
beside the kernel the way ``tools/flash_bwd_variants.py`` builds its
own:

* ``per_head``: a tile's 64 rows from one query head (the grid over the
  H heads), not the g heads of a KV head packed into its rows, so each
  head stages its own K/V tiles;
* ``wg2``: two warpgroups a block sharing each K/V tile, not one;
* ``kt2``: steps of two 64-key tiles, not one;
* ``masked``: every step through the masked softmax (no fast path for
  steps that every row of a warpgroup sees whole);
* ``parent`` (with ``--parent DIR``): ``DIR/paged_attention.cu`` with
  the headers in DIR before those of ``csrc/``: an older tree's kernel
  with the same C signature, e.g. unpacked from ``git show
  <commit>:src/repro_torch/csrc/...`` into a directory .gitignore lists.

``per_head``, ``wg2`` and ``masked`` must give the kernel's bits (each
row's sums in the same order).  ``kt2`` takes its maxima over other
keys, so its p round elsewhere, and an older kernel may round otherwise:
both are held to the kernel within ``chip_smoke.py``'s TOL and
FWD_REL_L2_TOL over the real rows.  Every build is also held to the plain
version (``ref.paged_prefill_ref``) likewise.  The script fails
otherwise.  It prints each build's registers, spills and ptxas C75xx
notes for the prefill kernels, each one's CUDA-event time (as
``chip_smoke.py`` takes it) beside SDPA on the gathered KV, the bound,
and the card's name and power limit; then the shipped kernel's time at
other fills of the same 256-row chunk (1 to 16 steps of 64 keys for the
heaviest tile), which parts its cost into a step's and a launch's.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

CFG128 = "struct PrefillCfg<128> {\n  static constexpr int WGS = 1, MIN_BLOCKS = 2, KT = 1;"
CFG64 = "struct PrefillCfg<64> {\n  static constexpr int WGS = 1, MIN_BLOCKS = 4, KT = 1;"
VARIANTS = {
    "kernel": [],
    "per_head": [("const int gp = H / Hkv;", "const int gp = 1;")],
    "wg2": [(CFG128, CFG128.replace("WGS = 1, MIN_BLOCKS = 2",
                                    "WGS = 2, MIN_BLOCKS = 1")),
            (CFG64, CFG64.replace("WGS = 1, MIN_BLOCKS = 4",
                                  "WGS = 2, MIN_BLOCKS = 2"))],
    "kt2": [(CFG128, CFG128.replace("KT = 1", "KT = 2")),
            (CFG64, CFG64.replace("KT = 1", "KT = 2"))],
    "masked": [("const bool whole =\n        (!rows.causal()",
                "const bool whole = false &&\n        (!rows.causal()")],
}
ROUNDS_ELSEWHERE = {"kt2", "parent"}
C, START, N_VALID, PAGE, SLOTS, MAXP = 256, 256, 180, 16, 8, 64
# (start, n_valid) of the chunk for the time against the keys
FILLS = [(0, 64), (0, 200), (256, 180), (512, 256), (768, 256)]


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flash_bwd_variants import build_variants, card
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ref as dr

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding an older "
                    "paged_attention.cu to build and time beside the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_prefill_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[variants] {card(torch)}", flush=True)
    libs = build_variants(build, "paged_attention.cu", VARIANTS,
                          ("paged_prefill_bf16",), args.parent,
                          only="paged_prefill")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cpm = cs.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream().cuda_stream

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    i32 = dict(dtype=torch.int32, device=dev)
    st = torch.tensor([START], **i32)
    nv = torch.tensor([N_VALID], **i32)
    fill = START + N_VALID
    seen = sum(min(START + j + 1, fill) for j in range(C))
    failed = []
    for label, H, HKV, D in (("yi-6b", 32, 4, 128), ("granite", 16, 8, 64)):
        n_pages = SLOTS * MAXP + 1
        kp, vp = rnd(n_pages, PAGE, HKV, D), rnd(n_pages, PAGE, HKV, D)
        bt = (1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
              [:MAXP]).to(torch.int32).reshape(1, MAXP)
        q = rnd(1, C, H, D)
        want = dr.paged_prefill_ref(q, kp, vp, bt, st, nv)
        least, by = cs.bound(2 * fill * HKV * D * 2 + 2 * q.numel() * 2,
                             4 * seen * H * D)
        kg = kp[bt.long()].reshape(1, MAXP * PAGE, HKV, D).transpose(1, 2)
        vg = vp[bt.long()].reshape(1, MAXP * PAGE, HKV, D).transpose(1, 2)
        qpos = START + torch.arange(C, device=dev)
        kpos = torch.arange(MAXP * PAGE, device=dev)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] < fill))[None, None]
        qt = q.transpose(1, 2)
        t_lib = cs.median_ms(cpm, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True))
        print(f"[variants] {label} q (1,{C},{H},{D}) at start {START}, "
              f"n_valid {N_VALID}, pools ({n_pages},{PAGE},{HKV},{D}): bound "
              f"{least:.5f} ms ({by}); SDPA on the gathered KV {t_lib:.4f} ms",
              flush=True)
        out = torch.empty_like(q)
        kernel = None                      # the shipped kernel's output
        for name, so in libs.items():      # "kernel" first
            def run():
                err = so.paged_prefill_bf16(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                    st.data_ptr(), nv.data_ptr(), out.data_ptr(), 1, C, H, HKV,
                    D, PAGE, MAXP, D ** -0.5, stream)
                cs.check(err == 0, f"{name}: launch failed ({err})")
            run()
            torch.cuda.synchronize()
            real = out[:, :N_VALID]
            if name == "kernel":
                kernel = out.clone()
            e, ok = cs.err_within(real, want[:, :N_VALID], cs.TOL)
            r = cs.rel_l2(real, want[:, :N_VALID])
            ok = ok and r <= cs.FWD_REL_L2_TOL
            if name in ROUNDS_ELSEWHERE:
                _, close = cs.err_within(real, kernel[:, :N_VALID], cs.TOL)
                ok = ok and close and (cs.rel_l2(real, kernel[:, :N_VALID])
                                       <= cs.FWD_REL_L2_TOL)
            else:
                ok = ok and torch.equal(out, kernel)
            if not ok:
                failed.append(f"{name} at {label}")
            t = cs.median_ms(cpm, run)
            print(f"[variants] {label} {name}: {t:.4f} ms, {least / t:.3f} of "
                  f"the bound, {t / t_lib:.2f}x SDPA; against the plain "
                  f"version max error {e:.3g}, relative L2 {r:.3g}"
                  + ("" if ok else "  DIFFERS"), flush=True)
        times = []
        for start, n_valid in FILLS:
            sf = torch.tensor([start], **i32)
            nf = torch.tensor([n_valid], **i32)

            def run():
                err = libs["kernel"].paged_prefill_bf16(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                    sf.data_ptr(), nf.data_ptr(), out.data_ptr(), 1, C, H, HKV,
                    D, PAGE, MAXP, D ** -0.5, stream)
                cs.check(err == 0, f"kernel: launch failed ({err})")
            steps = -(-(start + n_valid) // 64)
            times.append((steps, cs.median_ms(cpm, run)))
        print(f"[variants] {label} kernel against the keys (steps of 64 for "
              f"the heaviest tile: ms): "
              + ", ".join(f"{n}: {t:.4f}" for n, t in times), flush=True)
    cs.check(not failed, "variants differ: " + ", ".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
