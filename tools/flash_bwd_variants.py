#!/usr/bin/env python3
"""What each design choice of ``src/repro_torch/csrc/flash_bwd.cu`` is
worth on the card: the kernels as they are, and each rebuilt without one
choice, timed in one run at yi-6b's and granite-moe-1b-a400m's training
shapes (causal).

    python3 tools/flash_bwd_variants.py

Each variant is a textual edit of the source, built beside the kernels:

* ``masked``: every tile through the masked elementwise path (no fast
  path for tiles that every row sees whole).

Every variant must give the same bits as the kernels (the same sums in
the same order); the script fails otherwise.  It prints each kernel's
registers and spills (``-Xptxas -v``), its CUDA-event time (as
``chip_smoke.py`` takes it) and achieved TFLOP/s, beside the card's name
and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

VARIANTS = {
    "kernel": [],
    "masked": [("if ((!causal || k0 + STEP - 1 <= q0 + q_offset)",
                "if (false && (!causal || k0 + STEP - 1 <= q0 + q_offset)"),
               ("if ((!causal || k0 + ROWS - 1 <= q0 + q_offset)",
                "if (false && (!causal || k0 + ROWS - 1 <= q0 + q_offset)")],
}
SHAPES = [(2, 4096, 32, 4, 128), (4, 4096, 16, 8, 64)]   # B, S, H, Hkv, D


def build_variants(build):
    out = ROOT / "build" / "flash_bwd_variants"
    src = (build.CSRC / "flash_bwd.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in "
                                   f"flash_bwd.cu")
            text = text.replace(old, new)
        (d / "flash_bwd.cu").write_text(text)
        for f in ("common.cuh", "errors.cu"):
            shutil.copy(build.CSRC / f, d / f)
        procs[name] = (d, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             str(d / "flash_bwd.cu"), str(d / "errors.cu"),
             "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "Used" in ln or "spill stores" in ln]
        print(f"[variants] {name}: {'; '.join(regs)}", flush=True)
        so = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
            getattr(so, fn).argtypes = build.SIGNATURES[fn]
            getattr(so, fn).restype = ctypes.c_int
        libs[name] = so
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa

    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[variants] {smi}; torch {torch.__version__}", flush=True)
    libs = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cpm = cs.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream().cuda_stream
    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    for B, S, H, HKV, D in SHAPES:
        q, k, v = rnd(B, S, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D)
        do = rnd(B, S, H, D)
        out, lse = fa.flash_fwd(q, k, v, causal=True)
        delta = (out.float() * do.float()).sum(-1)
        mm = 2 * B * (S * (S + 1) // 2) * H * D
        first = None
        for name, so in libs.items():
            dq = torch.empty_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            args = (B, S, S, H, HKV, D, 1, 0, D ** -0.5, stream)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr())

            def run_dq():
                err = so.flash_bwd_dq_bf16(*ptrs, dq.data_ptr(), *args)
                cs.check(err == 0, f"{name}: dq launch failed ({err})")

            def run_dkv():
                err = so.flash_bwd_dkv_bf16(*ptrs, dk.data_ptr(),
                                            dv.data_ptr(), *args)
                cs.check(err == 0, f"{name}: dkv launch failed ({err})")
            run_dq()
            run_dkv()
            torch.cuda.synchronize()
            got = (dq, dk, dv)
            if first is None:
                first = tuple(t.clone() for t in got)
            cs.check(all(torch.equal(a, b) for a, b in zip(first, got)),
                     f"variant {name} gives other bits than the kernels")
            t_dq, t_dkv = cs.median_ms(cpm, run_dq), cs.median_ms(cpm, run_dkv)
            print(f"[variants] {name} q ({B},{S},{H},{D}) kv "
                  f"({B},{S},{HKV},{D}): dq {t_dq:.4f} ms "
                  f"{3 * mm / t_dq / 1e9:.1f} TFLOP/s, dkv {t_dkv:.4f} ms "
                  f"{4 * mm / t_dkv / 1e9:.1f} TFLOP/s, both "
                  f"{t_dq + t_dkv:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
