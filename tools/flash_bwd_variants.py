#!/usr/bin/env python3
"""What each design choice of ``src/repro_torch/csrc/flash_bwd.cu`` is
worth on the card: the kernels as they are, and each rebuilt without one
choice, timed in one run at yi-6b's and granite-moe-1b-a400m's training
shapes (causal).

    python3 tools/flash_bwd_variants.py [--parent DIR]

Each variant is a textual edit of the source, built beside the kernels:

* ``masked``: every tile through the masked elementwise path (no fast
  path for tiles that every row sees whole);
* ``parent`` (with ``--parent DIR``): ``DIR/flash_bwd.cu`` as it is, with
  the headers in DIR before those of ``csrc/``: an older tree's kernels,
  e.g. ``git show HEAD~1:src/repro_torch/csrc/flash_bwd.cu``.

Every variant must give the same bits as the kernels (the same sums in
the same order); the script fails otherwise.  It prints each kernel's
registers, spills and ptxas's C75xx notes on wgmma (``-Xptxas -v``), its CUDA-event time (as
``chip_smoke.py`` takes it) and achieved TFLOP/s, beside the card's name
and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
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


def build_variants(build, source, variants, fns, parent=None, only=""):
    """Build ``csrc/<source>`` once per variant of ``variants`` (name ->
    textual edits, each made in the one file of ``source`` and the
    headers that holds its old text), each with ``errors.cu`` and the
    headers beside it, all with one nvcc each, started together; with
    ``parent`` (a directory) also ``parent/<source>`` as variant
    ``parent``, with the headers in it before those of ``csrc/``.
    Prints each build's registers, spills and C75xx notes by kernel
    (those whose name holds ``only``).  Returns name -> the loaded
    library with the C entry points ``fns`` bound."""
    out = ROOT / "build" / f"{Path(source).stem}_variants"
    files = {f.name: f.read_text() for f in
             [build.CSRC / source, *sorted(build.CSRC.glob("*.cuh"))]}
    texts = {}
    for name, edits in variants.items():
        edited = dict(files)
        for old, new in edits:
            where = [f for f, text in edited.items() if old in text]
            if len(where) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is in "
                                   f"{where or 'none'} of {source} and "
                                   f"its headers, not in one")
            edited[where[0]] = edited[where[0]].replace(old, new)
        texts[name] = edited
    if parent is not None:
        parent = Path(parent)
        texts["parent"] = {**files, **{f.name: f.read_text() for f in
                                       [parent / source,
                                        *parent.glob("*.cuh")]}}
    procs = {}
    for name, edited in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(build.CSRC / "errors.cu", d / "errors.cu")
        for f, text in edited.items():
            (d / f).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(d / source),
             str(d / "errors.cu"), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        print(f"[variants] {name}: "
              f"{'; '.join(build.ptxas_report(log, only))}", flush=True)
        so = ctypes.CDLL(str(d / "lib.so"))
        for fn in fns:
            getattr(so, fn).argtypes = build.SIGNATURES[fn]
            getattr(so, fn).restype = ctypes.c_int
        libs[name] = so
    return libs


def card(torch):
    """The card's name and power limit, and torch's version."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return f"{smi}; torch {torch.__version__}"


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding an older "
                    "flash_bwd.cu to build and hold beside the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[variants] {card(torch)}", flush=True)
    libs = build_variants(build, "flash_bwd.cu", VARIANTS,
                          ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"),
                          args.parent)
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
        kernel = None                    # the shipped kernels' bits
        for name, so in libs.items():      # "kernel" first
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
            if name == "kernel":
                kernel = tuple(t.clone() for t in got)
            cs.check(all(torch.equal(a, b) for a, b in zip(kernel, got)),
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
