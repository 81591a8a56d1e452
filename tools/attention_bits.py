#!/usr/bin/env python3
"""Digests of the bits that the flash-attention forward kernel gives at
``chip_smoke.py``'s three flash_fwd shapes, to hold it to an older
tree's kernel.

    python3 tools/attention_bits.py [--src DIR]

Inputs are made with numpy from fixed seeds (the same on any machine),
rounded to bf16 and moved to the card; each output's bytes (out, then
lse) are hashed (sha256, first 16 hex digits).  ``PARENT`` holds the
digests that ``flash_fwd.cu`` gave before its kernel body became the
template it shares with paged chunk prefill (``flash_fwd.cuh``),
measured on an H100 by this script with ``--src`` pointing at that
tree's ``src``; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
the kernel as built to them, which shows the shared body kept
flash_fwd's arithmetic.  The kernel has no atomics, so its bits repeat.
Prints the digests as one JSON object; needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> digest, from the tree before the shared kernel body (NVIDIA
# H100 80GB HBM3, 700.00 W, torch 2.11.0+cu128)
PARENT = {
    "flash_fwd q (1,512,32,128) causal": "859f15ee94c2fdea",
    "flash_fwd q (2,4096,32,128) causal": "11967ff4ff27b3ec",
    "flash_fwd q (4,4096,16,64) causal": "3e3ccf0f6e81cfbf",
}
# B, S, H, Hkv, D: the 512-token prompt, yi-6b's and granite's training
SHAPES = [(1, 512, 32, 4, 128), (2, 4096, 32, 4, 128), (4, 4096, 16, 8, 64)]


def digests(torch, dev, fa_kernel):
    """name -> digest of flash_fwd's out and lse at each shape, causal,
    through ``fa_kernel`` (the port's
    ``repro_torch.kernels.flash_attention.kernel``, of whichever tree)."""
    import numpy as np

    res = {}
    for b, s, h, hkv, d in SHAPES:
        rng = np.random.default_rng(s + d)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(dev).to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
        out, lse = fa_kernel.flash_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.contiguous().view(torch.int16).cpu()
                                .numpy().tobytes())
        digest.update(lse.contiguous().cpu().numpy().tobytes())
        res[f"flash_fwd q ({b},{s},{h},{d}) causal"] = digest.hexdigest()[:16]
        del q, k, v, out, lse
    return res


def differ_from_parent(torch, dev, fa_kernel):
    """The shapes whose bits differ from ``PARENT``'s (none when the
    kernel gives the older tree's bits)."""
    got = digests(torch, dev, fa_kernel)
    return sorted(n for n in PARENT if got.get(n) != PARENT[n])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_bits: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    print(json.dumps(digests(torch, torch.device("cuda"), fa_kernel)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
