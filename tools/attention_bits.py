#!/usr/bin/env python3
"""Digests of the bits that the paged chunk-prefill kernel gives at
``chip_smoke.py``'s shapes, to hold it to an older tree's kernel.

    python3 tools/attention_bits.py [--src DIR]

Inputs are made with numpy from fixed seeds (the same on any machine),
rounded to bf16 and moved to the card; each output's bytes are hashed
(sha256, first 16 hex digits).  ``PARENT`` holds the digests that the
kernel gave before the decode kernels were split across blocks (the
tree before ``csrc/attention.cuh`` gained ``split::``; paged prefill
still runs ``attend``, which that change left alone), measured on an
H100 by this script with ``--src`` pointing at that tree's ``src``;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel as
built to them.  The kernel has no atomics, so its bits repeat.  Prints
the digests as one JSON object; needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> digest, from the tree before the split decode kernels (NVIDIA
# H100 80GB HBM3, 700 W, CUDA 12.9)
PARENT = {
    "paged_prefill yi-6b start 0": "90036a96abb688bd",
    "paged_prefill yi-6b start 256": "59bb952bfc03f704",
    "paged_prefill granite start 256": "2551d7eae251fa36",
}


def _cases(np):
    """(name, arguments as numpy arrays) at chip_smoke's shapes: paged
    prefill of a 256-row chunk at start 0 (200 valid) and 256 (180
    valid) over yi-6b's pools, and at start 256 over granite's."""
    out = []
    for label, h, hkv, d in (("yi-6b", 32, 4, 128), ("granite", 16, 8, 64)):
        rng = np.random.default_rng(17 + d)
        b, maxp, page = 8, 64, 16
        n_pages = b * maxp + 1
        kp = rng.standard_normal((n_pages, page, hkv, d), np.float32)
        vp = rng.standard_normal((n_pages, page, hkv, d), np.float32)
        bt = (1 + rng.permutation(n_pages - 1)[:b * maxp]).astype(
            np.int32).reshape(b, maxp)[:1]
        starts = ((0, 200), (256, 180)) if label == "yi-6b" else ((256, 180),)
        for start, n_valid in starts:
            q = rng.standard_normal((1, 256, h, d), np.float32)
            out.append((f"paged_prefill {label} start {start}",
                        (q, kp, vp, bt, np.array([start], np.int32),
                         np.array([n_valid], np.int32))))
    return out


def digests(torch, dev, ops):
    """name -> digest of each case's output through ``ops`` (the port's
    ``repro_torch.kernels.ops``, of whichever tree)."""
    import numpy as np

    def t(a):
        x = torch.from_numpy(a)
        return (x.to(torch.bfloat16) if x.dtype == torch.float32 else x).to(dev)

    res = {}
    for name, args in _cases(np):
        got = ops.paged_prefill_attention(*(t(a) for a in args))
        torch.cuda.synchronize()
        raw = got.contiguous().view(torch.int16).cpu().numpy().tobytes()
        res[name] = hashlib.sha256(raw).hexdigest()[:16]
    return res


def differ_from_parent(torch, dev, ops):
    """The cases whose bits differ from ``PARENT``'s (none when the
    kernels give the older tree's bits)."""
    got = digests(torch, dev, ops)
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
    from repro_torch.kernels import ops
    print(json.dumps(digests(torch, torch.device("cuda"), ops)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
