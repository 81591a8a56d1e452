#!/usr/bin/env python3
"""Where the paged engine's greedy streams and the contiguous path's part,
over all twelve of ``chip_smoke.py``'s yi-6b prompts (the script holds
four), with the gap at each part printed instead of held:

    python3 tools/decode_streams.py [--src DIR]

yi-6b at full width and depth (random weights from seed 0) serves the
prompts through the engine's legacy ticks (paged decode), then runs each
prompt alone through ``Model.prefill`` and ``decode_step`` (decode over
a contiguous cache), both as ``chip_smoke.py`` runs them.  For each
prompt it prints the first step where the two streams part and the
engine token's logit gap below the contiguous path's largest logit (or
None).  ``--src`` runs another tree's ``repro_torch`` (e.g. an older
commit's ``src``, unpacked into a directory ``.gitignore`` lists) with
this tree's ``chip_smoke.py`` driving it.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to run")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_streams: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    # after repro_torch: flash_bwd_variants puts this tree's src first
    from flash_bwd_variants import card

    # report each part instead of stopping at the first one held too far
    cs.check = lambda cond, msg: None if cond else print(f"[streams] {msg}")
    dev = torch.device("cuda")
    print(f"[streams] {card(torch)}")
    build.build()
    cfg = registry.get("yi-6b")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, 12)]
    _, streams = cs.serve_run(torch, dev, cfg, params, 0, prompts, build)
    cs.contiguous_phase(torch, dev, cfg, params, prompts, streams, build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
