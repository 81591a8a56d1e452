#!/usr/bin/env python3
"""How far bf16 compute moves a sequence-mixer model's logits from float32
compute, in the PyTorch port and in the JAX reference, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/seqmix_drift.py \
        --arch xlstm-1.3b --layers 8 [--prompt-len 77]

Draws the arch's full-width config at ``--layers`` layers from the JAX
init (seed 0), carries the parameters into the port, prefills one
prompt (exact length, numpy seed 7) through both packages in float32 and
in bfloat16 (the plain versions in the port), and prints the relative L2
distance of the last-position logits for: port f32 vs JAX f32 (parity),
JAX bf16 vs JAX f32 and port bf16 vs port f32 (each package's own bf16
drift), and port bf16 vs JAX bf16.  A full-depth xlstm-1.3b needs about
20 GB of host memory; depth sets the size.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import registry as jreg
    from repro.models.model import Model as JModel
    from repro_torch.configs import registry as treg
    from repro_torch.models import params as P
    from repro_torch.models.model import Model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b",
                    choices=["xlstm-1.3b", "jamba-v0.1-52b"])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=77)
    args = ap.parse_args(argv)

    jcfg = dataclasses.replace(jreg.get(args.arch), n_layers=args.layers)
    tcfg = dataclasses.replace(treg.get(args.arch), n_layers=args.layers)
    t = time.perf_counter()
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.device_get(jp))
    print(f"{args.arch} at {args.layers} layers, "
          f"{JModel(jcfg).n_params() / 1e9:.3f} B params, drawn in "
          f"{time.perf_counter() - t:.1f} s")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                             (1, args.prompt_len))
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        logits, _ = jax.jit(lambda p, x: JModel(jcfg).prefill(
            p, {"tokens": x}, compute_dtype=dt))(jp, jnp.asarray(toks))
        out["jax " + name] = np.asarray(logits.astype(jnp.float32))
    with torch.no_grad():
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            logits, _ = Model(tcfg, impl="ref").prefill(
                tp, {"tokens": torch.from_numpy(toks)}, compute_dtype=dt)
            out["port " + name] = logits.float().numpy()

    def rel(a, b):
        return float(np.linalg.norm(out[a] - out[b])
                     / np.linalg.norm(out[b]))

    for a, b in (("port f32", "jax f32"), ("jax bf16", "jax f32"),
                 ("port bf16", "port f32"), ("port bf16", "jax bf16")):
        print(f"relative L2 of the last logits, {a} vs {b}: {rel(a, b):.5f}")


if __name__ == "__main__":
    main()
