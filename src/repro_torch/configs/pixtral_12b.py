"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo decoder.

[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The vision tower is a stub: precomputed patch embeddings (``patches``)
take the place of the leading token embeddings.  No ``d_head`` is set,
so the head dim is 5120 // 32 = 160 (the published text decoder's is
128; this copy keeps the reference's config as it is).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000_000.0,
    frontend="vision",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    frontend="vision",
)
