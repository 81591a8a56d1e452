"""Model configuration for the PyTorch port.

A copy of the fields and properties of ``ModelConfig`` that the dense
serving path reads.  Field names and defaults match the JAX package's
``configs/base.py`` so a config converts field for field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0                  # 0 -> d_model // n_heads

    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # rotate this fraction of the head dim
    causal: bool = True
    norm_eps: float = 1e-5

    # kinds cycle through this pattern; parameters are keyed "p{i}" by
    # position and stacked over n_repeats (attention-only so far)
    block_pattern: Tuple[str, ...] = ("attn",)

    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % self.pattern_len == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern of length {self.pattern_len}")
        return self.n_layers // self.pattern_len

    @property
    def sub_quadratic(self) -> bool:
        return any(k in ("mamba", "mlstm", "slstm") for k in self.block_pattern)

    def n_params(self) -> int:
        """Analytic parameter count of the dense decoder (embedding and
        head, attention and SwiGLU weights; norm scales not counted)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        return 2 * self.vocab_size * d + self.n_layers * (attn + 3 * d * self.d_ff)

