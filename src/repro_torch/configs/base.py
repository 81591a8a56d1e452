"""Model, workload and training configuration for the PyTorch port.

Copies of the fields and properties of the JAX package's
``configs/base.py`` that the decoders' serving and single-device
training paths read: ``MoEConfig``, ``MambaConfig``, ``XLSTMConfig``,
``ModelConfig`` (with its optimizer choice), ``WorkloadShape`` with
``SHAPES``, ``TrainConfig``, and ``ShardingStrategy`` with its named
instances.
Field names and defaults match, so a config converts field for field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (token-choice top-k, capacity dispatch)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Apply MoE to every ``every``-th position of the block pattern (1 = all).
    every: int = 1
    # Arctic-style parallel dense residual FFN next to the MoE branch.
    dense_residual: bool = False
    d_ff_dense: int = 0
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class MambaConfig:
    """Jamba-style Mamba (selective SSM) block settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block settings (mLSTM matrix memory / sLSTM scalar memory)."""

    n_heads: int = 4
    expand: int = 2          # up-projection factor inside the cell
    d_conv: int = 4          # causal conv in mLSTM pre-projection
    chunk_size: int = 64     # chunkwise-parallel training chunk


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0                  # 0 -> d_model // n_heads

    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # chatglm3 2d-RoPE: rotate half the head dim
    qkv_bias: bool = False
    causal: bool = True

    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    mlp_type: str = "swiglu"         # swiglu | gelu
    pos_type: str = "rope"           # rope | sinusoidal | none
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # kinds cycle through this pattern; parameters are keyed "p{i}" by
    # position and stacked over n_repeats
    block_pattern: Tuple[str, ...] = ("attn",)   # attn | mamba | mlstm | slstm

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # encoder-decoder (whisper)
    encoder_layers: int = 0          # >0 -> enc-dec with cross attention
    encoder_seq_divisor: int = 1     # encoder frames = seq_len // divisor

    # modality frontend stub: precomputed frame or patch embeddings
    frontend: Optional[str] = None   # audio | vision | None

    # optimizer choice (production default per arch)
    optimizer: str = "adamw"         # adamw | adafactor
    opt_state_dtype: str = "float32"  # float32 | bfloat16 (memory pressure)

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
        """True if context cost does not grow quadratically (SSM / hybrid)."""
        return any(k in ("mamba", "mlstm", "slstm") for k in self.block_pattern)

    def n_params(self) -> int:
        """Analytic parameter count, as the JAX package counts it
        (embeddings once when tied; QKV biases counted, norm scales and
        biases not)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            p = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if self.qkv_bias:
                p += h * hd + 2 * kv * hd
            return p

        def mlp_params(dff: int) -> int:
            return (3 if self.mlp_type == "swiglu" else 2) * d * dff

        def mamba_params() -> int:
            mc = self.mamba or MambaConfig()
            d_in = mc.expand * d
            dtr = mc.dt_rank or -(-d // 16)
            return (d * 2 * d_in + d_in * mc.d_conv
                    + d_in * (dtr + 2 * mc.d_state) + dtr * d_in
                    + d_in * mc.d_state + d_in + d_in * d)

        def xlstm_params(kind: str) -> int:
            xc = self.xlstm or XLSTMConfig()
            d_in = xc.expand * d
            if kind == "mlstm":
                return (d * 2 * d_in + d_in * xc.d_conv + 3 * d_in * d_in
                        + 3 * xc.n_heads * (d_in // xc.n_heads)  # gates
                        + d_in * d)
            return (4 * d * d_in + 4 * d_in * (d_in // xc.n_heads)
                    + d_in * d)

        for i, kind in enumerate(self.block_pattern):
            if kind == "attn":
                blk = attn_params()
            elif kind == "mamba":
                blk = mamba_params()
            elif kind in ("mlstm", "slstm"):
                blk = xlstm_params(kind)
            else:
                raise ValueError(kind)
            if self.moe is not None and (i % self.moe.every) == (self.moe.every - 1):
                blk += self.moe.n_experts * mlp_params(self.moe.d_ff_expert)
                blk += d * self.moe.n_experts                       # router
                if self.moe.dense_residual:
                    blk += mlp_params(self.moe.d_ff_dense)
            elif kind in ("attn", "mamba"):
                blk += mlp_params(self.d_ff)
            total += blk * self.n_repeats
        if self.encoder_layers:          # the encoder, cross-attention
            total += ((attn_params() + mlp_params(self.d_ff))
                      * self.encoder_layers + attn_params() * self.n_layers)
        return total


@dataclass(frozen=True)
class WorkloadShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    WorkloadShape("train_4k", "train", 4_096, 256),
    "prefill_32k": WorkloadShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  WorkloadShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   WorkloadShape("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    param_dtype: str = "float32"      # master params
    compute_dtype: str = "bfloat16"
    grad_accum: int = 1
    remat: bool = True
    seed: int = 0


@dataclass(frozen=True)
class ShardingStrategy:
    """Named sharding strategy.  The port reads its comm fields
    (``comm/collectives.py``); tensor parallelism, FSDP and expert
    parallelism have no rule tables in the port yet."""

    name: str = "baseline"
    # baseline : DP over data(+pod), TP over model, ZeRO-1 opt states.
    # fsdp     : + params/grads sharded over data (ZeRO-3), seq-parallel
    #            residual stream, EP experts, sharded KV caches.
    fsdp_params: bool = False
    seq_shard_activations: bool = False
    expert_parallel: bool = True
    # decode-time KV cache sequence sharding axis ("model" | "none")
    kv_seq_axis: str = "model"
    # hierarchical two-phase collective schedule over (pod, data):
    # reduce-scatter inside each pod over the fast data axis, all-reduce
    # the shards across pods over the slow pod axis, all-gather back
    # (see comm/collectives.py)
    hierarchical_collectives: bool = False
    # int8 error-feedback compression on cross-pod gradient reduction
    compress_cross_pod: bool = False
    # logical pod count the compression schema is sized for: the
    # error-feedback residual carries one row per pod payload, and its
    # SHAPE must not depend on the live mesh (elastic remesh reshards
    # the residual with the rest of the train state, so the schema is a
    # function of the strategy alone; meshes whose pod tier differs
    # sync uncompressed with a warning)
    compress_pods: int = 2
    # contiguous fp32 elements per int8 scale (quantization block)
    compress_block: int = 256
    # number of gradient-sync buckets (1 = one monolithic sync after
    # the full backward).  >1 partitions the param tree into
    # ~byte-balanced buckets in REVERSE-layer order and launches each
    # bucket's cross-pod phase as soon as its gradients are final, so
    # DCN time hides behind the remaining backward compute (see
    # comm/bucketing.py; the JAX package's comm/overlap.py prices it)
    comm_buckets: int = 1
    # hierarchical MoE dispatch: shard experts over the pod tier too
    # (``expert`` -> (pod, model)) and route dispatch/combine as
    # pod-local exchange + cross-pod transfer of only the tokens whose
    # expert lives in another pod (see models/moe.py; the port raises)
    hierarchical_moe: bool = False
    # error instead of falling back to flat sync when the mesh cannot
    # honor the requested comm schedule (no pod tier, pod mismatch)
    comm_strict: bool = False
    # tensor parallelism over the model axis; when False the model axis
    # becomes a second FSDP/data axis (pure ZeRO-3 over all 256 chips)
    tensor_parallel: bool = True


BASELINE = ShardingStrategy(name="baseline")
OPTIMIZED = ShardingStrategy(
    name="optimized", fsdp_params=True, seq_shard_activations=True,
    expert_parallel=True, hierarchical_collectives=True)
# beyond-paper: all 256 chips as one FSDP domain; params gathered bf16
# per layer, activations fully local (1 batch row per chip at gb=256)
ZERO3 = ShardingStrategy(
    name="zero3", fsdp_params=True, seq_shard_activations=False,
    expert_parallel=True, tensor_parallel=False)

STRATEGIES = {"baseline": BASELINE, "optimized": OPTIMIZED,
              "zero3": ZERO3}
