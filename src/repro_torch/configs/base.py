"""Config dataclasses: model architecture, input shapes, mesh, training
(twin of ``repro.configs.base``).

The fields and defaults are ``repro``'s, all of them, so a configuration
reads the same in both packages. ``MeshConfig`` is carried for the
multi-card slice; the one-card trainer reads none of it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|encdec|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    window: int = 0                  # sliding-window size for "local" blocks
    qk_norm: bool = False
    rope_frac: float = 1.0           # fraction of head_dim rotated
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    act: str = "silu"                # silu|gelu
    gated_mlp: bool = True           # SwiGLU/GeGLU vs plain
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = False
    learned_pos: bool = False        # whisper-style learned positions
    # layer pattern, cycled over depth
    pattern: Tuple[str, ...] = ("attn",)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64
    # RG-LRU (griffin)
    rglru_conv: int = 4
    d_rnn: int = 0                   # defaults to d_model when 0
    # encoder-decoder (whisper backbone)
    enc_layers: int = 0
    enc_seq: int = 0
    max_pos: int = 32768             # learned-position table size
    # multimodal stub frontend
    num_image_tokens: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    true_vocab: int = 0              # unpadded vocab (0 => == vocab_size)
    # distribution strategy knobs (read by the sharded slices)
    moe_impl: str = "local"
    tp_reduce: str = "xla"

    @property
    def pattern_groups(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, \
            f"{self.name}: {self.num_layers} layers not divisible by " \
            f"pattern {self.pattern}"
        return self.num_layers // len(self.pattern)

    @property
    def d_rnn_eff(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return self.shape[self.axes.index("model")]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0              # number of accumulation microbatches
    remat: str = "full"              # full|dots|none|nested
    accum_dtype: str = "float32"     # bfloat16 halves grad-accum memory
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    moments_dtype: str = "float32"   # bfloat16 to halve optimizer memory
    seed: int = 0
    # multi-pod DCN strategy: "sync" per-step psum | "diloco" H-step outer
    multipod_strategy: str = "sync"
    diloco_h: int = 16
    diloco_outer_lr: float = 0.7
    diloco_outer_momentum: float = 0.9
    grad_compression: str = "none"   # none|int8_ef
    # PowerTCP-scheduled chunked DCN reduction
    comm_buckets: int = 4
