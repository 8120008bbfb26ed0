"""The model configuration dataclass (twin of ``repro.configs.base``).

Only ``ModelConfig`` is ported; the shape, mesh and training configs come
with the training and sharding slices (ROADMAP.md, Queue 1 items 14-15).
The fields are ``repro``'s, all of them, so a configuration reads the same
in both packages.
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
