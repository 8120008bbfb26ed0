"""Per-arch training presets (microbatching, remat, dtypes); a copy of
``repro.launch.presets``.

  * microbatch: #accumulation steps; global batch 256 over 32 DP shards
    (multi-pod) leaves 8 seqs/shard -> microbatch of 8 keeps one seq per
    shard per step and bounds logits+activation memory.
  * llama3-405b: bf16 params + bf16 moments + bf16 grad accumulation and
    sqrt(L) nested remat.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import TrainConfig

_DEFAULT = TrainConfig(microbatch=8, remat="full")

_OVERRIDES = {
    "llama3_405b": dict(microbatch=8, remat="nested",
                        accum_dtype="bfloat16", moments_dtype="bfloat16"),
    "qwen3_moe_30b_a3b": dict(microbatch=8, remat="full"),
    "whisper_large_v3": dict(microbatch=8, remat="full"),
}


def train_preset(arch: str) -> TrainConfig:
    over = _OVERRIDES.get(arch, {})
    return dataclasses.replace(_DEFAULT, **over)
