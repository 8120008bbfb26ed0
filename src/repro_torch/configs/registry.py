"""Architecture registry (twin of ``repro.configs.registry``).

Ported: all ten architectures of ``repro``: the dense qwen3-14b,
llama3-405b, gemma-7b (GeGLU, tied and scaled embeddings, head dim 256)
and stablelm-3b (layernorm, partial RoPE, head dim 80), the
mixture-of-experts qwen3-moe-30b-a3b and granite-moe-3b-a800m (tied
embeddings, a padded vocab), the hybrid recurrentgemma-2b (RG-LRU
``"rec"`` blocks and sliding-window ``"local"`` attention with a ring
cache), the state-space mamba2-130m (``"ssm"`` blocks, the chunked SSD),
the encoder-decoder whisper-large-v3 (bidirectional ``"enc"`` blocks,
``"dec"`` blocks with cross-attention, learned positions, the plain GELU
MLP, layernorm) and the vision-language phi3-vision-4.2b (image
embeddings over the first 576 positions, head dim 96). Each attention
runs K5 flash attention (mamba2 has none); K6 rmsnorm serves the rmsnorm
norms and the qk-norm (the layernorms and mamba2's gated norm are plain
torch). The audio and image frontends are stubs, as in ``repro``: the
batch carries their embeddings (``configs/inputs.py``).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

PORTED = ("qwen3_14b", "llama3_405b", "gemma_7b", "stablelm_3b",
          "qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "recurrentgemma_2b",
          "mamba2_130m", "whisper_large_v3", "phi3_vision_4_2b")


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    return importlib.import_module(f"{__package__}.{canon(name)}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced_config(name: str) -> ModelConfig:
    return _module(name).REDUCED


def padded_vocab(v: int, mult: int = 256) -> int:
    return ((v + mult - 1) // mult) * mult
