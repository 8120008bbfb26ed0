"""Architecture registry (twin of ``repro.configs.registry``).

Ported: every architecture of ``repro`` whose blocks are ``"attn"``,
``"moe"``, ``"local"``, ``"rec"`` or ``"ssm"``: the dense qwen3-14b,
llama3-405b, gemma-7b (GeGLU, tied and scaled embeddings, head dim 256)
and stablelm-3b (layernorm, partial RoPE, head dim 80), the
mixture-of-experts qwen3-moe-30b-a3b and granite-moe-3b-a800m (tied
embeddings, a padded vocab), the hybrid recurrentgemma-2b (RG-LRU
``"rec"`` blocks and sliding-window ``"local"`` attention with a ring
cache) and the state-space mamba2-130m (``"ssm"`` blocks, the chunked
SSD). Each attention runs K5 flash attention (mamba2 has none); K6
rmsnorm serves the rmsnorm norms and the qk-norm (stablelm's layernorm
and mamba2's gated norm are plain torch). Asking for another
architecture (whisper-large-v3, phi3-vision-4.2b) raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

PORTED = ("qwen3_14b", "llama3_405b", "gemma_7b", "stablelm_3b",
          "qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "recurrentgemma_2b",
          "mamba2_130m")


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = canon(name)
    if arch not in PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 15); ported: {', '.join(PORTED)}")
    return importlib.import_module(f"{__package__}.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced_config(name: str) -> ModelConfig:
    return _module(name).REDUCED


def padded_vocab(v: int, mult: int = 256) -> int:
    return ((v + mult - 1) // mult) * mult
