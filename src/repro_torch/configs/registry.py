"""Architecture registry (twin of ``repro.configs.registry``).

Only qwen3-14b is ported: the dense, full-causal model whose serving path
runs both of the LM kernels (K5 flash attention for GQA, K6 rmsnorm for
the layer norms and the qk-norm). Asking for another architecture raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

PORTED = ("qwen3_14b",)


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
