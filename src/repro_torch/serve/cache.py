"""Decode-cache declarations (twin of ``repro.serve.cache``, the full KV
cache of ``"attn"`` blocks: [G, B, cache_len, KV, Dh] in bfloat16).

The ring-buffer, recurrent and SSM caches come with their block kinds
(ROADMAP.md, Queue 1 item 15).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.lm import check_config
from ..models.spec import ParamSpec, init_params, num_bytes

CACHE_DTYPE = "bfloat16"

# Production TP width of ``repro``'s sharding rules: the cache shards its
# kv heads when they divide it, else its sequence (the axes are kept for
# the sharded slice, ROADMAP.md Queue 1 item 14; nothing reads them yet).
PRODUCTION_TP = 16


def _kv_axes(kv_heads: int, seq: int):
    if kv_heads % PRODUCTION_TP == 0:
        return ("layers", "batch", None, "kv", None)
    if seq % PRODUCTION_TP == 0:
        return ("layers", "batch", "seq", None, None)
    return ("layers", "batch", None, None, None)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    check_config(cfg)
    kv = ParamSpec((cfg.pattern_groups, batch, cache_len, cfg.num_kv_heads,
                    cfg.head_dim), CACHE_DTYPE,
                   _kv_axes(cfg.num_kv_heads, cache_len), "zeros")
    return {f"b{j}_{kind}": {"k": kv, "v": kv}
            for j, kind in enumerate(cfg.pattern)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda"):
    return init_params(cache_specs(cfg, batch, cache_len), None, device)


def cache_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> int:
    return num_bytes(cache_specs(cfg, batch, cache_len))
