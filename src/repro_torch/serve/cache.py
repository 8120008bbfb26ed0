"""Decode-cache declarations (twin of ``repro.serve.cache``).

Cache kinds per block:
  attn/moe/dec  full KV cache        [G, B, cache_len, KV, Dh]   (+xk/xv)
  local         ring-buffer KV       [G, B, min(window, cache_len), KV, Dh]
  rec           RG-LRU hidden (fp32) [G, B, d_rnn] + conv tail
  ssm           SSD state            [G, B, H, P, N] + conv tail

with a ``"dec"`` block's cross keys and values ``xk``/``xv`` [G, B,
enc_seq, KV, Dh], declared in ``CACHE_DTYPE`` but the RG-LRU state.
``lm_prefill`` returns what ``repro``'s prefill returns instead: the
ring at the window's size, the cross keys at the encoder's length, and
the caches in the compute dtype (``models.lm._new_cache``).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.lm import check_config
from ..models.spec import ParamSpec, init_params, num_bytes
from ..models.ssm import mamba_dims

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
    G, B = cfg.pattern_groups, batch
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    c = {}
    for j, kind in enumerate(cfg.pattern):
        key = f"b{j}_{kind}"
        if kind in ("attn", "moe", "local", "dec"):
            S = cache_len
            if kind == "local":
                S = min(cfg.window, cache_len) or cache_len
            kv = ParamSpec((G, B, S, KV, Dh), CACHE_DTYPE, _kv_axes(KV, S),
                           "zeros")
            c[key] = {"k": kv, "v": kv}
            if kind == "dec":
                xkv = ParamSpec((G, B, cfg.enc_seq, KV, Dh), CACHE_DTYPE,
                                _kv_axes(KV, cfg.enc_seq), "zeros")
                c[key].update(xk=xkv, xv=xkv)
        elif kind == "rec":
            dr = cfg.d_rnn_eff
            c[key] = {
                "h": ParamSpec((G, B, dr), "float32",
                               ("layers", "batch", "rnn"), "zeros"),
                "conv": ParamSpec((G, B, cfg.rglru_conv - 1, dr),
                                  CACHE_DTYPE,
                                  ("layers", "batch", None, "rnn"), "zeros"),
            }
        elif kind == "ssm":
            d_in, H, N, conv_ch, _ = mamba_dims(cfg)
            c[key] = {
                "state": ParamSpec((G, B, H, d_in // H, N), CACHE_DTYPE,
                                   ("layers", "batch", None, None, None),
                                   "zeros"),
                "conv": ParamSpec((G, B, cfg.ssm_conv - 1, conv_ch),
                                  CACHE_DTYPE,
                                  ("layers", "batch", None, "inner"),
                                  "zeros"),
            }
    return c


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda"):
    return init_params(cache_specs(cfg, batch, cache_len), None, device)


def cache_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> int:
    return num_bytes(cache_specs(cfg, batch, cache_len))
