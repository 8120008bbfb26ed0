"""Serving on PyTorch (twin of ``repro.serve``): KV caches, prefill/decode
step builders, decode driver."""
from .cache import CACHE_DTYPE, cache_bytes, cache_specs, init_cache
from .engine import (decode_loop, make_forward, make_prefill_step,
                     make_serve_step)

__all__ = ["CACHE_DTYPE", "cache_bytes", "cache_specs", "init_cache",
           "decode_loop", "make_forward", "make_prefill_step",
           "make_serve_step"]
