"""Model zoo on PyTorch (twin of ``repro.models``): spec-declared params
and the decoder-only LM, ``"attn"`` and ``"moe"`` blocks."""
from .spec import (ParamSpec, cache_from_numpy, fan_in_normal, init_params,
                   is_spec, num_bytes, num_params, opt_from_numpy,
                   params_from_numpy, tree_map_specs)
from .lm import lm_decode_step, lm_forward, lm_prefill, lm_specs
from . import layers

__all__ = [
    "ParamSpec", "cache_from_numpy", "fan_in_normal", "init_params",
    "is_spec", "num_bytes", "num_params", "opt_from_numpy",
    "params_from_numpy",
    "tree_map_specs", "lm_decode_step", "lm_forward", "lm_prefill",
    "lm_specs", "layers",
]
