"""Parameter-spec system (twin of ``repro.models.spec``).

Every model declares its parameters once, as a tree of dicts with
``ParamSpec`` leaves (shape + dtype + logical axes + init recipe). From
that declaration come:

  * ``init_params``       tensors drawn on the device from an explicit
                          ``torch.Generator`` (its draws are not JAX's)
  * ``params_from_numpy`` the same tree from numpy arrays, key for key —
                          how the tests carry ``repro``'s params across
  * ``opt_from_numpy``    the optimizer state likewise (``repro``'s
                          ``OptState`` of numpy arrays)
  * ``num_params`` / ``num_bytes``

The logical axes are kept for the sharded slices (ROADMAP.md, Queue 1
item 14); nothing reads them yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.types import resolve_device


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: str = "float32"
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"       # normal | zeros | ones | constant
    scale: float = 1.0         # stddev (normal) or value (constant)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn, tree):
    """``fn`` over the spec leaves of a tree of dicts."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in _leaves(tree[k])]


def fan_in_normal(shape, fan_axis: int = 0, dtype="float32", axes=(),
                  gain: float = 1.0) -> ParamSpec:
    """Normal init with 1/sqrt(fan_in) scale."""
    fan = shape[fan_axis] if shape else 1
    return ParamSpec(tuple(shape), dtype, tuple(axes), "normal",
                     gain / float(np.sqrt(max(fan, 1))))


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(specs, generator: torch.Generator, device="cuda"):
    """Materialize a spec tree on ``device``: zeros, ones and constants as
    declared, normal leaves drawn from ``generator`` (a generator on that
    device) times the spec's scale, leaf by leaf in sorted-key order."""
    dev = resolve_device(device)

    def one(spec: ParamSpec):
        dt = torch_dtype(spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if spec.init == "constant":
            return torch.full(spec.shape, spec.scale, dtype=dt, device=dev)
        x = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        x.normal_(0.0, 1.0, generator=generator).mul_(spec.scale)
        return x if dt == torch.float32 else x.to(dt)

    def walk(tree):
        if is_spec(tree):
            return one(tree)
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(specs)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a tensor. numpy's bfloat16 (``ml_dtypes``) goes
    through a 16-bit integer view, so no ``ml_dtypes`` import is needed."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (``jax.tree.map(np.asarray, params)``) as the
    port's tree of tensors on ``device``, key for key; the stacked
    ``[G, ...]`` block layout is kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(np.asarray(tree), dev)


def opt_from_numpy(opt, device="cuda"):
    """``repro``'s optimizer state as numpy arrays (``jax.tree.map(
    np.asarray, opt)``: anything with ``step``, ``mu`` and ``nu``) as the
    port's ``train.OptState`` on ``device``."""
    from ..train.optim import OptState
    dev = resolve_device(device)
    return OptState(_tensor(np.asarray(opt.step), dev),
                    params_from_numpy(opt.mu, dev),
                    params_from_numpy(opt.nu, dev))


def cache_from_numpy(tree, device="cuda"):
    """A decode cache of numpy arrays (``repro``'s ``lm_prefill`` cache
    through ``jax.tree.map(np.asarray, ...)``) as the port's cache."""
    return params_from_numpy(tree, device)


def num_params(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for s in _leaves(specs)))


def num_bytes(specs) -> int:
    return int(sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
                   for s in _leaves(specs)))
