"""AdamW with dtype-configurable moments, warmup+cosine LR, global-norm
clip (twin of ``repro.train.optim``).

``adamw_update`` updates the parameters and the moments leaf by leaf, in
place, a chunk of ``CHUNK`` elements at a time: a functional update of
the whole tree would hold a second copy of the parameters and moments
(34.5 GB at qwen3-14b's full width cut to 4 layers), which does not fit
on one card beside them; a chunk's temporaries are all it adds.

Its arithmetic is ``repro``'s update as XLA:CPU compiles it inside the
jitted step, which is the same bits where the clip is off (the test holds
it so): XLA contracts ``b1 m + (1 - b1) g`` and ``b2 v + (1 - b2) g²``
into fused multiply-adds, rewrites ``(m / c1) / (sqrt(v / c2) + eps)`` as
``m / (c1 (sqrt(v / c2) + eps))`` and the parameter step into two fused
multiply-adds; a fused multiply-add is spelled here as its product and
sum in float64 (exact for the product of two float32 values) rounded
once to float32. XLA folds its Python-scalar constants the same way:
``lr * (step + 1) / warmup`` is ``(step + 1) * float32(lr / warmup)``.
``b ** step`` is taken in float64 and rounded to float32, which equals
XLA:CPU's float32 ``pow`` at every step probed (``torch.pow`` in float32
is one ulp off at some). The schedule's cosine is XLA:CPU's, which calls
the C library's ``cosf``: ``_cosf`` spells glibc's algorithm (a
reduction by pi/2 and a polynomial, in float64, rounded once), bit for
bit XLA's where ``torch.cos`` in float32 or float64 is one ulp off at 5%
or 1.3% of the inputs. One gap remains (ROADMAP.md, Queue 3):
``global_norm`` adds each leaf's squares in PyTorch's order, not XLA's,
so with the clip on its scale (and every update after it) can differ in
the last bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.spec import ParamSpec, _leaves, torch_dtype, tree_map_specs


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: dict                    # first moment (tree like params)
    nu: dict                    # second moment


def opt_specs(param_specs, cfg):
    """ParamSpec tree for the optimizer state."""
    dt = cfg.moments_dtype

    def mom(s: ParamSpec):
        return ParamSpec(s.shape, dt, s.axes, "zeros")

    return OptState(
        step=ParamSpec((), "int32", (), "zeros"),
        mu=tree_map_specs(mom, param_specs),
        nu=tree_map_specs(mom, param_specs),
    )


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def init_opt(params, cfg) -> OptState:
    dt = torch_dtype(cfg.moments_dtype)
    dev = _leaves(params)[0].device

    def z(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    _tree_map(z, params), _tree_map(z, params))


def _f32(x: float) -> float:
    """A Python float rounded to float32, as XLA holds the constant."""
    return float(np.float32(x))


# glibc's float32 sin/cos constants (sysdeps/ieee754/flt-32/s_sincosf.h,
# __sincosf_table[0]): 2^24 / (pi / 2), pi / 2, the cosine's c0..c4 and
# the sine's s1..s3
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_COS_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
          float.fromhex("0x1.55553e1068f19p-5"),
          float.fromhex("-0x1.6c087e89a359dp-10"),
          float.fromhex("0x1.99343027bf8c3p-16"))
_SIN_S = (float.fromhex("-0x1.555545995a603p-3"),
          float.fromhex("0x1.1107605230bc4p-7"),
          float.fromhex("-0x1.994eb3774cf24p-13"))


def _cosf(y):
    """cos of a float32 tensor, |y| < 120, as glibc's ``cosf`` computes it
    (XLA:CPU's float32 cosine), every step in float64 and rounded to
    float32 once: below 0.75 (glibc compares the top 12 bits against
    pi/4's) the cosine polynomial of y; else xr = y - n pi/2 (n from the
    fast rounding of y / (pi/2)) and, by n mod 4, cos(xr), -sin(xr),
    -cos(xr) or sin(xr)."""
    x = y.double()
    a = y.abs()
    n = ((x * _HPI_INV).trunc().long() + 0x800000) >> 24
    xr = x - n.double() * _HPI

    def cos_poly(u2):
        u4 = u2 * u2
        hi = _COS_C[3] + u2 * _COS_C[4]
        lo = _COS_C[0] + u2 * _COS_C[1]
        return (lo + u4 * _COS_C[2]) + (u4 * u2) * hi

    def sin_poly(u, u2):
        u3 = u * u2
        s1 = _SIN_S[1] + u2 * _SIN_S[2]
        return (u + u3 * _SIN_S[0]) + (u3 * u2) * s1

    q = n & 3
    neg = torch.where((q == 1) | (q == 2), -1.0, 1.0).double()
    far = torch.where((n & 1) == 1, sin_poly(xr * neg, xr * xr),
                      cos_poly(xr * xr) * neg)
    out = torch.where(a < 0.75, cos_poly(x * x), far)
    return torch.where(a < 2.0 ** -12, 1.0, out).float()


def lr_schedule(step, cfg):
    """Warmup then cosine decay, float32, at the int32 tensor ``step``."""
    step = step.to(torch.float32)
    warm = (step + 1.0) * _f32(_f32(cfg.lr)
                               * _f32(1.0 / max(cfg.warmup_steps, 1)))
    prog = torch.clamp((step - float(cfg.warmup_steps)) * _f32(
        1.0 / max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = _f32(0.5 * cfg.lr) * (1.0 + _cosf(prog * _f32(math.pi)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf (float32), the leaves added
    in ``jax.tree.leaves`` order (sorted dict keys)."""
    total = None
    for x in _leaves(tree):
        xf = x.to(torch.float32)
        s = torch.sum(xf * xf)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _bias_correction(b: float, step):
    """1 - b ** step, the power in float64 rounded to float32."""
    pw = torch.pow(torch.tensor(_f32(b), dtype=torch.float64,
                                device=step.device), step.to(torch.float64))
    return 1.0 - pw.to(torch.float32)


# elements a chunk of a leaf updates at once
CHUNK = 1 << 26


def _fma(a, b, c):
    """a * b + c rounded once to float32 (``a`` a float32 tensor, ``b`` a
    float32 value or tensor, ``c`` a float32 tensor): the product of two
    float32 values is exact in float64."""
    return torch.add(a.double() * (b.double() if torch.is_tensor(b) else b),
                     c.double()).float()


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, cfg):
    """Update ``params`` and ``opt``'s moments in place from ``grads``.
    Returns (params, new OptState, metrics {"lr", "grad_norm"})."""
    step = opt.step + 1
    lr = lr_schedule(opt.step, cfg)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                         max=1.0) if cfg.clip_norm > 0 else None)
    b1, b2 = _f32(cfg.adam_b1), _f32(cfg.adam_b2)
    a1, a2 = _f32(1 - cfg.adam_b1), _f32(1 - cfg.adam_b2)
    wd = _f32(cfg.weight_decay)
    c1 = _bias_correction(cfg.adam_b1, step)
    c2 = _bias_correction(cfg.adam_b2, step)
    neg_lr = -lr
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(opt.mu),
                          _leaves(opt.nu)):
        p1, g1, m1, v1 = (x.view(-1) for x in (p, g, m, v))
        for i in range(0, p1.numel(), CHUNK):
            sl = slice(i, i + CHUNK)
            g32 = g1[sl].to(torch.float32)
            if scale is not None:
                g32 = g32 * scale
            m32 = _fma(m1[sl].to(torch.float32), b1, g32 * a1)
            v32 = _fma(v1[sl].to(torch.float32), b2, (g32 * g32) * a2)
            m1[sl] = m32
            v1[sl] = v32
            d = m32 / (c1 * (torch.sqrt(v32 / c2) + 1e-8))
            p32 = p1[sl].to(torch.float32)
            p1[sl] = _fma(_fma(p32, wd, d), neg_lr, p32)
    return params, OptState(step, opt.mu, opt.nu), {"lr": lr,
                                                    "grad_norm": gnorm}
