"""Wrapper of the RMSNorm kernel (``csrc/rmsnorm.cu``).

K6 ``rmsnorm`` replaces ``repro/kernels/rmsnorm.py::rmsnorm``:
``x·rsqrt(mean(x²)+eps)·scale`` over the last dim with float32
statistics, out in x's dtype. A group of G lanes holds one row in
registers as 16-byte vectors (``plan``): a block per row for wide rows, a
few lanes of a warp per row for narrow ones; on a grid of at most one
block per SM the scale is loaded with x. Bound by the bytes it moves
(each element read once and written once).

``rmsnorm_bwd`` is its backward (``jax.grad`` through
``repro/models/layers.py::norm_apply`` in ``repro``; ``csrc/rmsnorm.cu``,
one launch: the gradient of x row by row over contiguous row chunks, a
block each, with the next row's loads in flight during this row's sums;
the scale's as float32 partials of the chunks, added in chunk order by
the last blocks to finish, no float atomics).

This launches the CUDA kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``kernels/ref.py::rmsnorm_ref``
(``rmsnorm_bwd_ref``). The kernel is held to that plain version at rtol
1e-5 in float32 and to one bfloat16 ulp in bfloat16, and bit for bit to
its own sum order spelled in torch
(``tests/test_torch_support.py::rmsnorm_in_k6_order``); the backward at
2e-5 in float32 and 2e-2 in bfloat16, relative to the largest gradient,
and bit for bit to its order spelled in torch
(``tests/test_torch_support.py::rmsnorm_bwd_in_k6_order``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_BWD = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _I, _P]
_SIGNATURES = {"rmsnorm_f32": [_P, _P, _P, _L, _I, _I, _I, _F, _I, _I, _P],
               "rmsnorm_bf16": [_P, _P, _P, _L, _I, _I, _I, _F, _I, _I, _P],
               "rmsnorm_bwd_f32": _BWD, "rmsnorm_bwd_bf16": _BWD}
_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_BWD_ENTRY = {torch.float32: "rmsnorm_bwd_f32",
              torch.bfloat16: "rmsnorm_bwd_bf16"}
# the backward's widest plan (csrc/rmsnorm.cu instantiates vpt 1, 2, 4, 8)
BWD_MAX_VPT = 8
# the backward's row chunks: about this many blocks per SM
BWD_BLOCKS_PER_SM = 2
# the runs of blocks' partials a dscale column is added in (csrc/rmsnorm.cu
# kSegs)
BWD_SEGMENTS = 8

# rows at least this wide take a whole block; narrower rows share a warp
WIDE = 1024
# vectors a lane of a wide row holds, about, and at most
WIDE_VPT, MAX_VPT = 4, 16
# threads of a block of narrow rows (csrc/rmsnorm.cu kNarrowThreads)
NARROW_THREADS = 256


def plan(D: int, itemsize: int):
    """(G, vpt, E) for rows of D elements of ``itemsize`` bytes: G lanes
    per row, each holding vpt 16-byte vectors of E elements (vector v of
    the row sits on lane v % G, slot v // G). Wide rows: a block of whole
    warps with about ``WIDE_VPT`` vectors a lane, at most 512 threads;
    narrow rows: the next power of two at or above the row's vectors, at
    most 32."""
    E = 16 // itemsize
    nv = max(-(-D // E), 1)
    if D >= WIDE:
        G = min(512, 32 * -(-nv // (32 * WIDE_VPT)))
    else:
        G = min(32, 1 << (nv - 1).bit_length())
    vpt = -(-nv // G)
    if vpt > MAX_VPT:
        raise ValueError(f"rmsnorm: rows of {D} elements are wider than K6 "
                         f"holds ({512 * MAX_VPT * E})")
    return G, vpt, E


def rmsnorm(x, scale, *, eps=1e-6):
    """x: [..., D] float32 or bfloat16 on the card (rows flattened to
    [N, D]); scale: [D], float32 or bfloat16 (widened exactly). Returns
    x's shape and dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm: x has dtype {x.dtype}, not float32 or "
                        f"bfloat16")
    D = x.shape[-1]
    if scale.device != x.device or tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: scale must be [{D}] on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    x2 = x.contiguous()
    s = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x2)
    N = x2.numel() // D if D else 0
    if N == 0:
        return y
    G, vpt, E = plan(D, x2.element_size())
    vec = int(D % E == 0 and all(t.data_ptr() % 16 == 0 for t in (x2, s, y)))
    # at most a block per SM: load the scale with x (see the source)
    blocks = N if G > 32 else -(-N // (NARROW_THREADS // G))
    pre = int(blocks <= _build.sm_count(x.device))
    lib = _build.library("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(x2.data_ptr(), s.data_ptr(),
                                            y.data_ptr(), N, D, G, vpt, eps,
                                            vec, pre, stream)
    _build.check(err, "rmsnorm")
    _build.LAUNCHES["rmsnorm"] += 1
    return y


def bwd_rows_per_block(N: int, G: int, sms: int) -> int:
    """The backward's chunk of rows a block: about ``BWD_BLOCKS_PER_SM``
    blocks an SM, and at least a row for each of a narrow block's
    groups."""
    groups = 1 if G > 32 else NARROW_THREADS // G
    return max(-(-N // (BWD_BLOCKS_PER_SM * sms)), groups, 1)


def rmsnorm_bwd(x, scale, dy, *, eps=1e-6):
    """The gradients (dx in x's dtype and shape, dscale in scale's dtype)
    of ``rmsnorm(x, scale, eps=eps)`` given the output's gradient ``dy``
    (x's shape and dtype), on the card."""
    what = "rmsnorm_bwd"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _BWD_ENTRY:
        raise TypeError(f"{what}: x has dtype {x.dtype}, not float32 or "
                        f"bfloat16")
    D = x.shape[-1]
    if scale.device != x.device or tuple(scale.shape) != (D,):
        raise ValueError(f"{what}: scale must be [{D}] on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if dy.device != x.device or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{what}: dy must match x ({tuple(x.shape)}, "
                         f"{x.dtype}), got {tuple(dy.shape)}, {dy.dtype} on "
                         f"{dy.device}")
    x2, g2 = x.contiguous(), dy.contiguous()
    s = scale.to(torch.float32).contiguous()
    dx = torch.empty_like(x2)
    N = x2.numel() // D if D else 0
    if N == 0:
        return dx, torch.zeros_like(scale)
    G, vpt, E = plan(D, x2.element_size())
    if vpt > BWD_MAX_VPT:
        raise ValueError(f"{what}: rows of {D} elements are wider than the "
                         f"backward holds ({512 * BWD_MAX_VPT * E})")
    R = bwd_rows_per_block(N, G, _build.sm_count(x.device))
    part = torch.empty((-(-N // R), D), dtype=torch.float32,
                       device=x.device)
    dscale = torch.empty(D, dtype=torch.float32, device=x.device)
    count = _build.counters("rmsnorm_bwd", 2, x.device)
    vec = int(D % E == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (x2, s, g2, dx)))
    lib = _build.library("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _BWD_ENTRY[x.dtype])(
            x2.data_ptr(), s.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dscale.data_ptr(), count.data_ptr(), N, D, G,
            vpt, R, eps, vec, stream)
    _build.check(err, what)
    _build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx.reshape(x.shape), dscale.to(scale.dtype)
