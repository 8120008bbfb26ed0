"""Wrapper of the RMSNorm kernel (``csrc/rmsnorm.cu``).

K6 ``rmsnorm`` replaces ``repro/kernels/rmsnorm.py::rmsnorm``:
``x·rsqrt(mean(x²)+eps)·scale`` over the last dim with float32
statistics, out in x's dtype. One warp per row; bound by the bytes it
moves (each element read once and written once).

This launches the CUDA kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to ``kernels/ref.py::rmsnorm_ref``.
The kernel is held to that plain version at rtol 1e-5 in float32 and to
one bfloat16 ulp in bfloat16.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {"rmsnorm_f32": [_P, _P, _P, _L, _I, _F, _P],
               "rmsnorm_bf16": [_P, _P, _P, _L, _I, _F, _P]}
_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


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
    lib = _build.library("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(x2.data_ptr(), s.data_ptr(),
                                            y.data_ptr(), N, D, eps, stream)
    _build.check(err, "rmsnorm")
    _build.LAUNCHES["rmsnorm"] += 1
    return y
