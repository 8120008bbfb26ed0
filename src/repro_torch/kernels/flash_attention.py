"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

K5 ``flash_attention`` replaces
``repro/kernels/flash_attention.py::flash_attention``: blockwise
online-softmax attention, causal (the queries are the last T of the S
positions), sliding window and GQA (query head h reads kv head
h // (H/KV)), float32 running max, denominator and accumulator, fully
masked key tiles skipped. The TPU kernel's ``[B, H, T, D]`` signature is
kept; the kernel reads strided tensors (only the D stride must be 1), so
the model hands it permuted views of its ``[B, T, H, D]`` activations and
of its ``[B, S, KV, D]`` cache without copies, and the output is laid out
``[B, T, H, D]`` in memory (a permuted view), so that the model's
``[B, T, H·D]`` reshape is free. Prefill (T > 4) runs the tiled form,
decode (T <= 4) the split form that spreads the keys over a block's warps.

This launches the CUDA kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to
``kernels/ref.py::flash_attention_ref``. The kernel is held to that plain
version at 2e-5 in float32 and 2e-2 in bfloat16.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_LL = ctypes.c_longlong


class _Args(ctypes.Structure):
    """The kernel's ``FlashArgs`` (``csrc/flash_attention.cu``)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(f"{t}_s{d}", _LL) for t in "qkvo" for d in "bhs"]
                + [(n, ctypes.c_int) for n in ("B", "H", "KV", "T", "S", "D",
                                               "causal", "window")]
                + [("scale", ctypes.c_float)])


_SIGNATURES = {"flash_attention_f32": [ctypes.c_void_p, ctypes.c_void_p],
               "flash_attention_bf16": [ctypes.c_void_p, ctypes.c_void_p]}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16,) + tuple(range(32, 257, 32))   # built in the .cu


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B,H,T,D]; k, v: [B,KV,S,D] (H % KV == 0; D 16 or a multiple of
    32 up to 256), one dtype (float32 or bfloat16), on the card, any strides
    with a unit D stride. Returns [B,H,T,D] in q's dtype."""
    what = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    B, H, T, D = q.shape
    _, KV, S, _ = k.shape
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{q.device}")
        if tuple(x.shape) != (B, KV, S, D):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"not {(B, KV, S, D)}")
        if x.dtype != q.dtype:
            raise TypeError(f"{what}: {name} has dtype {x.dtype}, not "
                            f"{q.dtype}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"{what}: dtype {q.dtype}, not float32 or bfloat16")
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads over {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} is not built (16 or a "
                         f"multiple of 32 up to 256)")
    out = torch.empty((B, T, H, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{what}: {name} is strided along D")
    args = _Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], B, H, KV, T, S, D, int(bool(causal)),
                 int(window), 1.0 / math.sqrt(D))
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(ctypes.byref(args), stream)
    _build.check(err, what)
    _build.LAUNCHES["flash_attention"] += 1
    return out
