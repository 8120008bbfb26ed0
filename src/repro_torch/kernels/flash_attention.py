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
``[B, T, H·D]`` reshape is free.

It is bound by bytes at the serve shapes. bfloat16 runs on the tensor
cores (``mma.sync``, float32 accumulate, P split into two bf16 halves so
it keeps its float32 precision, K/V staged by ``cp.async``): prefill
(T > 4) in 64-query-row tiles, FlashAttention-2 style; decode (T <= 4)
split over the keys with one block per (b, kv head, 64 keys) serving the
whole GQA group, so each cached key is read once per group, and the last
block of each (b, kv head) merging the splits in order (a scratch buffer
and a cached counter, one launch per call). ``cp.async`` copies 16 bytes,
so bfloat16 q, k and v must start 16-byte aligned with strides that are
multiples of 8 elements; the wrapper raises where they do not. float32
keeps the scalar CUDA-core forms (tensor cores would mean TF32).

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
                + [("scale", ctypes.c_float),
                   ("part", ctypes.c_void_p), ("count", ctypes.c_void_p)])


_SIGNATURES = {"flash_attention_f32": [ctypes.c_void_p, ctypes.c_void_p],
               "flash_attention_bf16": [ctypes.c_void_p, ctypes.c_void_p],
               "flash_attention_split_max_t": [],
               "flash_attention_split_keys": []}
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
        if q.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])):
            raise ValueError(f"{what}: bfloat16 {name} must start 16-byte "
                             f"aligned with strides that are multiples of 8"
                             f" elements (strides {tuple(x.stride())})")
    lib = _build.library("flash_attention", _SIGNATURES)
    part = count = None
    if q.dtype == torch.bfloat16 and T <= lib.flash_attention_split_max_t():
        splits = max(1, -(-S // lib.flash_attention_split_keys()))
        part = torch.empty(B * KV * splits * H // KV * T * (D + 2),
                           dtype=torch.float32, device=q.device)
        count = _build.counters("flash_attention", B * KV, q.device)
    args = _Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], B, H, KV, T, S, D, int(bool(causal)),
                 int(window), 1.0 / math.sqrt(D),
                 None if part is None else part.data_ptr(),
                 None if count is None else count.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(ctypes.byref(args), stream)
    _build.check(err, what)
    _build.LAUNCHES["flash_attention"] += 1
    return out
