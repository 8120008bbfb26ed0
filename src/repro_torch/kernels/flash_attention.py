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

For training, ``return_lse=True`` also returns each query row's float32
log-sum-exp (the tiled forms serve every T then), and
``flash_attention_bwd`` is the backward (``jax.grad`` through
``repro/models/layers.py::_sdpa`` in ``repro``): two kernels, dq (one
block per (b, head, 64 query rows), which also writes delta =
rowsum(do * o)) then dk/dv (one block per (b, kv head, 64 keys, chunk of
``bwd_heads_per_chunk`` of the group's query heads), in float32 scalar
forms, and in bfloat16 on Hopper's ``wgmma`` with the operands brought in
by TMA (a warpgroup a block owns 64 rows of every product; P and dS
rounded once to bf16; dq recomputes S and dP). The chunks spread a GQA
group over the SMs: each writes float32 partials of dk and dv to a
scratch buffer (``torch.empty``) and the last block of the key tile to
finish, elected by a cached counter, adds them in chunk order. No float
atomics, so the gradients are the same bits run to run. The forward's
masks (causal, with or without a sliding window, or none): the dq kernel
walks only the key tiles its rows see and the dk/dv kernel only the
query tiles that see its keys; head dims 16, 32, 64, 80, 96, 128 and 256
(at 256 each key tile's dk and dv are split by columns over two blocks,
which keeps a thread's accumulators in registers). TMA reads q, k, v and
do in place under the same alignment as ``cp.async``.

This launches the CUDA kernel and takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to
``kernels/ref.py::flash_attention_ref`` (``flash_attention_bwd_ref``). The
kernel is held to that plain version at 2e-5 in float32 and 2e-2 in
bfloat16; the backward at the same bars relative to the largest
gradient.
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
                   ("part", ctypes.c_void_p), ("count", ctypes.c_void_p),
                   ("lse", ctypes.c_void_p)])


class _BwdArgs(ctypes.Structure):
    """The backward's ``FlashBwdArgs`` (``csrc/flash_attention.cu``)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "dout",
                                                "lse", "delta", "dq", "dk",
                                                "dv")]
                + [(f"{t}_s{d}", _LL)
                   for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv")
                   for d in "bhs"]
                + [(n, ctypes.c_int) for n in ("B", "H", "KV", "T", "S", "D",
                                               "causal", "window")]
                + [("scale", ctypes.c_float), ("hpc", ctypes.c_int),
                   ("part", ctypes.c_void_p), ("count", ctypes.c_void_p)])


_P2 = [ctypes.c_void_p, ctypes.c_void_p]
_SIGNATURES = {"flash_attention_f32": _P2, "flash_attention_bf16": _P2,
               "flash_attention_bwd_f32": _P2, "flash_attention_bwd_bf16": _P2,
               "flash_attention_split_max_t": [],
               "flash_attention_split_keys": []}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
HEAD_DIMS = tuple(sorted((16, 80) + tuple(range(32, 257, 32))))  # the .cu's
BWD_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)  # the backward's
# the bf16 dk/dv kernel: keys a block, and blocks an SM it aims for
BWD_KEYS, BWD_WAVES = 64, 2


def _check(what, q, others, kv_shape):
    """Raise unless ``others`` ({name: tensor}) match q's device and dtype,
    k/v-like ones ``kv_shape`` and the rest q's shape."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    for name, x in others.items():
        want = kv_shape if name in ("k", "v") else tuple(q.shape)
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{q.device}")
        if tuple(x.shape) != want:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"not {want}")
        if x.dtype != q.dtype:
            raise TypeError(f"{what}: {name} has dtype {x.dtype}, not "
                            f"{q.dtype}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"{what}: dtype {q.dtype}, not float32 or bfloat16")


def _copyable(x) -> bool:
    """bfloat16 is staged by ``cp.async``'s 16-byte copies: a 16-byte
    aligned start and strides that are multiples of 8 elements."""
    return x.dtype != torch.bfloat16 or not (
        x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]))


def _check_strides(what, tensors):
    """A unit D stride, and ``_copyable``."""
    for name, x in tensors.items():
        if x.stride(3) != 1:
            raise ValueError(f"{what}: {name} is strided along D")
        if not _copyable(x):
            raise ValueError(f"{what}: bfloat16 {name} must start 16-byte "
                             f"aligned with strides that are multiples of 8"
                             f" elements (strides {tuple(x.stride())})")


def _heads_inner(shape, dtype, device):
    """An empty [B, X, T, D] view of a [B, T, X, D] tensor."""
    B, X, T, D = shape
    return torch.empty((B, T, X, D), dtype=dtype,
                       device=device).permute(0, 2, 1, 3)


def flash_attention(q, k, v, *, causal=True, window=0, return_lse=False):
    """q: [B,H,T,D]; k, v: [B,KV,S,D] (H % KV == 0; D 16, 80 or a multiple
    of 32 up to 256), one dtype (float32 or bfloat16), on the card, any strides
    with a unit D stride. Returns [B,H,T,D] in q's dtype, and with
    ``return_lse`` also the float32 log-sum-exp of each query row [B,H,T]
    (what ``flash_attention_bwd`` takes)."""
    what = "flash_attention"
    B, H, T, D = q.shape
    _, KV, S, _ = k.shape
    _check(what, q, {"k": k, "v": v}, (B, KV, S, D))
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads over {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} is not built "
                         f"{HEAD_DIMS}")
    out = _heads_inner((B, H, T, D), q.dtype, q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    _check_strides(what, {"q": q, "k": k, "v": v})
    lib = _build.library("flash_attention", _SIGNATURES)
    part = count = None
    if (q.dtype == torch.bfloat16 and lse is None
            and T <= lib.flash_attention_split_max_t()):
        splits = max(1, -(-S // lib.flash_attention_split_keys()))
        part = torch.empty(B * KV * splits * H // KV * T * (D + 2),
                           dtype=torch.float32, device=q.device)
        count = _build.counters("flash_attention", B * KV, q.device)
    args = _Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], B, H, KV, T, S, D, int(bool(causal)),
                 int(window), 1.0 / math.sqrt(D),
                 None if part is None else part.data_ptr(),
                 None if count is None else count.data_ptr(),
                 None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(ctypes.byref(args), stream)
    _build.check(err, what)
    _build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _aligned(x):
    """``x`` as the backward reads it: itself where its strides serve,
    else a copy in the [B, T, X, D] layout (autograd may hand the output's
    gradient over in any layout)."""
    if x.stride(3) == 1 and _copyable(x):
        return x
    return x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)


def bwd_units(B, KV, S, D):
    """The bf16 dk/dv kernel's (b, kv head, column split, key tile)
    units: its blocks a chunk of query heads."""
    return B * KV * -(-S // BWD_KEYS) * max(1, D // 128)


def bwd_heads_per_chunk(B, H, KV, S, D, sms):
    """The query heads of a chunk of the bf16 dk/dv kernel: the group's G
    heads cut into as few equal chunks as give about ``BWD_WAVES`` blocks
    an SM (each chunk adds float32 partials to be summed), all G where the
    units alone do."""
    G = H // KV
    chunks = min(G, max(1, -(-BWD_WAVES * sms // bwd_units(B, KV, S, D))))
    return -(-G // chunks)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """The gradients (dq [B,H,T,D], dk and dv [B,KV,S,D], each laid out
    [B, T or S, heads, D] in memory) of ``flash_attention(q, k, v)`` given
    its output ``o``, its log-sum-exp ``lse`` (``return_lse=True``) and the
    output's gradient ``do``, on the card; ``causal`` and ``window`` as
    the forward took them."""
    what = "flash_attention_bwd"
    B, H, T, D = q.shape
    _, KV, S, _ = k.shape
    _check(what, q, {"k": k, "v": v, "o": o, "do": do}, (B, KV, S, D))
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads over {KV} kv heads")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} is not built for the "
                         f"backward {BWD_HEAD_DIMS}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, T)):
        raise ValueError(f"{what}: lse must be float32 [{B}, {H}, {T}] on "
                         f"{q.device}")
    do = _aligned(do)
    _check_strides(what, {"q": q, "k": k, "v": v, "o": o, "do": do})
    lse = lse.contiguous()
    dq = _heads_inner((B, H, T, D), q.dtype, q.device)
    dk = _heads_inner((B, KV, S, D), q.dtype, q.device)
    dv = _heads_inner((B, KV, S, D), q.dtype, q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _SIGNATURES)
    hpc, part, count = H // KV, None, None
    if q.dtype == torch.bfloat16:
        hpc = bwd_heads_per_chunk(B, H, KV, S, D, _build.sm_count(q.device))
        chunks = -(-(H // KV) // hpc)
        if chunks > 1:
            units = bwd_units(B, KV, S, D)
            part = torch.empty(chunks * units * 2 * BWD_KEYS * min(D, 128),
                               dtype=torch.float32, device=q.device)
            count = _build.counters("flash_attention_bwd", units, q.device)
    args = _BwdArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    *(st for x in (q, k, v, o, do, dq, dk, dv)
                      for st in x.stride()[:3]),
                    B, H, KV, T, S, D, int(bool(causal)), int(window),
                    1.0 / math.sqrt(D), hpc,
                    None if part is None else part.data_ptr(),
                    None if count is None else count.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _BWD_ENTRY[q.dtype])(ctypes.byref(args), stream)
    _build.check(err, what)
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
