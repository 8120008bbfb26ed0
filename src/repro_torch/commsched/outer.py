"""Cross-pod parameter synchronization: chunked, compressed, window-bounded.

The DiLoCo outer sync (twin of ``repro.commsched.outer``): H local steps
per pod, then each pod computes ``delta = anchor - theta_pod``; every leaf
is int8-quantized with pod-local error feedback, all-gathered over the
pods (the wire format stays int8, 4x fewer cross-pod bytes than float32),
de-quantized, averaged and applied through Nesterov momentum.

PyTorch's idiom is one process per pod: each rank of a ``ShardGroup``
(``core/shardcomm.py``) is one pod and holds its own ``local_params`` and
error feedback; ``anchor`` and the momentum are replicated. Each leaf's
gather is issued with ``async_op=True`` and leaf ``i`` waits on leaf ``i -
window``'s gather before it is issued: at most ``window`` gathers are in
flight, the counterpart of ``repro``'s ``optimization_barrier`` chaining.
The bound is what the host control loop adapts between steps
(``commsched.controller``, validated in ``commsched.simbackend``).

Arithmetic, as ``repro``'s jitted sync rounds it on the CPU: the scale is
``max|y|`` times the float32 reciprocal of 127 (XLA's rewrite of a
division by a constant), the error feedback ``y - q * scale`` and the two
Nesterov updates are fused multiply-adds (one rounding each, ``_fma``);
the pods' de-quantized blocks are summed in rank order and multiplied by
the float32 reciprocal of the pod count. The eager ``quantize_int8`` is
``repro``'s eager form: a true division and separate roundings.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.shardcomm import ShardGroup


# -------------------------------------------------------------------------
# Trees: nested dicts / lists / tuples of tensors, flattened in JAX's order
# -------------------------------------------------------------------------


def tree_flatten_with_path(tree, path: Tuple = ()) -> List[Tuple]:
    """(key path, leaf) of every tensor of ``tree`` in
    ``jax.tree_util.tree_flatten_with_path``'s order: a dict's keys
    sorted, a list's or tuple's items (a NamedTuple's fields) in order,
    None an empty subtree. A path is a tuple of dict keys and indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (an iterator) in
    ``tree_flatten_with_path``'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    return next(leaves)


# -------------------------------------------------------------------------
# Bucketizer: group leaves into ~equal-byte buckets
# -------------------------------------------------------------------------


def bucketize(tree, target_bytes: float = 64e6) -> List[List[Tuple]]:
    """Greedy first-fit over leaves in deterministic key order (JAX's
    flatten order), so every pod builds identical buckets. Returns lists
    of (key path, leaf)."""
    buckets, cur, cur_bytes = [], [], 0.0
    for path, leaf in tree_flatten_with_path(tree):
        b = leaf.numel() * leaf.element_size()
        if cur and cur_bytes + b > target_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append((path, leaf))
        cur_bytes += b
    if cur:
        buckets.append(cur)
    return buckets


def window_to_buckets(window_bytes: float, bucket_bytes: float,
                      nbuckets: int) -> int:
    """Bridge: controller window (bytes) -> in-flight bucket bound."""
    return int(max(1, min(round(window_bytes / max(bucket_bytes, 1.0)),
                          nbuckets)))


# -------------------------------------------------------------------------
# int8 + error feedback
# -------------------------------------------------------------------------


def quantize_int8(x, ef):
    """Per-tensor symmetric int8 with error feedback, as ``repro``'s eager
    ``quantize_int8`` rounds it. Returns (q int8, scale, new_ef)."""
    y = x.to(torch.float32) + ef
    scale = torch.clamp(torch.max(torch.abs(y)), min=np.float32(1e-12)) \
        / torch.tensor(127.0, dtype=torch.float32, device=y.device)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale, y - q.to(torch.float32) * scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _fma(a, b, c):
    """``a * b + c`` in float32 with one rounding (a fused multiply-add).
    The product of two float32 values is exact in float64; the sum is
    rounded to odd in float64 (a nudge of one float64 ulp toward the
    exact sum where it was inexact and landed on an even significand) and
    then to nearest in float32, which is the correctly rounded result
    (53 >= 2 * 24 + 2 bits)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32).to(torch.float64)
               for v in (a, b, c))
    s = a * b
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)
    even = (t.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(t)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(t.dtype)
    t = torch.where(fix, torch.nextafter(t, toward), t)
    return t.to(torch.float32)


def _quantize_fused(y):
    """The jitted sync's quantization of one pod's block: (q int8, scale
    [1] float32, new_ef)."""
    recip = np.float32(1.0) / np.float32(127.0)
    mx = torch.clamp(torch.max(torch.abs(y)), min=np.float32(1e-12))
    scale = (mx * torch.tensor(recip, device=y.device)).reshape(1)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale, _fma(-q.to(torch.float32), scale, y)


def pod_mean(xs):
    """The average over pods of ``xs`` [P, ...] float32 in rank order:
    summed in rank order and multiplied by the float32 reciprocal of P
    (XLA's rewrite of the mean's division by a constant)."""
    P = int(xs.shape[0])
    total = xs[0]
    for p in range(1, P):
        total = total + xs[p]
    if P == 1:
        return total
    return total * torch.tensor(np.float32(1.0) / np.float32(P),
                                device=total.device)


def nesterov(anchor, mom, mean, outer_lr: float, momentum: float):
    """The outer step on the averaged delta: (new anchor in the anchor's
    dtype, new momentum), each update one fused multiply-add."""
    new_mom = _fma(np.float32(momentum), mom, mean)
    step = _fma(np.float32(momentum), new_mom, mean)
    new_anchor = _fma(-np.float32(outer_lr), step, anchor)
    return new_anchor.to(anchor.dtype), new_mom


# -------------------------------------------------------------------------
# Outer sync (DiLoCo + int8/EF + windowed chunking)
# -------------------------------------------------------------------------


def make_outer_sync(group: ShardGroup, compress: str = "int8_ef",
                    window: int = 2, outer_lr: float = 0.7,
                    momentum: float = 0.9):
    """Builds ``outer_sync(anchor, local_params, ef, mom) -> (new_anchor,
    new_ef, new_mom)`` over the pods of ``group`` (one rank per pod; gloo
    on the CPU or staged through the host, NCCL on the card).

    ``anchor`` and ``mom`` are replicated; ``local_params`` and ``ef`` are
    this pod's (each leaf shaped as the anchor's). Every leaf stays whole
    on every rank. With ``compress="int8_ef"`` each pod's int8 block and
    its scale travel as one int8 message (the scale's 4 bytes at its
    end); otherwise the float32 delta travels and ``ef`` comes back as
    it is. One asynchronous all-gather a leaf, at most ``window`` in
    flight (``window`` 0: no bound). ``outer_sync.stats`` holds the last
    sync's gathers, the most in flight at once and the bytes gathered on
    this rank."""
    world = int(group.world)

    def blocks(rows, n, shape):
        """The pods' de-quantized blocks from their int8 messages."""
        scales = rows[:, n:].flatten().clone().view(torch.float32)
        deq = rows[:, :n].to(torch.float32) * scales[:, None]
        return deq.reshape((world,) + tuple(shape))

    def outer_sync(anchor, local_params, ef, mom):
        a_leaves = [v for _, v in tree_flatten_with_path(anchor)]
        l_leaves = [v for _, v in tree_flatten_with_path(local_params)]
        e_leaves = [v for _, v in tree_flatten_with_path(ef)]
        m_leaves = [v for _, v in tree_flatten_with_path(mom)]
        stats = dict(gathers=0, max_in_flight=0, bytes=0)
        pending, means, new_efs = {}, [None] * len(a_leaves), []
        with torch.no_grad():
            for i, (a, lp, e) in enumerate(zip(a_leaves, l_leaves,
                                               e_leaves)):
                if window > 0 and i >= window:
                    # the bound: leaf i - window's gather completes before
                    # leaf i's is issued
                    means[i - window] = pending.pop(i - window)()
                d = a.to(torch.float32) - lp.to(torch.float32)
                if compress == "int8_ef":
                    q, scale, ne = _quantize_fused(d + e)
                    msg = torch.cat([q.reshape(-1), scale.view(torch.int8)])
                    rows = group.all_gather(msg, async_op=True)
                    pending[i] = (lambda rows=rows, n=q.numel(), s=d.shape:
                                  pod_mean(blocks(rows(), n, s)))
                else:
                    ne, msg = e, d.reshape(-1)
                    rows = group.all_gather(msg, async_op=True)
                    pending[i] = (lambda rows=rows, s=d.shape:
                                  pod_mean(rows().reshape((world,) + s)))
                stats["gathers"] += 1
                stats["bytes"] += world * msg.numel() * msg.element_size()
                stats["max_in_flight"] = max(stats["max_in_flight"],
                                             len(pending))
                new_efs.append(ne)
            for i in sorted(pending):
                means[i] = pending.pop(i)()
            outs = [nesterov(a, m.to(torch.float32), g, outer_lr, momentum)
                    for a, m, g in zip(a_leaves, m_leaves, means)]
        outer_sync.stats = stats
        return (_unflatten(anchor, iter([o[0] for o in outs])),
                _unflatten(anchor, iter(new_efs)),
                _unflatten(anchor, iter([o[1] for o in outs])))

    outer_sync.stats = dict(gathers=0, max_in_flight=0, bytes=0)
    return outer_sync
