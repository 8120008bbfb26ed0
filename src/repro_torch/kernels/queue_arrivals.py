"""Fluid-queue update: the dense K3 kernel and the in-order sparse helpers
(twin of ``repro.kernels.queue_arrivals``).

Dense (``queue_arrivals``, the ``"fused"`` backend): K3 replaces
``repro/kernels/queue_arrivals.py::queue_arrivals``. Per tick it sums the
delayed per-hop rates through the [H, F, Q+1] one-hot incidence and
integrates the queues, ``q' = clip(q + (arr - out) dt, 0, caps)``, in one
launch of ``csrc/queue_arrivals.cu``: a split reduction over row chunks
of the incidence whose last block per column tile adds the chunks'
partials in chunk order and integrates. A batch of scenarios (the
engines carry one, of one scenario or more) is the same launch with one
grid plane per scenario. Its sum runs in that fixed order, which is not
the reference scatter's, so the fused backend is close to (not bitwise
equal with) the reference backend.

Sparse (the ``"reference"`` backend): ``repro`` accumulates queue
arrivals with a scatter-add that XLA runs in ascending flat order. On the
card ``index_add_``/``scatter_add_`` use atomics whose order changes from
run to run, so the port inverts the hop table into a per-queue gather
table (``build_csr_gather``) and adds each queue's contributors in
ascending flat order (``csr_gather_arrivals``) — bit-identical to the
scatter by construction, on the CPU and on the card alike. Both take a
leading batch axis of scenarios, as the engines' carries do.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"queue_arrivals_f32": [_P] * 9 + [_I] * 6 + [_F, _P],
               "queue_arrivals_tiles": [_I], "queue_arrivals_chunks": [_I]}


def queue_arrivals(lam_del, onehot, q, out_rate, caps, *, dt):
    """K3 on CUDA tensors. lam_del: [..., H, F]; onehot: [..., H, F, Q];
    q: [..., Q]; out_rate/caps: [Q] (shared by the batch) or [..., Q]
    (all float32, contiguous). A leading batch axis B of scenarios runs in
    the same launch, each scenario on its own plane of the grid. Returns
    (arrivals [..., Q], q_new [..., Q])."""
    H, F, Q = onehot.shape[-3:]
    lead = tuple(onehot.shape[:-3])
    B = 1
    for n in lead:
        B *= n

    def rate(x):
        return (Q,) if x.dim() == 1 else lead + (Q,)

    _build.check_tensors(
        "queue_arrivals",
        dict(lam_del=lam_del, onehot=onehot, q=q, out_rate=out_rate,
             caps=caps),
        dict(lam_del=lead + (H, F), onehot=lead + (H, F, Q), q=lead + (Q,),
             out_rate=rate(out_rate), caps=rate(caps)), onehot.device)
    arr = torch.empty_like(q)
    q_new = torch.empty_like(q)
    if Q == 0 or B == 0:
        return arr, q_new
    if B > 65535:
        raise ValueError(f"queue_arrivals: a batch of {B} scenarios is more "
                         f"than the grid's 65 535 planes hold")
    lib = _build.library("queue_arrivals", _SIGNATURES)
    chunks = lib.queue_arrivals_chunks(H * F)
    if chunks > 65535:
        raise ValueError(f"queue_arrivals: {H * F} incidence rows are more "
                         f"than the grid's 65 535 row chunks hold")
    part = torch.empty((B, chunks, Q), dtype=torch.float32, device=q.device)
    count = _build.counters("queue_arrivals",
                            B * lib.queue_arrivals_tiles(Q), q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.queue_arrivals_f32(
            lam_del.data_ptr(), onehot.data_ptr(), q.data_ptr(),
            out_rate.data_ptr(), caps.data_ptr(), arr.data_ptr(),
            q_new.data_ptr(), part.data_ptr(), count.data_ptr(), B, H, F,
            Q, 0 if out_rate.dim() == 1 else Q, 0 if caps.dim() == 1 else Q,
            dt, stream)
    _build.check(err, "queue_arrivals")
    _build.LAUNCHES["queue_arrivals"] += 1
    return arr, q_new


def suggest_maxdeg(path, num_queues: int, slots: int, cap: int = 64,
                   default: int = 32) -> int:
    """Static width of the megakernel's gather table from a schedule's hop
    table (host numpy, as ``repro``): the largest number of schedule
    entries on one real queue, at most ``slots`` (no more flows than slots
    are resident at once). Degrees above ``cap`` fall back to ``default``
    and rely on the in-order overflow path."""
    flat = np.asarray(path).reshape(-1)
    flat = flat[(flat >= 0) & (flat < num_queues)]
    d = int(np.bincount(flat, minlength=1).max()) if flat.size else 1
    d = max(d, 1)
    if d > cap:
        d = default
    return max(1, min(d, int(slots)))


def stable_sort_ids(ids: torch.Tensor, bound: int):
    """Stable ascending sort of int ids in ``[0, bound]``: returns
    ``(sorted_ids, order)`` as int32, ``order`` the stable argsort (the
    values of ``repro``'s packed-key sort, which is a stable sort too)."""
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    return sorted_ids.to(torch.int32), order.to(torch.int32)


def seg_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal ids (ids ascending):
    the index minus the running max of the run starts."""
    n = int(sorted_ids.shape[0])
    idx = torch.arange(n, dtype=torch.int32, device=sorted_ids.device)
    change = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    change[1:] = sorted_ids[1:] != sorted_ids[:-1]
    zero = torch.zeros((), dtype=torch.int32, device=sorted_ids.device)
    return idx - torch.cummax(torch.where(change, idx, zero), dim=0).values


def build_csr_gather(path: torch.Tensor, num_queues: int, maxdeg: int):
    """Invert the hop tables of a batch of scenarios into per-queue gather
    tables.

    ``path`` is [B, S, H] (any shape after the batch axis; each
    scenario's is flattened). The result ``inv`` is [B, num_queues+1,
    maxdeg] int64 where ``inv[b, q, j]`` is the flat index (within
    scenario b) of queue q's j-th contributor in ascending flat order,
    padded with the sentinel index S*H (which ``csr_gather_arrivals``
    maps to a 0.0 contribution). Entries ``>= num_queues`` (the sentinel
    queue) are left out: their contributions are structurally zero.
    ``overflow`` [B] (bool) is True where some queue has more than
    ``maxdeg`` contributors and the table is truncated. One stable sort
    serves the batch: scenario b's queue ids are shifted by
    b * (num_queues+1), so its entries stay in ascending flat order.
    """
    flat = path.reshape(path.shape[0], -1)
    B, nnz = int(flat.shape[0]), int(flat.shape[1])
    Q1 = num_queues + 1
    base = torch.arange(B, dtype=torch.int64, device=path.device) * Q1
    key = flat.to(torch.int64) + base[:, None]
    sorted_k, order = stable_sort_ids(key, B * Q1)
    sorted_k = sorted_k.to(torch.int64)
    # rank of each contributor within its queue (ascending flat index,
    # because the sort is stable)
    rank = seg_ranks(sorted_k).to(torch.int64)
    scen = torch.div(sorted_k, Q1, rounding_mode="floor")
    real = sorted_k - scen * Q1 < num_queues
    overflow = (real & (rank >= maxdeg)).reshape(B, nnz).any(1)
    drop = B * Q1 * maxdeg
    cell = torch.where(real & (rank < maxdeg),
                       sorted_k * maxdeg + rank.clamp_max(maxdeg - 1), drop)
    inv = torch.full((drop + 1,), nnz, dtype=torch.int64, device=path.device)
    inv[cell] = order.to(torch.int64) - scen * nnz
    return inv[:-1].reshape(B, Q1, maxdeg), overflow


def build_csr_gather_padded(path: torch.Tensor, num_queues: int,
                            maxdeg: int, rows: int):
    """``build_csr_gather`` padded to ``rows`` queue rows ([B, rows,
    maxdeg]): the sharded engine (``core/shardslots.py``) splits the table
    row-wise over its ranks, ``rows`` the queue count rounded up to a
    multiple of the rank count. Pad rows hold only the sentinel index
    S*H, which ``csr_gather_arrivals`` maps to +0.0; ``overflow`` keeps
    its whole-table meaning."""
    inv, overflow = build_csr_gather(path, num_queues, maxdeg)
    extra = rows - (num_queues + 1)
    if extra > 0:
        nnz = int(path.reshape(path.shape[0], -1).shape[1])
        inv = torch.cat([inv, inv.new_full((int(inv.shape[0]), extra,
                                            maxdeg), nnz)], 1)
    return inv, overflow


def csr_gather_arrivals(contrib: torch.Tensor, inv: torch.Tensor,
                        zero: torch.Tensor) -> torch.Tensor:
    """Arrival sums of a batch from its inverted incidence (``inv`` [B,
    Q+1, maxdeg], contributions [B, ...], ``zero`` [B, Q+1]): one gather
    and maxdeg in-order column adds. Column j holds every queue's j-th
    contributor, so each queue's chain of adds is exactly the scatter's;
    the sentinel pad contributes +0.0, an identity on the non-negative
    arrivals."""
    B = int(inv.shape[0])
    flat = contrib.reshape(B, -1)
    padded = torch.cat([flat, flat.new_zeros(B, 1)], -1)
    rows = torch.arange(B, device=inv.device).view(B, 1, 1)
    m = padded[rows, inv]                             # [B, Q+1, maxdeg]
    arr = zero
    for col in m.unbind(-1):
        arr = arr + col
    return arr


def max_degree(path: torch.Tensor, num_queues: int) -> int:
    """Largest number of entries of one scenario's ``path`` ([B, ...]) on
    one real queue (at least 1): the ``maxdeg`` that makes
    ``build_csr_gather`` exact for the whole batch. Reads one number back
    from the device."""
    flat = path.reshape(path.shape[0], -1).to(torch.int64)
    B, Q1 = int(flat.shape[0]), num_queues + 1
    key = flat + torch.arange(B, device=flat.device)[:, None] * Q1
    counts = torch.bincount(key.reshape(-1), minlength=B * Q1)
    counts = counts.reshape(B, Q1)[:, :num_queues]
    return max(int(counts.max()) if counts.numel() else 0, 1)


def ordered_scatter_add(zero: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """``zero`` plus ``vals`` scattered to ``idx``, each position summed in
    ascending flat order of ``idx`` — bit-identical to ``repro``'s
    ``zero.at[idx].add(vals)`` on every device, via the gather table (a
    batch of one)."""
    n = int(zero.shape[0])
    inv, _ = build_csr_gather(idx[None], n, max_degree(idx[None], n))
    return csr_gather_arrivals(vals[None], inv[:, :n], zero[None])[0]


def apply_loss(arr: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Per-link loss folded into the accumulated queue arrivals: ``arr *
    keep`` (each queue's survival fraction, [Q+1] or per scenario [B,
    Q+1]), after the in-order sum and before the integration, so every
    engine scales the same sum. A keep of 1.0 is exact."""
    return arr * keep


def integrate_arrivals(arr: torch.Tensor, q: torch.Tensor, bw: torch.Tensor,
                       caps: torch.Tensor, *, dt: float):
    """The fluid-queue integration shared by the sparse queue forms:
    ``q' = min(max(q + (arr - bw) dt, 0), caps)`` with the sentinel queue
    pinned to 0, and the egress rate ``out = bw`` where the queue was
    backlogged, else ``min(arr, bw)``. Returns (out, q_new)."""
    q_new = torch.minimum(torch.clamp_min(q + (arr - bw) * dt, 0.0), caps)
    q_new[..., -1] = 0.0
    out = torch.where(q > 0.0, bw, torch.minimum(arr, bw))
    return out, q_new


def queue_arrivals_sparse(lam_del: torch.Tensor, path: torch.Tensor,
                          valid: torch.Tensor, q: torch.Tensor,
                          bw: torch.Tensor, caps: torch.Tensor, *,
                          dt: float):
    """Sparse queue update in one call: the pool's [S, H] delayed rates
    summed per queue in ascending flat order (``ordered_scatter_add``),
    then ``integrate_arrivals``. Returns (arrivals, out, q_new), bit for
    bit the reference backend's ``fluid._queue_update``."""
    contrib = torch.where(valid, lam_del, 0.0)
    arr = ordered_scatter_add(torch.zeros_like(q), path, contrib)
    out, q_new = integrate_arrivals(arr, q, bw, caps, dt=dt)
    return arr, out, q_new


def update_incidence(incidence: torch.Tensor, path: torch.Tensor,
                     changed: torch.Tensor, num_queues: int) -> torch.Tensor:
    """Refresh a slot pool's [..., H, S, Q+1] one-hot incidence where
    ``changed`` [..., S] marks slots admitted this tick (retired slots
    keep their stale path: their delayed rates are zero). Sentinel hops
    become all-zero rows, as in ``fluid.build_incidence``."""
    return torch.where(changed[..., None, :, None],
                       one_hot_incidence(path, num_queues), incidence)


def one_hot_incidence(path: torch.Tensor, num_queues: int) -> torch.Tensor:
    """[..., H, F, Q+1] float32 one-hot of an [..., F, H] hop table,
    contiguous, with all-zero rows for sentinel hops."""
    pt = path.transpose(-1, -2).to(torch.int64)
    oh = torch.nn.functional.one_hot(pt, num_queues + 1).to(torch.float32)
    return oh * (pt < num_queues)[..., None]
