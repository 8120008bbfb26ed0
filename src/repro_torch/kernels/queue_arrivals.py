"""Fluid-queue update: the dense K3 kernel and the in-order sparse helpers
(twin of ``repro.kernels.queue_arrivals``).

Dense (``queue_arrivals``, the ``"fused"`` backend): K3 replaces
``repro/kernels/queue_arrivals.py::queue_arrivals``. Per tick it sums the
delayed per-hop rates through the [H, F, Q+1] one-hot incidence and
integrates the queues, ``q' = clip(q + (arr - out) dt, 0, caps)``, in one
launch of ``csrc/queue_arrivals.cu``. Its sum runs in a fixed order that
is not the reference scatter's, so the fused backend is close to (not
bitwise equal with) the reference backend.

Sparse (the ``"reference"`` backend): ``repro`` accumulates queue
arrivals with a scatter-add that XLA runs in ascending flat order. On the
card ``index_add_``/``scatter_add_`` use atomics whose order changes from
run to run, so the port inverts the hop table into a per-queue gather
table (``build_csr_gather``) and adds each queue's contributors in
ascending flat order (``csr_gather_arrivals``) — bit-identical to the
scatter by construction, on the CPU and on the card alike.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"queue_arrivals_f32": [_P] * 7 + [_I, _I, _I, _F, _P]}


def queue_arrivals(lam_del, onehot, q, out_rate, caps, *, dt):
    """K3 on CUDA tensors. lam_del: [H,F]; onehot: [H,F,Q]; q/out_rate/caps:
    [Q] (all float32, contiguous). Returns (arrivals [Q], q_new [Q])."""
    H, F, Q = onehot.shape
    _build.check_tensors(
        "queue_arrivals",
        dict(lam_del=lam_del, onehot=onehot, q=q, out_rate=out_rate,
             caps=caps),
        dict(lam_del=(H, F), onehot=(H, F, Q), q=(Q,), out_rate=(Q,),
             caps=(Q,)), onehot.device)
    arr = torch.empty_like(q)
    q_new = torch.empty_like(q)
    if Q == 0:
        return arr, q_new
    lib = _build.library("queue_arrivals", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.queue_arrivals_f32(
            lam_del.data_ptr(), onehot.data_ptr(), q.data_ptr(),
            out_rate.data_ptr(), caps.data_ptr(), arr.data_ptr(),
            q_new.data_ptr(), H, F, Q, dt, stream)
    _build.check(err, "queue_arrivals")
    _build.LAUNCHES["queue_arrivals"] += 1
    return arr, q_new


def build_csr_gather(path: torch.Tensor, num_queues: int, maxdeg: int):
    """Invert a hop table into a per-queue gather table.

    ``path`` is an [S, H] hop table (any shape; it is flattened). The
    result ``inv`` is [num_queues+1, maxdeg] int64 where ``inv[q, j]`` is
    the flat index of queue q's j-th contributor in ascending flat order,
    padded with the sentinel index S*H (which ``csr_gather_arrivals`` maps
    to a 0.0 contribution). Entries ``>= num_queues`` (the sentinel queue)
    are left out: their contributions are structurally zero. ``overflow``
    (a bool tensor) is True when some queue has more than ``maxdeg``
    contributors and the table is truncated.
    """
    flat_q = path.reshape(-1)
    nnz = int(flat_q.shape[0])
    dev = path.device
    sorted_q, order = torch.sort(flat_q, stable=True)
    sorted_q = sorted_q.to(torch.int64)
    idx = torch.arange(nnz, device=dev)
    change = torch.ones(nnz, dtype=torch.bool, device=dev)
    change[1:] = sorted_q[1:] != sorted_q[:-1]
    # rank of each contributor within its queue (ascending flat index,
    # because the sort is stable)
    rank = idx - torch.cummax(torch.where(change, idx, 0), dim=0).values
    real = sorted_q < num_queues
    overflow = torch.any(real & (rank >= maxdeg))
    drop = (num_queues + 1) * maxdeg
    cell = torch.where(real & (rank < maxdeg),
                       sorted_q * maxdeg + rank.clamp_max(maxdeg - 1), drop)
    inv = torch.full((drop + 1,), nnz, dtype=torch.int64, device=dev)
    inv[cell] = order
    return inv[:-1].reshape(num_queues + 1, maxdeg), overflow


def csr_gather_arrivals(contrib: torch.Tensor, inv: torch.Tensor,
                        zero: torch.Tensor) -> torch.Tensor:
    """Arrival sums from the inverted incidence: one [Q+1, maxdeg] gather
    and maxdeg in-order column adds. Column j holds every queue's j-th
    contributor, so each queue's chain of adds is exactly the scatter's;
    the sentinel pad contributes +0.0, an identity on the non-negative
    arrivals."""
    padded = torch.cat([contrib.reshape(-1), contrib.new_zeros(1)])
    m = padded[inv]                                   # [Q+1, maxdeg]
    arr = zero
    for j in range(inv.shape[1]):
        arr = arr + m[:, j]
    return arr


def max_degree(path: torch.Tensor, num_queues: int) -> int:
    """Largest number of entries of ``path`` on one real queue (at least
    1): the ``maxdeg`` that makes ``build_csr_gather`` exact. Reads one
    number back from the device."""
    flat = path.reshape(-1).to(torch.int64)
    counts = torch.bincount(flat, minlength=num_queues + 1)[:num_queues]
    return max(int(counts.max()) if counts.numel() else 0, 1)


def ordered_scatter_add(zero: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """``zero`` plus ``vals`` scattered to ``idx``, each position summed in
    ascending flat order of ``idx`` — bit-identical to ``repro``'s
    ``zero.at[idx].add(vals)`` on every device, via the gather table."""
    n = int(zero.shape[0])
    inv, _ = build_csr_gather(idx, n, max_degree(idx, n))
    return csr_gather_arrivals(vals, inv[:n], zero)


def update_incidence(incidence: torch.Tensor, path: torch.Tensor,
                     changed: torch.Tensor, num_queues: int) -> torch.Tensor:
    """Refresh a slot pool's [H, S, Q+1] one-hot incidence where
    ``changed`` [S] marks slots admitted this tick (retired slots keep
    their stale path: their delayed rates are zero). Sentinel hops become
    all-zero rows, as in ``fluid.build_incidence``."""
    return torch.where(changed[None, :, None],
                       one_hot_incidence(path, num_queues), incidence)


def one_hot_incidence(path: torch.Tensor, num_queues: int) -> torch.Tensor:
    """[H, F, Q+1] float32 one-hot of an [F, H] hop table, contiguous,
    with all-zero rows for sentinel hops."""
    pt = path.t().to(torch.int64)
    oh = torch.nn.functional.one_hot(pt, num_queues + 1).to(torch.float32)
    return oh * (pt < num_queues)[..., None]
