"""Wrapper of K4, the whole-tick megakernel (``csrc/fused_tick.cu``).

K4 replaces ``repro/kernels/fused_tick.py::fused_tick_block``: one launch
advances the flow-slot engine by K whole ticks of
``core.megakernel.make_tick`` (``DEFAULT_BLOCK = 64``), the gated
admit/retire pass included, for PowerTCP and theta-PowerTCP. One
persistent thread block runs the block's ticks with barriers between the
tick's phases; the carry stays in device memory (L2-resident) and is
updated in place. What bounds a tick is its chain of dependent phases,
not bytes (see the note in the source).

``fused_tick_block`` takes CUDA tensors only and launches on the current
stream; ``kernels/ops.py`` sends CPU tensors to the plain block
(``kernels/ref.py::fused_tick_block_ref``) instead. The carry K4 leaves
equals the plain block's bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

# Ticks per launch. Any K works: the host loop clamps it to the trace,
# aligns it to ``record_every`` and runs a remainder block.
DEFAULT_BLOCK = 64


class TickParams(NamedTuple):
    """The read-only inputs of K4 for one run (built by
    ``core.megakernel``): the schedule, the per-flow law config, the
    topology and the run's float32 constants."""
    law: int                        # 0 powertcp, 1 theta_powertcp
    N: int
    Q: int
    D: int
    maxdeg: int
    nsw: int                        # switches of the DT fold (0: DT off)
    swdeg: int
    dt: float
    inv_dt: float
    dt_alpha: float
    gamma: float
    one_minus_gamma: float
    update_period: float            # 0: once per measured RTT
    s_path: torch.Tensor            # [N, H] int32
    s_tf: torch.Tensor              # [N, H] int32
    s_rtt: torch.Tensor             # [N] int32
    s_tau: torch.Tensor             # [N] float32
    s_nic: torch.Tensor
    s_start: torch.Tensor
    s_stop: torch.Tensor
    s_size: torch.Tensor
    c_beta: torch.Tensor            # [N] float32 law config
    c_tau: torch.Tensor
    bw: torch.Tensor                # [Q+1] float32
    buf: torch.Tensor               # [Q+1] float32
    sw_table: Optional[torch.Tensor]  # [nsw, swdeg] int32
    switch_buffer: torch.Tensor     # [switches] float32
    switch_of_queue: torch.Tensor   # [Q] int32


class BlockRecords(NamedTuple):
    """The records of one block, the fields of ``core.types.Record``."""
    t: torch.Tensor
    q: torch.Tensor
    w_sum: torch.Tensor
    thru: torch.Tensor
    lam: torch.Tensor
    lam_f: torch.Tensor
    n_active: torch.Tensor


_PTRS = ("cursor hw slot_flow admit_t free_at path tf_steps rtt_steps tau "
         "nic start stop w rate_cap q out_rate hist_lam hist_q hist_w "
         "remaining next_update last_update gamma_smooth prev_theta fct "
         "pend_flow pend_val hold inv ovf s_path s_tf s_rtt s_tau s_nic "
         "s_start s_stop s_size c_beta c_tau bw buf sw_table switch_buffer "
         "switch_of_queue due rec_t rec_q rec_w_sum rec_thru rec_lam "
         "rec_lam_f rec_n_active scratch").split()
_INTS = ("S N Q H D nsw swdeg maxdeg K t0 record_every record law "
         "has_period use_smem").split()
_FLOATS = "dt inv_dt dt_alpha gamma one_minus_gamma update_period".split()


class _Args(ctypes.Structure):
    """``struct FusedTickArgs`` of ``csrc/fused_tick.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] +
                [(n, ctypes.c_int) for n in _INTS] +
                [(n, ctypes.c_float) for n in _FLOATS])


_SIGNATURES = {
    "fused_tick_block_f32": [ctypes.POINTER(_Args), ctypes.c_void_p],
    "fused_tick_scratch_bytes": [ctypes.c_int] * 3,
}


def _lib():
    lib = _build.library("fused_tick", _SIGNATURES)
    lib.fused_tick_scratch_bytes.restype = ctypes.c_longlong
    return lib


def fused_tick_block(params: TickParams, carry, due_block: torch.Tensor, *,
                     record: bool = True, record_every: int = 1):
    """Run K ticks of the megakernel in one launch of K4, K the length of
    ``due_block`` (int32, the due counts of the block's ticks). ``carry``
    is a ``core.megakernel.MegaCarry`` of CUDA tensors; every leaf is
    updated in place and the returned carry holds the same tensors with
    the tick counter advanced by K. Returns (carry', ``BlockRecords`` of
    every ``record_every``-th tick, or None)."""
    st = carry.state
    dev = st.w.device
    S, H = (int(n) for n in st.path.shape)
    N, Q, D, M = params.N, params.Q, params.D, params.maxdeg
    Q1 = Q + 1
    K = int(due_block.shape[0])
    re = max(int(record_every), 1)
    if record and K % re:
        raise ValueError(f"fused_tick_block: K ({K}) must be a multiple of "
                         f"record_every ({re})")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    law = st.law
    prev_theta = getattr(law, "prev_theta", None)
    if (params.law == 1) != (prev_theta is not None):
        raise ValueError("fused_tick_block: the law state does not match "
                         "the law of the parameters")
    leaves = {
        "cursor": (st.cursor, i32, ()), "hw": (st.hw, i32, ()),
        "slot_flow": (st.slot_flow, i32, (S,)),
        "admit_t": (st.admit_t, i32, (S,)),
        "free_at": (st.free_at, i32, (S,)),
        "path": (st.path, i32, (S, H)), "tf_steps": (st.tf_steps, i32, (S, H)),
        "rtt_steps": (st.rtt_steps, i32, (S,)),
        "tau": (st.tau, f32, (S,)), "nic": (st.nic_rate, f32, (S,)),
        "start": (st.start, f32, (S,)), "stop": (st.stop, f32, (S,)),
        "w": (st.w, f32, (S,)), "rate_cap": (st.rate_cap, f32, (S,)),
        "q": (st.q, f32, (Q1,)), "out_rate": (st.out_rate, f32, (Q1,)),
        "hist_lam": (st.hist_lam, f32, (D, S)),
        "hist_q": (st.hist_q, f32, (D, 3 * Q1)),
        "hist_w": (st.hist_w, f32, (D, S)),
        "remaining": (st.remaining, f32, (S,)),
        "next_update": (st.next_update, f32, (S,)),
        "last_update": (st.last_update, f32, (S,)),
        "gamma_smooth": (law.gamma_smooth, f32, (S,)),
        "fct": (st.fct, f32, (N + 1,)),
        "pend_flow": (carry.pend.flow, i32, (S,)),
        "pend_val": (carry.pend.val, f32, (S,)),
        "hold": (carry.hold, i32, (S,)), "inv": (carry.inv, i32, (Q1, M)),
        "ovf": (carry.ovf, b8, ()),
        "s_path": (params.s_path, i32, (N, H)),
        "s_tf": (params.s_tf, i32, (N, H)),
        "s_rtt": (params.s_rtt, i32, (N,)),
        "bw": (params.bw, f32, (Q1,)), "buf": (params.buf, f32, (Q1,)),
        "switch_buffer": (params.switch_buffer, f32,
                          tuple(params.switch_buffer.shape)),
        "switch_of_queue": (params.switch_of_queue, i32, (Q,)),
        "due": (due_block, i32, (K,)),
    }
    for name in ("s_tau", "s_nic", "s_start", "s_stop", "s_size", "c_beta",
                 "c_tau"):
        leaves[name] = (getattr(params, name), f32, (N,))
    if prev_theta is not None:
        leaves["prev_theta"] = (prev_theta, f32, (S,))
    if params.sw_table is not None:
        leaves["sw_table"] = (params.sw_table, i32,
                              (params.nsw, params.swdeg))
    _build.check_tensors(
        "fused_tick_block", {k: v[0] for k, v in leaves.items()},
        {k: v[2] for k, v in leaves.items()}, dev,
        dtypes={k: v[1] for k, v in leaves.items()})

    nrec = K // re if record else 0
    recs = BlockRecords(
        t=torch.empty((nrec,), dtype=f32, device=dev),
        q=torch.empty((nrec, Q1), dtype=f32, device=dev),
        w_sum=torch.empty((nrec,), dtype=f32, device=dev),
        thru=torch.empty((nrec, Q1), dtype=f32, device=dev),
        lam=torch.empty((nrec,), dtype=f32, device=dev),
        lam_f=torch.empty((nrec, S), dtype=f32, device=dev),
        n_active=torch.empty((nrec,), dtype=i32, device=dev))
    lib = _lib()
    scratch = torch.empty(
        (max(int(lib.fused_tick_scratch_bytes(S, H, params.nsw)), 4),),
        dtype=torch.uint8, device=dev)

    args = _Args()
    for name, (x, _, _) in leaves.items():
        setattr(args, name, x.data_ptr())
    for name in BlockRecords._fields:
        setattr(args, "rec_" + name, getattr(recs, name).data_ptr())
    args.scratch = scratch.data_ptr()
    for name, val in dict(S=S, N=N, Q=Q, H=H, D=D, nsw=params.nsw,
                          swdeg=params.swdeg, maxdeg=M, K=K, t0=int(st.t),
                          record_every=re, record=int(bool(record)),
                          law=params.law,
                          has_period=int(params.update_period > 0.0),
                          use_smem=0).items():
        setattr(args, name, val)
    for name in _FLOATS:
        setattr(args, name, getattr(params, name))
    if K:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_tick_block_f32(ctypes.byref(args), stream)
        _build.check(err, "fused_tick_block")
        _build.LAUNCHES["fused_tick_block"] += 1
    carry = carry._replace(state=st._replace(t=int(st.t) + K))
    return carry, (recs if record else None)
