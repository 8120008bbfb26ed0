"""Wrapper of K4, the whole-tick megakernel (``csrc/fused_tick.cu``).

K4 replaces ``repro/kernels/fused_tick.py::fused_tick_block``: one launch
advances the flow-slot engine by K whole ticks of
``core.megakernel.make_tick`` (``DEFAULT_BLOCK = 64``), the gated
admit/retire pass included, for PowerTCP and theta-PowerTCP. One
persistent thread block runs the block's ticks with barriers between the
tick's phases, on a working set staged in shared memory for the launch
(``layout``: the per-slot, per-hop and per-queue carry, the topology it
indexes, the tick's temporaries and each queue's full contributor list);
the rings stay in device memory, and the carry is written back in place
at the end of the launch. What bounds a tick is its chain of dependent
phases, not bytes (see the note in the source).

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


# warps of K4's block (csrc/fused_tick.cu kWarps): the counting sort of
# the contributor lists keeps a count per warp and queue
WARPS = 16
# shared memory a block may take on an H100 (227 KB), less 2 KB for K4's
# static shared memory
SMEM_BUDGET = 227 * 1024 - 2048


def _fields(S, H, Q, nsw, swdeg, nswb, law):
    """(name, 4-byte words) of every field K4 stages, in the order of
    ``enum Field`` in ``csrc/fused_tick.cu``: the tick's temporaries and
    the contributor lists (CSR offsets, entries, each entry's place, the
    per-warp counts), the queues (with each queue's q / bw) and the
    topology, the hops, the slots (with each slot's law config beta and
    tau)."""
    SH, Q1 = S * H, Q + 1
    slot_fields = ("slot_flow admit_t free_at rtt_steps hold pend_flow tau "
                   "nic start stop w rate_cap remaining next_update "
                   "last_update gamma_smooth prev_theta pend_val beta "
                   "ctau").split()
    return ([("contrib", SH + 1), ("obs", SH * (3 if law == 0 else 1)),
             ("theta_now", S), ("lam", S), ("act", S), ("freef", S),
             ("sw_used", nsw), ("csr_off", Q1 + 1), ("csr_list", SH),
             ("csr_pos", SH), ("csr_hist", WARPS * Q1),
             ("q", Q1), ("out_rate", Q1), ("qb", Q1), ("bw", Q1),
             ("buf", Q1),
             ("switch_of_queue", Q), ("sw_table", nsw * swdeg),
             ("switch_buffer", nswb),
             ("path", SH), ("tf_steps", SH)]
            + [(f, 0 if f == "prev_theta" and law != 1 else S)
               for f in slot_fields])


class Layout(NamedTuple):
    """Where K4 keeps its working set for one launch: each field's byte
    offset (16-byte aligned), the bytes in all, and whether they fit in
    shared memory. Otherwise the same layout lives in a global scratch
    buffer: the same kernel on a slower layout."""
    offsets: tuple
    nbytes: int
    smem: bool


def layout(S, H, Q, nsw, swdeg, nswb, law) -> Layout:
    """K4's layout for S slots of H hops, Q queues, ``nsw`` switches of
    ``swdeg`` ports in the Dynamic-Thresholds fold (0: off), ``nswb``
    switch buffers, and law 0 (PowerTCP) or 1 (theta-PowerTCP)."""
    offsets, at = [], 0
    for _, words in _fields(S, H, Q, nsw, swdeg, nswb, law):
        offsets.append(at)
        at += -(-4 * words // 16) * 16
    return Layout(tuple(offsets), at, at <= SMEM_BUDGET)


_PTRS = ("cursor hw slot_flow admit_t free_at path tf_steps rtt_steps tau "
         "nic start stop w rate_cap q out_rate hist_lam hist_q hist_w "
         "remaining next_update last_update gamma_smooth prev_theta fct "
         "pend_flow pend_val hold inv ovf s_path s_tf s_rtt s_tau s_nic "
         "s_start s_stop s_size c_beta c_tau bw buf sw_table switch_buffer "
         "switch_of_queue due rec_t rec_q rec_w_sum rec_thru rec_lam "
         "rec_lam_f rec_n_active scratch").split()
_INTS = ("S N Q H D nsw swdeg nswb maxdeg K t0 record_every record law "
         "has_period use_smem layout_bytes").split()
_NFIELDS = len(_fields(1, 1, 1, 0, 0, 1, 0))
_FLOATS = "dt inv_dt dt_alpha gamma one_minus_gamma update_period".split()


class _Args(ctypes.Structure):
    """``struct FusedTickArgs`` of ``csrc/fused_tick.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] +
                [(n, ctypes.c_int) for n in _INTS] +
                [(n, ctypes.c_float) for n in _FLOATS] +
                [("off", ctypes.c_int * _NFIELDS)])


_SIGNATURES = {
    "fused_tick_block_f32": [ctypes.POINTER(_Args), ctypes.c_void_p],
    "fused_tick_abi": [ctypes.POINTER(ctypes.c_int)],
}


def _lib():
    lib = _build.library("fused_tick", _SIGNATURES)
    nf = ctypes.c_int()
    size = lib.fused_tick_abi(ctypes.byref(nf))
    if size != ctypes.sizeof(_Args) or nf.value != _NFIELDS:
        raise RuntimeError(f"fused_tick_block: csrc/fused_tick.cu's "
                           f"FusedTickArgs ({size} bytes, {nf.value} fields)"
                           f" does not match the wrapper's "
                           f"({ctypes.sizeof(_Args)}, {_NFIELDS})")
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
    nswb = int(params.switch_buffer.numel())
    lay = layout(S, H, Q, params.nsw, params.swdeg, nswb, params.law)
    scratch = torch.empty((16 if lay.smem else lay.nbytes,),
                          dtype=torch.uint8, device=dev)

    args = _Args()
    for name, (x, _, _) in leaves.items():
        setattr(args, name, x.data_ptr())
    for name in BlockRecords._fields:
        setattr(args, "rec_" + name, getattr(recs, name).data_ptr())
    args.scratch = scratch.data_ptr()
    for name, val in dict(S=S, N=N, Q=Q, H=H, D=D, nsw=params.nsw,
                          swdeg=params.swdeg, nswb=nswb, maxdeg=M, K=K,
                          t0=int(st.t), record_every=re,
                          record=int(bool(record)), law=params.law,
                          has_period=int(params.update_period > 0.0),
                          use_smem=int(lay.smem),
                          layout_bytes=lay.nbytes).items():
        setattr(args, name, val)
    args.off[:] = lay.offsets
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
