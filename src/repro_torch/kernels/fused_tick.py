"""Wrapper of K4, the whole-tick megakernel (``csrc/fused_tick.cu``).

K4 replaces ``repro/kernels/fused_tick.py::fused_tick_block``: one launch
advances the flow-slot engine by K whole ticks of
``core.megakernel.make_tick`` (``DEFAULT_BLOCK = 64``), the admit/retire
pass included (gated or, with ``gate=False``, on every tick), for each
law of ``LAW_NAMES`` (the law a template parameter of the kernel; its
state and per-flow config staged per slot, its scalars per scenario in
``TickParams.lawp``). One persistent thread block per scenario
runs the block's ticks with barriers between the tick's phases: a batch
of B scenarios (every carry leaf, the schedule and the law config with a
leading batch axis) is one launch of B blocks that share nothing. Each
block works on a working set staged in its shared memory for the launch
(``layout``: the per-slot, per-hop and per-queue carry, the topology it
indexes, the tick's temporaries and each queue's full contributor list);
the rings stay in device memory, and the carry is written back in place
at the end of the launch. What bounds a tick is its chain of dependent
phases, not bytes (see the note in the source).

``fused_tick_block`` takes CUDA tensors only and launches on the current
stream; ``kernels/ops.py`` sends CPU tensors to the plain block
(``kernels/ref.py::fused_tick_block_ref``) instead. The carry K4 leaves
equals the plain block's bit for bit, with the same ``gate``.

``gate``: K4 honours both values. The batched megakernel path
(``fluid.simulate_slots_batch``) passes ``gate=True`` whether or not it
runs the scenarios sequentially. ``repro`` runs the ungated tick for a
vmapped batch only because a ``lax.cond`` under ``vmap`` runs both of its
branches; a K4 block branches on its own scenario's state, so that reason
does not hold here, and the gated tick skips the admit/retire pass and
the contributor lists' rebuild on the ticks that need neither.

Time-varying bandwidth: ``TickParams.sched`` ([B, 6], the fields of
``core.rdcn.ScheduleParams``) makes each block evaluate its scenario's
circuit schedule at the start of every tick (the classification by
``jnp.mod``'s rule on ``fmodf``), set the VOQ's rate from it and
recompute each queue's q / bw before any phase reads them; without it
(None) the topology's rates hold for the launch. The flag is one
block-uniform branch a tick. ``fused_tick_schedule`` runs that
evaluation alone, compiled with K4's flags, to hold it against
``rdcn.circuit_bw_at`` on the card.

Impairments: ``TickParams.impair`` (a regime of ``core.impair``, packed
by ``core.megakernel._k4_impair`` as int32 rows [10, Q], shared by the
batch, or [B, 10, Q]) makes each block evaluate every queued link's
capacity, loss and jitter processes at the start of every tick and keep
the rates, survival fractions and jitters in shared memory (``keep`` and
``jit``, 2 (Q+1) floats of the layout); the arrivals, the observation,
theta and the goodput read them. Whether a launch carries a regime picks
the kernel's instantiation, so a clean run executes none of that code.
``impair`` runs the evaluation alone, compiled with K4's flags, to hold
it against ``core.impair`` on the card.

Chunk windows: the schedule rows of ``TickParams`` (``s_*``) may be a C-row
window of the whole schedule (a chunk-streamed run, ``core.fluid``'s
loop); ``fused_tick_block``'s ``win_off`` is then the window's global
base, and admission reads the rows of flow f at ``clamp(f - win_off, 0,
C - 1)``, while the law config, the FCT table and the free-slot sentinel
keep the global f and N. A whole-schedule run passes ``win_off = 0`` with
C = N.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

# Ticks per launch. Any K works: the host loop clamps it to the trace,
# aligns it to ``record_every`` and runs a remainder block.
DEFAULT_BLOCK = 64


# K4's laws; a law's id is its place here (``TickParams.law``)
LAW_NAMES = ("powertcp", "theta_powertcp", "hpcc", "swift", "gradient_mimd",
             "timely", "dcqcn", "reno", "retcp", "fncc", "pulser",
             "backpressure", "pcc")
# the state fields K4 stages, in ``enum Field``'s order; a law stages the
# fields of its state NamedTuple, a nested one's flattened (reTCP's
# NewReno ``last_cut`` and its ``w_base``; swift's ``dummy`` stays zeros
# in the carry and is not staged); ``INT_STATE`` are int32
STATE_FIELDS = ("gamma_smooth prev_theta u wc inc_stage last_ref rate "
                "neg_count rc rt alpha t_last_cut t_last_inc "
                "last_cut w_base").split()
INT_STATE = ("inc_stage", "neg_count")
LAW_STATE = {
    "powertcp": ("gamma_smooth",),
    "theta_powertcp": ("gamma_smooth", "prev_theta"),
    "hpcc": ("u", "wc", "inc_stage", "last_ref"),
    "swift": (),
    "gradient_mimd": ("prev_theta",),
    "timely": ("rate", "prev_theta", "neg_count"),
    "dcqcn": ("rc", "rt", "alpha", "t_last_cut", "t_last_inc", "inc_stage"),
    "reno": ("last_cut",),
    "retcp": ("last_cut", "w_base"),
    "fncc": ("u",),
    "pulser": (),
    "backpressure": ("last_cut",),
    "pcc": ("rate",),
}
# the per-flow law config K4 reads through ``slot_flow`` (each [B, N]
# float32): beta, tau, gamma and 1 - gamma (``omg``), host_bw and
# TIMELY's thresholds and step
CONFIG_FIELDS = ("beta ctau gamma omg hbw t_low t_high tadd").split()
_EWMA = ("beta", "ctau", "gamma", "omg")
LAW_CONFIG = {
    "powertcp": _EWMA, "theta_powertcp": _EWMA, "swift": _EWMA,
    "gradient_mimd": _EWMA, "hpcc": ("beta", "ctau", "hbw"),
    "timely": ("ctau", "hbw", "t_low", "t_high", "tadd"),
    "dcqcn": ("ctau", "hbw"), "reno": (), "retcp": ("ctau", "hbw"),
    "fncc": _EWMA, "pulser": ("beta", "ctau"), "backpressure": ("beta",),
    "pcc": ("ctau", "hbw"),
}
# per-hop telemetry words a law reads from the packed ring: q, then the
# egress rate (PowerTCP, HPCC, FNCC) or the law's feedback channel (the
# pause state of backpressure, the sender count of pulser), then the
# queue gradient (PowerTCP)
TELEMETRY = {"powertcp": 3, "hpcc": 2, "fncc": 2, "pulser": 2,
             "backpressure": 2}
# the feedback channels a law's ring appends to [q | out | qdot]
# (``core.megakernel.ring_channels``); backpressure also carries each
# queue's pause state
PAUSE_LAWS = ("backpressure",)
INCAST_LAWS = ("pulser",)
# the per-scenario law constants (``TickParams.lawp`` [B, len]), float32;
# the integer ones hold small integers exactly. ``*_inv_*`` are the
# float32 reciprocals a Python-scalar divisor is multiplied by
# (``core.laws.div_config``), ``dcqcn_omg`` 1 - g and ``dcqcn_rai_hyper``
# 5 * rai, each rounded as the plain law rounds it; ``retcp_*`` reTCP's
# own circuit schedule (``LawConfig.sched``) and prebuffer; then the
# feedback-channel laws' scalars
LAW_PARAMS = ("hpcc_eta hpcc_inv_eta hpcc_max_stage timely_beta "
              "timely_hai_n dcqcn_kmin dcqcn_span dcqcn_inv_span dcqcn_pmax "
              "dcqcn_g dcqcn_omg dcqcn_rai dcqcn_rai_hyper dcqcn_timer "
              "dcqcn_cnp_timer dcqcn_f reno_md retcp_day retcp_night "
              "retcp_week retcp_t0 retcp_circuit_bw retcp_packet_bw "
              "retcp_prebuffer fncc_eta fncc_inv_eta pulser_n bp_xoff "
              "bp_xon bp_md pcc_eps pcc_b").split()
# the fields of one scenario's bandwidth schedule (``TickParams.sched``),
# ``core.rdcn.ScheduleParams``'
SCHED_FIELDS = "day night week t0 circuit_bw packet_bw".split()
# the rows of an impairment regime (``TickParams.impair``),
# ``core.impair.ImpairmentParams``' fields
IMPAIR_FIELDS = ("kind bw_hi bw_lo period up t0 loss loss_kind jitter "
                 "seed").split()


class TickParams(NamedTuple):
    """The read-only inputs of K4 for one run (built by
    ``core.megakernel``): the schedule (its C rows, the whole schedule's
    N or a chunk window's), the law config (per flow, and per scenario in
    ``lawp``), the topology and the run's float32 constants. ``config``
    maps each of the law's ``LAW_CONFIG`` fields to its [B, N] tensor;
    ``N`` is the whole schedule's flow count."""
    law: int                        # index into LAW_NAMES
    N: int
    Q: int
    D: int
    maxdeg: int
    nsw: int                        # switches of the DT fold (0: DT off)
    swdeg: int
    dt: float
    inv_dt: float
    dt_alpha: float
    update_period: float            # 0: once per measured RTT
    div_eta: int                    # 1: divide by hpcc_eta, 0: multiply
    div_span: int                   # the same for the marking span
    div_fncc: int                   # the same for fncc_eta
    s_path: torch.Tensor            # [C, H] int32 (C = N, or a window)
    s_tf: torch.Tensor              # [C, H] int32
    s_rtt: torch.Tensor             # [C] int32
    s_tau: torch.Tensor             # [C] float32
    s_nic: torch.Tensor
    s_start: torch.Tensor
    s_stop: torch.Tensor
    s_size: torch.Tensor
    config: dict                    # name -> [N] float32 (LAW_CONFIG)
    lawp: torch.Tensor              # [len(LAW_PARAMS)] float32
    bw: torch.Tensor                # [Q+1] float32
    buf: torch.Tensor               # [Q+1] float32
    sw_table: Optional[torch.Tensor]  # [nsw, swdeg] int32
    switch_buffer: torch.Tensor     # [switches] float32
    switch_of_queue: torch.Tensor   # [Q] int32
    sched: Optional[torch.Tensor] = None  # [B, 6] float32 bandwidth schedule
    impair: Optional[torch.Tensor] = None  # [10, Q] / [B, 10, Q] int32 regime


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


def ring_channels(name: str) -> int:
    """Columns of law ``name``'s packed ring in units of Q+1
    (``core.megakernel.ring_channels``)."""
    return 3 + (name in PAUSE_LAWS) + (name in INCAST_LAWS)


def _fields(S, H, Q, nsw, swdeg, nswb, law, impair=False):
    """(name, 4-byte words) of every field K4 stages, in the order of
    ``enum Field`` in ``csrc/fused_tick.cu``: the tick's temporaries and
    the contributor lists (CSR offsets, entries, each entry's place, the
    per-warp counts), the queues (with each queue's q / bw, under an
    impairment regime its survival fraction and jitter, and the pause
    state of a law with that channel) and the topology, the hops, the
    slots: their carry, the law state and config of law ``law`` (an index
    into ``LAW_NAMES``; a field the law lacks takes no words)."""
    name = LAW_NAMES[law]
    SH, Q1 = S * H, Q + 1
    slot_fields = ("slot_flow admit_t free_at rtt_steps hold pend_flow tau "
                   "nic start stop w rate_cap remaining next_update "
                   "last_update").split()
    return ([("contrib", SH + 1), ("obs", SH * TELEMETRY.get(name, 1)),
             ("theta_now", S), ("lam", S), ("act", S), ("freef", S),
             ("sw_used", nsw), ("csr_off", Q1 + 1), ("csr_list", SH),
             ("csr_pos", SH), ("csr_hist", WARPS * Q1),
             ("q", Q1), ("out_rate", Q1), ("qb", Q1), ("bw", Q1),
             ("keep", Q1 if impair else 0), ("jit", Q1 if impair else 0),
             ("buf", Q1), ("pause", Q1 if name in PAUSE_LAWS else 0),
             ("switch_of_queue", Q), ("sw_table", nsw * swdeg),
             ("switch_buffer", nswb),
             ("path", SH), ("tf_steps", SH)]
            + [(f, S) for f in slot_fields]
            + [(f, S if f in LAW_STATE[name] else 0) for f in STATE_FIELDS]
            + [("pend_val", S)]
            + [(f, S if f in LAW_CONFIG[name] else 0)
               for f in CONFIG_FIELDS])


class Layout(NamedTuple):
    """Where K4 keeps its working set for one launch: each field's byte
    offset (16-byte aligned), the bytes in all, and whether they fit in
    shared memory. Otherwise the same layout lives in a global scratch
    buffer: the same kernel on a slower layout."""
    offsets: tuple
    nbytes: int
    smem: bool


def layout(S, H, Q, nsw, swdeg, nswb, law, impair=False) -> Layout:
    """K4's layout for S slots of H hops, Q queues, ``nsw`` switches of
    ``swdeg`` ports in the Dynamic-Thresholds fold (0: off), ``nswb``
    switch buffers, law ``law`` (an index into ``LAW_NAMES``) and, with
    ``impair``, an impairment regime."""
    offsets, at = [], 0
    for _, words in _fields(S, H, Q, nsw, swdeg, nswb, law, impair):
        offsets.append(at)
        at += -(-4 * words // 16) * 16
    return Layout(tuple(offsets), at, at <= SMEM_BUDGET)


_PTRS = (("cursor hw slot_flow admit_t free_at path tf_steps rtt_steps tau "
          "nic start stop w rate_cap q out_rate hist_lam hist_q hist_w "
          "remaining next_update last_update").split() + STATE_FIELDS
         + ("pause fct pend_flow pend_val hold inv ovf s_path s_tf s_rtt "
            "s_tau s_nic s_start s_stop s_size").split()
         + ["c_" + f for f in CONFIG_FIELDS]
         + ("lawp sched imp bw buf sw_table switch_buffer switch_of_queue due "
            "rec_t rec_q rec_w_sum rec_thru rec_lam rec_lam_f rec_n_active "
            "scratch").split())
_INTS = ("S N Q H D nsw swdeg nswb maxdeg K t0 record_every record law "
         "has_period use_smem layout_bytes B gate due_stride div_eta "
         "div_span div_fncc smask cmask nlawp imp_stride C win_off").split()
_NFIELDS = len(_fields(1, 1, 1, 0, 0, 1, 0))
# the inputs K4 reads and never writes
_READ_ONLY = set(("s_path s_tf s_rtt s_tau s_nic s_start s_stop s_size lawp "
                  "sched imp bw buf sw_table switch_buffer switch_of_queue")
                 .split()
                 + ["c_" + f for f in CONFIG_FIELDS])
_FLOATS = "dt inv_dt dt_alpha update_period".split()


class _Args(ctypes.Structure):
    """``struct FusedTickArgs`` of ``csrc/fused_tick.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] +
                [(n, ctypes.c_int) for n in _INTS] +
                [(n, ctypes.c_float) for n in _FLOATS] +
                [("off", ctypes.c_int * _NFIELDS)])


def state_leaves(law) -> dict:
    """A law state's tensors by field name, a nested state's fields
    flattened in order (reTCP's ``reno.last_cut``, then ``w_base``)."""
    out = {}
    for f, x in zip(law._fields, law):
        if isinstance(x, tuple):
            out.update(state_leaves(x))
        else:
            out[f] = x
    return out


def _mask(fields, staged) -> int:
    """Bit i set where ``fields[i]`` is among ``staged``."""
    return sum(1 << i for i, f in enumerate(fields) if f in staged)


_SIGNATURES = {
    "fused_tick_block_f32": [ctypes.POINTER(_Args), ctypes.c_void_p],
    "fused_tick_abi": [ctypes.POINTER(ctypes.c_int)],
    "fused_tick_powf": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p],
    "fused_tick_schedule": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "fused_tick_impair": [ctypes.c_void_p] + [ctypes.c_int] * 5
                         + [ctypes.c_float] + [ctypes.c_void_p] * 4,
}


def _lib(law: int = 0):
    """The library of law ``law``'s K4 (each law is built on its own,
    ``_build.SOURCES``; every one also holds the probes)."""
    lib = _build.library(f"fused_tick@{law}", _SIGNATURES)
    nf = ctypes.c_int()
    size = lib.fused_tick_abi(ctypes.byref(nf))
    if size != ctypes.sizeof(_Args) or nf.value != _NFIELDS:
        raise RuntimeError(f"fused_tick_block: csrc/fused_tick.cu's "
                           f"FusedTickArgs ({size} bytes, {nf.value} fields)"
                           f" does not match the wrapper's "
                           f"({ctypes.sizeof(_Args)}, {_NFIELDS})")
    return lib


# The argument structs of recent launches, filled and checked once per
# run: keyed by the identity of the run's tensors (the carry is updated in
# place, so a run's launches share them), which the entry keeps alive so
# that no id is reused while it is cached. A launch then sets only its
# own fields (the tick, K, the due counts, the record rows).
_ARGS_CACHE: dict = {}
_ARGS_CACHE_MAX = 16


def _run_tensors(params: TickParams, carry) -> list:
    """Every tensor a launch's argument struct points at, but the due
    counts and the records."""
    st = carry.state
    out = [st.cursor, st.hw, st.slot_flow, st.admit_t, st.free_at, st.path,
           st.tf_steps, st.rtt_steps, st.tau, st.nic_rate, st.start, st.stop,
           st.w, st.rate_cap, st.q, st.out_rate, st.hist_lam, st.hist_q,
           st.hist_w, st.remaining, st.next_update, st.last_update, st.fct,
           st.pause, carry.pend.flow, carry.pend.val, carry.hold, carry.inv,
           carry.ovf, params.lawp, params.sched, params.impair]
    out += list(state_leaves(st.law).values()) + list(params.config.values())
    return [x for x in out if isinstance(x, torch.Tensor)]


def _launch_args(params: TickParams, carry):
    """(the argument struct of a run's launches with every field but the
    per-launch ones set, the batch's leading shape); checked and filled
    on the first launch of a run, then taken from the cache."""
    tens = _run_tensors(params, carry)
    key = (id(params),) + tuple((id(x), x.data_ptr()) for x in tens)
    hit = _ARGS_CACHE.get(key)
    if hit is not None:
        return hit[0], hit[1]
    st = carry.state
    dev = st.w.device
    lead = tuple(st.w.shape[:-1])
    S, H = (int(n) for n in st.path.shape[-2:])
    B = 1
    for n in lead:
        B *= n
    N, Q, D, M = params.N, params.Q, params.D, params.maxdeg
    C = int(params.s_start.shape[-1])
    Q1 = Q + 1
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    lname = LAW_NAMES[params.law]
    law = state_leaves(st.law)
    if tuple(law) != (LAW_STATE[lname] or ("dummy",)):
        raise ValueError(f"fused_tick_block: the law state "
                         f"{type(st.law).__name__} is not {lname}'s")
    if dev.type == "cuda" and (B < 1 or B > 65535):
        raise ValueError(f"fused_tick_block: a batch of {B} scenarios")
    # per scenario: (tensor, dtype, shape without the batch axis)
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
        "hist_q": (st.hist_q, f32, (D, ring_channels(lname) * Q1)),
        "hist_w": (st.hist_w, f32, (D, S)),
        "remaining": (st.remaining, f32, (S,)),
        "next_update": (st.next_update, f32, (S,)),
        "last_update": (st.last_update, f32, (S,)),
        "fct": (st.fct, f32, (N + 1,)),
        "pend_flow": (carry.pend.flow, i32, (S,)),
        "pend_val": (carry.pend.val, f32, (S,)),
        "hold": (carry.hold, i32, (S,)), "inv": (carry.inv, i32, (Q1, M)),
        "ovf": (carry.ovf, b8, ()),
        "s_path": (params.s_path, i32, (C, H)),
        "s_tf": (params.s_tf, i32, (C, H)),
        "s_rtt": (params.s_rtt, i32, (C,)),
    }
    for f in ("s_tau", "s_nic", "s_start", "s_stop", "s_size"):
        leaves[f] = (getattr(params, f), f32, (C,))
    if lname in PAUSE_LAWS:
        leaves["pause"] = (st.pause, f32, (Q1,))
    for f in LAW_STATE[lname]:
        leaves[f] = (law[f], i32 if f in INT_STATE else f32, (S,))
    for f in LAW_CONFIG[lname]:
        leaves["c_" + f] = (params.config[f], f32, (N,))
    leaves["lawp"] = (params.lawp, f32, (len(LAW_PARAMS),))
    if params.sched is not None:
        leaves["sched"] = (params.sched, f32, (len(SCHED_FIELDS),))
    imp = params.impair
    shared = imp is not None and imp.dim() == 2
    if imp is not None and not shared:
        leaves["imp"] = (imp, i32, (len(IMPAIR_FIELDS), Q))
    leaves = {k: (x, dt, lead + shape) for k, (x, dt, shape)
              in leaves.items()}
    if shared:
        leaves["imp"] = (imp, i32, (len(IMPAIR_FIELDS), Q))
    # the topology, shared by the batch
    leaves["bw"] = (params.bw, f32, (Q1,))
    leaves["buf"] = (params.buf, f32, (Q1,))
    leaves["switch_buffer"] = (params.switch_buffer, f32,
                               tuple(params.switch_buffer.shape))
    leaves["switch_of_queue"] = (params.switch_of_queue, i32, (Q,))
    if params.sw_table is not None:
        leaves["sw_table"] = (params.sw_table, i32,
                              (params.nsw, params.swdeg))
    _build.check_tensors(
        "fused_tick_block", {k: v[0] for k, v in leaves.items()},
        {k: v[2] for k, v in leaves.items()}, dev,
        dtypes={k: v[1] for k, v in leaves.items()})
    # K4 writes the carry back in place: two leaves on one buffer would
    # take each other's values
    ptrs = [x.data_ptr() for k, (x, _, _) in leaves.items()
            if k not in _READ_ONLY]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("fused_tick_block: two carry leaves share memory")
    nswb = int(params.switch_buffer.numel())
    lay = layout(S, H, Q, params.nsw, params.swdeg, nswb, params.law,
                 imp is not None)
    scratch = torch.empty((16 if lay.smem else B * lay.nbytes,),
                          dtype=torch.uint8, device=dev)
    args = _Args()
    for f, (x, _, _) in leaves.items():
        setattr(args, f, x.data_ptr())
    args.scratch = scratch.data_ptr()
    for f, val in dict(S=S, N=N, Q=Q, H=H, D=D, nsw=params.nsw,
                          swdeg=params.swdeg, nswb=nswb, maxdeg=M,
                          law=params.law,
                          has_period=int(params.update_period > 0.0),
                          use_smem=int(lay.smem),
                          layout_bytes=lay.nbytes, B=B,
                          div_eta=params.div_eta,
                          div_span=params.div_span,
                          div_fncc=params.div_fncc,
                          smask=_mask(STATE_FIELDS, LAW_STATE[lname]),
                          cmask=_mask(CONFIG_FIELDS, LAW_CONFIG[lname]),
                          nlawp=len(LAW_PARAMS),
                          imp_stride=(0 if imp is None or shared
                                      else len(IMPAIR_FIELDS) * Q),
                          C=C, win_off=0).items():
        setattr(args, f, val)
    args.off[:] = lay.offsets
    for f in _FLOATS:
        setattr(args, f, getattr(params, f))
    if len(_ARGS_CACHE) >= _ARGS_CACHE_MAX:
        _ARGS_CACHE.clear()
    _ARGS_CACHE[key] = (args, lead, (params, tens, scratch))
    return args, lead


def fused_tick_block(params: TickParams, carry, due_block: torch.Tensor, *,
                     record: bool = True, record_every: int = 1,
                     gate: bool = True, win_off: int = 0):
    """Run K ticks of the megakernel in one launch of K4, K the length of
    ``due_block`` (int32, the due counts of the block's ticks). ``carry``
    is a ``core.megakernel.MegaCarry`` of CUDA tensors; every leaf is
    updated in place and the returned carry holds the same tensors with
    the tick counter advanced by K. A batch's carry ([B, ...] leaves, the
    schedule and law config of ``params`` [B, N, ...], ``due_block``
    [B, K], rows of a wider table allowed) launches B blocks, one per
    scenario; the topology is shared. ``gate=False`` runs the admit/retire
    pass and the contributor lists' rebuild on every tick. ``win_off`` is
    the global index of the first schedule row of ``params`` (a chunk
    window's base; 0 for the whole schedule). The tensors are
    checked and the argument struct filled on a run's first launch
    (``_launch_args``). Returns (carry', ``BlockRecords`` of every
    ``record_every``-th tick — [B, nrec, ...] for a batch — or None)."""
    st = carry.state
    dev = st.w.device
    K = int(due_block.shape[-1])
    re = max(int(record_every), 1)
    if record and K % re:
        raise ValueError(f"fused_tick_block: K ({K}) must be a multiple of "
                         f"record_every ({re})")
    args, lead = _launch_args(params, carry)
    if not 0 <= int(win_off) <= params.N:
        raise ValueError(f"fused_tick_block: a window offset of {win_off} "
                         f"in a schedule of {params.N} flows")
    i32, f32 = torch.int32, torch.float32
    # the due counts: each scenario's K contiguous, rows of any stride
    if (due_block.dtype != i32 or due_block.device != dev
            or tuple(due_block.shape) != lead + (K,)
            or (K > 1 and due_block.stride(-1) != 1)):
        raise ValueError(f"fused_tick_block: due_block must be int32 "
                         f"{lead + (K,)} on {dev} with contiguous rows")
    S, Q1 = int(st.w.shape[-1]), params.Q + 1
    nrec = K // re if record else 0
    recs = BlockRecords(
        t=torch.empty(lead + (nrec,), dtype=f32, device=dev),
        q=torch.empty(lead + (nrec, Q1), dtype=f32, device=dev),
        w_sum=torch.empty(lead + (nrec,), dtype=f32, device=dev),
        thru=torch.empty(lead + (nrec, Q1), dtype=f32, device=dev),
        lam=torch.empty(lead + (nrec,), dtype=f32, device=dev),
        lam_f=torch.empty(lead + (nrec, S), dtype=f32, device=dev),
        n_active=torch.empty(lead + (nrec,), dtype=i32, device=dev))
    args.due = due_block.data_ptr()
    args.due_stride = int(due_block.stride(0)) if lead else K
    for name in BlockRecords._fields:
        setattr(args, "rec_" + name, getattr(recs, name).data_ptr())
    args.K, args.t0, args.record_every = K, int(st.t), re
    args.record, args.gate = int(bool(record)), int(bool(gate))
    args.win_off = int(win_off)
    if K:
        lib = _lib(params.law)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_tick_block_f32(ctypes.byref(args), stream)
        _build.check(err, "fused_tick_block")
        _build.LAUNCHES["fused_tick_block"] += 1
    carry = carry._replace(state=st._replace(t=int(st.t) + K))
    return carry, (recs if record else None)


def powf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``powf(x, y)`` elementwise, compiled into K4's library with its
    flags: the pow of DCQCN's K4 routine, to hold against ``torch.pow``
    on the card (CUDA float32 tensors of one shape; not a K4 launch)."""
    _build.check_tensors("fused_tick_powf", {"x": x, "y": y},
                         {"x": tuple(x.shape), "y": tuple(x.shape)},
                         x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().fused_tick_powf(x.data_ptr(), y.data_ptr(),
                                     out.data_ptr(), x.numel(), stream)
    _build.check(err, "fused_tick_powf")
    return out


def schedule(sched: torch.Tensor, t0: int, T: int, dt: float,
             prebuffer: torch.Tensor):
    """K4's evaluation of a batch of circuit schedules (``sched`` [B, 6],
    ``TickParams.sched``'s layout) over ticks ``t0 .. t0 + T - 1``,
    compiled into K4's library with its flags: (the VOQ's rate [B, T] as
    K4 sets it, and reTCP's scaling flag [B, T] — up at ``t +
    prebuffer[b]`` or at ``t`` — as uint8). Not a K4 launch."""
    B = int(sched.shape[0])
    _build.check_tensors(
        "fused_tick_schedule", {"sched": sched, "prebuffer": prebuffer},
        {"sched": (B, len(SCHED_FIELDS)), "prebuffer": (B,)}, sched.device)
    bw = torch.empty((B, T), dtype=torch.float32, device=sched.device)
    on = torch.empty((B, T), dtype=torch.uint8, device=sched.device)
    with torch.cuda.device(sched.device):
        stream = torch.cuda.current_stream(sched.device).cuda_stream
        err = _lib().fused_tick_schedule(
            sched.data_ptr(), prebuffer.data_ptr(), bw.data_ptr(),
            on.data_ptr(), B, int(t0), int(T), float(dt), stream)
    _build.check(err, "fused_tick_schedule")
    return bw, on


def impair(imp: torch.Tensor, t0: int, T: int, dt: float):
    """K4's evaluation of an impairment regime (``imp``, ``TickParams.
    impair``'s layout: int32 [10, Q], or [B, 10, Q] one per scenario)
    over ticks ``t0 .. t0 + T - 1``, compiled into K4's library with its
    flags: each queue's (rate, survival fraction, jitter), each [B, T, Q]
    float32 (B = 1 for a shared regime). Not a K4 launch."""
    nf = len(IMPAIR_FIELDS)
    Q = int(imp.shape[-1])
    B = 1 if imp.dim() == 2 else int(imp.shape[0])
    _build.check_tensors("fused_tick_impair", {"imp": imp},
                         {"imp": tuple(imp.shape[:-2]) + (nf, Q)},
                         imp.device, dtypes={"imp": torch.int32})
    out = [torch.empty((B, T, Q), dtype=torch.float32, device=imp.device)
           for _ in range(3)]
    with torch.cuda.device(imp.device):
        stream = torch.cuda.current_stream(imp.device).cuda_stream
        err = _lib().fused_tick_impair(
            imp.data_ptr(), nf * Q, B, Q, int(t0), int(T), float(dt),
            *[x.data_ptr() for x in out], stream)
    _build.check(err, "fused_tick_impair")
    return tuple(out)
