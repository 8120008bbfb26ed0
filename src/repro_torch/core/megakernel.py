"""Whole-tick megakernel backend of the flow-slot engine (twin of
``repro.core.megakernel``).

``simulate_slots(..., backend="megakernel")`` runs the slot engine in
blocks of K ticks (``kernels.fused_tick.DEFAULT_BLOCK``). The tick is
``repro``'s ``make_tick``, with the same restructurings of the slot tick:

  * the admit/retire pass is gated: it runs only on ticks where an arrival
    is due and not yet admitted, or a slot is freeable; the due counts of
    the whole trace come from one host ``searchsorted`` (``_due_table``);
  * completions park in a per-slot pending buffer (``PendingFCT``) and go
    to the [N] FCT table when their slot is recycled, or at the end;
  * Dynamic-Thresholds caps fold each switch's queues in ascending order
    over a static table (``fluid._buffer_caps``, the port's form of
    ``repro``'s ``build_switch_csr``/``_buffer_caps_csr``);
  * the queue arrivals sum through an in-order gather table over the hop
    list of the pool, rebuilt only when the admission cursor moves, with
    an in-order walk of the hop list for a queue whose degree outgrows the
    table's width (``build_csr_gather``'s overflow flag);
  * queue length, egress rate and queue gradient share one packed
    telemetry ring row ``[q | out | qdot]``, the gradient computed when
    the row is written, so the delayed observation reads one ring; the
    feedback channels a law declares append their columns,
    ``[.. | pause? | inc?]`` (``ring_channels``), so the columns before
    them never move;
  * a time-varying bandwidth (``bw_fn``, with ``bw_params`` per scenario)
    is evaluated once per tick and read by every phase of it; so is a
    per-link impairment regime (``sim.impair``, ``core/impair.py``): its
    rates, the survival fractions that scale each queue's accumulated
    arrivals and each slot's goodput, and the jitter added to each hop's
    q / b in the RTT sums.

Two lowerings, chosen by ``impl``:

  * ``"torch"``: the plain version, the tick below as eager PyTorch ops,
    looped per tick (``kernels.ref.fused_tick_block_ref``). It is the
    counterpart of ``repro``'s XLA lowering, and what the CPU runs;
  * ``"cuda"``: K4 (``kernels/fused_tick.py``, ``csrc/fused_tick.cu``), one
    launch per block of K ticks, with the busy tick (gated or not, as the
    plain tick) and each law's arithmetic written by hand (the 13 laws
    of ``core/laws.py``, ``core/rdcn.py`` and ``core/feedback.py``,
    ``K4_LAWS``, with the hop clock and the pause and incast channels of
    the feedback laws; a ``Law`` around another update raises). The host
    uploads the due table once and reads nothing back between blocks.
    K4 evaluates a circuit schedule in its own body every tick
    (``rdcn.circuit_bw_at`` with ``bw_params``, or
    ``CircuitSchedule.bw_fn()``; any other ``bw_fn`` raises there), and
    each queued link's capacity, loss and jitter processes under a
    regime (its hash, epochs and selects as ``core/impair.py`` has them).

The carry is a batch's, as the slot engine's is ([B, ...] leaves; one
schedule runs as a batch of one). K4 takes it in one launch of B thread
blocks, one scenario each; the plain tick runs every op over the batch,
and the admit/retire pass on a tick where any scenario needs it (exact
for the others: the pass changes nothing in a scenario with nothing due
and nothing freeable). Scenarios share nothing, so a scenario's
trajectory is its own run's whatever the batch.

Both produce the reference backend's trajectories bit for bit: queue
trace, FCTs, windows, per-slot rates and rings
(``tests/test_torch_megakernel.py``; K4 on the card in ``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops, ref
from ..kernels import fused_tick as _k4
from ..kernels.fused_tick import DEFAULT_BLOCK, TickParams
from ..kernels.queue_arrivals import (build_csr_gather, csr_gather_arrivals,
                                      integrate_arrivals, max_degree,
                                      suggest_maxdeg)
from ..kernels.queue_arrivals import apply_loss
from . import fluid
from . import laws as _laws
from . import rdcn
from .impair import ImpairmentParams, impair_vectors
from .types import MTU, PathObs, Record, SlotState, cat_trees

_INT32_MAX = np.iinfo(np.int32).max

# laws with a K4 path: name -> (reference update K4 carries, law id)
K4_LAWS = {name: (_laws.LAWS[name].update, i)
           for i, name in enumerate(_k4.LAW_NAMES)}


class PendingFCT(NamedTuple):
    """Completions awaiting their write into the FCT table; ``flow == N``
    marks an empty lane."""
    flow: torch.Tensor              # [B, S] int32 schedule index (N = empty)
    val: torch.Tensor               # [B, S] float32 completion time


def ring_channels(law) -> int:
    """Columns of the packed ring, in units of Q+1: ``[q | out | qdot]``,
    then the pause state (``uses_pause``) and the sender count
    (``uses_incast``) where the law declares them."""
    return 3 + int(law.uses_pause) + int(law.uses_incast)


class MegaCarry(NamedTuple):
    """Carry of the megakernel: the ``SlotState`` (its ``hist_q`` holds the
    packed [D, nchan(Q+1)] ring ``[q | out | qdot | pause? | inc?]``,
    ``ring_channels``; ``hist_out``, ``hist_pause``, ``hist_inc`` and the
    reference backend's ``inv`` ride as None), the pending FCTs, the
    per-slot drain hold, and the in-order gather table with its overflow
    flag. The hold and the table change only on admit/retire ticks."""
    state: SlotState
    pend: PendingFCT
    hold: torch.Tensor              # [B, S] int32 largest valid hop delay
    inv: torch.Tensor               # [B, Q+1, maxdeg] int32 gather table
    ovf: torch.Tensor               # [B] bool: some queue exceeds maxdeg


def _due_table(sched, steps: int, dt: float) -> np.ndarray:
    """[B, T] int32 due-arrival counts on the host: ``due[b, t]`` is the
    number of scenario b's schedule entries with ``start <= t*dt``
    (float32), the count the slot engine's admission takes at tick t."""
    t_sec = np.arange(steps, dtype=np.int32).astype(np.float32) \
        * np.float32(dt)
    return np.stack([np.searchsorted(row, t_sec, side="right")
                     for row in sched.start.cpu().numpy().astype(np.float32)
                     ]).astype(np.int32)


def _suggest_maxdeg(sched, num_queues: int, slots: int) -> int:
    """The gather table's width for a batch: the largest of its
    scenarios' ``suggest_maxdeg``."""
    return max(suggest_maxdeg(p, num_queues, slots)
               for p in sched.path.cpu().numpy())


def _flush_pending(fct: torch.Tensor, pend: PendingFCT, mask, N: int):
    """Write the masked pending completions into ``fct`` (in place; [B,
    N+1], other rows land on the drop cell N) and empty their lanes."""
    fluid._put(fct, torch.where(mask, pend.flow, N),
               torch.where(mask, pend.val, float("nan")))
    pend = PendingFCT(torch.where(mask, N, pend.flow),
                      torch.where(mask, float("nan"), pend.val))
    return fct, pend


def _per_flow(x, B: int, n: int, dev) -> torch.Tensor:
    """A batch's law-config field (a scalar, per scenario [B, 1] or per
    flow [B, n]) as a contiguous float32 [B, n] tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(
        B, n).contiguous()


def _k4_config(name: str, lcfg, B: int, n: int, dev) -> dict:
    """The per-flow law config K4 reads for law ``name`` (its
    ``LAW_CONFIG`` fields), each a contiguous float32 [B, n] tensor
    rounded as the plain law rounds it: gamma and 1 - gamma from a Python
    gamma as float32(gamma) and float32(1.0 - gamma), from a tensor in
    float32; TIMELY's thresholds and step by ``laws.timely_params``."""
    gamma = lcfg.gamma
    t_low, t_high, tadd = (_laws.timely_params(lcfg) if name == "timely"
                           else (None, None, None))
    vals = dict(beta=lcfg.beta, ctau=lcfg.tau, gamma=gamma,
                omg=1.0 - gamma, hbw=lcfg.host_bw, t_low=t_low,
                t_high=t_high, tadd=tadd)
    return {f: _per_flow(vals[f], B, n, dev) for f in _k4.LAW_CONFIG[name]}


def _k4_lawp(lcfg, B: int, dev) -> tuple:
    """The per-scenario law constants of K4 ([B, len(LAW_PARAMS)] float32,
    ``fused_tick.LAW_PARAMS``) and the three divisor modes, of
    ``hpcc_eta``, the marking span and ``fncc_eta`` (1: a tensor leaf,
    divided; 0: a Python scalar, multiplied by its float32 reciprocal,
    ``laws.div_config``). Each derived constant is rounded as
    the plain law rounds it (Python arithmetic in double for Python
    scalars, float32 ops for tensor leaves); reTCP's schedule
    (``LawConfig.sched``, zeros without one) and prebuffer as float32. A
    leaf that varies per flow raises."""
    span = lcfg.dcqcn_kmax - lcfg.dcqcn_kmin
    span = (torch.clamp_min(span, 1.0) if isinstance(span, torch.Tensor)
            else max(span, 1.0))

    def inv(x):
        if isinstance(x, torch.Tensor):
            return 1.0 / x.to(torch.float32)
        return float(np.float32(1.0) / np.float32(x))

    sched = lcfg.sched if lcfg.sched is not None else \
        rdcn.ScheduleParams(*[0.0] * len(rdcn.ScheduleParams._fields))
    vals = {f"retcp_{f}": getattr(sched, f)
            for f in rdcn.ScheduleParams._fields}
    vals.update(hpcc_eta=lcfg.hpcc_eta, hpcc_inv_eta=inv(lcfg.hpcc_eta),
                hpcc_max_stage=lcfg.hpcc_max_stage,
                timely_beta=lcfg.timely_beta,
                timely_hai_n=lcfg.timely_hai_n, dcqcn_kmin=lcfg.dcqcn_kmin,
                dcqcn_span=span, dcqcn_inv_span=inv(span),
                dcqcn_pmax=lcfg.dcqcn_pmax, dcqcn_g=lcfg.dcqcn_g,
                dcqcn_omg=1.0 - lcfg.dcqcn_g, dcqcn_rai=lcfg.dcqcn_rai,
                dcqcn_rai_hyper=5.0 * lcfg.dcqcn_rai,
                dcqcn_timer=lcfg.dcqcn_timer,
                dcqcn_cnp_timer=lcfg.dcqcn_cnp_timer,
                dcqcn_f=lcfg.dcqcn_f, reno_md=lcfg.reno_md,
                retcp_prebuffer=lcfg.retcp_prebuffer,
                fncc_eta=lcfg.fncc_eta, fncc_inv_eta=inv(lcfg.fncc_eta),
                pulser_n=lcfg.pulser_n, bp_xoff=lcfg.bp_xoff,
                bp_xon=lcfg.bp_xon, bp_md=lcfg.bp_md, pcc_eps=lcfg.pcc_eps,
                pcc_b=lcfg.pcc_b)
    cols = []
    for f in _k4.LAW_PARAMS:
        x = torch.as_tensor(vals[f], device=dev).to(torch.float32)
        if x.numel() not in (1, B):
            raise ValueError(f"the megakernel's K4 takes {f} per scenario; "
                             f"got a leaf of shape {tuple(x.shape)}")
        cols.append(x.reshape(-1).expand(B))
    return (torch.stack(cols, -1).contiguous(),
            int(isinstance(lcfg.hpcc_eta, torch.Tensor)),
            int(isinstance(span, torch.Tensor)),
            int(isinstance(lcfg.fncc_eta, torch.Tensor)))


def _k4_schedule(bw_fn, bw_params, B: int, Q: int, dev):
    """The circuit schedule K4 evaluates in its body, [B, 6] float32 (the
    fields of ``rdcn.ScheduleParams``), or None without ``bw_fn``. K4
    carries ``rdcn.circuit_bw_at`` with stacked ``bw_params`` and
    ``CircuitSchedule.bw_fn()`` (which carries its params); any other
    ``bw_fn`` raises."""
    if bw_fn is None:
        return None
    if bw_fn is rdcn.circuit_bw_at and isinstance(bw_params,
                                                  rdcn.ScheduleParams):
        p = bw_params
    elif bw_params is None and isinstance(getattr(bw_fn, "params", None),
                                          rdcn.ScheduleParams):
        p = bw_fn.params
    else:
        raise NotImplementedError(
            "the CUDA megakernel's K4 carries the circuit schedule only "
            "(bw_fn=rdcn.circuit_bw_at with bw_params=stack_schedules(...), "
            "or CircuitSchedule.bw_fn()); run another bw_fn on "
            "backend='reference'")
    if Q != 1:
        raise ValueError(f"a circuit schedule serves one VOQ; the topology "
                         f"has {Q} queues")
    cols = []
    for x in p:
        x = torch.as_tensor(x, device=dev).to(torch.float32).reshape(-1)
        if x.numel() not in (1, B):
            raise ValueError(f"a schedule leaf of {x.numel()} values for "
                             f"a batch of {B}")
        cols.append(x.expand(B))
    return torch.stack(cols, -1).contiguous()


def _k4_impair(impair, B: int, Q: int, dev):
    """A regime as K4 reads it: int32 [10, Q] (shared by the batch) or
    [B, 10, Q], the fields of ``ImpairmentParams`` in order, the floats as
    their bits and the seed as its uint32 bits; None without a regime."""
    if impair is None:
        return None
    rows = []
    for f, x in zip(ImpairmentParams._fields, impair):
        x = x.to(dev)
        if x.dtype == torch.float32:
            x = x.contiguous().view(torch.int32)
        elif f == "seed":
            x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
        rows.append(x.to(torch.int32))
    return torch.stack(rows, -2).contiguous()


def _k4_params(sim, maxdeg: int, bw_fn=None, bw_params=None) -> TickParams:
    """The read-only inputs of K4 for one run (``bw_fn``/``bw_params``:
    the run's bandwidth, ``_k4_schedule``; ``sim.impair``: its regime,
    ``_k4_impair``). The schedule rows are ``sim.sched``'s, a chunk
    window's on a chunk-streamed run (the same tensors, refilled in place
    each segment), and N the whole schedule's."""
    law = sim.law
    entry = K4_LAWS.get(law.name)
    if entry is None or law.update is not entry[0]:
        raise NotImplementedError(
            f"law '{law.name}' has no K4 path: the CUDA megakernel carries "
            f"{sorted(K4_LAWS)}, each through its registered update")
    topo, sched, cfg, static = sim.topo, sim.sched, sim.cfg, sim.static
    dev = sched.start.device
    B, N = int(sched.start.shape[0]), fluid._slot_n(sim)
    lawp, div_eta, div_span, div_fncc = _k4_lawp(sim.law_cfg, B, dev)

    def i32(x):
        return x.to(device=dev, dtype=torch.int32).contiguous()

    def f32(x):
        return x.to(device=dev, dtype=torch.float32).contiguous()

    sw_table = static.sw_table
    if sw_table is not None:
        sw_table = sw_table.to(torch.int32).contiguous()
    return TickParams(
        law=entry[1], N=N, Q=int(topo.num_queues), D=int(cfg.hist),
        maxdeg=int(maxdeg),
        nsw=0 if sw_table is None else sw_table.shape[0],
        swdeg=0 if sw_table is None else sw_table.shape[1],
        dt=float(np.float32(cfg.dt)),
        inv_dt=float(np.float32(1.0 / cfg.dt)),
        dt_alpha=float(np.float32(topo.dt_alpha)),
        update_period=float(np.float32(cfg.update_period)),
        div_eta=div_eta, div_span=div_span, div_fncc=div_fncc,
        s_path=i32(sched.path), s_tf=i32(sched.tf_steps),
        s_rtt=i32(sched.rtt_steps), s_tau=f32(sched.tau),
        s_nic=f32(sched.nic_rate), s_start=f32(sched.start),
        s_stop=f32(sched.stop), s_size=f32(sched.size),
        config=_k4_config(law.name, sim.law_cfg, B, N, dev), lawp=lawp,
        bw=f32(static.bw), buf=f32(static.buf), sw_table=sw_table,
        sched=_k4_schedule(bw_fn, bw_params, B, int(topo.num_queues), dev),
        impair=_k4_impair(sim.impair, B, int(topo.num_queues), dev),
        switch_buffer=f32(topo.switch_buffer),
        switch_of_queue=i32(topo.switch_of_queue))


def make_tick(sim, gate: bool = True, quiet: bool = False,
              maxdeg: Optional[int] = None, bw_fn=None,
              bw_params=None) -> Callable:
    """Build the plain megakernel tick of a batch (``sim`` a
    ``fluid.SlotSim``): ``tick(carry, due_t) -> (carry', Record)``,
    ``due_t`` the [B] int32 due counts of the tick.

    The arithmetic is ``fluid.slot_step``'s, with the restructurings of
    the module docstring; the law runs through ``sim.law.update`` against
    the slot-gathered config. ``gate`` runs the admit/retire pass only on
    ticks with an arrival due and not yet admitted or a slot freeable, in
    any scenario (without it, every tick). ``quiet`` short-circuits ticks
    with every pool empty and nothing due to the queue drain and the ring
    writes (exact for laws with ``masked_updates``). ``maxdeg`` overrides
    the gather table's width (default the batch's largest
    ``suggest_maxdeg``). ``bw_fn``/``bw_params`` are the batch's
    time-varying bandwidth, as ``fluid.simulate_slots_batch`` takes
    them; ``sim.impair`` its impairment regime.

    ``tick.init_carry(state0)`` builds the matching ``MegaCarry``;
    ``tick.k4_params()`` the inputs of K4 (raises for a law without a K4
    path); ``tick.gate`` is the ``gate`` K4 runs with.

    On a chunk window (``sim.win_off`` set, ``sim.sched`` the window's
    rows; the chunk loop passes the whole schedule's ``maxdeg``),
    ``tick.win_off`` is the window's global base, which the loop sets
    before each segment: the plain tick and K4 read the admitted rows at
    ``f - tick.win_off`` and the law config at ``f``. It is 0 on a
    whole-schedule run.
    """
    topo, cfg, law, static = sim.topo, sim.cfg, sim.law, sim.static
    sched = sim.sched
    dev = sched.start.device
    B = int(sched.start.shape[0])
    S = int(sim.slots)
    N = fluid._slot_n(sim)
    Q = int(topo.num_queues)
    Q1 = Q + 1
    D = int(cfg.hist)
    dt = cfg.dt
    if maxdeg is None:
        maxdeg = _suggest_maxdeg(sched, Q, S)
    nchan = ring_channels(law)
    off_pause = 3 * Q1
    off_inc = (3 + int(law.uses_pause)) * Q1
    sidx = torch.arange(S, device=dev)
    buf = static.buf
    bfn = fluid.batch_bw_fn(bw_fn, bw_params)
    impair = sim.impair

    def slot_hold(st):
        return torch.amax(torch.where(st.path < Q, st.tf_steps, 0), dim=-1)

    def gather_table(path):
        inv, ovf = build_csr_gather(path, Q, maxdeg)
        return inv.to(torch.int32), ovf

    def init_carry(state0: SlotState) -> MegaCarry:
        inv0, ovf0 = gather_table(state0.path)
        return MegaCarry(
            state=state0._replace(
                hist_q=torch.zeros((B, D, nchan * Q1), dtype=torch.float32,
                                   device=dev),
                hist_out=None, inv=None, incidence=None, hist_pause=None,
                hist_inc=None),
            pend=PendingFCT(
                torch.full((B, S), N, dtype=torch.int32, device=dev),
                torch.full((B, S), float("nan"), dtype=torch.float32,
                           device=dev)),
            hold=slot_hold(state0), inv=inv0, ovf=ovf0)

    def admit_retire(st, pend, inv, ovf, due_t):
        """Retire drained slots (flushing their parked FCTs), admit due
        arrivals, and rebuild the gather tables if a cursor moved (a
        scenario whose cursor did not move gets its table again)."""
        freeable = ((st.slot_flow < N) & (st.t >= st.free_at) &
                    (pend.flow < N))
        fct, pend = _flush_pending(st.fct, pend, freeable, N)
        simw = (sim if sim.win_off is None
                else sim._replace(win_off=tick.win_off))
        st2, occupied = fluid._admit_retire(simw, st._replace(fct=fct),
                                            due_t)
        if bool(torch.any(st2.cursor > st.cursor)):
            inv, ovf = gather_table(st2.path)
        return st2, pend, occupied, slot_hold(st2), inv, ovf

    def integrate_queues(st, arr, bw, inc=None):
        """The queue integration at the tick's rates ``bw`` and the packed
        telemetry row, the gradient computed over the operands the slot
        engine subtracts when it reads the ring; then the declared
        channels: the pause hysteresis on the integrated queues and the
        sender counts ``inc``. Returns (q_new, out, row, the new pause
        state or None)."""
        caps = fluid._buffer_caps(topo, st.q, static)
        out, q_new = integrate_arrivals(arr, st.q, bw, caps, dt=dt)
        parts = [q_new, out, (q_new - st.q) * (1.0 / dt)]
        pause_new = None
        if law.uses_pause:
            pause_new = fluid._pause_step(q_new, st.pause, sim.law_cfg)
            parts.append(pause_new)
        if law.uses_incast:
            parts.append(inc)
        return q_new, out, torch.cat(parts, -1), pause_new

    def window_clamp(w, nic, tau, theta_now):
        return torch.minimum(torch.clamp_min(w, MTU),
                             8.0 * nic * tau + 8.0 * nic * theta_now)

    def theta_of(st, q, bw, jit):
        """tau plus each valid hop's q / b and, under a regime, its
        jitter."""
        valid = st.path < Q
        qb = fluid._take(q, st.path) / fluid._hop_bw(bw, st.path)
        if jit is not None:
            qb = qb + fluid._hop_bw(jit, st.path)
        return st.tau + fluid._hop_sum(torch.where(valid, qb, 0.0))

    def quiet_tick(c, ptr, bw, jit):
        """Every pool empty, nothing due: the queues drain, the rings
        advance and the window clamp runs; nothing else can change."""
        st, pend, hold, inv, ovf = c
        # no slot sends: the sender counts are zero, and so are the
        # arrivals the loss would scale; the pause state follows the drain
        q_new, out, row, pause_new = integrate_queues(
            st, torch.zeros_like(st.q), bw,
            torch.zeros_like(st.q) if law.uses_incast else None)
        w = window_clamp(st.w, st.nic_rate, st.tau,
                         theta_of(st, st.q, bw, jit))
        lam = torch.zeros_like(st.w)
        st.hist_lam[:, ptr] = lam
        st.hist_w[:, ptr] = st.w
        st.hist_q[:, ptr] = row
        st = st._replace(t=st.t + 1, w=w, q=q_new, out_rate=out,
                         pause=pause_new)
        zero = torch.zeros((B,), dtype=torch.float32, device=dev)
        return (st, pend, hold, inv, ovf, zero, zero,
                torch.zeros((B,), dtype=torch.int32, device=dev), lam)

    def busy_tick(c, ptr, due_t, bw, keep, jit):
        st, pend, hold, inv, ovf = c
        t = st.t
        t_sec = fluid._tick_time(t, dt)
        need = (not gate) or bool(
            torch.any(due_t > st.cursor) |
            torch.any((st.slot_flow < N) & (t >= st.free_at)))
        if need:
            st, pend, occupied, hold, inv, ovf = admit_retire(
                st, pend, inv, ovf, due_t)
        else:
            occupied = st.slot_flow < N
        path, tf_steps, tau, nic = (st.path, st.tf_steps, st.tau,
                                    st.nic_rate)
        gf = torch.clamp(st.slot_flow, 0, N - 1)
        cfg_slot = fluid._gather_law_cfg(sim.law_cfg, gf, N)

        active = (occupied & (t_sec >= st.start) & (st.remaining > 0.0) &
                  (t_sec < st.stop))
        valid = path < Q
        b_hop = fluid._hop_bw(bw, path)
        theta_now = theta_of(st, st.q, bw, jit)
        lam = torch.where(active, torch.minimum(
            torch.minimum(st.w / theta_now, st.rate_cap), nic), 0.0)
        hist_lam, hist_w, hist_q = st.hist_lam, st.hist_w, st.hist_q
        hist_lam[:, ptr] = lam
        hist_w[:, ptr] = st.w

        # -- queue update: in-order gather table, or, when a queue outgrows
        #    the table, the in-order walk of the hop list (a table as wide
        #    as the busiest queue) -----------------------------------------
        lam_del = fluid._ring(hist_lam, torch.remainder(ptr - tf_steps, D),
                              sidx[:, None])
        lam_del = torch.where(t - tf_steps >= st.admit_t[..., None],
                              lam_del, 0.0)
        contrib = torch.where(valid, lam_del, 0.0)
        table = inv
        if bool(torch.any(ovf)):
            table, _ = build_csr_gather(path, Q, max_degree(path, Q))
        arr = csr_gather_arrivals(contrib, table, torch.zeros_like(st.q))
        if keep is not None:
            arr = apply_loss(arr, keep)
        inc = (fluid._incast_count(path, valid, lam_del, table, Q)
               if law.uses_incast else None)
        q_new, out, row, pause_new = integrate_queues(st, arr, bw, inc)
        hist_q[:, ptr] = row

        # -- delayed observation: one packed ring (the hop clock for
        #    congestion-point feedback) ------------------------------------
        tb_steps = fluid.feedback_delay(law, tf_steps, st.rtt_steps, D)
        ohidx = torch.remainder(ptr - tb_steps, D)
        q_obs = fluid._ring(hist_q, ohidx, path)
        mu = fluid._ring(hist_q, ohidx, path + Q1) if law.uses_mu else None
        qdot = (fluid._ring(hist_q, ohidx, path + 2 * Q1)
                if law.uses_qdot else None)
        ecn = (torch.amax(torch.where(
            valid, fluid._marking(q_obs, buf[path], cfg_slot), 0.0), dim=-1)
            if law.uses_ecn else None)
        qb_obs = q_obs / b_hop
        if jit is not None:
            qb_obs = qb_obs + fluid._hop_bw(jit, path)
        theta_obs = tau + fluid._hop_sum(torch.where(valid, qb_obs, 0.0))
        wold_delay = torch.clamp(torch.round(theta_obs / static.dt)
                                 .to(torch.int32), 1, D - 2)
        w_old = fluid._ring(hist_w, torch.remainder(ptr - wold_delay, D),
                            sidx)
        w_old = torch.where(t - wold_delay >= st.admit_t, w_old, nic * tau)
        upd = active & (t_sec >= st.next_update)
        dt_obs = torch.clamp_min(t_sec - st.last_update, dt)
        obs = PathObs(q=q_obs, qdot=qdot, mu=mu, b=b_hop, valid=valid,
                      theta=theta_obs, w_old=w_old, dt_obs=dt_obs,
                      ecn_frac=ecn,
                      pause=(fluid._ring(hist_q, ohidx, path + off_pause)
                             if law.uses_pause else None),
                      incast=(fluid._ring(hist_q, ohidx, path + off_inc)
                              if law.uses_incast else None))

        # -- control law (the registered reference update) ----------------
        law_state, w, rate_cap = law.update(
            st.law, obs, st.w, st.rate_cap, upd, cfg_slot, t_sec)
        w = window_clamp(w, nic, tau, theta_now)
        next_update = fluid._next_update(cfg, upd, t_sec, theta_now,
                                         st.next_update)
        last_update = torch.where(upd, t_sec, st.last_update)

        # -- progress; completions park in the pending buffer -------------
        remaining = torch.where(
            active, st.remaining - fluid._goodput(lam, keep, path, valid) * dt,
            st.remaining)
        done = active & (remaining <= 0.0)
        pend = PendingFCT(
            torch.where(done, st.slot_flow, pend.flow),
            torch.where(done, t_sec + tau / 2.0 - st.start, pend.val))
        expire = (occupied & (t_sec >= st.stop) &
                  (st.free_at == _INT32_MAX) & ~done)
        free_at = torch.where(done | expire, t + hold + 1, st.free_at)

        st = st._replace(
            t=t + 1, w=w, rate_cap=rate_cap, q=q_new, out_rate=out,
            remaining=remaining, free_at=free_at, next_update=next_update,
            last_update=last_update, law=law_state, pause=pause_new)
        return (st, pend, hold, inv, ovf,
                *fluid._record_sums(w, lam, active),
                torch.sum(active, dim=-1, dtype=torch.int32), lam)

    def tick(carry: MegaCarry, due_t):
        st = carry.state
        t_sec = fluid._tick_time(st.t, dt)
        ptr = st.t % D
        c = tuple(carry)
        bw = fluid._bandwidth(topo, bfn, t_sec, static, impair)
        keep, jit = (impair_vectors(t_sec, impair) if impair is not None
                     else (None, None))
        if (gate and quiet and law.masked_updates
                and bool(torch.all(due_t == st.cursor))
                and not bool(torch.any(st.slot_flow < N))):
            out = quiet_tick(c, ptr, bw, jit)
        else:
            out = busy_tick(c, ptr, due_t, bw, keep, jit)
        st, pend, hold, inv, ovf, w_sum, lam_sum, n_act, lam = out
        rec = Record(t=torch.full((B,), t_sec, dtype=torch.float32,
                                  device=dev),
                     q=st.q, w_sum=w_sum, thru=st.out_rate, lam=lam_sum,
                     lam_f=lam, n_active=n_act)
        return MegaCarry(st, pend, hold, inv, ovf), rec

    k4 = []

    def k4_params() -> TickParams:
        if not k4:
            k4.append(_k4_params(sim, maxdeg, bw_fn, bw_params))
        return k4[0]

    tick.init_carry = init_carry
    tick.k4_params = k4_params
    tick.maxdeg = maxdeg
    tick.gate = bool(gate)
    tick.win_off = 0 if sim.win_off is None else int(sim.win_off)
    return tick


def default_impl(device) -> str:
    """K4 (``"cuda"``) on the card, the plain tick (``"torch"``) on the
    CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _unpack_state(carry: MegaCarry, N: int, Q1: int, law=None) -> SlotState:
    """Final flush of the pending FCTs and the packed ring split back into
    the ``SlotState`` layout (with ``law``, the rings of its feedback
    channels too)."""
    st, pend = carry.state, carry.pend
    fct, _ = _flush_pending(st.fct, pend, pend.flow < N, N)
    ring = st.hist_q

    def cols(k):
        return ring[..., k * Q1:(k + 1) * Q1].contiguous()

    pause = law is not None and law.uses_pause
    incast = law is not None and law.uses_incast
    return st._replace(
        fct=fct, admitted=fluid._host_count(st.cursor), hist_q=cols(0),
        hist_out=cols(1), hist_pause=cols(3) if pause else None,
        hist_inc=cols(3 + int(pause)) if incast else None)


def block_size(steps: int, record_every: int = 1,
               block: Optional[int] = None) -> int:
    """Ticks per block: ``block`` (default ``DEFAULT_BLOCK``) clamped to the
    trace, and a multiple of ``record_every`` so every block records whole
    rows."""
    K = max(1, min(int(block) if block else DEFAULT_BLOCK, int(steps)))
    re = max(int(record_every), 1)
    if re > 1:
        K = max(re, K - K % re)
    return K


def run_blocks(tick, carry: MegaCarry, due: torch.Tensor, block: int,
               impl: str, record: bool = True, record_every: int = 1):
    """Advance ``carry`` over the ticks of ``due`` ([B, T], the device due
    table from the carry's tick on) in blocks of ``block`` ticks, the last
    block the remainder: K4 per block for ``impl="cuda"`` (one launch for
    the batch, ``kernels.ops``), the plain block for ``"torch"``. Returns
    (carry', Record [B, T, ...] or None)."""
    run_block = (ops.fused_tick_block if impl == "cuda"
                 else ref.fused_tick_block_ref)
    recs = []
    for lo in range(0, int(due.shape[-1]), block):
        carry, r = run_block(tick, carry, due[..., lo:lo + block],
                             record=record, record_every=record_every)
        if record:
            recs.append(r)
    if not record:
        return carry, None
    return carry, Record(*[torch.cat(list(x), dim=1) for x in zip(*recs)])


def simulate_slots_mega(sim, record: bool = True,
                        impl: Optional[str] = None,
                        block: Optional[int] = None, gate: bool = True,
                        quiet: bool = False, sequential: bool = False,
                        bw_fn=None, bw_params=None):
    """Run a batch of schedules (``sim`` a ``fluid.SlotSim``) through the
    megakernel backend, all scenarios with the batch's largest suggested
    gather-table width. Returns (final ``SlotState``, Record [B, T, ...]
    or None), the FCT table [B, N+1] (``fluid.simulate_slots_batch`` trims
    it).

    ``impl`` is ``"cuda"`` (K4, on CUDA tensors only) or ``"torch"`` (the
    plain tick); the default follows the device. ``block`` sets the ticks
    per block; ``T // K`` full blocks run, then one remainder block.
    ``sequential=False`` advances the whole batch per block (one K4 launch
    of B thread blocks per 64 ticks); ``sequential=True`` runs the
    scenarios one after another (one block per launch). ``gate`` goes to
    the plain tick (``make_tick``) and to K4, ``quiet`` to the plain tick
    only (K4 runs the busy tick); neither changes the results.
    ``bw_fn``/``bw_params`` as ``fluid.simulate_slots_batch`` takes them.
    """
    cfg = sim.cfg
    T = int(cfg.steps)
    re = max(int(cfg.record_every), 1) if record else 1
    if record and re > 1 and T % re:
        raise ValueError(f"steps ({T}) must be divisible by "
                         f"record_every ({re})")
    dev = sim.sched.start.device
    impl = impl or default_impl(dev)
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown megakernel impl {impl!r}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("impl='cuda' runs K4 and needs CUDA tensors; use "
                         "impl='torch' on the CPU")
    B = int(sim.sched.start.shape[0])
    Q = int(sim.topo.num_queues)
    maxdeg = _suggest_maxdeg(sim.sched, Q, sim.slots)
    due = torch.as_tensor(_due_table(sim.sched, T, cfg.dt), device=dev)
    K = block_size(T, re, block)
    parts = [(b, b + 1) for b in range(B)] if sequential else [(0, B)]
    finals, recs = [], []
    for lo, hi in parts:
        part = fluid.scenarios(sim, lo, hi)
        tick = make_tick(part, gate=gate, quiet=quiet, maxdeg=maxdeg,
                         bw_fn=bw_fn,
                         bw_params=fluid.part_of(bw_params, lo, hi))
        state0 = fluid.init_slot_state(part)
        fluid.audit_carry_dtypes(state0)
        carry, r = run_blocks(tick, tick.init_carry(state0), due[lo:hi], K,
                              impl, record, re)
        finals.append(_unpack_state(carry, fluid._slot_n(sim), Q + 1,
                                    sim.law))
        recs.append(r)
    return cat_trees(finals), (cat_trees(recs) if record else None)


__all__ = ["DEFAULT_BLOCK", "K4_LAWS", "MegaCarry", "PendingFCT",
           "block_size", "default_impl", "make_tick", "run_blocks",
           "simulate_slots_mega"]
