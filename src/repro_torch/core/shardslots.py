"""Single-scenario slot engine sharded over the ranks of a process group
(twin of ``repro.core.shardslots``).

Every other engine scales by batching scenarios; this one splits ONE
scenario's slot pool and queue-arrival accumulation over the ranks of a
``torch.distributed`` group (``core/shardcomm.py``: one process per rank,
each running the same host loop on its own slice), bit for bit the
reference slot engine (``fluid.slot_step``) for every rank count.

Replicated on every rank (identical computation per tick): the integer
admit/retire bookkeeping (``_admit_global``: ``slot_flow``, ``free_at``,
the cursor and high-water mark, [S]); the queue state ``q``/``out_rate``
and their rings [D, Q+1] (CSR layout: padded to ``q1p = Qb * ndev``, the
pad rows exactly 0.0), the pause and sender-count rings of a law that
declares them; the tick's rates, loss and jitter vectors (in the CSR
layout over several ranks each rank evaluates its queue block of the
regime, ``qid0`` offset, and one [3, Qb] all-gather assembles them).

Per rank, a contiguous block of Sl = S / ndev slots: the per-slot
metadata, window, rate and law state, the rings [D, Sl] and an FCT
buffer (each flow is admitted to one slot, so the buffers merge by
selecting the finite entry, ``_merge_fct``).

The queue-arrival sums: with S * H > 128 (``use_csr``) each rank owns a
block of Qb queue rows and replays its queues' add chains. On rebuild
ticks each rank sorts its hop list by destination block
(``_halo_send_tables``), one all-to-all moves the queue ids, and the
receive side inverts them into a [Qb, maxdeg] gather table
(``_halo_recv_csr``). Receipt is source-major and each source is sorted
by (queue, flat index), so each queue's chain is the reference gather's
ascending flat order. Steady ticks move the compacted contributions in
one all-to-all, integrate the block, and ONE packed all-gather carries
the queue blocks and the per-slot tail (retire/hold and the recorded
rows): two collectives a steady tick. A freshly admitted slot
contributes exactly +0.0 for its first min(tf) ticks, so the tables are
rebuilt on the first admission-dirty tick of each ``rb_every = min_tf +
1`` window. A destination block beyond ``cap`` rows or a queue beyond
``maxdeg`` contributors (agreed through ``ShardGroup.any``) drops the
ticks to the full gather of contributions and paths until the next
rebuild, bit for bit the same. Small pools keep the replicated in-order
gather of the whole pool: one packed all-gather (contributions and the
tail) a tick, and the paths on admission ticks.

``jax.lax.cond`` becomes a host branch: the admission pass (on ticks
with an arrival due and not yet admitted, as ``fluid.slot_step`` gates
it), the rebuild and the overflow route are decided from replicated host
values only (the tick, the schedule, the cursor read after an admission
pass, the agreed overflow flag read at a rebuild), so every rank takes
the same branch and meets the same collectives. Ring rows are written
when the tick's queues are known (every ring read is at least a tick in
the past). The state is returned whole on every rank: the per-rank slot
leaves are all-gathered once at the end into the [S] / [D, S] layout.

No float is reduced across ranks: every cross-rank value moves in
reference order and only the integer overflow flag is summed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..kernels.queue_arrivals import (apply_loss, build_csr_gather,
                                      csr_gather_arrivals,
                                      integrate_arrivals, max_degree,
                                      ordered_scatter_add, seg_ranks,
                                      stable_sort_ids, suggest_maxdeg)
from . import shardcomm
from .fluid import (_CHUNK_SEG_MAX, _INT32_MAX, _bandwidth, _buffer_caps,
                    _check_impair, _due_now, _fill_window, _gather_law_cfg,
                    _goodput, _hop_bw, _hop_sum, _host_window, _incast_count,
                    _law_init, _observe_update, _pause_step, _put, _record,
                    _resolve_law, _ring, _safe_ticks, _slot_n, _take,
                    _tick_time, _window_tensors, LawTick, audit_carry_dtypes,
                    make_slot_sim, resolve_devices)
from .impair import regime_at
from .laws import Law, LawConfig
from .types import (FlowSchedule, Record, SimConfig, SlotState, Topology,
                    batch_of_one, resolve_device, scenario, tree_map)


class ShardInfo(NamedTuple):
    """Static shard geometry of a run."""
    ndev: int
    Sl: int          # slots per rank (S / ndev)
    Qb: int          # queue rows per rank (Q+1 rounded up to ndev blocks)
    use_csr: bool    # small pools keep the replicated in-order gather
    maxdeg: int
    cap: int         # halo rows per (source rank, destination block)
    rb_every: int    # admission-batched rebuild cadence (<= min tf + 1)


class ShardGlob(NamedTuple):
    """Replicated tick state, identical on every rank ([1, ...]: a batch
    of one, the port's engine layout). ``t`` and ``admitted`` (the
    cursor's host copy) are host ints."""
    t: int
    admitted: int
    cursor: torch.Tensor         # [1]
    hw: torch.Tensor             # [1]
    slot_flow: torch.Tensor      # [1, S]
    free_at: torch.Tensor        # [1, S]
    q: torch.Tensor              # [1, q1p]
    out_rate: torch.Tensor       # [1, q1p]
    hist_q: torch.Tensor         # [1, D, q1p]
    hist_out: torch.Tensor       # [1, D, q1p]
    pause: Optional[torch.Tensor] = None        # like q (uses_pause)
    hist_pause: Optional[torch.Tensor] = None   # like hist_q
    hist_inc: Optional[torch.Tensor] = None     # like hist_q (uses_incast)


class ShardLoc(NamedTuple):
    """This rank's contiguous block of Sl slots ([1, Sl] leaves)."""
    w: torch.Tensor
    rate_cap: torch.Tensor
    remaining: torch.Tensor
    next_update: torch.Tensor
    last_update: torch.Tensor
    admit_t: torch.Tensor
    path: torch.Tensor           # [1, Sl, H]
    tf_steps: torch.Tensor       # [1, Sl, H]
    rtt_steps: torch.Tensor
    tau: torch.Tensor
    nic_rate: torch.Tensor
    start: torch.Tensor
    stop: torch.Tensor
    hist_lam: torch.Tensor       # [1, D, Sl]
    hist_w: torch.Tensor         # [1, D, Sl]
    law: tuple                   # law state of [1, Sl] leaves
    fct: torch.Tensor            # [1, N+1] this rank's buffer


class ShardCarry(NamedTuple):
    """The tick loop's carry. CSR layout: ``sel`` [ndev, cap] (send side),
    ``inv`` [Qb, maxdeg] (receive side), ``ovf`` the agreed overflow flag
    and ``rb_cur`` the cursor at the last rebuild (host values).
    Replicated layout: ``inv`` the [1, Q+1, maxdeg] gather table of the
    whole pool's ``path_full``, rebuilt on admission ticks."""
    g: ShardGlob
    l: ShardLoc
    inv: Optional[torch.Tensor] = None
    sel: Optional[torch.Tensor] = None
    ovf: bool = False
    rb_cur: int = 0
    path_full: Optional[torch.Tensor] = None


def _admit_global(simw, g: ShardGlob, due: torch.Tensor):
    """The replicated half of ``fluid._admit_retire``: the integer slot
    bookkeeping over the whole pool, identical on every rank. Returns the
    updated globals, the admit mask and the window / global schedule
    indices [1, S]; each rank applies the metadata gathers, resets and
    the law re-init to its own slice (``_admit_local``)."""
    S = int(g.slot_flow.shape[-1])
    N = _slot_n(simw)
    dev = g.slot_flow.device
    i32 = torch.int32
    sidx = torch.arange(S, dtype=i32, device=dev)
    occupied = g.slot_flow < N
    freeable = occupied & (g.t >= g.free_at)
    slot_flow = torch.where(freeable, N, g.slot_flow)
    occupied = slot_flow < N
    n_free = S - torch.sum(occupied, dim=-1, dtype=i32)
    n_admit = torch.minimum(due - g.cursor, n_free)
    free = ~occupied
    hw = g.hw[..., None]
    fresh = free & (sidx >= hw)
    n_fresh = torch.minimum(n_admit, torch.sum(fresh, dim=-1, dtype=i32))
    take_fresh = fresh & (torch.cumsum(fresh, -1, dtype=i32) - 1 <
                          n_fresh[..., None])
    recycled = free & (sidx < hw)
    take_rec = recycled & (torch.cumsum(recycled, -1, dtype=i32) - 1 <
                           (n_admit - n_fresh)[..., None])
    admit = take_fresh | take_rec
    rank = torch.cumsum(admit, -1, dtype=i32) - 1
    slot_flow = torch.where(admit, g.cursor[..., None] + rank, slot_flow)
    gf = torch.clamp(slot_flow, 0, N - 1)
    gw = gf if simw.win_off is None else torch.clamp(
        slot_flow - int(simw.win_off), 0,
        int(simw.sched.start.shape[-1]) - 1)
    g = g._replace(slot_flow=slot_flow, cursor=g.cursor + n_admit,
                   hw=g.hw + n_fresh,
                   free_at=torch.where(admit, _INT32_MAX, g.free_at))
    return g, admit, gw, gf


def _admit_local(simw, loc: ShardLoc, t: int, admit, gw, gf) -> ShardLoc:
    """This rank's slice of ``fluid._admit_retire``'s per-slot half: the
    admitted slots gather their flow's metadata and re-init window, timers
    and law state (``admit``/``gw``/``gf`` already sliced, [1, Sl])."""
    sched = simw.sched
    N = _slot_n(simw)

    def sel(new, old):
        return torch.where(
            admit.view(tuple(admit.shape) + (1,) * (old.dim() - admit.dim())),
            new, old)

    def take(x):
        return _take(x, gw)

    tau = sel(take(sched.tau), loc.tau)
    nic = sel(take(sched.nic_rate), loc.nic_rate)
    start = sel(take(sched.start), loc.start)
    fresh_law = _law_init(simw.law, tuple(gf.shape),
                          _gather_law_cfg(simw.law_cfg, gf, N))
    return loc._replace(
        admit_t=torch.where(admit, t, loc.admit_t),
        path=sel(take(sched.path), loc.path),
        tf_steps=sel(take(sched.tf_steps), loc.tf_steps),
        rtt_steps=sel(take(sched.rtt_steps), loc.rtt_steps),
        tau=tau, nic_rate=nic, start=start,
        stop=sel(take(sched.stop), loc.stop),
        w=sel(nic * tau, loc.w),
        rate_cap=torch.where(admit, float("inf"), loc.rate_cap),
        remaining=sel(take(sched.size), loc.remaining),
        next_update=sel(start + tau, loc.next_update),
        last_update=sel(start, loc.last_update),
        law=tree_map(sel, fresh_law, loc.law))


def _halo_send_tables(path_l: torch.Tensor, mi: ShardInfo, Q: int):
    """Route this rank's [Sl, H] hop list to the destination queue blocks.

    Returns ``(sel, qid, ovf)`` (int32, int32, bool): ``sel[d, j]`` is the
    local flat index of the j-th element bound for block d (sentinel
    ``Sl*H`` past the block's count: a +0.0 contribution), ``qid[d, j]``
    its row within block d (sentinel ``Qb``), ``ovf`` whether a block's
    count exceeds ``cap``. One stable sort by queue id orders the
    elements by (block, queue, flat index) at once; sentinel hops are
    dropped (their contributions are +0.0)."""
    Sl, H = (int(n) for n in path_l.shape)
    nnz_l = Sl * H
    Qpad = mi.Qb * mi.ndev
    dev = path_l.device
    i32 = torch.int32
    flatq = torch.where(path_l < Q, path_l, Qpad).reshape(-1).to(i32)
    sq, order = stable_sort_ids(flatq, Qpad)
    dest = torch.div(sq, mi.Qb, rounding_mode="floor").contiguous()
    dix = torch.arange(mi.ndev, dtype=i32, device=dev)
    starts = torch.searchsorted(dest, dix, right=False, out_int32=True)
    ends = torch.searchsorted(dest, dix, right=True, out_int32=True)
    cnt = ends - starts
    ovf = torch.any(cnt > mi.cap)
    j = torch.arange(mi.cap, dtype=i32, device=dev)
    pos = torch.clamp_max(starts[:, None] + j[None, :], nnz_l - 1).long()
    inside = j[None, :] < torch.clamp_max(cnt, mi.cap)[:, None]
    sel = torch.where(inside, order[pos], nnz_l).to(i32)
    qid = torch.where(inside, sq[pos] - dix[:, None] * mi.Qb,
                      mi.Qb).to(i32)
    return sel, qid, ovf


def _halo_recv_csr(rqid: torch.Tensor, mi: ShardInfo):
    """Invert the received [ndev, cap] halo row ids into this block's
    [Qb, maxdeg] gather table over the flat [ndev*cap] halo buffer
    (sentinel ``ndev*cap``, a +0.0 contribution). A stable sort by row
    id keeps, per queue, the source-major receipt order, which is the
    reference's ascending flat order. ``ovf``: some queue has more than
    ``maxdeg`` contributors."""
    R = mi.ndev * mi.cap
    sq, order = stable_sort_ids(rqid.reshape(R), mi.Qb)
    rank = seg_ranks(sq)
    real = sq < mi.Qb
    ovf = torch.any(real & (rank >= mi.maxdeg))
    cell = torch.where(real & (rank < mi.maxdeg),
                       sq * mi.maxdeg + torch.clamp_max(rank, mi.maxdeg - 1),
                       mi.Qb * mi.maxdeg).long()
    inv = torch.full((mi.Qb * mi.maxdeg + 1,), R, dtype=torch.int32,
                     device=rqid.device)
    inv[cell] = order.to(torch.int32)
    return inv[:-1].reshape(mi.Qb, mi.maxdeg), ovf


def _block_caps_tables(topo, mi: ShardInfo, q1p: int):
    """Static per-rank tables for block-local Dynamic-Thresholds caps
    (numpy, ``repro``'s values): ``swq[d]`` lists the queue ids of the
    switches whose queues block d holds, ascending (the reference fold's
    order; pads index an appended 0.0), ``swb[d]`` their shared buffers,
    ``locrow[d]`` each local queue's row in them and ``bufb[d]`` the
    per-queue hard caps (sentinel and pad rows 1e30)."""
    Q = int(topo.num_queues)
    Qb, ndev = mi.Qb, mi.ndev
    sw = topo.switch_of_queue.cpu().numpy().astype(np.int64)
    nsw = int(topo.num_switches)
    sbuf = np.broadcast_to(topo.switch_buffer.cpu().numpy()
                           .astype(np.float32), (nsw,))
    buf = topo.buffer.cpu().numpy().astype(np.float32)
    counts = np.bincount(sw, minlength=nsw)
    deg = int(counts.max()) if counts.size else 0
    full = np.full((nsw, max(deg, 1)), q1p, np.int32)
    order = np.argsort(sw, kind="stable")
    col = np.concatenate([np.arange(c) for c in counts]) \
        if counts.size else np.zeros((0,), np.int64)
    full[sw[order], col] = order.astype(np.int32)
    per_dev = [np.unique(sw[d * Qb:min((d + 1) * Qb, Q)])
               if d * Qb < Q else np.zeros((0,), sw.dtype)
               for d in range(ndev)]
    nswm = max(1, max(len(p) for p in per_dev))
    swq = np.full((ndev, nswm, max(deg, 1)), q1p, np.int32)
    swb = np.zeros((ndev, nswm), np.float32)
    locrow = np.zeros((ndev, Qb), np.int32)
    bufb = np.full((ndev, Qb), 1e30, np.float32)
    for d, sws in enumerate(per_dev):
        swq[d, :len(sws)] = full[sws]
        swb[d, :len(sws)] = sbuf[sws]
        g = np.arange(d * Qb, d * Qb + Qb)
        real = g < Q
        gr = g[real]
        locrow[d, real] = np.searchsorted(sws, sw[gr]).astype(np.int32)
        bufb[d, real] = buf[gr]
    return swq, swb, locrow, bufb


def _block_caps(topo, tabs, q_full: torch.Tensor, did: int,
                gidx: torch.Tensor) -> torch.Tensor:
    """Block ``did``'s slice of ``fluid._buffer_caps`` from the replicated
    depths ``q_full`` [q1p] (``tabs``: ``_block_caps_tables`` as tensors
    on the run's device): the same values, O(block) work."""
    swq, swb, locrow, bufb = tabs
    bufb_d = bufb[did]
    if topo.dt_alpha <= 0:
        return bufb_d
    qp = torch.cat([q_full, q_full.new_zeros(1)])
    m = qp[swq[did].long()]                           # [nswm, deg]
    used = torch.zeros_like(m[..., 0])
    for col in m.unbind(-1):
        used = used + col
    free = torch.clamp_min(swb[did] - used, 0.0)
    thr = topo.dt_alpha * free[locrow[did].long()]
    return torch.where(gidx < int(topo.num_queues),
                       torch.minimum(thr, bufb_d), bufb_d)


def _merge_fct(fct_parts: torch.Tensor) -> torch.Tensor:
    """[ndev, N] per-rank FCT buffers -> [N]: each flow is admitted to one
    rank's slot, so at most one row of a column is finite; select it (no
    arithmetic; an all-NaN column stays NaN)."""
    out = fct_parts[0]
    for part in fct_parts[1:]:
        out = torch.where(torch.isnan(out), part, out)
    return out


def _regime_vectors(simw, mi: ShardInfo, q1p: int, blk0: int, t_sec,
                    bw_fn, group):
    """(bw, keep, jit) of the tick, [Q+1] each with the sentinel's
    identities (keep/jit None without a regime): the values of
    ``fluid._bandwidth`` and ``impair_vectors``, the three draws hashed in
    one pass (``impair.regime_at``). In the CSR layout over several ranks
    each rank evaluates its queue block of the regime (``qid0`` offset:
    the full evaluation's values) and one [3, Qb] all-gather assembles
    the vectors; otherwise every rank evaluates the whole regime."""
    topo, static, Q = simw.topo, simw.static, int(simw.topo.num_queues)
    imp = simw.impair
    if imp is None:
        return _bandwidth(topo, bw_fn, t_sec, static), None, None
    if mi.use_csr and mi.ndev > 1:
        pz = tree_map(lambda a: torch.cat(
            [a, a.new_zeros(q1p - Q)])[blk0:blk0 + mi.Qb], imp)
        rows = group.all_gather(torch.stack(regime_at(t_sec, pz, blk0)))
        full = rows.transpose(0, 1).reshape(3, q1p)[:, :Q]
    else:
        full = regime_at(t_sec, imp)
    return (torch.cat([full[0], static.bw[-1:]]),
            torch.cat([full[1], full[1].new_ones(1)]),
            torch.cat([full[2], full[2].new_zeros(1)]))


def _shard_tick(simw, mi: ShardInfo, rank: int, carry: ShardCarry, tabs,
                bw_fn, record: bool, group):
    """One tick on this rank: ``fluid.slot_step`` operation for operation,
    each local float computation an elementwise or gather slice of the
    single-pool one, every cross-rank value moved in reference order.
    Returns (new carry, Record [1, ...] or None)."""
    g, loc = carry.g, carry.l
    topo, cfg, law, static = simw.topo, simw.cfg, simw.law, simw.static
    N = _slot_n(simw)
    D, dt = cfg.hist, cfg.dt
    Q = int(topo.num_queues)
    Sl, ndev = mi.Sl, mi.ndev
    S = Sl * ndev
    off, blk0 = rank * Sl, rank * mi.Qb
    q1p = int(g.q.shape[-1])
    t = g.t
    t_sec = _tick_time(t, dt)
    ptr = t % D
    dev = g.q.device
    bw, keep, jit = _regime_vectors(simw, mi, q1p, blk0, t_sec, bw_fn,
                                    group)

    # -- admit / retire on ticks with an arrival due and not admitted:
    #    the replicated bookkeeping, then this rank's slice --------------
    due = _due_now(simw, t_sec)
    inv, sel_t, ovf, rb_cur = carry.inv, carry.sel, carry.ovf, carry.rb_cur
    path_full = carry.path_full
    admitted = g.admitted
    if due[0] > admitted:
        g, admit, gw, gf = _admit_global(
            simw, g, torch.as_tensor(due, dtype=torch.int32, device=dev))
        sl = slice(off, off + Sl)
        loc = _admit_local(simw, loc, t, admit[:, sl], gw[:, sl], gf[:, sl])
        admitted = int(g.cursor[0])
        g = g._replace(admitted=admitted)
        if not mi.use_csr:
            path_full = group.all_gather(loc.path[0], tiled=True)[None]
            inv = build_csr_gather(path_full, Q, max_degree(
                path_full, Q))[0].to(torch.int32)
    slot_flow_l = g.slot_flow[:, off:off + Sl]
    free_at_l = g.free_at[:, off:off + Sl]
    occ_l = slot_flow_l < N
    path, tf_steps, tau, nic = loc.path, loc.tf_steps, loc.tau, loc.nic_rate

    # -- halo tables, rebuilt on the first admission-dirty tick of each
    #    rb_every window (a fresh slot sends +0.0 until then) --------------
    if mi.use_csr and admitted > rb_cur and t % mi.rb_every == 0:
        sel_t, qid, ovf_cap = _halo_send_tables(path[0], mi, Q)
        inv, ovf_deg = _halo_recv_csr(group.all_to_all(qid), mi)
        ovf = group.any(ovf_cap | ovf_deg)
        rb_cur = admitted

    # -- instantaneous RTT and send rates (this rank's slots) ---------------
    sidx = torch.arange(Sl, device=dev)
    active = (occ_l & (t_sec >= loc.start) & (loc.remaining > 0.0) &
              (t_sec < loc.stop))
    valid = path < Q
    q_hop = _take(g.q, path)
    b_hop = _hop_bw(bw, path)
    qb_now = q_hop / b_hop
    jit_hop = None if jit is None else _hop_bw(jit, path)
    if jit_hop is not None:
        qb_now = qb_now + jit_hop
    theta_now = tau + _hop_sum(torch.where(valid, qb_now, 0.0))
    lam = torch.where(active, torch.minimum(
        torch.minimum(loc.w / theta_now, loc.rate_cap), nic), 0.0)
    hist_lam, hist_w = loc.hist_lam, loc.hist_w
    hist_lam[..., ptr, :] = lam
    hist_w[..., ptr, :] = loc.w
    lam_del = _ring(hist_lam, torch.remainder(ptr - tf_steps, D),
                    sidx[:, None])
    lam_del = torch.where(t - tf_steps >= loc.admit_t[..., None], lam_del,
                          0.0)
    contrib = torch.where(valid, lam_del, 0.0)

    # -- delayed observation and the law update (every ring read is at
    #    least a tick old, so this tick's queue rows are not needed) ------
    law_state, w, rate_cap, next_update, last_update = _observe_update(
        law, static, cfg, LawTick(
            t=t, t_sec=t_sec, ptr=ptr, hist_q=g.hist_q, hist_out=g.hist_out,
            hist_w=hist_w, rows=sidx, path=path, valid=valid, bw=bw,
            b_hop=b_hop, tf_steps=tf_steps, rtt_steps=loc.rtt_steps,
            tau=tau, nic=nic, theta_now=theta_now, active=active, w=loc.w,
            rate_cap=loc.rate_cap, law_state=loc.law,
            next_update=loc.next_update, last_update=loc.last_update,
            law_cfg=simw.law_cfg, admit_t=loc.admit_t,
            slot_flow=slot_flow_l, n_flows=N, hist_pause=g.hist_pause,
            hist_inc=g.hist_inc, jit_hop=jit_hop))

    # -- flow progress; FCTs into this rank's buffer ------------------------
    remaining = torch.where(active,
                            loc.remaining - _goodput(lam, keep, path,
                                                     valid) * dt,
                            loc.remaining)
    done = active & (remaining <= 0.0)
    fct = loc.fct
    _put(fct, torch.where(done, slot_flow_l, N), torch.where(
        done, t_sec + tau / 2.0 - loc.start, float("nan")))
    hold = torch.amax(torch.where(valid, tf_steps, 0), dim=-1)
    expire = (occ_l & (t_sec >= loc.stop) & (free_at_l == _INT32_MAX) &
              ~done)
    # the per-slot tail: retire/hold (exact in float32: hold <= D - 2)
    # and the recorded rows
    trows = [(done | expire).to(torch.float32)[0],
             hold.to(torch.float32)[0]]
    if record:
        trows += [lam[0], active.to(torch.float32)[0],
                  torch.where(active, w, 0.0)[0]]
    k = len(trows)
    tail_l = torch.stack(trows).reshape(-1)

    # -- queue update --------------------------------------------------------
    inc_now = None
    if mi.use_csr:
        if ovf:
            ab = _full_rows(contrib[0], path[0], law, mi, q1p, blk0, group)
        else:
            ab = _halo_rows(contrib[0], sel_t, inv, law, mi, group)
        gidx = blk0 + torch.arange(mi.Qb, dtype=torch.int32, device=dev)
        pad = q1p - (Q + 1)
        blk = slice(blk0, blk0 + mi.Qb)
        bw_b = torch.cat([bw, bw.new_zeros(pad)])[blk]
        if tabs[0].shape[2] <= 64:
            caps_b = _block_caps(topo, tabs, g.q[0], blk0 // mi.Qb, gidx)
        else:    # a pathological switch degree: the replicated caps
            caps = _buffer_caps(topo, g.q[:, :Q + 1], static)[0]
            caps_b = torch.cat([caps, caps.new_full((pad,), 1e30)])[blk]
        q_b = g.q[0, blk]
        arr_b = ab[0]
        if keep is not None:
            arr_b = apply_loss(arr_b, torch.cat([keep,
                                                 keep.new_ones(pad)])[blk])
        qn_b = torch.minimum(torch.clamp_min(q_b + (arr_b - bw_b) * dt,
                                             0.0), caps_b)
        out_b = torch.where(q_b > 0.0, bw_b, torch.minimum(arr_b, bw_b))
        qn_b = torch.where(gidx >= Q, 0.0, qn_b)
        brows = [qn_b, out_b] + ([ab[1]] if law.uses_incast else [])
        nb = len(brows)
        # ONE packed all-gather: the queue blocks and the slot tail
        gg = group.all_gather(torch.cat([torch.stack(brows).reshape(-1),
                                         tail_l]))
        rows = (gg[:, :nb * mi.Qb].reshape(ndev, nb, mi.Qb)
                .transpose(0, 1).reshape(nb, q1p))
        tail = (gg[:, nb * mi.Qb:].reshape(ndev, k, Sl).transpose(0, 1)
                .reshape(k, S))
        q_new, out = rows[0][None], rows[1][None]
        if law.uses_incast:
            inc_now = rows[2][None]
    else:
        gg = group.all_gather(torch.cat([contrib.reshape(-1), tail_l]))
        nc = Sl * int(path.shape[-1])
        contrib_f = gg[:, :nc].reshape(1, -1)
        tail = (gg[:, nc:].reshape(ndev, k, Sl).transpose(0, 1)
                .reshape(k, S))
        caps = _buffer_caps(topo, g.q, static)
        arr = csr_gather_arrivals(contrib_f, inv, torch.zeros_like(g.q))
        if law.uses_incast:
            inc_now = _incast_count(path_full, path_full < Q,
                                    contrib_f.reshape(path_full.shape), inv,
                                    Q)
        if keep is not None:
            arr = apply_loss(arr, keep)
        out, q_new = integrate_arrivals(arr, g.q, bw, caps, dt=dt)

    # -- rings and feedback channels (replicated) ---------------------------
    g.hist_q[..., ptr, :] = q_new
    g.hist_out[..., ptr, :] = out
    pause_new = None
    if law.uses_pause:
        pause_new = _pause_step(q_new, g.pause, simw.law_cfg)
        g.hist_pause[..., ptr, :] = pause_new
    if law.uses_incast:
        g.hist_inc[..., ptr, :] = inc_now
    free_at = torch.where(tail[0] > 0.0,
                          t + tail[1].to(torch.int32) + 1, g.free_at[0])

    new = ShardCarry(
        g=g._replace(t=t + 1, q=q_new, out_rate=out, free_at=free_at[None],
                     pause=pause_new),
        l=loc._replace(w=w, rate_cap=rate_cap, remaining=remaining,
                       next_update=next_update, last_update=last_update,
                       hist_lam=hist_lam, hist_w=hist_w, law=law_state,
                       fct=fct),
        inv=inv, sel=sel_t, ovf=ovf, rb_cur=rb_cur, path_full=path_full)
    rec = None
    if record:
        rec = _record(t_sec, q_new[:, :Q + 1], tail[4][None],
                      out[:, :Q + 1], tail[2][None], tail[3][None] > 0.0)
    return new, rec


def _halo_rows(contrib_l, sel_t, inv, law: Law, mi: ShardInfo, group):
    """[nb, Qb] this block's arrival sums (and sender counts) through the
    halo: the compacted rows bound for each block, one all-to-all, and
    the in-order gather of the received buffer."""
    pad = torch.cat([contrib_l.reshape(-1), contrib_l.new_zeros(1)])
    send = pad[sel_t.long()]                          # [ndev, cap]
    if law.uses_incast:
        send = torch.cat([send, (send > 0.0).to(torch.float32)], 1)
    recv = group.all_to_all(send)
    zero = contrib_l.new_zeros(1, mi.Qb)
    inv_b = inv[None]
    rows = [csr_gather_arrivals(recv[:, :mi.cap].reshape(1, -1), inv_b,
                                zero)[0]]
    if law.uses_incast:
        rows.append(csr_gather_arrivals(recv[:, mi.cap:].reshape(1, -1),
                                        inv_b, zero)[0])
    return torch.stack(rows)


def _full_rows(contrib_l, path_l, law: Law, mi: ShardInfo, q1p: int,
               blk0: int, group):
    """The overflow route: the whole pool's contributions and paths in one
    all-gather (paths as float32, exact below 2^24) and the in-order sum
    of every queue, of which this block's rows are kept."""
    n = int(contrib_l.numel())
    gg = group.all_gather(torch.cat([contrib_l.reshape(-1),
                                     path_l.reshape(-1).to(torch.float32)]))
    contrib = gg[:, :n].reshape(-1, int(path_l.shape[-1]))
    path = gg[:, n:].reshape(contrib.shape).to(torch.int32)
    zero = contrib.new_zeros(q1p)
    rows = [ordered_scatter_add(zero, path, contrib)]
    if law.uses_incast:
        rows.append(ordered_scatter_add(zero, path,
                                        (contrib > 0.0).to(torch.float32)))
    return torch.stack(rows)[:, blk0:blk0 + mi.Qb]


def _init_carry(simw, mi: ShardInfo) -> ShardCarry:
    """``fluid.init_slot_state`` split into the replicated and the
    per-rank halves (the same inert values). The halo tables start
    all-sentinel: the pool is empty until the first admission, whose
    rebuild comes before any contribution turns nonzero."""
    topo, cfg, law = simw.topo, simw.cfg, simw.law
    S = int(simw.slots)
    N = _slot_n(simw)
    H = int(simw.sched.path.shape[-1])
    Q = int(topo.num_queues)
    D = cfg.hist
    Sl = mi.Sl
    q1p = mi.Qb * mi.ndev if mi.use_csr else Q + 1
    dev = simw.sched.start.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    inf = float("inf")

    def zeros(*shape):
        return torch.zeros((1,) + shape, **f32)

    g = ShardGlob(
        t=0, admitted=0, cursor=torch.zeros(1, **i32),
        hw=torch.zeros(1, **i32), slot_flow=torch.full((1, S), N, **i32),
        free_at=torch.zeros(1, S, **i32), q=zeros(q1p),
        out_rate=zeros(q1p), hist_q=zeros(D, q1p), hist_out=zeros(D, q1p),
        pause=zeros(q1p) if law.uses_pause else None,
        hist_pause=zeros(D, q1p) if law.uses_pause else None,
        hist_inc=zeros(D, q1p) if law.uses_incast else None)
    pool = (1, Sl)
    tau0 = torch.full(pool, 20e-6, **f32)
    nic0 = torch.full(pool, 1e9, **f32)
    w0 = nic0 * tau0
    cfg0 = _gather_law_cfg(simw.law_cfg, torch.zeros(pool, **i32), N)
    loc = ShardLoc(
        w=w0, rate_cap=torch.full(pool, inf, **f32),
        remaining=torch.full(pool, inf, **f32),
        next_update=torch.full(pool, inf, **f32),
        last_update=torch.zeros(pool, **f32),
        admit_t=torch.zeros(pool, **i32),
        path=torch.full(pool + (H,), Q, **i32),
        tf_steps=torch.ones(pool + (H,), **i32),
        rtt_steps=torch.ones(pool, **i32), tau=tau0, nic_rate=nic0,
        start=torch.full(pool, inf, **f32), stop=torch.full(pool, inf, **f32),
        hist_lam=torch.zeros(1, D, Sl, **f32),
        hist_w=w0[:, None, :].expand(1, D, Sl).clone(),
        law=_law_init(law, pool, cfg0),
        fct=torch.full((1, N + 1), float("nan"), **f32))
    if mi.use_csr:
        return ShardCarry(
            g=g, l=loc,
            inv=torch.full((mi.Qb, mi.maxdeg), mi.ndev * mi.cap, **i32),
            sel=torch.full((mi.ndev, mi.cap), Sl * H, **i32))
    path_full = torch.full((1, S, H), Q, **i32)
    inv = build_csr_gather(path_full, Q, 1)[0].to(torch.int32)
    return ShardCarry(g=g, l=loc, inv=inv, path_full=path_full)


def _shard_geometry(sched_np, S: int, Q: int, ndev: int) -> ShardInfo:
    """Static shard geometry (``repro``'s): the halo capacity ~2x the
    uniform per-(source, destination-block) element count (more skew
    takes the bit-identical full gather until the next rebuild), the
    rebuild cadence bounded by the schedule's smallest forward hop
    delay."""
    H = int(sched_np.path.shape[1])
    use_csr = S * H > 128
    nnz = S * H
    Sl = S // ndev
    if not use_csr:
        return ShardInfo(ndev=ndev, Sl=Sl, Qb=-(-(Q + 1) // ndev),
                         use_csr=False, maxdeg=1, cap=1, rb_every=1)
    cap = min(Sl * H, max(8, ((2 * nnz // (ndev * ndev)) + 7) // 8 * 8))
    validm = np.asarray(sched_np.path) < Q
    tfv = np.asarray(sched_np.tf_steps)[validm]
    min_tf = int(tfv.min()) if tfv.size else 1
    return ShardInfo(ndev=ndev, Sl=Sl, Qb=-(-(Q + 1) // ndev),
                     use_csr=True,
                     maxdeg=suggest_maxdeg(sched_np.path, Q, S),
                     cap=cap, rb_every=int(min(64, max(1, min_tf + 1))))


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def shard_geometry(sched, slots: int, num_queues: int,
                   devices: int) -> ShardInfo:
    """The ``ShardInfo`` a ``simulate_slots_sharded`` run over ``devices``
    ranks uses for this schedule (host arithmetic only); feed it to
    ``comm_census``."""
    sched_np = FlowSchedule(*[_host(x) for x in sched])
    return _shard_geometry(sched_np, int(slots), int(num_queues),
                           int(devices))


def comm_census(mi: ShardInfo, S: int, H: int, Q: int,
                record: bool = True, uses_incast: bool = False) -> dict:
    """``repro``'s analytic per-steady-tick communication table of the
    sharded tick: exchanges per tick and float32 payload bytes per rank
    per tick for each, the rebuild cadence and bytes, and the pre-diet
    layout (a full [S, H] contribution gather plus three per-slot
    gathers) as the baseline."""
    f32 = 4
    k = 5 if record else 2
    if not mi.use_csr:
        ex = [("contrib_gather", mi.ndev * mi.Sl * H * f32),
              ("path_gather", mi.ndev * mi.Sl * H * f32),
              ("tail_gather", mi.ndev * k * mi.Sl * f32)]
    else:
        width = mi.cap * (2 if uses_incast else 1)
        nb2 = 3 if uses_incast else 2
        ex = [("halo_all_to_all", mi.ndev * width * f32),
              ("packed_gather",
               mi.ndev * (nb2 * mi.Qb + k * mi.Sl) * f32)]
    old = (mi.ndev * (mi.Sl * H + 2 * mi.Sl) * f32 +
           mi.ndev * mi.Qb * f32 + mi.ndev * 2 * mi.Sl * f32 +
           (mi.ndev * mi.Sl * f32 if record else 0))
    total = sum(b for _, b in ex)
    return {
        "exchanges_per_tick": len(ex),
        "bytes_per_tick": total,
        "bytes_per_exchange": dict(ex),
        "rebuild_every": mi.rb_every,
        "rebuild_bytes": (mi.ndev * mi.cap * f32 if mi.use_csr else 0),
        "baseline_exchanges_per_tick": 4 if record else 3,
        "baseline_bytes_per_tick": old,
    }


def _gather_slots(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """A per-rank slot leaf ([..., Sl at ``axis``, ...]) all-gathered into
    the whole pool's [..., S, ...] (ranks hold contiguous blocks)."""
    moved = x.movedim(axis, 0).contiguous()
    return group.all_gather(moved, tiled=True).movedim(0, axis).contiguous()


# the last run's statistics, kept up to date as it runs (read by
# ``chip_smoke.py``): the tick loop's collectives (not the final
# assembly's), ticks, segments, rebuilds, overflow ticks and geometry
LAST_SHARDED: dict = {}


def simulate_slots_sharded(topo: Topology, sched: FlowSchedule,
                           law_name: Union[str, Law], slots: int,
                           law_cfg: Optional[LawConfig] = None,
                           cfg: Optional[SimConfig] = None,
                           bw_fn=None, record: bool = True, devices=None,
                           chunk: Optional[int] = None, impair=None,
                           group=None, device="cuda"):
    """Run one schedule with its slot pool sharded over the ranks of a
    process group, on ``device``: ``fluid.simulate_slots``'s contract and
    results, bit for bit the reference slot engine for every rank count.
    Every rank of the group calls it with the same arguments and gets the
    whole result: (final ``SlotState``, ``Record`` or None), ``fct`` [N]
    in schedule order. The returned state has no gather table (``inv``
    None).

    ``group`` is a ``shardcomm.ShardGroup``; by default the initialized
    default group, else a one-rank group (``shardcomm.current_group``).
    ``devices``: None runs over the whole group; an int or ``"auto"``
    resolves as ``fluid.resolve_devices`` does and must then equal the
    group's size. ``slots`` must divide over the ranks, and ``record``
    records every tick (``record_every > 1`` raises ``ValueError``, as in
    ``repro``). ``chunk=C`` streams the schedule in C-row windows, as
    ``simulate_slots(..., chunk=)``. ``impair`` is a per-link regime ([Q]
    leaves), exclusive with ``bw_fn``."""
    cfg = cfg or SimConfig()
    _check_impair(impair, bw_fn, "reference")
    law = _resolve_law(law_name, "reference")
    dev = resolve_device(device)
    group = shardcomm.current_group(dev, group)
    ndev = group.world if devices is None else resolve_devices(devices,
                                                               group)
    if ndev != group.world:
        raise ValueError(f"devices={devices!r} resolves to {ndev} ranks; "
                         f"the run's process group has {group.world}")
    S = int(slots)
    if S % ndev:
        raise ValueError(f"slots={S} must divide over {ndev} devices")
    if record and int(cfg.record_every) > 1:
        raise ValueError("sharded runs record every tick; record_every "
                         "> 1 is not supported")
    sim = make_slot_sim(topo, batch_of_one(sched), law, S,
                        None if law_cfg is None else batch_of_one(law_cfg),
                        cfg, "reference", dev, impair=impair)
    sched_np = FlowSchedule(*[x[0].cpu().numpy().copy() for x in sim.sched])
    N = int(sched_np.start.shape[0])
    Q = int(topo.num_queues)
    T = int(cfg.steps)
    mi = _shard_geometry(sched_np, S, Q, ndev)
    q1p = mi.Qb * mi.ndev if mi.use_csr else Q + 1
    if q1p >= 1 << 24:
        raise ValueError(f"{Q} queues: the overflow route carries queue ids "
                         f"as float32, exact below 2^24")
    C = N if chunk is None else min(max(int(chunk), S), max(N, 1))
    start_np = np.asarray(sched_np.start, np.float32)
    tabs = None
    if mi.use_csr:
        tabs = tuple(torch.as_tensor(x, device=dev)
                     for x in _block_caps_tables(sim.topo, mi, q1p))

    win0 = _host_window(sched_np, 0, C, Q)
    simw = sim._replace(sched=_window_tensors(win0, dev), n_flows=N,
                        win_off=0, start_host=win0.start[None])
    stats = LAST_SHARDED
    stats.clear()
    stats.update(ndev=ndev, ticks=0, segments=0, rebuilds=0,
                 overflow_ticks=0, collectives=0, geometry=mi._asdict())
    calls0 = group.calls
    with torch.no_grad():
        carry = _init_carry(simw, mi)
        audit_carry_dtypes(carry)
        recs = []
        t0 = 0
        while t0 < T:
            w0 = carry.g.admitted
            safe = _safe_ticks(start_np, w0, C, t0, T, cfg.dt)
            if w0 + C >= N:
                L = T - t0
            else:
                allowed = max(1, min(max(safe, 1), T - t0, _CHUNK_SEG_MAX))
                L = 1 << (allowed.bit_length() - 1)
            win = _host_window(sched_np, w0, C, Q)
            _fill_window(simw.sched, win)
            simw = simw._replace(win_off=w0, start_host=win.start[None])
            for _ in range(L):
                rb = carry.rb_cur
                carry, rec = _shard_tick(simw, mi, group.rank, carry, tabs,
                                         bw_fn, record, group)
                stats["rebuilds"] += carry.rb_cur != rb
                stats["overflow_ticks"] += bool(carry.ovf)
                if record:
                    recs.append(rec)
            t0 += L
            stats["segments"] += 1
            stats["ticks"] = t0
            stats["collectives"] = group.calls - calls0
        state = _assemble(carry, mi, Q, N, group)
    recs = (Record(*[torch.stack(list(x), dim=1) for x in zip(*recs)])
            if record else None)
    return scenario(state, 0), (None if recs is None else scenario(recs, 0))


def _assemble(carry: ShardCarry, mi: ShardInfo, Q: int, N: int,
              group) -> SlotState:
    """The whole pool's ``SlotState`` (a batch of one) from every rank's
    slot block: one all-gather per slot leaf, the FCT buffers merged; the
    queue vectors cut back to Q+1."""
    g, loc = carry.g, carry.l

    def slots(x, axis=1):
        return _gather_slots(x, axis, group)

    fct = _merge_fct(group.all_gather(loc.fct[0]))[:N][None]
    q1 = slice(0, Q + 1)
    return SlotState(
        t=g.t, admitted=np.array([g.admitted], np.int64), cursor=g.cursor,
        hw=g.hw, slot_flow=g.slot_flow, admit_t=slots(loc.admit_t),
        free_at=g.free_at, path=slots(loc.path),
        tf_steps=slots(loc.tf_steps), rtt_steps=slots(loc.rtt_steps),
        tau=slots(loc.tau), nic_rate=slots(loc.nic_rate),
        start=slots(loc.start), stop=slots(loc.stop), w=slots(loc.w),
        rate_cap=slots(loc.rate_cap), q=g.q[:, q1],
        out_rate=g.out_rate[:, q1], hist_lam=slots(loc.hist_lam, 2),
        hist_q=g.hist_q[..., q1], hist_out=g.hist_out[..., q1],
        hist_w=slots(loc.hist_w, 2), remaining=slots(loc.remaining),
        next_update=slots(loc.next_update),
        last_update=slots(loc.last_update),
        law=tree_map(slots, loc.law), fct=fct, incidence=None, inv=None,
        pause=None if g.pause is None else g.pause[:, q1],
        hist_pause=None if g.hist_pause is None else g.hist_pause[..., q1],
        hist_inc=None if g.hist_inc is None else g.hist_inc[..., q1])
