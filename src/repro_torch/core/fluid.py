"""Vectorized fluid-model network simulator (twin of ``repro.core.fluid``).

Implements the paper's analytical model (Eqs. 4/9/10 and Appendix A) as a
host loop over time steps:

  queue dynamics    qdot_j = sum_i[i traverses j] lam_i(t - tf_i) - mu_j
  flow rates        lam_i  = min(w_i / theta_i, rate_cap_i, nic_i)
  measured RTT      theta_i = tau_i + sum_j on path q_j / b_j
  feedback delay    senders observe bottleneck state theta_i seconds late

Two engines, as in ``repro``: the padded engine (``simulate``) carries
every flow of a scenario through every tick; the flow-slot streaming
engine (``simulate_slots``) streams a time-sorted ``FlowSchedule`` through
a fixed pool of S slots, so per-tick cost is O(S * hops). With S >= N the
slot engine reproduces the padded engine's trajectories bit for bit.

Backends: ``"reference"`` (plain PyTorch, with the queue arrivals summed in
ascending flat order — bitwise ``repro``'s scatter, see
``kernels/queue_arrivals.py``), ``"fused"``, which sends the tick's
observation and law update through K1/K2 in their observe form (the
law's registered observe-and-update routine, ``laws.observe_step``) and
the queue update through K3, one launch each per tick on the card, or
``"megakernel"``: on the slot engine the whole-tick
engine of ``core/megakernel.py`` (K4, one launch per 64 ticks on the
card; its plain tick on the CPU), bit for bit the reference backend; on
the padded engine, as in ``repro``, the reference ops.

Batched scenario engine (``simulate_batch``, ``simulate_slots_batch``): a
sweep of B scenarios on one topology runs as one batch, with an explicit
leading batch axis on every carry leaf (the stacking helpers
``stack_flows``, ``stack_flow_schedules`` and ``stack_law_configs``
build it). The engines carry that axis always: ``simulate`` and
``simulate_slots`` run a batch of one (``types.batch_of_one``) and
return its scenario, bit for bit what a scenario gives in any batch.
``torch.vmap`` does not serve here: the slot engine's admit/retire gate
is host-side control flow.

The tick loop is a Python loop of eager PyTorch ops: ``repro``'s
``lax.scan`` has no counterpart. Tick counters live on the host, so the
loop indexes its ring buffers without reading anything back from the
card; the ring buffers (``hist_*``) and the slot engine's FCT table are
updated in place — they are the large part of the carry, and copying them
every tick would double the traffic. The slot engine runs its
admit/retire pass only on ticks where an arrival is due and not yet
admitted (the host knows the due count from the schedule, and reads the
admission cursor back after each pass), as ``repro``'s megakernel gates
it; retiring a drained slot later changes nothing, because its delayed
rates are exactly zero and a pass retires every drained slot before it
admits. A batch runs the pass for every scenario on a tick where any
scenario needs it (exact for the others, by the same argument: ``repro``'s
``slot_step`` runs it every tick). The reference backend rebuilds its
in-order gather table on those ticks too, reading back the largest live
queue degree. The padded engine's reference sums go through a table of
its live flows alike, rebuilt on the ticks where a flow starts
(``_live_gather_step``).

Time-varying bandwidth: ``bw_fn(t_sec)`` gives the queues' service
rates each tick ([Q], shared by the batch, or [B, Q]); the batched entry
points take ``bw_fn`` with ``bw_params`` (a tree of tensors with a
leading batch axis, e.g. ``rdcn.stack_schedules``), and scenario b then
runs at ``bw_fn(t, bw_params_b)``, evaluated for the whole batch in one
call. Every phase of a tick reads that tick's rates.

Feedback channels (the laws of ``core/feedback.py``): a law with
``feedback="hop"`` reads hop h's telemetry ``tf_h`` ticks old (the
congested switch notifies the sender over the reverse path) instead of
``rtt - tf_h``; ``uses_pause`` adds each queue's XON/XOFF state
(``_pause_step``) and ``uses_incast`` each queue's count of flows
sending into it (``_incast_count``), both written to rings of their own
every tick and observed at the delayed row. A law that declares none of
them carries none (``None`` leaves).

Per-link impairments (``core/impair.py``): ``impair`` (an
``ImpairmentParams``; ``impair_params`` on the batched entry points, a
regime per scenario or one shared) drives the tick's rates through
``_bandwidth``, folds the survival fraction ``keep`` into each queue's
accumulated arrivals (``apply_loss``) and, as a per-path product
(``_hop_keep``), into the goodput, and adds the jitter to each hop's
q / b in the RTT sums (on the padded engine only for flows that have
started: the slot engine holds a flow only from its start). The fused
backend rejects a regime (``UnsupportedFeature``), and ``bw_fn`` with
``impair`` raises ``ValueError``, as in ``repro``.

Chunk-streamed runs (``simulate_slots(..., chunk=C)``): the slot engine
reads the schedule through a C-row window that follows the admission
cursor (``SlotSim.win_off``, the window's global base; ``n_flows``, the
whole schedule's N), on the reference and megakernel backends, bit for
bit the single-shot run for every C. The segment boundaries are also
where checkpoints are written (``core/ckpt.py``, ``resume_slots``), the
divergence guard runs (``core/guard.py``) and injected crashes fire
(``core/faults.py``).

Allocators: ``alloc_fn(remaining, active, t_sec, flows, rate_cap)`` on the
padded engine (``simulate``, ``simulate_batch``; every padded backend)
replaces the rate caps for the next tick, after the law update and the
window clip and before flow progress, as in ``repro``
(``workload.homa_alloc_fn``, the paper's HOMA baseline). The slot path
rejects it (``ValueError``), as ``repro`` does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..kernels import ops
from . import shardcomm
from .faults import InjectedCrash, UnsupportedFeature
from ..kernels.queue_arrivals import (apply_loss, build_csr_gather,
                                      csr_gather_arrivals,
                                      integrate_arrivals, max_degree,
                                      one_hot_incidence, update_incidence)
from .impair import ImpairmentParams, impair_vectors, link_bw_at
from .laws import Law, LawConfig, div_config, get_law, observe_step
from .types import (MTU, CheckpointSpec, Flows, FlowSchedule, PathObs,
                    Record, SimConfig, SimState, SlotState, Topology,
                    batch_of_one, cat_trees, pad_hops, resolve_device,
                    scenario, stack_trees, tree_map)

_INT32_MAX = np.iinfo(np.int32).max


def _check_impair(impair, bw_fn, backend: str):
    """The entry points' check of a regime: the fused backend rejects
    impairments (its dense arrival sum reassociates the sums the loss fold
    scales), and ``bw_fn`` with ``impair`` would be two owners of one
    bandwidth vector."""
    if impair is None:
        return
    if backend == "fused":
        raise UnsupportedFeature(
            "impairments are not supported on the fused backend (its "
            "incidence matmul reassociates the arrival sums, so the "
            "bit-for-bit loss fold has no home there)",
            hint="use the reference or megakernel backend")
    if bw_fn is not None:
        raise ValueError("bw_fn and impair are mutually exclusive "
                         "bandwidth drivers (wrap the schedule as a "
                         "KIND_SCHEDULE impairment process instead)")


def default_law_config(flows, gamma: float = 0.9,
                       expected_flows: float = 1.0, **kw) -> LawConfig:
    """Paper parameterization: beta = HostBw * tau / N."""
    # a float32 tensor divisor: on the card a division by a Python scalar
    # becomes a reciprocal multiply, which ``repro`` does not do
    n = torch.tensor(expected_flows, dtype=torch.float32,
                     device=flows.tau.device)
    beta = flows.nic_rate * flows.tau / n
    return LawConfig(gamma=gamma, beta=beta, tau=flows.tau,
                     host_bw=flows.nic_rate, **kw)


def _hop_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (last) hop axis as a left-to-right chain — ``repro``'s
    fixed association; ``torch.sum`` would pick its own order."""
    cols = x.unbind(-1)
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


def _hop_keep(keep: torch.Tensor, path: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Each row's survival fraction: the product of ``keep`` ([Q+1] or
    [B, Q+1]) over its valid hops, left to right (``_hop_sum``'s fixed
    association); an invalid hop is exactly 1.0, so an all-ones ``keep``
    gives exactly 1.0."""
    k_hop = _hop_bw(keep, path)
    cols, ok = k_hop.unbind(-1), valid.unbind(-1)
    acc = torch.where(ok[0], cols[0], 1.0)
    for c, v in zip(cols[1:], ok[1:]):
        acc = acc * torch.where(v, c, 1.0)
    return acc


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order for ``jnp.sum``, which
    ``repro``'s record sums ``w_sum`` and ``lam`` take: while more than 32
    values are left, pad them with zeros to a multiple of 32 (half the
    pad, rounded down, in front) and sum each window of 32 left to right;
    then sum the rest left to right. ``torch.sum`` adds in its own order,
    one ulp away on some ticks. It runs only on recorded ticks; at the
    paper's 384 slots it is 42 adds (31 over 12 windows, then 11), so two
    such sums cost ~90 launches per recorded tick on the card."""
    n = int(x.shape[-1])
    while n > 32:
        m = -(-n // 32) * 32
        pad = m - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        cols = x.reshape(tuple(x.shape[:-1]) + (m // 32, 32)).unbind(-1)
        acc = cols[0]
        for c in cols[1:]:
            acc = acc + c
        x, n = acc, m // 32
    cols = x.unbind(-1)
    acc = cols[0]
    for c in cols[1:n]:
        acc = acc + c
    return acc


_BIDX: dict = {}


def _bidx(B: int, nd: int, device) -> torch.Tensor:
    """``arange(B)`` shaped [B, 1, ...] (``nd`` axes) to index the batch
    axis beside index tensors of ``nd`` axes; cached per device."""
    key = (B, nd, str(device))
    x = _BIDX.get(key)
    if x is None:
        x = torch.arange(B, device=device).view((B,) + (1,) * (nd - 1))
        _BIDX[key] = x
    return x


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for each scenario b of the batch: scenario b's
    rows of ``x`` [B, X] at scenario b's ``idx`` [B, ...]."""
    return x[_bidx(int(x.shape[0]), idx.dim(), x.device), idx]


def _ring(hist: torch.Tensor, rows: torch.Tensor,
          cols: torch.Tensor) -> torch.Tensor:
    """``hist[b, rows, cols]`` of a batch's rings [B, D, X]; ``rows`` and
    ``cols`` broadcast (per scenario, [B, ...], or shared)."""
    nd = max(rows.dim(), cols.dim())
    return hist[_bidx(int(hist.shape[0]), nd, hist.device), rows, cols]


def _put(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``table[b, idx[b]] = vals[b]`` for each scenario b (in place)."""
    table[_bidx(int(table.shape[0]), idx.dim(), table.device), idx] = vals


def _host_count(x: torch.Tensor) -> np.ndarray:
    """A batch's device counters [B] on the host."""
    return x.cpu().numpy().astype(np.int64)


def _law_init(law: Law, shape: tuple, cfg: LawConfig):
    """``law.init`` for per-flow shape ``shape`` ([B, F]): a law builds
    [F] leaves (or broadcasts against the batch's config); each is made
    ``shape``, contiguous and a tensor of its own (DCQCN's init returns
    one tensor for two leaves; K4 updates the carry in place). A state
    may nest (reTCP's holds NewReno's)."""
    st = law.init(int(shape[-1]), cfg)
    return tree_map(lambda x: x.expand(shape).clone(
        memory_format=torch.contiguous_format), st)


def _marking(q: torch.Tensor, buf: torch.Tensor, cfg: LawConfig,
             ) -> torch.Tensor:
    """ECN marking probability + hard mark when a hop's buffer is ~full."""
    def per_hop(x):
        # a stacked config's per-scenario leaf [B, 1] against [B, F, H]
        return x[..., None] if isinstance(x, torch.Tensor) else x

    # a stacked config's leaves subtract in float32, Python scalars in
    # double, as in ``repro``; the span divides as ``laws.div_config``
    kmin = per_hop(cfg.dcqcn_kmin)
    span = per_hop(cfg.dcqcn_kmax) - kmin
    span = (torch.clamp_min(span, 1.0) if isinstance(span, torch.Tensor)
            else max(span, 1.0))
    p = torch.clamp(div_config(q - kmin, span), 0.0,
                    1.0) * per_hop(cfg.dcqcn_pmax)
    hard = q >= 0.95 * buf
    return torch.where(hard, 1.0, p)


def _pause_step(q_new: torch.Tensor, pause: torch.Tensor,
                cfg: LawConfig) -> torch.Tensor:
    """Per-queue XON/XOFF hysteresis (laws with ``uses_pause``): pause
    rises at ``bp_xoff``, clears at ``bp_xon`` and holds in between, on
    the integrated queue level. Comparisons only, so every engine gets the
    same bits; a drained queue (q <= bp_xon) always clears, and the
    sentinel queue stays 0. A stacked config's per-scenario thresholds
    ([B, 1]) broadcast over the queues."""
    return torch.where(q_new >= cfg.bp_xoff, 1.0,
                       torch.where(q_new <= cfg.bp_xon, 0.0, pause))


def _incast_count(path: torch.Tensor, valid: torch.Tensor,
                  lam_del: torch.Tensor, inv: Optional[torch.Tensor],
                  num_queues: int) -> torch.Tensor:
    """Per-queue count of the flows whose delayed rate into it is
    positive (laws with ``uses_incast``), [B, Q+1]: 1.0 per sending hop,
    summed in order through the gather table ``inv`` (a table over the
    hop entries of ``path``, its senders included; built here if None).
    The counts are sums of ones, exact in any order; no scatter-add."""
    sending = torch.where(valid & (lam_del > 0.0), 1.0, 0.0)
    if inv is None:
        inv, _ = build_csr_gather(path, num_queues,
                                  max_degree(path, num_queues))
    zeros = sending.new_zeros(tuple(path.shape[:-2]) + (num_queues + 1,))
    return csr_gather_arrivals(sending, inv, zeros)


def _tick_time(t: int, dt: float) -> float:
    """``t * dt`` rounded in float32, as the engines of ``repro`` compute
    it; exact as a Python float, so it enters tensor ops unchanged."""
    return float(np.float32(t) * np.float32(dt))


class _Static(NamedTuple):
    """Per-topology constants of one run, built once before the loop."""
    bw: torch.Tensor                # [Q+1] service rates (sentinel 1e15)
    buf: torch.Tensor               # [Q+1] queue buffers (sentinel 1e30)
    sw_table: Optional[torch.Tensor]  # [switches, deg] queue ids (None: no DT)
    dt: torch.Tensor                # 0-dim float32 dt (a true divisor)


class FluidSim(NamedTuple):
    """A batch of scenarios ([B, F, ...] flows, a stacked law config) on
    one topology, bound to a backend. ``incidence`` is the [B, H, F, Q+1]
    one-hot path incidence of the fused queue kernel (fused backend);
    ``inv`` the [B, Q+1, maxdeg] in-order gather table of the reference
    queue update (reference backend; ``simulate_batch`` keeps it over the
    live flows, ``_live_gather_step``)."""
    topo: Topology
    flows: Flows
    law: Law
    law_cfg: LawConfig
    cfg: SimConfig
    backend: str = "reference"
    incidence: Optional[torch.Tensor] = None
    static: Optional[_Static] = None
    inv: Optional[torch.Tensor] = None
    impair: Optional[ImpairmentParams] = None   # [Q] or [B, Q] leaves


def build_incidence(flows: Flows, num_queues: int) -> torch.Tensor:
    """[B, H, F, Q+1] one-hot path incidence for the fused queue update;
    sentinel (padded) hops become all-zero rows."""
    return one_hot_incidence(flows.path, num_queues)


def init_state(sim: FluidSim) -> SimState:
    """The padded engine's initial carry: every leaf with the batch's
    leading axis."""
    topo, flows, cfg = sim.topo, sim.flows, sim.cfg
    lead = tuple(flows.tau.shape[:-1])
    F = flows.tau.shape[-1]
    Q = topo.num_queues
    D = cfg.hist
    dev = flows.tau.device
    f32 = dict(dtype=torch.float32, device=dev)
    w0 = flows.nic_rate * flows.tau          # cwnd_init = HostBw * tau
    return SimState(
        t=0,
        w=w0,
        rate_cap=torch.full(lead + (F,), float("inf"), **f32),
        q=torch.zeros(lead + (Q + 1,), **f32),
        out_rate=torch.zeros(lead + (Q + 1,), **f32),
        hist_lam=torch.zeros(lead + (D, F), **f32),
        hist_q=torch.zeros(lead + (D, Q + 1), **f32),
        hist_out=torch.zeros(lead + (D, Q + 1), **f32),
        hist_w=w0[..., None, :].expand(lead + (D, F)).clone(),
        remaining=flows.size.to(torch.float32),
        fct=torch.full(lead + (F,), float("nan"), **f32),
        next_update=flows.start + flows.tau,
        last_update=flows.start,
        law=_law_init(sim.law, lead + (F,), sim.law_cfg),
        **_channels(sim.law, lead, D, Q, dev),
    )


def _channels(law: Law, lead: tuple, D: int, Q: int, dev) -> dict:
    """The feedback-channel leaves of an initial carry: the pause state
    and its ring where the law declares ``uses_pause``, the sender-count
    ring where it declares ``uses_incast`` (None otherwise)."""
    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=dev)
    return dict(pause=zeros(Q + 1) if law.uses_pause else None,
                hist_pause=zeros(D, Q + 1) if law.uses_pause else None,
                hist_inc=zeros(D, Q + 1) if law.uses_incast else None)


def _static_bandwidth(topo: Topology) -> torch.Tensor:
    """[Q+1] the topology's per-queue service rates (sentinel appended)."""
    bw = topo.bandwidth
    return torch.cat([bw, bw.new_full((1,), 1e15)])


def _bandwidth(topo: Topology, bw_fn, t_sec: float,
               static: "_Static", impair=None) -> torch.Tensor:
    """The tick's per-queue service rates with the 1e15 sentinel appended:
    under a regime ``impair``, ``impair.link_bw_at``; else the topology's
    [Q+1] without ``bw_fn``; else ``bw_fn(t_sec)``. [Q+1] for a [Q]
    vector the batch shares, [B, Q+1] for one per scenario. A vector of
    another length raises."""
    if impair is not None:
        bw = link_bw_at(t_sec, impair)
    elif bw_fn is None:
        return static.bw
    else:
        bw = bw_fn(t_sec)
    Q = topo.num_queues
    if bw.dim() not in (1, 2) or bw.shape[-1] != Q:
        raise ValueError(f"bw_fn returned a vector of shape "
                         f"{tuple(bw.shape)}; the topology has {Q} queues")
    bw = bw.to(torch.float32)
    sentinel = static.bw[-1:]
    if bw.dim() == 1:
        return torch.cat([bw, sentinel])
    return torch.cat([bw, sentinel.expand(bw.shape[0], 1)], -1)


def _hop_bw(bw: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """Each hop's service rate: ``bw[path]``, per scenario for a [B, Q+1]
    ``bw``."""
    return bw[path] if bw.dim() == 1 else _take(bw, path)


def _switch_queue_table(sw: np.ndarray, num_switches: int) -> np.ndarray:
    """``[num_switches, max_deg]`` table of each switch's queue ids in
    ascending order, padded with ``len(sw)`` (the sentinel queue, always
    0.0). A column-wise fold over it replays ``repro``'s per-switch
    accumulation exactly (ascending queue order)."""
    counts = np.bincount(sw, minlength=num_switches)
    deg = int(counts.max()) if counts.size else 0
    tab = np.full((num_switches, deg), len(sw), dtype=np.int64)
    order = np.argsort(sw, kind="stable")   # per switch: queues ascending
    col = np.concatenate([np.arange(c) for c in counts]) \
        if counts.size else np.zeros((0,), np.int64)
    tab[sw[order], col] = order
    return tab


def _make_static(topo: Topology, dt: float) -> _Static:
    dev = topo.bandwidth.device
    buf = torch.cat([topo.buffer, topo.buffer.new_full((1,), 1e30)])
    sw_table = None
    if topo.dt_alpha > 0 and topo.num_queues:
        sw = topo.switch_of_queue.cpu().numpy().astype(np.int64)
        sw_table = torch.as_tensor(
            _switch_queue_table(sw, int(topo.num_switches)), device=dev)
    return _Static(bw=_static_bandwidth(topo), buf=buf, sw_table=sw_table,
                   dt=torch.tensor(dt, dtype=torch.float32, device=dev))


def _buffer_caps(topo: Topology, q: torch.Tensor,
                 static: _Static) -> torch.Tensor:
    """Per-queue caps; Dynamic Thresholds [17] when dt_alpha > 0. Each
    switch's occupancy is folded over its queues in ascending order, as
    ``repro`` accumulates it."""
    if static.sw_table is None:
        return static.buf
    m = q[..., static.sw_table]                 # [..., switches, deg]
    used = torch.zeros_like(m[..., 0])
    for col in m.unbind(-1):
        used = used + col
    free = torch.clamp_min(topo.switch_buffer - used, 0.0)
    thr = topo.dt_alpha * free[..., topo.switch_of_queue]
    return torch.cat([torch.minimum(thr, topo.buffer),
                      thr.new_full(tuple(thr.shape[:-1]) + (1,), 1e30)], -1)


def _queue_update(topo: Topology, dt: float, backend: str, incidence, inv,
                  q, lam_del, valid, static: _Static, bw: torch.Tensor,
                  keep=None):
    """Queue-arrival accumulation + integration at the tick's service
    rates ``bw`` ([Q+1], or [B, Q+1]): (arrivals, out, q_new).

    Reference backend: the masked per-hop rates summed per queue in
    ascending flat order through the gather table ``inv``, then scaled by
    the survival fractions ``keep`` under a regime (``apply_loss``, on
    the accumulated sums). Fused backend:
    K3 over the incidence (``out_rate=bw`` is exact there — when q == 0
    and arr < bw the clip at 0 reproduces ``out = min(arr, bw)``). A
    batch (leading axis on ``q``, ``lam_del``, ``inv``/``incidence``) is
    one gather, or one K3 launch.
    """
    caps = _buffer_caps(topo, q, static)
    if backend == "fused":
        arr, q_new = ops.queue_arrivals(
            lam_del.transpose(-1, -2).contiguous(), incidence, q, bw, caps,
            dt=dt)
        out = torch.where(q > 0.0, bw, torch.minimum(arr, bw))
        q_new[..., -1] = 0.0
        return arr, out, q_new
    contrib = torch.where(valid, lam_del, 0.0)
    arr = csr_gather_arrivals(contrib, inv, torch.zeros_like(q))
    if keep is not None:
        arr = apply_loss(arr, keep)
    out, q_new = integrate_arrivals(arr, q, bw, caps, dt=dt)
    return arr, out, q_new


def feedback_delay(law: Law, tf_steps, rtt_steps, D: int):
    """[.., H] ticks by which each hop's telemetry reaches the sender:
    ``rtt - tf_h`` for the receiver echo, ``tf_h`` for congestion-point
    feedback (``law.feedback == "hop"``), clamped to [1, D - 2]."""
    if law.feedback == "hop":
        return torch.clamp(tf_steps, 1, D - 2)
    return torch.clamp(rtt_steps[..., None] - tf_steps, 1, D - 2)


def _observe(law: Law, law_cfg: LawConfig, static: _Static, cfg: SimConfig,
             ptr: int, hist_q, hist_out, path, valid, tf_steps, rtt_steps,
             tau, b_hop, jit_hop=None):
    """Delayed INT observation of each hop (stamped when a segment
    dequeues there, back at the sender after ``feedback_delay``) and the
    RTT sample rebuilt from it, each hop's q / b plus its jitter
    ``jit_hop`` under a regime. Returns (q_obs, qdot, mu, ecn, theta_obs,
    wold_delay). Telemetry a law declares it does not read
    (``Law.uses_qdot``/``uses_mu``/``uses_ecn``) is left out (None)."""
    D, dt = cfg.hist, cfg.dt
    tb_steps = feedback_delay(law, tf_steps, rtt_steps, D)
    ohidx = torch.remainder(ptr - tb_steps, D)                # [F,H]
    q_obs = _ring(hist_q, ohidx, path)
    qdot = mu = ecn = None
    if law.uses_qdot:
        q_prev = _ring(hist_q, torch.remainder(ohidx - 1, D), path)
        qdot = (q_obs - q_prev) * (1.0 / dt)
    if law.uses_mu:
        mu = _ring(hist_out, ohidx, path)
    if law.uses_ecn:
        ecn = torch.amax(torch.where(
            valid, _marking(q_obs, static.buf[path], law_cfg), 0.0), dim=-1)
    qb_obs = q_obs / b_hop
    if jit_hop is not None:
        qb_obs = qb_obs + jit_hop
    theta_obs = tau + _hop_sum(torch.where(valid, qb_obs, 0.0))
    wold_delay = torch.clamp(torch.round(theta_obs / static.dt)
                             .to(torch.int32), 1, D - 2)
    return q_obs, qdot, mu, ecn, theta_obs, wold_delay


def _next_update(cfg: SimConfig, upd, t_sec: float, theta_now,
                 next_update):
    if cfg.update_period > 0.0:
        # fixed period: t_sec + period rounded in float32, as in ``repro``
        nxt = float(np.float32(t_sec) + np.float32(cfg.update_period))
        return torch.where(upd, nxt, next_update)
    return torch.where(upd, t_sec + theta_now, next_update)


class LawTick(NamedTuple):
    """What one tick's observation and law update read, per row [B, F]
    (flows on the padded engine, slots on the slot engine); the rings
    already hold this tick's row ``ptr``. ``law_cfg`` is the batch's
    config: per flow on the padded engine, per schedule entry on the slot
    engine, where ``slot_flow`` and ``n_flows`` (N) gather it into the
    slots. ``started`` (padded) holds the window of flows not yet started;
    ``admit_t`` (slot) dates each occupant's admission; ``bw`` is the
    tick's service rates, of which ``b_hop`` is gathered. ``hist_pause``
    and ``hist_inc`` are the feedback-channel rings of a law that
    declares them; ``jit_hop`` [B, F, H] the jitter each hop adds to the
    RTT sample under a regime."""
    t: int
    t_sec: float
    ptr: int
    hist_q: torch.Tensor            # [B, D, Q+1]
    hist_out: torch.Tensor          # [B, D, Q+1]
    hist_w: torch.Tensor            # [B, D, F]
    rows: torch.Tensor              # arange(F)
    path: torch.Tensor              # [B, F, H]
    valid: torch.Tensor             # [B, F, H] path < Q
    bw: torch.Tensor                # the tick's rates, [Q+1] or [B, Q+1]
    b_hop: torch.Tensor             # [B, F, H] bw[path]
    tf_steps: torch.Tensor          # [B, F, H]
    rtt_steps: torch.Tensor
    tau: torch.Tensor
    nic: torch.Tensor
    theta_now: torch.Tensor         # the instantaneous RTT
    active: torch.Tensor
    w: torch.Tensor
    rate_cap: torch.Tensor
    law_state: tuple
    next_update: torch.Tensor
    last_update: torch.Tensor
    law_cfg: LawConfig
    started: Optional[torch.Tensor] = None
    admit_t: Optional[torch.Tensor] = None
    slot_flow: Optional[torch.Tensor] = None
    n_flows: int = 0
    hist_pause: Optional[torch.Tensor] = None   # [B, D, Q+1] (uses_pause)
    hist_inc: Optional[torch.Tensor] = None     # [B, D, Q+1] (uses_incast)
    jit_hop: Optional[torch.Tensor] = None      # [B, F, H] (a regime)


def _law_tick(update, law: Law, static: _Static, cfg: SimConfig,
              x: LawTick):
    """One tick's delayed observation (``_observe``), ``w_old`` (on the
    slot engine the occupant's initial window where the ring row predates
    its admission), ``upd`` and ``dt_obs``, the law update ``update``, the
    window clamp, the padded engine's hold of flows not yet started and
    the update times. Returns (law state, w, rate_cap, next_update,
    last_update)."""
    D = cfg.hist
    law_cfg = x.law_cfg
    if x.slot_flow is not None:
        gf = torch.clamp(x.slot_flow, 0, x.n_flows - 1)
        law_cfg = _gather_law_cfg(law_cfg, gf, x.n_flows)
    q_obs, qdot, mu, ecn, theta_obs, wold_delay = _observe(
        law, law_cfg, static, cfg, x.ptr, x.hist_q, x.hist_out, x.path,
        x.valid, x.tf_steps, x.rtt_steps, x.tau, x.b_hop, x.jit_hop)
    w_old = _ring(x.hist_w, torch.remainder(x.ptr - wold_delay, D), x.rows)
    if x.admit_t is not None:
        w_old = torch.where(x.t - wold_delay >= x.admit_t, w_old,
                            x.nic * x.tau)
    upd = x.active & (x.t_sec >= x.next_update)
    dt_obs = torch.clamp_min(x.t_sec - x.last_update, cfg.dt)
    pause = incast = None
    if law.uses_pause or law.uses_incast:
        ohidx = torch.remainder(x.ptr - feedback_delay(
            law, x.tf_steps, x.rtt_steps, D), D)
        if law.uses_pause:
            pause = _ring(x.hist_pause, ohidx, x.path)
        if law.uses_incast:
            incast = _ring(x.hist_inc, ohidx, x.path)
    obs = PathObs(q=q_obs, qdot=qdot, mu=mu, b=x.b_hop, valid=x.valid,
                  theta=theta_obs, w_old=w_old, dt_obs=dt_obs, ecn_frac=ecn,
                  pause=pause, incast=incast)
    law_state, w, rate_cap = update(x.law_state, obs, x.w, x.rate_cap, upd,
                                    law_cfg, x.t_sec)
    w = torch.minimum(torch.clamp_min(w, MTU),
                      8.0 * x.nic * x.tau + 8.0 * x.nic * x.theta_now)
    if x.started is not None:
        # a flow that has not started holds its initial window, so the
        # slot engine's admission re-init lands on the same bits
        w = torch.where(x.started, w, x.w)
    next_update = _next_update(cfg, upd, x.t_sec, x.theta_now, x.next_update)
    last_update = torch.where(upd, x.t_sec, x.last_update)
    return law_state, w, rate_cap, next_update, last_update


def _observe_update(law: Law, static: _Static, cfg: SimConfig, x: LawTick):
    """The bound law's observe-and-update routine where it has one
    (``laws.observe_step``: the fused PowerTCP laws' K1/K2 observe
    kernels), else ``_law_tick`` with ``law.update``."""
    fn = observe_step(law)
    if fn is not None:
        return fn(law, static, cfg, x)
    return _law_tick(law.update, law, static, cfg, x)


def _record_sums(w, lam, active):
    """The records' ``w_sum`` (of the active rows' windows) and ``lam``,
    each in ``repro``'s order (``_xla_sum``), taken as one stacked sum:
    the same adds on each row, half the launches."""
    sums = _xla_sum(torch.stack([torch.where(active, w, 0.0), lam], -2))
    return sums[..., 0], sums[..., 1]


def _record(t_sec, q_new, w, out, lam, active) -> Record:
    """One tick's record, per scenario; the two float sums in ``repro``'s
    order (``_record_sums``)."""
    w_sum, lam_sum = _record_sums(w, lam, active)
    return Record(t=torch.full(tuple(w.shape[:-1]), t_sec,
                               dtype=torch.float32), q=q_new,
                  w_sum=w_sum, thru=out, lam=lam_sum, lam_f=lam,
                  n_active=torch.sum(active, dim=-1, dtype=torch.int32))


def step(sim: FluidSim, state: SimState, bw_fn=None, alloc_fn=None,
         record: bool = True):
    """One tick of the padded engine over the batch (a leading scenario
    axis on every leaf, each op covering every scenario). Returns (new
    state, Record or None). The ring buffers of ``state`` are updated in
    place and shared with the new state. ``bw_fn`` gives the tick's
    service rates (``_bandwidth``), unless ``sim.impair`` holds a regime,
    which also gives the tick's loss and jitter (``impair_vectors``).
    ``alloc_fn`` replaces the rate caps after the law update, before flow
    progress."""
    topo, flows, cfg, static = sim.topo, sim.flows, sim.cfg, sim.static
    law_cfg = sim.law_cfg
    D, dt = cfg.hist, cfg.dt
    F = flows.tau.shape[-1]
    t = state.t
    t_sec = _tick_time(t, dt)
    ptr = t % D
    fidx = torch.arange(F, device=flows.tau.device)
    bw = _bandwidth(topo, bw_fn, t_sec, static, sim.impair)
    keep, jit = (impair_vectors(t_sec, sim.impair)
                 if sim.impair is not None else (None, None))

    started = t_sec >= flows.start
    active = started & (state.remaining > 0.0) & (t_sec < flows.stop)
    # -- instantaneous RTT and send rates ---------------------------------
    path = flows.path
    valid = path < topo.num_queues
    q_hop = _take(state.q, path)                              # [B,F,H]
    b_hop = _hop_bw(bw, path)
    qb_now = q_hop / b_hop
    jit_hop = None
    if jit is not None:
        # a flow sees the jitter once it has started: the slot engine
        # holds a flow (and reads a hop's jitter) only from its start
        jit_hop = torch.where(started[..., None], _hop_bw(jit, path), 0.0)
        qb_now = qb_now + jit_hop
    theta_now = flows.tau + _hop_sum(torch.where(valid, qb_now, 0.0))
    lam = torch.where(active, torch.minimum(
        torch.minimum(state.w / theta_now, state.rate_cap), flows.nic_rate),
        0.0)

    # -- histories at current time (in place) ------------------------------
    hist_lam, hist_w = state.hist_lam, state.hist_w
    hist_lam[..., ptr, :] = lam
    hist_w[..., ptr, :] = state.w

    # -- queue update ------------------------------------------------------
    lam_del = _ring(hist_lam, torch.remainder(ptr - flows.tf_steps, D),
                    fidx[:, None])                            # [B,F,H]
    arr, out, q_new = _queue_update(topo, dt, sim.backend, sim.incidence,
                                    sim.inv, state.q, lam_del, valid, static,
                                    bw, keep)
    hist_q, hist_out = state.hist_q, state.hist_out
    hist_q[..., ptr, :] = q_new
    hist_out[..., ptr, :] = out
    pause_new = _write_channels(sim.law, law_cfg, state, ptr, q_new, path,
                                valid, lam_del, sim.inv)

    # -- delayed observation and control-law update (the bound law's
    #    observe-and-update routine, or its backend's update) -------------
    law_state, w, rate_cap, next_update, last_update = _observe_update(
        sim.law, static, cfg, LawTick(
            t=t, t_sec=t_sec, ptr=ptr, hist_q=hist_q, hist_out=hist_out,
            hist_w=hist_w, rows=fidx, path=path, valid=valid, bw=bw,
            b_hop=b_hop,
            tf_steps=flows.tf_steps, rtt_steps=flows.rtt_steps,
            tau=flows.tau, nic=flows.nic_rate, theta_now=theta_now,
            active=active, w=state.w, rate_cap=state.rate_cap,
            law_state=state.law, next_update=state.next_update,
            last_update=state.last_update, law_cfg=law_cfg,
            started=started, hist_pause=state.hist_pause,
            hist_inc=state.hist_inc, jit_hop=jit_hop))
    if alloc_fn is not None:
        rate_cap = alloc_fn(state.remaining, active, t_sec, flows, rate_cap)

    # -- flow progress (under loss, the goodput is the surviving share) ----
    remaining = torch.where(active,
                            state.remaining - _goodput(lam, keep, path,
                                                       valid) * dt,
                            state.remaining)
    done = active & (remaining <= 0.0)
    fct = torch.where(done & torch.isnan(state.fct),
                      t_sec + flows.tau / 2.0 - flows.start, state.fct)

    new_state = SimState(
        t=t + 1, w=w, rate_cap=rate_cap, q=q_new, out_rate=out,
        hist_lam=hist_lam, hist_q=hist_q, hist_out=hist_out, hist_w=hist_w,
        remaining=remaining, fct=fct, next_update=next_update,
        last_update=last_update, law=law_state, pause=pause_new,
        hist_pause=state.hist_pause, hist_inc=state.hist_inc)
    rec = _record(t_sec, q_new, w, out, lam, active) if record else None
    return new_state, rec


def _goodput(lam, keep, path, valid):
    """The rates that arrive: ``lam`` times each row's path survival
    fraction under a regime (``_hop_keep``), else ``lam``."""
    return lam if keep is None else lam * _hop_keep(keep, path, valid)


def _write_channels(law: Law, law_cfg: LawConfig, state, ptr: int, q_new,
                    path, valid, lam_del, inv):
    """This tick's feedback channels, written to their rings in place:
    the pause hysteresis on the integrated queues (returned: the carry's
    new ``pause``, None without the channel) and the sender counts of the
    delayed rates ``lam_del`` (summed through the gather table ``inv``
    of the tick's queue update)."""
    pause_new = None
    if law.uses_pause:
        pause_new = _pause_step(q_new, state.pause, law_cfg)
        state.hist_pause[..., ptr, :] = pause_new
    if law.uses_incast:
        state.hist_inc[..., ptr, :] = _incast_count(
            path, valid, lam_del, inv, int(q_new.shape[-1]) - 1)
    return pause_new


def _live_gather_step(sim: FluidSim):
    """``step`` with the padded engine's gather table over its live flows
    only, rebuilt on each tick where a flow starts (reference backend).

    A flow that has not started has sent nothing; one that stopped
    sending (completed, or past ``stop``) has no delayed rate on any hop
    once its longest hop delay has passed. Leaving those +0.0 terms out of
    an in-order sum of non-negative rates changes no bit (the slot
    engine's table of resident slots rests on the same fact), and the
    table is as wide as the busiest queue's live flows instead of all the
    flows that ever cross it. A rebuild reads back which flows have
    stopped; a flow first seen stopped at tick t is dropped after tick
    t + its hold. Returns ``step_fn(sim, state, bw_fn, record,
    alloc_fn)``."""
    flows, cfg, Q = sim.flows, sim.cfg, sim.topo.num_queues
    start = flows.start.cpu().numpy().astype(np.float32)
    stop = flows.stop.cpu().numpy().astype(np.float32)
    path = flows.path.cpu().numpy()
    hold = np.where(path < Q, flows.tf_steps.cpu().numpy(), 0).max(-1)
    never = np.iinfo(np.int64).max
    gone = np.full(start.shape, never, np.int64)
    last = {"started": -1, "inv": None}

    def step_fn(sim_, state, bw_fn=None, record=True, alloc_fn=None):
        t = state.t
        t32 = np.float32(_tick_time(t, cfg.dt))
        started = start <= t32
        n = int(started.sum())
        if n != last["started"]:
            stopped = (state.remaining <= 0.0).cpu().numpy() | (t32 >= stop)
            gone[:] = np.where(stopped & (gone == never), t + hold, gone)
            live = torch.as_tensor(started & (t <= gone),
                                   device=flows.path.device)
            last.update(started=n, inv=_resident_gather(live, flows.path, Q))
        return step(sim_._replace(inv=last["inv"]), state, bw_fn=bw_fn,
                    record=record, alloc_fn=alloc_fn)

    return step_fn


def _run(sim, state, step_fn, record: bool, bw_fn=None, alloc_fn=None):
    """The tick loop: ``cfg.steps`` ticks of ``step_fn`` (with ``bw_fn``
    and ``alloc_fn``),
    honouring ``cfg.record_every`` (one record per chunk of k ticks, the
    chunk's last tick; steps must divide by k). Returns (final state,
    stacked Record or None); the records are [B, T, ...], as ``repro``'s
    vmapped scan returns them."""
    cfg = sim.cfg
    k = max(int(cfg.record_every), 1) if record else 1
    if cfg.steps % k:
        raise ValueError(f"steps ({cfg.steps}) must be divisible by "
                         f"record_every ({k})")
    recs = []
    for i in range(cfg.steps):
        keep = record and (i + 1) % k == 0
        state, rec = step_fn(sim, state, bw_fn=bw_fn, record=keep,
                             alloc_fn=alloc_fn)
        if keep:
            recs.append(rec)
    if not record:
        return state, None
    return state, Record(*[torch.stack(list(x), dim=1) for x in zip(*recs)])


def _resolve_law(law: Union[str, Law], backend: str) -> Law:
    """A law name (resolved through the registry) or a prebuilt ``Law``."""
    return law if isinstance(law, Law) else get_law(law, backend)


def _check_backend(backend: str):
    if backend not in ("reference", "fused", "megakernel"):
        raise ValueError(f"unknown backend {backend!r}")


def _to(x, dev):
    """Move a NamedTuple of tensors (nested tuples included) to ``dev``."""
    return tree_map(lambda v: v.to(dev), x)


# the host's own leaves of a carry: the tick counter and the copy of the
# cursors (int64), never on the device
_HOST_LEAVES = ("t", "admitted")


def audit_carry_dtypes(state) -> None:
    """Raise unless every tensor of the carry, and every numpy array that
    stands in for one (a snapshot's raw leaves, ``core/ckpt.py``), is
    float32, int32 or bool (the host's tick counter and cursor copy are
    not device leaves). A stray float64/int64 leaf would double the
    carried state."""
    ok = (torch.float32, torch.int32, torch.bool)
    ok_np = (np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_))

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            if x.dtype not in ok:
                raise TypeError(f"carry leaf {name} has dtype {x.dtype}; "
                                f"expected float32/int32")
        elif isinstance(x, np.ndarray):
            if x.dtype not in ok_np and name.rsplit(".", 1)[-1] \
                    not in _HOST_LEAVES:
                raise TypeError(f"carry leaf {name} has dtype {x.dtype}; "
                                f"expected float32/int32")
        elif isinstance(x, tuple):
            fields = getattr(x, "_fields", range(len(x)))
            for f, v in zip(fields, x):
                walk(v, f"{name}.{f}")

    walk(state, "state")


def simulate(topo: Topology, flows: Flows, law_name: Union[str, Law],
             law_cfg: Optional[LawConfig] = None,
             cfg: Optional[SimConfig] = None,
             bw_fn=None, alloc_fn=None, record: bool = True,
             backend: str = "reference", impair=None, device="cuda"):
    """Run a scenario through the padded engine on ``device``: a batch of
    one through ``simulate_batch``. Returns (final ``SimState``, ``Record``
    or None). ``backend="fused"`` sends the law update and the queue
    update through the CUDA kernels (their plain versions on the CPU).
    ``impair`` is a per-link regime (``core.impair``, [Q] leaves)."""
    state, recs = simulate_batch(
        topo, batch_of_one(flows), law_name,
        None if law_cfg is None else batch_of_one(law_cfg), cfg,
        bw_fn=bw_fn, alloc_fn=alloc_fn, record=record, backend=backend,
        impair_params=impair, device=device)
    return scenario(state, 0), (None if recs is None else scenario(recs, 0))


# --------------------------------------------------------------------------
# Flow-slot streaming engine
# --------------------------------------------------------------------------

class SlotSim(NamedTuple):
    """A batch of B schedules ([B, N, ...] leaves, a stacked law config)
    on one topology, bound to a slot pool of ``slots`` (S) and a backend.
    ``start_host`` [B, N] is the schedules' arrival times on the host
    (float32 numpy), where the admission search runs; ``static`` the
    per-topology constants.

    A chunk-streamed run (``simulate_slots(..., chunk=)``) binds ``sched``
    (and ``start_host``) to a C-row window of the whole schedule:
    ``win_off`` is then the window's global base index (a host int) and
    ``n_flows`` the whole schedule's flow count N. Sentinels (``slot_flow
    == N``), the FCT table and the [N] law config keep their global
    meaning; only the schedule rows are read at ``f - win_off``. Both stay
    None on whole-schedule runs.

    ``sync`` (a ``_BatchSync``) is set on a rank's part of a batch split
    over a process group: the admit/retire pass then runs on the ticks
    the whole batch needs it, and the gather table takes the whole
    batch's width, as in the unsharded batch."""
    topo: Topology
    sched: FlowSchedule
    law: Law
    law_cfg: LawConfig
    cfg: SimConfig
    slots: int
    backend: str = "reference"
    static: Optional[_Static] = None
    start_host: Optional[np.ndarray] = None
    impair: Optional[ImpairmentParams] = None   # [Q] or [B, Q] leaves
    n_flows: Optional[int] = None
    win_off: Optional[int] = None
    sync: Optional[object] = None


def _slot_n(sim: SlotSim) -> int:
    """Global flow count N (per scenario): the whole schedule's, even when
    ``sim.sched`` is a chunk window."""
    if sim.n_flows is not None:
        return int(sim.n_flows)
    return int(sim.sched.start.shape[-1])


def _gather_law_cfg(law_cfg: LawConfig, gf: torch.Tensor, n_flows: int):
    """Per-slot view of a batch's LawConfig: tensors with a [B, N] flow
    axis are gathered at ``gf`` [B, S]; scalars and per-scenario scalars
    [B, 1] pass through."""
    def g(x):
        if isinstance(x, torch.Tensor) and x.dim() == gf.dim() \
                and x.shape[-1] == n_flows:
            return _take(x, gf)
        return x
    return type(law_cfg)(*[g(x) for x in law_cfg])


def init_slot_state(sim: SlotSim) -> SlotState:
    """All slots free; pool metadata holds inert values so empty slots
    never send and never NaN. Every leaf has the batch's leading axis
    (``admitted``, the host's copy of the cursors, a numpy array)."""
    topo, sched, cfg = sim.topo, sim.sched, sim.cfg
    lead = tuple(sched.start.shape[:-1])
    S = int(sim.slots)
    N = _slot_n(sim)
    H = int(sched.path.shape[-1])
    Q = topo.num_queues
    D = cfg.hist
    dev = sched.start.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pool = lead + (S,)
    tau0 = torch.full(pool, 20e-6, **f32)
    nic0 = torch.full(pool, 1e9, **f32)
    w0 = nic0 * tau0
    cfg0 = _gather_law_cfg(sim.law_cfg, torch.zeros(pool, **i32), N)
    incidence = (torch.zeros(lead + (H, S, Q + 1), **f32)
                 if sim.backend == "fused" else None)
    inf = float("inf")
    path0 = torch.full(pool + (H,), Q, **i32)
    return SlotState(
        t=0,
        admitted=np.zeros(lead, np.int64),
        cursor=torch.zeros(lead, **i32),
        hw=torch.zeros(lead, **i32),
        slot_flow=torch.full(pool, N, **i32),
        admit_t=torch.zeros(pool, **i32),
        free_at=torch.zeros(pool, **i32),
        path=path0,
        tf_steps=torch.ones(pool + (H,), **i32),
        rtt_steps=torch.ones(pool, **i32),
        tau=tau0, nic_rate=nic0,
        start=torch.full(pool, inf, **f32),
        stop=torch.full(pool, inf, **f32),
        w=w0,
        rate_cap=torch.full(pool, inf, **f32),
        q=torch.zeros(lead + (Q + 1,), **f32),
        out_rate=torch.zeros(lead + (Q + 1,), **f32),
        hist_lam=torch.zeros(lead + (D, S), **f32),
        hist_q=torch.zeros(lead + (D, Q + 1), **f32),
        hist_out=torch.zeros(lead + (D, Q + 1), **f32),
        hist_w=w0[..., None, :].expand(lead + (D, S)).clone(),
        remaining=torch.full(pool, inf, **f32),
        next_update=torch.full(pool, inf, **f32),
        last_update=torch.zeros(pool, **f32),
        law=_law_init(sim.law, pool, cfg0),
        fct=torch.full(lead + (N + 1,), float("nan"), **f32),
        incidence=incidence,
        inv=(None if sim.backend == "fused" else _resident_gather(
            torch.zeros(pool, dtype=torch.bool, device=dev), path0, Q)),
        **_channels(sim.law, lead, D, Q, dev),
    )


def _resident_gather(resident: torch.Tensor, path: torch.Tensor,
                     num_queues: int, sync=None) -> torch.Tensor:
    """The reference backend's in-order gather table over the resident
    slots' hops (int32 [B, Q+1, maxdeg], maxdeg the largest over the
    batch, or over the whole split batch with ``sync``). Only resident
    slots can send, so leaving the others out keeps the sums bit-identical
    and the table narrow; reads the largest queue degree back from the
    device."""
    live = torch.where(resident[..., None], path, num_queues)
    width = max_degree(live, num_queues)
    if sync is not None:
        width = sync.width(width)
    inv, _ = build_csr_gather(live, num_queues, width)
    return inv.to(torch.int32)


def _admit_retire(sim: SlotSim, state: SlotState, due: int):
    """The admit/retire pass.

    Retire: slots whose occupant completed (or passed ``stop``) AND whose
    in-flight traffic has drained (``t >= free_at``) return to the pool.
    Admit: the ``due`` arrivals (``start <= t``, counted by the caller; a
    [B] int32 tensor) fill free slots, fresh-never-used
    slots first (ascending), recycled slots when fresh ones run out.
    Admitted slots gather the flow's metadata and re-init window, timers
    and law state exactly as ``init_state`` would. Returns (state,
    resident mask).

    On a chunk window (``sim.win_off`` set) the schedule rows are read at
    the window-local index ``f - win_off`` (clamped into the window; the
    rows of slots not admitted this tick are masked out), the law config
    at the global index ``f``, as ``repro`` splits them.
    """
    sched = sim.sched
    S = int(state.w.shape[-1])
    N = _slot_n(sim)
    dev = state.w.device
    sidx = torch.arange(S, dtype=torch.int32, device=dev)
    i32 = torch.int32

    occupied = state.slot_flow < N
    freeable = occupied & (state.t >= state.free_at)
    slot_flow = torch.where(freeable, N, state.slot_flow)
    occupied = slot_flow < N

    n_free = S - torch.sum(occupied, dim=-1, dtype=i32)
    n_admit = torch.minimum(due - state.cursor, n_free)
    free = ~occupied
    hw = state.hw[..., None]
    fresh = free & (sidx >= hw)
    n_fresh = torch.minimum(n_admit, torch.sum(fresh, dim=-1, dtype=i32))
    take_fresh = fresh & (torch.cumsum(fresh, -1, dtype=i32) - 1 <
                          n_fresh[..., None])
    recycled = free & (sidx < hw)
    take_rec = recycled & (torch.cumsum(recycled, -1, dtype=i32) - 1 <
                           (n_admit - n_fresh)[..., None])
    admit = take_fresh | take_rec
    rank = torch.cumsum(admit, -1, dtype=i32) - 1
    slot_flow = torch.where(admit, state.cursor[..., None] + rank, slot_flow)
    gf = torch.clamp(slot_flow, 0, N - 1)
    gw = gf if sim.win_off is None else torch.clamp(
        slot_flow - int(sim.win_off), 0, int(sched.start.shape[-1]) - 1)

    def sel(new, old):
        return torch.where(
            admit.view(tuple(admit.shape) + (1,) * (old.dim() - admit.dim())),
            new, old)

    def take(x):
        return _take(x, gw)

    tau = sel(take(sched.tau), state.tau)
    nic = sel(take(sched.nic_rate), state.nic_rate)
    start = sel(take(sched.start), state.start)
    fresh_law = _law_init(sim.law, tuple(gf.shape),
                          _gather_law_cfg(sim.law_cfg, gf, N))
    law_state = tree_map(sel, fresh_law, state.law)
    state = state._replace(
        slot_flow=slot_flow,
        cursor=state.cursor + n_admit,
        hw=state.hw + n_fresh,
        admit_t=torch.where(admit, state.t, state.admit_t),
        free_at=torch.where(admit, _INT32_MAX, state.free_at),
        path=sel(take(sched.path), state.path),
        tf_steps=sel(take(sched.tf_steps), state.tf_steps),
        rtt_steps=sel(take(sched.rtt_steps), state.rtt_steps),
        tau=tau, nic_rate=nic, start=start,
        stop=sel(take(sched.stop), state.stop),
        w=sel(nic * tau, state.w),
        rate_cap=torch.where(admit, float("inf"), state.rate_cap),
        remaining=sel(take(sched.size), state.remaining),
        next_update=sel(start + tau, state.next_update),
        last_update=sel(start, state.last_update),
        law=law_state,
    )
    if sim.backend == "fused":
        state = state._replace(incidence=update_incidence(
            state.incidence, state.path, admit, sim.topo.num_queues))
    return state, occupied | admit


def _due_now(sim: SlotSim, t_sec: float) -> np.ndarray:
    """Each scenario's schedule entries with ``start <= t_sec`` (float32),
    counted on the host ([B]); on a chunk window, searched in the window
    and rebased by its offset."""
    t32 = np.float32(t_sec)
    due = np.array([np.searchsorted(row, t32, side="right")
                    for row in sim.start_host], np.int64)
    return due if sim.win_off is None else due + int(sim.win_off)


def slot_step(sim: SlotSim, state: SlotState, bw_fn=None, alloc_fn=None,
              record: bool = True):
    """One tick of the flow-slot streaming engine over the batch:
    ``step``'s arithmetic on the S-sized pools, plus the admit/retire pass
    (on ticks with an arrival due and not yet admitted, in any scenario)
    and two
    occupancy guards on delayed ring-buffer reads (history older than the
    occupant's admission reads as the ring-init values). Ring buffers and
    the FCT table are updated in place."""
    if alloc_fn is not None:
        raise ValueError("alloc_fn is not supported on the slot path")
    topo, cfg, static = sim.topo, sim.cfg, sim.static
    S = int(state.w.shape[-1])
    N = _slot_n(sim)
    Q = topo.num_queues
    D, dt = cfg.hist, cfg.dt
    t = state.t
    t_sec = _tick_time(t, dt)
    ptr = t % D
    sidx = torch.arange(S, device=state.w.device)
    bw = _bandwidth(topo, bw_fn, t_sec, static, sim.impair)
    keep, jit = (impair_vectors(t_sec, sim.impair)
                 if sim.impair is not None else (None, None))

    # -- admit / retire, on ticks with an arrival due and not admitted ----
    due = _due_now(sim, t_sec)
    if (np.any(due > state.admitted) if sim.sync is None
            else sim.sync.due(t_sec)):
        due = torch.as_tensor(due, dtype=torch.int32, device=state.w.device)
        state, occupied = _admit_retire(sim, state, due)
        state = state._replace(admitted=_host_count(state.cursor))
        if sim.sync is not None:
            sim.sync.admitted(state.admitted)
        if sim.backend != "fused":
            state = state._replace(
                inv=_resident_gather(occupied, state.path, Q, sim.sync))
    else:
        occupied = state.slot_flow < N
    path, tf_steps, tau, nic = (state.path, state.tf_steps, state.tau,
                                state.nic_rate)

    active = (occupied & (t_sec >= state.start) & (state.remaining > 0.0) &
              (t_sec < state.stop))
    # -- instantaneous RTT and send rates ---------------------------------
    valid = path < Q
    q_hop = _take(state.q, path)                              # [B,S,H]
    b_hop = _hop_bw(bw, path)
    qb_now = q_hop / b_hop
    # a slot holds its flow from its start: no gate on the jitter
    jit_hop = None if jit is None else _hop_bw(jit, path)
    if jit_hop is not None:
        qb_now = qb_now + jit_hop
    theta_now = tau + _hop_sum(torch.where(valid, qb_now, 0.0))
    lam = torch.where(active, torch.minimum(
        torch.minimum(state.w / theta_now, state.rate_cap), nic), 0.0)

    # -- histories at current time (in place) ------------------------------
    hist_lam, hist_w = state.hist_lam, state.hist_w
    hist_lam[..., ptr, :] = lam
    hist_w[..., ptr, :] = state.w

    # -- queue update (reads older than admission are masked) --------------
    lam_del = _ring(hist_lam, torch.remainder(ptr - tf_steps, D),
                    sidx[:, None])
    lam_del = torch.where(t - tf_steps >= state.admit_t[..., None], lam_del,
                          0.0)
    arr, out, q_new = _queue_update(topo, dt, sim.backend, state.incidence,
                                    state.inv, state.q, lam_del, valid,
                                    static, bw, keep)
    hist_q, hist_out = state.hist_q, state.hist_out
    hist_q[..., ptr, :] = q_new
    hist_out[..., ptr, :] = out
    pause_new = _write_channels(sim.law, sim.law_cfg, state, ptr, q_new,
                                path, valid, lam_del, state.inv)

    # -- delayed observation (w_old before admission is the occupant's
    #    initial window, the padded engine's ring-init) and control-law
    #    update on the slot-gathered config --------------------------------
    law_state, w, rate_cap, next_update, last_update = _observe_update(
        sim.law, static, cfg, LawTick(
            t=t, t_sec=t_sec, ptr=ptr, hist_q=hist_q, hist_out=hist_out,
            hist_w=hist_w, rows=sidx, path=path, valid=valid, bw=bw,
            b_hop=b_hop,
            tf_steps=tf_steps, rtt_steps=state.rtt_steps, tau=tau, nic=nic,
            theta_now=theta_now, active=active, w=state.w,
            rate_cap=state.rate_cap, law_state=state.law,
            next_update=state.next_update, last_update=state.last_update,
            law_cfg=sim.law_cfg, admit_t=state.admit_t,
            slot_flow=state.slot_flow, n_flows=N,
            hist_pause=state.hist_pause, hist_inc=state.hist_inc,
            jit_hop=jit_hop))

    # -- flow progress; FCT goes to the schedule-ordered table ------------
    remaining = torch.where(active,
                            state.remaining - _goodput(lam, keep, path,
                                                       valid) * dt,
                            state.remaining)
    done = active & (remaining <= 0.0)
    fct = state.fct
    _put(fct, torch.where(done, state.slot_flow, N), torch.where(
        done, t_sec + tau / 2.0 - state.start, float("nan")))
    # hold the slot until the flow's tail has drained into the queues
    hold = torch.amax(torch.where(valid, tf_steps, 0), dim=-1)
    expire = (occupied & (t_sec >= state.stop) &
              (state.free_at == _INT32_MAX) & ~done)
    free_at = torch.where(done | expire, t + hold + 1, state.free_at)

    new_state = state._replace(
        t=t + 1, w=w, rate_cap=rate_cap, q=q_new, out_rate=out,
        hist_lam=hist_lam, hist_q=hist_q, hist_out=hist_out, hist_w=hist_w,
        remaining=remaining, fct=fct, free_at=free_at,
        next_update=next_update, last_update=last_update, law=law_state,
        pause=pause_new)
    rec = _record(t_sec, q_new, w, out, lam, active) if record else None
    return new_state, rec


def make_slot_sim(topo: Topology, sched: FlowSchedule,
                  law_name: Union[str, Law], slots: int,
                  law_cfg: Optional[LawConfig] = None,
                  cfg: Optional[SimConfig] = None,
                  backend: str = "reference", device="cuda",
                  expected_flows: float = 1.0, impair=None) -> SlotSim:
    """Bind a batch of schedules ([B, N, ...] leaves; ``batch_of_one`` for
    one) to a pool of ``slots`` and a backend on ``device``: the
    ``SlotSim`` that ``simulate_slots_batch`` runs. ``law_cfg`` is a
    stacked LawConfig (leading batch axis on every tensor leaf), or None
    for the paper default with ``expected_flows``; ``impair`` a per-link
    regime, [Q] leaves shared by the batch or [B, Q]."""
    _check_backend(backend)
    _check_impair(impair, None, backend)
    cfg = cfg or SimConfig()
    dev = resolve_device(device)
    law = _resolve_law(law_name, backend)
    topo, sched = _to(topo, dev), _to(sched, dev)
    B = int(sched.start.shape[0])
    law_cfg = (_batch_law_cfg(_to(law_cfg, dev), B, backend)
               if law_cfg is not None else
               default_law_config(sched, expected_flows=expected_flows))
    return SlotSim(topo, sched, law, law_cfg, cfg, int(slots), backend,
                   _make_static(topo, cfg.dt),
                   sched.start.cpu().numpy().astype(np.float32),
                   _impair_on(impair, B, int(topo.num_queues), dev))


# --------------------------------------------------------------------------
# Chunk-streamed schedules, checkpoints, guards and injected crashes
# --------------------------------------------------------------------------

# the inert values of a schedule's padding rows (``pad_flows``'), by field
_PAD_ROWS = dict(path=None, tf_steps=1, rtt_steps=1, tau=20e-6,
                 nic_rate=1e9, size=np.inf, start=np.inf, stop=np.inf,
                 weight=1.0, order=-1)


def _host_window(sched_np: FlowSchedule, w0: int, chunk: int,
                 pad_queue: int) -> FlowSchedule:
    """The C-row window ``sched[w0:w0+C]`` of a host (numpy) schedule,
    padded with inert rows past the schedule's end so that every window
    has C rows."""
    n = int(sched_np.start.shape[0])
    end = min(w0 + chunk, n)
    add = chunk - (end - w0)
    rows = []
    for f, x in zip(FlowSchedule._fields, sched_np):
        x = x[w0:end]
        if add > 0:
            fill = pad_queue if f == "path" else _PAD_ROWS[f]
            x = np.concatenate([x, np.full((add,) + x.shape[1:], fill,
                                           x.dtype)])
        rows.append(x)
    return FlowSchedule(*rows)


def _safe_ticks(start_np: np.ndarray, w0: int, chunk: int, t0: int,
                t_end: int, dt: float) -> int:
    """Ticks from ``t0`` during which no schedule entry beyond the window
    ``[w0, w0+C)`` becomes due: within them the window-rebased admission
    search equals the whole schedule's. 0 means entry ``w0+C`` is already
    due at ``t0``; the loop then runs a single tick (exact because
    C >= S caps a tick's admissions at the free pool)."""
    n = int(start_np.shape[0])
    if w0 + chunk >= n:
        return t_end - t0
    lim = np.float32(start_np[w0 + chunk])
    if not np.isfinite(lim):
        return t_end - t0
    # t_sec(t) = f32(t) * f32(dt), the engines' product (nondecreasing in
    # t): the first due tick by bisection
    dtf = np.float32(dt)

    def f(t):
        return np.float32(t) * dtf

    if f(t0) >= lim:
        return 0
    if f(t_end - 1) < lim:
        return t_end - t0
    lo, hi = t0, t_end - 1            # f(lo) < lim <= f(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if f(mid) >= lim:
            hi = mid
        else:
            lo = mid
    return hi - t0


_CHUNK_SEG_MAX = 4096                 # longest single segment (ticks)
# the last chunk-streamed run, segment by segment (kept up to date as it
# runs, so also after a crash): the window's rows, the segments' count,
# lengths and window offsets (read by ``chip_smoke.py``'s timing)
LAST_CHUNKED: dict = {}


def _window_tensors(win: FlowSchedule, dev) -> FlowSchedule:
    """A host window as the run's resident [1, C, ...] tensors (copies:
    the window is refilled in place, and a host slice is a view of the
    caller's schedule)."""
    return FlowSchedule(*[torch.tensor(x[None], device=dev) for x in win])


def _fill_window(dst: FlowSchedule, win: FlowSchedule) -> None:
    """Copy a host window into the resident window tensors, in place (the
    megakernel's argument struct points at them for the whole run)."""
    for d, x in zip(dst, win):
        d.copy_(torch.from_numpy(np.ascontiguousarray(x))[None])


def _cat_records(parts: list, dev) -> Record:
    """Record segments joined on the tick axis, as tensors: each field on
    the device of a segment run here (a restored trace is numpy)."""
    live = next((r for r in parts if isinstance(r.q, torch.Tensor)), None)
    out = []
    for i, f in enumerate(Record._fields):
        d = getattr(live, f).device if live is not None else dev
        out.append(torch.cat([torch.as_tensor(r[i], device=d)
                              for r in parts], dim=1))
    return Record(*out)


def _simulate_slots_chunked(sim: SlotSim, chunk: int, bw_fn, record: bool,
                            checkpoint: Optional[CheckpointSpec] = None,
                            faults=None, guard: bool = False,
                            resume: bool = False,
                            resume_tick: Optional[int] = None):
    """The host's segment loop (``repro``'s ``_simulate_slots_chunked``):
    each segment advances L ticks against a C-row window of the schedule;
    between segments the cursor is read and the window re-anchored at it.
    Segment lengths keep the window-rebased admission equal to the whole
    schedule's (``_safe_ticks``) and are powers of two, cut to the
    checkpoint cadence and the crash tick, as ``repro`` cuts them; the
    carry (pool, queues, rings, law state, the megakernel's carry) crosses
    the boundaries unchanged, so the run is bit for bit the single-shot
    run whatever C. ``sim`` is a batch of one on the whole schedule
    (``make_slot_sim``).

    On the megakernel backend one resident window of C rows is refilled
    in place each segment and its offset passed to every launch, so K4's
    arguments are set up once per run; the gather table's width comes
    from the whole schedule (``suggest_maxdeg``), and each segment's due
    counts are ``w0 + searchsorted(window starts, f32(t) * f32(dt))`` on
    the host, the grid of ``megakernel._due_table``. A segment runs
    through ``megakernel.run_blocks``: K4 on the card, the plain block on
    the CPU (blocks of 64 ticks; a shorter segment is one launch).

    Segment boundaries are the fault-tolerance seam: ``checkpoint``
    snapshots the carry and the trace so far at the cadence's multiples
    and at the end; ``guard`` runs the divergence check; ``faults`` fires
    an ``InjectedCrash`` after the boundary's checkpoint is written.
    ``resume`` restores the newest (or ``resume_tick``) snapshot into the
    carry built by the same init and continues."""
    cfg = sim.cfg
    if record and int(cfg.record_every) > 1:
        raise ValueError("chunk-streamed runs record every tick; "
                         "record_every > 1 is not supported with chunk=")
    if sim.backend == "fused":
        raise ValueError("chunk= is not supported on the fused backend")
    if int(sim.sched.start.shape[0]) != 1:
        raise ValueError("the chunk-streamed loop runs one schedule")
    mega = sim.backend == "megakernel"
    dev = sim.sched.start.device
    sched_np = FlowSchedule(*[x[0].cpu().numpy().copy() for x in sim.sched])
    N = int(sched_np.start.shape[0])
    S = int(sim.slots)
    Q = int(sim.topo.num_queues)
    T = int(cfg.steps)
    # C >= S makes the 1-tick fallback exact: one tick admits at most
    # n_free <= S entries, which the C-clamped due count never truncates
    C = min(max(int(chunk), S), max(N, 1))
    start_np = np.asarray(sched_np.start, np.float32)

    win0 = _host_window(sched_np, 0, C, Q)
    simw = sim._replace(sched=_window_tensors(win0, dev), n_flows=N,
                        win_off=0, start_host=win0.start[None])
    state0 = init_slot_state(simw)
    audit_carry_dtypes(state0)
    if mega:
        from .megakernel import (DEFAULT_BLOCK, _suggest_maxdeg,
                                 _unpack_state, default_impl, make_tick,
                                 run_blocks)
        tick = make_tick(simw, gate=True,
                         maxdeg=_suggest_maxdeg(sim.sched, Q, S),
                         bw_fn=bw_fn)
        impl = default_impl(dev)
        carry = tick.init_carry(state0)
    else:
        carry = state0

    recs = []
    t0 = 0
    seg_idx = 0
    scenario_meta = dict(law=sim.law.name, steps=T, slots=S, flows=N,
                         mega=mega)
    if resume:
        from . import ckpt as _ckpt
        if checkpoint is None:
            raise ValueError("resume requires a CheckpointSpec")
        tick_r = (int(resume_tick) if resume_tick is not None
                  else _ckpt.latest_checkpoint(checkpoint.path))
        if tick_r is None:
            raise FileNotFoundError(
                f"no ckpt-*.npz snapshot in {checkpoint.path!r}")
        rec_template = (Record(*[np.zeros(0)] * len(Record._fields))
                        if record else None)
        meta, carry, recs0 = _ckpt.load_checkpoint(
            checkpoint.path, tick_r, carry, rec_template=rec_template)
        saved = {k: meta.get(k) for k in scenario_meta}
        if saved != scenario_meta:
            raise ValueError(
                f"checkpoint scenario mismatch: snapshot was written by "
                f"{saved}, resume was asked for {scenario_meta} — "
                f"resume_slots must be called with the original run's "
                f"scenario arguments")
        if record:
            recs.append(recs0)
        t0 = int(meta["tick"])

    crash_tick = faults.crash_tick if faults is not None else None
    crash_seg = faults.crash_segment if faults is not None else None
    every = int(checkpoint.every) if checkpoint is not None else 0

    def maybe_checkpoint(t_now):
        if checkpoint is None:
            return
        if every > 0 and t_now % every != 0 and t_now < T:
            return
        from . import ckpt as _ckpt
        rcat = (Record(*[np.concatenate([_ckpt._host(r[i]) for r in recs],
                                        axis=1)
                         for i in range(len(Record._fields))])
                if record else None)
        _ckpt.save_checkpoint(checkpoint, t_now, carry, recs=rcat,
                              meta=dict(scenario_meta, record=record))

    dtf = np.float32(cfg.dt)
    stats = LAST_CHUNKED
    stats.clear()
    stats.update(window=C, segments=0, ticks=[], win_off=[])
    while t0 < T:
        # the admission cursor: the host's copy on the reference backend,
        # one read from the device on the megakernel's
        w0 = (int(carry.state.cursor[0]) if mega
              else int(carry.admitted[0]))
        safe = _safe_ticks(start_np, w0, C, t0, T, cfg.dt)
        allowed = max(1, min(max(safe, 1), T - t0, _CHUNK_SEG_MAX))
        # clamped to the next cadence multiple and the crash tick, the
        # pow2 floor below lands boundaries exactly on them
        if every > 0:
            allowed = min(allowed, ((t0 // every) + 1) * every - t0)
        if crash_tick is not None and t0 < crash_tick:
            allowed = min(allowed, crash_tick - t0)
        L = 1 << (allowed.bit_length() - 1)       # pow2 floor, >= 1
        win = _host_window(sched_np, w0, C, Q)
        _fill_window(simw.sched, win)
        if mega:
            tick.win_off = w0
            t_grid = np.arange(t0, t0 + L, dtype=np.int32).astype(
                np.float32) * dtf
            due = (w0 + np.searchsorted(win.start, t_grid, side="right")
                   ).astype(np.int32)
            carry, rec = run_blocks(
                tick, carry, torch.as_tensor(due[None], device=dev),
                min(DEFAULT_BLOCK, L), impl, record)
        else:
            simw = simw._replace(win_off=w0, start_host=win.start[None])
            seg = []
            for _ in range(L):
                carry, r = slot_step(simw, carry, bw_fn=bw_fn,
                                     record=record)
                if record:
                    seg.append(r)
            rec = (Record(*[torch.stack(list(x), dim=1) for x in zip(*seg)])
                   if record else None)
        if record:
            recs.append(rec)
        t0 += L
        seg_idx += 1
        stats["segments"] += 1
        stats["ticks"].append(L)
        stats["win_off"].append(w0)
        if guard:
            from .guard import check_divergence
            check_divergence(carry.state if mega else carry,
                             sim.law.name, t0)
        maybe_checkpoint(t0)
        # the crash fires after the boundary's checkpoint is written: the
        # process dies after its last durable snapshot
        if crash_tick is not None and t0 >= crash_tick:
            raise InjectedCrash(t0, seg_idx)
        if crash_seg is not None and seg_idx >= crash_seg:
            raise InjectedCrash(t0, seg_idx)

    recs = _cat_records(recs, dev) if record else None
    if mega:
        carry = _unpack_state(carry, N, Q + 1, sim.law)
    state = carry._replace(fct=carry.fct[..., :N])
    return scenario(state, 0), (None if recs is None else scenario(recs, 0))


def simulate_slots(topo: Topology, sched: FlowSchedule,
                   law_name: Union[str, Law], slots: int,
                   law_cfg: Optional[LawConfig] = None,
                   cfg: Optional[SimConfig] = None,
                   bw_fn=None, record: bool = True,
                   backend: str = "reference", chunk=None, impair=None,
                   checkpoint: Optional[CheckpointSpec] = None,
                   faults=None, guard: bool = False, device="cuda"):
    """Run a schedule through a bounded pool of ``slots`` active slots on
    ``device``: a batch of one through ``simulate_slots_batch``. Returns
    (final ``SlotState``, ``Record`` or None); ``final.fct`` is [N] in
    SCHEDULE order. With ``slots >= N`` this reproduces ``simulate`` on
    ``network.schedule_as_flows(sched)`` bit for bit; smaller pools delay
    the admission of flows that arrive while the pool is full.
    ``law_cfg`` tensors with an [N] flow axis are gathered into slots on
    admission. ``impair`` is a per-link regime (``core.impair``, [Q]
    leaves).

    ``chunk=C`` streams the schedule through the run in C-row windows
    (reference and megakernel backends; ``_simulate_slots_chunked``), bit
    for bit the single-shot run for every C (clamped up to S); not with
    ``record_every > 1`` or the fused backend (``ValueError``).
    ``checkpoint=CheckpointSpec(path)`` snapshots the carry and the trace
    at segment boundaries (``resume_slots`` continues from the newest),
    ``guard=True`` runs the divergence check at each boundary
    (``core/guard.py``: ``DivergenceError`` naming law, tick and field),
    and ``faults`` injects a deterministic crash (``core/faults.py``). The
    three ride the chunk-streamed loop, with a window of the whole
    schedule when ``chunk`` is None; the fused backend rejects them
    (``UnsupportedFeature``)."""
    if checkpoint is not None or faults is not None or guard or \
            chunk is not None:
        cfg = cfg or SimConfig()
        sim = make_slot_sim(topo, batch_of_one(sched), law_name, slots,
                            None if law_cfg is None
                            else batch_of_one(law_cfg), cfg, backend,
                            device, impair=impair)
        _check_impair(impair, bw_fn, backend)
        if checkpoint is not None or faults is not None or guard:
            if backend == "fused":
                raise UnsupportedFeature(
                    "checkpoint/fault/guard execution rides the "
                    "chunk-streamed loop, which the fused backend does "
                    "not support",
                    hint="use the reference or megakernel backend")
            C = int(chunk) if chunk is not None else _slot_n(sim)
            with torch.no_grad():
                return _simulate_slots_chunked(
                    sim, C, bw_fn, record, checkpoint=checkpoint,
                    faults=faults, guard=guard)
        with torch.no_grad():
            return _simulate_slots_chunked(sim, int(chunk), bw_fn, record)
    state, recs = simulate_slots_batch(
        topo, batch_of_one(sched), law_name, slots,
        None if law_cfg is None else batch_of_one(law_cfg), cfg,
        bw_fn=bw_fn, record=record, backend=backend, impair_params=impair,
        device=device)
    return scenario(state, 0), (None if recs is None else scenario(recs, 0))


def resume_slots(topo: Topology, sched: FlowSchedule,
                 law_name: Union[str, Law], slots: int,
                 checkpoint: CheckpointSpec,
                 law_cfg: Optional[LawConfig] = None,
                 cfg: Optional[SimConfig] = None,
                 bw_fn=None, record: bool = True,
                 backend: str = "reference", chunk=None, impair=None,
                 faults=None, guard: bool = False,
                 tick: Optional[int] = None, device="cuda"):
    """Continue a checkpointed ``simulate_slots`` run.

    Call with the original run's scenario arguments (a snapshot holds only
    the carry and the recorded trace; laws and schedules are rebuilt, not
    deserialized) and the same ``checkpoint`` spec. The newest snapshot
    (or ``tick``) is restored into a carry built by the same init (its
    law / steps / slots / flows / engine metadata must match, or this
    raises ``ValueError``) and the run continues to its end,
    checkpointing onward at the same cadence. Returns ``(final SlotState,
    Record)`` with the Record covering the whole trace from tick 0, bit
    for bit the uninterrupted run's. The fused backend raises
    ``UnsupportedFeature``."""
    cfg = cfg or SimConfig()
    _check_impair(impair, bw_fn, backend)
    if backend == "fused":
        raise UnsupportedFeature(
            "checkpoint/resume rides the chunk-streamed loop, which "
            "the fused backend does not support",
            hint="use the reference or megakernel backend")
    sim = make_slot_sim(topo, batch_of_one(sched), law_name, slots,
                        None if law_cfg is None else batch_of_one(law_cfg),
                        cfg, backend, device, impair=impair)
    C = int(chunk) if chunk is not None else _slot_n(sim)
    with torch.no_grad():
        return _simulate_slots_chunked(sim, C, bw_fn, record,
                                       checkpoint=checkpoint, faults=faults,
                                       guard=guard, resume=True,
                                       resume_tick=tick)


# --------------------------------------------------------------------------
# Batched scenario engine
# --------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, add: int, fill, dtype) -> torch.Tensor:
    """``x`` (as ``dtype``) with ``add`` rows of ``fill`` appended."""
    x = x.to(dtype)
    pad = torch.full((add,) + tuple(x.shape[1:]), fill, dtype=dtype,
                     device=x.device)
    return torch.cat([x, pad])


def pad_flows(flows: Flows, n: int, pad_queue: int) -> Flows:
    """Pad a Flows batch to ``n`` flows with inert entries.

    Padded flows never activate (``start = inf``), traverse only the
    sentinel queue ``pad_queue`` (== topo.num_queues), and carry ``size =
    inf`` so FCT accounting (which keys on finite sizes) ignores them.
    """
    F = int(flows.tau.shape[0])
    add = n - F
    if add < 0:
        raise ValueError(f"cannot pad {F} flows down to {n}")
    if add == 0:
        return flows
    i32, f32, inf = torch.int32, torch.float32, float("inf")
    return Flows(
        path=_pad_rows(flows.path, add, pad_queue, i32),
        tf_steps=_pad_rows(flows.tf_steps, add, 1, i32),
        rtt_steps=_pad_rows(flows.rtt_steps, add, 1, i32),
        tau=_pad_rows(flows.tau, add, 20e-6, f32),
        nic_rate=_pad_rows(flows.nic_rate, add, 1e9, f32),
        size=_pad_rows(flows.size, add, inf, f32),
        start=_pad_rows(flows.start, add, inf, f32),
        stop=_pad_rows(flows.stop, add, inf, f32),
        weight=_pad_rows(flows.weight, add, 1.0, f32),
    )


def stack_flows(flows_list: List[Flows], pad_queue: int) -> Flows:
    """Stack scenarios along a new leading batch axis, padding each to the
    largest flow count with inert flows (``pad_flows``) and to the
    largest hop count with sentinel hops (``types.pad_hops``)."""
    n = max(int(f.tau.shape[0]) for f in flows_list)
    h = max(int(f.path.shape[-1]) for f in flows_list)
    return stack_trees([pad_flows(pad_hops(f, h, pad_queue), n, pad_queue)
                        for f in flows_list])


def _leaf_tensor(x, device) -> torch.Tensor:
    """A LawConfig leaf as a tensor: Python floats float32, ints int32,
    flags bool (``jnp.asarray``'s dtypes); tensors as they are."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int32, device=device)
    return torch.tensor(x, dtype=torch.float32, device=device)


def stack_law_configs(cfgs: List[LawConfig]) -> LawConfig:
    """Stack per-scenario LawConfigs along a new leading axis (scalars become
    [B] vectors; None leaves must be None everywhere)."""
    dev = next((x.device for c in cfgs for x in c
                if isinstance(x, torch.Tensor)), torch.device("cpu"))

    def stack(xs):
        if all(x is None for x in xs):
            return None
        if any(x is None for x in xs):
            raise ValueError("a LawConfig leaf is None in some scenarios "
                             "and not in others")
        if isinstance(xs[0], tuple):
            return type(xs[0])(*[stack(list(ys)) for ys in zip(*xs)]) \
                if hasattr(xs[0], "_fields") else \
                tuple(stack(list(ys)) for ys in zip(*xs))
        return torch.stack([_leaf_tensor(x, dev) for x in xs])

    return type(cfgs[0])(*[stack(list(xs)) for xs in zip(*cfgs)])


def pad_schedule(sched: FlowSchedule, n: int,
                 pad_queue: int) -> FlowSchedule:
    """Pad a schedule to ``n`` flows with inert tail entries.

    Same inert values as ``pad_flows`` plus ``start = inf`` — the sorted
    order is preserved (inf sorts last) and the admission cursor never
    reaches the padding, so padded scenarios in one batch share a flow
    count without ever admitting phantom flows. ``order`` pads with -1.
    """
    N = int(sched.start.shape[0])
    add = n - N
    if add < 0:
        raise ValueError(f"cannot pad {N} schedule entries down to {n}")
    if add == 0:
        return sched
    flows = pad_flows(Flows(*sched[:-1]), n, pad_queue)
    return FlowSchedule(*flows, order=_pad_rows(sched.order, add, -1,
                                                torch.int32))


def stack_flow_schedules(scheds: List[FlowSchedule],
                         pad_queue: int) -> FlowSchedule:
    """Stack schedules along a new leading batch axis, padding each to the
    largest flow count with inert entries (``pad_schedule``) and to the
    largest hop count with sentinel hops (``types.pad_hops``)."""
    n = max(int(s.start.shape[0]) for s in scheds)
    h = max(int(s.path.shape[-1]) for s in scheds)
    return stack_trees([pad_schedule(pad_hops(s, h, pad_queue), n,
                                      pad_queue) for s in scheds])


def resolve_devices(devices, group=None) -> int:
    """The batched engines' ``devices`` (``repro``'s contract, over the
    ranks of a process group): None/0/1 -> 1; ``"auto"`` -> the group's
    size (``group``, else the initialized default group; 1 with none); an
    int is clamped to it, as ``repro`` clamps to the devices present."""
    if devices is None:
        return 1
    world = shardcomm.world_size(group)
    n = world if devices == "auto" else int(devices)
    return max(1, min(n, world))


def _pad_batch(tree, pad: int):
    """Repeat the last scenario ``pad`` times on the batch axis (filler
    runs whose outputs are sliced off)."""
    if pad == 0 or tree is None:
        return tree
    return tree_map(lambda x: torch.cat(
        [x, x[-1:].expand((pad,) + tuple(x.shape[1:]))]), tree)


def _gather_batch(tree, group, batch: int):
    """Every rank's part of a batched result joined on the batch axis and
    cut to ``batch`` rows: tensor leaves through one all-gather each (on
    the group's device, back to their own), the host's numpy leaves
    (``admitted``) likewise. (The reference gather tables already share
    the whole batch's width, ``_BatchSync.width``.)"""
    def leaf(x):
        if isinstance(x, np.ndarray):
            return leaf(torch.as_tensor(x)).numpy()
        y = group.all_gather(x.to(group.device), tiled=True)
        return y[:batch].to(x.device)
    return tree_map(leaf, tree)


class _BatchSync:
    """The admission gate of the whole batch on one rank of a split batch
    (``SlotSim.sync``): the unsharded batch runs the admit/retire pass for
    every scenario on a tick where any scenario has an arrival due and
    not yet admitted, and widens every scenario's gather table to the
    batch's largest degree. Each rank keeps every scenario's arrival times
    and, after each pass, its cursors all-gathered, so every rank takes
    the same decision and the run is leaf for leaf the unsharded one."""

    def __init__(self, group, start_all: np.ndarray):
        self.group = group
        self.start = start_all                    # [B_pad, N] float32
        self.cursors = np.zeros(start_all.shape[0], np.int64)

    def due(self, t_sec: float) -> bool:
        t32 = np.float32(t_sec)
        return any(np.searchsorted(row, t32, side="right") > c
                   for row, c in zip(self.start, self.cursors))

    def admitted(self, local: np.ndarray) -> None:
        x = torch.as_tensor(np.asarray(local, np.int64), dtype=torch.int64)
        self.cursors = self.group.all_gather(
            x.to(self.group.device), tiled=True).cpu().numpy()

    def width(self, local: int) -> int:
        w = self.group.all_gather(torch.tensor([int(local)],
                                               device=self.group.device))
        return int(w.max())


def _shard_batch(run, batched, law_cfg, bw_params, impair, batch: int,
                 n: int, device):
    """A batch split over the ``n`` ranks of the process group (every rank
    calls the entry point with the whole batch): padded to a multiple of
    ``n`` by repeating its last scenario, each rank runs its contiguous
    slice through ``run(batched, law_cfg, bw_params, impair)`` (the
    entry point on one device), and the parts are all-gathered and the pad
    cut off. The split comes after stacking, so every scenario keeps the
    whole batch's padded flow count and runs bit for bit as in the
    unsharded batch. A shared regime ([Q] leaves) is not split. A rank
    that fails makes every rank raise (agreed through the group before
    any result moves)."""
    group = shardcomm.current_group(resolve_device(device))
    if n != group.world:
        raise ValueError(f"devices resolves to {n} ranks; the process "
                         f"group has {group.world}")
    pad = -batch % n
    per = (batch + pad) // n
    lo, hi = group.rank * per, (group.rank + 1) * per
    shared = impair is not None and impair.kind.dim() == 1
    sync = None
    if isinstance(batched, FlowSchedule):
        sync = _BatchSync(group, _pad_batch(batched.start, pad).cpu().numpy()
                          .astype(np.float32))
    args = [part_of(_pad_batch(x, pad), lo, hi)
            for x in (batched, law_cfg, bw_params)]
    args.append(impair if shared or impair is None
                else part_of(_pad_batch(impair, pad), lo, hi))
    err = None
    try:
        out = run(*args, sync=sync) if sync is not None else run(*args)
    except Exception as e:
        err = e
    if group.any(err is not None):
        if err is not None:
            raise err
        raise RuntimeError("another rank of the sharded batch failed")
    state, recs = out
    return (_gather_batch(state, group, batch),
            None if recs is None else _gather_batch(recs, group, batch))


def _impair_on(impair, batch: int, num_queues: int, dev):
    """A regime on the run's device: [Q] leaves (shared by the batch) or
    [B, Q] (one per scenario); another shape raises."""
    if impair is None:
        return None
    shape = tuple(impair.kind.shape)
    if shape not in ((num_queues,), (batch, num_queues)):
        raise ValueError(f"an impairment regime of shape {shape}; the run "
                         f"takes ({num_queues},) or ({batch}, "
                         f"{num_queues})")
    for x in impair:
        if tuple(x.shape) != shape:
            raise ValueError("the leaves of an impairment regime differ "
                             "in shape")
    return _to(impair, dev)


def _batch_law_cfg(law_cfg: LawConfig, batch: int, backend: str):
    """A stacked LawConfig for the batched tick: per-scenario scalars [B]
    become [B, 1] so they broadcast over flows (those of a nested leaf,
    reTCP's ``sched``, too); per-flow leaves [B, F] stay. A fused backend
    needs one concrete gamma (its kernels take it as a launch argument),
    so a stacked gamma raises as in ``repro``."""
    if backend == "fused" and isinstance(law_cfg.gamma, torch.Tensor):
        raise ValueError("fused law backends need a concrete (non-traced) "
                         "gamma; use backend='reference' for gamma sweeps")

    def norm(x):
        if isinstance(x, torch.Tensor):
            if x.dim() == 0 or x.shape[0] != batch:
                raise ValueError(f"a stacked LawConfig leaf has shape "
                                 f"{tuple(x.shape)}; expected a leading "
                                 f"batch axis of {batch}")
            return x.reshape(batch, 1) if x.dim() == 1 else x
        if isinstance(x, tuple):
            return type(x)(*[norm(v) for v in x])
        return x
    return type(law_cfg)(*[norm(x) for x in law_cfg])


def part_of(tree, lo: int, hi: int):
    """Scenarios ``lo:hi`` of a batched tree (views; None stays None)."""
    return None if tree is None else tree_map(lambda v: v[lo:hi], tree)


def impair_part(impair, lo: int, hi: int):
    """Scenarios ``lo:hi`` of a regime: a shared one ([Q] leaves) as it
    is, one per scenario sliced."""
    if impair is None or impair.kind.dim() == 1:
        return impair
    return part_of(impair, lo, hi)


def scenarios(sim: SlotSim, lo: int, hi: int) -> SlotSim:
    """Of a ``SlotSim``: the batch of its scenarios ``lo:hi`` (views of the
    schedules, the law config, the host arrival times and a per-scenario
    regime; the topology is shared)."""
    return sim._replace(sched=part_of(sim.sched, lo, hi),
                        law_cfg=part_of(sim.law_cfg, lo, hi),
                        start_host=part_of(sim.start_host, lo, hi),
                        impair=impair_part(sim.impair, lo, hi))


def batch_bw_fn(bw_fn, bw_params):
    """The batch's one-argument bandwidth function: ``bw_fn`` itself
    (shared by every scenario) without ``bw_params``, else ``t ->
    bw_fn(t, bw_params)``, one row per scenario."""
    if bw_params is None:
        return bw_fn
    return lambda t_sec: bw_fn(t_sec, bw_params)


def _bw_params_on(bw_fn, bw_params, dev):
    """``bw_params`` on the run's device; it needs a ``bw_fn``."""
    if bw_params is None:
        return None
    if bw_fn is None:
        raise ValueError("bw_params needs a bw_fn")
    return _to(bw_params, dev)


def _pad_inv(state: SlotState, width: int, fill: int) -> SlotState:
    """The reference gather table widened to ``width`` with the sentinel
    index (so runs of different widths join on the batch axis)."""
    inv = state.inv
    if inv is None or inv.shape[-1] == width:
        return state
    pad = inv.new_full(tuple(inv.shape[:-1]) + (width - inv.shape[-1],),
                       fill)
    return state._replace(inv=torch.cat([inv, pad], -1))


def simulate_batch(topo: Topology, flows: Flows, law_name: Union[str, Law],
                   law_cfg: Optional[LawConfig] = None,
                   cfg: Optional[SimConfig] = None,
                   bw_fn=None, bw_params=None, alloc_fn=None,
                   record: bool = True, backend: str = "reference",
                   expected_flows: float = 1.0, devices=None,
                   impair_params=None, device="cuda"):
    """Run a sweep of scenarios on ``device`` as one batch through the
    padded engine.

    ``flows`` carries a leading batch axis B on every leaf (build it with
    ``stack_flows``); ``law_cfg`` likewise (``stack_law_configs``), or
    None to derive the paper-default config per scenario with
    ``expected_flows``. Topology, SimConfig and the law are shared: every
    scenario advances in lockstep through one tick loop whose ops each
    cover the whole batch (on the fused backend one K1/K2 and one K3
    launch per tick for all B). Each scenario's trajectory is bit for bit
    its own run through ``simulate``.

    Time-varying bandwidth: without ``bw_params``, ``bw_fn(t)`` is shared
    by every scenario; with ``bw_params`` (a tree of tensors with a
    leading batch axis B, e.g. ``rdcn.stack_schedules``), scenario b runs
    at ``bw_fn(t, bw_params_b)`` — ``bw_fn`` takes the whole stacked tree
    and returns [B, Q].

    Per-link impairments: ``impair_params`` is a regime (``core.impair``)
    with [B, Q] leaves (``stack_impairments``, one per scenario) or [Q]
    leaves (shared), evaluated once a tick for the whole batch. The fused
    backend rejects it (``UnsupportedFeature``), and so does ``bw_fn``
    (``ValueError``).

    ``devices`` > 1 (or ``"auto"``, ``resolve_devices``) splits the batch
    over the ranks of the process group: every rank calls this with the
    whole batch, runs its contiguous slice and gets the whole result
    (``_shard_batch``), each scenario bit for bit its unsharded run.
    Without a process group it resolves to one device, as ``repro``
    clamps to the devices present.

    ``alloc_fn`` (``workload.homa_alloc_fn``) replaces every scenario's
    rate caps once a tick, after the law update; it sees the batch's
    [B, F] leaves, and on a batch split over ranks its rank's part (an
    allocator whose receivers are [B, F] needs the batch whole; one
    sharing [F] receivers, as ``repro``'s under ``vmap``, takes any
    split). Returns (final_states, records) with a leading batch axis.
    """
    dev = resolve_device(device)
    n = resolve_devices(devices)
    if n > 1:
        return _shard_batch(
            lambda f, lc, bp, ip: simulate_batch(
                topo, f, law_name, lc, cfg, bw_fn=bw_fn, bw_params=bp,
                alloc_fn=alloc_fn, record=record, backend=backend,
                expected_flows=expected_flows, impair_params=ip,
                device=dev),
            flows, law_cfg, bw_params, impair_params,
            int(flows.tau.shape[0]), n, dev)
    _check_backend(backend)
    _check_impair(impair_params, bw_fn, backend)
    cfg = cfg or SimConfig()
    law = _resolve_law(law_name, backend)
    topo, flows = _to(topo, dev), _to(flows, dev)
    B = int(flows.tau.shape[0])
    law_cfg = (_batch_law_cfg(_to(law_cfg, dev), B, backend)
               if law_cfg is not None else
               default_law_config(flows, expected_flows=expected_flows))
    incidence = (build_incidence(flows, topo.num_queues)
                 if backend == "fused" else None)
    sim = FluidSim(topo, flows, law, law_cfg, cfg, backend, incidence,
                   _make_static(topo, cfg.dt),
                   impair=_impair_on(impair_params, B, int(topo.num_queues),
                                     dev))
    bfn = batch_bw_fn(bw_fn, _bw_params_on(bw_fn, bw_params, dev))
    with torch.no_grad():
        state = init_state(sim)
        audit_carry_dtypes(state)
        return _run(sim, state, step if backend == "fused"
                    else _live_gather_step(sim), record, bfn, alloc_fn)


def simulate_slots_batch(topo: Topology, scheds: FlowSchedule,
                         law_name: Union[str, Law], slots: int,
                         law_cfg: Optional[LawConfig] = None,
                         cfg: Optional[SimConfig] = None,
                         bw_fn=None, bw_params=None, record: bool = True,
                         backend: str = "reference",
                         expected_flows: float = 1.0, devices=None,
                         sequential: bool = False, impair_params=None,
                         device="cuda"):
    """Batched twin of ``simulate_slots``: B schedules (a leading batch
    axis on every leaf, ``stack_flow_schedules``) through one pool size
    ``slots`` on ``device``. ``law_cfg``, ``bw_fn``/``bw_params``,
    ``impair_params`` and the unported arguments as in
    ``simulate_batch``. Returns (final
    ``SlotState``s, records) with a leading batch axis; ``fct`` rows [B,
    N] are in each scenario's schedule order.

    ``sequential=False`` advances the scenarios in lockstep, one op (or
    one kernel launch) per step for the whole batch; the admit/retire
    pass runs on a tick where any scenario has an arrival due and not
    yet admitted. ``sequential=True`` runs them one after another, as
    ``repro``'s ``lax.scan`` over scenarios. Both give each scenario its
    own ``simulate_slots`` trajectory bit for bit.

    ``backend="megakernel"`` runs ``megakernel.simulate_slots_mega``: on
    the card K4 with one thread block per scenario, one launch per 64
    ticks for the whole batch (``sequential=False``), or one block per
    launch, scenario after scenario (``sequential=True``). Both run the
    gated tick: ``repro`` drops the gate under ``vmap`` only because a
    ``lax.cond`` there runs both branches, and a K4 block branches on its
    own scenario. ``devices`` is ignored with ``sequential``, as in
    ``repro``. On the card K4 carries a circuit schedule
    (``rdcn.circuit_bw_at`` with ``bw_params``, or
    ``CircuitSchedule.bw_fn()``) and no other ``bw_fn``, and evaluates a
    regime's processes in its body. ``devices`` splits the batch over the
    ranks of the process group, as in ``simulate_batch``.
    """
    dev = resolve_device(device)
    n = 1 if sequential else resolve_devices(devices)
    if n > 1:
        return _shard_batch(
            lambda sc, lc, bp, ip, sync: _slots_batch(
                topo, sc, law_name, slots, lc, cfg, bw_fn, bp, record,
                backend, expected_flows, False, ip, dev, sync),
            scheds, law_cfg, bw_params, impair_params,
            int(scheds.start.shape[0]), n, dev)
    return _slots_batch(topo, scheds, law_name, slots, law_cfg, cfg, bw_fn,
                        bw_params, record, backend, expected_flows,
                        sequential, impair_params, dev, None)


def _slots_batch(topo, scheds, law_name, slots, law_cfg, cfg, bw_fn,
                 bw_params, record, backend, expected_flows, sequential,
                 impair_params, dev, sync):
    """``simulate_slots_batch`` on one device (``sync``: the whole batch's
    admission gate on a rank of a split batch, ``_BatchSync``)."""
    _check_impair(impair_params, bw_fn, backend)
    sim = make_slot_sim(topo, scheds, law_name, slots, law_cfg, cfg,
                        backend, dev, expected_flows, impair_params)
    sim = sim._replace(sync=sync)
    B, N = int(sim.sched.start.shape[0]), _slot_n(sim)
    bw_params = _bw_params_on(bw_fn, bw_params, dev)
    with torch.no_grad():
        if backend == "megakernel":
            from .megakernel import simulate_slots_mega
            state, recs = simulate_slots_mega(
                sim, record=record, sequential=sequential, bw_fn=bw_fn,
                bw_params=bw_params)
        else:
            parts = ([(b, b + 1) for b in range(B)] if sequential
                     else [(0, B)])
            outs = []
            for lo, hi in parts:
                part = scenarios(sim, lo, hi)
                state = init_slot_state(part)
                audit_carry_dtypes(state)
                outs.append(_run(part, state, slot_step, record, batch_bw_fn(
                    bw_fn, part_of(bw_params, lo, hi))))
            finals = [o[0] for o in outs]
            if finals[0].inv is not None:
                width = max(int(f.inv.shape[-1]) for f in finals)
                fill = int(sim.slots) * int(sim.sched.path.shape[-1])
                finals = [_pad_inv(f, width, fill) for f in finals]
            state = cat_trees(finals)
            recs = cat_trees([o[1] for o in outs]) if record else None
    return state._replace(fct=state.fct[..., :N]), recs
