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
``kernels/queue_arrivals.py``) or ``"fused"``, which sends the law update
through K1/K2 and the queue update through K3, one launch each per tick
on the card.

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
admits. The reference backend rebuilds its in-order gather table on
those ticks too, reading back the largest live queue degree.

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP
item that brings it): time-varying bandwidth (``bw_fn``), allocators
(``alloc_fn``), impairments, chunk streaming, checkpoints, fault
injection, divergence guards, the megakernel backend, and laws that need
the hop-feedback, pause or incast channels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..kernels import ops
from ..kernels.queue_arrivals import (build_csr_gather, csr_gather_arrivals,
                                      max_degree, one_hot_incidence,
                                      update_incidence)
from .laws import Law, LawConfig, get_law
from .types import (MTU, Flows, FlowSchedule, PathObs, Record, SimConfig,
                    SimState, SlotState, Topology, resolve_device)

_INT32_MAX = np.iinfo(np.int32).max


def _unported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1 item "
        f"{item})")


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
    acc = x[..., 0]
    for h in range(1, x.shape[-1]):
        acc = acc + x[..., h]
    return acc


def _marking(q: torch.Tensor, buf: torch.Tensor, cfg: LawConfig,
             ) -> torch.Tensor:
    """ECN marking probability + hard mark when a hop's buffer is ~full."""
    span = torch.tensor(max(cfg.dcqcn_kmax - cfg.dcqcn_kmin, 1.0),
                        dtype=torch.float32, device=q.device)
    p = torch.clamp((q - cfg.dcqcn_kmin) / span, 0.0, 1.0) * cfg.dcqcn_pmax
    hard = q >= 0.95 * buf
    return torch.where(hard, 1.0, p)


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
    """One scenario bound to a backend. ``incidence`` is the [H, F, Q+1]
    one-hot path incidence of the fused queue kernel (fused backend);
    ``inv`` the in-order gather table of the reference queue update
    (reference backend; the padded engine's hop table is static)."""
    topo: Topology
    flows: Flows
    law: Law
    law_cfg: LawConfig
    cfg: SimConfig
    backend: str = "reference"
    incidence: Optional[torch.Tensor] = None
    static: Optional[_Static] = None
    inv: Optional[torch.Tensor] = None


def build_incidence(flows: Flows, num_queues: int) -> torch.Tensor:
    """[H, F, Q+1] one-hot path incidence for the fused queue update;
    sentinel (padded) hops become all-zero rows."""
    return one_hot_incidence(flows.path, num_queues)


def init_state(sim: FluidSim) -> SimState:
    topo, flows, cfg = sim.topo, sim.flows, sim.cfg
    F = flows.tau.shape[0]
    Q = topo.num_queues
    D = cfg.hist
    dev = flows.tau.device
    f32 = dict(dtype=torch.float32, device=dev)
    w0 = flows.nic_rate * flows.tau          # cwnd_init = HostBw * tau
    return SimState(
        t=0,
        w=w0,
        rate_cap=torch.full((F,), float("inf"), **f32),
        q=torch.zeros((Q + 1,), **f32),
        out_rate=torch.zeros((Q + 1,), **f32),
        hist_lam=torch.zeros((D, F), **f32),
        hist_q=torch.zeros((D, Q + 1), **f32),
        hist_out=torch.zeros((D, Q + 1), **f32),
        hist_w=w0.expand(D, F).clone(),
        remaining=flows.size.to(torch.float32),
        fct=torch.full((F,), float("nan"), **f32),
        next_update=flows.start + flows.tau,
        last_update=flows.start,
        law=sim.law.init(F, sim.law_cfg),
    )


def _bandwidth(topo: Topology) -> torch.Tensor:
    """[Q+1] per-queue service rates (sentinel appended). Only the static
    topology capacities are ported; schedules and impairments come later."""
    bw = topo.bandwidth
    return torch.cat([bw, bw.new_full((1,), 1e15)])


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
    return _Static(bw=_bandwidth(topo), buf=buf, sw_table=sw_table,
                   dt=torch.tensor(dt, dtype=torch.float32, device=dev))


def _buffer_caps(topo: Topology, q: torch.Tensor,
                 static: _Static) -> torch.Tensor:
    """Per-queue caps; Dynamic Thresholds [17] when dt_alpha > 0. Each
    switch's occupancy is folded over its queues in ascending order, as
    ``repro`` accumulates it."""
    if static.sw_table is None:
        return static.buf
    m = q[static.sw_table]                      # [switches, deg]
    used = torch.zeros_like(m[:, 0])
    for j in range(m.shape[1]):
        used = used + m[:, j]
    free = torch.clamp_min(topo.switch_buffer - used, 0.0)
    thr = topo.dt_alpha * free[topo.switch_of_queue]
    return torch.cat([torch.minimum(thr, topo.buffer),
                      thr.new_full((1,), 1e30)])


def _queue_update(topo: Topology, dt: float, backend: str, incidence, inv,
                  q, lam_del, valid, static: _Static):
    """Queue-arrival accumulation + integration: (arrivals, out, q_new).

    Reference backend: the masked per-hop rates summed per queue in
    ascending flat order through the gather table ``inv``. Fused backend:
    K3 over the incidence (``out_rate=bw`` is exact there — when q == 0
    and arr < bw the clip at 0 reproduces ``out = min(arr, bw)``).
    """
    bw = static.bw
    caps = _buffer_caps(topo, q, static)
    if backend == "fused":
        arr, q_new = ops.queue_arrivals(lam_del.t().contiguous(), incidence,
                                        q, bw, caps, dt=dt)
    else:
        contrib = torch.where(valid, lam_del, 0.0)
        arr = csr_gather_arrivals(contrib, inv, torch.zeros_like(q))
        q_new = torch.minimum(torch.clamp_min(q + (arr - bw) * dt, 0.0),
                              caps)
    out = torch.where(q > 0.0, bw, torch.minimum(arr, bw))
    q_new[-1] = 0.0
    return arr, out, q_new


def _observe(law: Law, law_cfg: LawConfig, static: _Static, cfg: SimConfig,
             ptr: int, hist_q, hist_out, path, valid, tf_steps, rtt_steps,
             tau, b_hop):
    """Delayed INT observation of each hop (stamped when a segment
    dequeues there, back at the sender after ``rtt - tf_h``) and the RTT
    sample rebuilt from it. Returns (q_obs, qdot, mu, ecn, theta_obs,
    wold_delay). Telemetry a law declares it does not read
    (``Law.uses_qdot``/``uses_mu``/``uses_ecn``) is left out (None)."""
    D, dt = cfg.hist, cfg.dt
    tb_steps = torch.clamp(rtt_steps[:, None] - tf_steps, 1, D - 2)
    ohidx = torch.remainder(ptr - tb_steps, D)                # [F,H]
    q_obs = hist_q[ohidx, path]
    qdot = mu = ecn = None
    if law.uses_qdot:
        q_prev = hist_q[torch.remainder(ohidx - 1, D), path]
        qdot = (q_obs - q_prev) * (1.0 / dt)
    if law.uses_mu:
        mu = hist_out[ohidx, path]
    if law.uses_ecn:
        ecn = torch.amax(torch.where(
            valid, _marking(q_obs, static.buf[path], law_cfg), 0.0), dim=1)
    theta_obs = tau + _hop_sum(torch.where(valid, q_obs / b_hop, 0.0))
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


def _record(t_sec, q_new, w, out, lam, active) -> Record:
    return Record(t=torch.tensor(t_sec, dtype=torch.float32), q=q_new,
                  w_sum=torch.sum(torch.where(active, w, 0.0)),
                  thru=out, lam=torch.sum(lam), lam_f=lam,
                  n_active=torch.sum(active, dtype=torch.int32))


def step(sim: FluidSim, state: SimState, bw_fn=None, alloc_fn=None,
         record: bool = True):
    """One tick of the padded engine. Returns (new state, Record or None).
    The ring buffers of ``state`` are updated in place and shared with
    the new state."""
    if bw_fn is not None:
        _unported("bw_fn", 8)
    if alloc_fn is not None:
        _unported("alloc_fn", 13)
    topo, flows, cfg, static = sim.topo, sim.flows, sim.cfg, sim.static
    law_cfg = sim.law_cfg
    D, dt = cfg.hist, cfg.dt
    F = flows.tau.shape[0]
    t = state.t
    t_sec = _tick_time(t, dt)
    ptr = t % D
    fidx = torch.arange(F, device=flows.tau.device)

    started = t_sec >= flows.start
    active = started & (state.remaining > 0.0) & (t_sec < flows.stop)
    # -- instantaneous RTT and send rates ---------------------------------
    path = flows.path
    valid = path < topo.num_queues
    q_hop = state.q[path]                                     # [F,H]
    b_hop = static.bw[path]
    theta_now = flows.tau + _hop_sum(torch.where(valid, q_hop / b_hop, 0.0))
    lam = torch.where(active, torch.minimum(
        torch.minimum(state.w / theta_now, state.rate_cap), flows.nic_rate),
        0.0)

    # -- histories at current time (in place) ------------------------------
    hist_lam, hist_w = state.hist_lam, state.hist_w
    hist_lam[ptr] = lam
    hist_w[ptr] = state.w

    # -- queue update ------------------------------------------------------
    lam_del = hist_lam[torch.remainder(ptr - flows.tf_steps, D),
                       fidx[:, None]]                         # [F,H]
    arr, out, q_new = _queue_update(topo, dt, sim.backend, sim.incidence,
                                    sim.inv, state.q, lam_del, valid, static)
    hist_q, hist_out = state.hist_q, state.hist_out
    hist_q[ptr] = q_new
    hist_out[ptr] = out

    # -- delayed observation ------------------------------------------------
    q_obs, qdot, mu, ecn, theta_obs, wold_delay = _observe(
        sim.law, law_cfg, static, cfg, ptr, hist_q, hist_out, path, valid,
        flows.tf_steps, flows.rtt_steps, flows.tau, b_hop)
    w_old = hist_w[torch.remainder(ptr - wold_delay, D), fidx]
    upd = active & (t_sec >= state.next_update)
    dt_obs = torch.clamp_min(t_sec - state.last_update, dt)
    obs = PathObs(q=q_obs, qdot=qdot, mu=mu, b=b_hop, valid=valid,
                  theta=theta_obs, w_old=w_old, dt_obs=dt_obs, ecn_frac=ecn)

    # -- control-law update (dispatches through the law's bound backend) ---
    law_state, w, rate_cap = sim.law.update(
        state.law, obs, state.w, state.rate_cap, upd, law_cfg, t_sec)
    w = torch.minimum(torch.clamp_min(w, MTU),
                      8.0 * flows.nic_rate * flows.tau +
                      8.0 * flows.nic_rate * theta_now)
    # a flow that has not started holds its initial window, so the slot
    # engine's admission re-init lands on the same bits
    w = torch.where(started, w, state.w)
    next_update = _next_update(cfg, upd, t_sec, theta_now, state.next_update)
    last_update = torch.where(upd, t_sec, state.last_update)

    # -- flow progress ------------------------------------------------------
    remaining = torch.where(active, state.remaining - lam * dt,
                            state.remaining)
    done = active & (remaining <= 0.0)
    fct = torch.where(done & torch.isnan(state.fct),
                      t_sec + flows.tau / 2.0 - flows.start, state.fct)

    new_state = SimState(
        t=t + 1, w=w, rate_cap=rate_cap, q=q_new, out_rate=out,
        hist_lam=hist_lam, hist_q=hist_q, hist_out=hist_out, hist_w=hist_w,
        remaining=remaining, fct=fct, next_update=next_update,
        last_update=last_update, law=law_state)
    rec = _record(t_sec, q_new, w, out, lam, active) if record else None
    return new_state, rec


def _run(sim, state, step_fn, record: bool):
    """The tick loop: ``cfg.steps`` ticks, honouring ``cfg.record_every``
    (one record per chunk of k ticks, the chunk's last tick; steps must
    divide by k). Returns (final state, stacked Record or None)."""
    cfg = sim.cfg
    k = max(int(cfg.record_every), 1) if record else 1
    if cfg.steps % k:
        raise ValueError(f"steps ({cfg.steps}) must be divisible by "
                         f"record_every ({k})")
    recs = []
    for i in range(cfg.steps):
        keep = record and (i + 1) % k == 0
        state, rec = step_fn(sim, state, record=keep)
        if keep:
            recs.append(rec)
    if not record:
        return state, None
    return state, Record(*[torch.stack(list(x)) for x in zip(*recs)])


def _resolve_law(law: Union[str, Law], backend: str) -> Law:
    """A law name (resolved through the registry) or a prebuilt ``Law``."""
    law = law if isinstance(law, Law) else get_law(law, backend)
    if law.feedback == "hop" or law.uses_pause or law.uses_incast:
        _unported(f"law '{law.name}' (hop feedback / pause / incast "
                  f"channels)", 9)
    return law


def _check_backend(backend: str):
    if backend == "megakernel":
        _unported("backend='megakernel'", 6)
    if backend not in ("reference", "fused"):
        raise ValueError(f"unknown backend {backend!r}")


def _to(x, dev):
    """Move a NamedTuple of tensors (nested tuples included) to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        vals = [_to(v, dev) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def audit_carry_dtypes(state) -> None:
    """Raise unless every tensor of the carry is float32, int32 or bool
    (host tick counters are Python ints). A stray float64/int64 tensor
    would double the carried state."""
    ok = (torch.float32, torch.int32, torch.bool)

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            if x.dtype not in ok:
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
    """Run a scenario through the padded engine on ``device``. Returns
    (final ``SimState``, ``Record`` or None). ``backend="fused"`` sends the
    law update and the queue update through the CUDA kernels (their plain
    versions on the CPU)."""
    if bw_fn is not None:
        _unported("bw_fn", 8)
    if alloc_fn is not None:
        _unported("alloc_fn", 13)
    if impair is not None:
        _unported("impair", 10)
    _check_backend(backend)
    cfg = cfg or SimConfig()
    dev = resolve_device(device)
    law = _resolve_law(law_name, backend)
    topo, flows = _to(topo, dev), _to(flows, dev)
    law_cfg = _to(law_cfg, dev) if law_cfg is not None \
        else default_law_config(flows)
    Q = topo.num_queues
    incidence = inv = None
    if backend == "fused":
        incidence = build_incidence(flows, Q)
    else:
        inv, _ = build_csr_gather(flows.path, Q, max_degree(flows.path, Q))
    sim = FluidSim(topo, flows, law, law_cfg, cfg, backend, incidence,
                   _make_static(topo, cfg.dt), inv)
    with torch.no_grad():
        state = init_state(sim)
        audit_carry_dtypes(state)
        return _run(sim, state, step, record)


# --------------------------------------------------------------------------
# Flow-slot streaming engine
# --------------------------------------------------------------------------

class SlotSim(NamedTuple):
    """One schedule bound to a slot pool of ``slots`` (S) and a backend.
    ``start_host`` is the schedule's arrival times on the host (float32
    numpy), where the admission search runs; ``static`` the per-topology
    constants."""
    topo: Topology
    sched: FlowSchedule
    law: Law
    law_cfg: LawConfig
    cfg: SimConfig
    slots: int
    backend: str = "reference"
    static: Optional[_Static] = None
    start_host: Optional[np.ndarray] = None


def _slot_n(sim: SlotSim) -> int:
    """Global flow count N."""
    return int(sim.sched.start.shape[0])


def _gather_law_cfg(law_cfg: LawConfig, gf: torch.Tensor, n_flows: int):
    """Per-slot view of a LawConfig: tensors with an [N] flow axis are
    gathered at ``gf``; scalars pass through."""
    def g(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                and x.shape[0] == n_flows:
            return x[gf]
        return x
    return type(law_cfg)(*[g(x) for x in law_cfg])


def init_slot_state(sim: SlotSim) -> SlotState:
    """All slots free; pool metadata holds inert values so empty slots
    never send and never NaN."""
    topo, sched, cfg = sim.topo, sim.sched, sim.cfg
    S = int(sim.slots)
    N = _slot_n(sim)
    H = int(sched.path.shape[1])
    Q = topo.num_queues
    D = cfg.hist
    dev = sched.start.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    tau0 = torch.full((S,), 20e-6, **f32)
    nic0 = torch.full((S,), 1e9, **f32)
    w0 = nic0 * tau0
    cfg0 = _gather_law_cfg(sim.law_cfg, torch.zeros((S,), **i32), N)
    incidence = (torch.zeros((H, S, Q + 1), **f32)
                 if sim.backend == "fused" else None)
    inf = float("inf")
    return SlotState(
        t=0,
        admitted=0,
        cursor=torch.zeros((), **i32),
        hw=torch.zeros((), **i32),
        slot_flow=torch.full((S,), N, **i32),
        admit_t=torch.zeros((S,), **i32),
        free_at=torch.zeros((S,), **i32),
        path=torch.full((S, H), Q, **i32),
        tf_steps=torch.ones((S, H), **i32),
        rtt_steps=torch.ones((S,), **i32),
        tau=tau0, nic_rate=nic0,
        start=torch.full((S,), inf, **f32),
        stop=torch.full((S,), inf, **f32),
        w=w0,
        rate_cap=torch.full((S,), inf, **f32),
        q=torch.zeros((Q + 1,), **f32),
        out_rate=torch.zeros((Q + 1,), **f32),
        hist_lam=torch.zeros((D, S), **f32),
        hist_q=torch.zeros((D, Q + 1), **f32),
        hist_out=torch.zeros((D, Q + 1), **f32),
        hist_w=w0.expand(D, S).clone(),
        remaining=torch.full((S,), inf, **f32),
        next_update=torch.full((S,), inf, **f32),
        last_update=torch.zeros((S,), **f32),
        law=sim.law.init(S, cfg0),
        fct=torch.full((N + 1,), float("nan"), **f32),
        incidence=incidence,
        inv=(None if sim.backend == "fused" else _resident_gather(
            torch.zeros((S,), dtype=torch.bool, device=dev),
            torch.full((S, H), Q, **i32), Q)),
    )


def _resident_gather(resident: torch.Tensor, path: torch.Tensor,
                     num_queues: int) -> torch.Tensor:
    """The reference backend's in-order gather table over the resident
    slots' hops (int32). Only resident slots can send, so leaving the
    others out keeps the sums bit-identical and the table narrow; reads
    the largest queue degree back from the device."""
    live = torch.where(resident[:, None], path, num_queues)
    inv, _ = build_csr_gather(live, num_queues, max_degree(live, num_queues))
    return inv.to(torch.int32)


def _admit_retire(sim: SlotSim, state: SlotState, due: int):
    """The admit/retire pass.

    Retire: slots whose occupant completed (or passed ``stop``) AND whose
    in-flight traffic has drained (``t >= free_at``) return to the pool.
    Admit: the ``due`` arrivals (``start <= t``, counted by the caller on
    the host) fill free slots, fresh-never-used slots first (ascending),
    recycled slots when fresh ones run out. Admitted slots gather the
    flow's metadata and re-init window, timers and law state exactly as
    ``init_state`` would. Returns (state, resident mask).
    """
    sched = sim.sched
    S = int(state.w.shape[0])
    N = _slot_n(sim)
    dev = state.w.device
    sidx = torch.arange(S, dtype=torch.int32, device=dev)
    i32 = torch.int32

    occupied = state.slot_flow < N
    freeable = occupied & (state.t >= state.free_at)
    slot_flow = torch.where(freeable, N, state.slot_flow)
    occupied = slot_flow < N

    n_free = S - torch.sum(occupied, dtype=i32)
    n_admit = torch.minimum(due - state.cursor, n_free)
    free = ~occupied
    fresh = free & (sidx >= state.hw)
    n_fresh = torch.minimum(n_admit, torch.sum(fresh, dtype=i32))
    take_fresh = fresh & (torch.cumsum(fresh, 0, dtype=i32) - 1 < n_fresh)
    recycled = free & (sidx < state.hw)
    take_rec = recycled & (torch.cumsum(recycled, 0, dtype=i32) - 1 <
                           n_admit - n_fresh)
    admit = take_fresh | take_rec
    rank = torch.cumsum(admit, 0, dtype=i32) - 1
    slot_flow = torch.where(admit, state.cursor + rank, slot_flow)
    gf = torch.clamp(slot_flow, 0, N - 1)

    def sel(new, old):
        return torch.where(admit.view((S,) + (1,) * (old.dim() - 1)),
                           new, old)

    tau = sel(sched.tau[gf], state.tau)
    nic = sel(sched.nic_rate[gf], state.nic_rate)
    start = sel(sched.start[gf], state.start)
    fresh_law = sim.law.init(S, _gather_law_cfg(sim.law_cfg, gf, N))
    law_state = type(state.law)(*[sel(f, o) for f, o
                                  in zip(fresh_law, state.law)])
    state = state._replace(
        slot_flow=slot_flow,
        cursor=state.cursor + n_admit,
        hw=state.hw + n_fresh,
        admit_t=torch.where(admit, state.t, state.admit_t),
        free_at=torch.where(admit, _INT32_MAX, state.free_at),
        path=sel(sched.path[gf], state.path),
        tf_steps=sel(sched.tf_steps[gf], state.tf_steps),
        rtt_steps=sel(sched.rtt_steps[gf], state.rtt_steps),
        tau=tau, nic_rate=nic, start=start,
        stop=sel(sched.stop[gf], state.stop),
        w=sel(nic * tau, state.w),
        rate_cap=torch.where(admit, float("inf"), state.rate_cap),
        remaining=sel(sched.size[gf], state.remaining),
        next_update=sel(start + tau, state.next_update),
        last_update=sel(start, state.last_update),
        law=law_state,
    )
    if sim.backend == "fused":
        state = state._replace(incidence=update_incidence(
            state.incidence, state.path, admit, sim.topo.num_queues))
    return state, occupied | admit


def slot_step(sim: SlotSim, state: SlotState, bw_fn=None, alloc_fn=None,
              record: bool = True):
    """One tick of the flow-slot streaming engine: ``step``'s arithmetic
    on the S-sized pool, plus the admit/retire pass (on ticks with an
    arrival due and not yet admitted) and two occupancy guards on delayed ring-buffer reads (history older than the occupant's
    admission reads as the ring-init values). Ring buffers and the FCT
    table are updated in place."""
    if bw_fn is not None:
        _unported("bw_fn", 8)
    if alloc_fn is not None:
        raise ValueError("alloc_fn is not supported on the slot path")
    topo, cfg, static = sim.topo, sim.cfg, sim.static
    S = int(state.w.shape[0])
    N = _slot_n(sim)
    Q = topo.num_queues
    D, dt = cfg.hist, cfg.dt
    t = state.t
    t_sec = _tick_time(t, dt)
    ptr = t % D
    sidx = torch.arange(S, device=state.w.device)

    # -- admit / retire, on ticks with an arrival due and not admitted ----
    due = int(np.searchsorted(sim.start_host, np.float32(t_sec),
                              side="right"))
    if due > state.admitted:
        state, occupied = _admit_retire(sim, state, due)
        state = state._replace(admitted=int(state.cursor))
        if sim.backend != "fused":
            state = state._replace(
                inv=_resident_gather(occupied, state.path, Q))
    else:
        occupied = state.slot_flow < N
    path, tf_steps, tau, nic = (state.path, state.tf_steps, state.tau,
                                state.nic_rate)
    gf = torch.clamp(state.slot_flow, 0, N - 1)
    cfg_slot = _gather_law_cfg(sim.law_cfg, gf, N)

    active = (occupied & (t_sec >= state.start) & (state.remaining > 0.0) &
              (t_sec < state.stop))
    # -- instantaneous RTT and send rates ---------------------------------
    valid = path < Q
    q_hop = state.q[path]                                     # [S,H]
    b_hop = static.bw[path]
    theta_now = tau + _hop_sum(torch.where(valid, q_hop / b_hop, 0.0))
    lam = torch.where(active, torch.minimum(
        torch.minimum(state.w / theta_now, state.rate_cap), nic), 0.0)

    # -- histories at current time (in place) ------------------------------
    hist_lam, hist_w = state.hist_lam, state.hist_w
    hist_lam[ptr] = lam
    hist_w[ptr] = state.w

    # -- queue update (reads older than admission are masked) --------------
    lam_del = hist_lam[torch.remainder(ptr - tf_steps, D), sidx[:, None]]
    lam_del = torch.where(t - tf_steps >= state.admit_t[:, None], lam_del,
                          0.0)
    arr, out, q_new = _queue_update(topo, dt, sim.backend, state.incidence,
                                    state.inv, state.q, lam_del, valid,
                                    static)
    hist_q, hist_out = state.hist_q, state.hist_out
    hist_q[ptr] = q_new
    hist_out[ptr] = out

    # -- delayed observation (w_old before admission is the occupant's
    #    initial window, the padded engine's ring-init) -------------------
    q_obs, qdot, mu, ecn, theta_obs, wold_delay = _observe(
        sim.law, cfg_slot, static, cfg, ptr, hist_q, hist_out, path, valid,
        tf_steps, state.rtt_steps, tau, b_hop)
    w_old = hist_w[torch.remainder(ptr - wold_delay, D), sidx]
    w_old = torch.where(t - wold_delay >= state.admit_t, w_old, nic * tau)
    upd = active & (t_sec >= state.next_update)
    dt_obs = torch.clamp_min(t_sec - state.last_update, dt)
    obs = PathObs(q=q_obs, qdot=qdot, mu=mu, b=b_hop, valid=valid,
                  theta=theta_obs, w_old=w_old, dt_obs=dt_obs, ecn_frac=ecn)

    # -- control-law update (slot-gathered config) ------------------------
    law_state, w, rate_cap = sim.law.update(
        state.law, obs, state.w, state.rate_cap, upd, cfg_slot, t_sec)
    w = torch.minimum(torch.clamp_min(w, MTU),
                      8.0 * nic * tau + 8.0 * nic * theta_now)
    next_update = _next_update(cfg, upd, t_sec, theta_now, state.next_update)
    last_update = torch.where(upd, t_sec, state.last_update)

    # -- flow progress; FCT goes to the schedule-ordered table ------------
    remaining = torch.where(active, state.remaining - lam * dt,
                            state.remaining)
    done = active & (remaining <= 0.0)
    fct = state.fct
    fct[torch.where(done, state.slot_flow, N)] = torch.where(
        done, t_sec + tau / 2.0 - state.start, float("nan"))
    # hold the slot until the flow's tail has drained into the queues
    hold = torch.amax(torch.where(valid, tf_steps, 0), dim=1)
    expire = (occupied & (t_sec >= state.stop) &
              (state.free_at == _INT32_MAX) & ~done)
    free_at = torch.where(done | expire, t + hold + 1, state.free_at)

    new_state = state._replace(
        t=t + 1, w=w, rate_cap=rate_cap, q=q_new, out_rate=out,
        hist_lam=hist_lam, hist_q=hist_q, hist_out=hist_out, hist_w=hist_w,
        remaining=remaining, fct=fct, free_at=free_at,
        next_update=next_update, last_update=last_update, law=law_state)
    rec = _record(t_sec, q_new, w, out, lam, active) if record else None
    return new_state, rec


def simulate_slots(topo: Topology, sched: FlowSchedule,
                   law_name: Union[str, Law], slots: int,
                   law_cfg: Optional[LawConfig] = None,
                   cfg: Optional[SimConfig] = None,
                   bw_fn=None, record: bool = True,
                   backend: str = "reference", chunk=None, impair=None,
                   checkpoint=None, faults=None, guard: bool = False,
                   device="cuda"):
    """Run a schedule through a bounded pool of ``slots`` active slots on
    ``device``. Returns (final ``SlotState``, ``Record`` or None);
    ``final.fct`` is [N] in SCHEDULE order. With ``slots >= N`` this
    reproduces ``simulate`` on ``network.schedule_as_flows(sched)`` bit
    for bit; smaller pools delay the admission of flows that arrive
    while the pool is full. ``law_cfg`` tensors with an [N] flow axis are
    gathered into slots on admission."""
    if bw_fn is not None:
        _unported("bw_fn", 8)
    if impair is not None:
        _unported("impair", 10)
    if chunk is not None:
        _unported("chunk streaming (chunk=)", 11)
    if checkpoint is not None or faults is not None or guard:
        _unported("checkpoint / faults / guard", 11)
    _check_backend(backend)
    cfg = cfg or SimConfig()
    dev = resolve_device(device)
    law = _resolve_law(law_name, backend)
    topo, sched = _to(topo, dev), _to(sched, dev)
    law_cfg = _to(law_cfg, dev) if law_cfg is not None \
        else default_law_config(sched)
    sim = SlotSim(topo, sched, law, law_cfg, cfg, int(slots), backend,
                  _make_static(topo, cfg.dt),
                  sched.start.cpu().numpy().astype(np.float32))
    with torch.no_grad():
        state = init_slot_state(sim)
        audit_carry_dtypes(state)
        state, recs = _run(sim, state, slot_step, record)
    return state._replace(fct=state.fct[:_slot_n(sim)]), recs
