"""Congestion-control laws (twin of ``repro.core.laws``): the registry and
the two PowerTCP laws.

Every law is a pair ``init(nflows, cfg) -> state`` and
``update(state, obs, w, rate_cap, upd_mask, cfg, t) -> (state, w, rate_cap)``
on per-flow tensors ([F], or [B, F] for a batch of scenarios, per-hop
[..., F, H]); the engines call ``update`` every tick and a law acts only
where ``upd_mask`` is set.

  powertcp        Algorithm 1 (INT feedback; per-hop max normalized power)
  theta_powertcp  Algorithm 2 (RTT + RTT-gradient only)
  hpcc            HPCC (Li et al., SIGCOMM'19) inflight-MIMD w/ per-RTT wc ref
  swift           delay-based MIMD (paper Eq. 26 — Swift/FAST class)
  gradient_mimd   paper Eq. 27 (pure RTT-gradient MIMD)
  timely          TIMELY (Mittal et al.) gradient-based rate control w/ HAI
  dcqcn           DCQCN fluid approximation (ECN + alpha, RP increase stages)
  reno            NewReno-style AI/MD on loss

``retcp`` (NewReno with circuit-state feedback, for time-varying
circuits) is registered by ``core/rdcn.py``, with the ``"reference"`` and
``"megakernel"`` backends; it reads ``LawConfig.sched`` and
``retcp_prebuffer``. The feedback-channel laws (``fncc``, ``pulser``,
``backpressure``, ``pcc``) are registered by ``core/feedback.py``, with
the same two backends; they read the hop-feedback clock and the pause
and incast channels (``ENGINE_CHANNELS``, ``FEEDBACK_MODELS``).

Numerics: ``repro`` wraps products in ``_pin``/``_nofma`` so that XLA and
LLVM cannot reassociate them or contract them into FMAs. Eager PyTorch
rounds every operation on its own, so here each expression is written in
``repro``'s association and nothing else is needed — as long as no fused
op (``addcmul``, ``lerp``, ``addmm``) replaces a rounded product plus an
add. A divisor from the law config divides as ``repro``'s compiled
engines divide (``div_config``). ``dcqcn``'s ``pow`` is PyTorch's, which
may differ from XLA's in the last bits.

The electrical analogy (Table 1 of the paper):
  current  lambda = qdot + mu          [bytes/s]
  voltage  v      = q + b*tau          [bytes]
  power    Gamma  = lambda * v         [bytes^2/s],  e = b^2 * tau
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .types import PathObs, MTU


class LawConfig(NamedTuple):
    """Law hyperparameters: scalars (Python numbers) or per-flow [F]
    tensors. The fields of ``repro.core.laws.LawConfig``, so a config
    crosses over field by field (``types.from_numpy``); the fields of laws
    not yet ported are carried and unused."""
    # shared
    gamma: float = 0.9              # EWMA parameter (paper recommendation)
    beta: torch.Tensor = None       # [F] additive increase (bytes) = HostBw*tau/N
    tau: torch.Tensor = None        # [F] base RTT (seconds)
    host_bw: torch.Tensor = None    # [F] NIC rate (bytes/s)
    # hpcc
    hpcc_eta: float = 0.95
    hpcc_max_stage: int = 5
    # timely
    t_low: torch.Tensor = None
    t_high: torch.Tensor = None
    timely_add: torch.Tensor = None
    timely_beta: float = 0.8
    timely_hai_n: int = 5
    # dcqcn
    dcqcn_kmin: float = 400e3
    dcqcn_kmax: float = 1.6e6
    dcqcn_pmax: float = 0.2
    dcqcn_g: float = 1.0 / 256.0
    dcqcn_rai: float = 50e6
    dcqcn_timer: float = 55e-6
    dcqcn_cnp_timer: float = 50e-6
    dcqcn_f: int = 5
    # reno
    reno_md: float = 0.5
    # retcp (core/rdcn.py): its circuit schedule (a ScheduleParams, nested;
    # ``fluid.stack_law_configs`` stacks it leaf by leaf) and prebuffer
    sched: tuple = None
    retcp_prebuffer: float = 0.0
    # feedback-channel laws
    fncc_eta: float = 0.95
    pulser_n: float = 8.0
    bp_xoff: float = 2e6
    bp_xon: float = 1e6
    bp_md: float = 0.5
    pcc_eps: float = 0.05
    pcc_b: float = 512.0


# --------------------------------------------------------------------------
# Power computation (Algorithm 1, NORMPOWER) — shared helpers
# --------------------------------------------------------------------------

def norm_power_int(obs: PathObs, cfg: LawConfig) -> torch.Tensor:
    """Per-flow max over path hops of normalized power (INT variant):
    Gamma' = (qdot + mu) * (q + b*tau), e = b^2 * tau, Gamma'_norm = Gamma'/e.
    Written in ``repro``'s association: base = (b*tau)*b and an explicit
    reciprocal multiply."""
    tau = cfg.tau[..., None]
    current = obs.qdot + obs.mu                      # [F,H] bytes/s
    bdp = obs.b * tau                                # [F,H] bytes (b*tau)
    voltage = obs.q + bdp                            # [F,H] bytes
    base = bdp * obs.b                               # [F,H] b^2 * tau
    power = current * voltage
    g = torch.where(obs.valid,
                    power * (1.0 / torch.clamp_min(base, 1.0)), 0.0)
    return torch.amax(g, dim=-1)                     # [F]


def norm_power_theta(theta: torch.Tensor, theta_prev: torch.Tensor,
                     dt_obs: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """theta-PowerTCP (Algorithm 2): Gamma_norm = (thetadot + 1) * theta / tau."""
    thetadot = (theta - theta_prev) / torch.clamp_min(dt_obs, 1e-12)
    return (thetadot + 1.0) * theta / torch.clamp_min(tau, 1e-12)


def _smooth(prev, new, dt_obs, tau):
    """Gamma_smooth update (Alg. 1 line 24), with dt clipped to tau."""
    d = torch.minimum(torch.clamp_min(dt_obs, 0.0), tau)
    blend = prev * (tau - d) + new * d
    return blend / torch.clamp_min(tau, 1e-12)


def _ewma(gamma, target, w):
    """``gamma * target + (1 - gamma) * w``, each product rounded."""
    return gamma * target + (1.0 - gamma) * w


def _mimd_update(w, w_old, norm_power, cfg: LawConfig, upd_mask):
    """UPDATEWINDOW (Alg. 1 line 27): EWMA of (w_old / Gamma_norm + beta)."""
    target = w_old / torch.clamp_min(norm_power, 1e-9) + cfg.beta
    w_new = _ewma(cfg.gamma, target, w)
    return torch.where(upd_mask, torch.clamp_min(w_new, MTU), w)


# --------------------------------------------------------------------------
# PowerTCP (INT)
# --------------------------------------------------------------------------

class PowerTCPState(NamedTuple):
    gamma_smooth: torch.Tensor      # [F]


def powertcp_init(n, cfg):
    return PowerTCPState(gamma_smooth=torch.ones(
        (n,), dtype=torch.float32, device=cfg.tau.device))


def powertcp_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    gnorm = norm_power_int(obs, cfg)
    gs = torch.where(upd_mask,
                     _smooth(state.gamma_smooth, gnorm, obs.dt_obs, cfg.tau),
                     state.gamma_smooth)
    w = _mimd_update(w, obs.w_old, gs, cfg, upd_mask)
    return PowerTCPState(gs), w, rate_cap


# --------------------------------------------------------------------------
# theta-PowerTCP (timestamps only)
# --------------------------------------------------------------------------

class ThetaPowerTCPState(NamedTuple):
    gamma_smooth: torch.Tensor
    prev_theta: torch.Tensor


def theta_powertcp_init(n, cfg):
    ones = torch.ones((n,), dtype=torch.float32, device=cfg.tau.device)
    return ThetaPowerTCPState(ones, cfg.tau.to(torch.float32) * ones)


def theta_powertcp_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    gnorm = norm_power_theta(obs.theta, state.prev_theta, obs.dt_obs, cfg.tau)
    gs = torch.where(upd_mask,
                     _smooth(state.gamma_smooth, gnorm, obs.dt_obs, cfg.tau),
                     state.gamma_smooth)
    w = _mimd_update(w, obs.w_old, gs, cfg, upd_mask)
    prev = torch.where(upd_mask, obs.theta, state.prev_theta)
    return ThetaPowerTCPState(gs, prev), w, rate_cap


# --------------------------------------------------------------------------
# HPCC
# --------------------------------------------------------------------------

def div_config(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a law-config divisor ``d``, rounded as ``repro``'s
    compiled engines round it. A Python scalar is a constant of the XLA
    program, and XLA rewrites a division by a constant into a product
    with its float32 reciprocal, ``float32(1) / float32(d)``; so does this
    (the card's torch would also turn ``x / python_float`` into a product,
    but with the reciprocal rounded from double). A tensor leaf (a stacked
    config) is an input of the program, and there it is a division."""
    if isinstance(d, torch.Tensor):
        return x / d
    return x * float(np.float32(1.0) / np.float32(d))


class HPCCState(NamedTuple):
    u: torch.Tensor                 # EWMA max-link utilization proxy
    wc: torch.Tensor                # per-RTT reference window
    inc_stage: torch.Tensor         # int32
    last_ref: torch.Tensor          # time of last wc reference update


def hpcc_init(n, cfg):
    dev = cfg.tau.device
    return HPCCState(torch.ones((n,), dtype=torch.float32, device=dev),
                     (cfg.host_bw * cfg.tau).to(torch.float32)
                     * torch.ones((n,), dtype=torch.float32, device=dev),
                     torch.zeros((n,), dtype=torch.int32, device=dev),
                     torch.zeros((n,), dtype=torch.float32, device=dev))


def hpcc_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """HPCC: per-ack window update against a once-per-RTT reference wc
    (Li et al. SIGCOMM'19, Alg. 1)."""
    tau = cfg.tau[..., None]
    u_link = torch.where(obs.valid,
                         obs.q / torch.clamp_min(obs.b * tau, 1.0) +
                         obs.mu / torch.clamp_min(obs.b, 1.0), 0.0)
    u_max = torch.amax(u_link, dim=-1)
    u = torch.where(upd_mask, _smooth(state.u, u_max, obs.dt_obs, cfg.tau),
                    state.u)
    over = (u >= cfg.hpcc_eta) | (state.inc_stage >= cfg.hpcc_max_stage)
    w_mimd = state.wc / torch.clamp_min(
        div_config(u, cfg.hpcc_eta), 1e-6) + cfg.beta
    w_ai = state.wc + cfg.beta
    w_new = torch.where(over, w_mimd, w_ai)
    w_out = torch.where(upd_mask, torch.clamp_min(w_new, MTU), w)
    ref = upd_mask & (t - state.last_ref >= obs.theta)
    wc = torch.where(ref, w_out, state.wc)
    inc = torch.where(ref, torch.where(over, 0, state.inc_stage + 1),
                      state.inc_stage)
    last_ref = torch.where(ref, t, state.last_ref)
    return HPCCState(u, wc, inc, last_ref), w_out, rate_cap


# --------------------------------------------------------------------------
# Swift / FAST class: delay-based MIMD (paper Eq. 26)
# --------------------------------------------------------------------------

class SwiftState(NamedTuple):
    dummy: torch.Tensor


def swift_init(n, cfg):
    return SwiftState(torch.zeros((n,), dtype=torch.float32,
                                  device=cfg.tau.device))


def swift_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    f = torch.clamp_min(obs.theta, 1e-12)
    target = obs.w_old * cfg.tau / f + cfg.beta
    w_new = _ewma(cfg.gamma, target, w)
    w = torch.where(upd_mask, torch.clamp_min(w_new, MTU), w)
    return state, w, rate_cap


# --------------------------------------------------------------------------
# Pure RTT-gradient MIMD (paper Eq. 27)
# --------------------------------------------------------------------------

class GradState(NamedTuple):
    prev_theta: torch.Tensor


def gradient_init(n, cfg):
    return GradState(cfg.tau.to(torch.float32) * torch.ones(
        (n,), dtype=torch.float32, device=cfg.tau.device))


def gradient_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    thetadot = (obs.theta - state.prev_theta) / torch.clamp_min(obs.dt_obs,
                                                                1e-12)
    f = torch.clamp_min(thetadot + 1.0, 1e-2)
    target = obs.w_old / f + cfg.beta
    w_new = _ewma(cfg.gamma, target, w)
    w = torch.where(upd_mask, torch.clamp_min(w_new, MTU), w)
    prev = torch.where(upd_mask, obs.theta, state.prev_theta)
    return GradState(prev), w, rate_cap


# --------------------------------------------------------------------------
# TIMELY (rate-based, gradient + HAI)
# --------------------------------------------------------------------------

class TimelyState(NamedTuple):
    rate: torch.Tensor
    prev_theta: torch.Tensor
    neg_count: torch.Tensor         # int32 consecutive negative gradients


def timely_init(n, cfg):
    dev = cfg.tau.device
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    return TimelyState(cfg.host_bw.to(torch.float32) * ones,
                       cfg.tau.to(torch.float32) * ones,
                       torch.zeros((n,), dtype=torch.int32, device=dev))


def timely_params(cfg):
    """(t_low, t_high, additive step) of TIMELY, the defaults 1.5 tau,
    3 tau and host_bw / 100 (an explicit multiply by float32(0.01), as in
    ``repro``) where the config leaves them None."""
    t_low = cfg.t_low if cfg.t_low is not None else 1.5 * cfg.tau
    t_high = cfg.t_high if cfg.t_high is not None else 3.0 * cfg.tau
    add = cfg.timely_add if cfg.timely_add is not None \
        else cfg.host_bw * (1.0 / 100.0)
    return t_low, t_high, add


def timely_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    t_low, t_high, add = timely_params(cfg)
    grad = (obs.theta - state.prev_theta) / torch.clamp_min(cfg.tau, 1e-12)
    neg = torch.where(grad <= 0, state.neg_count + 1, 0)
    hai = neg >= cfg.timely_hai_n
    r = state.rate
    step = torch.where(hai, cfg.timely_hai_n * add, add)
    r_low = r + step
    r_high = r * (1.0 - cfg.timely_beta *
                  (1.0 - t_high / torch.clamp_min(obs.theta, 1e-12)))
    r_grad_neg = r + step
    r_grad_pos = r * torch.clamp_min(1.0 - cfg.timely_beta * grad, 0.5)
    r_mid = torch.where(grad <= 0, r_grad_neg, r_grad_pos)
    r_new = torch.where(obs.theta < t_low, r_low,
                        torch.where(obs.theta > t_high, r_high, r_mid))
    r_new = torch.clamp(r_new, 0.001 * cfg.host_bw, cfg.host_bw)
    rate = torch.where(upd_mask, r_new, state.rate)
    # window bookkeeping: w tracks rate*theta so FCT logic stays uniform
    w = torch.where(upd_mask, torch.clamp_min(rate * obs.theta, MTU), w)
    prev = torch.where(upd_mask, obs.theta, state.prev_theta)
    return TimelyState(rate, prev, torch.where(upd_mask, neg,
                                               state.neg_count)), w, rate


# --------------------------------------------------------------------------
# DCQCN (fluid approximation)
# --------------------------------------------------------------------------

class DCQCNState(NamedTuple):
    rc: torch.Tensor                # current rate
    rt: torch.Tensor                # target rate
    alpha: torch.Tensor
    t_last_cut: torch.Tensor
    t_last_inc: torch.Tensor
    inc_stage: torch.Tensor         # int32


def dcqcn_init(n, cfg):
    dev = cfg.tau.device
    hb = cfg.host_bw.to(torch.float32) * torch.ones(
        (n,), dtype=torch.float32, device=dev)
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    return DCQCNState(hb, hb, torch.ones((n,), dtype=torch.float32,
                                         device=dev), z, z,
                      torch.zeros((n,), dtype=torch.int32, device=dev))


def dcqcn_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """ECN-marking-driven rate control. ``upd_mask`` fires per RTT; timers
    gate the actual cut/increase cadence. The rate clamp runs on every
    row (an identity on in-range rates) and the rate is the rate cap."""
    p = obs.ecn_frac                                  # marking prob
    # probability >=1 marked packet among packets sent since last update
    pkts = torch.clamp_min(div_config(state.rc * obs.dt_obs, MTU), 1.0)
    pe = 1.0 - torch.pow(torch.clamp(1.0 - p, 0.0, 1.0), pkts)
    cut = upd_mask & (pe > 0.01) & (t - state.t_last_cut
                                    >= cfg.dcqcn_cnp_timer)
    alpha = torch.where(cut, _ewma(cfg.dcqcn_g, pe, state.alpha),
                        state.alpha)
    rt = torch.where(cut, state.rc, state.rt)
    # expected-value (fluid) cut: scale the alpha/2 cut by the mark fraction
    rc = torch.where(cut, state.rc * (1.0 - 0.5 * alpha *
                                      torch.clamp_max(pe, 1.0)), state.rc)
    t_cut = torch.where(cut, t, state.t_last_cut)
    # increase path: timer since last increase and no recent cut
    can_inc = upd_mask & ~cut & (t - state.t_last_inc >= cfg.dcqcn_timer)
    stage = torch.where(cut, 0, state.inc_stage)
    fast = stage < cfg.dcqcn_f
    hyper = stage >= 2 * cfg.dcqcn_f
    rai = torch.where(hyper, 5.0 * cfg.dcqcn_rai, cfg.dcqcn_rai)
    rt_inc = torch.where(fast, rt, rt + rai)
    rc_inc = 0.5 * (rc + rt_inc)
    rc = torch.where(can_inc, rc_inc, rc)
    rt = torch.where(can_inc, rt_inc, rt)
    stage = torch.where(can_inc, stage + 1, stage)
    t_inc = torch.where(can_inc, t, state.t_last_inc)
    # alpha decay toward 0 when no congestion (DCQCN alpha-update timer)
    alpha = torch.where(can_inc, (1.0 - cfg.dcqcn_g) * alpha, alpha)
    rc = torch.clamp(rc, 0.001 * cfg.host_bw, cfg.host_bw)
    w = torch.where(upd_mask, torch.clamp_min(
        rc * torch.maximum(obs.theta, cfg.tau), MTU), w)
    return DCQCNState(rc, rt, alpha, t_cut, t_inc, stage), w, rc


# --------------------------------------------------------------------------
# NewReno-ish AI/MD (loss == bottleneck queue at capacity)
# --------------------------------------------------------------------------

class RenoState(NamedTuple):
    last_cut: torch.Tensor


def reno_init(n, cfg):
    return RenoState(torch.zeros((n,), dtype=torch.float32,
                                 device=cfg.tau.device))


def reno_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    # loss proxy: a hop's queue within 5% of its buffer is signalled as a
    # hard mark, ecn_frac >= 1
    loss = obs.ecn_frac >= 1.0
    can_cut = upd_mask & loss & (t - state.last_cut > obs.theta)
    # MD on loss (at most once per RTT), else AI of one MTU per update
    w_new = torch.where(can_cut, w * cfg.reno_md,
                        torch.where(upd_mask, w + MTU, w))
    w_new = torch.clamp_min(w_new, MTU)
    last = torch.where(can_cut, t, state.last_cut)
    return RenoState(last), w_new, rate_cap


class Law(NamedTuple):
    """A congestion-control law bound to one concrete backend (see
    ``repro.core.laws.Law`` for the full contract). ``backend`` names the
    implementation bound to ``update``: ``"reference"`` (plain PyTorch),
    ``"fused"`` (the hand-written CUDA kernels on the card, their plain
    versions on the CPU; ``core/backends.py``) or ``"megakernel"`` (the
    reference update, composed into the whole-tick engine). The ``uses_*`` flags
    declare the ``PathObs`` telemetry a law reads; ``feedback`` names the
    feedback-path delay model."""
    name: str
    init: Callable
    update: Callable
    rate_based: bool = False
    backend: str = "reference"
    uses_qdot: bool = True
    uses_mu: bool = True
    uses_ecn: bool = True
    masked_updates: bool = True
    feedback: str = "receiver"
    uses_pause: bool = False
    uses_incast: bool = False


LAWS = {
    "powertcp": Law("powertcp", powertcp_init, powertcp_update,
                    uses_ecn=False),
    "theta_powertcp": Law("theta_powertcp", theta_powertcp_init,
                          theta_powertcp_update, uses_qdot=False,
                          uses_mu=False, uses_ecn=False),
    "hpcc": Law("hpcc", hpcc_init, hpcc_update, uses_qdot=False,
                uses_ecn=False),
    "swift": Law("swift", swift_init, swift_update, uses_qdot=False,
                 uses_mu=False, uses_ecn=False),
    "gradient_mimd": Law("gradient_mimd", gradient_init, gradient_update,
                         uses_qdot=False, uses_mu=False, uses_ecn=False),
    "timely": Law("timely", timely_init, timely_update, rate_based=True,
                  uses_qdot=False, uses_mu=False, uses_ecn=False),
    "dcqcn": Law("dcqcn", dcqcn_init, dcqcn_update, rate_based=True,
                 uses_qdot=False, uses_mu=False),
    "reno": Law("reno", reno_init, reno_update, uses_qdot=False,
                uses_mu=False),
}

# law name -> {backend name -> update callable}. ``"fused"`` entries are
# registered on import of ``core.backends``. Every law also carries a
# ``"megakernel"`` entry, its reference update: the whole-tick engine
# (``core/megakernel.py``) composes it into its plain tick, and K4 carries
# the same arithmetic for the laws it implements. ``get_law`` is the
# single dispatch point; it never falls back silently.
LAW_BACKENDS: dict = {name: {"reference": law.update,
                             "megakernel": law.update}
                      for name, law in LAWS.items()}

# (law name, backend name) -> observe-and-update routine
# ``fn(law, static, cfg, tick) -> (law_state, w, rate_cap, next_update,
# last_update)``: one tick's delayed observation, law update, window clamp
# and update times for a bound law, in place of the engine's generic
# sequence (``fluid._law_tick``: ``fluid._observe``, then ``law.update``,
# then the clamp and the update times), which it must equal. ``tick`` is a
# ``fluid.LawTick``. ``core.backends`` registers the fused PowerTCP laws'
# (K1/K2 in their observe form). ``observe_step`` is the lookup.
OBSERVE_STEPS: dict = {}

# Telemetry channels and feedback-path models a law may declare
# (validated at registration, as in ``repro``).
ENGINE_CHANNELS = ("qdot", "mu", "ecn", "pause", "incast")
FEEDBACK_MODELS = ("receiver", "hop")


def _validate_law(law) -> None:
    """Raise ``ValueError`` if a law declares a channel no engine provides
    or an unknown feedback-path model."""
    name = getattr(law, "name", "<unnamed>")
    for field in getattr(law, "_fields", ()):
        if field.startswith("uses_") and field[5:] not in ENGINE_CHANNELS:
            raise ValueError(
                f"law '{name}' declares '{field}' but no engine provides a "
                f"'{field[5:]}' channel; available channels: "
                f"{ENGINE_CHANNELS}")
    fb = getattr(law, "feedback", "receiver")
    if fb not in FEEDBACK_MODELS:
        raise ValueError(
            f"law '{name}' declares feedback={fb!r}; engines implement "
            f"{FEEDBACK_MODELS}")


def register_law(law: Law) -> None:
    """Add a law to the registry; its ``update`` becomes the
    ``"reference"`` and ``"megakernel"`` backends. Re-registering a name
    resets its backends."""
    _validate_law(law)
    LAWS[law.name] = law
    LAW_BACKENDS[law.name] = {"reference": law.update,
                              "megakernel": law.update}
    for key in [k for k in OBSERVE_STEPS if k[0] == law.name]:
        del OBSERVE_STEPS[key]


def register_backend(law_name: str, backend: str, update: Callable) -> None:
    """Register an alternative ``update`` implementation for a law; it
    must honour the law's state, ``PathObs`` and masking contract."""
    if law_name not in LAWS:
        raise KeyError(f"unknown law '{law_name}'; have {sorted(LAWS)}")
    LAW_BACKENDS.setdefault(law_name, {})[backend] = update


def register_observe_step(law_name: str, backend: str,
                          fn: Callable) -> None:
    """Register the observe-and-update routine of a law's backend (see
    ``OBSERVE_STEPS``); the backend must be registered first."""
    if backend not in LAW_BACKENDS.get(law_name, {}):
        raise KeyError(f"law '{law_name}' has no backend '{backend}'")
    OBSERVE_STEPS[(law_name, backend)] = fn


def observe_step(law: Law) -> Optional[Callable]:
    """The observe-and-update routine of a bound law, or None. It is the
    one registered for the law's (name, backend), and only while
    ``law.update`` is that backend's registered update: a ``Law`` built
    around another update keeps the engine's generic sequence."""
    fn = OBSERVE_STEPS.get((law.name, law.backend))
    if fn is None or LAW_BACKENDS.get(law.name, {}).get(law.backend) \
            is not law.update:
        return None
    return fn


def law_backends(name: str) -> list:
    """Names of the backends available for ``name``."""
    return sorted(LAW_BACKENDS.get(name, {}))


def get_law(name: str, backend: str = "reference") -> Law:
    """Resolve a law bound to a concrete backend; raises ``KeyError`` for
    unknown laws or backends."""
    if name not in LAWS:
        raise KeyError(f"unknown law '{name}'; have {sorted(LAWS)}")
    impls = LAW_BACKENDS[name]
    if backend not in impls:
        raise KeyError(f"law '{name}' has no backend '{backend}'; "
                       f"have {sorted(impls)}")
    return LAWS[name]._replace(update=impls[backend], backend=backend)


for _law in LAWS.values():
    _validate_law(_law)
del _law
