"""Congestion-control laws (twin of ``repro.core.laws``): the registry and
the two PowerTCP laws.

Every law is a pair ``init(nflows, cfg) -> state`` and
``update(state, obs, w, rate_cap, upd_mask, cfg, t) -> (state, w, rate_cap)``
on per-flow tensors; the engines call ``update`` every tick and a law acts
only where ``upd_mask`` is set.

  powertcp        Algorithm 1 (INT feedback; per-hop max normalized power)
  theta_powertcp  Algorithm 2 (RTT + RTT-gradient only)

The other laws of ``repro`` come with later slices.

Numerics: ``repro`` wraps products in ``_pin``/``_nofma`` so that XLA and
LLVM cannot reassociate them or contract them into FMAs. Eager PyTorch
rounds every operation on its own, so here each expression is written in
``repro``'s association and nothing else is needed — as long as no fused
op (``addcmul``, ``lerp``, ``addmm``) replaces a rounded product plus an
add.

The electrical analogy (Table 1 of the paper):
  current  lambda = qdot + mu          [bytes/s]
  voltage  v      = q + b*tau          [bytes]
  power    Gamma  = lambda * v         [bytes^2/s],  e = b^2 * tau
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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
    # retcp
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
    tau = cfg.tau[:, None]
    current = obs.qdot + obs.mu                      # [F,H] bytes/s
    bdp = obs.b * tau                                # [F,H] bytes (b*tau)
    voltage = obs.q + bdp                            # [F,H] bytes
    base = bdp * obs.b                               # [F,H] b^2 * tau
    power = current * voltage
    g = torch.where(obs.valid,
                    power * (1.0 / torch.clamp_min(base, 1.0)), 0.0)
    return torch.amax(g, dim=1)                      # [F]


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


class Law(NamedTuple):
    """A congestion-control law bound to one concrete backend (see
    ``repro.core.laws.Law`` for the full contract). ``backend`` names the
    implementation bound to ``update``: ``"reference"`` (plain PyTorch) or
    ``"fused"`` (the hand-written CUDA kernels on the card, their plain
    versions on the CPU; ``core/backends.py``). The ``uses_*`` flags
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
}

# law name -> {backend name -> update callable}. ``"fused"`` entries are
# registered on import of ``core.backends``. ``get_law`` is the single
# dispatch point; it never falls back silently.
LAW_BACKENDS: dict = {name: {"reference": law.update}
                      for name, law in LAWS.items()}

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
    ``"reference"`` backend. Re-registering a name resets its backends."""
    _validate_law(law)
    LAWS[law.name] = law
    LAW_BACKENDS[law.name] = {"reference": law.update}


def register_backend(law_name: str, backend: str, update: Callable) -> None:
    """Register an alternative ``update`` implementation for a law; it
    must honour the law's state, ``PathObs`` and masking contract."""
    if law_name not in LAWS:
        raise KeyError(f"unknown law '{law_name}'; have {sorted(LAWS)}")
    LAW_BACKENDS.setdefault(law_name, {})[backend] = update


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
