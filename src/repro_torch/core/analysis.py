"""Analytical tools (twin of ``repro.core.analysis``): phase-plane
trajectories (paper Fig. 3), equilibria and linearized eigenvalues
(Theorem 1), convergence constants (Theorem 2).

These integrate the paper's ODE system directly (Eqs. 9/10 and the
per-class window dynamics of Appendix C), independent of the fluid
simulator, in float32 on the CPU: a trajectory is a host loop of Euler
steps (``repro``'s ``lax.scan``), and a phase portrait integrates all its
starting points as one vector, each element the arithmetic of its own
trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ODEConfig:
    b: float = 12.5e9            # bottleneck bandwidth (bytes/s) == 100 Gbps
    tau: float = 20e-6           # base RTT (seconds)
    gamma_r: float = 0.9 / 20e-6  # gamma / delta_t with delta_t = one RTT
    beta_hat: float = 12.5e9 * 20e-6 / 10.0   # aggregate additive increase
    dt: float = 0.2e-6
    steps: int = 4000


def _theta(q, cfg):
    return q / cfg.b + cfg.tau


def window_dot(kind: str, w, q, qdot, cfg: ODEConfig):
    """Per-class aggregate window dynamics (Appendix C Eqs. 25/26/27 and
    Eq. 15); ``kind`` in {voltage_q, voltage_delay, current, power}."""
    if kind == "voltage_q":          # queue-length / inflight MIMD (HPCC)
        e, f = cfg.b * cfg.tau, q + cfg.b * cfg.tau
    elif kind == "voltage_delay":    # delay MIMD (Swift/FAST)
        e, f = cfg.tau, _theta(q, cfg)
    elif kind == "current":          # RTT-gradient MIMD (TIMELY)
        e, f = 1.0, qdot / cfg.b + 1.0
    elif kind == "power":            # PowerTCP: reduces to Eq. 15
        return cfg.gamma_r * (-w + cfg.b * cfg.tau + cfg.beta_hat)
    else:
        raise ValueError(kind)
    return cfg.gamma_r * (w * e / torch.clamp_min(f, 1e-9) - w +
                          cfg.beta_hat)


def _integrate(kind: str, w0, q0, cfg: ODEConfig) -> torch.Tensor:
    """Euler-integrate (q, w) from float32 vectors of starting points;
    returns [steps, P, 2]."""
    q = torch.as_tensor(np.asarray(q0, np.float32))
    w = torch.as_tensor(np.asarray(w0, np.float32))
    out = torch.empty((cfg.steps,) + tuple(q.shape) + (2,),
                      dtype=torch.float32)
    for i in range(cfg.steps):
        th = _theta(q, cfg)
        qdot = torch.where(q > 0.0, w / th - cfg.b,
                           torch.clamp_min(w / th - cfg.b, 0.0))
        wdot = window_dot(kind, w, q, qdot, cfg)
        q = torch.clamp_min(q + qdot * cfg.dt, 0.0)
        w = torch.clamp_min(w + wdot * cfg.dt, 1e3)
        out[i, ..., 0] = q
        out[i, ..., 1] = w
    return out


def trajectory(kind: str, w0: float, q0: float, cfg: ODEConfig):
    """Euler-integrate (q, w) from an initial point; returns [steps, 2]
    (a float32 numpy array)."""
    return _integrate(kind, w0, q0, cfg).numpy()


def phase_portrait(kind: str, cfg: ODEConfig, grid: int = 5):
    """Trajectories from a grid of initial (q0, w0) points (Fig. 3):
    [grid^2, steps, 2], q0-major."""
    bdp = cfg.b * cfg.tau
    q0s = np.linspace(0.0, 4.0 * bdp, grid)
    w0s = np.linspace(0.2 * bdp, 3.0 * bdp, grid)
    q0 = np.repeat(q0s, grid)
    w0 = np.tile(w0s, grid)
    return _integrate(kind, w0, q0, cfg).permute(1, 0, 2).numpy()


def equilibrium_powertcp(cfg: ODEConfig) -> Tuple[float, float]:
    """(w_e, q_e) = (b*tau + beta_hat, beta_hat): Theorem 1."""
    return cfg.b * cfg.tau + cfg.beta_hat, cfg.beta_hat


def eigenvalues_powertcp(cfg: ODEConfig) -> Tuple[float, float]:
    """Linearization eigenvalues (-1/tau, -gamma_r): proof of Theorem 1."""
    return -1.0 / cfg.tau, -cfg.gamma_r


def convergence_time_constant(gamma: float, delta_t: float) -> float:
    """Theorem 2: exponential decay constant delta_t / gamma."""
    return delta_t / gamma


def endpoint_spread(kind: str, cfg: ODEConfig, grid: int = 4) -> float:
    """Spread of final queue lengths across initial conditions, normalized
    by BDP: ~0 for a unique equilibrium (voltage, power), >> 0 for none
    (current)."""
    paths = phase_portrait(kind, cfg, grid)
    finals = paths[:, -1, 0]
    return float((finals.max() - finals.min()) / (cfg.b * cfg.tau))
