"""Fused law backends (twin of ``repro.core.backends``).

Importing this module registers the ``"fused"`` backend for ``powertcp``
and ``theta_powertcp``: the whole law update (NORMPOWER, smoothing and
UPDATEWINDOW) in one kernel launch — the hand-written CUDA kernels of
``kernels/powertcp_step.py`` on CUDA tensors, their plain PyTorch versions
on CPU tensors (``kernels/ops.py``).

A fused ``update`` consumes the same ``PathObs`` and state as its
reference twin and is held to it at about 1e-5 (the kernel follows
``repro``'s Pallas kernel, whose association differs slightly from the
reference law's). EWMA ``gamma`` must be a concrete Python number: the
kernels take it as a launch argument, so a fused law cannot sit under a
per-scenario gamma sweep (use the reference backend there).
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .laws import PowerTCPState, ThetaPowerTCPState, register_backend
from .types import MTU


def _static_gamma(cfg):
    if isinstance(cfg.gamma, torch.Tensor) and cfg.gamma.numel() != 1:
        raise ValueError(
            "fused law backends need a concrete (non-batched) gamma; "
            "use backend='reference' for gamma sweeps")
    return float(cfg.gamma)


def powertcp_update_fused(state, obs, w, rate_cap, upd_mask, cfg, t):
    """Algorithm 1 through the fused kernel (NORMPOWER+EWMA+UPDATEWINDOW)."""
    w_new, gs = ops.powertcp_step(
        obs.q, obs.qdot, obs.mu, obs.b, obs.valid, cfg.tau, w, obs.w_old,
        state.gamma_smooth, obs.dt_obs, upd_mask, cfg.beta,
        gamma=_static_gamma(cfg), w_min=MTU)
    return PowerTCPState(gs), w_new, rate_cap


def theta_powertcp_update_fused(state, obs, w, rate_cap, upd_mask, cfg, t):
    """Algorithm 2 through the fused kernel (timestamps only)."""
    w_new, gs, prev = ops.theta_powertcp_step(
        obs.theta, state.prev_theta, cfg.tau, w, obs.w_old,
        state.gamma_smooth, obs.dt_obs, upd_mask, cfg.beta,
        gamma=_static_gamma(cfg), w_min=MTU)
    return ThetaPowerTCPState(gs, prev), w_new, rate_cap


register_backend("powertcp", "fused", powertcp_update_fused)
register_backend("theta_powertcp", "fused", theta_powertcp_update_fused)
