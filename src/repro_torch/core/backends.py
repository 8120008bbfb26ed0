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

The engines call the fused laws through their observe-and-update
routines (``laws.observe_step``), registered here: K1/K2 in their
observe form, one launch a tick that reads the rings and returns the
finished window, on CUDA tensors; on CPU tensors the plain version, the
engine's own op sequence (``fluid._law_tick``: ``fluid._observe``, the
law as ``kernels/ref.py`` spells it, the clamp and the update times).
The device of the tensors alone chooses; there is no fallback. The
``PathObs`` form above stays what ``Law.update`` is.
"""
from __future__ import annotations

import torch

from ..kernels import ops, ref
from ..kernels.powertcp_step import (
    powertcp_observe_step as k1_observe_step,
    theta_powertcp_observe_step as k2_observe_step)
from . import fluid
from .laws import (PowerTCPState, ThetaPowerTCPState, register_backend,
                   register_observe_step)
from .types import MTU


def _static_gamma(cfg):
    if isinstance(cfg.gamma, torch.Tensor) and cfg.gamma.numel() != 1:
        raise ValueError(
            "fused law backends need a concrete (non-batched) gamma; "
            "use backend='reference' for gamma sweeps")
    return float(cfg.gamma)


def _powertcp(step, state, obs, w, rate_cap, upd_mask, cfg):
    w_new, gs = step(
        obs.q, obs.qdot, obs.mu, obs.b, obs.valid, cfg.tau, w, obs.w_old,
        state.gamma_smooth, obs.dt_obs, upd_mask, cfg.beta,
        gamma=_static_gamma(cfg), w_min=MTU)
    return PowerTCPState(gs), w_new, rate_cap


def _theta_powertcp(step, state, obs, w, rate_cap, upd_mask, cfg):
    w_new, gs, prev = step(
        obs.theta, state.prev_theta, cfg.tau, w, obs.w_old,
        state.gamma_smooth, obs.dt_obs, upd_mask, cfg.beta,
        gamma=_static_gamma(cfg), w_min=MTU)
    return ThetaPowerTCPState(gs, prev), w_new, rate_cap


def powertcp_update_fused(state, obs, w, rate_cap, upd_mask, cfg, t):
    """Algorithm 1 through the fused kernel (NORMPOWER+EWMA+UPDATEWINDOW)."""
    return _powertcp(ops.powertcp_step, state, obs, w, rate_cap, upd_mask,
                     cfg)


def theta_powertcp_update_fused(state, obs, w, rate_cap, upd_mask, cfg, t):
    """Algorithm 2 through the fused kernel (timestamps only)."""
    return _theta_powertcp(ops.theta_powertcp_step, state, obs, w, rate_cap,
                           upd_mask, cfg)


# -------------------------------------------------------------------------
# the observe form: plain versions and the registered routines
# -------------------------------------------------------------------------

def powertcp_observe_step_plain(law, static, cfg, tick):
    """The plain version of K1's observe form: ``fluid._law_tick`` with
    Algorithm 1 as ``ref.powertcp_step_ref`` (on any device)."""
    def update(state, obs, w, rate_cap, upd_mask, law_cfg, t):
        return _powertcp(ref.powertcp_step_ref, state, obs, w, rate_cap,
                         upd_mask, law_cfg)
    return fluid._law_tick(update, law, static, cfg, tick)


def theta_powertcp_observe_step_plain(law, static, cfg, tick):
    """The plain version of K2's observe form: ``fluid._law_tick`` with
    Algorithm 2 as ``ref.theta_powertcp_step_ref`` (on any device)."""
    def update(state, obs, w, rate_cap, upd_mask, law_cfg, t):
        return _theta_powertcp(ref.theta_powertcp_step_ref, state, obs, w,
                               rate_cap, upd_mask, law_cfg)
    return fluid._law_tick(update, law, static, cfg, tick)


def _kernel_args(static, cfg, tick) -> dict:
    lc = tick.law_cfg
    slot = tick.slot_flow is not None
    return dict(
        hist_q=tick.hist_q, hist_w=tick.hist_w, path=tick.path,
        tf_steps=tick.tf_steps, rtt_steps=tick.rtt_steps, bw=tick.bw,
        tau=tick.tau, nic=tick.nic, theta_now=tick.theta_now, w=tick.w,
        gs_prev=tick.law_state.gamma_smooth, next_update=tick.next_update,
        last_update=tick.last_update, active=tick.active,
        cfg_tau=lc.tau, cfg_beta=lc.beta,
        t=tick.t, t_sec=tick.t_sec, ptr=tick.ptr, dt=cfg.dt,
        update_period=cfg.update_period, gamma=_static_gamma(lc),
        w_min=MTU, started=tick.started, admit_t=tick.admit_t,
        slot_flow=tick.slot_flow, n_flows=tick.n_flows if slot else None)


def powertcp_observe_step(law, static, cfg, tick):
    """The fused PowerTCP law's observe-and-update routine: K1's observe
    kernel on CUDA tensors, its plain version on CPU tensors."""
    if not ops.on_cuda(tick.w):
        return powertcp_observe_step_plain(law, static, cfg, tick)
    w, gs, nu, lu = k1_observe_step(
        hist_out=tick.hist_out, **_kernel_args(static, cfg, tick))
    return PowerTCPState(gs), w, tick.rate_cap, nu, lu


def theta_powertcp_observe_step(law, static, cfg, tick):
    """The fused theta-PowerTCP law's observe-and-update routine: K2's
    observe kernel on CUDA tensors, its plain version on CPU tensors."""
    if not ops.on_cuda(tick.w):
        return theta_powertcp_observe_step_plain(law, static, cfg, tick)
    w, gs, prev, nu, lu = k2_observe_step(
        prev_theta=tick.law_state.prev_theta,
        **_kernel_args(static, cfg, tick))
    return ThetaPowerTCPState(gs, prev), w, tick.rate_cap, nu, lu


register_backend("powertcp", "fused", powertcp_update_fused)
register_backend("theta_powertcp", "fused", theta_powertcp_update_fused)
register_observe_step("powertcp", "fused", powertcp_observe_step)
register_observe_step("theta_powertcp", "fused", theta_powertcp_observe_step)
