"""Plain PyTorch versions of the hand-written kernels (twins of
``repro.kernels.ref``).

Each is written the most obvious way. They are what a wrapper runs on a
CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel against on
the card: K1 and K2 bit for bit (the kernels are built with
``-fmad=false`` and round every product the way these do), K3 at rtol
1e-5 (its arrival sum runs in another order).
"""
from __future__ import annotations

import torch


def powertcp_step_ref(q, qdot, mu, b, valid, tau, w, w_old, gs_prev,
                      dt_obs, upd, beta, gamma=0.9, w_min=1000.0):
    """Algorithm 1 (NORMPOWER + smoothing + UPDATEWINDOW), vectorized over
    flows. Per-hop tensors [F,H]; per-flow tensors [F]. Returns (w, gs)."""
    tau2 = tau[:, None]
    current = qdot + mu
    voltage = q + b * tau2
    base = b * b * tau2
    gnorm = torch.where(valid,
                        current * voltage / torch.clamp_min(base, 1.0), 0.0)
    gmax = torch.amax(gnorm, dim=1)
    d = torch.minimum(torch.clamp_min(dt_obs, 0.0), tau)
    gs = (gs_prev * (tau - d) + gmax * d) / torch.clamp_min(tau, 1e-12)
    gs_out = torch.where(upd, gs, gs_prev)
    target = w_old / torch.clamp_min(gs_out, 1e-9) + beta
    w_new = gamma * target + (1.0 - gamma) * w
    w_out = torch.where(upd, torch.clamp_min(w_new, w_min), w)
    return w_out, gs_out


def theta_powertcp_step_ref(theta, prev_theta, tau, w, w_old, gs_prev,
                            dt_obs, upd, beta, gamma=0.9, w_min=1000.0):
    """Algorithm 2 (theta-PowerTCP): RTT-only power + smoothing +
    UPDATEWINDOW. All per-flow tensors [F]. Returns (w, gs, prev_theta)."""
    thetadot = (theta - prev_theta) / torch.clamp_min(dt_obs, 1e-12)
    gnorm = (thetadot + 1.0) * theta / torch.clamp_min(tau, 1e-12)
    d = torch.minimum(torch.clamp_min(dt_obs, 0.0), tau)
    gs = (gs_prev * (tau - d) + gnorm * d) / torch.clamp_min(tau, 1e-12)
    gs_out = torch.where(upd, gs, gs_prev)
    target = w_old / torch.clamp_min(gs_out, 1e-9) + beta
    w_new = gamma * target + (1.0 - gamma) * w
    w_out = torch.where(upd, torch.clamp_min(w_new, w_min), w)
    prev_out = torch.where(upd, theta, prev_theta)
    return w_out, gs_out, prev_out


def queue_arrivals_ref(lam_del, onehot, q, out_rate, caps, dt):
    """Dense fluid-queue update: arrivals are the incidence-weighted sum
    of the delayed per-hop rates, then q' = clip(q + (arr - out) dt, 0, caps).

    lam_del: [H,F]; onehot: [H,F,Q]; q/out_rate/caps: [Q].
    Returns (arrivals [Q], q_new [Q])."""
    arr = torch.sum(lam_del[:, :, None] * onehot, dim=(0, 1))
    q_new = torch.minimum(torch.clamp_min(q + (arr - out_rate) * dt, 0.0),
                          caps)
    return arr, q_new
