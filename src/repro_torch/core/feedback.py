"""Feedback-channel law families (twin of ``repro.core.feedback``).

Four congestion-control families that the receiver-echo INT loop cannot
express, each reading one of the feedback paths the engines carry for
them (``Law.feedback`` / ``uses_pause`` / ``uses_incast``):

  fncc          congestion-point feedback: the congested switch notifies
                the sender over the reverse path, so hop h's telemetry is
                tf_h old instead of rtt - tf_h; an HPCC-style utilization
                MIMD on that shorter loop (FNCC).
  pulser        incast notification: switches report each queue's live
                sender count; when it reaches ``pulser_n`` the sender
                snaps its window to the fair share b*tau/n in one update
                (Pulser).
  backpressure  hop-by-hop per-queue pausing: a queue raises XOFF at
                ``bp_xoff`` and clears it at ``bp_xon`` (the engines'
                ``fluid._pause_step``); senders cut multiplicatively while
                a path hop is paused and add ``beta`` otherwise (PFC-like).
  pcc           online utility racing: each update scores a rational
                delay-penalized utility at five probe rates and moves to
                the best (PCC).

Importing this module registers the four laws (``core/__init__`` does),
with the ``"reference"`` and ``"megakernel"`` backends; ``repro`` has no
fused backend for them, so ``get_law(name, "fused")`` raises.

Numerics, as in ``repro``'s compiled engines: FNCC's ``u / fncc_eta``
divides as ``laws.div_config`` (a Python-scalar eta is a constant that
XLA turns into a product with its float32 reciprocal); PCC's argmax
takes the first maximal probe, and a NaN score counts as the maximum
(``jnp.argmax``'s rule), written out as a left-to-right scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .laws import Law, _ewma, _smooth, div_config, register_law
from .types import MTU


def _ones(n, cfg) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=cfg.tau.device)


# --------------------------------------------------------------------------
# FNCC: congestion-point feedback (hop-delay telemetry)
# --------------------------------------------------------------------------

class FNCCState(NamedTuple):
    u: torch.Tensor                 # EWMA max-link utilization proxy


def fncc_init(n, cfg):
    return FNCCState(_ones(n, cfg))


def fncc_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """HPCC's per-link utilization (q / BDP + mu / b), read over the
    reverse path, and the direct fixed-point window w_old / (u / eta) +
    beta."""
    tau = cfg.tau[..., None]
    u_link = torch.where(obs.valid,
                         obs.q / torch.clamp_min(obs.b * tau, 1.0) +
                         obs.mu / torch.clamp_min(obs.b, 1.0), 0.0)
    u_max = torch.amax(u_link, dim=-1)
    u = torch.where(upd_mask, _smooth(state.u, u_max, obs.dt_obs, cfg.tau),
                    state.u)
    target = obs.w_old / torch.clamp_min(div_config(u, cfg.fncc_eta),
                                         1e-6) + cfg.beta
    w_new = _ewma(cfg.gamma, target, w)
    w = torch.where(upd_mask, torch.clamp_min(w_new, MTU), w)
    return FNCCState(u), w, rate_cap


# --------------------------------------------------------------------------
# Pulser: incast notification fast response
# --------------------------------------------------------------------------

class PulserState(NamedTuple):
    dummy: torch.Tensor


def pulser_init(n, cfg):
    return PulserState(torch.zeros((n,), dtype=torch.float32,
                                   device=cfg.tau.device))


def pulser_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """When a path hop's live sender count reaches ``pulser_n``, clamp
    the window to the tightest fair share min_h(b_h / n_h) * tau (never
    raising it); otherwise add beta."""
    n_hop = obs.incast                                   # [F,H]
    n_max = torch.amax(torch.where(obs.valid, n_hop, 0.0), dim=-1)
    share = torch.amin(torch.where(obs.valid & (n_hop > 0.0),
                                   obs.b / torch.clamp_min(n_hop, 1.0),
                                   float("inf")), dim=-1)
    w_fair = torch.clamp_min(share * cfg.tau, MTU)
    pulse = n_max >= cfg.pulser_n
    w_new = torch.where(pulse, torch.minimum(w, w_fair), w + cfg.beta)
    w = torch.where(upd_mask, torch.clamp_min(w_new, MTU), w)
    return state, w, rate_cap


# --------------------------------------------------------------------------
# Backpressure: hop-by-hop per-queue pausing
# --------------------------------------------------------------------------

class BackpressureState(NamedTuple):
    last_cut: torch.Tensor


def backpressure_init(n, cfg):
    return BackpressureState(torch.zeros((n,), dtype=torch.float32,
                                         device=cfg.tau.device))


def backpressure_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """AI/MD against the pause channel: while a path hop is paused the
    window is multiplied by ``bp_md``, at most once per RTT; an unpaused
    update adds beta. Every row takes the MTU floor."""
    paused = torch.amax(torch.where(obs.valid, obs.pause, 0.0),
                        dim=-1) > 0.5
    can_cut = upd_mask & paused & (t - state.last_cut > obs.theta)
    w_new = torch.where(can_cut, w * cfg.bp_md,
                        torch.where(upd_mask & ~paused, w + cfg.beta, w))
    w_new = torch.clamp_min(w_new, MTU)
    last = torch.where(can_cut, t, state.last_cut)
    return BackpressureState(last), w_new, rate_cap


# --------------------------------------------------------------------------
# PCC: online utility racing
# --------------------------------------------------------------------------

class PCCState(NamedTuple):
    rate: torch.Tensor


def pcc_init(n, cfg):
    return PCCState(cfg.host_bw.to(torch.float32) * _ones(n, cfg))


# the probe ladder: rate multipliers 1 + pcc_eps * {-2..2}
PCC_PROBES = (-2.0, -1.0, 0.0, 1.0, 2.0)


def pcc_multipliers(cfg) -> list:
    """The five probe multipliers, each ``1 + pcc_eps * p`` in float32
    (a Python ``pcc_eps`` as float32, a stacked one per scenario)."""
    eps = cfg.pcc_eps
    if not isinstance(eps, torch.Tensor):
        eps = torch.tensor(eps, dtype=torch.float32,
                           device=cfg.host_bw.device)
    return [1.0 + eps * p for p in PCC_PROBES]


def pcc_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """Score u(r) = -host_bw / r - (pcc_b / host_bw) * excess * r at the
    five probe rates r = rate * m (excess = max(theta - tau, 0) / tau,
    the queueing-delay ratio) and jump to the best, clipped to
    [0.001, 1] x host_bw. The rate is also the rate cap."""
    hb = cfg.host_bw
    excess = (torch.clamp_min(obs.theta - cfg.tau, 0.0) /
              torch.clamp_min(cfg.tau, 1e-12))
    penalty = cfg.pcc_b / torch.clamp_min(hb, 1.0)
    best_r = best_s = None
    for m in pcc_multipliers(cfg):
        r = state.rate * m
        waste = hb / torch.clamp_min(r, 1.0)
        score = -waste - (excess * r) * penalty
        if best_s is None:
            best_r, best_s = r, score
            continue
        # jnp.argmax: the first maximum; a NaN beats every number
        take = (score > best_s) | (torch.isnan(score) & ~torch.isnan(best_s))
        best_r = torch.where(take, r, best_r)
        best_s = torch.where(take, score, best_s)
    r_new = torch.clamp(best_r, 0.001 * hb, hb)
    rate = torch.where(upd_mask, r_new, state.rate)
    w = torch.where(upd_mask, torch.clamp_min(rate * obs.theta, MTU), w)
    return PCCState(rate), w, rate


FEEDBACK_LAWS = (
    Law("fncc", fncc_init, fncc_update, feedback="hop",
        uses_qdot=False, uses_ecn=False),
    Law("pulser", pulser_init, pulser_update, feedback="hop",
        uses_qdot=False, uses_mu=False, uses_ecn=False, uses_incast=True),
    Law("backpressure", backpressure_init, backpressure_update,
        feedback="hop", uses_qdot=False, uses_mu=False, uses_ecn=False,
        uses_pause=True),
    Law("pcc", pcc_init, pcc_update, rate_based=True,
        uses_qdot=False, uses_mu=False, uses_ecn=False),
)

for _law in FEEDBACK_LAWS:
    register_law(_law)
del _law
