"""Fluid-model DCN backend for validating window controllers.

Models the cross-pod reduction path as the paper's single-bottleneck pipe
(Eqs. 4/9/10): the scheduler's transmission rate is window-limited,
``lam = min(w / theta, nic)``, the bottleneck queue integrates
``qdot = lam - avail(t)``, and the measured RTT is
``theta = tau + q / avail``. Bucket ACKs fire when the bucket's last byte
drains; the controller sees (ack time, theta) — exactly the telemetry a
chunked collective gets from issue/completion timestamps.

Scoreboard per controller:
  * completion time of an H-byte reduction vs the fluid optimum,
  * standing queue (added latency for co-running latency-sensitive RPCs),
  * adaptation after bandwidth steps (RDCN day/night, contention).

This replays the paper's Fig. 4/8 story at the collective-scheduling layer:
power-based control fills new bandwidth in ~1 RTT and keeps q ~ 0, while
voltage-only reacts late to congestion onset and AIMD oscillates.
(A copy of ``repro.commsched.simbackend``: the same names and results.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .controller import ControllerConfig, make_controller


@dataclasses.dataclass
class DCNConfig:
    tau: float = 1e-3                 # base RTT, seconds (DCN-scale)
    bw: float = 12.5e9                # bytes/s (100 Gbps nominal)
    nic: float = 50e9                 # sender injection cap
    bucket_bytes: float = 4e6
    dt: float = 2e-5                  # sim step
    bg_frac: float = 0.0              # background load fraction of bw
    bw_fn: Optional[Callable] = None  # t -> bytes/s (None: constant)
    bg_fn: Optional[Callable] = None  # t -> bytes/s background arrivals


@dataclasses.dataclass
class SimResult:
    name: str
    completion: float                 # time to finish all buckets (s)
    mean_queue: float                 # bytes (standing bottleneck queue)
    p99_queue: float
    mean_util: float                  # fraction of available bw used
    optimal: float                    # fluid lower bound
    trace: Dict[str, np.ndarray]


def run_reduction(controller_name: str, total_bytes: float, cfg: DCNConfig,
                  horizon: float = 3.0, record: bool = True) -> SimResult:
    ccfg = ControllerConfig(tau=cfg.tau, bw_est=cfg.bw)
    ctl = make_controller(controller_name, ccfg)
    nbuckets = int(np.ceil(total_bytes / cfg.bucket_bytes))

    t, q, sent, served = 0.0, 0.0, 0.0, 0.0
    next_ack = 0                       # next bucket index to ack
    ts, qs, ws, util = [], [], [], []
    completion = None

    while t < horizon and completion is None:
        bw = cfg.bw if cfg.bw_fn is None else float(cfg.bw_fn(t))
        bg = cfg.bg_frac * bw if cfg.bg_fn is None else float(cfg.bg_fn(t))
        avail = max(bw - bg, 1e3)
        theta = cfg.tau + q / avail

        # window-limited injection (outstanding = sent - served)
        w = max(ctl.window(), cfg.bucket_bytes)
        rate = min(w / theta, cfg.nic)
        room = max(w - (sent - served), 0.0)
        inj = min(rate * cfg.dt, total_bytes - sent, room)
        sent += inj

        serve = min(q + inj, avail * cfg.dt)
        q = q + inj - serve
        served += serve

        # bucket ACKs (half-RTT return path folded into theta)
        while next_ack < nbuckets and served >= \
                min((next_ack + 1) * cfg.bucket_bytes, total_bytes) - 1.0:
            ctl.on_ack(t + cfg.dt, theta, cfg.bucket_bytes)
            next_ack += 1
        if record:
            ts.append(t)
            qs.append(q)
            ws.append(w)
            util.append(serve / max(avail * cfg.dt, 1e-9))
        if served >= total_bytes - 1.0:
            completion = t + cfg.dt + cfg.tau / 2.0
        t += cfg.dt

    completion = completion if completion is not None else horizon
    qa = np.asarray(qs) if qs else np.zeros(1)
    ua = np.asarray(util) if util else np.zeros(1)
    opt = _optimal_time(total_bytes, cfg, horizon) + cfg.tau / 2.0
    return SimResult(
        name=controller_name, completion=completion,
        mean_queue=float(qa.mean()), p99_queue=float(np.percentile(qa, 99)),
        mean_util=float(ua.mean()), optimal=float(opt),
        trace={"t": np.asarray(ts), "queue": qa,
               "window": np.asarray(ws), "util": ua})


def _optimal_time(total_bytes, cfg: DCNConfig, horizon):
    t, acc = 0.0, 0.0
    while t < horizon:
        bw = cfg.bw if cfg.bw_fn is None else float(cfg.bw_fn(t))
        bg = cfg.bg_frac * bw if cfg.bg_fn is None else float(cfg.bg_fn(t))
        acc += max(bw - bg, 1e3) * cfg.dt
        if acc >= total_bytes:
            return t
        t += cfg.dt
    return horizon


def rdcn_bw_fn(day: float = 20e-3, night: float = 5e-3,
               hi: float = 50e9, lo: float = 6.25e9) -> Callable:
    """RDCN-style square-wave bandwidth (circuit up during 'day')."""
    period = day + night

    def fn(t):
        return hi if (t % period) < day else lo
    return fn


def contention_bg_fn(base: float = 0.0, burst: float = 0.75,
                     period: float = 40e-3, duty: float = 0.5,
                     bw: float = 12.5e9) -> Callable:
    """Bursty co-tenant traffic stealing `burst` of the link half the time."""
    def fn(t):
        return bw * (burst if (t % period) < duty * period else base)
    return fn
