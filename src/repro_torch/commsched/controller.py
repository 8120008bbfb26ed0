"""Window controllers for chunked cross-pod (DCN) collectives.

The DCN gradient/delta reduction is the paper's congested pipe retold: a
shared, oversubscribed link whose available bandwidth varies (other jobs,
reconfigurable optical fabrics). The scheduler keeps a **window** of
outstanding bucket bytes; the controller updates it from per-bucket
timestamps — exactly theta-PowerTCP (Algorithm 2: RTT + RTT-gradient only),
since a cross-pod fabric exposes no INT to the collective layer.

Controllers (all update on a bucket ACK):
  theta_powertcp   Gamma_norm = (1 + theta_dot) * theta / tau, MIMD on power
  hpcc_like        voltage-only MIMD: U = theta/tau (inflight/BDP proxy)
  aimd             TCP-style: +MTU per ack, halve on theta > 1.5 tau
  static           fixed window (the "well-provisioned" assumption)

State is plain floats — this runs in the host control loop between steps,
not on the device. (A copy of ``repro.commsched.controller``: the same
names and results.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ControllerConfig:
    tau: float                  # base RTT of the DCN path (seconds)
    bw_est: float               # nominal bandwidth (bytes/s) for init/beta
    gamma: float = 0.9          # EWMA (paper recommendation)
    beta_frac: float = 0.05     # additive increase = beta_frac * BDP
    hpcc_eta: float = 0.95
    aimd_md: float = 0.5
    static_bdp_mult: float = 1.0
    w_min: float = 64e3         # one bucket minimum
    w_max_mult: float = 32.0    # cap: multiple of nominal BDP


class WindowController:
    """Base: fixed window at static_bdp_mult * BDP."""

    name = "static"

    def __init__(self, cfg: ControllerConfig):
        self.cfg = cfg
        self.bdp = cfg.bw_est * cfg.tau
        self.w = cfg.static_bdp_mult * self.bdp
        self.prev_theta: Optional[float] = None
        self.prev_t: Optional[float] = None
        self.w_old = self.w
        self.gamma_smooth = 1.0

    def _clip(self):
        self.w = min(max(self.w, self.cfg.w_min),
                     self.cfg.w_max_mult * self.bdp)

    def on_ack(self, t: float, theta: float, bytes_acked: float):
        pass                                   # static: no reaction

    def window(self) -> float:
        return self.w


class ThetaPowerTCP(WindowController):
    """Algorithm 2 of the paper, applied to bucket ACK timestamps."""

    name = "theta_powertcp"

    def on_ack(self, t, theta, bytes_acked):
        cfg = self.cfg
        if self.prev_theta is None:
            self.prev_theta, self.prev_t = theta, t
            return
        dt = max(t - self.prev_t, 1e-9)
        theta_dot = (theta - self.prev_theta) / dt
        gnorm = max((theta_dot + 1.0) * theta / cfg.tau, 1e-3)
        # smoothing (Alg. 1 line 24) with dt clipped to tau
        d = min(dt, cfg.tau)
        self.gamma_smooth = (self.gamma_smooth * (cfg.tau - d)
                             + gnorm * d) / cfg.tau
        beta = cfg.beta_frac * self.bdp
        target = self.w_old / self.gamma_smooth + beta
        self.w = cfg.gamma * target + (1.0 - cfg.gamma) * self.w
        self._clip()
        self.w_old = self.w
        self.prev_theta, self.prev_t = theta, t


class HPCCLike(WindowController):
    """Voltage-only MIMD (HPCC-class reference point)."""

    name = "hpcc_like"

    def on_ack(self, t, theta, bytes_acked):
        cfg = self.cfg
        u = max(theta / cfg.tau, 1e-3)          # inflight/BDP proxy
        beta = cfg.beta_frac * self.bdp
        target = self.w_old / max(u / cfg.hpcc_eta, 1e-3) + beta
        self.w = cfg.gamma * target + (1.0 - cfg.gamma) * self.w
        self._clip()
        self.w_old = self.w
        self.prev_theta, self.prev_t = theta, t


class AIMD(WindowController):
    name = "aimd"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.last_cut = -1e9

    def on_ack(self, t, theta, bytes_acked):
        if theta > 1.5 * self.cfg.tau and t - self.last_cut > theta:
            self.w *= self.cfg.aimd_md
            self.last_cut = t
        else:
            self.w += bytes_acked * self.cfg.beta_frac * 4.0
        self._clip()


CONTROLLERS = {
    "theta_powertcp": ThetaPowerTCP,
    "hpcc_like": HPCCLike,
    "aimd": AIMD,
    "static": WindowController,
}


def make_controller(name: str, cfg: ControllerConfig) -> WindowController:
    return CONTROLLERS[name](cfg)
