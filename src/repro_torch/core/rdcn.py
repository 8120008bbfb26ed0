"""Reconfigurable-DCN (RDCN) case study (twin of ``repro.core.rdcn``;
paper section 5).

Model: a ToR-pair's traffic drains through one VOQ whose service rate
follows the optical-circuit schedule — ``circuit_bw`` (100G) during this
pair's "day", ``packet_bw`` (25G) through the fallback packet fabric
otherwise. A day lasts 225us, reconfiguration ("night") 20us, and each
pair is connected once per "week" of 24 matchings.

``CircuitSchedule`` is the host-side description; ``ScheduleParams``
(``CircuitSchedule.params()``) its tensor twin, whose leaves may carry a
leading batch axis (``stack_schedules``). ``circuit_up(t, p)`` and
``circuit_bw_at(t, p)`` evaluate a schedule from params;
``circuit_bw_at`` is the ``bw_fn(t, bw_params)`` that the batched
engines take with ``bw_params=stack_schedules(...)``, one schedule per
scenario. ``CircuitSchedule.bw_fn()`` returns the one-argument form and
carries its ``ScheduleParams`` as ``.params``, so that the megakernel's
K4 can evaluate the same schedule in its own body.

The phase ``mod(t - t0 + 1e-7, week)`` is ``torch.remainder``, which
equals ``jnp.mod`` of a traced schedule bit for bit; ``repro``'s serial
runs fold a constant schedule and round the phase otherwise, but the
up/down classification — what the engines read — is the same in every
form (the 0.1us nudge, ``_EDGE_NUDGE``).

reTCP (Mukerjee et al., NSDI'20) is NewReno plus explicit circuit-state
feedback: the effective window is scaled by ``circuit_bw / packet_bw``
while the circuit is up, beginning ``prebuffer`` seconds early. It is
registered as ``"retcp"``, with ``masked_updates=False``: the multiplier
applies to the output window on every tick, not only where the law
updates. It reads the schedule and the prebuffer from
``LawConfig.sched`` / ``LawConfig.retcp_prebuffer``, so both batch like
any other law hyperparameter (``fluid.stack_law_configs``).

``circuit_utilization`` and ``queuing_latency_percentile`` are Fig. 8's
metrics in ``repro``'s arithmetic: the sums in XLA:CPU's order
(``fluid._xla_sum``) and ``jnp.percentile``'s linear interpolation
in the arithmetic XLA:CPU compiles it to (``torch.quantile`` rounds
otherwise).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from .fluid import _xla_sum
from .impair import _EDGE_NUDGE
from .laws import Law, LawConfig, register_law, reno_init, reno_update
from .types import GBPS, US, Topology, resolve_device


class ScheduleParams(NamedTuple):
    """Tensor form of a ``CircuitSchedule`` (float32 leaves, 0-dim or with
    a leading batch axis)."""
    day: torch.Tensor                # seconds the circuit serves this pair
    night: torch.Tensor              # reconfiguration gap (seconds)
    week: torch.Tensor               # full rotation period (seconds)
    t0: torch.Tensor                 # this pair's day start offset (seconds)
    circuit_bw: torch.Tensor         # bytes/s while the circuit is up
    packet_bw: torch.Tensor          # bytes/s through the packet fabric


# Schedule edges fall exactly on ticks; sampling 0.1us past the tick
# start (``_EDGE_NUDGE``, shared with the impairment processes) keeps the
# classification off the float32 knife edge, so every compiled form of
# the phase classifies each tick alike (see ``repro``)
def circuit_up(t_sec, p: ScheduleParams) -> torch.Tensor:
    """Is the circuit serving this pair at ``t_sec`` (elementwise)?"""
    ph = torch.remainder(t_sec - p.t0 + _EDGE_NUDGE, p.week)
    return (ph >= 0.0) & (ph < p.day)


def circuit_bw_at(t_sec, p: ScheduleParams) -> torch.Tensor:
    """The VOQ's service rate at ``t_sec``: [1], or [B, 1] for a batch of
    schedules — the batched ``bw_fn`` for ``simulate_batch(...,
    bw_fn=circuit_bw_at, bw_params=stack_schedules(...))``."""
    b = torch.where(circuit_up(t_sec, p), p.circuit_bw, p.packet_bw)
    return b.to(torch.float32).reshape(tuple(b.shape) + (1,))


@dataclasses.dataclass(frozen=True)
class CircuitSchedule:
    day: float = 225 * US
    night: float = 20 * US
    matchings: int = 24
    slot: int = 0                    # which matching connects our pair
    circuit_bw: float = 100 * GBPS
    packet_bw: float = 25 * GBPS

    @property
    def week(self) -> float:
        return self.matchings * (self.day + self.night)

    def params(self, device="cuda") -> ScheduleParams:
        """The tensor twin on ``device``, each leaf rounded to float32."""
        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)
        return ScheduleParams(
            day=f32(self.day), night=f32(self.night), week=f32(self.week),
            t0=f32(self.slot * (self.day + self.night)),
            circuit_bw=f32(self.circuit_bw), packet_bw=f32(self.packet_bw))

    def up_fn(self, device="cuda") -> Callable:
        p = self.params(device)
        return lambda t_sec: circuit_up(t_sec, p)

    def bw_fn(self, device="cuda") -> Callable:
        """``t_sec -> [1]`` service rate; ``.params`` is its schedule."""
        p = self.params(device)

        def fn(t_sec):
            return circuit_bw_at(t_sec, p)
        fn.params = p
        return fn


def stack_schedules(scheds: List[CircuitSchedule],
                    device="cuda") -> ScheduleParams:
    """Stack schedules along a new leading batch axis ([B] leaves, each a
    tensor of its own)."""
    ps = [s.params(device) for s in scheds]
    return ScheduleParams(*[torch.stack(xs) for xs in zip(*ps)])


def voq_topology(sched: CircuitSchedule, buffer: float = 12e6,
                 device="cuda") -> Topology:
    dev = resolve_device(device)

    def f32(xs):
        return torch.tensor(xs, dtype=torch.float32, device=dev)
    return Topology(
        num_queues=1, bandwidth=f32([sched.packet_bw]), buffer=f32([buffer]),
        switch_of_queue=torch.zeros((1,), dtype=torch.int32, device=dev),
        num_switches=1, switch_buffer=f32([buffer]), dt_alpha=0.0)


class ReTCPState(NamedTuple):
    reno: tuple
    w_base: torch.Tensor


def retcp_init(n, cfg: LawConfig):
    w0 = cfg.host_bw * cfg.tau * torch.ones(
        (n,), dtype=torch.float32, device=cfg.tau.device)
    return ReTCPState(reno=reno_init(n, cfg), w_base=w0)


def _plus_prebuffer(t, prebuffer):
    """``t + prebuffer`` in float32, as ``repro`` adds its float32 time and
    the prebuffer (an engine's time and a Python prebuffer would otherwise
    add in double)."""
    if isinstance(t, torch.Tensor) or isinstance(prebuffer, torch.Tensor):
        return t + prebuffer
    return float(np.float32(t) + np.float32(prebuffer))


def retcp_update(state, obs, w, rate_cap, upd_mask, cfg, t):
    """NewReno + circuit-aware window scaling with prebuffering.

    The NewReno core (``w_base``, its loss state) honours ``upd_mask``;
    the circuit-state multiplier applies to the output window on every
    row and tick (reTCP's circuit feedback is an out-of-band switch
    notification, not ACK-clocked). Schedule and prebuffer come from
    ``cfg.sched`` and ``cfg.retcp_prebuffer``."""
    sp = cfg.sched
    rs, wb, _ = reno_update(state.reno, obs, state.w_base, rate_cap,
                            upd_mask, cfg, t)
    scale_on = (circuit_up(_plus_prebuffer(t, cfg.retcp_prebuffer), sp)
                | circuit_up(t, sp))
    ratio = sp.circuit_bw / sp.packet_bw
    w_out = wb * torch.where(scale_on, ratio, 1.0)
    return ReTCPState(rs, wb), w_out, rate_cap


# masked_updates=False: the multiplier runs every tick, so reTCP is kept
# out of the megakernel's quiet-tick short cut
register_law(Law("retcp", retcp_init, retcp_update, uses_qdot=False,
                 uses_mu=False, masked_updates=False))


def make_retcp_law(sched: CircuitSchedule, prebuffer: float,
                   device="cuda") -> Law:
    """Serial-path convenience: ``"retcp"`` with the schedule and the
    prebuffer baked into a wrapped update (new code passes
    ``LawConfig(sched=..., retcp_prebuffer=...)``)."""
    sp = sched.params(device)

    def update(state, obs, w, rate_cap, upd_mask, cfg, t):
        cfg = cfg._replace(sched=sp, retcp_prebuffer=prebuffer)
        return retcp_update(state, obs, w, rate_cap, upd_mask, cfg, t)

    return Law("retcp", retcp_init, update)


def circuit_utilization(rec_t: torch.Tensor, rec_thru: torch.Tensor,
                        sched: CircuitSchedule) -> float:
    """Mean egress rate during circuit-up ticks / circuit bandwidth."""
    up = sched.up_fn(rec_t.device)(rec_t)
    num = _xla_sum(torch.where(up, rec_thru, 0.0))
    den = torch.clamp_min(_xla_sum(up.to(torch.float32)), 1.0) \
        * sched.circuit_bw
    return float(num / den)


def _fma_f32(a: float, b: float, c: float) -> np.float32:
    """``a * b + c`` of float32 values rounded once to float32 (a fused
    multiply-add), exactly: the nearest float32 to the exact value, ties
    to even."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    r = np.float32(float(exact))
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(x.view(np.int32)) & 1)


def _percentile(x: torch.Tensor, pct: float) -> float:
    """``jnp.percentile(x, pct)`` of a 1-D float32 tensor (method "linear")
    in the arithmetic XLA:CPU compiles it to: the constants folded into
    q = pct * float32(float32(1 / 100) * (n - 1)), the weights w = q -
    floor(q) and 1 - w, and the interpolation contracted into one fused
    multiply-add, high * w + float32(low * (1 - w))."""
    f32 = np.float32
    if bool(torch.isnan(x).any()):
        return float("nan")
    a = torch.sort(x).values.cpu().numpy()
    n = int(a.shape[0])
    q = f32(pct) * f32(f32(f32(1.0) / f32(100.0)) * f32(n - 1))
    lo = min(max(int(np.floor(q)), 0), n - 1)
    hi = min(max(int(np.ceil(q)), 0), n - 1)
    hw = f32(q - f32(np.floor(q)))
    lw = f32(f32(1.0) - hw)
    return float(_fma_f32(float(a[hi]), float(hw), float(f32(a[lo] * lw))))


def queuing_latency_percentile(rec_q: torch.Tensor, rec_t: torch.Tensor,
                               sched: CircuitSchedule, pct: float) -> float:
    """Queuing latency q / b with the instantaneous service rate."""
    dev = rec_q.device
    up = sched.up_fn(dev)(rec_t)
    f32 = dict(dtype=torch.float32, device=dev)
    b = torch.where(up, torch.tensor(sched.circuit_bw, **f32),
                    torch.tensor(sched.packet_bw, **f32))
    return _percentile(rec_q / b, pct)


__all__ = ["CircuitSchedule", "ReTCPState", "ScheduleParams",
           "circuit_bw_at", "circuit_up", "circuit_utilization",
           "make_retcp_law", "queuing_latency_percentile", "retcp_init",
           "retcp_update", "stack_schedules", "voq_topology"]
