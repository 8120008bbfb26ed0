"""Traffic generation (twin of a subset of ``repro.core.workload``):
web-search flow sizes and Poisson arrivals, repeated incast bursts, and
the slot-pool sizing helpers of the flow-slot engine.

Generators take a *fabric*: any object with ``n_hosts``,
``host_group()``, ``load_capacity()`` and
``make_flows(src, dst, sizes, starts, sim_dt, seed=..., device=...)`` —
``LeafSpine`` and ``FabricRoutes`` both qualify. Draws come from
``numpy.random.default_rng(seed)`` in exactly ``repro``'s order, so one
seed gives one trace in both packages.

The web-search distribution is a piecewise log-linear approximation of the
flow-size CDF of Alizadeh et al. (DCTCP, SIGCOMM'10): heavy-tailed, mean
~1.7 MB, >95% of flows under 1 MB while most bytes come from multi-MB
flows.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .network import make_schedule
from .types import Flows, FlowSchedule, KB, MB

# (size_bytes, cdf) anchor points
WEBSEARCH_CDF = np.array([
    (6 * KB, 0.00),
    (10 * KB, 0.15),
    (13 * KB, 0.20),
    (19 * KB, 0.30),
    (33 * KB, 0.40),
    (53 * KB, 0.53),
    (133 * KB, 0.60),
    (667 * KB, 0.70),
    (1.333 * MB, 0.80),
    (4 * MB, 0.90),
    (10 * MB, 0.97),
    (30 * MB, 1.00),
], dtype=np.float64)


def websearch_mean() -> float:
    s, c = WEBSEARCH_CDF[:, 0], WEBSEARCH_CDF[:, 1]
    mids = 0.5 * (s[1:] + s[:-1])
    return float(np.sum(mids * np.diff(c)))


def websearch_sample(rng: np.random.Generator, n: int) -> np.ndarray:
    """Inverse-CDF sampling with log-linear interpolation between anchors."""
    u = rng.uniform(0.0, 1.0, size=n)
    s, c = WEBSEARCH_CDF[:, 0], WEBSEARCH_CDF[:, 1]
    return np.exp(np.interp(u, c, np.log(s))).astype(np.float64)


def _groups(fabric) -> np.ndarray:
    """[n_hosts] cross-group key (rack / edge attachment)."""
    return np.asarray(fabric.host_group())


def poisson_websearch(fabric, load: float, duration: float,
                      sim_dt: float, seed: int = 0,
                      cross_rack_only: bool = True, device="cuda") -> Flows:
    """Poisson flow arrivals sized by the web-search CDF, at an arrival
    byte-rate of ``load * fabric.load_capacity()``."""
    rng = np.random.default_rng(seed)
    cap = fabric.load_capacity()
    lam = load * cap / websearch_mean()          # flows per second
    n = max(int(lam * duration * 1.2) + 16, 16)
    inter = rng.exponential(1.0 / lam, size=n)
    starts = np.cumsum(inter)
    keep = starts < duration
    starts = starts[keep]
    n = len(starts)
    sizes = websearch_sample(rng, n)
    nh = fabric.n_hosts
    src = rng.integers(0, nh, size=n)
    dst = rng.integers(0, nh, size=n)
    if cross_rack_only:
        # re-draw destinations until cross-group (vectorized best effort)
        grp = _groups(fabric)
        for _ in range(8):
            same = grp[src] == grp[dst]
            if not same.any():
                break
            dst[same] = rng.integers(0, nh, size=int(same.sum()))
    # a flow to self is not a network flow: shift it to a neighbour
    dst = np.where(dst == src, (dst + 1) % nh, dst)
    return fabric.make_flows(src, dst, sizes, starts, sim_dt, seed=seed,
                             device=device)


def poisson_websearch_schedule(fabric, load: float,
                               duration: float, sim_dt: float, seed: int = 0,
                               cross_rack_only: bool = True,
                               device="cuda") -> FlowSchedule:
    """``poisson_websearch`` emitted as a time-sorted ``FlowSchedule``."""
    return make_schedule(poisson_websearch(fabric, load, duration, sim_dt,
                                           seed=seed,
                                           cross_rack_only=cross_rack_only,
                                           device=device))


def incast_burst(fabric, fan_in: int, req_bytes: float, n_bursts: int,
                 period: float, sim_dt: float, seed: int = 0,
                 start: float = 0.0, rotate_victims: bool = True,
                 device="cuda") -> Tuple[Flows, List[int]]:
    """Repeated synchronized incast bursts (the Pulser-style workload).

    Burst ``k`` fires at ``start + k * period``: a victim (rotating
    round-robin across hosts, or host 0 with ``rotate_victims=False``)
    receives ``req_bytes`` from each of ``fan_in`` distinct cross-group
    senders at once. Returns (flows on ``device``, the victim's ingress
    queue per burst)."""
    rng = np.random.default_rng(seed)
    grp = _groups(fabric)
    nh = fabric.n_hosts
    src_l, dst_l, sz_l, st_l, bqs = [], [], [], [], []
    for k in range(n_bursts):
        victim = int((k * max(nh // max(n_bursts, 1), 1)) % nh) \
            if rotate_victims else 0
        others = np.nonzero(grp != grp[victim])[0]
        senders = rng.choice(others, size=fan_in,
                             replace=fan_in > len(others))
        src_l.append(senders)
        dst_l.append(np.full(fan_in, victim))
        sz_l.append(np.full(fan_in, req_bytes))
        st_l.append(np.full(fan_in, start + k * period))
        bqs.append(fabric.host_ingress_queue(victim))
    flows = fabric.make_flows(np.concatenate(src_l).astype(np.int64),
                              np.concatenate(dst_l).astype(np.int64),
                              np.concatenate(sz_l), np.concatenate(st_l),
                              sim_dt, seed=seed, device=device)
    return flows, bqs


def peak_concurrency(starts: np.ndarray, ends: np.ndarray) -> int:
    """Maximum number of simultaneously live intervals [start, end)."""
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    ok = np.isfinite(starts)
    starts, ends = starts[ok], ends[ok]
    ends = np.where(np.isfinite(ends), ends, np.inf)
    ts = np.concatenate([starts, ends])
    deltas = np.concatenate([np.ones_like(starts), -np.ones_like(ends)])
    # departures (-1) before arrivals (+1) at identical times: intervals
    # are half-open, and a retired slot is reusable in the same tick
    order = np.lexsort((deltas, ts))
    return int(np.cumsum(deltas[order]).max()) if len(ts) else 0


def suggest_slots(sched: FlowSchedule, sim_dt: float,
                  rate_fraction: float = 0.1, rtt_slack: float = 16.0,
                  round_to: int = 64) -> int:
    """A-priori slot-pool size for a schedule: each flow's residency is
    bounded by its transfer time at ``rate_fraction`` of its NIC rate plus
    ``rtt_slack`` RTTs and the drain hold; the peak overlap of those
    intervals, rounded up to ``round_to`` and clamped to the flow count."""
    n = int(sched.start.shape[0])

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    starts, sizes = host(sched.start), host(sched.size)
    nic, tau = host(sched.nic_rate), host(sched.tau)
    hold = int(sched.tf_steps.max()) * sim_dt if n else 0.0
    dur = sizes / np.maximum(rate_fraction * nic, 1.0) + rtt_slack * tau
    peak = max(peak_concurrency(starts, starts + dur + hold), 1)
    rounded = ((peak + round_to - 1) // round_to) * round_to
    return max(min(rounded, n), 1)
