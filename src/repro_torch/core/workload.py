"""Traffic generation (twin of ``repro.core.workload``): web-search flow
sizes and Poisson arrivals, incast (single-shot and repeated bursts),
permutation and all-to-all matrices, the distributed-file-system incast,
the slot-pool sizing helpers of the flow-slot engine, and a
receiver-driven (HOMA-like) grant allocator for the padded engine.

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

from typing import Callable, List, Tuple

import numpy as np
import torch

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


def permutation_traffic(fabric, load: float, duration: float,
                        sim_dt: float, seed: int = 0,
                        cross_rack_only: bool = True,
                        device="cuda") -> Flows:
    """Poisson web-search arrivals over a fixed random permutation matrix:
    one derangement ``perm`` per seed (re-drawn, best effort, until no
    host maps inside its own group with ``cross_rack_only``), senders
    arriving Poisson at ``load * load_capacity()`` total byte-rate, every
    flow from host ``s`` going to ``perm[s]``."""
    rng = np.random.default_rng(seed)
    nh = fabric.n_hosts
    grp = _groups(fabric)
    perm = rng.permutation(nh)
    for _ in range(64):
        bad = perm == np.arange(nh)
        if cross_rack_only:
            bad |= grp[perm] == grp
        if not bad.any():
            break
        if bad.sum() == 1:
            # a lone offender swaps with any other host
            i = int(bad.nonzero()[0][0])
            j = int(rng.integers(0, nh))
            perm[[i, j]] = perm[[j, i]]
        else:
            # a cyclic shift among the offenders fixes most at once
            idx = bad.nonzero()[0]
            perm[idx] = perm[np.roll(idx, 1)]
    cap = fabric.load_capacity()
    lam = load * cap / websearch_mean()
    n = max(int(lam * duration * 1.2) + 16, 16)
    starts = np.cumsum(rng.exponential(1.0 / lam, size=n))
    starts = starts[starts < duration]
    n = len(starts)
    sizes = websearch_sample(rng, n)
    src = rng.integers(0, nh, size=n)
    dst = perm[src]
    return fabric.make_flows(src, dst, sizes, starts, sim_dt, seed=seed,
                             device=device)


def incast_flows(fabric, fan_in: int, req_bytes: float,
                 sim_dt: float, victim: int = 0, start: float = 0.0,
                 long_flow: bool = True, seed: int = 0,
                 device="cuda") -> Tuple[Flows, int]:
    """``fan_in`` senders in other groups (distinct hosts, drawn with
    replacement only when there are fewer such hosts) respond at once to
    ``victim``; with ``long_flow`` a long-lived flow to the same victim,
    from the first host of the other groups that is not a sender, runs
    from before the incast (``start = -1``, ``size = inf``: paper Fig. 4's
    setup). Returns (flows on ``device``, the victim's ingress queue)."""
    rng = np.random.default_rng(seed)
    grp = _groups(fabric)
    others = np.nonzero(grp != grp[victim])[0]
    senders = rng.choice(others, size=fan_in, replace=fan_in > len(others))
    src = senders
    dst = np.full(fan_in, victim)
    sizes = np.full(fan_in, req_bytes)
    starts = np.full(fan_in, start)
    if long_flow:
        free = ~np.isin(others, senders)
        lf_src = others[free][0] if free.any() else others[0]
        src = np.concatenate([[lf_src], src])
        dst = np.concatenate([[victim], dst])
        sizes = np.concatenate([[np.inf], sizes])
        starts = np.concatenate([[-1.0], starts])   # running before incast
    flows = fabric.make_flows(src.astype(np.int64), dst.astype(np.int64),
                              sizes, starts, sim_dt, seed=seed,
                              device=device)
    return flows, fabric.host_ingress_queue(victim)


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


def all_to_all_flows(fabric, bytes_per_pair: float, sim_dt: float,
                     start: float = 0.0, stagger: float = 0.0,
                     seed: int = 0, device="cuda") -> Flows:
    """Every ordered host pair exchanges ``bytes_per_pair`` (a shuffle or
    collective matrix); ``stagger`` > 0 jitters the starts uniformly in
    [0, stagger). Quadratic in ``n_hosts``: for small fabrics (the k = 4
    fat tree: 240 pairs)."""
    rng = np.random.default_rng(seed)
    nh = fabric.n_hosts
    src, dst = np.nonzero(~np.eye(nh, dtype=bool))
    n = len(src)
    starts = np.full(n, start)
    if stagger > 0:
        starts = starts + rng.uniform(0.0, stagger, size=n)
    return fabric.make_flows(src, dst, np.full(n, bytes_per_pair), starts,
                             sim_dt, seed=seed, device=device)


def synthetic_incast_workload(fabric, request_rate: float,
                              req_bytes: float, duration: float,
                              sim_dt: float, seed: int = 0,
                              device="cuda") -> Flows:
    """Distributed-file-system workload (paper section 4.1): each request
    picks a victim and 16 servers in other groups, which respond at once
    with ``req_bytes / 16`` each."""
    rng = np.random.default_rng(seed)
    fan_in = 16
    n_req = max(int(request_rate * duration), 1)
    req_t = np.sort(rng.uniform(0, duration, size=n_req))
    src_l, dst_l, sz_l, st_l = [], [], [], []
    grp = _groups(fabric)
    nh = fabric.n_hosts
    for t in req_t:
        victim = rng.integers(0, nh)
        others = np.nonzero(grp != grp[victim])[0]
        senders = rng.choice(others, size=fan_in, replace=False)
        src_l.append(senders)
        dst_l.append(np.full(fan_in, victim))
        sz_l.append(np.full(fan_in, req_bytes / fan_in))
        st_l.append(np.full(fan_in, t))
    return fabric.make_flows(np.concatenate(src_l), np.concatenate(dst_l),
                             np.concatenate(sz_l), np.concatenate(st_l),
                             sim_dt, seed=seed, device=device)


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


# --------------------------------------------------------------------------
# HOMA-like receiver-driven allocation (simplified)
# --------------------------------------------------------------------------

def homa_alloc_fn(receiver, downlink_bw: float, overcommit: int,
                  tau: torch.Tensor, start: torch.Tensor) -> Callable:
    """Returns ``alloc(remaining, active, t_sec, flows, rate_cap)``, the
    padded engine's allocator (``simulate(..., alloc_fn=)``) over its
    batched layout ([B, F] leaves; one scenario is a batch of one).

    Scheduled: each receiver grants its downlink to its ``overcommit``
    shortest-remaining active flows (ties to the lower flow index).
    Unscheduled: a flow younger than one base RTT (``t_sec - start <
    tau``, in float32) sends at its line rate. ``receiver`` is [F]
    (shared by the batch) or [B, F]; ``tau`` and ``start`` are float32
    tensors on the engine's device, [F] or [B, F]. The grants are
    recomputed every tick the allocator is called."""
    recv_host = np.asarray(receiver.cpu() if isinstance(receiver,
                                                        torch.Tensor)
                           else receiver).astype(np.int64)
    nrecv = int(recv_host.max()) + 1 if recv_host.size else 1
    on = {}

    def alloc(remaining, active, t_sec, flows, rate_cap):
        dev = remaining.device
        if dev not in on:
            on[dev] = torch.as_tensor(recv_host, device=dev)
        key = torch.where(active, remaining, float("inf"))
        # +0.0 and -0.0 tie, as in jax's sort comparator
        key = torch.where(key == 0.0, 0.0, key)
        recv = on[dev].expand(key.shape)
        F = int(key.shape[-1])
        # jnp.lexsort((key, recv)): by receiver, ties by key, then by
        # index; two stable sorts, the secondary key first
        by_key = torch.sort(key, dim=-1, stable=True).indices
        recv_k = torch.gather(recv, -1, by_key)
        by_recv = torch.sort(recv_k, dim=-1, stable=True).indices
        order = torch.gather(by_key, -1, by_recv)
        recv_sorted = torch.gather(recv_k, -1, by_recv)
        pos = torch.arange(F, device=dev).expand(key.shape)
        group_start = torch.full(tuple(key.shape[:-1]) + (nrecv,), F,
                                 dtype=torch.int64, device=dev)
        group_start = group_start.scatter_reduce(-1, recv_sorted, pos,
                                                 "amin")
        rank_sorted = pos - torch.gather(group_start, -1, recv_sorted)
        rank = torch.zeros_like(rank_sorted).scatter(-1, order, rank_sorted)
        granted = active & (rank < overcommit) & torch.isfinite(key)
        unscheduled = active & ((t_sec - start) < tau)
        cap = torch.where(granted, downlink_bw, 0.0)
        cap = torch.where(unscheduled, flows.nic_rate, cap)
        return cap.to(torch.float32)

    return alloc
