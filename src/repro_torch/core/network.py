"""Topology and scenario builders (twin of ``repro.core.network``).

``single_bottleneck`` (the paper's analytical model, one shared queue)
and ``LeafSpine`` (the oversubscribed datacenter fabric of the FCT
experiments) are both instances of the fabric graph in ``core/fabric.py``.
Path compilation is host numpy; the emitted tensors land on the device
asked for (``"cuda"`` unless the caller says otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .fabric import (FabricRoutes, compile_routes, leaf_spine_fabric,
                     single_bottleneck_fabric)
from .types import Flows, FlowSchedule, Topology, GBPS, US, resolve_device


def make_schedule(flows: Flows) -> FlowSchedule:
    """Sort a ``Flows`` batch by arrival time into a ``FlowSchedule``.

    The sort is stable (host numpy, as in ``repro``), so flows sharing a
    start time keep their relative order — with the slot engine's
    fresh-first slot assignment this is what makes slot == padded exact
    when S >= N. ``order`` records each entry's original index.
    """
    start = flows.start.cpu().numpy()
    perm = np.argsort(start, kind="stable")
    idx = torch.as_tensor(perm.astype(np.int32), device=flows.start.device)
    return FlowSchedule(
        path=flows.path[idx], tf_steps=flows.tf_steps[idx],
        rtt_steps=flows.rtt_steps[idx], tau=flows.tau[idx],
        nic_rate=flows.nic_rate[idx], size=flows.size[idx],
        start=flows.start[idx], stop=flows.stop[idx],
        weight=flows.weight[idx], order=idx)


def schedule_as_flows(sched: FlowSchedule) -> Flows:
    """View a schedule as a plain ``Flows`` batch (schedule order kept):
    the padded-engine twin the slot engine is held against."""
    return Flows(path=sched.path, tf_steps=sched.tf_steps,
                 rtt_steps=sched.rtt_steps, tau=sched.tau,
                 nic_rate=sched.nic_rate, size=sched.size,
                 start=sched.start, stop=sched.stop, weight=sched.weight)


def single_bottleneck(bandwidth: float = 25 * GBPS,
                      buffer: float = 6e6,
                      dt_alpha: float = 0.0, device="cuda") -> Topology:
    """One shared queue, emitted by the fabric compiler."""
    return single_bottleneck_fabric(bandwidth=bandwidth, buffer=buffer,
                                    dt_alpha=dt_alpha).topology(device)


def make_flows_single(n: int, tau: float, nic: float,
                      sizes=None, starts=None, stops=None,
                      weights=None, sim_dt: float = 1e-6,
                      hops_fwd_delay: float = 0.5, device="cuda") -> Flows:
    """All n flows traverse the single queue 0."""
    dev = resolve_device(device)

    def vec(x, fill):
        a = np.full((n,), fill) if x is None else np.asarray(x)
        return torch.as_tensor(a.astype(np.float32), device=dev)

    def full(v, dtype):
        return torch.as_tensor(np.full((n,), v).astype(dtype), device=dev)

    tf = int(round(hops_fwd_delay * tau / sim_dt))
    return Flows(
        path=torch.zeros((n, 1), dtype=torch.int32, device=dev),
        tf_steps=torch.full((n, 1), tf, dtype=torch.int32, device=dev),
        rtt_steps=full(max(int(round(tau / sim_dt)), 1), np.int32),
        tau=full(tau, np.float32),
        nic_rate=full(nic, np.float32),
        size=vec(sizes, np.inf), start=vec(starts, 0.0),
        stop=vec(stops, np.inf), weight=vec(weights, 1.0),
    )


@dataclasses.dataclass
class LeafSpine:
    """Thin facade over ``fabric.leaf_spine_fabric`` (queue layout:
      up[r, s]      ToR r -> spine s uplink          idx = r*S + s
      down[s, r]    spine s -> ToR r downlink        idx = R*S + s*R + r
      host[r, h]    ToR r -> host (r,h) downlink     idx = 2*R*S + r*H + h).
    Carries the parameterization and the workload-facing protocol
    (``n_hosts`` / ``host_group`` / ``load_capacity`` / ``make_flows``)."""
    racks: int = 4
    hosts_per_rack: int = 16
    spines: int = 1
    host_bw: float = 25 * GBPS                   # 25 Gbps server links
    fabric_bw: float = 100 * GBPS                # 100 Gbps fabric links
    d_host: float = 1 * US                       # host<->ToR propagation
    d_fabric: float = 5 * US                     # ToR<->spine propagation
    buffer_per_port: float = 6e6
    switch_buffer: float = 24e6                  # Tofino-like shallow shared
    dt_alpha: float = 1.0
    ecmp_seed: int = 0

    def __post_init__(self):
        R, S, H = self.racks, self.spines, self.hosts_per_rack
        self.n_hosts = R * H
        self.num_queues = 2 * R * S + R * H
        self._routes: Optional[FabricRoutes] = None

    def routes(self) -> FabricRoutes:
        """The compiled fabric (built lazily, cached)."""
        if self._routes is None:
            self._routes = compile_routes(leaf_spine_fabric(
                racks=self.racks, hosts_per_rack=self.hosts_per_rack,
                spines=self.spines, host_bw=self.host_bw,
                fabric_bw=self.fabric_bw, d_host=self.d_host,
                d_fabric=self.d_fabric,
                buffer_per_port=self.buffer_per_port,
                switch_buffer=self.switch_buffer,
                dt_alpha=self.dt_alpha), seed=self.ecmp_seed)
        return self._routes

    def oversubscription(self) -> float:
        return (self.hosts_per_rack * self.host_bw) / (self.spines * self.fabric_bw)

    def topology(self, device="cuda") -> Topology:
        return self.routes().topology(device)

    def host_down_queue(self, r, h):
        R, S, H = self.racks, self.spines, self.hosts_per_rack
        return 2 * R * S + r * H + h

    def host_group(self) -> np.ndarray:
        """[n_hosts] rack id per host (the workload cross-group key)."""
        return np.arange(self.n_hosts) // self.hosts_per_rack

    def host_ingress_queue(self, host: int) -> int:
        H = self.hosts_per_rack
        return self.host_down_queue(host // H, host % H)

    def load_capacity(self) -> float:
        """Offered-load base: aggregate ToR uplink bandwidth (the paper's
        load definition on this oversubscribed fabric)."""
        return self.racks * self.spines * self.fabric_bw

    def make_flows(self, src: np.ndarray, dst: np.ndarray, sizes: np.ndarray,
                   starts: np.ndarray, sim_dt: float,
                   weights: Optional[np.ndarray] = None,
                   rng: Optional[np.random.Generator] = None,
                   seed: Optional[int] = None, device="cuda") -> Flows:
        """src/dst are host ids in [0, racks*hosts_per_rack); paths come
        from deterministic per-flow ECMP hashing (``fabric.ecmp_hash``).
        ``rng`` is accepted for compatibility and not consulted."""
        del rng
        return self.routes().make_flows(src, dst, sizes, starts, sim_dt,
                                        weights=weights, seed=seed,
                                        device=device)
