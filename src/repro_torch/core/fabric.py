"""Declarative fabric graph + routing compiler (twin of ``repro.core.fabric``).

The single-bottleneck, leaf-spine and fat-tree builders, and the
reverse paths of hop-by-hop feedback (``Fabric.reverse_links``,
``FabricRoutes.reverse_path`` / ``notify_delays``), and the per-link
impairment classes a builder declares (``FabricBuilder.impair_class``,
compiled by ``core.impair.fabric_impairments``).
All path compilation is host numpy, bit-identical to ``repro``; only the
emitted ``Topology``/``Flows`` are tensors, on the device asked for.

  * ``Fabric`` — a directed graph of tiered nodes (hosts are nodes
    ``[0, n_hosts)``; everything else is a switch) and capacitated links
    with propagation delays. Links marked ``queued`` each own one
    fluid-model queue, numbered in link-declaration order.
  * a routing compiler (``compile_routes`` / ``FabricRoutes``): BFS per
    destination builds the shortest-path DAG; equal-cost paths are
    ordered lexicographically by link id and emitted as padded per-hop
    queue indices, forward-delay steps and an RTT.
  * deterministic ECMP: each flow picks among its pair's paths by a
    seedable splitmix64-style hash of (src, dst, flow id, seed).

Per-hop semantics (as in ``repro``):

  * forward delay to hop h's queue = sum of the propagation delays of
    every link *before* h on the path (a packet crosses a link after
    being serviced by the link's queue);
  * base RTT = 2 x the sum of ALL link delays on the path (symmetric
    reverse path, no reverse queueing — DESIGN.md section 9);
  * paths pad with queue id ``num_queues`` (the simulator's sentinel)
    strictly after the final real hop, and padded hops carry forward
    delay 0 (the old same-rack builder's convention, which
    ``workload.suggest_slots`` relies on for its drain hold).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .types import Flows, Topology, GBPS, US, resolve_device

HOST, TOR, AGG, CORE = 0, 1, 2, 3      # conventional tier labels


# --------------------------------------------------------------------------
# fabric graph
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fabric:
    """Declarative fabric: tiered nodes + directed capacitated links.

    Nodes ``[0, n_hosts)`` are hosts; the rest are switches, and switch
    ``i`` of the simulator (Dynamic-Thresholds buffer sharing) is node
    ``n_hosts + i``. Queue ``q`` is the q-th link with ``link_queued``
    set, in declaration order — builders therefore control the queue
    layout exactly (the compiled leaf-spine keeps the historical
    up/down/host-down index blocks).
    """
    name: str
    n_hosts: int
    tier: np.ndarray                    # [n_nodes] int8
    link_src: np.ndarray                # [L] int32
    link_dst: np.ndarray                # [L] int32
    link_bw: np.ndarray                 # [L] float64 bytes/s
    link_delay: np.ndarray              # [L] float64 seconds
    link_buffer: np.ndarray             # [L] float64 bytes (queued links)
    link_queued: np.ndarray             # [L] bool
    switch_buffer: np.ndarray           # [n_switches] float64 bytes
    dt_alpha: float = 1.0
    # per-link-class impairment processes: ((src_tier, dst_tier),
    # ``core.impair.LinkProcess``) pairs declared with
    # ``FabricBuilder.impair_class``, compiled by
    # ``core.impair.fabric_impairments``
    impair_rules: tuple = ()

    @property
    def n_nodes(self) -> int:
        return int(self.tier.shape[0])

    @property
    def n_switches(self) -> int:
        return self.n_nodes - self.n_hosts

    @property
    def num_queues(self) -> int:
        return int(self.link_queued.sum())

    def queue_of_link(self) -> np.ndarray:
        """[L] queue id per link (-1 for unqueued links)."""
        q = np.cumsum(self.link_queued.astype(np.int64)) - 1
        return np.where(self.link_queued, q, -1).astype(np.int32)

    def queued_links(self) -> np.ndarray:
        """[Q] link id of each queue, in queue order."""
        return np.nonzero(self.link_queued)[0].astype(np.int32)

    def topology(self, device="cuda") -> Topology:
        """Emit the simulator's static ``Topology`` on ``device`` (queue
        order = queued link declaration order; switch of a queue = the
        queued link's source switch)."""
        dev = resolve_device(device)
        ql = self.queued_links()
        src = self.link_src[ql]
        if (src < self.n_hosts).any():
            raise ValueError("queued links must originate at switches "
                             "(host egress is modelled by the NIC cap)")

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return Topology(
            num_queues=int(ql.shape[0]),
            bandwidth=f32(self.link_bw[ql]),
            buffer=f32(self.link_buffer[ql]),
            switch_of_queue=torch.as_tensor(
                (src - self.n_hosts).astype(np.int32), device=dev),
            num_switches=self.n_switches,
            switch_buffer=f32(self.switch_buffer),
            dt_alpha=self.dt_alpha,
        )

    def host_nic_rate(self) -> np.ndarray:
        """[n_hosts] egress line rate = bandwidth of each host's uplink
        (0 for pure-receiver hosts with no egress link — ``make_flows``
        rejects sourcing a flow there)."""
        nic = np.zeros(self.n_hosts, np.float64)
        for l in range(len(self.link_src)):
            u = int(self.link_src[l])
            if u < self.n_hosts:
                nic[u] = self.link_bw[l]
        return nic

    def host_group(self) -> np.ndarray:
        """[n_hosts] attachment-switch node id (the 'rack' of each host —
        workloads use it for cross-group constraints)."""
        grp = np.full(self.n_hosts, -1, np.int64)
        for l in range(len(self.link_src)):
            u = int(self.link_src[l])
            if u < self.n_hosts:
                grp[u] = int(self.link_dst[l])
        return grp

    def host_ingress_queue(self, host: int) -> int:
        """Queue id of the (unique) queued link delivering to ``host``."""
        qid = self.queue_of_link()
        hits = [int(qid[l]) for l in range(len(self.link_dst))
                if int(self.link_dst[l]) == host and qid[l] >= 0]
        if len(hits) != 1:
            raise ValueError(f"host {host} has {len(hits)} ingress queues")
        return hits[0]

    def uplink_capacity(self) -> float:
        """Aggregate ToR/edge-to-upper-tier bandwidth (the paper's load
        base on oversubscribed fabrics); falls back to the total queued
        bandwidth when the fabric has no upper tier."""
        up = (self.link_queued
              & (self.tier[self.link_src] == TOR)
              & (self.tier[self.link_dst] >= AGG))
        sel = up if up.any() else self.link_queued
        return float(self.link_bw[sel].sum())

    def load_capacity(self) -> float:
        """Byte-rate base for offered-load workloads: the tighter of the
        fabric's uplink capacity and the hosts' aggregate injection rate
        (a non-blocking fat-tree is injection-limited; an oversubscribed
        leaf-spine is uplink-limited)."""
        return min(self.uplink_capacity(), float(self.host_nic_rate().sum()))

    def reverse_links(self) -> np.ndarray:
        """[L] int32 id of each link's reverse link (the link declared
        between the same node pair in the opposite direction), or -1 where
        the fabric has none. Every builder here declares links in
        symmetric pairs except ``single_bottleneck_fabric`` (a one-way
        spine), where the hop-feedback derivations
        (``FabricRoutes.reverse_path`` / ``notify_delays``) raise."""
        idx = {(int(s), int(d)): l for l, (s, d)
               in enumerate(zip(self.link_src, self.link_dst))}
        out = np.full(len(self.link_src), -1, np.int32)
        for l, (s, d) in enumerate(zip(self.link_src, self.link_dst)):
            out[l] = idx.get((int(d), int(s)), -1)
        return out


class FabricBuilder:
    """Imperative construction helper. Add ALL hosts before any switch
    (queue/switch index math assumes hosts occupy node ids [0, n_hosts));
    add queued links in the order you want queues numbered."""

    def __init__(self, name: str, dt_alpha: float = 1.0):
        self.name = name
        self.dt_alpha = dt_alpha
        self.tier: List[int] = []
        self.sw_buffer: List[float] = []
        self.links: List[Tuple[int, int, float, float, bool, float]] = []
        self.impair_rules: List[Tuple[Tuple[int, int], object]] = []

    def add_host(self) -> int:
        if any(t != HOST for t in self.tier):
            raise ValueError("add all hosts before the first switch")
        self.tier.append(HOST)
        return len(self.tier) - 1

    def add_switch(self, tier: int, shared_buffer: float) -> int:
        self.tier.append(tier)
        self.sw_buffer.append(float(shared_buffer))
        return len(self.tier) - 1

    def add_link(self, src: int, dst: int, bw: float, delay: float,
                 queued: Optional[bool] = None, buffer: float = 0.0):
        if queued is None:
            queued = self.tier[src] != HOST
        self.links.append((src, dst, float(bw), float(delay), bool(queued),
                           float(buffer)))

    def impair_class(self, src_tier: int, dst_tier: int, proc):
        """Attach an impairment process (``core.impair.LinkProcess``, e.g.
        an ``impair.netem`` preset) to every queued link of one
        (src_tier, dst_tier) class; ``core.impair.fabric_impairments``
        compiles the built fabric's regime. The last declaration per class
        wins."""
        self.impair_rules = [r for r in self.impair_rules
                             if r[0] != (src_tier, dst_tier)]
        self.impair_rules.append(((src_tier, dst_tier), proc))

    def build(self) -> Fabric:
        n_hosts = sum(1 for t in self.tier if t == HOST)
        ls = self.links
        return Fabric(
            name=self.name, n_hosts=n_hosts,
            tier=np.asarray(self.tier, np.int8),
            link_src=np.asarray([l[0] for l in ls], np.int32),
            link_dst=np.asarray([l[1] for l in ls], np.int32),
            link_bw=np.asarray([l[2] for l in ls], np.float64),
            link_delay=np.asarray([l[3] for l in ls], np.float64),
            link_buffer=np.asarray([l[5] for l in ls], np.float64),
            link_queued=np.asarray([l[4] for l in ls], bool),
            switch_buffer=np.asarray(self.sw_buffer, np.float64),
            dt_alpha=self.dt_alpha,
            impair_rules=tuple(self.impair_rules),
        )


# --------------------------------------------------------------------------
# deterministic ECMP hash
# --------------------------------------------------------------------------

def ecmp_hash(src, dst, flow_id, seed: int = 0) -> np.ndarray:
    """Seedable per-flow path selector: a splitmix64-style finalizer over
    (src, dst, flow id, seed). Pure integer arithmetic — the same inputs
    hash identically in every process and on every platform (the
    regression tests/test_fabric.py asserts this across interpreters),
    unlike the global-RNG spine pick it replaces. ``flow_id`` plays the
    role of the transport 5-tuple's port entropy: consecutive flows of
    one pair spread across the pair's ECMP paths.
    """
    def mix(x):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xbf58476d1ce4e5b9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94d049bb133111eb)
        return x ^ (x >> np.uint64(31))

    with np.errstate(over="ignore"):
        h = mix(np.asarray(seed, np.uint64) ^ np.uint64(0x9e3779b97f4a7c15))
        h = mix(h ^ np.asarray(src, np.uint64))
        h = mix(h ^ np.asarray(dst, np.uint64))
        h = mix(h ^ np.asarray(flow_id, np.uint64))
    return h


# --------------------------------------------------------------------------
# routing compiler
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompiledPaths:
    """All ECMP paths of one (src, dst) host pair.

    ``queues``/``tf`` are hop-padded to the FABRIC-wide max hop count H
    (pad queue id = num_queues, pad delay = 0.0, strictly after the
    final real hop); ``links`` keeps the raw link-id tuples for
    delay/property audits. Path order is deterministic: lexicographic
    by link ids (adjacency sorted ascending), so path index p is stable
    across processes — the ECMP hash indexes into this order.
    """
    links: Tuple[Tuple[int, ...], ...]
    queues: np.ndarray                  # [P, H] int32
    tf: np.ndarray                      # [P, H] float64 seconds
    rtt: np.ndarray                     # [P] float64 seconds
    n_hops: np.ndarray                  # [P] int32


class FabricRoutes:
    """The routing compiler bound to one fabric.

    Shortest paths are computed per destination (BFS on the reversed
    link graph), all equal-cost paths are enumerated through the
    shortest-path DAG, and per-pair results are memoized. ``H`` is the
    fabric-wide maximum queued-hop count, so every compiled ``Flows``
    batch of one fabric shares its hop axis.
    """

    def __init__(self, fabric: Fabric, seed: int = 0):
        self.fabric = fabric
        self.seed = int(seed)
        self._qid = fabric.queue_of_link()
        # adjacency sorted by link id => deterministic path enumeration
        self._adj: List[List[int]] = [[] for _ in range(fabric.n_nodes)]
        for l in range(len(fabric.link_src)):
            self._adj[int(fabric.link_src[l])].append(l)
        self._dist: Dict[int, np.ndarray] = {}
        self._pairs: Dict[Tuple[int, int], CompiledPaths] = {}
        self._nic = fabric.host_nic_rate()
        self.H = self._max_hops()

    # -- graph machinery ---------------------------------------------------

    def _dist_to(self, dst: int) -> np.ndarray:
        """[n_nodes] BFS link-hop distance to ``dst`` (INT32_MAX = cut).

        Level-synchronous over the whole link array — one numpy pass per
        BFS level instead of a Python loop per link, which is what makes
        per-destination compilation viable on 1024-host fabrics.
        """
        if dst in self._dist:
            return self._dist[dst]
        f = self.fabric
        INF = np.iinfo(np.int32).max
        ls = np.asarray(f.link_src, np.int64)
        ld = np.asarray(f.link_dst, np.int64)
        dist = np.full(f.n_nodes, INF, np.int64)
        dist[dst] = 0
        d = 0
        while True:
            hit = ls[(dist[ld] == d) & (dist[ls] == INF)]
            if not len(hit):
                break
            d += 1
            dist[hit] = d
        self._dist[dst] = dist
        return dist

    def _padded_adj(self) -> np.ndarray:
        """[n_nodes, D] outgoing link ids, ascending, -1 padded (cached)."""
        if not hasattr(self, "_padj"):
            deg = max((len(a) for a in self._adj), default=1)
            padj = np.full((self.fabric.n_nodes, max(deg, 1)), -1, np.int64)
            for u, ls in enumerate(self._adj):
                padj[u, :len(ls)] = ls
            self._padj = padj
        return self._padj

    def _unrank_tables(self, dst: int):
        """Shortest-path-DAG counting tables for one destination.

        Returns ``(dist [n_nodes], counts [n_nodes], counts_cum
        [n_nodes, D])`` where ``counts[u]`` is the number of shortest
        u->dst paths and ``counts_cum[u, j]`` the cumulative path count
        over ``u``'s first ``j+1`` outgoing links (invalid / non-DAG
        links count 0). Because adjacency is sorted by link id, the
        lexicographic rank of a path decomposes along these cumsums —
        ``select`` unranks a flow's ECMP index hop by hop without ever
        materializing the pair's full path set.
        """
        f = self.fabric
        adj = self._padded_adj()
        dist = self._dist_to(dst)
        INF = np.iinfo(np.int32).max
        vdst = np.asarray(f.link_dst, np.int64)[np.maximum(adj, 0)]
        valid = (adj >= 0) & (dist[vdst] == dist[:, None] - 1)
        counts = np.zeros(f.n_nodes, np.int64)
        counts[dst] = 1
        finite = dist < INF
        if finite.any():
            for lev in range(1, int(dist[finite].max()) + 1):
                nodes = np.nonzero(finite & (dist == lev))[0]
                if len(nodes):
                    counts[nodes] = np.where(valid[nodes],
                                             counts[vdst[nodes]], 0).sum(1)
        return dist, counts, np.cumsum(np.where(valid, counts[vdst], 0),
                                       axis=1)

    def _enumerate(self, u: int, dst: int,
                   dist: np.ndarray) -> List[Tuple[int, ...]]:
        """All shortest u->dst paths as link-id tuples (lexicographic)."""
        if u == dst:
            return [()]
        f = self.fabric
        out: List[Tuple[int, ...]] = []
        for l in self._adj[u]:
            v = int(f.link_dst[l])
            if dist[v] == dist[u] - 1:
                out += [(l,) + rest for rest in
                        self._enumerate(v, dst, dist)]
        return out

    def _max_hops(self) -> int:
        """Fabric-wide max queued-hop count over all host pairs: DP over
        each destination's shortest-path DAG (max queued links on any
        shortest path from any host), level-vectorized per destination."""
        f = self.fabric
        INF = np.iinfo(np.int32).max
        adj = self._padded_adj()
        vdst = np.asarray(f.link_dst, np.int64)[np.maximum(adj, 0)]
        qhop = (self._qid[np.maximum(adj, 0)] >= 0).astype(np.int64)
        best = 1
        for d in range(f.n_hosts):
            dist = self._dist_to(d)
            valid = (adj >= 0) & (dist[vdst] == dist[:, None] - 1)
            maxq = np.full(f.n_nodes, -1, np.int64)
            maxq[d] = 0
            finite = dist < INF
            for lev in range(1, int(dist[finite].max()) + 1):
                nodes = np.nonzero(finite & (dist == lev))[0]
                if not len(nodes):
                    continue
                up = maxq[vdst[nodes]]
                cand = np.where(valid[nodes] & (up >= 0),
                                up + qhop[nodes], -1)
                maxq[nodes] = cand.max(1)
            reach = maxq[:f.n_hosts]
            if (reach >= 0).any():
                best = max(best, int(reach[reach >= 0].max()))
        return best

    # -- public compiler surface ------------------------------------------

    def paths(self, src: int, dst: int) -> CompiledPaths:
        """The memoized ECMP path set of one host pair."""
        key = (int(src), int(dst))
        if key in self._pairs:
            return self._pairs[key]
        f = self.fabric
        if not (0 <= key[0] < f.n_hosts and 0 <= key[1] < f.n_hosts):
            raise ValueError(f"hosts must be in [0, {f.n_hosts}); got {key}")
        if key[0] == key[1]:
            raise ValueError("src == dst has no network path")
        dist = self._dist_to(key[1])
        if dist[key[0]] >= np.iinfo(np.int32).max:
            raise ValueError(f"no path {key[0]} -> {key[1]}")
        link_paths = self._enumerate(key[0], key[1], dist)
        P, H = len(link_paths), self.H
        queues = np.full((P, H), f.num_queues, np.int32)
        tf = np.zeros((P, H), np.float64)
        rtt = np.zeros(P, np.float64)
        n_hops = np.zeros(P, np.int32)
        for p, lp in enumerate(link_paths):
            cum = 0.0
            h = 0
            for l in lp:
                if self._qid[l] >= 0:
                    queues[p, h] = self._qid[l]
                    tf[p, h] = cum
                    h += 1
                cum = cum + float(f.link_delay[l])
            rtt[p] = 2.0 * cum
            n_hops[p] = h
        cp = CompiledPaths(links=tuple(link_paths), queues=queues, tf=tf,
                           rtt=rtt, n_hops=n_hops)
        self._pairs[key] = cp
        return cp

    def reverse_path(self, links) -> Tuple[int, ...]:
        """The reverse-path walk of a forward link path: the reverse link
        of each forward link, destination first (the order a
        congestion-point notification travels). Raises ``ValueError`` if
        a hop has no reverse link (a one-way fabric carries no hop
        feedback)."""
        rev = self.fabric.reverse_links()
        out = []
        for l in reversed(tuple(links)):
            r = int(rev[int(l)])
            if r < 0:
                raise ValueError(
                    f"link {int(l)} has no reverse link; fabric "
                    f"'{self.fabric.name}' cannot route hop-by-hop "
                    f"feedback")
            out.append(r)
        return tuple(out)

    def notify_delays(self, src: int, dst: int) -> np.ndarray:
        """[P, H] congestion-point notification delay of each hop of each
        ECMP path of one pair: the reverse-path latency from hop h's
        queue back to the sender (``Law.feedback == "hop"``). Accumulated
        in forward hop order, in float64, as ``paths()`` accumulates
        ``tf``, so on a symmetric fabric it equals the forward delay bit
        for bit (the identity the engines' ``tf_steps`` hop clock rests
        on). Padded hops keep 0. Raises on a fabric without reverse
        links."""
        f = self.fabric
        rev = f.reverse_links()
        cp = self.paths(src, dst)
        nd = np.zeros((len(cp.links), self.H), np.float64)
        for p, lp in enumerate(cp.links):
            cum = 0.0
            h = 0
            for l in lp:
                r = int(rev[l])
                if r < 0:
                    raise ValueError(
                        f"link {l} has no reverse link; fabric "
                        f"'{f.name}' cannot route hop-by-hop feedback")
                if self._qid[l] >= 0:
                    nd[p, h] = cum
                    h += 1
                cum = cum + float(f.link_delay[r])
        return nd

    def select(self, src: np.ndarray, dst: np.ndarray,
               flow_ids: Optional[np.ndarray] = None,
               seed: Optional[int] = None):
        """Vectorized per-flow path selection: (queues [n,H] int32,
        tf [n,H] float64 s, rtt [n] float64 s, choice [n] int32).

        Flows are grouped by destination and walk the shortest-path DAG
        hop by hop, unranking their hashed lexicographic path index
        against ``_unrank_tables`` cumsums. This visits O(hops) links
        per flow instead of enumerating every ECMP path of every pair
        (64 paths/pair on a k=16 fat-tree), and reproduces the exact
        path the enumerating compiler would have picked: same
        lexicographic order, same hash, same float64 delay accumulation
        order (tests/test_fabric.py pins the equivalence against
        ``paths()``).
        """
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        n = len(src)
        fid = (np.arange(n, dtype=np.int64) if flow_ids is None
               else np.asarray(flow_ids, np.int64))
        seed = self.seed if seed is None else int(seed)
        f = self.fabric
        if ((src < 0) | (src >= f.n_hosts)
                | (dst < 0) | (dst >= f.n_hosts)).any():
            raise ValueError(f"hosts must be in [0, {f.n_hosts})")
        if (src == dst).any():
            raise ValueError("src == dst has no network path")
        H = self.H
        adj = self._padded_adj()
        ldst = np.asarray(f.link_dst, np.int64)
        ldelay = np.asarray(f.link_delay, np.float64)
        queues = np.full((n, H), f.num_queues, np.int32)
        tf = np.zeros((n, H), np.float64)
        rtt = np.zeros(n, np.float64)
        choice_out = np.zeros(n, np.int64)
        for d in np.unique(dst):
            m = np.nonzero(dst == d)[0]
            dist_t, counts, ccum = self._unrank_tables(int(d))
            total = counts[src[m]]
            if (total == 0).any():
                bad = int(src[m][total == 0][0])
                raise ValueError(f"no path {bad} -> {int(d)}")
            ch = (ecmp_hash(src[m], dst[m], fid[m], seed)
                  % total.astype(np.uint64)).astype(np.int64)
            choice_out[m] = ch
            u = src[m].copy()
            rank = ch.copy()
            h = np.zeros(len(m), np.int64)
            cum = np.zeros(len(m), np.float64)
            for _ in range(int(dist_t[src[m]].max())):
                active = u != d
                cc = ccum[u]
                b = np.minimum((cc <= rank[:, None]).sum(1),
                               adj.shape[1] - 1)
                prev = np.take_along_axis(
                    cc, np.maximum(b - 1, 0)[:, None], 1)[:, 0]
                rank = np.where(active, rank - np.where(b > 0, prev, 0),
                                rank)
                link = np.maximum(adj[u, b], 0)
                lq = np.where(active, self._qid[link], -1)
                rows = np.nonzero(active & (lq >= 0))[0]
                queues[m[rows], h[rows]] = lq[rows]
                tf[m[rows], h[rows]] = cum[rows]
                h = h + (active & (lq >= 0))
                cum = np.where(active, cum + ldelay[link], cum)
                u = np.where(active, ldst[link], u)
            rtt[m] = 2.0 * cum
        return queues, tf, rtt, choice_out.astype(np.int32)

    def make_flows(self, src: np.ndarray, dst: np.ndarray,
                   sizes: np.ndarray, starts: np.ndarray, sim_dt: float,
                   weights: Optional[np.ndarray] = None,
                   stops: Optional[np.ndarray] = None,
                   flow_ids: Optional[np.ndarray] = None,
                   seed: Optional[int] = None, device="cuda",
                   **_ignored) -> Flows:
        """Compile (src, dst, size, start) tuples into a ``Flows`` batch
        on ``device``.

        Paths come from deterministic ECMP (``select``); per-hop forward
        delays and RTTs are rounded to steps exactly as ``repro`` does.
        ``**_ignored`` swallows the legacy ``rng=`` argument.
        """
        dev = resolve_device(device)
        n = len(src)
        path, tf, rtt, _ = self.select(src, dst, flow_ids, seed)
        nic = self._nic[np.asarray(src, np.int64)]
        if (nic <= 0).any():
            raise ValueError("a flow sources at a host with no egress link")
        if weights is None:
            weights = np.ones(n)
        stops_a = (np.full((n,), np.inf, np.float32) if stops is None
                   else np.asarray(stops, np.float32))

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a).astype(dtype), device=dev)

        return Flows(
            path=t(path, np.int32),
            tf_steps=t(np.round(tf / sim_dt), np.int32),
            rtt_steps=t(np.maximum(np.round(rtt / sim_dt), 1), np.int32),
            tau=t(rtt, np.float32),
            nic_rate=t(nic, np.float32),
            size=t(sizes, np.float32),
            start=t(starts, np.float32),
            stop=t(stops_a, np.float32),
            weight=t(weights, np.float32),
        )

    # -- workload-facing conveniences (the fabric protocol shared with the
    #    LeafSpine facade; see workload.py) --------------------------------

    @property
    def n_hosts(self) -> int:
        return self.fabric.n_hosts

    @property
    def num_queues(self) -> int:
        return self.fabric.num_queues

    def topology(self, device="cuda") -> Topology:
        return self.fabric.topology(device)

    def host_group(self) -> np.ndarray:
        return self.fabric.host_group()

    def host_ingress_queue(self, host: int) -> int:
        return self.fabric.host_ingress_queue(host)

    def load_capacity(self) -> float:
        return self.fabric.load_capacity()

    @property
    def host_bw(self) -> float:
        """Uniform host NIC rate (raises if hosts differ — use
        ``fabric.host_nic_rate()`` for heterogeneous fabrics)."""
        nic = np.unique(self._nic)
        if len(nic) != 1:
            raise ValueError("fabric has heterogeneous host NICs")
        return float(nic[0])


def compile_routes(fabric: Fabric, seed: int = 0) -> FabricRoutes:
    """Compile a fabric's ECMP routing tables (memoized per host pair)."""
    return FabricRoutes(fabric, seed=seed)


# --------------------------------------------------------------------------
# builders: the single-bottleneck, leaf-spine and fat-tree fabrics
# --------------------------------------------------------------------------

def single_bottleneck_fabric(bandwidth: float = 25 * GBPS,
                             buffer: float = 6e6,
                             tau: float = 20 * US,
                             nic: Optional[float] = None,
                             hops_fwd_delay: float = 0.5,
                             dt_alpha: float = 0.0) -> Fabric:
    """The paper's analytical model as a graph: sender host -> switch ->
    receiver host. The sender's (unqueued) uplink carries
    ``hops_fwd_delay * tau`` of the propagation budget and the queued
    switch->receiver link the rest, so the compiled forward delay and
    RTT reproduce ``network.make_flows_single`` bit-for-bit (forward
    delay to the queue = hops_fwd_delay * tau, RTT = tau)."""
    b = FabricBuilder("single_bottleneck", dt_alpha=dt_alpha)
    s = b.add_host()
    d = b.add_host()
    sw = b.add_switch(TOR, shared_buffer=buffer)
    b.add_link(s, sw, nic if nic is not None else bandwidth,
               hops_fwd_delay * tau, queued=False)
    # one-way propagation totals tau/2 so the compiled RTT is exactly tau
    b.add_link(sw, d, bandwidth, tau / 2.0 - hops_fwd_delay * tau,
               queued=True, buffer=buffer)
    return b.build()


def leaf_spine_fabric(racks: int = 4, hosts_per_rack: int = 16,
                      spines: int = 1, host_bw: float = 25 * GBPS,
                      fabric_bw: float = 100 * GBPS, d_host: float = 1 * US,
                      d_fabric: float = 5 * US,
                      buffer_per_port: float = 6e6,
                      switch_buffer: float = 24e6,
                      dt_alpha: float = 1.0) -> Fabric:
    """The historical ``LeafSpine`` as a compiler instance.

    Queued-link declaration order keeps the historical queue blocks:
    up[r, s] = r*S + s, down[s, r] = R*S + s*R + r,
    host[r, h] = 2*R*S + r*H + h. Host->ToR uplinks are unqueued
    (delay-only): the first-hop propagation is ``d_host`` for same-rack
    AND cross-rack flows alike — both enter their first queue one
    host-link past the sender — which is the distinction the old
    builder's ``np.where(same_rack, d_host, d_host)`` dead branch was
    (vacuously) encoding; here it falls out of the graph."""
    R, S, H = racks, spines, hosts_per_rack
    b = FabricBuilder("leaf_spine", dt_alpha=dt_alpha)
    hosts = [[b.add_host() for _ in range(H)] for _ in range(R)]
    tors = [b.add_switch(TOR, switch_buffer) for _ in range(R)]
    sps = [b.add_switch(AGG, switch_buffer) for _ in range(S)]
    for r in range(R):                       # up[r, s] -> queues [0, R*S)
        for s in range(S):
            b.add_link(tors[r], sps[s], fabric_bw, d_fabric,
                       queued=True, buffer=buffer_per_port)
    for s in range(S):                       # down[s, r] -> [R*S, 2*R*S)
        for r in range(R):
            b.add_link(sps[s], tors[r], fabric_bw, d_fabric,
                       queued=True, buffer=buffer_per_port)
    for r in range(R):                       # host[r, h] -> [2*R*S, ...)
        for h in range(H):
            b.add_link(tors[r], hosts[r][h], host_bw, d_host,
                       queued=True, buffer=buffer_per_port)
    for r in range(R):                       # unqueued host uplinks
        for h in range(H):
            b.add_link(hosts[r][h], tors[r], host_bw, d_host, queued=False)
    return b.build()


def fat_tree(k: int = 4, host_bw: float = 25 * GBPS,
             fabric_bw: float = 100 * GBPS, d_host: float = 1 * US,
             d_fabric: float = 5 * US, buffer_per_port: float = 6e6,
             switch_buffer: float = 24e6, dt_alpha: float = 1.0,
             seed: int = 0) -> FabricRoutes:
    """Compiled k-ary fat-tree (Al-Fares et al.): k pods of k/2 edge and
    k/2 aggregation switches, (k/2)^2 cores, k^3/4 hosts.

    Inter-pod paths are 5 queued hops (edge-up, agg-up, core-down,
    agg-down, edge-host-down) with (k/2)^2 ECMP choices per pair;
    intra-pod cross-edge paths are 3 hops with k/2 choices; same-edge
    pairs take the single host-downlink hop. Queue blocks, in order:
    edge->agg up, agg->core up, core->agg down, agg->edge down,
    edge->host down.
    """
    if k < 2 or k % 2:
        raise ValueError("fat-tree k must be even and >= 2")
    half = k // 2
    b = FabricBuilder("fat_tree", dt_alpha=dt_alpha)
    # hosts: pod-major, edge-major
    hosts = [b.add_host() for _ in range(k * half * half)]
    edges = [[b.add_switch(TOR, switch_buffer) for _ in range(half)]
             for _ in range(k)]
    aggs = [[b.add_switch(AGG, switch_buffer) for _ in range(half)]
            for _ in range(k)]
    cores = [b.add_switch(CORE, switch_buffer) for _ in range(half * half)]

    def host_id(pod, e, h):
        return (pod * half + e) * half + h

    for pod in range(k):                     # edge -> agg (up)
        for e in range(half):
            for a in range(half):
                b.add_link(edges[pod][e], aggs[pod][a], fabric_bw,
                           d_fabric, queued=True, buffer=buffer_per_port)
    for pod in range(k):                     # agg -> core (up)
        for a in range(half):
            for j in range(half):
                b.add_link(aggs[pod][a], cores[a * half + j], fabric_bw,
                           d_fabric, queued=True, buffer=buffer_per_port)
    for c in range(half * half):             # core -> agg (down)
        for pod in range(k):
            b.add_link(cores[c], aggs[pod][c // half], fabric_bw,
                       d_fabric, queued=True, buffer=buffer_per_port)
    for pod in range(k):                     # agg -> edge (down)
        for a in range(half):
            for e in range(half):
                b.add_link(aggs[pod][a], edges[pod][e], fabric_bw,
                           d_fabric, queued=True, buffer=buffer_per_port)
    for pod in range(k):                     # edge -> host (down)
        for e in range(half):
            for h in range(half):
                b.add_link(edges[pod][e], hosts[host_id(pod, e, h)],
                           host_bw, d_host, queued=True,
                           buffer=buffer_per_port)
    for pod in range(k):                     # unqueued host uplinks
        for e in range(half):
            for h in range(half):
                b.add_link(hosts[host_id(pod, e, h)], edges[pod][e],
                           host_bw, d_host, queued=False)
    return compile_routes(b.build(), seed=seed)
