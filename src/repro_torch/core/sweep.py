"""Declarative scenario sweeps with the fault-tolerant ladder (twin of
``repro.core.sweep``).

A ``SweepSpec`` names a grid over

  * ``laws``: law names (or prebuilt ``Law`` instances),
  * ``flows``: scenarios (anything expressible as a ``Flows``),
  * ``law_cfg_overrides``: dicts of ``LawConfig`` field overrides,
  * ``schedules``: optional time-varying bandwidth schedules
    (``rdcn.CircuitSchedule``),
  * ``impairments``: optional per-link impairment regimes
    (``impair.ImpairmentParams``), an array axis like ``schedules``; with a
    ``topologies`` axis, one Sequence[ImpairmentParams] per topology.
    Exclusive with ``schedules`` (two owners of the bandwidth vector),
  * ``backends``: optional backend axis (reference / fused / megakernel),
    structural like the law axis,
  * ``topologies``: optional structural fabric axis, ``flows[t]`` the
    scenarios of ``topologies[t]``.

``run_sweep`` expands the grid and runs each (topology, law, backend)
group as one batch through ``fluid.simulate_batch`` (or, with
``spec.slots``, ``fluid.simulate_slots_batch``): the group's scenarios are
padded to a common flow count and stacked on the batch axis, with their
law configs, schedules and regimes. On the card a megakernel group is one
K4 launch of one block per scenario per 64 ticks.

``fault_tolerant=True`` adds the ladder: bounded retry with backoff on
transient failures (``faults.is_transient``: a kernel's launch error or an
allocator failure is a ``RuntimeError`` and is retried), the declared
backend fallback (``FALLBACK_CHAIN``) on ``UnsupportedFeature`` and on
nothing else, per-point isolation when a whole group still fails, and the
post-hoc divergence scan of the finished rows.

``devices`` splits each group's batch over the ranks of the process
group (``fluid.simulate_batch``'s ``devices``); ``shard_scenario=True``
runs each point alone through the sharded slot engine
(``shardslots.simulate_slots_sharded``), its pool split over the ranks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .faults import UnsupportedFeature, is_transient
from .fluid import (_pad_inv, _to, default_law_config, pad_flows,
                    simulate_batch, simulate_slots_batch,
                    stack_flow_schedules, stack_flows, stack_law_configs)
from .guard import first_divergent_field
from .impair import ImpairmentParams, stack_impairments
from .laws import Law
from .network import make_schedule
from .rdcn import CircuitSchedule, circuit_bw_at, stack_schedules
from .types import (Flows, SimConfig, Topology, resolve_device,
                    stack_trees, tree_map)


class SweepPoint(NamedTuple):
    """One expanded grid point.

    ``index`` is the global position (topology-major, then law-major, then
    backend-major, then flows x overrides x schedules x impairments
    row-major); ``row`` the position inside its (topology, law, backend)
    batch. ``sched_idx`` is -1 without a schedule axis, ``impair_idx`` -1
    without an impairment axis, ``topo_idx`` 0 without a topology axis.
    """
    index: int
    row: int
    law_idx: int
    law: str
    flows_idx: int
    override_idx: int
    sched_idx: int
    backend: str = "reference"
    backend_idx: int = 0
    topo_idx: int = 0
    impair_idx: int = -1


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative grid; see the module docstring. ``slots`` switches the
    grid onto the flow-slot engine (each scenario's flows sorted into a
    ``FlowSchedule``; result ``fct`` rows in schedule order)."""
    laws: Sequence[Union[str, Law]]
    flows: Sequence[Flows]
    law_cfg_overrides: Sequence[dict] = ({},)
    schedules: Optional[Sequence[CircuitSchedule]] = None
    expected_flows: float = 1.0
    backend: str = "reference"
    slots: Optional[int] = None
    backends: Optional[Sequence[str]] = None
    topologies: Optional[Sequence[Topology]] = None
    impairments: Optional[Sequence] = None

    def __post_init__(self):
        if not self.laws or not self.flows or not self.law_cfg_overrides:
            raise ValueError("laws, flows and law_cfg_overrides must be "
                             "non-empty")
        if self.schedules is not None and not self.schedules:
            raise ValueError("schedules must be None or non-empty")
        if self.impairments is not None:
            if self.schedules is not None:
                raise ValueError(
                    "impairments and schedules are mutually exclusive (two "
                    "owners of the bandwidth vector) — wrap the circuit "
                    "schedule as a KIND_SCHEDULE impairment process instead")
            if not self.impairments:
                raise ValueError("impairments must be None or non-empty")
            if self.topologies is not None:
                # an ImpairmentParams is itself a non-empty tuple: check
                # the nesting explicitly
                nested_ok = (
                    len(self.impairments) == len(self.topologies) and
                    all(isinstance(g, (list, tuple)) and
                        not isinstance(g, ImpairmentParams) and len(g) > 0
                        for g in self.impairments))
                if not nested_ok:
                    raise ValueError(
                        "with a topology axis, impairments must be one "
                        "non-empty Sequence[ImpairmentParams] per topology "
                        "(a [Q] regime only fits its own fabric) — got "
                        "un-nested or mismatched impairments")
            elif any(not isinstance(p, ImpairmentParams)
                     for p in self.impairments):
                raise ValueError("impairments must be ImpairmentParams "
                                 "(see impair.fabric_impairments)")
        if self.slots is not None and self.slots < 1:
            raise ValueError("slots must be None or >= 1")
        if self.backends is not None and not self.backends:
            raise ValueError("backends must be None or non-empty")
        if self.topologies is not None:
            if not self.topologies:
                raise ValueError("topologies must be None or non-empty")
            # a Flows NamedTuple is itself a non-empty tuple: check the
            # nesting explicitly
            nested_ok = (len(self.flows) == len(self.topologies) and
                         all(isinstance(g, (list, tuple)) and
                             not isinstance(g, Flows) and len(g) > 0
                             for g in self.flows))
            if not nested_ok:
                raise ValueError(
                    "with a topology axis, flows must be one non-empty "
                    "Sequence[Flows] per topology (flows[t] belongs to "
                    "topologies[t]) — got un-nested or mismatched flows")

    @property
    def flow_groups(self) -> Sequence[Sequence[Flows]]:
        """Per-topology scenario groups."""
        return (tuple(self.flows) if self.topologies is not None
                else (tuple(self.flows),))

    @property
    def impair_groups(self) -> Sequence[Optional[Sequence[ImpairmentParams]]]:
        """Per-topology impairment groups (None without the axis)."""
        ngroups = (len(self.topologies) if self.topologies is not None
                   else 1)
        if self.impairments is None:
            return (None,) * ngroups
        return (tuple(self.impairments) if self.topologies is not None
                else (tuple(self.impairments),))

    @property
    def backend_axis(self) -> Sequence[str]:
        """``backends`` when given, else the single ``backend``."""
        return tuple(self.backends) if self.backends is not None \
            else (self.backend,)


def _law_name(law: Union[str, Law]) -> str:
    return law.name if isinstance(law, Law) else law


def expand(spec: SweepSpec) -> List[SweepPoint]:
    """The expanded grid, topology-major, then law-major, then
    backend-major (one contiguous run of rows per group). ``flows_idx``
    indexes the point's own topology group."""
    pts: List[SweepPoint] = []
    scheds = (range(len(spec.schedules)) if spec.schedules is not None
              else (-1,))
    for ti, group in enumerate(spec.flow_groups):
        imp_group = spec.impair_groups[ti]
        imps = range(len(imp_group)) if imp_group is not None else (-1,)
        for li, law in enumerate(spec.laws):
            for bi, be in enumerate(spec.backend_axis):
                row = 0
                for fi in range(len(group)):
                    for oi in range(len(spec.law_cfg_overrides)):
                        for si in scheds:
                            for ii in imps:
                                pts.append(SweepPoint(len(pts), row, li,
                                                      _law_name(law), fi,
                                                      oi, si, be, bi, ti,
                                                      ii))
                                row += 1
    return pts


def tree_index(tree, i):
    """Index ``i`` of every array leaf's leading (batch) axis."""
    return None if tree is None else tree_map(lambda x: x[i], tree)


class PointFailure(NamedTuple):
    """One failed point of a fault-tolerant sweep: ``stage`` is ``"run"``
    (its group and its own run raised, after retries, fallback and
    isolation: no result exists) or ``"divergence"`` (it ran to its end
    with a non-finite field in its final carry, kept and flagged);
    ``attempts`` counts executions; ``backend`` produced the outcome."""
    index: int
    law: str
    backend: str
    stage: str
    error: str
    attempts: int = 1


class SweepResult(NamedTuple):
    """Per-group batched results and the point list that indexes them.

    ``states``/``records`` are keyed by group: ``law_idx`` without a
    backend or topology axis, ``(law_idx, backend_idx)`` with a backend
    axis, ``(topo_idx, law_idx, backend_idx)`` with a topology axis.
    ``state(i)``/``record(i)`` return point ``i`` whatever the keying; for
    a ``"run"``-stage failure they raise. ``fallbacks`` records backend
    substitutions as ``(group_key, declared_backend, used_backend)``.
    """
    points: Tuple[SweepPoint, ...]
    states: Dict[object, object]
    records: Dict[object, object]
    failures: Tuple[PointFailure, ...] = ()
    fallbacks: Tuple[Tuple[object, str, str], ...] = ()

    def _key(self, p: SweepPoint):
        if p.law_idx in self.states:
            return p.law_idx
        if (p.law_idx, p.backend_idx) in self.states:
            return (p.law_idx, p.backend_idx)
        return (p.topo_idx, p.law_idx, p.backend_idx)

    def failure(self, i: int) -> Optional[PointFailure]:
        """The PointFailure of point ``i``, or None."""
        for f in self.failures:
            if f.index == i:
                return f
        return None

    def _check(self, i: int) -> SweepPoint:
        f = self.failure(i)
        if f is not None and f.stage == "run":
            raise RuntimeError(
                f"sweep point {i} (law '{f.law}', backend '{f.backend}') "
                f"failed after {f.attempts} attempt(s): {f.error}")
        return self.points[i]

    def state(self, i: int):
        p = self._check(i)
        return tree_index(self.states[self._key(p)], p.row)

    def record(self, i: int):
        p = self._check(i)
        return tree_index(self.records[self._key(p)], p.row)


# The declared backend degradation chain: when a backend raises its
# documented rejection (``UnsupportedFeature``, never a plain error and
# never a kernel's build or launch error), a fault-tolerant sweep retries
# the group on the next backend. The slot reference engine implements
# every feature the grid axes can express.
FALLBACK_CHAIN: Dict[str, Tuple[str, ...]] = {
    "megakernel": ("reference",),
    "fused": ("reference",),
}


def _run_with_retries(fn, retries: int, backoff_s: float):
    """``(fn(), attempts)`` with bounded retry and backoff on transient
    failures; structured errors escape at once."""
    attempt = 0
    while True:
        try:
            return fn(), attempt + 1
        except Exception as e:
            if not is_transient(e) or attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


def _run_degraded(backend: str, run_fn, retries: int, backoff_s: float):
    """``(run_fn(be), used_backend, attempts)`` walking the fallback chain
    on ``UnsupportedFeature`` (other exceptions, after retries, escape to
    the caller's isolation)."""
    attempts = 0
    last: Optional[BaseException] = None
    for be in (backend,) + FALLBACK_CHAIN.get(backend, ()):
        try:
            res, att = _run_with_retries(lambda: run_fn(be), retries,
                                         backoff_s)
            return res, be, attempts + att
        except UnsupportedFeature as e:
            last = e
            attempts += 1
    raise last


def _nan_filler(tmpl):
    """An inert stand-in row for a failed point: NaN floats, zero ints."""
    def fill(x):
        if isinstance(x, torch.Tensor):
            return (torch.full_like(x, float("nan")) if x.is_floating_point()
                    else torch.zeros_like(x))
        return (np.full_like(x, np.nan) if np.issubdtype(x.dtype, np.floating)
                else np.zeros_like(x))
    return tree_map(fill, tmpl)


def _stack_rows(rows):
    """Per-point results stacked on a new batch axis; the reference slot
    engine's gather tables (``inv``, one width per run) widened first with
    the sentinel index, as ``simulate_slots_batch`` joins them."""
    if all(isinstance(getattr(r, "inv", None), torch.Tensor) for r in rows):
        width = max(int(r.inv.shape[-1]) for r in rows)
        S, H = (int(n) for n in rows[0].path.shape[-2:])
        rows = [_pad_inv(r, width, S * H) for r in rows]
    return stack_trees(rows)


def _stack_points(sts, rcs, record: bool):
    """Per-point results (state, record) stacked on a new batch axis, a
    failed point (None) an inert NaN row (``_nan_filler``); None when
    every point failed."""
    tmpl = next((s for s in sts if s is not None), None)
    if tmpl is None:
        return None
    fill_s = _nan_filler(tmpl)
    rtmpl = next((r for r in rcs if r is not None), None)
    fill_r = _nan_filler(rtmpl) if rtmpl is not None else None
    return (_stack_rows([fill_s if s is None else s for s in sts]),
            stack_trees([fill_r if r is None else r for r in rcs])
            if record else None)


def run_sweep(spec: SweepSpec, topo: Optional[Topology] = None,
              cfg: Optional[SimConfig] = None, record: bool = True,
              devices=None, shard_scenario: bool = False,
              chunk: Optional[int] = None,
              fault_tolerant: bool = False, retries: int = 1,
              backoff_s: float = 0.25, device="cuda") -> SweepResult:
    """Expand ``spec`` and run it on ``device``: one batch per (topology,
    law, backend) group covering that group's slab of the grid. Pass
    ``topo`` for a single-fabric spec; with a ``topologies`` axis the
    fabrics come from the spec and ``topo`` must be None.

    ``fault_tolerant=True`` turns hard failures into per-point bookkeeping:
    each group runs with bounded retry and backoff (``retries`` extra
    attempts, exponential from ``backoff_s``) on transient failures,
    degrades along ``FALLBACK_CHAIN`` on ``UnsupportedFeature`` and, if the
    whole group still fails, re-runs its points one at a time so that one
    bad point cannot take down the others. The finished rows are then
    scanned for non-finite carries (``guard.first_divergent_field``).
    Failed points land in ``SweepResult.failures``; every other point is
    bit for bit a clean run of the same spec (the batch's scenarios share
    nothing). Without it the first exception propagates unchanged.

    ``devices`` goes to the batched engines: with a process group of
    several ranks, every rank calls ``run_sweep`` and each group's batch
    is split over them (bit for bit the unsharded sweep).
    ``shard_scenario=True`` instead runs each point alone, its slot pool
    and queue accumulation split over the ranks
    (``shardslots.simulate_slots_sharded``; ``chunk`` streams each
    point's schedule): it needs a slot spec, the reference backend and no
    RDCN schedule axis (``ValueError``), and is bit for bit the batched
    slot path. Under ``fault_tolerant`` a sharded point is retried on
    transient failures and otherwise recorded as a ``PointFailure`` of
    backend ``"sharded"``; it never falls back to another engine.
    """
    if shard_scenario:
        if spec.slots is None:
            raise ValueError("shard_scenario requires a slot spec "
                             "(spec.slots)")
        if any(be != "reference" for be in spec.backend_axis):
            raise ValueError("shard_scenario supports the reference "
                             "backend only")
        if spec.schedules is not None:
            raise ValueError("shard_scenario does not support an RDCN "
                             "schedule axis")
    dev = resolve_device(device)
    if spec.topologies is not None:
        if topo is not None:
            raise ValueError("spec carries a topology axis; pass topo=None")
        topos = list(spec.topologies)
    else:
        if topo is None:
            raise ValueError("pass topo (or give the spec a topology axis)")
        topos = [topo]

    points = expand(spec)
    states: Dict[object, object] = {}
    records: Dict[object, object] = {}
    failures: List[PointFailure] = []
    fallbacks: List[Tuple[object, str, str]] = []
    for ti, (topo_t, group) in enumerate(zip(topos, spec.flow_groups)):
        topo_t = _to(topo_t, dev)
        nmax = max(int(f.tau.shape[0]) for f in group)
        padded = [pad_flows(_to(f, dev), nmax, topo_t.num_queues)
                  for f in group]
        # slot path: the schedules are sorted views of the padded flows,
        # so per-flow LawConfig vectors derive from the sorted metadata
        scheds = ([make_schedule(f) for f in padded]
                  if spec.slots is not None else None)
        imp_group = spec.impair_groups[ti]
        for li, law in enumerate(spec.laws):
            for bi, be in enumerate(spec.backend_axis):
                if spec.topologies is not None:
                    key = (ti, li, bi)
                else:
                    key = li if spec.backends is None else (li, bi)
                rows = [p for p in points
                        if p.topo_idx == ti and p.law_idx == li
                        and p.backend_idx == bi]
                lcfgs = []
                for p in rows:
                    kw = dict(spec.law_cfg_overrides[p.override_idx])
                    if spec.schedules is not None:
                        kw.setdefault("sched", spec.schedules[
                            p.sched_idx].params(dev))
                    src = (scheds if scheds is not None
                           else padded)[p.flows_idx]
                    lcfgs.append(default_law_config(
                        src, expected_flows=spec.expected_flows, **kw))
                bw_fn = bw_params = None
                if spec.schedules is not None:
                    bw_fn = circuit_bw_at
                    bw_params = stack_schedules(
                        [spec.schedules[p.sched_idx] for p in rows], dev)
                impair_params = (stack_impairments(
                    [_to(imp_group[p.impair_idx], dev) for p in rows])
                    if imp_group is not None else None)

                if shard_scenario:
                    states[key], records[key] = _run_sharded_points(
                        spec, topo_t, law, rows, lcfgs, scheds, imp_group,
                        cfg, record, devices, chunk, fault_tolerant,
                        retries, backoff_s, failures, dev)
                    continue

                def run_group(be_, rows=rows, lcfgs=lcfgs, bw_fn=bw_fn,
                              bw_params=bw_params,
                              impair_params=impair_params, topo_t=topo_t,
                              padded=padded, scheds=scheds):
                    if spec.slots is not None:
                        sb = stack_flow_schedules(
                            [scheds[p.flows_idx] for p in rows],
                            topo_t.num_queues)
                        return simulate_slots_batch(
                            topo_t, sb, law, spec.slots,
                            stack_law_configs(lcfgs), cfg, bw_fn=bw_fn,
                            bw_params=bw_params, record=record,
                            backend=be_, devices=devices,
                            impair_params=impair_params, device=dev)
                    fb = stack_flows([padded[p.flows_idx] for p in rows],
                                     topo_t.num_queues)
                    return simulate_batch(
                        topo_t, fb, law, stack_law_configs(lcfgs), cfg,
                        bw_fn=bw_fn, bw_params=bw_params, record=record,
                        backend=be_, devices=devices,
                        impair_params=impair_params, device=dev)

                def run_point(p, lcfg, be_, bw_fn=bw_fn, topo_t=topo_t,
                              padded=padded, scheds=scheds,
                              imp_group=imp_group):
                    """The group's run at batch width 1: the isolation
                    route when the whole group fails."""
                    bw1 = (stack_schedules([spec.schedules[p.sched_idx]],
                                           dev)
                           if spec.schedules is not None else None)
                    imp1 = (stack_impairments(
                        [_to(imp_group[p.impair_idx], dev)])
                        if imp_group is not None else None)
                    if spec.slots is not None:
                        sb1 = stack_flow_schedules(
                            [scheds[p.flows_idx]], topo_t.num_queues)
                        st, rc = simulate_slots_batch(
                            topo_t, sb1, law, spec.slots,
                            stack_law_configs([lcfg]), cfg, bw_fn=bw_fn,
                            bw_params=bw1, record=record, backend=be_,
                            impair_params=imp1, device=dev)
                    else:
                        fb1 = stack_flows([padded[p.flows_idx]],
                                          topo_t.num_queues)
                        st, rc = simulate_batch(
                            topo_t, fb1, law, stack_law_configs([lcfg]),
                            cfg, bw_fn=bw_fn, bw_params=bw1,
                            record=record, backend=be_,
                            impair_params=imp1, device=dev)
                    return (tree_index(st, 0),
                            tree_index(rc, 0) if record else None)

                if not fault_tolerant:
                    states[key], records[key] = run_group(be)
                    continue

                used_be = be
                try:
                    (states[key], records[key]), used_be, _ = \
                        _run_degraded(be, run_group, retries, backoff_s)
                    if used_be != be:
                        fallbacks.append((key, be, used_be))
                except Exception:
                    # the whole group failed: isolate its points so that
                    # one bad point cannot take down the others
                    sts, rcs = [], []
                    for p, lcfg in zip(rows, lcfgs):
                        try:
                            (st_i, rec_i), used_i, _ = _run_degraded(
                                be,
                                lambda b, p=p, lcfg=lcfg:
                                    run_point(p, lcfg, b),
                                retries, backoff_s)
                            if used_i != be:
                                fallbacks.append((key, be, used_i))
                        except Exception as e:
                            failures.append(PointFailure(
                                p.index, p.law, be, "run", repr(e),
                                retries + 1))
                            st_i = rec_i = None
                        sts.append(st_i)
                        rcs.append(rec_i)
                    stacked = _stack_points(sts, rcs, record)
                    if stacked is None:
                        states[key] = records[key] = None
                        continue
                    states[key], records[key] = stacked

                # post-hoc divergence scan: a poisoned point runs to its
                # end inside the batch (NaN does not raise); flag its row
                failed_idx = {f.index for f in failures}
                for p in rows:
                    if p.index in failed_idx:
                        continue
                    field = first_divergent_field(
                        tree_index(states[key], p.row))
                    if field:
                        failures.append(PointFailure(
                            p.index, p.law, used_be, "divergence",
                            f"non-finite field '{field}' in final "
                            f"carry", 1))
    return SweepResult(tuple(points), states, records,
                       tuple(failures), tuple(fallbacks))


def _run_sharded_points(spec: SweepSpec, topo_t, law, rows, lcfgs, scheds,
                        imp_group, cfg, record: bool, devices, chunk,
                        fault_tolerant: bool, retries: int, backoff_s: float,
                        failures: list, dev):
    """A group's points one by one through the sharded slot engine
    (``repro``'s route, ``sweep.py:489-530``): each point's regime rides
    un-stacked, the rows are stacked after. Fault-tolerant: bounded retry
    (``_run_degraded`` from ``"reference"``, whose chain is empty), then a
    ``PointFailure(..., "sharded", "run", ...)`` and a NaN row."""
    from .shardslots import simulate_slots_sharded

    def run_point(p, lcfg):
        imp_p = (_to(imp_group[p.impair_idx], dev)
                 if imp_group is not None else None)
        return simulate_slots_sharded(
            topo_t, scheds[p.flows_idx], law, spec.slots, lcfg, cfg,
            record=record, devices=devices, chunk=chunk, impair=imp_p,
            device=dev)

    sts, rcs = [], []
    for p, lcfg in zip(rows, lcfgs):
        if not fault_tolerant:
            st_i, rec_i = run_point(p, lcfg)
        else:
            try:
                (st_i, rec_i), _, _ = _run_degraded(
                    "reference", lambda b, p=p, lcfg=lcfg: run_point(p, lcfg),
                    retries, backoff_s)
            except Exception as e:
                failures.append(PointFailure(p.index, p.law, "sharded",
                                             "run", repr(e), retries + 1))
                st_i = rec_i = None
        sts.append(st_i)
        rcs.append(rec_i)
    return _stack_points(sts, rcs, record) or (None, None)
