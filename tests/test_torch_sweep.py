"""The port's declarative sweeps (``core/sweep.py``) against ``repro``'s,
on the CPU.

Mirrors ``tests/test_sweep.py`` and the sweep half of
``tests/test_faults.py`` (both run ``repro`` here through
``test_torch_support.import_repro``; ``test_sweep.py`` does not collect
on jax 0.9 on its own):

* ``expand`` gives ``repro``'s ``SweepPoint``s for specs with every axis;
* ``run_sweep`` gives ``repro``'s results bit for bit on small grids: laws
  x flows x overrides on the slot engine and the padded engine, a
  schedules axis (RDCN), an impairments axis with a backends axis
  (reference and megakernel);
* the fault-tolerant ladder: a transient failure retried, a persistent
  one isolated and recorded (reading its state raises), the fused ->
  reference fallback recorded in ``fallbacks`` (strict mode still
  raises), a poisoned point flagged as diverged while the clean points
  stay bit for bit a clean grid's, strict == fault tolerant when nothing
  fails;
* the sharded forms (``devices``, ``shard_scenario``) raise, naming item
  12; the topology axis's misuse guards.
"""
import functools

import numpy as np
import pytest
import torch

import test_torch_support as sup

B = 100 * 1e9 / 8.0
DT = 1e-6


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _tc():
    import repro_torch.core as tc
    return tc


def _flows(core, n, seed, spread=0.8e-3, **dev):
    rng = np.random.default_rng(seed)
    return core.make_flows_single(n, tau=20 * core.US, nic=B,
                                  sizes=rng.uniform(6e4, 2e5, n),
                                  starts=rng.uniform(0.0, spread, n),
                                  sim_dt=DT, **dev)


def _bottleneck(core, **dev):
    return core.single_bottleneck(bandwidth=B, buffer=16e6, **dev)


def _same_points(got, want, fields=("fct", "w", "q"), rec=("q", "w_sum")):
    """Every point of two ``SweepResult``s bit for bit in ``fields`` of its
    state and ``rec`` of its record."""
    assert tuple(got.points) == tuple(
        type(got.points[0])(*p) for p in want.points)
    for p in got.points:
        a, b = got.state(p.index), want.state(p.index)
        for f in fields:
            assert np.array_equal(_host(getattr(a, f)), _host(getattr(b, f)),
                                  equal_nan=True), (p, f)
        if rec and got.records[got._key(p)] is not None:
            ra, rb = got.record(p.index), want.record(p.index)
            for f in rec:
                assert np.array_equal(_host(getattr(ra, f)),
                                      _host(getattr(rb, f)),
                                      equal_nan=True), (p, "rec." + f)


# -------------------------------------------------------------------------
# expand
# -------------------------------------------------------------------------

def _every_axis_specs(core, **dev):
    """Two specs that between them use every axis (schedules and
    impairments exclude each other)."""
    fl = core.make_flows_single(2, tau=20e-6, nic=1e9, sim_dt=DT, **dev)
    ls = core.LeafSpine(racks=2, hosts_per_rack=4)
    ft = core.fat_tree(4)
    f_ls = core.make_flows_single(3, tau=20e-6, nic=1e9, sim_dt=DT, **dev)
    return [
        core.SweepSpec(laws=["powertcp", "hpcc"], flows=[fl, fl],
                       law_cfg_overrides=({"gamma": 0.8}, {"gamma": 0.9}),
                       schedules=[core.CircuitSchedule(),
                                  core.CircuitSchedule(slot=3)],
                       backends=("reference", "megakernel"), slots=4),
        core.SweepSpec(laws=["powertcp", "swift", "timely"],
                       flows=[[f_ls, f_ls], [f_ls]],
                       topologies=[ls.topology(**dev), ft.topology(**dev)],
                       impairments=[
                           [core.no_impairment(ls.topology(**dev))] * 2,
                           [core.no_impairment(ft.topology(**dev))] * 3],
                       law_cfg_overrides=({}, {"gamma": 0.7}),
                       backends=("reference", "fused", "megakernel")),
    ]


def test_expand_equals_repro():
    tc = _tc()
    core, _ = sup.import_repro()
    for mine, theirs in zip(_every_axis_specs(tc, device="cpu"),
                            _every_axis_specs(core)):
        got, want = tc.expand(mine), core.expand(theirs)
        assert [tuple(p) for p in got] == [tuple(p) for p in want]
        assert len(got) > 8


def test_expand_grid_law_major():
    tc = _tc()
    flows = tc.make_flows_single(2, tau=20e-6, nic=1e9, sim_dt=DT,
                                 device="cpu")
    spec = tc.SweepSpec(laws=["powertcp", "hpcc"], flows=[flows, flows],
                        law_cfg_overrides=({"gamma": 0.8}, {"gamma": 0.9}),
                        schedules=[tc.CircuitSchedule(),
                                   tc.CircuitSchedule(slot=3)])
    pts = tc.expand(spec)
    assert len(pts) == 16
    assert [p.law for p in pts[:8]] == ["powertcp"] * 8
    assert [p.row for p in pts[8:]] == list(range(8))
    assert [p.sched_idx for p in pts[:4]] == [0, 1, 0, 1]
    assert tc.expand(tc.SweepSpec(laws=["powertcp"], flows=[flows]))[
        0].sched_idx == -1
    with pytest.raises(ValueError):
        tc.SweepSpec(laws=[], flows=[flows])
    with pytest.raises(ValueError):
        tc.SweepSpec(laws=["powertcp"], flows=[flows],
                     schedules=[tc.CircuitSchedule()],
                     impairments=[tc.no_impairment(
                         tc.single_bottleneck(device="cpu"))])


# -------------------------------------------------------------------------
# run_sweep against repro
# -------------------------------------------------------------------------

def _grid(core, slots, **dev):
    topo = _bottleneck(core, **dev)
    flows = [_flows(core, 5 + s, s, spread=2e-4, **dev) for s in range(2)]
    spec = core.SweepSpec(laws=["powertcp", "swift"], flows=flows,
                          law_cfg_overrides=({"gamma": 0.8},
                                             {"gamma": 0.9}),
                          expected_flows=4.0, slots=slots)
    return spec, topo, core.SimConfig(dt=DT, steps=1000, hist=256)


@pytest.mark.parametrize("slots", [6, None], ids=["slot", "padded"])
def test_run_sweep_matches_repro(slots):
    """laws x flows x overrides, on the slot engine and on the padded
    engine: every point bit for bit ``repro``'s."""
    tc = _tc()
    core, _ = sup.import_repro()
    spec, topo, cfg = _grid(tc, slots, device="cpu")
    jspec, jtopo, jcfg = _grid(core, slots)
    got = tc.run_sweep(spec, topo, cfg, device="cpu")
    want = core.run_sweep(jspec, jtopo, jcfg)
    assert len(got.points) == 8
    _same_points(got, want)


def _rdcn(core, **dev):
    scheds = [core.CircuitSchedule(day=45e-6, night=5e-6, matchings=4,
                                   slot=s) for s in (0, 2)]
    topo = core.voq_topology(scheds[0], **dev)
    flows = core.make_flows_single(4, tau=24e-6, nic=25 * 12.5e8,
                                   sim_dt=DT, **dev)
    cfg = core.SimConfig(dt=DT, steps=600, hist=256, update_period=0.0)
    spec = core.SweepSpec(laws=["powertcp", "retcp"], flows=[flows],
                          schedules=scheds,
                          law_cfg_overrides=({"retcp_prebuffer": 600e-6},
                                             {"retcp_prebuffer": 200e-6}),
                          expected_flows=16.0, slots=4)
    return spec, topo, cfg


def test_run_sweep_schedules_axis_matches_repro():
    """A schedules axis (per-scenario circuit schedules through
    ``bw_params``; reTCP's through its law config): bit for bit
    ``repro``'s."""
    tc = _tc()
    core, _ = sup.import_repro()
    spec, topo, cfg = _rdcn(tc, device="cpu")
    jspec, jtopo, jcfg = _rdcn(core)
    _same_points(tc.run_sweep(spec, topo, cfg, device="cpu"),
                 core.run_sweep(jspec, jtopo, jcfg),
                 rec=("q", "thru", "w_sum"))


def _impaired(core, **dev):
    topo = _bottleneck(core, **dev)
    regimes = [sup.golden_impair_regime(core, topo, **dev),
               core.no_impairment(topo)]
    spec = core.SweepSpec(laws=["powertcp", "hpcc"],
                          flows=[_flows(core, 10, 3, **dev)],
                          impairments=regimes, expected_flows=8.0, slots=8,
                          backends=("reference", "megakernel"))
    return spec, topo, core.SimConfig(dt=DT, steps=1000, hist=256)


def test_run_sweep_impairments_and_backends_match_repro():
    """An impairments axis (a regime per scenario, stacked) with a backends
    axis: the reference and megakernel groups are each bit for bit
    ``repro``'s, and each other's."""
    tc = _tc()
    core, _ = sup.import_repro()
    spec, topo, cfg = _impaired(tc, device="cpu")
    jspec, jtopo, jcfg = _impaired(core)
    got = tc.run_sweep(spec, topo, cfg, device="cpu")
    _same_points(got, core.run_sweep(jspec, jtopo, jcfg))
    assert set(got.states) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for p in got.points:
        if p.backend == "megakernel":
            twin = next(q for q in got.points if q.backend == "reference"
                        and q.law == p.law and q.impair_idx == p.impair_idx)
            assert np.array_equal(_host(got.state(p.index).fct),
                                  _host(got.state(twin.index).fct),
                                  equal_nan=True)


def test_topology_axis_and_misuse_guards():
    """A topology axis keys results by (topology, law, backend); each
    point equals its serial run; the misuse guards raise."""
    tc = _tc()
    ls = tc.LeafSpine(racks=2, hosts_per_rack=4)
    ft = tc.fat_tree(4)
    f_ls = [tc.poisson_websearch(ls, 0.4, 0.0006, DT, seed=s, device="cpu")
            for s in (0, 1)]
    f_ft = [tc.poisson_websearch(ft, 0.3, 0.0006, DT, seed=0, device="cpu")]
    spec = tc.SweepSpec(laws=["powertcp"], flows=[f_ls, f_ft],
                        topologies=[ls.topology(device="cpu"),
                                    ft.topology(device="cpu")],
                        expected_flows=8.0)
    cfg = tc.SimConfig(dt=DT, steps=800, hist=256, update_period=2e-6)
    res = tc.run_sweep(spec, cfg=cfg, record=False, device="cpu")
    assert set(res.states) == {(0, 0, 0), (1, 0, 0)}
    for p in res.points:
        fl = spec.flows[p.topo_idx][p.flows_idx]
        st, _ = tc.simulate(spec.topologies[p.topo_idx], fl, "powertcp",
                            tc.default_law_config(fl, expected_flows=8.0),
                            cfg, record=False, device="cpu")
        got = _host(res.state(p.index).fct)[:int(fl.tau.shape[0])]
        assert np.array_equal(got, _host(st.fct), equal_nan=True)
    with pytest.raises(ValueError):
        tc.run_sweep(spec, ls.topology(device="cpu"), cfg, device="cpu")
    with pytest.raises(ValueError):
        tc.SweepSpec(laws=["powertcp"], flows=[f_ls],
                     topologies=[ls.topology(device="cpu"),
                                 ft.topology(device="cpu")])
    with pytest.raises(ValueError):
        tc.run_sweep(tc.SweepSpec(laws=["powertcp"], flows=f_ls), None,
                     cfg, device="cpu")


def test_sharded_forms_raise_naming_item_12():
    """The sharded forms are ported (item 12): in one process ``devices``
    clamps to one device, and ``shard_scenario=True`` runs each point
    through the sharded slot engine; both are bit for bit the plain
    sweep (over the grid's first 300 ticks). Over several ranks they are
    held in ``test_torch_shard_mesh.py``."""
    tc = _tc()
    spec, topo, cfg = _grid(tc, 6, device="cpu")
    cfg = cfg._replace(steps=300)
    base = tc.run_sweep(spec, topo, cfg, record=False, device="cpu")
    for kw in (dict(devices="auto"), dict(devices=2),
               dict(shard_scenario=True)):
        got = tc.run_sweep(spec, topo, cfg, record=False, device="cpu",
                           **kw)
        assert got.points == base.points
        for k in base.states:
            torch.testing.assert_close(got.states[k].fct,
                                       base.states[k].fct, rtol=0, atol=0,
                                       equal_nan=True)


# -------------------------------------------------------------------------
# the fault-tolerant ladder
# -------------------------------------------------------------------------

def _small(steps=1000):
    tc = _tc()
    topo = _bottleneck(tc, device="cpu")
    return tc, topo, _flows(tc, 10, 3, spread=0.5e-3, device="cpu"), \
        tc.SimConfig(dt=DT, steps=steps, hist=256)


def _flaky_law(fail_times, exc):
    """A law whose init raises ``exc`` on its first ``fail_times`` calls."""
    tc = _tc()
    calls = {"n": 0}
    inner = tc.get_law("powertcp", "reference")

    def init(n, lcfg):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise exc("injected")
        return inner.init(n, lcfg)
    return inner._replace(name="flaky_powertcp", init=init), calls


def test_sweep_retries_transient_failures():
    tc, topo, fl, cfg = _small()
    law, calls = _flaky_law(1, tc.TransientFault)
    spec = tc.SweepSpec(laws=(law,), flows=(fl,), expected_flows=8.0,
                        slots=8)
    res = tc.run_sweep(spec, topo, cfg, fault_tolerant=True, retries=2,
                       backoff_s=0.01, device="cpu")
    assert not res.failures and calls["n"] >= 2
    assert torch.isfinite(res.state(0).fct).all()


def test_sweep_records_persistent_failure_and_isolates_it():
    tc, topo, fl, cfg = _small()
    law, _ = _flaky_law(10 ** 9, ValueError)
    spec = tc.SweepSpec(laws=("powertcp", law), flows=(fl,),
                        expected_flows=8.0, slots=8)
    res = tc.run_sweep(spec, topo, cfg, fault_tolerant=True, retries=1,
                       backoff_s=0.0, device="cpu")
    assert [f.index for f in res.failures] == [1]
    assert res.failures[0].stage == "run"
    assert "ValueError" in res.failures[0].error
    with pytest.raises(RuntimeError):
        res.state(1)
    assert torch.isfinite(res.state(0).fct).all()


def test_sweep_falls_back_from_fused_to_reference():
    """The fused backend rejects a regime (``UnsupportedFeature``): the
    group degrades to the reference backend, the substitution is recorded
    and the results are the reference's; strict mode raises."""
    tc, topo, fl, cfg = _small()
    spec = tc.SweepSpec(laws=("powertcp",), flows=(fl,), expected_flows=8.0,
                        slots=8, backends=("fused",),
                        impairments=(tc.no_impairment(topo),))
    res = tc.run_sweep(spec, topo, cfg, fault_tolerant=True, device="cpu")
    assert not res.failures
    assert res.fallbacks == (((0, 0), "fused", "reference"),)
    ref = tc.run_sweep(spec.__class__(**{**spec.__dict__,
                                         "backends": ("reference",)}),
                       topo, cfg, device="cpu")
    assert torch.equal(res.state(0).w, ref.state(0).w)
    with pytest.raises(tc.UnsupportedFeature):
        tc.run_sweep(spec, topo, cfg, device="cpu")


def test_megakernel_group_never_falls_back_on_an_error():
    """A megakernel group that raises anything but ``UnsupportedFeature``
    (here a law without a K4 path on a CUDA-less box stands in, raising
    in its init) fails its points; it is never rerun on another
    backend."""
    tc, topo, fl, cfg = _small()
    law, _ = _flaky_law(10 ** 9, RuntimeError)
    spec = tc.SweepSpec(laws=(law,), flows=(fl,), expected_flows=8.0,
                        slots=8, backend="megakernel")
    res = tc.run_sweep(spec, topo, cfg, fault_tolerant=True, retries=1,
                       backoff_s=0.0, device="cpu")
    assert res.fallbacks == ()
    assert [(f.index, f.stage, f.backend) for f in res.failures] == [
        (0, "run", "megakernel")]


def test_strict_mode_equals_fault_tolerant():
    tc, topo, fl, cfg = _small()
    spec = tc.SweepSpec(laws=("powertcp", "hpcc"), flows=(fl,),
                        expected_flows=8.0, slots=8)
    a = tc.run_sweep(spec, topo, cfg, device="cpu")
    b = tc.run_sweep(spec, topo, cfg, fault_tolerant=True, device="cpu")
    assert not b.failures and not b.fallbacks
    for i in range(len(a.points)):
        assert torch.equal(a.state(i).w, b.state(i).w)
        assert np.array_equal(_host(a.state(i).fct), _host(b.state(i).fct),
                              equal_nan=True)


def test_sweep_poisoned_point_isolated_and_clean_points_bitmatch():
    """``fault_fct.sweep_isolation``: the poisoned point is flagged as
    diverged, every clean point is bit for bit a clean grid's."""
    tc = _tc()
    topo = _bottleneck(tc, device="cpu")
    fl = _flows(tc, 14, 3, device="cpu")
    cfg = tc.SimConfig(dt=DT, steps=1500, hist=256)
    bad = tc.poison_law("powertcp", at_t=0.3e-3)
    res = tc.run_sweep(
        tc.SweepSpec(laws=("powertcp", bad, "hpcc"), flows=(fl,),
                     expected_flows=8.0, slots=8),
        topo, cfg, fault_tolerant=True, device="cpu")
    assert [(f.index, f.stage) for f in res.failures] == [(1, "divergence")]
    assert res.failure(1) is not None
    assert res.state(1) is not None          # kept, flagged
    clean = tc.run_sweep(
        tc.SweepSpec(laws=("powertcp", "hpcc"), flows=(fl,),
                     expected_flows=8.0, slots=8), topo, cfg, device="cpu")
    for i, j in ((0, 0), (2, 1)):
        a, b = res.state(i), clean.state(j)
        for f in ("fct", "w", "q"):
            assert np.array_equal(_host(getattr(a, f)), _host(getattr(b, f)),
                                  equal_nan=True), (i, f)
