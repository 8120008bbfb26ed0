"""The port's sharded slot engine at one rank, in this process, against
``repro``'s slot engine and the port's own, on the CPU.

Mirrors ``tests/test_shard_scenario.py``'s one-device tests. The run's
process group is the default group, initialized on first use as a
one-rank gloo group from a ``HashStore`` (no network):

* every one of the 13 laws on the 12-flow single bottleneck
  (``_scenario``, cut to 1 400 ticks: every flow completes by then; the
  replicated layout, S * H <= 128), bit for bit ``repro``'s
  ``simulate_slots`` in the queue trace, FCTs (``equal_nan``), final
  windows, per-slot rates, ``w_sum`` and ``n_active`` (the clean leg of
  the registry check; its impaired, chunked leg on the fat tree is
  ``test_torch_shard_registry.py``);
* leaf for leaf the port's reference slot engine in both layouts, the
  CSR one on the leaf-spine anchor under its mixed regime;
* a bounded pool (S < N) streamed in chunks of 9;
* ``repro``'s ``ValueError``s: ``record_every > 1``, a pool that does not
  divide over the ranks, and ``run_sweep(shard_scenario=True)`` without
  slots, off the reference backend or with an RDCN schedule axis;
* ``run_sweep(shard_scenario=True)`` point for point the batched slot
  path, and its fault-tolerant ladder ``repro``'s: a failing point is
  retried, then recorded as a ``PointFailure`` of backend ``"sharded"``,
  with no fallback;
* ``test_faults.py``'s sharded seams: a regime (the zero preset bit for
  bit the unimpaired run) and a feedback law.

``repro`` is imported only through ``test_torch_support.import_repro``.
"""
import numpy as np
import pytest
import torch

import test_torch_support as sup

STEPS = 1400


def _scenario(core, n=12, steps=STEPS, seed=0, **dev):
    """``test_shard_scenario._scenario`` in either package."""
    B = 100 * core.GBPS
    topo = core.single_bottleneck(bandwidth=B, buffer=16e6, **dev)
    rng = np.random.default_rng(seed)
    flows = core.make_flows_single(n, tau=20 * core.US, nic=B,
                                   sizes=rng.uniform(8e4, 4e5, n),
                                   starts=rng.uniform(0.0, 1.5e-3, n),
                                   sim_dt=1e-6, **dev)
    sched = core.make_schedule(flows)
    cfg = core.SimConfig(dt=1e-6, steps=steps, hist=256)
    return topo, sched, cfg


def _lcfg(core, sched, **dev):
    """The paper default at 8 expected flows, with a circuit schedule
    (which reTCP reads and the other laws ignore)."""
    sp = core.CircuitSchedule(day=50 * core.US, night=10 * core.US,
                              matchings=4).params(*dev.values())
    return core.default_law_config(core.schedule_as_flows(sched),
                                   expected_flows=8.0, sched=sp)


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def assert_bitmatch_repro(got, want, what):
    """``test_shard_scenario._assert_bitmatch``: the port's (state, record)
    against ``repro``'s."""
    (st, rec), (jst, jrec) = got, want
    for f in ("q", "lam_f", "w_sum", "n_active"):
        np.testing.assert_array_equal(_host(getattr(rec, f)),
                                      np.asarray(getattr(jrec, f)),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(_host(st.fct), np.asarray(jst.fct),
                                  err_msg=f"{what}: fct")
    np.testing.assert_array_equal(_host(st.w), np.asarray(jst.w),
                                  err_msg=f"{what}: w")


def assert_same_run(got, want, what):
    """Leaf for leaf (every state leaf but the reference engine's gather
    table, every record field), bit for bit, NaN equal to NaN."""
    def walk(a, b, name):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor), name
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"{what} {name}: {m}")
        elif isinstance(b, tuple):
            for f, x, y in zip(getattr(b, "_fields", range(len(b))), a, b):
                if f not in ("inv", "incidence"):
                    walk(x, y, f"{name}.{f}")
        elif isinstance(b, (int, np.integer)):
            assert int(a) == int(b), name
    walk(got[0], want[0], "state")
    walk(got[1], want[1], "record")


@pytest.mark.parametrize("law", sorted(__import__(
    "repro_torch.core", fromlist=["LAWS"]).LAWS))
def test_sharded_bitmatches_repro_1rank(law):
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    topo, sched, cfg = _scenario(tc, device="cpu")
    jtopo, jsched, jcfg = _scenario(jcore)
    want = jcore.simulate_slots(jtopo, jsched, law, 12, _lcfg(jcore, jsched),
                                jcfg)
    got = tc.simulate_slots_sharded(topo, sched, law, 12,
                                    _lcfg(tc, sched, device="cpu"), cfg,
                                    device="cpu")
    assert_bitmatch_repro(got, want, law)
    assert int(torch.isfinite(got[0].fct).sum()) == 12


def test_sharded_equals_port_slot_engine_both_layouts():
    """The replicated layout (the bottleneck, S * H = 12) and the CSR one
    (the paper leaf-spine's impaired anchor, S * H = 280, its first 600
    ticks): every leaf of the state and every record field is the port's
    reference slot engine's."""
    import repro_torch.core as tc
    from repro_torch.core.shardslots import LAST_SHARDED
    topo, sched, cfg = _scenario(tc, device="cpu")
    lcfg = _lcfg(tc, sched, device="cpu")
    for law in ("powertcp", "pulser"):
        assert_same_run(
            tc.simulate_slots_sharded(topo, sched, law, 12, lcfg, cfg,
                                      device="cpu"),
            tc.simulate_slots(topo, sched, law, 12, lcfg, cfg,
                              device="cpu"), f"bottleneck {law}")
        assert not LAST_SHARDED["geometry"]["use_csr"]
    ptopo, psched, pcfg, pS, preg = sup.impair_paper_scenario(
        tc, device="cpu")
    pcfg = pcfg._replace(steps=600)
    plcfg = tc.default_law_config(tc.schedule_as_flows(psched),
                                  expected_flows=8.0)
    assert_same_run(
        tc.simulate_slots_sharded(ptopo, psched, "backpressure", pS, plcfg,
                                  pcfg, impair=preg, device="cpu"),
        tc.simulate_slots(ptopo, psched, "backpressure", pS, plcfg, pcfg,
                          impair=preg, device="cpu"), "leaf-spine mixed")
    assert LAST_SHARDED["geometry"]["use_csr"]
    assert LAST_SHARDED["rebuilds"] > 0


def test_sharded_bounded_pool_with_chunk_1rank():
    """A bounded pool (S = 8 < N = 12) streamed in chunks of 9, bit for
    bit ``repro``'s unchunked slot engine and the port's."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    from repro_torch.core.shardslots import LAST_SHARDED
    topo, sched, cfg = _scenario(tc, device="cpu")
    jtopo, jsched, jcfg = _scenario(jcore)
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)
    jlcfg = jcore.default_law_config(jcore.schedule_as_flows(jsched),
                                     expected_flows=8.0)
    got = tc.simulate_slots_sharded(topo, sched, "powertcp", 8, lcfg, cfg,
                                    chunk=9, device="cpu")
    assert LAST_SHARDED["segments"] > 1
    assert_bitmatch_repro(got, jcore.simulate_slots(
        jtopo, jsched, "powertcp", 8, jlcfg, jcfg), "bounded chunk 9")
    assert_same_run(got, tc.simulate_slots(topo, sched, "powertcp", 8, lcfg,
                                           cfg, device="cpu"),
                    "bounded chunk 9")


def test_sharded_rejections():
    import repro_torch.core as tc
    from repro_torch.core.shardcomm import ShardGroup
    topo, sched, _ = _scenario(tc, device="cpu")
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)
    cfg = tc.SimConfig(dt=1e-6, steps=512, hist=256, record_every=8)
    with pytest.raises(ValueError, match="record_every"):
        tc.simulate_slots_sharded(topo, sched, "powertcp", 12, lcfg, cfg,
                                  device="cpu")
    # the pool must split evenly over the ranks (checked before any
    # collective, so a three-rank group description is enough)
    three = ShardGroup(0, 3, "cpu", backend="gloo")
    with pytest.raises(ValueError, match="must divide"):
        tc.simulate_slots_sharded(topo, sched, "powertcp", 8, lcfg,
                                  cfg._replace(record_every=1), group=three,
                                  device="cpu")
    with pytest.raises(ValueError, match="process group"):
        tc.simulate_slots_sharded(topo, sched, "powertcp", 12, lcfg,
                                  cfg._replace(record_every=1), devices=2,
                                  group=three, device="cpu")
    flows = tc.schedule_as_flows(sched)
    for spec, match in (
            (tc.SweepSpec(laws=["powertcp"], flows=[flows]), "slot spec"),
            (tc.SweepSpec(laws=["powertcp"], flows=[flows], slots=12,
                          backend="megakernel"), "reference backend"),
            (tc.SweepSpec(laws=["powertcp"], flows=[flows], slots=12,
                          schedules=[tc.CircuitSchedule(
                              day=50e-6, night=10e-6, matchings=2)]),
             "schedule axis")):
        with pytest.raises(ValueError, match=match):
            tc.run_sweep(spec, topo, cfg, shard_scenario=True, device="cpu")


def test_sweep_shard_scenario_matches_batched_slots():
    """``run_sweep(..., shard_scenario=True)`` point for point the batched
    slot path (``test_shard_scenario``'s: two laws, 10 flows, 10 slots,
    1 500 ticks)."""
    import repro_torch.core as tc
    topo, sched, cfg = _scenario(tc, n=10, steps=1500, device="cpu")
    spec = tc.SweepSpec(laws=["powertcp", "hpcc"],
                        flows=[tc.schedule_as_flows(sched)], slots=10,
                        expected_flows=8.0)
    base = tc.run_sweep(spec, topo, cfg, record=False, device="cpu")
    shd = tc.run_sweep(spec, topo, cfg, record=False, shard_scenario=True,
                       device="cpu")
    assert base.points == shd.points
    for li in base.states:
        torch.testing.assert_close(shd.states[li].fct, base.states[li].fct,
                                   rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(shd.states[li].w, base.states[li].w,
                                   rtol=0, atol=0)


def _boom_update(*args):
    raise RuntimeError("boom")


def test_sweep_shard_scenario_ladder_matches_repro():
    """A sharded point whose law raises: retried (a ``RuntimeError`` is
    transient), then recorded as ``PointFailure(..., "sharded", "run",
    ...)`` with the attempts ``repro`` counts, no fallback, and the other
    point's row kept, as ``repro``'s ladder does."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    rows = {}
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        topo, sched, cfg = _scenario(core, n=6, steps=300, **dev)
        boom = core.Law("boom", core.LAWS["powertcp"].init, _boom_update)
        spec = core.SweepSpec(laws=[boom, "powertcp"],
                              flows=[core.schedule_as_flows(sched)],
                              slots=6, expected_flows=8.0)
        res = core.run_sweep(spec, topo, cfg, record=False,
                             shard_scenario=True, fault_tolerant=True,
                             retries=1, backoff_s=0.0, **dev)
        rows[core.__name__] = (
            [(f.index, f.law, f.backend, f.stage, f.attempts)
             for f in res.failures], list(res.fallbacks),
            _host(res.state(1).fct))
    (jf, jfb, jfct), (tf, tfb, tfct) = rows["repro.core"], \
        rows["repro_torch.core"]
    assert tf == jf == [(0, "boom", "sharded", "run", 2)]
    assert tfb == jfb == []
    np.testing.assert_array_equal(tfct, np.asarray(jfct))


def test_sharded_seams_lifted():
    """``test_faults.py``'s sharded seams: the engine accepts a regime
    (the zero preset is bit for bit the unimpaired run) and the feedback
    laws (a hop-clock law bit for bit the unsharded slot engine), on its
    14-flow bottleneck (16 slots, 1 500 ticks)."""
    import repro_torch.core as tc
    topo = tc.single_bottleneck(bandwidth=100 * tc.GBPS, buffer=16e6,
                                device="cpu")
    rng = np.random.default_rng(3)
    flows = tc.make_flows_single(14, tau=20 * tc.US, nic=100 * tc.GBPS,
                                 sizes=rng.uniform(6e4, 2e5, 14),
                                 starts=rng.uniform(0.0, 0.8e-3, 14),
                                 sim_dt=1e-6, device="cpu")
    sched = tc.make_schedule(flows)
    cfg = tc.SimConfig(dt=1e-6, steps=1500, hist=256)
    lcfg = tc.default_law_config(flows)
    st_b, _ = tc.simulate_slots_sharded(topo, sched, "powertcp", 16, lcfg,
                                        cfg, record=False, device="cpu")
    st_z, _ = tc.simulate_slots_sharded(topo, sched, "powertcp", 16, lcfg,
                                        cfg, record=False,
                                        impair=tc.no_impairment(topo),
                                        device="cpu")
    torch.testing.assert_close(st_z.fct, st_b.fct, rtol=0, atol=0,
                               equal_nan=True)
    st_r, _ = tc.simulate_slots(topo, sched, "fncc", 16, lcfg, cfg,
                                record=False, device="cpu")
    st_s, _ = tc.simulate_slots_sharded(topo, sched, "fncc", 16, lcfg, cfg,
                                        record=False, device="cpu")
    torch.testing.assert_close(st_s.fct, st_r.fct, rtol=0, atol=0,
                               equal_nan=True)
