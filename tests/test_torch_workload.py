"""The port's traffic generators and Fig. 4's incast against ``repro`` on
the CPU.

* ``permutation_traffic`` (``cross_rack_only`` on and off),
  ``incast_flows`` (``long_flow`` on and off; a ``fan_in`` beyond the
  other groups' hosts, drawn with replacement), ``all_to_all_flows``
  (``stagger`` 0 and > 0) and ``synthetic_incast_workload``: every
  ``Flows`` leaf exactly ``repro``'s, on the 64-host ``LeafSpine()``, the
  paper's 256-host leaf-spine, the routing compiler's
  ``leaf_spine_fabric()`` and ``fat_tree(4)`` (the all-to-all matrix only
  on the small ones, as its docstring asks), with more seeds drawn by
  ``hypothesis``;
* Fig. 4's 10:1 and 63:1 incasts (``fig4_incast.run``'s setup, both
  fan-ins one batch) through the port's slot engine (a slot per flow)
  and its megakernel backend's plain tick, each bit for bit ``repro``'s
  padded ``simulate_batch`` over 2 000 ticks for ``powertcp`` and
  ``hpcc``: every ``Record`` field, the FCTs NaN for NaN;
* the goldens of ``chip_smoke.py`` phase 6i (``torch_port_fig4.json``,
  ``torch_port_generators.json``) load, their schedule checksums are the
  port's builds, and Fig. 4's metrics and verdict recomputed from the
  stored traces are the stored ones.

Regenerate the goldens (``repro`` on the CPU, ~3 min):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_workload.py
"""
import base64
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import test_torch_support as sup

import repro_torch.core as tc

jcore, _ = sup.import_repro()

DT = 1e-6
FIG4_CHECK_STEPS = 2000


def _eq_flows(got, want, what=""):
    for f in want._fields:
        g = getattr(got, f).cpu().numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f"{what}{f}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{f}")


def _fabric(core, name):
    if name == "leaf_spine":
        return core.LeafSpine()
    if name == "paper":
        return core.LeafSpine(**sup.PAPER)
    if name == "compiled":
        return core.compile_routes(core.leaf_spine_fabric())
    if name == "small":
        return core.LeafSpine(racks=2, hosts_per_rack=4, spines=1)
    if name == "mid":
        return core.LeafSpine(racks=4, hosts_per_rack=8, spines=1)
    return core.fat_tree(4)


FABRICS = ("leaf_spine", "paper", "compiled", "fat_tree")


@pytest.mark.parametrize("cross", (True, False))
@pytest.mark.parametrize("fabric", FABRICS)
def test_permutation_traffic_matches_repro(fabric, cross):
    ft, fj = _fabric(tc, fabric), _fabric(jcore, fabric)
    for seed in (0, 3):
        got = tc.permutation_traffic(ft, 0.5, 2e-3, DT, seed=seed,
                                     cross_rack_only=cross, device="cpu")
        want = jcore.permutation_traffic(fj, 0.5, 2e-3, DT, seed=seed,
                                         cross_rack_only=cross)
        _eq_flows(got, want, f"seed {seed}: ")


@pytest.mark.parametrize("long_flow", (True, False))
@pytest.mark.parametrize("fabric", FABRICS)
def test_incast_flows_matches_repro(fabric, long_flow):
    ft, fj = _fabric(tc, fabric), _fabric(jcore, fabric)
    grp = np.asarray(fj.host_group())
    for victim, fan_in in ((0, 6), (3, 40)):
        others = int((grp != grp[victim]).sum())
        # a fan-in beyond the other groups' hosts draws with replacement
        for fan in (fan_in, others + 5):
            got, bq = tc.incast_flows(ft, fan, 2e5, DT, victim=victim,
                                      long_flow=long_flow, seed=victim,
                                      device="cpu")
            want, wbq = jcore.incast_flows(fj, fan, 2e5, DT, victim=victim,
                                           long_flow=long_flow, seed=victim)
            assert bq == wbq
            _eq_flows(got, want, f"victim {victim} fan-in {fan}: ")
            if long_flow:
                assert float(got.start[0]) == -1.0
                assert float(got.size[0]) == float("inf")


@pytest.mark.parametrize("stagger", (0.0, 1e-4))
@pytest.mark.parametrize("fabric", ("small", "fat_tree"))
def test_all_to_all_flows_matches_repro(fabric, stagger):
    ft, fj = _fabric(tc, fabric), _fabric(jcore, fabric)
    got = tc.all_to_all_flows(ft, 1e4, DT, stagger=stagger, seed=2,
                              device="cpu")
    want = jcore.all_to_all_flows(fj, 1e4, DT, stagger=stagger, seed=2)
    _eq_flows(got, want)
    assert int(got.tau.shape[0]) == ft.n_hosts * (ft.n_hosts - 1)


@pytest.mark.parametrize("fabric", FABRICS)
def test_synthetic_incast_workload_matches_repro(fabric):
    ft, fj = _fabric(tc, fabric), _fabric(jcore, fabric)
    if fabric == "fat_tree":
        # 12 hosts outside a k = 4 edge group: 16 distinct responders
        # cannot be drawn, in either package
        with pytest.raises(ValueError, match="larger sample"):
            jcore.synthetic_incast_workload(fj, 5e3, 1e6, 2e-3, DT, seed=4)
        with pytest.raises(ValueError, match="larger sample"):
            tc.synthetic_incast_workload(ft, 5e3, 1e6, 2e-3, DT, seed=4,
                                         device="cpu")
        return
    got = tc.synthetic_incast_workload(ft, 5e3, 1e6, 2e-3, DT, seed=4,
                                       device="cpu")
    want = jcore.synthetic_incast_workload(fj, 5e3, 1e6, 2e-3, DT, seed=4)
    _eq_flows(got, want)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), fan=st.integers(1, 40),
       load=st.floats(0.05, 0.9), cross=st.booleans())
def test_generators_match_repro_over_seeds(seed, fan, load, cross):
    ft, fj = _fabric(tc, "mid"), _fabric(jcore, "mid")
    _eq_flows(tc.permutation_traffic(ft, load, 1e-3, DT, seed=seed,
                                     cross_rack_only=cross, device="cpu"),
              jcore.permutation_traffic(fj, load, 1e-3, DT, seed=seed,
                                        cross_rack_only=cross))
    _eq_flows(tc.incast_flows(ft, fan, 1e5, DT, victim=seed % 32,
                              long_flow=cross, seed=seed, device="cpu")[0],
              jcore.incast_flows(fj, fan, 1e5, DT, victim=seed % 32,
                                 long_flow=cross, seed=seed)[0])
    _eq_flows(tc.synthetic_incast_workload(ft, 2e3, 5e5, 1e-3, DT,
                                           seed=seed, device="cpu"),
              jcore.synthetic_incast_workload(fj, 2e3, 5e5, 1e-3, DT,
                                              seed=seed))


# -- Fig. 4 through the port's engines against repro's padded runs -----------

@pytest.fixture(scope="module")
def fig4():
    _, topo, flows, bq, cfg = sup.fig4_scenario(jcore,
                                                steps=FIG4_CHECK_STEPS)
    fb = jcore.stack_flows(flows, topo.num_queues)
    runs = {law: jcore.simulate_batch(
        topo, fb, law, cfg=cfg, expected_flows=sup.FIG4_EXPECTED_FLOWS)
        for law in ("powertcp", "hpcc")}
    return runs


@pytest.mark.parametrize("backend", ("reference", "megakernel"))
@pytest.mark.parametrize("law", ("powertcp", "hpcc"))
def test_fig4_slot_engine_matches_repro_padded(fig4, law, backend):
    fab, topo, flows, bq, cfg = sup.fig4_scenario(
        tc, steps=FIG4_CHECK_STEPS, device="cpu")
    scheds = [tc.make_schedule(f) for f in flows]
    sb = tc.stack_flow_schedules(scheds, topo.num_queues)
    n = int(sb.start.shape[-1])
    st, rec = tc.simulate_slots_batch(
        topo, sb, law, n, cfg=cfg, backend=backend,
        expected_flows=sup.FIG4_EXPECTED_FLOWS, device="cpu")
    wst, wrec = fig4[law]
    for f in wrec._fields:
        np.testing.assert_array_equal(getattr(rec, f).cpu().numpy(),
                                      np.asarray(getattr(wrec, f)),
                                      err_msg=f"{law} {backend} rec.{f}")
    # the schedules keep the incasts' flow order (the long flow first)
    np.testing.assert_array_equal(st.fct.cpu().numpy(), np.asarray(wst.fct))
    assert int(np.isfinite(np.asarray(wst.fct)).sum()) > 0


# -- the goldens of chip_smoke.py phase 6i ------------------------------------

def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(
        np.asarray(a, np.float32)).tobytes()).decode()


def _unb64(s) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), np.float32)


def _f32(a):
    return [None if not np.isfinite(x) else float(x)
            for x in np.asarray(a, np.float32)]


def _checksum(flows):
    return sup.schedule_checksum(np.asarray(flows.size.cpu() if isinstance(
        flows.size, torch.Tensor) else flows.size), np.asarray(
        flows.start.cpu() if isinstance(flows.start, torch.Tensor)
        else flows.start))


def test_fig4_golden_loads_and_holds():
    with open(sup.FIG4_REF) as f:
        ref = json.load(f)
    fab, topo, flows, bq, cfg = sup.fig4_scenario(tc, device="cpu")
    assert ref["scenario"]["bq"] == bq
    assert ref["scenario"]["steps"] == cfg.steps == sup.FIG4_STEPS
    for fan, fl in zip(sup.FIG4_FANS, flows):
        assert ref["scenario"][f"checksum_{fan}"] == _checksum(fl)
    bdp = sup.fig4_bdp(fab)
    res = {fan: {} for fan in sup.FIG4_FANS}
    for law in sup.FIG4_LAWS:
        for fan, fl in zip(sup.FIG4_FANS, flows):
            leg = ref["laws"][law][str(fan)]
            q, thru = _unb64(leg["q"]), _unb64(leg["thru"])
            assert q.shape == thru.shape == (sup.FIG4_STEPS,)
            fct = np.array([np.nan if x is None else x
                            for x in leg["fct_s"]], np.float32)
            m = sup.fig4_metrics(fl.size.numpy(), fct, q,
                                 thru / fab.host_bw, cfg.steps, cfg.dt, bdp)
            assert m == leg["metrics"], (law, fan)
            res[fan][law] = m
    assert sup.fig4_claims(res[10], res[63], fab) == ref["claims_hold"]
    homa = ref["homa"]
    assert homa["fig4_10"]["steps"] == sup.HOMA_FIG4_STEPS
    assert homa["ws"]["steps"] == sup.HOMA_WS_STEPS
    _, _, wfl, _ = sup.homa_ws_scenario(tc, device="cpu")
    assert homa["ws"]["checksum"] == _checksum(wfl)


def test_generators_golden_loads():
    with open(sup.GENERATORS_REF) as f:
        ref = json.load(f)
    for leg in sup.GEN_LEGS:
        topo, sched, cfg, slots = sup.generator_scenario(tc, leg,
                                                         device="cpu")
        r = ref[leg]
        assert r["checksum"] == _checksum(sched)
        assert (r["slots"], r["steps"], r["n_flows"]) == (
            slots, cfg.steps, int(sched.start.shape[0]))
        assert len(r["fct_s"]) == r["n_flows"]
        assert r["completed"] == sum(x is not None for x in r["fct_s"]) > 0


def write_fig4_golden():
    """``repro``'s padded ``simulate_batch`` of Fig. 4's two incasts for
    the five window laws (every FCT, the victim queue's depth and
    throughput traces, ``_metrics``' four values per fan-in, the verdict),
    and its HOMA runs (``run_law``'s allocator on ``reno``) of Fig. 4's
    10:1 incast (padded to the 63:1's 64 flows, as ``run_law`` pads it)
    and of Fig. 6's web-search leg (seed 1), cut to their first ticks:
    FCTs and queue traces."""
    fab, topo, flows, bq, cfg = sup.fig4_scenario(jcore)
    fb = jcore.stack_flows(flows, topo.num_queues)
    bdp = sup.fig4_bdp(fab)
    laws, res = {}, {fan: {} for fan in sup.FIG4_FANS}
    for law in sup.FIG4_LAWS:
        st, rec = jcore.simulate_batch(
            topo, fb, law, cfg=cfg, expected_flows=sup.FIG4_EXPECTED_FLOWS)
        laws[law] = {}
        for i, (fan, fl) in enumerate(zip(sup.FIG4_FANS, flows)):
            q = np.asarray(rec.q[i][:, bq])
            thru = np.asarray(rec.thru[i][:, bq])
            fct = np.asarray(st.fct[i])
            m = sup.fig4_metrics(np.asarray(fl.size), fct, q,
                                 thru / fab.host_bw, cfg.steps, cfg.dt, bdp)
            res[fan][law] = m
            laws[law][str(fan)] = dict(fct_s=_f32(fct), q=_b64(q),
                                       thru=_b64(thru), metrics=m)
    n = int(fb.tau.shape[1])
    hfl, alloc, lcfg = sup.homa_run_args(jcore, fab, flows[0], pad_to=n,
                                         expected_flows=16.0)
    hcfg = cfg._replace(steps=sup.HOMA_FIG4_STEPS)
    st, rec = jcore.simulate(topo, hfl, "reno", lcfg, hcfg, alloc_fn=alloc)
    homa = dict(fig4_10=dict(
        steps=hcfg.steps, fct_s=_f32(st.fct), q=_b64(np.asarray(rec.q)[:, bq]),
        thru=_b64(np.asarray(rec.thru)[:, bq]),
        w_sum=_b64(rec.w_sum), n_active=np.asarray(rec.n_active).tolist()))
    wfab, wtopo, wfl, wcfg = sup.homa_ws_scenario(jcore)
    wfl_, walloc, wlcfg = sup.homa_run_args(jcore, wfab, wfl)
    st, rec = jcore.simulate(wtopo, wfl_, "reno", wlcfg, wcfg,
                             alloc_fn=walloc)
    homa["ws"] = dict(steps=wcfg.steps, n_flows=int(wfl.tau.shape[0]),
                      checksum=_checksum(wfl), fct_s=_f32(st.fct),
                      q=_b64(np.asarray(rec.q)), w_sum=_b64(rec.w_sum))
    out = dict(
        scenario=dict(bq=int(bq), steps=cfg.steps, hist=cfg.hist,
                      update_period=cfg.update_period,
                      expected_flows=sup.FIG4_EXPECTED_FLOWS,
                      **{f"checksum_{fan}": _checksum(fl)
                         for fan, fl in zip(sup.FIG4_FANS, flows)}),
        source="benchmarks/fig4_incast.py::run (quick=False) and "
               "benchmarks/common.py::run_law(law='homa'); "
               "benchmarks/fig6_fct.py::run_load(0.6) HOMA, seed 1",
        laws=laws, claims_hold=sup.fig4_claims(res[10], res[63], fab),
        homa=homa)
    with open(sup.FIG4_REF, "w") as f:
        json.dump(out, f)
    return out


def write_generators_golden():
    """``repro``'s slot-engine runs (``powertcp``, no records) of the three
    generator legs of ``test_torch_support.generator_scenario``: the
    FCTs in schedule order."""
    out = {}
    for leg in sup.GEN_LEGS:
        topo, sched, cfg, slots = sup.generator_scenario(jcore, leg)
        lcfg = jcore.default_law_config(jcore.schedule_as_flows(sched),
                                        expected_flows=sup.GEN_EXPECTED_FLOWS)
        st, _ = jcore.simulate_slots(topo, sched, sup.GEN_LAW, slots, lcfg,
                                     cfg, record=False)
        fct = np.asarray(st.fct)
        out[leg] = dict(checksum=_checksum(sched), slots=slots,
                        steps=cfg.steps, n_flows=int(sched.start.shape[0]),
                        law=sup.GEN_LAW,
                        completed=int(np.isfinite(fct).sum()),
                        fct_s=_f32(fct))
    with open(sup.GENERATORS_REF, "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    import sys
    which = sys.argv[1:] or ["fig4", "generators"]
    if "fig4" in which:
        o = write_fig4_golden()
        print(sup.FIG4_REF, o["claims_hold"],
              {law: o["laws"][law]["10"]["metrics"] for law in o["laws"]})
    if "generators" in which:
        o = write_generators_golden()
        print(sup.GENERATORS_REF, {k: (v["n_flows"], v["slots"],
                                       v["completed"]) for k, v in o.items()})
