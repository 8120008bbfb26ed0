"""The port's engines under per-link impairments against ``repro``'s, on
the CPU (``tests/test_impair.py``'s anchor, cut to ``ANCHOR_STEPS``
ticks).

* ``check_three_engines``: for a law, the port's padded reference, slot
  reference (S = N + 4, and a recycled pool of 10) and plain megakernel
  tick on the k = 4 fat-tree web-search anchor under the mixed regime
  (oscillating ToR -> host capacity, 1% random loss and 1 us jitter
  elsewhere), each bit for bit ``repro``'s run of the same engine and
  one another. The laws are split over this file (PowerTCP),
  ``test_torch_impair_classic.py``, ``test_torch_impair_rate.py``,
  ``test_torch_impair_marking.py`` and ``test_torch_impair_feedback.py``,
  so that each file stays near a minute;
* ``no_impairment`` bitwise the clean run on every engine;
* a batch of two regimes (``stack_impairments``) against ``repro``'s
  batched runs, padded and slot, lockstep and sequential, and the
  megakernel's plain tick; a shared [Q] regime as its stacked copies;
* K4's inputs for a regime (``megakernel._k4_impair``) and its layout,
  checked without a card.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_support as sup  # noqa: E402

ANCHOR_STEPS = 1000
ANCHOR_DT = 1e-6


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def anchor(core, fabric, steps=ANCHOR_STEPS, **dev):
    """(topo, schedule, cfg, mixed regime, law config) of
    ``tests/test_impair.py::_anchor`` in either package (``fabric`` the
    package's fabric module, for the tier labels); the config carries
    the 4-matching schedule reTCP reads."""
    ft = core.fat_tree(4)
    flows = core.poisson_websearch(ft, 0.25, 0.002, ANCHOR_DT, seed=3, **dev)
    sched = core.make_schedule(flows)
    cfg = core.SimConfig(dt=ANCHOR_DT, steps=steps, hist=512,
                         update_period=2e-6)
    imp = core.fabric_impairments(
        ft, rules={(fabric.TOR, fabric.HOST): core.LinkProcess(
            kind="oscillate", bw_lo=2.5e9, period=200e-6, seed=5)},
        default=core.netem(loss=0.01, jitter=1e-6, seed=9), **dev)
    sp = core.CircuitSchedule(day=50e-6, night=10e-6, matchings=4).params(
        **dev)
    lcfg = core.default_law_config(core.schedule_as_flows(sched),
                                   expected_flows=8.0, sched=sp)
    return ft.topology(**dev), sched, cfg, imp, lcfg


def runs_equal(got, want, what, fields=None, min_done=0):
    """Every ``Record`` field (or ``fields``) and the FCTs bit for bit."""
    (sg, rg), (sw, rw) = got, want
    fw = _host(sw.fct)
    assert np.isfinite(fw).sum() >= min_done, f"{what}: too few complete"
    np.testing.assert_array_equal(_host(sg.fct), fw, err_msg=f"{what}: fct")
    if rw is None:
        return
    for f in fields or rw._fields:
        np.testing.assert_array_equal(_host(getattr(rg, f)),
                                      _host(getattr(rw, f)),
                                      err_msg=f"{what}: rec.{f}")


def check_three_engines(law):
    """``repro``'s padded, slot (S = N + 4) and recycled slot (S = 10)
    runs of the impaired anchor against the port's padded, slot and
    plain megakernel runs (S = N + 4 and 10), bit for bit; within the
    port, slot == padded (queue trace, FCTs, the admitted flows'
    windows) and megakernel == slot."""
    jcore, _ = sup.import_repro()
    from repro.core import fabric as jfab
    import repro_torch.core as tc
    from repro_torch.core import fabric as tfab
    out = {}
    for core, fab, dev in ((jcore, jfab, {}), (tc, tfab, {"device": "cpu"})):
        topo, sched, cfg, imp, lcfg = anchor(core, fab, **dev)
        n = int(sched.start.shape[0])
        fl = core.schedule_as_flows(sched)
        r = out[core] = {
            "padded": core.simulate(topo, fl, law, lcfg, cfg, impair=imp,
                                    **dev),
            "slot": core.simulate_slots(topo, sched, law, n + 4, lcfg, cfg,
                                        impair=imp, **dev),
            "slot10": core.simulate_slots(topo, sched, law, 10, lcfg, cfg,
                                          record=False, impair=imp, **dev)}
        if core is tc:
            r["mega"] = core.simulate_slots(topo, sched, law, n + 4, lcfg,
                                            cfg, backend="megakernel",
                                            impair=imp, **dev)
            r["mega10"] = core.simulate_slots(
                topo, sched, law, 10, lcfg, cfg, record=False,
                backend="megakernel", impair=imp, **dev)
    j, t = out[jcore], out[tc]
    runs_equal(t["padded"], j["padded"], f"{law} padded", min_done=5)
    runs_equal(t["slot"], j["slot"], f"{law} slot")
    runs_equal(t["mega"], j["slot"], f"{law} megakernel")
    runs_equal(t["slot10"], j["slot10"], f"{law} slot S=10")
    runs_equal(t["mega10"], j["slot10"], f"{law} megakernel S=10")
    runs_equal(t["slot"], t["padded"], f"{law} slot == padded",
               fields=("q",))
    # the windows of the flows admitted by the end (a slot not yet
    # holding its flow keeps the pool's initial window)
    k = int(t["slot"][0].cursor)
    assert k >= 5
    np.testing.assert_array_equal(_host(t["slot"][0].w[:k]),
                                  _host(t["padded"][0].w[:k]))


@pytest.mark.parametrize("law", ["powertcp"])
def test_three_engines_bitmatch_impaired(law):
    check_three_engines(law)


def test_no_impairment_is_the_clean_run():
    """``no_impairment`` (keep 1.0, jitter +0.0, the topology's rates) is
    bitwise the unimpaired run on the padded, slot and megakernel
    engines, every record field and the FCTs."""
    import repro_torch.core as tc
    from repro_torch.core import fabric as tfab
    topo, sched, cfg, _, lcfg = anchor(tc, tfab, steps=600, device="cpu")
    z = tc.no_impairment(topo)
    n = int(sched.start.shape[0])
    fl = tc.schedule_as_flows(sched)
    for what, run in (
            ("padded", lambda **kw: tc.simulate(topo, fl, "powertcp", lcfg,
                                                cfg, device="cpu", **kw)),
            ("slot", lambda **kw: tc.simulate_slots(
                topo, sched, "powertcp", n, lcfg, cfg, device="cpu", **kw)),
            ("megakernel", lambda **kw: tc.simulate_slots(
                topo, sched, "powertcp", n, lcfg, cfg, device="cpu",
                backend="megakernel", **kw))):
        runs_equal(run(impair=z), run(), f"zero preset {what}", min_done=1)


def test_quiet_ticks_under_a_regime():
    """The plain megakernel tick's quiet form (every pool empty, nothing
    due: the drain and the window clamp, whose theta carries the jitter)
    gives the busy tick's bits under the mixed regime; the anchor's pool
    empties between arrivals."""
    import repro_torch.core as tc
    from repro_torch.core import fabric as tfab, fluid, megakernel as mk
    topo, sched, cfg, imp, _ = anchor(tc, tfab, steps=600, device="cpu")
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), "powertcp", 6,
                              None, cfg, "megakernel", "cpu", 8.0, imp)
    quiet = mk.simulate_slots_mega(sim, quiet=True)
    busy = mk.simulate_slots_mega(sim)
    runs_equal(quiet, busy, "quiet ticks", min_done=1)
    assert int((quiet[1].n_active == 0).sum()) > 0


def _batch(core, fab, regimes, **dev):
    """The anchor's schedule and a second seed's, stacked, with a law
    config each and the regimes of ``regimes`` (names of ``mixed``,
    ``oscillate``, ``zero``)."""
    topo, sched, cfg, mixed, _ = anchor(core, fab, steps=600, **dev)
    ft = core.fat_tree(4)
    s2 = core.make_schedule(core.poisson_websearch(ft, 0.25, 0.002,
                                                   ANCHOR_DT, seed=4, **dev))
    sb = core.stack_flow_schedules([sched, s2], topo.num_queues)
    osc = core.fabric_impairments(ft, rules={
        (fab.TOR, fab.HOST): core.LinkProcess(
            kind="fading", bw_lo=2.5e9, period=50e-6,
            seed=0xFFFFFFF0)}, **dev)
    named = {"mixed": mixed, "oscillate": osc,
             "zero": core.no_impairment(topo)}
    return topo, sb, cfg, core.stack_impairments(
        [named[r] for r in regimes])


def test_batch_of_two_regimes_matches_repro():
    """Two scenarios with a regime each (``impair_params`` of [2, Q]
    leaves) through ``simulate_slots_batch`` (lockstep and sequential)
    and ``simulate_batch``, against ``repro``'s batched runs bit for bit;
    the megakernel's plain tick against the port's slot run."""
    jcore, _ = sup.import_repro()
    from repro.core import fabric as jfab
    import repro_torch.core as tc
    from repro_torch.core import fabric as tfab
    out = {}
    for core, fab, dev in ((jcore, jfab, {}), (tc, tfab, {"device": "cpu"})):
        topo, sb, cfg, imps = _batch(core, fab, ("mixed", "oscillate"),
                                     **dev)
        n = int(sb.start.shape[-1])
        fb = core.stack_flows([core.schedule_as_flows(
            type(sb)(*[x[b] for x in sb])) for b in range(2)],
            topo.num_queues)
        out[core] = [
            core.simulate_slots_batch(topo, sb, "powertcp", n, cfg=cfg,
                                      expected_flows=8.0,
                                      impair_params=imps, **dev),
            core.simulate_batch(topo, fb, "powertcp", cfg=cfg,
                                expected_flows=8.0, impair_params=imps,
                                **dev)]
        if core is tc:
            out[core] += [
                core.simulate_slots_batch(
                    topo, sb, "powertcp", n, cfg=cfg, expected_flows=8.0,
                    impair_params=imps, sequential=True, **dev),
                core.simulate_slots_batch(
                    topo, sb, "powertcp", n, cfg=cfg, expected_flows=8.0,
                    impair_params=imps, backend="megakernel", **dev)]
    j, t = out[jcore], out[tc]
    runs_equal(t[0], j[0], "slot batch", min_done=4)
    runs_equal(t[1], j[1], "padded batch", min_done=4)
    runs_equal(t[2], j[0], "sequential slot batch")
    runs_equal(t[3], j[0], "megakernel batch")
    assert not np.array_equal(_host(t[0][1].q[0]), _host(t[0][1].q[1]))


def test_shared_regime_is_its_stacked_copies():
    """A [Q] regime shared by a batch gives each scenario the run of the
    regime stacked per scenario, on the slot and megakernel engines."""
    import repro_torch.core as tc
    from repro_torch.core import fabric as tfab
    topo, sb, cfg, imps = _batch(tc, tfab, ("mixed", "mixed"),
                                 device="cpu")
    one = tc.ImpairmentParams(*[x[0] for x in imps])
    n = int(sb.start.shape[-1])
    for backend in ("reference", "megakernel"):
        runs = [tc.simulate_slots_batch(topo, sb, "hpcc", n, cfg=cfg,
                                        expected_flows=8.0,
                                        impair_params=p, backend=backend,
                                        device="cpu") for p in (one, imps)]
        runs_equal(runs[0], runs[1], f"shared regime {backend}",
                   min_done=4)


def test_k4_inputs_for_a_regime():
    """``tick.k4_params().impair``: [10, Q] int32 for a shared regime,
    [B, 10, Q] for one per scenario, each row a field of
    ``ImpairmentParams`` in order (the floats as their bits, the seed as
    its uint32 bits); K4's layout gains ``keep`` and ``jit`` ((Q+1)
    floats each) and stays in shared memory at the paper fabric's shapes
    of phases 6c and 6f.4."""
    import repro_torch.core as tc
    from repro_torch.core import fabric as tfab, fluid, megakernel as mk
    from repro_torch.kernels import fused_tick as ft
    topo, sb, cfg, imps = _batch(tc, tfab, ("mixed", "oscillate"),
                                 device="cpu")
    Q = topo.num_queues
    for regime, lead in ((imps, (2,)),
                         (tc.ImpairmentParams(*[x[0] for x in imps]), ())):
        sim = fluid.make_slot_sim(topo, sb, "powertcp", 8, None, cfg,
                                  "megakernel", "cpu", 8.0, regime)
        p = mk.make_tick(sim).k4_params()
        assert p.impair.dtype == torch.int32
        assert tuple(p.impair.shape) == lead + (len(ft.IMPAIR_FIELDS), Q)
        assert ft.IMPAIR_FIELDS == list(tc.ImpairmentParams._fields)
        for i, f in enumerate(ft.IMPAIR_FIELDS):
            row, x = p.impair[..., i, :], getattr(regime, f)
            if x.dtype == torch.float32:
                assert torch.equal(row.view(torch.float32), x), f
            else:
                assert torch.equal(row.to(torch.int64) & 0xFFFFFFFF,
                                   x.to(torch.int64)), f
        if lead:
            assert int(p.impair[..., 9, :].min()) < 0   # a seed >= 2^31
    clean = mk.make_tick(fluid.make_slot_sim(topo, sb, "powertcp", 8, None,
                                             cfg, "megakernel", "cpu", 8.0))
    assert clean.k4_params().impair is None
    for shape in ((448, 3, 288, 10, 34, 10), (56, 3, 288, 10, 34, 10),
                  (37, 5, 80, 20, 4, 20)):
        for law in range(len(ft.LAW_NAMES)):
            a = ft.layout(*shape, law)
            b = ft.layout(*shape, law, impair=True)
            assert b.smem, (shape, law, b)
            assert b.nbytes - a.nbytes == 2 * (-(-4 * (shape[2] + 1) // 16)
                                               * 16)
            words = dict(ft._fields(*shape, law, True))
            assert words["keep"] == words["jit"] == shape[2] + 1


# -------------------------------------------------------------------------
# phase 6f's reference data
# -------------------------------------------------------------------------

def _scenario_meta(sched, cfg, slots):
    return {"n_flows": int(sched.start.shape[0]), "slots": int(slots),
            "steps": int(cfg.steps),
            "schedule_sha256": sup.schedule_checksum(
                np.asarray(_host(sched.size)), np.asarray(_host(sched.start)))}


def test_impair_reference_scenarios_are_the_ports():
    """``tests/golden/torch_port_impair.json`` was written for the
    scenarios the port builds: flow counts, pools, ticks and schedule
    checksums of the anchor and the paper fabric, and the regimes'
    names."""
    import json
    import repro_torch.core as tc
    with open(sup.IMPAIR_REF) as f:
        ref = json.load(f)
    topo, sched, cfg, slots, regimes = sup.impair_anchor_scenario(
        tc, device="cpu")
    assert ref["anchor"]["scenario"] == _scenario_meta(sched, cfg, slots)
    assert list(regimes) == list(sup.IMPAIR_REGIMES) == \
        list(ref["regimes"]["fct_s"])
    assert sorted(ref["anchor"]["fct_s"]) == sorted(sup.IMPAIR_LAWS)
    topo, sched, cfg, slots, _ = sup.impair_paper_scenario(tc, device="cpu")
    assert ref["paper"]["scenario"] == _scenario_meta(sched, cfg, slots)
    assert sorted(ref["paper"]["fct_s"]) == sorted(sup.IMPAIR_PAPER_LAWS)


def _f32_list(x):
    """float32 values as the shortest decimals that read back to them
    (None for a flow that did not complete)."""
    return [None if not np.isfinite(v) else float(str(v))
            for v in np.asarray(x, np.float32)]


def _write_impair_reference():
    """``repro``'s slot engine (``simulate_slots_batch``, backend
    ``"reference"``) on the CPU over phase 6f's scenarios: the anchor of
    ``impair_fct.smoke_impair`` under the mixed regime for
    ``IMPAIR_LAWS``, its four regimes as one batch for powertcp, and the
    paper fabric's impaired pass for ``IMPAIR_PAPER_LAWS``; written to
    tests/golden/torch_port_impair.json."""
    import json
    import time
    jcore, _ = sup.import_repro()

    def run(topo, scheds, law, slots, cfg, regimes):
        sb = jcore.stack_flow_schedules(scheds, topo.num_queues)
        st, _ = jcore.simulate_slots_batch(
            topo, sb, law, slots, cfg=cfg, record=False,
            backend="reference", expected_flows=sup.IMPAIR_EXPECTED_FLOWS,
            impair_params=jcore.stack_impairments(regimes))
        n = int(scheds[0].start.shape[0])
        return [_f32_list(np.asarray(st.fct[b], np.float32)[:n])
                for b in range(len(scheds))]

    data = {"source": "repro.core.simulate_slots_batch, backend="
                      "'reference', impair_params=stack_impairments(...), "
                      "on benchmarks/impair_fct.py::smoke_impair's anchor "
                      "and the impaired pass of "
                      "benchmarks/fabric_fct.py::_fabric16_anchor_bitmatch",
            "expected_flows": sup.IMPAIR_EXPECTED_FLOWS}
    topo, sched, cfg, slots, regimes = sup.impair_anchor_scenario(jcore)
    anchor = {"scenario": _scenario_meta(sched, cfg, slots), "fct_s": {}}
    for law in sup.IMPAIR_LAWS:
        t0 = time.time()
        anchor["fct_s"][law] = run(topo, [sched], law, slots, cfg,
                                   [regimes["mixed"]])[0]
        print(f"anchor {law} ({time.time() - t0:.1f} s)", flush=True)
    data["anchor"] = anchor
    t0 = time.time()
    fcts = run(topo, [sched] * len(sup.IMPAIR_REGIMES), "powertcp", slots,
               cfg, [regimes[r] for r in sup.IMPAIR_REGIMES])
    data["regimes"] = {"law": "powertcp",
                       "fct_s": dict(zip(sup.IMPAIR_REGIMES, fcts))}
    print(f"regimes ({time.time() - t0:.1f} s)", flush=True)
    topo, sched, cfg, slots, imp = sup.impair_paper_scenario(jcore)
    paper = {"scenario": _scenario_meta(sched, cfg, slots), "fct_s": {}}
    for law in sup.IMPAIR_PAPER_LAWS:
        t0 = time.time()
        paper["fct_s"][law] = run(topo, [sched], law, slots, cfg, [imp])[0]
        print(f"paper {law} ({time.time() - t0:.1f} s)", flush=True)
    data["paper"] = paper
    with open(sup.IMPAIR_REF, "w") as f:
        json.dump(data, f)
    print(f"wrote {sup.IMPAIR_REF}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    _write_impair_reference()
