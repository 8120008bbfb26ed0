"""The port's fault taxonomy, crash injection and divergence guards, on
the CPU.

Mirrors ``tests/test_faults.py`` (its sharded seams are held in
``test_torch_shard.py``):

* the taxonomy: ``UnsupportedFeature`` at every declared rejection seam,
  with a hint, still a ``NotImplementedError``; ``is_transient`` (a CUDA
  out-of-memory error is a ``RuntimeError``, so it is retried; a law
  without a K4 path stays a plain ``NotImplementedError``);
* the crash injectors and the tick and segment an ``InjectedCrash``
  carries;
* the guards: a poisoned law under ``guard=True`` raises
  ``DivergenceError`` with ``repro``'s law, tick and field; unguarded the
  NaN passes through; a clean run never trips; ``finite_flags`` names
  and flags the leaves of a carry as ``repro``'s does.
"""
import numpy as np
import pytest
import torch

import test_torch_support as sup


def _tc():
    import repro_torch.core as tc
    return tc


def _guard_scenario(core, **dev):
    return sup.bottleneck18(core, hist=512, **dev)


def test_unsupported_feature_moved_and_reexported():
    tc = _tc()
    from repro_torch.core import faults, fluid
    assert tc.UnsupportedFeature is faults.UnsupportedFeature
    assert fluid.UnsupportedFeature is faults.UnsupportedFeature
    assert issubclass(tc.UnsupportedFeature, NotImplementedError)


def test_fused_impair_seam_is_unsupported_feature_with_hint():
    tc = _tc()
    topo, sched, cfg = sup.bottleneck18(tc, steps=50, device="cpu")
    imp = tc.no_impairment(topo)
    with pytest.raises(tc.UnsupportedFeature, match="fused") as ei:
        tc.simulate(topo, tc.schedule_as_flows(sched), "powertcp", cfg=cfg,
                     backend="fused", impair=imp, device="cpu")
    assert ei.value.hint
    assert isinstance(ei.value, NotImplementedError)


def test_crash_injector_validation():
    tc = _tc()
    assert tc.crash_at_tick(5) == tc.FaultSpec(crash_tick=5)
    assert tc.crash_at_chunk(3) == tc.FaultSpec(crash_segment=3)
    with pytest.raises(ValueError):
        tc.crash_at_tick(0)
    with pytest.raises(ValueError):
        tc.crash_at_chunk(-1)


@pytest.mark.parametrize("backend", ["reference", "megakernel"])
def test_injected_crash_carries_tick_and_segment(backend):
    tc = _tc()
    topo, sched, cfg = sup.bottleneck18(tc, steps=800, device="cpu")
    with pytest.raises(tc.InjectedCrash) as ei:
        tc.simulate_slots(topo, sched, "powertcp", 8, cfg=cfg, chunk=8,
                          backend=backend, faults=tc.crash_at_tick(600),
                          device="cpu")
    assert ei.value.tick == 600
    assert ei.value.segment >= 1
    with pytest.raises(tc.InjectedCrash) as ei:
        tc.simulate_slots(topo, sched, "powertcp", 8, cfg=cfg, chunk=8,
                          backend=backend, faults=tc.crash_at_chunk(2),
                          device="cpu")
    assert ei.value.segment == 2


def test_is_transient_classification():
    tc = _tc()
    assert tc.is_transient(tc.TransientFault("allocator pressure"))
    assert tc.is_transient(RuntimeError("CUDA error: launch failure"))
    assert tc.is_transient(torch.cuda.OutOfMemoryError("out of memory"))
    assert not tc.is_transient(tc.UnsupportedFeature("nope"))
    assert not tc.is_transient(tc.InjectedCrash(5, 1))
    assert not tc.is_transient(tc.DivergenceError("l", 1, "w"))
    assert not tc.is_transient(ValueError("shape"))
    assert not tc.is_transient(TypeError("dtype"))
    # NotImplementedError is a RuntimeError: retried, as in repro (a law
    # without a K4 path then fails its point; it never falls back)
    assert tc.is_transient(NotImplementedError("no K4 path"))
    core, _ = sup.import_repro()
    for e in (RuntimeError("x"), NotImplementedError("x"), ValueError("x"),
              torch.cuda.OutOfMemoryError("x")):
        assert tc.is_transient(e) == core.is_transient(e), e


def test_poisoned_law_has_no_k4_path():
    """A wrapped law keeps raising ``NotImplementedError`` where K4 would
    take it (not ``UnsupportedFeature``: a sweep must not fall back)."""
    tc = _tc()
    from repro_torch.core import fluid, megakernel as mk
    topo, sched, cfg = sup.bottleneck18(tc, steps=50, device="cpu")
    bad = tc.poison_law("powertcp", at_t=1e-4)
    assert bad.name == "poisoned_powertcp"
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), bad, 8, cfg=cfg,
                              backend="megakernel", device="cpu")
    with pytest.raises(NotImplementedError) as ei:
        mk.make_tick(sim).k4_params()
    assert not isinstance(ei.value, tc.UnsupportedFeature)


@pytest.mark.parametrize("backend", ["reference", "megakernel"])
def test_poisoned_law_diagnosis_matches_repro(backend):
    """``fault_fct.guard_divergence``: the guarded run raises
    ``DivergenceError`` naming the law, the tick and the first non-finite
    field, each ``repro``'s (the golden of ``chip_smoke.py`` phase 6g
    holds them)."""
    import json
    tc = _tc()
    topo, sched, cfg = _guard_scenario(tc, device="cpu")
    bad = tc.poison_law("powertcp", at_t=sup.FAULT_GUARD_AT)
    with pytest.raises(tc.DivergenceError) as ei:
        tc.simulate_slots(topo, sched, bad, 8, cfg=cfg, chunk=8, guard=True,
                          backend=backend, device="cpu")
    e = ei.value
    with open(sup.FAULT_REF) as f:
        want = json.load(f)["guard"]
    assert dict(law=e.law, tick=e.tick, field=e.field) == want
    assert e.tick >= int(sup.FAULT_GUARD_AT / 1e-6)
    assert e.field in str(e) and "poisoned_powertcp" in str(e)
    if backend == "reference":
        core, _ = sup.import_repro()
        jtopo, jsched, jcfg = _guard_scenario(core)
        jbad = core.poison_law("powertcp", at_t=sup.FAULT_GUARD_AT)
        with pytest.raises(core.DivergenceError) as ej:
            core.simulate_slots(jtopo, jsched, jbad, 8, cfg=jcfg, chunk=8,
                                guard=True)
        assert (e.law, e.tick, e.field) == (ej.value.law, ej.value.tick,
                                            ej.value.field)


def test_unguarded_poison_passes_nan_through():
    """Without ``guard=True`` the NaN reaches the output, and the post-hoc
    form names it; ``repro``'s does the same on the same carry."""
    tc = _tc()
    topo, sched, cfg = _guard_scenario(tc, device="cpu")
    bad = tc.poison_law("powertcp", at_t=sup.FAULT_GUARD_AT)
    st, _ = tc.simulate_slots(topo, sched, bad, 8, cfg=cfg, chunk=8,
                              device="cpu")
    field = tc.first_divergent_field(st)
    assert field
    assert bool(torch.isnan(st.w).any() or torch.isnan(
        st.law.gamma_smooth).any())
    core, _ = sup.import_repro()
    jtopo, jsched, jcfg = _guard_scenario(core)
    jst, _ = core.simulate_slots(jtopo, jsched, core.poison_law(
        "powertcp", at_t=sup.FAULT_GUARD_AT), 8, cfg=jcfg, chunk=8)
    assert field == core.first_divergent_field(jst)


def test_clean_law_never_trips_guard():
    tc = _tc()
    topo, sched, cfg = sup.bottleneck18(tc, steps=800, device="cpu")
    st, _ = tc.simulate_slots(topo, sched, "powertcp", 8, cfg=cfg, chunk=8,
                              guard=True, device="cpu")
    assert tc.first_divergent_field(st) == ""


def test_finite_flags_policy_matches_repro():
    """``finite_flags`` checks the float leaves of a carry in field order
    with ``repro``'s policy: the names equal ``repro``'s on the same
    run's carry (the port's host counters, ``admitted`` and the gather
    table ``inv`` are skipped), and each flag follows its leaf."""
    tc = _tc()
    core, _ = sup.import_repro()
    topo, sched, cfg = sup.bottleneck18(tc, steps=300, device="cpu")
    st, _ = tc.simulate_slots(topo, sched, "hpcc", 8, cfg=cfg, device="cpu")
    jtopo, jsched, jcfg = sup.bottleneck18(core, steps=300)
    jst, _ = core.simulate_slots(jtopo, jsched, "hpcc", 8, cfg=jcfg)
    names, flags = tc.finite_flags(st)
    jnames, jflags = core.finite_flags(jst)
    assert names == [n.lstrip(".") for n in jnames]
    assert flags.tolist() == np.asarray(jflags).tolist()
    assert all(flags.tolist())
    # inf is legal in a sentinel and in law state, NaN is not; inf in a
    # window is not
    assert tc.first_divergent_field(st._replace(
        remaining=torch.full_like(st.remaining, float("inf")))) == ""
    assert tc.first_divergent_field(st._replace(
        remaining=torch.full_like(st.remaining, float("nan")))) == \
        "remaining"
    assert tc.first_divergent_field(st._replace(
        w=torch.full_like(st.w, float("inf")))) == "w"
    assert tc.first_divergent_field(st._replace(
        fct=torch.full_like(st.fct, float("nan")))) == ""
    with pytest.raises(tc.DivergenceError, match="by tick 7"):
        tc.check_divergence(st._replace(
            q=torch.full_like(st.q, float("nan"))), "hpcc", 7)
