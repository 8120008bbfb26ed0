"""Chunk-boundary checkpoints and bit-exact resume in the port, on the CPU.

Mirrors ``tests/test_resume.py`` (which does not collect on jax 0.9; its
runs here go through ``test_torch_support.import_repro``), on its 18-flow
single bottleneck with a pool of 8 slots, cut to 900 ticks:

* inject -> crash -> resume -> bit for bit, for every law of the registry
  (13), on the reference backend, and on the megakernel backend (its
  plain tick; K4 on the card in ``test_torch_cuda.py`` and
  ``chip_smoke.py`` phase 6g); each law's uninterrupted run is also
  ``repro``'s run of the same inputs, bit for bit;
* a crash on a checkpoint boundary, the cadence and the garbage
  collection, no snapshot, a scenario mismatch, a float64 leaf, the
  round trip of a carry and of a law config, the guard's bit-neutrality;
* the golden ``tests/golden/torch_port_fault.json`` (``repro``'s FCTs of
  ``fault_fct.crash_resume_paper_scale``'s scenario and its diagnosis of
  ``guard_divergence``, for ``chip_smoke.py`` phase 6g) loads, and its
  schedule checksum is the port's build of the scenario.

Regenerate the golden (``repro`` on the CPU, ~10 s):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_resume.py
"""
import json
import os

import numpy as np
import pytest
import torch

import test_torch_support as sup

S = 8
STEPS = 900
EVERY = 250
CRASH = 600


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _law_cfg(core, sched, dev):
    """``test_resume.py::_anchor_law_cfg``: the paper default with reTCP's
    circuit schedule (every law carries it; only reTCP reads it)."""
    sch = core.CircuitSchedule(day=50 * core.US, night=10 * core.US,
                               matchings=4)
    return core.default_law_config(core.schedule_as_flows(sched),
                                   expected_flows=8.0,
                                   sched=sch.params(**dev))


def _port(steps=STEPS):
    import repro_torch.core as tc
    topo, sched, cfg = sup.bottleneck18(tc, steps=steps, device="cpu")
    return tc, topo, sched, cfg, _law_cfg(tc, sched, {"device": "cpu"})


def _assert_resumed(got, want, what):
    bad = sup.resume_mismatches(got[0], got[1], want[0], want[1])
    assert not bad, f"{what}: {bad} differ"


def _crash_resume(tc, topo, sched, cfg, law, lcfg, path, backend, chunk,
                  every, fault):
    """Inject -> crash -> resume; returns (resumed, uninterrupted)."""
    ck = tc.CheckpointSpec(path=path, every=every, keep=2)
    single = tc.simulate_slots(topo, sched, law, S, lcfg, cfg,
                               backend=backend, device="cpu")
    with pytest.raises(tc.InjectedCrash):
        tc.simulate_slots(topo, sched, law, S, lcfg, cfg, backend=backend,
                          chunk=chunk, checkpoint=ck, faults=fault,
                          device="cpu")
    assert tc.latest_checkpoint(path) is not None
    resumed = tc.resume_slots(topo, sched, law, S, ck, law_cfg=lcfg,
                              cfg=cfg, backend=backend, chunk=chunk,
                              device="cpu")
    return resumed, single


LAWS = ("powertcp", "theta_powertcp", "hpcc", "swift", "gradient_mimd",
        "timely", "dcqcn", "reno", "retcp", "fncc", "pulser",
        "backpressure", "pcc")


def test_law_list_is_the_registry():
    import repro_torch.core as tc
    assert sorted(LAWS) == sorted(tc.LAWS)


@pytest.mark.parametrize("law", LAWS)
def test_crash_resume_bitmatch_every_law(law, tmp_path):
    """Every law of the registry: a run crashed at tick 600 and resumed
    from its snapshot at 500 is bit for bit the uninterrupted run, which
    is ``repro``'s run of the same inputs."""
    tc, topo, sched, cfg, lcfg = _port()
    resumed, single = _crash_resume(
        tc, topo, sched, cfg, law, lcfg, str(tmp_path / law), "reference",
        chunk=8, every=EVERY, fault=tc.crash_at_tick(CRASH))
    _assert_resumed(resumed, single, law)
    core, _ = sup.import_repro()
    jtopo, jsched, jcfg = sup.bottleneck18(core, steps=STEPS)
    want = core.simulate_slots(jtopo, jsched, law, S,
                               _law_cfg(core, jsched, {}), jcfg)
    _assert_resumed(resumed, want, f"{law} against repro")


def test_megakernel_crash_resume_bitmatch(tmp_path):
    """The megakernel backend honours the same contract (its carry, the
    pending FCTs and the gather table included, is plain data)."""
    tc, topo, sched, cfg, lcfg = _port()
    resumed, single = _crash_resume(
        tc, topo, sched, cfg, "powertcp", lcfg, str(tmp_path), "megakernel",
        chunk=8, every=300, fault=tc.crash_at_chunk(6))
    _assert_resumed(resumed, single, "megakernel")


def test_crash_on_checkpoint_boundary_still_resumes(tmp_path):
    """The crash tick is a checkpoint boundary: the snapshot is written
    before the crash fires, so resume replays only the tail."""
    tc, topo, sched, cfg, lcfg = _port()
    ck = tc.CheckpointSpec(path=str(tmp_path), every=450, keep=2)
    single = tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                               chunk=8, device="cpu")
    with pytest.raises(tc.InjectedCrash) as ei:
        tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg, chunk=8,
                          checkpoint=ck, faults=tc.crash_at_tick(450),
                          device="cpu")
    assert ei.value.tick == 450
    assert tc.latest_checkpoint(str(tmp_path)) == 450
    resumed = tc.resume_slots(topo, sched, "powertcp", S, ck, law_cfg=lcfg,
                              cfg=cfg, chunk=8, device="cpu")
    _assert_resumed(resumed, single, "crash on the boundary")


def test_checkpoint_cadence_and_gc(tmp_path):
    """Boundaries land exactly on the cadence's multiples, the last tick
    is always snapshotted, and only the newest ``keep`` stay."""
    tc, topo, sched, cfg, lcfg = _port()
    ck = tc.CheckpointSpec(path=str(tmp_path), every=200, keep=2)
    tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg, chunk=8,
                      checkpoint=ck, device="cpu")
    assert tc.checkpoint_ticks(str(tmp_path)) == [800, 900]
    meta = tc.read_meta(str(tmp_path), 900)
    assert meta["tick"] == 900 and meta["law"] == "powertcp"
    assert meta["steps"] == STEPS and meta["slots"] == S
    assert meta["flows"] == 18 and meta["mega"] is False
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))


def test_resume_without_snapshot_raises(tmp_path):
    tc, topo, sched, cfg, _ = _port(steps=300)
    ck = tc.CheckpointSpec(path=str(tmp_path / "empty"), every=100)
    with pytest.raises(FileNotFoundError):
        tc.resume_slots(topo, sched, "powertcp", S, ck, cfg=cfg, chunk=8,
                        device="cpu")


def test_resume_scenario_mismatch_rejected(tmp_path):
    """A snapshot of one scenario refuses to seed another."""
    tc, topo, sched, cfg, lcfg = _port(steps=400)
    ck = tc.CheckpointSpec(path=str(tmp_path), every=200)
    tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg, chunk=8,
                      checkpoint=ck, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        tc.resume_slots(topo, sched, "swift", S, ck, cfg=cfg, chunk=8,
                        device="cpu")


def test_fused_backend_rejects_the_chunk_loop(tmp_path):
    """Checkpoints, guards, injected faults and resume ride the chunk
    loop, which the fused backend does not run (``UnsupportedFeature``,
    a ``NotImplementedError``)."""
    tc, topo, sched, cfg, lcfg = _port(steps=100)
    ck = tc.CheckpointSpec(path=str(tmp_path), every=50)
    for kw in (dict(checkpoint=ck), dict(guard=True),
               dict(faults=tc.crash_at_tick(10))):
        with pytest.raises(tc.UnsupportedFeature) as ei:
            tc.simulate_slots(topo, sched, "powertcp", S, cfg=cfg,
                              backend="fused", device="cpu", **kw)
        assert ei.value.hint
    with pytest.raises(tc.UnsupportedFeature):
        tc.resume_slots(topo, sched, "powertcp", S, ck, cfg=cfg,
                        backend="fused", device="cpu")


def test_guard_is_bit_neutral_on_clean_runs():
    tc, topo, sched, cfg, lcfg = _port()
    plain = tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                              chunk=8, device="cpu")
    guarded = tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                                chunk=8, guard=True, device="cpu")
    _assert_resumed(guarded, plain, "guarded")


def _final_carry():
    """A realistic carry: a short run's final SlotState (occupied slots,
    wrapped rings, NaN FCTs of unfinished flows)."""
    tc, topo, sched, cfg, lcfg = _port(steps=500)
    st, _ = tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                              device="cpu")
    return tc, st


def _roundtrip_identical(tc, carry, tmpdir, tick=123, audit=True):
    from repro_torch.core.ckpt import _flatten_named
    ck = tc.CheckpointSpec(path=str(tmpdir), every=0)
    tc.save_checkpoint(ck, tick, carry)
    meta, back, _ = tc.load_checkpoint(str(tmpdir), tick, carry,
                                       to_device=False, audit=audit)
    assert meta["tick"] == tick
    got, want = _flatten_named(back), _flatten_named(carry)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, b), (_, a) in zip(got, want):
        if a is None:
            assert b is None, p
            continue
        a, b = _host(a), _host(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert np.array_equal(a, b, equal_nan=(a.dtype.kind == "f")), p


def test_slot_state_roundtrip_identity(tmp_path):
    tc, st = _final_carry()
    _roundtrip_identical(tc, st, tmp_path)
    meta, back, _ = tc.load_checkpoint(str(tmp_path), 123, st)
    assert isinstance(back.t, int) and back.t == st.t
    assert back.w.dtype == torch.float32 and back.w.device == st.w.device


def test_law_config_roundtrip_identity(tmp_path):
    """A LawConfig (Python-float leaves beside tensors and a nested
    schedule) round-trips exactly, the dtype audit off as in ``repro``."""
    tc, topo, sched, cfg, lcfg = _port(steps=100)
    _roundtrip_identical(tc, lcfg, tmp_path, audit=False)


def test_f64_leaf_rejected_on_load(tmp_path):
    """A snapshot with a float64 leaf is refused on load, before the leaf
    becomes a tensor (``audit_carry_dtypes`` on the raw numpy)."""
    tc, st = _final_carry()
    bad = st._replace(w=st.w.double())
    ck = tc.CheckpointSpec(path=str(tmp_path), every=0)
    tc.save_checkpoint(ck, 7, bad)
    with pytest.raises(TypeError, match="float32"):
        tc.load_checkpoint(str(tmp_path), 7, st)


def test_snapshot_copies_the_carry(tmp_path):
    """The snapshot holds the carry as it was: a leaf updated in place
    after the save (as the megakernel updates its carry) leaves the file
    unchanged."""
    tc, st = _final_carry()
    w0 = st.w.clone()
    tc.save_checkpoint(tc.CheckpointSpec(path=str(tmp_path)), 1, st)
    st.w.fill_(-1.0)
    _, back, _ = tc.load_checkpoint(str(tmp_path), 1, st)
    assert torch.equal(back.w, w0)


# -------------------------------------------------------------------------
# the golden of chip_smoke.py phase 6g
# -------------------------------------------------------------------------

def test_fault_golden_loads_and_matches_the_scenario():
    """``torch_port_fault.json`` loads, holds a completion set and an FCT
    per flow, and its scenario (flow count, pool, ticks, cadence, crash,
    schedule checksum) is the port's build of ``fault_fct``'s."""
    import repro_torch.core as tc
    with open(sup.FAULT_REF) as f:
        ref = json.load(f)
    topo, sched, cfg, slots, every, crash = sup.fault_scenario(
        tc, device="cpu")
    assert ref["scenario"] == dict(
        n_flows=int(sched.start.shape[0]), slots=slots, steps=cfg.steps,
        every=every, crash=crash, schedule_sha256=sup.schedule_checksum(
            sched.size.numpy(), sched.start.numpy()))
    fct = ref["fct_s"]
    assert len(fct) == ref["scenario"]["n_flows"]
    assert ref["completed"] == sum(x is not None for x in fct)
    g = ref["guard"]
    assert g["law"] == "poisoned_powertcp" and g["field"] and g["tick"] > 0


def _f32_list(x):
    """float32 values as the shortest decimals that read back to them
    (None for a flow that did not complete)."""
    return [None if not np.isfinite(v) else float(str(np.float32(v)))
            for v in np.asarray(x, np.float32)]


def write_fault_golden():
    """``repro``'s unchunked megakernel run of ``crash_resume_paper_scale``'s
    scenario (its FCTs, in schedule order) and its guarded
    ``guard_divergence`` run's diagnosis."""
    core, _ = sup.import_repro()
    topo, sched, cfg, slots, every, crash = sup.fault_scenario(core)
    lcfg = core.default_law_config(core.schedule_as_flows(sched),
                                   expected_flows=8.0)
    st, _ = core.simulate_slots(topo, sched, "powertcp", slots, lcfg, cfg,
                                record=False, backend="megakernel")
    fct = np.asarray(st.fct)
    gtopo, gsched, gcfg = sup.bottleneck18(core, hist=512)
    bad = core.poison_law("powertcp", at_t=sup.FAULT_GUARD_AT)
    try:
        core.simulate_slots(gtopo, gsched, bad, 8, cfg=gcfg, chunk=8,
                            guard=True)
        raise AssertionError("the guarded run did not diverge")
    except core.DivergenceError as e:
        guard = dict(law=e.law, tick=e.tick, field=e.field)
    out = dict(
        scenario=dict(n_flows=int(sched.start.shape[0]), slots=slots,
                      steps=cfg.steps, every=every, crash=crash,
                      schedule_sha256=sup.schedule_checksum(
                          np.asarray(sched.size), np.asarray(sched.start))),
        load=sup.FAULT_LOAD, duration_s=sup.FAULT_DURATION,
        seed=sup.FAULT_SEED, law="powertcp", backend="megakernel",
        completed=int(np.isfinite(fct).sum()), fct_s=_f32_list(fct),
        guard=guard)
    with open(sup.FAULT_REF, "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    o = write_fault_golden()
    print(sup.FAULT_REF, o["scenario"], o["completed"], o["guard"])
