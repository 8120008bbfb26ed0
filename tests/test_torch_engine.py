"""The port's engines against the JAX reference, on the CPU.

* the ``powertcp`` and ``theta_powertcp`` golden legs
  (``tests/golden/golden_laws.json``) through the port's ``simulate``,
  both backends, at ``tests/test_golden_traces.py``'s tolerances;
* live parity with ``repro`` on a small leaf-spine web-search scenario,
  padded and slot engines, reference and fused backends: the reference
  backend bit for bit (every ``Record`` field, FCTs with ``equal_nan``),
  the fused
  backend at rtol 1e-5 (its kernels sum and associate in their own
  order, in both packages);
* within the port, slot == padded bit for bit when S >= N;
* ``from_numpy`` round trips, and the import boundary: ``repro_torch``
  and ``chip_smoke.py`` import neither ``jax`` nor ``repro``;
* the paper-scale reference data of ``chip_smoke.py``
  (``tests/golden/torch_port_paper_seed1.json``) matches the schedule
  the port builds.

Run as a script, this module regenerates that reference data: the JAX
slot engine (reference backend, 384 slots) on the 256-host paper fabric,
seed 1, for PowerTCP and theta-PowerTCP:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_engine.py
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_support as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAWS = ("powertcp", "theta_powertcp")
BACKENDS = ("reference", "fused")


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# -------------------------------------------------------------------------
# goldens
# -------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("law", LAWS)
def test_golden_leg(law, backend):
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    got = sup.pack(*tc.simulate(topo, flows, law, lcfg, cfg,
                                backend=backend, device="cpu"))
    sup.check_golden(law, got, sup.golden()[law], leg=f"[{backend}]")


# -------------------------------------------------------------------------
# live parity with repro
# -------------------------------------------------------------------------

LIVE_STEPS = 1600
LIVE_SLOTS = 16


def _live_scenario(core, **dev):
    fab = core.LeafSpine(racks=2, hosts_per_rack=4, spines=1)
    flows = core.poisson_websearch(fab, 0.8, 1.2e-3, 1e-6, seed=3, **dev)
    sched = core.make_schedule(flows)
    cfg = core.SimConfig(dt=1e-6, steps=LIVE_STEPS, hist=512,
                         update_period=2e-6)
    return fab.topology(**dev), sched, cfg


def _run(core, engine, law, backend, **dev):
    topo, sched, cfg = _live_scenario(core, **dev)
    if engine == "padded":
        flows = core.schedule_as_flows(sched)
        lcfg = core.default_law_config(flows, expected_flows=8.0)
        return core.simulate(topo, flows, law, lcfg, cfg, backend=backend,
                             **dev)
    lcfg = core.default_law_config(sched, expected_flows=8.0)
    return core.simulate_slots(topo, sched, law, LIVE_SLOTS, lcfg, cfg,
                               backend=backend, **dev)


@pytest.mark.parametrize("engine", ("padded", "slot"))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("law", LAWS)
def test_live_parity_with_jax(law, backend, engine):
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    sj, rj = _run(jcore, engine, law, backend)
    st, rt = _run(tc, engine, law, backend, device="cpu")
    qj, qt = np.asarray(rj.q), _host(rt.q)
    fj, ft = np.asarray(sj.fct), _host(st.fct)
    assert np.isfinite(fj).sum() >= 10, "scenario completes too few flows"
    assert (np.isfinite(fj) == np.isfinite(ft)).all(), "completion set"
    if backend == "reference":
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(_host(rt.lam_f), np.asarray(rj.lam_f))
        # every Record field, the per-tick sums w_sum and lam included
        for f in rj._fields:
            np.testing.assert_array_equal(_host(getattr(rt, f)),
                                          np.asarray(getattr(rj, f)),
                                          err_msg=f"rec.{f}")
    else:
        np.testing.assert_allclose(qt, qj, rtol=1e-5, atol=0.5)
        np.testing.assert_allclose(ft, fj, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_pool_backlog_parity_with_jax(backend):
    """A pool of 4 slots for 17 flows: arrivals wait for a free slot over
    hundreds of ticks, so admission runs tick after tick with a backlog
    and slots are recycled many times."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    out = []
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        topo, sched, cfg = _live_scenario(core, **dev)
        lcfg = core.default_law_config(sched, expected_flows=8.0)
        st, rec = core.simulate_slots(topo, sched, "powertcp", 4, lcfg, cfg,
                                      backend=backend, **dev)
        out.append((_host(st.fct), _host(rec.q)))
    (fj, qj), (ft, qt) = out
    assert (np.isfinite(fj) == np.isfinite(ft)).all(), "completion set"
    if backend == "reference":
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(ft, fj)
    else:
        np.testing.assert_allclose(qt, qj, rtol=1e-5, atol=0.5)
        np.testing.assert_allclose(ft, fj, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("law", LAWS)
def test_slot_equals_padded_when_pool_holds_every_flow(law, backend):
    import repro_torch.core as tc
    topo, sched, cfg = _live_scenario(tc, device="cpu")
    n = int(sched.start.shape[0])
    flows = tc.schedule_as_flows(sched)
    sp, rp = tc.simulate(topo, flows, law,
                         tc.default_law_config(flows, expected_flows=8.0),
                         cfg, backend=backend, device="cpu")
    ss, rs = tc.simulate_slots(topo, sched, law, n,
                               tc.default_law_config(sched,
                                                     expected_flows=8.0),
                               cfg, backend=backend, device="cpu")
    np.testing.assert_array_equal(_host(rs.q), _host(rp.q))
    np.testing.assert_array_equal(_host(ss.fct), _host(sp.fct))


# -------------------------------------------------------------------------
# types, devices and the import boundary
# -------------------------------------------------------------------------

def test_from_numpy_round_trip():
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    from repro_torch.core.types import from_numpy
    jtopo, jsched, _ = _live_scenario(jcore)
    for jx, cls in ((jtopo, tc.Topology), (jsched, tc.FlowSchedule)):
        arrays = {f: (np.asarray(v) if hasattr(v, "shape") else v)
                  for f, v in jx._asdict().items()}
        got = from_numpy(cls, arrays, device="cpu")
        for f, v in arrays.items():
            g = getattr(got, f)
            if isinstance(v, np.ndarray):
                assert g.dtype in (torch.float32, torch.int32), f
                np.testing.assert_array_equal(_host(g), v, err_msg=f)
            else:
                assert g == v, f
    lcfg = jcore.default_law_config(jcore.schedule_as_flows(jsched),
                                    expected_flows=8.0)
    got = from_numpy(tc.LawConfig, lcfg, device="cpu")
    assert got.gamma == lcfg.gamma and isinstance(got.gamma, float)
    np.testing.assert_array_equal(_host(got.beta), np.asarray(lcfg.beta))
    # host float64 becomes float32, integers int32
    x = from_numpy(tc.LawConfig, {"beta": np.ones(3), "hpcc_max_stage": 5},
                   device="cpu")
    assert x.beta.dtype == torch.float32 and x.hpcc_max_stage == 5


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    import repro_torch.core as tc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.LeafSpine(racks=2, hosts_per_rack=2).topology()
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.simulate(topo, flows, "powertcp", lcfg, cfg)


def test_unported_arguments_raise():
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    sched = tc.make_schedule(flows)
    # impairments are ported (item 10); the fused backend rejects them
    with pytest.raises(NotImplementedError, match="fused backend"):
        tc.simulate_slots(topo, sched, "powertcp", 4,
                          impair=tc.no_impairment(topo), backend="fused",
                          device="cpu")
    # chunk streaming, sweeps (item 11) and the sharded sweep (item 12)
    # are ported: without a process group of several ranks, devices=2
    # clamps to one device, as repro clamps to the devices present
    spec = tc.SweepSpec(laws=["powertcp"], flows=[flows])
    assert tc.resolve_devices(2) == 1
    one = tc.run_sweep(spec, topo, cfg, record=False, device="cpu")
    two = tc.run_sweep(spec, topo, cfg, record=False, devices=2,
                       device="cpu")
    torch.testing.assert_close(two.states[0].fct, one.states[0].fct,
                               rtol=0, atol=0, equal_nan=True)
    # allocators (item 13) are ported to the padded engine; the slot path
    # rejects them, as repro does
    with pytest.raises(ValueError, match="not supported on the slot path"):
        tc.slot_step(tc.make_slot_sim(topo, tc.batch_of_one(sched),
                                      "powertcp", 4, device="cpu"),
                     None, alloc_fn=lambda *a: None)


def _imports(path):
    """Top-level module names a Python file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


PORT_SUBPACKAGES = ("core", "kernels", "configs", "models", "serve",
                    "commsched")


@pytest.mark.parametrize("sub", PORT_SUBPACKAGES)
def test_port_imports_neither_jax_nor_repro(sub):
    """Every file of the subpackage (and ``chip_smoke.py``, checked with
    ``core``) imports neither jax, ``repro`` nor ``benchmarks``, and
    importing the subpackage loads none of them."""
    files = [os.path.join(REPO, "chip_smoke.py")] if sub == "core" else []
    pkg = os.path.join(REPO, "src", "repro_torch", sub)
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert files
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro", "benchmarks"}
        assert not bad, f"{path} imports {bad}"
    code = (f"import sys; import repro_torch.{sub}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'benchmarks')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


def test_port_subpackages_are_all_checked():
    pkg = os.path.join(REPO, "src", "repro_torch")
    subs = {n for n in os.listdir(pkg)
            if os.path.isfile(os.path.join(pkg, n, "__init__.py"))}
    assert subs == set(PORT_SUBPACKAGES)
    assert _imports(os.path.join(pkg, "__init__.py")) <= {"torch"}


# -------------------------------------------------------------------------
# the paper-scale reference data of chip_smoke.py
# -------------------------------------------------------------------------

def _paper_schedule(core, **dev):
    fab = core.LeafSpine(**sup.PAPER)
    flows = core.poisson_websearch(fab, sup.PAPER_LOAD, sup.PAPER_DURATION,
                                   sup.PAPER_DT, seed=1, **dev)
    return fab, core.make_schedule(flows)


def test_paper_reference_matches_port_schedule():
    import repro_torch.core as tc
    with open(sup.PAPER_REF) as f:
        data = json.load(f)
    _, sched = _paper_schedule(tc, device="cpu")
    assert data["n_flows"] == int(sched.start.shape[0])
    assert data["schedule_sha256"] == sup.schedule_checksum(
        _host(sched.size), _host(sched.start))
    for law in LAWS:
        assert len(data["fct_s"][law]) == data["n_flows"]
    assert tc.suggest_slots(sched, sup.PAPER_DT) == data["slots"]


def _write_paper_reference():
    """Run the JAX slot engine (reference backend) on the paper scenario
    and write tests/golden/torch_port_paper_seed1.json."""
    jcore, _ = sup.import_repro()
    fab, sched = _paper_schedule(jcore)
    topo = fab.topology()
    cfg = jcore.SimConfig(dt=sup.PAPER_DT, steps=sup.PAPER_STEPS, hist=512,
                          update_period=2e-6)
    lcfg = jcore.default_law_config(sched,
                                    expected_flows=sup.PAPER_EXPECTED_FLOWS)
    fcts = {}
    for law in LAWS:
        st, _ = jcore.simulate_slots(topo, sched, law, sup.PAPER_SLOTS,
                                     lcfg, cfg, record=False)
        fct = np.asarray(st.fct, np.float64)
        fcts[law] = [None if not np.isfinite(x) else float(x) for x in fct]
    data = {
        "source": "repro.core.simulate_slots, backend='reference', on "
                  "benchmarks/fig6_fct.py::paper_fabric() with the "
                  "scenario of benchmarks/run.py::smoke_slots (seed 1)",
        "fabric": sup.PAPER, "load": sup.PAPER_LOAD,
        "duration_s": sup.PAPER_DURATION, "dt_s": sup.PAPER_DT,
        "steps": sup.PAPER_STEPS, "hist": 512, "update_period_s": 2e-6,
        "expected_flows": sup.PAPER_EXPECTED_FLOWS, "seed": 1,
        "slots": sup.PAPER_SLOTS,
        "n_flows": int(sched.start.shape[0]),
        "schedule_sha256": sup.schedule_checksum(np.asarray(sched.size),
                                                 np.asarray(sched.start)),
        "fct_s": fcts,
    }
    with open(sup.PAPER_REF, "w") as f:
        json.dump(data, f)
    print(f"wrote {sup.PAPER_REF}: {data['n_flows']} flows")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(REPO, "src"))
    _write_paper_reference()
