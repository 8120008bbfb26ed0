"""The port's batched engines against the JAX reference, on the CPU.

* ``fluid._xla_sum`` (the record sums ``w_sum`` and ``lam``) equals
  ``jax.jit(jnp.sum)`` bit for bit, over vectors and over the rows of a
  batch;
* the stacking helpers (``pad_flows``, ``stack_flows``,
  ``stack_law_configs``, ``pad_schedule``, ``stack_flow_schedules``)
  equal ``repro``'s bit for bit;
* ``simulate_batch`` (reference, fused) and ``simulate_slots_batch``
  (reference, fused, megakernel with ``sequential`` True and False) on a
  LeafSpine(2, 4, 1) web-search sweep of seeds 3 and 4 (load 0.8, 1 600
  ticks, 16 slots) equal ``repro``'s batched runs: the reference and
  megakernel backends bit for bit in every ``Record`` field and the FCTs,
  the fused backend at rtol 1e-5 / atol 0.5 bytes;
* each batched scenario equals the port's own unbatched run bit for bit,
  and the plain megakernel's ungated batch equals its gated batch;
* the arguments that belong to later slices raise, and a stacked gamma
  on the fused backend raises as in ``repro``;
* the reference FCTs of ``chip_smoke.py``'s ``smoke_slots`` phase
  (``tests/golden/torch_port_smoke_slots.json``) match the schedules the
  port builds.

Run as a script, this module regenerates that reference data with
``repro`` on the CPU (``benchmarks/run.py::smoke_slots``'s runs: seeds 1
and 2 on the 256-host paper fabric, about a minute):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_batch.py
"""
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import test_torch_support as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (3, 4)
STEPS = 1600
SLOTS = 16


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _sweep(core, **dev):
    """(topo, [flows per seed], [schedule per seed], cfg) of the sweep."""
    fab = core.LeafSpine(racks=2, hosts_per_rack=4, spines=1)
    flows = [core.poisson_websearch(fab, 0.8, 1.2e-3, 1e-6, seed=s, **dev)
             for s in SEEDS]
    cfg = core.SimConfig(dt=1e-6, steps=STEPS, hist=512, update_period=2e-6)
    return (fab.topology(**dev), flows,
            [core.make_schedule(f) for f in flows], cfg)


@functools.lru_cache(maxsize=None)
def _run(pkg, engine, law, backend, sequential=False):
    """A batched run of the sweep through ``repro`` (pkg "jax") or the
    port (pkg "torch", on the CPU)."""
    if pkg == "jax":
        core, dev = sup.import_repro()[0], {}
    else:
        import repro_torch.core as core
        dev = {"device": "cpu"}
    topo, flows, scheds, cfg = _sweep(core, **dev)
    Q = topo.num_queues
    if engine == "padded":
        return core.simulate_batch(topo, core.stack_flows(flows, Q), law,
                                   cfg=cfg, backend=backend,
                                   expected_flows=8.0, **dev)
    return core.simulate_slots_batch(
        topo, core.stack_flow_schedules(scheds, Q), law, SLOTS, cfg=cfg,
        backend=backend, expected_flows=8.0, sequential=sequential, **dev)


def _assert_equal(got, want, exact=True, what="", min_done=20):
    (sg, rg), (sw, rw) = got, want
    fg, fw = _host(sg.fct), _host(sw.fct)
    assert fg.shape == fw.shape, (what, fg.shape, fw.shape)
    assert (np.isfinite(fg) == np.isfinite(fw)).all(), f"{what}: completion"
    assert np.isfinite(fw).sum() >= min_done, \
        f"{what}: too few flows complete"
    for f in rw._fields:
        g, w = _host(getattr(rg, f)), _host(getattr(rw, f))
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        if exact or f in ("t", "n_active"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} rec.{f}")
            continue
        if f == "thru":
            # the egress rate is bw where the queue was backlogged the tick
            # before, else min(arrivals, bw): where one run's queue sat at
            # 0 and the other's within the queue tolerance above it, the
            # two take different branches
            qg, qw = (np.concatenate([np.zeros_like(x[..., :1, :]),
                                      x[..., :-1, :]], -2)
                      for x in (_host(rg.q), _host(rw.q)))
            edge = (qg > 0.0) != (qw > 0.0)
            np.testing.assert_allclose(qg[edge], qw[edge], rtol=0, atol=0.5)
            g, w = g[~edge], w[~edge]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.5,
                                   err_msg=f"{what} rec.{f}")
    if exact:
        np.testing.assert_array_equal(fg, fw, err_msg=f"{what} fct")
        for f in ("w", "q", "remaining", "hist_q", "hist_lam", "hist_w"):
            np.testing.assert_array_equal(
                _host(getattr(sg, f)), _host(getattr(sw, f)),
                err_msg=f"{what} state.{f}")
    else:
        np.testing.assert_allclose(fg, fw, rtol=1e-5, err_msg=f"{what} fct")


# -------------------------------------------------------------------------
# the record sums in XLA:CPU's order
# -------------------------------------------------------------------------

@pytest.mark.parametrize("n", [10, 17, 33, 64, 384, 2406, 40000])
def test_xla_sum_matches_jax(n):
    sup.apply_jax_shim()
    import jax
    import jax.numpy as jnp
    from repro_torch.core.fluid import _xla_sum
    rng = np.random.default_rng(n)
    one = jax.jit(jnp.sum)
    rows = jax.jit(lambda x: jnp.sum(x, axis=1))
    for _ in range(6):
        v = (rng.standard_normal(n) * rng.uniform(1.0, 1e6)).astype(
            np.float32)
        assert np.asarray(one(v)).tobytes() == \
            _xla_sum(torch.as_tensor(v)).numpy().tobytes(), n
    x = (np.abs(rng.standard_normal((3, n))) * 1e5).astype(np.float32)
    np.testing.assert_array_equal(_xla_sum(torch.as_tensor(x)).numpy(),
                                  np.asarray(rows(x)))


# -------------------------------------------------------------------------
# the stacking helpers
# -------------------------------------------------------------------------

def _stacked(core, helper, **dev):
    topo, flows, scheds, _ = _sweep(core, **dev)
    Q = topo.num_queues
    if helper == "pad_flows":
        return core.pad_flows(flows[0], int(flows[0].tau.shape[0]) + 5, Q)
    if helper == "stack_flows":
        return core.stack_flows(flows, Q)
    if helper == "pad_schedule":
        return core.pad_schedule(scheds[1], int(scheds[1].start.shape[0])
                                 + 3, Q)
    if helper == "stack_flow_schedules":
        return core.stack_flow_schedules(scheds, Q)
    return _gamma_sweep(core, core.stack_flows(flows, Q))


def _gamma_sweep(core, fb):
    """A stacked LawConfig of the batch ``fb``: gamma 0.9 and 0.8."""
    return core.stack_law_configs([core.default_law_config(
        type(fb)(*[x[b] for x in fb]), gamma=g, expected_flows=8.0)
        for b, g in enumerate((0.9, 0.8))])


@pytest.mark.parametrize("helper", ["pad_flows", "stack_flows",
                                    "stack_law_configs", "pad_schedule",
                                    "stack_flow_schedules"])
def test_stacking_helpers_match_repro(helper):
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    want = _stacked(jcore, helper)
    got = _stacked(tc, helper, device="cpu")
    assert type(got).__name__ == type(want).__name__
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32,
                           np.dtype(np.bool_): torch.bool}[w.dtype], f
        np.testing.assert_array_equal(_host(g), w, err_msg=f)


# -------------------------------------------------------------------------
# the batched engines against repro
# -------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_simulate_batch_matches_repro(backend):
    _assert_equal(_run("torch", "padded", "powertcp", backend),
                  _run("jax", "padded", "powertcp", backend),
                  exact=backend == "reference", what=f"padded {backend}")


@pytest.mark.parametrize("law,backend,sequential", [
    ("powertcp", "reference", False), ("powertcp", "fused", False),
    ("powertcp", "megakernel", False), ("powertcp", "megakernel", True),
    ("theta_powertcp", "reference", False),
    ("theta_powertcp", "fused", False),
    ("theta_powertcp", "megakernel", False)])
def test_simulate_slots_batch_matches_repro(law, backend, sequential):
    _assert_equal(_run("torch", "slot", law, backend, sequential),
                  _run("jax", "slot", law, backend, sequential),
                  exact=backend != "fused",
                  what=f"slot {law} {backend} sequential={sequential}")


def test_sequential_equals_lockstep_reference():
    _assert_equal(_run("torch", "slot", "powertcp", "reference", True),
                  _run("torch", "slot", "powertcp", "reference", False),
                  what="slot reference sequential")


# -------------------------------------------------------------------------
# within the port
# -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _single(engine, law, backend, b):
    """The port's unbatched run of scenario ``b`` at the batch's width
    (flows padded to the batch's flow count, as in the batch)."""
    import repro_torch.core as tc
    topo, flows, scheds, cfg = _sweep(tc, device="cpu")
    Q = topo.num_queues
    if engine == "padded":
        f = tc.stack_flows(flows, Q)
        f = type(f)(*[x[b] for x in f])
        return tc.simulate(topo, f, law, tc.default_law_config(
            f, expected_flows=8.0), cfg, backend=backend, device="cpu")
    s = tc.stack_flow_schedules(scheds, Q)
    s = type(s)(*[x[b] for x in s])
    return tc.simulate_slots(topo, s, law, SLOTS, tc.default_law_config(
        s, expected_flows=8.0), cfg, backend=backend, device="cpu")


@pytest.mark.parametrize("engine,backend", [
    ("padded", "reference"), ("padded", "fused"), ("slot", "reference"),
    ("slot", "fused"), ("slot", "megakernel")])
def test_batched_scenario_equals_its_unbatched_run(engine, backend):
    st, rec = _run("torch", engine, "powertcp", backend)
    for b in range(len(SEEDS)):
        got = (st._replace(fct=st.fct[b], w=st.w[b], q=st.q[b],
                           remaining=st.remaining[b], hist_q=st.hist_q[b],
                           hist_lam=st.hist_lam[b], hist_w=st.hist_w[b]),
               type(rec)(*[x[b] for x in rec]))
        _assert_equal(got, _single(engine, "powertcp", backend, b),
                      what=f"{engine} {backend} scenario {b}", min_done=10)


@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_ungated_megakernel_equals_gated_on_the_batch(law):
    """The plain megakernel tick with ``gate=False`` (the admit/retire pass
    on every tick) gives the gated batch's trajectories bit for bit."""
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    topo, _, scheds, cfg = _sweep(tc, device="cpu")
    sb = tc.stack_flow_schedules(scheds, topo.num_queues)
    sim = fluid.make_slot_sim(topo, sb, law, SLOTS,
                              tc.default_law_config(sb, expected_flows=8.0),
                              cfg._replace(steps=600), "megakernel", "cpu")
    with torch.no_grad():
        gated = mk.simulate_slots_mega(sim)
        ungated = mk.simulate_slots_mega(sim, gate=False)
    n = fluid._slot_n(sim)
    _assert_equal(
        (ungated[0]._replace(fct=ungated[0].fct[:, :n]), ungated[1]),
        (gated[0]._replace(fct=gated[0].fct[:, :n]), gated[1]),
        what=f"ungated {law}", min_done=5)


# -------------------------------------------------------------------------
# arguments
# -------------------------------------------------------------------------

def test_stacked_gamma_on_the_fused_backend_raises_as_in_repro():
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        topo, flows, _, cfg = _sweep(core, **dev)
        fb = core.stack_flows(flows, topo.num_queues)
        lcfg = _gamma_sweep(core, fb)
        with pytest.raises(ValueError, match="backend='reference'"):
            core.simulate_batch(topo, fb, "powertcp", lcfg,
                                cfg._replace(steps=4), backend="fused",
                                **dev)
        # the reference backend takes the gamma sweep
        core.simulate_batch(topo, fb, "powertcp", lcfg,
                            cfg._replace(steps=4), **dev)


def test_unported_batch_arguments_raise():
    import repro_torch.core as tc
    topo, flows, scheds, cfg = _sweep(tc, device="cpu")
    Q = topo.num_queues
    fb, sb = tc.stack_flows(flows, Q), tc.stack_flow_schedules(scheds, Q)
    # a regime is ported (item 10); the fused backend rejects it with a
    # NotImplementedError, as repro's UnsupportedFeature
    kw = dict(impair_params=tc.no_impairment(topo), backend="fused")
    with pytest.raises(NotImplementedError, match="fused backend"):
        tc.simulate_batch(topo, fb, "powertcp", cfg=cfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="fused backend"):
        tc.simulate_slots_batch(topo, sb, "powertcp", SLOTS, cfg=cfg,
                                device="cpu", **kw)
    # devices is ported (item 12): without a process group of several
    # ranks it clamps to one device, as repro clamps to the devices present
    short = cfg._replace(steps=8)
    for run in (lambda **k: tc.simulate_batch(topo, fb, "powertcp",
                                              cfg=short, record=False,
                                              device="cpu", **k),
                lambda **k: tc.simulate_slots_batch(topo, sb, "powertcp",
                                                    SLOTS, cfg=short,
                                                    record=False,
                                                    device="cpu", **k)):
        torch.testing.assert_close(run(devices=2)[0].w, run()[0].w,
                                   rtol=0, atol=0)
    # allocators are ported (item 13): one that hands back the law's rate
    # caps changes no bit of the batch's run
    keep = tc.simulate_batch(topo, fb, "powertcp", cfg=short,
                             alloc_fn=lambda r, a, t, f, cap: cap,
                             device="cpu")
    for g, w in zip(keep, tc.simulate_batch(topo, fb, "powertcp", cfg=short,
                                            device="cpu")):
        for (name, x), (_, y) in zip(sup.tree_leaves(g), sup.tree_leaves(w)):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m, n=name: f"{n}: {m}")
    # as in repro, the sequential slot engine ignores ``devices``
    st, _ = tc.simulate_slots_batch(topo, sb, "powertcp", SLOTS,
                                    cfg=cfg._replace(steps=8), devices=2,
                                    sequential=True, record=False,
                                    device="cpu")
    assert st.fct.shape[0] == len(SEEDS)
    with pytest.raises(ValueError, match="cannot pad"):
        tc.pad_flows(flows[0], 1, Q)


# -------------------------------------------------------------------------
# the smoke_slots reference data of chip_smoke.py
# -------------------------------------------------------------------------

SMOKE_SEEDS = (1, 2)


def _smoke_scenario(core, **dev):
    """(topo, [flows per seed], [schedule per seed], cfg) of
    ``benchmarks/run.py::smoke_slots`` on ``paper_fabric()``."""
    fab = core.LeafSpine(**sup.PAPER)
    flows = [core.poisson_websearch(fab, sup.PAPER_LOAD, sup.PAPER_DURATION,
                                    sup.PAPER_DT, seed=s, **dev)
             for s in SMOKE_SEEDS]
    cfg = core.SimConfig(dt=sup.PAPER_DT, steps=sup.PAPER_STEPS, hist=512,
                         update_period=2e-6)
    return (fab.topology(**dev), flows,
            [core.make_schedule(f) for f in flows], cfg)


def test_smoke_slots_reference_matches_port_schedules():
    import repro_torch.core as tc
    with open(sup.SMOKE_REF) as f:
        data = json.load(f)
    _, flows, scheds, _ = _smoke_scenario(tc, device="cpu")
    assert [s["seed"] for s in data["scenarios"]] == list(SMOKE_SEEDS)
    for sched, ref in zip(scheds, data["scenarios"]):
        n = int(sched.start.shape[0])
        assert ref["n_flows"] == n
        assert ref["schedule_sha256"] == sup.schedule_checksum(
            _host(sched.size), _host(sched.start))
        for run in ("padded", "slot", "mega"):
            assert len(ref["fct_s"][run]) == n
    assert 0 < data["slots"] <= sum(s["n_flows"] for s in data["scenarios"])


def _write_smoke_reference():
    """``smoke_slots``'s batched runs through ``repro`` on the CPU, written
    to tests/golden/torch_port_smoke_slots.json."""
    jcore, _ = sup.import_repro()
    topo, flows, scheds, cfg = _smoke_scenario(jcore)
    Q = topo.num_queues
    st_p, _ = jcore.simulate_batch(topo, jcore.stack_flows(flows, Q),
                                   "powertcp", cfg=cfg, record=False,
                                   expected_flows=sup.PAPER_EXPECTED_FLOWS)
    rows = [np.asarray(st_p.fct[i][:int(s.start.shape[0])], np.float64)
            for i, s in enumerate(scheds)]
    slots = sup.smoke_slots_pool(
        [np.asarray(s.start) for s in scheds], rows,
        max(int(np.asarray(s.tf_steps).max()) for s in scheds),
        jcore.peak_concurrency)
    # the padded engine's FCTs are in flow order: schedule order here
    padded = [r[np.asarray(s.order)] for r, s in zip(rows, scheds)]
    sb = jcore.stack_flow_schedules(scheds, Q)
    runs = {"padded": padded}
    for key, backend in (("slot", "reference"), ("mega", "megakernel")):
        st, _ = jcore.simulate_slots_batch(
            topo, sb, "powertcp", slots, cfg=cfg, record=False,
            backend=backend, expected_flows=sup.PAPER_EXPECTED_FLOWS,
            sequential=backend == "megakernel")
        runs[key] = [np.asarray(st.fct[i][:int(s.start.shape[0])],
                                np.float64) for i, s in enumerate(scheds)]

    def js(x):
        return [None if not np.isfinite(v) else float(v) for v in x]

    data = {
        "source": "repro.core.simulate_batch and simulate_slots_batch "
                  "(reference; megakernel, sequential=True) with the "
                  "scenario of benchmarks/run.py::smoke_slots on "
                  "benchmarks/fig6_fct.py::paper_fabric(), seeds 1 and 2",
        "fabric": sup.PAPER, "load": sup.PAPER_LOAD,
        "duration_s": sup.PAPER_DURATION, "dt_s": sup.PAPER_DT,
        "steps": sup.PAPER_STEPS, "hist": 512, "update_period_s": 2e-6,
        "expected_flows": sup.PAPER_EXPECTED_FLOWS, "law": "powertcp",
        "slots": int(slots),
        "scenarios": [{
            "seed": seed, "n_flows": int(s.start.shape[0]),
            "schedule_sha256": sup.schedule_checksum(np.asarray(s.size),
                                                     np.asarray(s.start)),
            "fct_s": {k: js(v[i]) for k, v in runs.items()}}
            for i, (seed, s) in enumerate(zip(SMOKE_SEEDS, scheds))],
    }
    with open(sup.SMOKE_REF, "w") as f:
        json.dump(data, f)
    print(f"wrote {sup.SMOKE_REF}: {[d['n_flows'] for d in data['scenarios']]}"
          f" flows, {slots} slots")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(REPO, "src"))
    _write_smoke_reference()
