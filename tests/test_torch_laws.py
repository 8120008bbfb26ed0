"""The classic laws of the port (``hpcc``, ``swift``, ``gradient_mimd``,
``timely``, ``dcqcn``, ``reno``) against the JAX reference, on the CPU.

Each test is a case per law:

* update by update: seeded ``PathObs``, state, windows, rate caps, masks
  and times (masked-off rows and int32 stage counters at their limits)
  through ``repro``'s ``*_update`` and the port's, every leaf bit for bit
  (``dcqcn``: its ``pow`` may differ in the last bits between XLA:CPU and
  PyTorch, so within ``DCQCN_RTOL``);
* the clean leg of ``tests/golden/golden_laws.json`` through the port's
  padded reference engine, within ``tests/test_golden_traces.py``'s
  tolerances;
* live parity with ``repro`` (``test_torch_engine._live_scenario``),
  padded and slot engines, reference backend: every ``Record`` field and
  the FCTs bit for bit (``dcqcn`` at the golden tolerances);
* within the port, the plain megakernel tick equal to the slot reference
  bit for bit, with ``gate`` True and False;
* a batch whose ``hpcc_eta`` and ``dcqcn_rai`` differ by scenario
  (``stack_law_configs``) against ``repro``'s ``simulate_slots_batch``;
* K4's shared-memory layout at the shape of ``chip_smoke.py``'s phase 6c;
* each law-state leaf of the slot carry a tensor of its own (K4 writes
  the carry back in place);
* a per-flow gamma (``linspace(0.5, 0.95)``) through the plain
  megakernel tick against ``repro``'s megakernel, bit for bit;

and, once, XLA:CPU's ``pow`` against ``torch.pow`` over DCQCN's inputs
(at most one ulp apart).

Run as a script, this module writes phase 6c's reference data,
``tests/golden/torch_port_fig6_paper.json``: ``repro``'s slot engine
(``simulate_slots_batch``, reference backend) on the CPU over
``benchmarks/fig6_fct.py::run_paper_scale``'s scenario for its five laws
(the per-flow FCTs as float32, the p99.9 FCTs by size and
``claims_hold``):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_laws.py
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_support as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAWS = ("hpcc", "swift", "gradient_mimd", "timely", "dcqcn", "reno")


EWMA_LAWS = ("powertcp", "theta_powertcp", "swift", "gradient_mimd")
# dcqcn's float leaves against repro's: XLA:CPU's and PyTorch's float32
# pow differ by one ulp on ~1.7% of DCQCN's inputs (measured by
# test_pow_drift_is_one_ulp), which moves 1 - pow by up to ~1e-4
# relative where it is small
DCQCN_RTOL = 1e-6


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# -------------------------------------------------------------------------
# update by update
# -------------------------------------------------------------------------

def _update_inputs(law, F=2048, H=3, seed=0):
    """Seeded inputs of one ``*_update`` call at the simulator's
    magnitudes: (PathObs fields, per-flow config, law state, w, rate_cap,
    upd, t), numpy. Masked-off rows, sentinel hops and int32 counters at
    0, -1 and INT32_MAX - 1 included; ECN fractions 0, 1 (a hard mark) and
    between."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tau = rng.uniform(12e-6, 24e-6, F).astype(f32)
    hb = rng.choice([3.125e9, 12.5e9], F).astype(f32)
    w = (np.abs(rng.standard_normal(F)) * 1e5 + 1e4).astype(f32)
    u = rng.random(F)
    ecn = np.where(u < 0.2, 1.0, np.where(u < 0.5, 0.0,
                                           rng.uniform(0, 0.2, F)))
    obs = dict(q=(np.abs(rng.standard_normal((F, H))) * 1e6).astype(f32),
               qdot=(rng.standard_normal((F, H)) * 1e8).astype(f32),
               mu=(np.abs(rng.standard_normal((F, H))) * 1e9).astype(f32),
               b=rng.choice([3.125e9, 12.5e9], (F, H)).astype(f32),
               valid=rng.random((F, H)) > 0.3,
               theta=(tau * rng.uniform(0.9, 4.0, F)).astype(f32),
               w_old=(w * rng.uniform(0.5, 1.5, F)).astype(f32),
               dt_obs=rng.choice([1e-6, 2e-6, 30e-6], F).astype(f32),
               ecn_frac=ecn.astype(f32))
    cfg = dict(beta=rng.uniform(1e3, 5e4, F).astype(f32), tau=tau,
               host_bw=hb)
    t = f32(rng.uniform(1e-4, 1e-3))

    def stage(hi):
        x = rng.integers(0, hi, F).astype(np.int32)
        x[:3] = [0, -1, np.iinfo(np.int32).max - 1]
        return x

    def past():
        return (t - rng.uniform(0, 200e-6, F)).astype(f32)

    rate = (hb * rng.uniform(0.0005, 1.0, F)).astype(f32)
    state = {
        "hpcc": dict(u=rng.uniform(0.2, 1.5, F).astype(f32),
                     wc=(hb * tau * rng.uniform(0.2, 1.2, F)).astype(f32),
                     inc_stage=stage(8), last_ref=past()),
        "swift": dict(dummy=np.zeros(F, f32)),
        "gradient_mimd": dict(prev_theta=(tau * rng.uniform(0.9, 4.0, F))
                              .astype(f32)),
        "timely": dict(rate=rate, prev_theta=(tau * rng.uniform(0.9, 4.0, F))
                       .astype(f32), neg_count=stage(8)),
        "dcqcn": dict(rc=rate, rt=(rate * rng.uniform(1, 2, F)).astype(f32),
                      alpha=rng.uniform(0, 1, F).astype(f32),
                      t_last_cut=past(), t_last_inc=past(),
                      inc_stage=stage(14)),
        "reno": dict(last_cut=past()),
    }[law]
    rate_cap = np.where(rng.random(F) < 0.5, np.inf,
                        rng.uniform(1e8, 1e10, F)).astype(f32)
    upd = rng.random(F) > 0.4
    return obs, cfg, state, w, rate_cap, upd, t


@pytest.mark.parametrize("law", LAWS)
def test_update_matches_repro(law):
    """The port's update against ``repro``'s under ``jax.jit`` as the
    engines compile it: the config's arrays inputs of the program, its
    Python scalars constants (XLA folds a division by one into a product
    with its reciprocal; ``laws.div_config`` does the same)."""
    import jax
    import jax.numpy as jnp
    jcore, _ = sup.import_repro()
    import repro.core.laws as jl
    import repro_torch.core as tc
    obs, cfg, state, w, rate_cap, upd, t = _update_inputs(law)
    jlaw, tlaw = jl.LAWS[law], tc.LAWS[law]
    jcfg0 = jl.LawConfig()

    def run(st, ob, w_, rc, up, t_, arrays):
        return jlaw.update(st, ob, w_, rc, up, jcfg0._replace(**arrays), t_)

    jstate = type(jlaw.init(1, jl.LawConfig(tau=jnp.ones(1),
                                            host_bw=jnp.ones(1))))
    got_j = jax.jit(run)(
        jstate(**{k: jnp.asarray(v) for k, v in state.items()}),
        jl.PathObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jnp.asarray(w), jnp.asarray(rate_cap), jnp.asarray(upd),
        jnp.float32(t), {k: jnp.asarray(v) for k, v in cfg.items()})
    tstate = type(tlaw.init(1, tc.LawConfig(tau=torch.ones(1),
                                            host_bw=torch.ones(1))))
    got_t = tlaw.update(
        tstate(**{k: torch.tensor(v) for k, v in state.items()}),
        tc.PathObs(**{k: torch.tensor(v) for k, v in obs.items()}),
        torch.tensor(w), torch.tensor(rate_cap), torch.tensor(upd),
        tc.LawConfig(**{k: torch.tensor(v) for k, v in cfg.items()}),
        float(t))
    names = [f"state.{f}" for f in got_j[0]._fields] + ["w", "rate_cap"]
    for name, a, b in zip(names, list(got_j[0]) + list(got_j[1:]),
                          list(got_t[0]) + list(got_t[1:])):
        a, b = np.asarray(a), _host(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if law == "dcqcn" and a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=DCQCN_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_pow_drift_is_one_ulp():
    """The one op where the port's dcqcn may leave ``repro``'s bits: over
    DCQCN's inputs (1 - p in [0.8, 1], packets 1-2 000) XLA:CPU's float32
    pow and ``torch.pow`` differ by at most one ulp where the result is a
    normal number (subnormal results flush to zero in XLA)."""
    import jax
    import jax.numpy as jnp
    sup.apply_jax_shim()
    rng = np.random.default_rng(0)
    x = rng.uniform(0.8, 1.0, 1 << 16).astype(np.float32)
    y = rng.uniform(1.0, 2000.0, 1 << 16).astype(np.float32)
    a = np.asarray(jax.jit(jnp.power)(x, y))
    b = torch.pow(torch.tensor(x), torch.tensor(y)).numpy()
    normal = (a >= np.finfo(np.float32).tiny) | (b >= np.finfo(np.float32).tiny)
    ulp = np.abs(a.view(np.int32).astype(np.int64)
                 - b.view(np.int32).astype(np.int64))
    assert ulp[normal].max() <= 1


# -------------------------------------------------------------------------
# the engines against repro and within the port
# -------------------------------------------------------------------------

@pytest.mark.parametrize("law", LAWS)
def test_golden_leg(law):
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    got = sup.pack(*tc.simulate(topo, flows, law, lcfg, cfg, device="cpu"))
    sup.check_golden(law, got, sup.golden()[law], leg="[reference]")


def _assert_runs_equal(law, got, want, what, min_done=10):
    """Two runs' (final state, Record): every Record field and the FCTs
    bit for bit (``dcqcn`` against ``repro``: the golden tolerances). The
    reference must complete ``min_done`` flows."""
    (sg, rg), (sw, rw) = got, want
    fg, fw = _host(sg.fct), _host(sw.fct)
    assert np.isfinite(fw).sum() >= min_done, "too few flows complete"
    assert (np.isfinite(fg) == np.isfinite(fw)).all(), f"{what}: completion"
    if law == "dcqcn" and "repro" in what:
        np.testing.assert_allclose(_host(rg.q), _host(rw.q), rtol=1e-5,
                                   atol=0.5)
        np.testing.assert_allclose(fg, fw, rtol=1e-5)
        return
    np.testing.assert_array_equal(fg, fw, err_msg=f"{what}: fct")
    for f in rw._fields:
        np.testing.assert_array_equal(_host(getattr(rg, f)),
                                      _host(getattr(rw, f)),
                                      err_msg=f"{what}: rec.{f}")


@pytest.mark.parametrize("engine", ("padded", "slot"))
@pytest.mark.parametrize("law", LAWS)
def test_live_parity_with_jax(law, engine):
    from test_torch_engine import _run
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    _assert_runs_equal(law, _run(tc, engine, law, "reference", device="cpu"),
                       _run(jcore, engine, law, "reference"),
                       f"{engine} against repro")


# the within-port and batch runs: the first 800 ticks of the live
# scenario, in which 5 or more flows complete (per scenario)
MEGA_STEPS = 800
MEGA_DONE = 5


@pytest.mark.parametrize("gate", (True, False))
@pytest.mark.parametrize("law", LAWS)
def test_plain_megakernel_tick_equals_slot_reference(law, gate):
    """The plain megakernel tick (``impl="torch"``, what K4 is held to on
    the card) against the port's slot reference, every Record field and
    the final carry's FCTs, windows, rate caps and law state bit for
    bit."""
    from test_torch_engine import LIVE_SLOTS, _live_scenario
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    topo, sched, cfg = _live_scenario(tc, device="cpu")
    cfg = cfg._replace(steps=MEGA_STEPS)
    lcfg = tc.default_law_config(sched, expected_flows=8.0)
    want = tc.simulate_slots(topo, sched, law, LIVE_SLOTS, lcfg, cfg,
                             device="cpu")
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), law, LIVE_SLOTS,
                              tc.batch_of_one(lcfg), cfg, "megakernel",
                              "cpu")
    st, rec = mk.simulate_slots_mega(sim, impl="torch", gate=gate)
    st = st._replace(fct=st.fct[..., :int(sched.start.shape[0])])
    got = (tc.scenario(st, 0), tc.scenario(rec, 0))
    _assert_runs_equal(law, got, want, f"megakernel gate={gate}", MEGA_DONE)
    for name, a, b in (("w", got[0].w, want[0].w),
                       ("rate_cap", got[0].rate_cap, want[0].rate_cap)) + \
            tuple((f"law.{f}", a, b) for f, a, b in zip(
                want[0].law._fields, got[0].law, want[0].law)):
        np.testing.assert_array_equal(_host(a), _host(b), err_msg=name)


BATCH_ETA = (0.9, 0.97)
BATCH_RAI = (40e6, 80e6)


@pytest.mark.parametrize("law", LAWS)
def test_batch_with_per_scenario_config_matches_repro(law):
    """Two seeds in one batch, ``hpcc_eta`` and ``dcqcn_rai`` different by
    scenario (``stack_law_configs``, so the engines divide by the stacked
    eta and marking span), through ``simulate_slots_batch`` against
    ``repro``'s."""
    from test_torch_batch import SLOTS, _sweep
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    out = []
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        topo, flows, scheds, cfg = _sweep(core, **dev)
        cfg = cfg._replace(steps=MEGA_STEPS)
        sb = core.stack_flow_schedules(scheds, topo.num_queues)
        cfgs = [core.default_law_config(type(sb)(*[x[b] for x in sb]),
                                        expected_flows=8.0, hpcc_eta=e,
                                        dcqcn_rai=r)
                for b, (e, r) in enumerate(zip(BATCH_ETA, BATCH_RAI))]
        out.append(core.simulate_slots_batch(
            topo, sb, law, SLOTS, core.stack_law_configs(cfgs), cfg, **dev))
    _assert_runs_equal(law, out[1], out[0], "batch against repro",
                       2 * MEGA_DONE)


# -------------------------------------------------------------------------
# K4: the layout at phase 6c's shape, and a per-flow gamma
# -------------------------------------------------------------------------

@pytest.mark.parametrize("law", LAWS)
def test_k4_layout_fits_at_the_fig6_shape(law):
    """At ``chip_smoke.py`` phase 6c's shape (``suggest_slots``' 448 slots
    of 3 hops, 288 queues, the paper fabric's DT fold) each law's working
    set fits in shared memory, and a field the law lacks takes no
    words."""
    from repro_torch.kernels import fused_tick as ft
    with open(sup.FIG6_REF) as f:
        S = json.load(f)["slots"]
    i = ft.LAW_NAMES.index(law)
    lay = ft.layout(S, 3, 288, 10, 34, 10, i)
    assert lay.smem and lay.nbytes <= ft.SMEM_BUDGET, lay.nbytes
    words = dict(ft._fields(S, 3, 288, 10, 34, 10, i))
    for f in ft.STATE_FIELDS:
        assert words[f] == (S if f in ft.LAW_STATE[law] else 0), f
    for f in ft.CONFIG_FIELDS:
        assert words[f] == (S if f in ft.LAW_CONFIG[law] else 0), f


@pytest.mark.parametrize("law", ("powertcp", "theta_powertcp") + LAWS)
def test_slot_state_law_leaves_own_their_memory(law):
    """Each law-state leaf of the slot engine's carry is a tensor of its
    own: K4 writes the carry back in place, and DCQCN's init returns one
    tensor for rc and rt and one for both of its timers."""
    import repro_torch.core as tc
    from repro_torch.core import fluid
    topo, sched, cfg = sup.staggered(tc, steps=64, device="cpu")
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), law, 6,
                              cfg=cfg, backend="megakernel", device="cpu",
                              expected_flows=8.0)
    ptrs = [x.data_ptr() for x in fluid.init_slot_state(sim).law]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("law", EWMA_LAWS)
def test_per_flow_gamma_megakernel_matches_repro(law):
    """A per-flow gamma (``linspace(0.5, 0.95)`` over the schedule) through
    the port's plain megakernel tick against ``repro``'s megakernel, bit
    for bit; K4 reads the same gamma and 1 - gamma per slot (held on the
    card by ``test_torch_cuda.py``)."""
    from test_torch_engine import LIVE_SLOTS, _live_scenario
    jcore, _ = sup.import_repro()
    import jax.numpy as jnp
    import repro_torch.core as tc
    out = []
    for core, dev, arr in ((jcore, {}, jnp.asarray),
                           (tc, {"device": "cpu"}, torch.tensor)):
        topo, sched, cfg = _live_scenario(core, **dev)
        cfg = cfg._replace(steps=MEGA_STEPS)
        n = int(sched.start.shape[0])
        gamma = arr(np.linspace(0.5, 0.95, n).astype(np.float32))
        lcfg = core.default_law_config(sched, expected_flows=8.0)._replace(
            gamma=gamma)
        out.append(core.simulate_slots(topo, sched, law, LIVE_SLOTS, lcfg,
                                       cfg, backend="megakernel", **dev))
    _assert_runs_equal(law, out[1], out[0], "per-flow gamma against repro",
                       MEGA_DONE)


# -------------------------------------------------------------------------
# phase 6c's reference data
# -------------------------------------------------------------------------

def _f32_list(x):
    """float32 values as the shortest decimals that read back to them
    (None for a flow that did not complete)."""
    return [None if not np.isfinite(v) else float(str(v))
            for v in np.asarray(x, np.float32)]


def _write_fig6_reference(laws=sup.FIG6_LAWS):
    """``run_paper_scale``'s five laws through ``repro``'s slot engine on
    the CPU, written to tests/golden/torch_port_fig6_paper.json."""
    jcore, _ = sup.import_repro()
    topo, sched, cfg, slots = sup.fig6_scenario(jcore)
    sb = jcore.stack_flow_schedules([sched], topo.num_queues)
    size = np.asarray(sched.size, np.float64)
    fcts, stats = {}, {}
    for law in laws:
        t0 = time.time()
        st, _ = jcore.simulate_slots_batch(
            topo, sb, law, slots, cfg=cfg, record=False,
            backend="reference", expected_flows=sup.PAPER_EXPECTED_FLOWS)
        fct = np.asarray(st.fct[0], np.float32)[:size.shape[0]]
        fcts[law] = _f32_list(fct)
        stats[law] = sup.fig6_stats(fct, size)
        print(f"{law}: {stats[law]} ({time.time() - t0:.1f} s)",
              flush=True)
    data = {
        "source": "repro.core.simulate_slots_batch, backend='reference', "
                  "on the scenario of "
                  "benchmarks/fig6_fct.py::run_paper_scale (seed 1)",
        "fabric": sup.PAPER, "load": sup.PAPER_LOAD,
        "duration_s": sup.FIG6_DURATION, "dt_s": sup.PAPER_DT,
        "steps": sup.FIG6_STEPS, "hist": 512, "update_period_s": 2e-6,
        "expected_flows": sup.PAPER_EXPECTED_FLOWS, "seed": sup.FIG6_SEED,
        "slots": slots, "n_flows": int(size.shape[0]),
        "schedule_sha256": sup.schedule_checksum(np.asarray(sched.size),
                                                 np.asarray(sched.start)),
        "stats": stats, "claims_hold": sup.fig6_claims(stats),
        "fct_s": fcts,
    }
    with open(sup.FIG6_REF, "w") as f:
        json.dump(data, f)
    print(f"wrote {sup.FIG6_REF}: {data['n_flows']} flows, {slots} slots, "
          f"claims_hold {data['claims_hold']}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(REPO, "src"))
    _write_fig6_reference()
