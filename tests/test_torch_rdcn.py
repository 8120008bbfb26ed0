"""Time-varying bandwidth and reTCP (``repro_torch/core/rdcn.py``; Fig. 8,
the RDCN case study) against the JAX reference, on the CPU.

* the circuit schedule: ``circuit_up`` and ``circuit_bw_at`` against
  ``repro``'s over every tick of Fig. 8's 4 weeks, for slots 0, 6, 11
  and 23 and prebuffers 0, 600 and 1 800 us, with ``repro``'s schedule
  traced (as ``run_sweep`` runs it) and closed over as constants (as its
  serial ``simulate`` does): the classification and the rate the same
  (the phase itself is not: XLA folds a constant schedule); the
  builders (``CircuitSchedule.params``, ``stack_schedules``,
  ``voq_topology``) bit for bit;
* ``retcp_update`` against ``repro``'s under ``jax.jit`` as the engines
  compile it (the config's arrays inputs, its Python scalars constants),
  on seeded states, for both prebuffers, with the 100G/25G schedule and a
  100G/40G one (a ratio float32 does not hold exactly);
* the clean ``retcp`` leg of ``tests/golden/golden_laws.json`` through
  the padded reference engine, within ``tests/test_golden_traces.py``'s
  tolerances;
* the first 2 000 ticks of Fig. 8 (both schedules' first edges: slot 0
  at ticks 225 and 245, slot 6 at 1 470 and 1 695), slots 0 and 6 as one
  batch with ``bw_fn=circuit_bw_at`` and ``bw_params=stack_schedules``,
  for each point of the grid (``powertcp``, ``theta_powertcp``,
  ``hpcc``, ``retcp`` at 1 800 and 600 us): the padded and the slot
  reference engines bit for bit against ``repro``'s in every ``Record``
  field; the plain megakernel tick, ``gate`` True and False, bit for bit
  against the port's slot reference and ``repro``'s megakernel; the fused
  backend (the PowerTCP laws) against ``repro``'s within rtol 1e-5, tick
  by tick over the first 270 ticks and in Fig. 8's metrics over all
  2 000 (K3's sum order differs from XLA's by an ulp, and the loop grows
  that past 1e-5 soon after); the serial ``simulate``
  with ``CircuitSchedule.bw_fn()`` bit for bit against ``repro``'s serial
  run;
* Fig. 8's metrics (``circuit_utilization``, the p99 of
  ``queuing_latency_percentile``) bit for bit against ``repro``'s on the
  same record;
* K4's inputs and layout for reTCP and a schedule, and its build into a
  library per law (the CUDA kernel itself runs in
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``);
* the errors: a ``bw_fn`` with ``impair_params`` (``ValueError``), a ``bw_fn``
  vector of the wrong length, a ``bw_fn`` that K4 cannot carry, a fused
  ``retcp``.

Run as a script, this module writes ``chip_smoke.py`` phase 6d's
reference, ``tests/golden/torch_port_fig8.json``: ``repro``'s
``run_sweep`` over ``benchmarks/fig8_rdcn.py``'s grid at full size on
the CPU (per point the circuit utilization, p99 queuing latency and mean
queue of the 4 weeks and of the first week, and ``claims_hold``):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_rdcn.py
"""
import functools
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_support as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the live runs: the first 2 000 ticks of Fig. 8
TICKS = 2000
POINTS = (("powertcp", None), ("theta_powertcp", None), ("hpcc", None),
          ("retcp", 1800e-6), ("retcp", 600e-6))
POINT_IDS = [sup.fig8_point_name(law, pb) for law, pb in POINTS]
SLOTS = 8


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# -------------------------------------------------------------------------
# the schedule
# -------------------------------------------------------------------------

def _fig8_ticks():
    """t_sec of every tick of Fig. 8's 4 weeks (and 10 more), float32 as
    the engines compute it."""
    _, _, cfg, _ = sup.fig8_scenario(sup.import_repro()[0])
    T = cfg.steps + 10
    return np.arange(T, dtype=np.int32).astype(np.float32) * np.float32(1e-6)


@pytest.mark.parametrize("slot", [0, 6, 11, 23])
def test_schedule_classification_matches_repro(slot):
    import jax
    import jax.numpy as jnp
    jcore, _ = sup.import_repro()
    import repro.core.rdcn as jr
    import repro_torch.core as tc
    from repro_torch.core import rdcn
    t = _fig8_ticks()
    js, ts = jcore.CircuitSchedule(slot=slot), tc.CircuitSchedule(slot=slot)
    jp, tp = js.params(), ts.params("cpu")
    tt = torch.tensor(t)
    traced = jax.jit(lambda x, p, pb: jr.circuit_up(x + pb, p))
    for pb in (0.0, 600e-6, 1800e-6):
        got = _host(tc.circuit_up(rdcn._plus_prebuffer(tt, pb), tp))
        want_t = np.asarray(traced(jnp.asarray(t), jp, jnp.float32(pb)))
        want_c = np.asarray(jax.jit(
            lambda x, pb=pb: js.up_fn()(x + pb))(jnp.asarray(t)))
        np.testing.assert_array_equal(got, want_t, err_msg=f"traced {pb}")
        np.testing.assert_array_equal(got, want_c, err_msg=f"const {pb}")
        assert 0 < got.sum() < got.size
    # the engines add the prebuffer to a Python time in float32
    for pb in (600e-6, 1800e-6):
        np.testing.assert_array_equal(
            np.array([rdcn._plus_prebuffer(float(x), pb) for x in t[:4000]],
                     np.float32), (tt[:4000] + pb).numpy())
    got = _host(tc.circuit_bw_at(tt, tp))
    want = np.asarray(jax.jit(jax.vmap(
        lambda x, p: jr.circuit_bw_at(x, p), (0, None)))(jnp.asarray(t), jp))
    np.testing.assert_array_equal(got, want)
    want_c = np.asarray(jax.jit(jax.vmap(js.bw_fn()))(jnp.asarray(t)))
    np.testing.assert_array_equal(got, want_c)


def test_schedule_builders_match_repro():
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    scheds = [(jcore.CircuitSchedule(slot=s), tc.CircuitSchedule(slot=s))
              for s in (0, 6, 23)]
    scheds.append((jcore.CircuitSchedule(day=50e-6, night=10e-6,
                                         matchings=2, circuit_bw=5e9),
                   tc.CircuitSchedule(day=50e-6, night=10e-6, matchings=2,
                                      circuit_bw=5e9)))
    for js, ts in scheds:
        for a, b in zip(js.params(), ts.params("cpu")):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(_host(b), np.asarray(a))
        for a, b in zip(js.params(), ts.bw_fn("cpu").params):
            np.testing.assert_array_equal(_host(b), np.asarray(a))
    jst = jcore.stack_schedules([j for j, _ in scheds])
    tst = tc.stack_schedules([t for _, t in scheds], "cpu")
    assert type(tst).__name__ == "ScheduleParams"
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(_host(b), np.asarray(a))
    assert len({x.data_ptr() for x in tst}) == len(tst)
    jt, tt = (jcore.voq_topology(scheds[0][0]),
              tc.voq_topology(scheds[0][1], device="cpu"))
    for f in jt._fields:
        a, b = getattr(jt, f), getattr(tt, f)
        if isinstance(b, torch.Tensor):
            assert b.dtype == {np.float32: torch.float32,
                               np.int32: torch.int32}[np.asarray(a).dtype.type]
        np.testing.assert_array_equal(_host(b), np.asarray(a), err_msg=f)
    law = tc.make_retcp_law(scheds[0][1], 600e-6, device="cpu")
    assert law.name == "retcp" and law.masked_updates
    assert not tc.LAWS["retcp"].masked_updates


# -------------------------------------------------------------------------
# retcp_update
# -------------------------------------------------------------------------

def _retcp_inputs(sched, F=2048, H=2, seed=0):
    """Seeded inputs of one ``retcp_update`` call (numpy) and the times to
    call it at: ticks on both sides of the schedule's edges, with the
    prebuffered edge among them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    w = (np.abs(rng.standard_normal(F)) * 1e5 + 1e4).astype(f32)
    u = rng.random((F, H))
    obs = dict(q=(np.abs(rng.standard_normal((F, H))) * 1e6).astype(f32),
               qdot=np.zeros((F, H), f32), mu=np.zeros((F, H), f32),
               b=np.full((F, H), 3.125e9, f32),
               valid=rng.random((F, H)) > 0.2,
               theta=rng.uniform(24e-6, 80e-6, F).astype(f32),
               w_old=w, dt_obs=np.full(F, 1e-6, f32),
               ecn_frac=np.where(u[:, 0] < 0.3, 1.0,
                                 rng.uniform(0, 0.2, F)).astype(f32))
    tau = np.full(F, 24e-6, f32)
    cfg = dict(beta=rng.uniform(1e3, 5e4, F).astype(f32), tau=tau,
               host_bw=np.full(F, 3.125e9, f32))
    state = dict(last_cut=rng.uniform(0, 2e-3, F).astype(f32),
                 w_base=(np.abs(rng.standard_normal(F)) * 1e5 + 500.0)
                 .astype(f32))
    rate_cap = np.full(F, np.inf, f32)
    upd = rng.random(F) > 0.4
    day, night, week = sched.day, sched.night, sched.week
    edges = [sched.slot * (day + night) + k * week + e
             for k in range(2) for e in (0.0, day)]
    ts = sorted({float(f32(round((e + d) * 1e6)) * f32(1e-6))
                 for e in edges for d in (-2e-6, -1e-6, 0.0, 1e-6,
                                          -600e-6, -1800e-6)
                 if e + d >= 0})
    return obs, cfg, state, w, rate_cap, upd, ts


@pytest.mark.parametrize("packet_bw", [25e9 / 8, 40e9 / 8],
                         ids=["100G-25G", "100G-40G"])
@pytest.mark.parametrize("prebuffer", [1800e-6, 600e-6])
def test_retcp_update_matches_repro(prebuffer, packet_bw):
    """The port's ``retcp_update`` against ``repro``'s jitted with the
    schedule and the per-flow config as inputs and the prebuffer a
    constant, at times around the edges; the 100G/40G schedule (packet
    rate 40G) makes the circuit ratio inexact in float32."""
    import jax
    import jax.numpy as jnp
    sup.import_repro()
    import repro.core.laws as jl
    import repro.core.rdcn as jr
    import repro_torch.core as tc
    from repro_torch.core import laws as tl, rdcn
    js = jr.CircuitSchedule(slot=3, packet_bw=packet_bw)
    ts_ = tc.CircuitSchedule(slot=3, packet_bw=packet_bw)
    obs, cfg, state, w, rate_cap, upd, times = _retcp_inputs(ts_)

    def run(st, ob, w_, rc, up, t_, arrays, sp):
        c = jl.LawConfig()._replace(sched=sp, retcp_prebuffer=prebuffer,
                                    **arrays)
        return jr.retcp_update(st, ob, w_, rc, up, c, t_)

    jrun = jax.jit(run)
    jstate = jr.ReTCPState(jl.RenoState(jnp.asarray(state["last_cut"])),
                           jnp.asarray(state["w_base"]))
    tstate = rdcn.ReTCPState(tl.RenoState(torch.tensor(state["last_cut"])),
                             torch.tensor(state["w_base"]))
    tcfg = tc.LawConfig(sched=ts_.params("cpu"), retcp_prebuffer=prebuffer,
                        **{k: torch.tensor(v) for k, v in cfg.items()})
    scaled = set()
    for t in times:
        got_j = jrun(jstate, jl.PathObs(**{k: jnp.asarray(v)
                                          for k, v in obs.items()}),
                     jnp.asarray(w), jnp.asarray(rate_cap),
                     jnp.asarray(upd), jnp.float32(t),
                     {k: jnp.asarray(v) for k, v in cfg.items()},
                     js.params())
        got_t = tc.LAWS["retcp"].update(
            tstate, tc.PathObs(**{k: torch.tensor(v)
                                  for k, v in obs.items()}),
            torch.tensor(w), torch.tensor(rate_cap), torch.tensor(upd),
            tcfg, t)
        for (name, a), (_, b) in zip(_jax_leaves(got_j),
                                     sup.tree_leaves(tuple(got_t), "out")):
            b = _host(b)
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f"t={t} {name}")
        scaled.add(bool((_host(got_t[1]) > _host(got_t[0].w_base)).any()))
    assert scaled == {True, False}


def _jax_leaves(x, name="out"):
    """(name, numpy array) of every array of nested tuples of JAX arrays,
    in ``test_torch_support.tree_leaves``' order."""
    if isinstance(x, tuple):
        fields = getattr(x, "_fields", [str(i) for i in range(len(x))])
        return [p for f, v in zip(fields, x)
                for p in _jax_leaves(v, f"{name}.{f}")]
    return [(name, np.asarray(x))]


def test_retcp_golden_leg():
    """The clean ``retcp`` leg of the golden traces (``tools/gen_golden.py``'s
    scenario, with its 50 us / 10 us two-matching schedule as ``sched``)
    through the padded reference engine."""
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    sp = tc.CircuitSchedule(day=50e-6, night=10e-6, matchings=2).params(
        "cpu")
    got = sup.pack(*tc.simulate(topo, flows, "retcp", lcfg._replace(
        sched=sp), cfg, device="cpu"))
    sup.check_golden("retcp", got, sup.golden()["retcp"], leg="[reference]")


# -------------------------------------------------------------------------
# the engines over Fig. 8's first 2 000 ticks
# -------------------------------------------------------------------------

def _fig8_batch(core, law, pb, engine, backend="reference", **dev):
    """``core``'s run of one point of the grid over the first ``TICKS``
    ticks, slots 0 and 6 as one batch: (final state, Record)."""
    topo, flows, cfg, scheds = sup.fig8_scenario(core, **dev)
    cfg = cfg._replace(steps=TICKS)
    Q = topo.num_queues
    src = flows if engine == "padded" else core.make_schedule(flows)
    _, lcfg, bwp = sup.fig8_group(core, law, (pb,), src, scheds, **dev)
    kw = dict(bw_fn=core.circuit_bw_at, bw_params=bwp, backend=backend,
              **dev)
    if backend == "fused":
        # the fused kernels take gamma as a launch argument: each
        # scenario's paper default (a Python gamma), as run_sweep's
        # config for a law that does not read the schedule
        lcfg = None
        kw["expected_flows"] = sup.FIG8_EXPECTED_FLOWS
    if engine == "padded":
        return core.simulate_batch(topo, core.stack_flows([flows] * 2, Q),
                                   law, lcfg, cfg, **kw)
    return core.simulate_slots_batch(
        topo, core.stack_flow_schedules([src] * 2, Q), law, SLOTS, lcfg,
        cfg, **kw)


@functools.lru_cache(maxsize=None)
def _repro_run(law, pb, engine, backend="reference"):
    jcore, _ = sup.import_repro()
    st, rec = _fig8_batch(jcore, law, pb, engine, backend)
    return st, type(rec)(*[np.asarray(x) for x in rec])


@functools.lru_cache(maxsize=None)
def _port_run(law, pb, engine, backend="reference"):
    import repro_torch.core as tc
    return _fig8_batch(tc, law, pb, engine, backend, device="cpu")


def _assert_records_equal(got, want, what):
    for f in want._fields:
        g, w = _host(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: rec.{f}")


def _edges_crossed(rec):
    """Both scenarios' queues drained at the circuit's rate somewhere (the
    run crossed an up edge) and at the packet rate elsewhere."""
    thru = _host(rec.thru)[..., 0]
    for b in range(thru.shape[0]):
        assert (thru[b] > 5e9).any() and (np.abs(thru[b] - 3.125e9)
                                          < 1.0).any(), b


@pytest.mark.parametrize("engine", ["padded", "slot"])
@pytest.mark.parametrize("law,pb", POINTS, ids=POINT_IDS)
def test_live_parity_with_repro(law, pb, engine):
    _, got = _port_run(law, pb, engine)
    _, want = _repro_run(law, pb, engine)
    _assert_records_equal(got, want, f"{engine} {law} {pb}")
    _edges_crossed(got)


# gate=False runs the admit/retire pass every tick: held for the law
# whose update ``upd_mask`` gates and for reTCP, whose multiplier is not
MEGA_CASES = [(law, pb, True) for law, pb in POINTS] + [
    ("powertcp", None, False), ("retcp", 600e-6, False)]


@pytest.mark.parametrize("law,pb,gate", MEGA_CASES, ids=[
    f"{sup.fig8_point_name(law, pb)}-gate={gate}"
    for law, pb, gate in MEGA_CASES])
def test_plain_megakernel_tick_matches_slot_reference_and_repro(law, pb,
                                                                gate):
    """The plain megakernel tick (what K4 is held to on the card) reading
    the schedule every tick: every Record field and the final windows,
    rate caps and law state bit for bit the port's slot reference; the
    records bit for bit ``repro``'s megakernel."""
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    topo, flows, cfg, scheds = sup.fig8_scenario(tc, device="cpu")
    cfg = cfg._replace(steps=TICKS)
    sch = tc.make_schedule(flows)
    _, lcfg, bwp = sup.fig8_group(tc, law, (pb,), sch, scheds,
                                  device="cpu")
    sim = fluid.make_slot_sim(
        topo, tc.stack_flow_schedules([sch] * 2, topo.num_queues), law,
        SLOTS, lcfg, cfg, "megakernel", "cpu")
    st, rec = mk.simulate_slots_mega(sim, impl="torch", gate=gate,
                                     bw_fn=tc.circuit_bw_at, bw_params=bwp)
    want_st, want_rec = _port_run(law, pb, "slot")
    _assert_records_equal(rec, want_rec, f"megakernel gate={gate}")
    for (name, a), (_, b) in zip(
            sup.tree_leaves((st.w, st.rate_cap, st.q, st.law), "state"),
            sup.tree_leaves((want_st.w, want_st.rate_cap, want_st.q,
                             want_st.law), "state")):
        np.testing.assert_array_equal(_host(a), _host(b), err_msg=name)
    _, jrec = _repro_run(law, pb, "slot", "megakernel")
    _assert_records_equal(rec, jrec, f"megakernel gate={gate} vs repro")


# the fused runs held tick by tick over the whole run: K3's plain version
# sums hop-major, each hop's flows in ascending order, as ``repro``'s
# Pallas kernel does, and stays within 5.2e-6 of ``repro``'s fused run
# over all of it (the first bits differ at ticks 24-25)
FUSED_TICK_BY_TICK = TICKS


@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_fused_backend_within_rtol(law):
    """The fused backend (K1/K2's observe form and K3, their plain
    versions here; K3 sums in its own order) against ``repro``'s fused
    backend, padded, each scenario's paper default config: every Record
    field at rtol 1e-5 / atol 0.5 bytes over the first
    ``FUSED_TICK_BY_TICK`` ticks (``thru`` where neither run's queue sat
    at 0 the tick before while the other's did not), and Fig. 8's
    metrics (circuit utilization, p99 queuing latency) over all 2 000
    ticks at rtol 1e-5."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    _, got = _port_run(law, None, "padded", "fused")
    _, want = _repro_run(law, None, "padded", "fused")
    n = FUSED_TICK_BY_TICK
    for f in want._fields:
        g = _host(getattr(got, f))[:, :n]
        w = np.asarray(getattr(want, f))[:, :n]
        if f in ("t", "n_active"):
            np.testing.assert_array_equal(g, w, err_msg=f)
            continue
        if f == "thru":
            qg, qw = (np.concatenate([np.zeros_like(x[..., :1, :]),
                                      x[..., :-1, :]], -2)
                      for x in (_host(got.q)[:, :n], np.asarray(want.q)[:, :n]))
            edge = (qg > 0.0) != (qw > 0.0)
            np.testing.assert_allclose(qg[edge], qw[edge], rtol=0, atol=0.5)
            g, w = g[~edge], w[~edge]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.5, err_msg=f)
    for b, slot in enumerate(sup.FIG8_SLOTS):
        gm = sup.fig8_metrics(tc, tc.scenario(got, b),
                              tc.CircuitSchedule(slot=slot))
        wm = sup.fig8_metrics(jcore, type(want)(*[x[b] for x in want]),
                              jcore.CircuitSchedule(slot=slot))
        for k in ("util", "p99_s"):
            assert gm[k] == pytest.approx(wm[k], rel=1e-5), (slot, k)


@pytest.mark.parametrize("law,pb", [("powertcp", None), ("retcp", 600e-6)],
                         ids=["powertcp", "retcp_600us"])
def test_serial_simulate_with_a_schedule_matches_repro(law, pb):
    """``simulate(..., bw_fn=CircuitSchedule(slot=6).bw_fn())`` against
    ``repro``'s serial run, whose schedule XLA folds as constants: the
    classification, and so every Record field, the same."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    out = []
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        topo, flows, cfg, _ = sup.fig8_scenario(core, **dev)
        sch = core.CircuitSchedule(slot=6)
        kw = {} if pb is None else {"retcp_prebuffer": pb}
        lcfg = core.default_law_config(
            flows, expected_flows=sup.FIG8_EXPECTED_FLOWS,
            sched=sch.params(**dev), **kw)
        out.append(core.simulate(topo, flows, law, lcfg,
                                 cfg._replace(steps=TICKS),
                                 bw_fn=sch.bw_fn(**dev), **dev))
    want = type(out[0][1])(*[np.asarray(x) for x in out[0][1]])
    _assert_records_equal(out[1][1], want, f"serial {law}")


# -------------------------------------------------------------------------
# Fig. 8's metrics
# -------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["retcp_600us", "random"])
def test_metrics_match_repro(source):
    """``circuit_utilization`` and ``queuing_latency_percentile`` (p99, and
    the median) against ``repro``'s on the same record, bit for bit: a
    live record's first 2 000 ticks, and a seeded one as long as Fig. 8's
    run."""
    jcore, _ = sup.import_repro()
    import jax.numpy as jnp
    import repro_torch.core as tc
    if source == "random":
        rng = np.random.default_rng(3)
        T = 23520
        t = np.arange(T, dtype=np.int32).astype(np.float32) * np.float32(1e-6)
        q = np.where(rng.random(T) < 0.3, 0.0,
                     np.abs(rng.standard_normal(T)) * 3e5).astype(np.float32)
        thru = rng.choice([3.125e9, 12.5e9], T).astype(np.float32) \
            * rng.uniform(0.5, 1.0, T).astype(np.float32)
        recs = [(t, q, thru)]
    else:
        _, rec = _repro_run("retcp", 600e-6, "padded")
        recs = [(rec.t[b], rec.q[b, :, 0], rec.thru[b, :, 0])
                for b in range(2)]
    for slot in (0, 6):
        js, ts = jcore.CircuitSchedule(slot=slot), tc.CircuitSchedule(
            slot=slot)
        for t, q, thru in recs:
            tt, tq, tthru = (torch.tensor(x) for x in (t, q, thru))
            assert tc.circuit_utilization(tt, tthru, ts) == \
                jcore.circuit_utilization(jnp.asarray(t), jnp.asarray(thru),
                                          js)
            for pct in (99.0, 50.0):
                assert tc.queuing_latency_percentile(tq, tt, ts, pct) == \
                    jcore.queuing_latency_percentile(
                        jnp.asarray(q), jnp.asarray(t), js, pct), pct


# -------------------------------------------------------------------------
# K4's inputs
# -------------------------------------------------------------------------

def _k4_sim(law="retcp", pb=600e-6):
    """(the megakernel's ``SlotSim`` of one point of the grid, slots 0 and
    6 as one batch over 64 ticks; the schedules; their ``bw_params``)."""
    import repro_torch.core as tc
    from repro_torch.core import fluid
    topo, flows, cfg, scheds = sup.fig8_scenario(tc, device="cpu")
    sch = tc.make_schedule(flows)
    _, lcfg, bwp = sup.fig8_group(tc, law, (pb,), sch, scheds, device="cpu")
    sim = fluid.make_slot_sim(
        topo, tc.stack_flow_schedules([sch] * 2, topo.num_queues), law,
        SLOTS, lcfg, cfg._replace(steps=64), "megakernel", "cpu")
    return sim, scheds, bwp


def test_k4_params_carry_the_schedules():
    """K4's per-scenario bandwidth schedule and reTCP's own schedule and
    prebuffer, as float32 — from stacked ``bw_params`` and from
    ``CircuitSchedule.bw_fn()`` (shared by the batch); none without a
    ``bw_fn``."""
    import repro_torch.core as tc
    from repro_torch.core import megakernel as mk
    from repro_torch.kernels import fused_tick as ft
    sim, scheds, bwp = _k4_sim()
    p = mk.make_tick(sim, bw_fn=tc.circuit_bw_at, bw_params=bwp).k4_params()
    assert p.law == ft.LAW_NAMES.index("retcp")
    assert tuple(p.sched.shape) == (2, len(ft.SCHED_FIELDS))
    for b, sc in enumerate(scheds):
        for j, x in enumerate(sc.params("cpu")):
            assert p.sched[b, j] == x
            assert p.lawp[b, ft.LAW_PARAMS.index(
                "retcp_" + ft.SCHED_FIELDS[j])] == x
        assert p.lawp[b, ft.LAW_PARAMS.index("retcp_prebuffer")] == \
            np.float32(600e-6)
    p = mk.make_tick(sim, bw_fn=scheds[1].bw_fn("cpu")).k4_params()
    for b in range(2):
        for j, x in enumerate(scheds[1].params("cpu")):
            assert p.sched[b, j] == x
    assert mk.make_tick(sim).k4_params().sched is None


@pytest.mark.parametrize("shape", ["fig8", "fig6"])
def test_k4_layout_for_retcp(shape):
    """reTCP's working set fits in shared memory at Fig. 8's shape (8 slots
    of one hop, one VOQ) and at phase 6c's (``suggest_slots``' pool of 3
    hops over 288 queues with the paper fabric's DT fold); its state is
    ``last_cut`` and ``w_base``, its per-slot config tau and host_bw."""
    from repro_torch.kernels import fused_tick as ft
    if shape == "fig8":
        dims = (SLOTS, 1, 1, 0, 0, 1)
    else:
        with open(sup.FIG6_REF) as f:
            dims = (json.load(f)["slots"], 3, 288, 10, 34, 10)
    i = ft.LAW_NAMES.index("retcp")
    lay = ft.layout(*dims, i)
    assert lay.smem and lay.nbytes <= ft.SMEM_BUDGET, lay.nbytes
    words = dict(ft._fields(*dims, i))
    for f in ft.STATE_FIELDS:
        assert words[f] == (dims[0] if f in ("last_cut", "w_base") else 0), f
    for f in ft.CONFIG_FIELDS:
        assert words[f] == (dims[0] if f in ("ctau", "hbw") else 0), f


def test_retcp_slot_state_leaves_own_their_memory():
    """reTCP's nested state (NewReno's ``last_cut`` inside) gives K4 one
    tensor per leaf, flattened in ``STATE_FIELDS``' order."""
    from repro_torch.core import fluid
    from repro_torch.kernels import fused_tick as ft
    sim, _, _ = _k4_sim()
    leaves = ft.state_leaves(fluid.init_slot_state(sim).law)
    assert tuple(leaves) == ft.LAW_STATE["retcp"]
    assert len({x.data_ptr() for x in leaves.values()}) == 2
    assert all(tuple(x.shape) == (2, SLOTS) for x in leaves.values())


def test_k4_is_built_once_per_law():
    """K4's source is built into a library per law (``-DVARIANT=<law
    id>``), one for each of ``LAW_NAMES``, each at a path of its own."""
    from repro_torch.kernels import _build, fused_tick as ft
    names = [n for n in _build.SOURCES if n.partition("@")[0] == "fused_tick"]
    assert names == [f"fused_tick@{i}" for i in range(len(ft.LAW_NAMES))]
    assert len({_build.library_path(n) for n in names}) == len(names)


# -------------------------------------------------------------------------
# errors
# -------------------------------------------------------------------------

def test_time_varying_bandwidth_errors():
    import repro_torch.core as tc
    topo, flows, cfg, scheds = sup.fig8_scenario(tc, device="cpu")
    cfg = cfg._replace(steps=4)
    sch = tc.make_schedule(flows)
    bwp = tc.stack_schedules(scheds, "cpu")
    fb = tc.stack_flows([flows] * 2, 1)
    sb = tc.stack_flow_schedules([sch] * 2, 1)
    # a bw_fn and an impairment regime are two owners of one vector
    with pytest.raises(ValueError, match="mutually exclusive"):
        tc.simulate_batch(topo, fb, "powertcp", cfg=cfg, device="cpu",
                          bw_fn=tc.circuit_bw_at, bw_params=bwp,
                          impair_params=tc.no_impairment(topo))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tc.simulate_slots(topo, sch, "powertcp", SLOTS, cfg=cfg,
                          bw_fn=scheds[0].bw_fn("cpu"),
                          impair=tc.no_impairment(topo), device="cpu")
    two = lambda t: torch.full((2,), 3.125e9)  # noqa: E731
    with pytest.raises(ValueError, match="1 queues"):
        tc.simulate(topo, flows, "powertcp", cfg=cfg, bw_fn=two,
                    device="cpu")
    for backend in ("reference", "megakernel"):
        with pytest.raises(ValueError, match="1 queues"):
            tc.simulate_slots_batch(topo, sb, "powertcp", SLOTS, cfg=cfg,
                                    bw_fn=two, backend=backend,
                                    device="cpu")
    with pytest.raises(ValueError, match="needs a bw_fn"):
        tc.simulate_batch(topo, fb, "powertcp", cfg=cfg, bw_params=bwp,
                          device="cpu")
    with pytest.raises(KeyError):
        tc.get_law("retcp", "fused")


def test_k4_refuses_a_bandwidth_it_cannot_carry():
    """On the card the megakernel runs K4 only; K4 evaluates a circuit
    schedule and nothing else, so another ``bw_fn`` raises when K4's
    inputs are built (checked here without a card)."""
    import repro_torch.core as tc
    from repro_torch.core import megakernel as mk
    sim, _, _ = _k4_sim()
    for bw_fn, bw_params in ((lambda t: torch.full((1,), 3.125e9), None),
                             (lambda t, p: tc.circuit_bw_at(t, p),
                              tc.stack_schedules(
                                  [tc.CircuitSchedule()] * 2, "cpu"))):
        tick = mk.make_tick(sim, bw_fn=bw_fn, bw_params=bw_params)
        with pytest.raises(NotImplementedError, match="circuit schedule"):
            tick.k4_params()


# -------------------------------------------------------------------------
# phase 6d's reference data
# -------------------------------------------------------------------------

def _write_fig8_reference():
    """``fig8_rdcn.run(quick=False)``'s grid through ``repro``'s
    ``run_sweep`` on the CPU, written to tests/golden/torch_port_fig8.json
    (per point the metrics of the 4 weeks and of the first week)."""
    jcore, _ = sup.import_repro()
    sys.path.insert(0, REPO)
    from benchmarks.fig8_rdcn import point_name, rdcn_setup, rdcn_specs
    topo, flows, cfg, scheds = rdcn_setup(weeks=sup.FIG8_WEEKS,
                                          slots=sup.FIG8_SLOTS)
    week = int(scheds[0].week / cfg.dt)
    points, rows = [], {}
    t0 = time.time()
    for spec in rdcn_specs(flows, scheds):
        res = jcore.run_sweep(spec, topo, cfg)
        for p in res.points:
            rec = res.record(p.index)
            sch = scheds[p.sched_idx]
            whole = sup.fig8_metrics(jcore, rec, sch)
            first = sup.fig8_metrics(jcore, rec, sch, week)
            row = dict(name=point_name(spec, p), slot=sch.slot, **whole,
                       week1_util=first["util"], week1_p99_s=first["p99_s"])
            points.append(row)
            if sch.slot == 0:
                rows[row["name"]] = whole
            print(row, flush=True)
    data = {
        "source": "repro.core.run_sweep over benchmarks/fig8_rdcn.py's "
                  "rdcn_specs (rdcn_setup(weeks=4, slots=(0, 6))), "
                  "padded engine, reference backend, on the CPU",
        "steps": cfg.steps, "dt_s": cfg.dt, "hist": cfg.hist,
        "week_ticks": week, "slots": list(sup.FIG8_SLOTS),
        "prebuffers_s": list(sup.FIG8_PREBUFFERS),
        "expected_flows": sup.FIG8_EXPECTED_FLOWS,
        "claims_hold": sup.fig8_claims(rows), "points": points,
    }
    with open(sup.FIG8_REF, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {sup.FIG8_REF}: {len(points)} points, claims_hold "
          f"{data['claims_hold']} ({time.time() - t0:.1f} s)")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(REPO, "src"))
    _write_fig8_reference()
