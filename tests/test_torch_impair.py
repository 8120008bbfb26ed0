"""The port's per-link impairment layer (``repro_torch/core/impair.py``)
against ``repro.core.impair``, on the CPU.

* the evaluators (``_mix32``, ``_u01``, ``link_bw_at``, ``link_loss_at``,
  ``link_jitter_at``, ``impair_vectors``) bit for bit ``repro``'s, jitted
  as its engines run them (the regime an input, or closed over as a
  constant), over every process and loss kind, epoch knife edges, times
  before ``t0``, a zero ``period``, the epoch's saturating conversion, a
  ``qid0`` row slice and [B, Q] leaves;
* ``tests/test_property_impair.py``'s invariants on the port: envelopes,
  determinism, independence of evaluation order and batching,
  decorrelation, the zero preset's bitwise identity and
  ``schedule_impairment`` equal to ``rdcn.circuit_bw_at``;
* ``fabric_impairments`` (explicit rules and the classes a
  ``FabricBuilder`` declares) equal to ``repro``'s, field for field;
* the entry points' rejections: the fused backend (``UnsupportedFeature``)
  and ``bw_fn`` with ``impair`` (``ValueError``);
* the ``"impair"`` leg of ``tests/golden/golden_laws.json`` for all 13
  laws through the padded reference engine, within
  ``tests/test_golden_traces.py``'s tolerances, and different from the
  clean leg.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_support as sup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GBPS, US = 1.25e8, 1e-6


def _repro_impair():
    sup.import_repro()
    from repro.core import impair
    return impair


def _regimes(n=48, seed=0):
    """(repro's regime, the port's) of ``_procs``."""
    ri = _repro_impair()
    from repro_torch.core import impair as ti
    rows, bw = sup.impair_kind_rows(n, seed)
    rp = ri._params_from_procs([ri.LinkProcess(**r) for r in rows], bw)
    tp = ti._params_from_procs([ti.LinkProcess(**r) for r in rows], bw,
                               device="cpu")
    return rp, tp


def _times():
    """Tick times (float32 products, as the engines compute them), times
    on epoch edges and off them, and a few far ones."""
    ticks = np.arange(0, 1200, 7).astype(np.float32) * np.float32(1e-6)
    extra = np.array([-5e-4, -1e-7, 0.0, 1e-7, 2.5e-6, 0.13, 3.0, 1e3],
                     np.float32)
    return [float(t) for t in np.concatenate([ticks, extra])]


def _equal(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def test_regime_fields_match_repro():
    """``_params_from_procs`` builds ``repro``'s rows, field for field."""
    rp, tp = _regimes()
    for f, a, b in zip(tp._fields, tp, rp):
        _equal(a, np.asarray(b).astype(np.int64) if f == "seed"
               else np.asarray(b), f)
        assert a.dtype == {"kind": torch.int32, "loss_kind": torch.int32,
                           "seed": torch.int64}.get(f, torch.float32), f


def test_mix32_and_draws_bit_for_bit():
    """``_mix32`` over edge and random uint32 values, and ``_u01`` of each
    salt, equal to ``repro``'s under ``jax.jit``."""
    import jax
    import jax.numpy as jnp
    ri = _repro_impair()
    from repro_torch.core import impair as ti
    rng = np.random.default_rng(1)
    xs = np.concatenate([np.array([0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1,
                                   2 ** 31, 2 ** 32 - 1, 0x7feb352d,
                                   0x846ca68b, 0x9E3779B9], np.uint32),
                         rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)])
    want = np.asarray(jax.jit(ri._mix32)(jnp.asarray(xs)))
    _equal(ti._mix32(torch.as_tensor(xs.astype(np.int64))),
           want.astype(np.int64), "_mix32")
    rp, tp = _regimes()
    u = jax.jit(lambda t, p, salt=0: ri._u01(t, p, salt),
                static_argnums=2)
    for salt in (ri._SALT_BW, ri._SALT_LOSS, ri._SALT_JIT):
        for t in _times()[::9]:
            _equal(ti._u01(t, tp, salt),
                   u(jnp.float32(t), rp, salt), f"_u01 salt {salt} t {t}")


@pytest.mark.parametrize("form", ["traced", "constant"])
def test_evaluators_bit_for_bit(form):
    """``link_bw_at``, ``link_loss_at``, ``link_jitter_at`` and
    ``impair_vectors`` equal ``repro``'s at every time of ``_times``, with
    the regime an input of the jitted function (the batched engines) or
    closed over as a constant (``simulate``)."""
    import jax
    import jax.numpy as jnp
    ri = _repro_impair()
    from repro_torch.core import impair as ti
    rp, tp = _regimes()

    def all_of(t, p):
        keep, jit = ri.impair_vectors(t, p)
        return (ri.link_bw_at(t, p), ri.link_loss_at(t, p),
                ri.link_jitter_at(t, p), keep, jit)
    f = (jax.jit(all_of) if form == "traced"
         else jax.jit(lambda t: all_of(t, rp)))
    for t in _times():
        want = f(jnp.float32(t), rp) if form == "traced" else f(
            jnp.float32(t))
        keep, jit = ti.impair_vectors(t, tp)
        got = (ti.link_bw_at(t, tp), ti.link_loss_at(t, tp),
               ti.link_jitter_at(t, tp), keep, jit)
        for name, g, w in zip(("bw", "loss", "jitter", "keep", "jit"), got,
                              want):
            _equal(g, w, f"{name} at t={t!r}")


def test_epoch_edges_and_saturation():
    """Epochs at tick edges (period one tick, phases on and just off a
    tick), before ``t0`` (a negative epoch wraps through uint32), and far
    outside int32 (``t0`` of +-1e9 s, +-inf and NaN): the conversion
    saturates and takes NaN to 0, as XLA's does."""
    import jax
    import jax.numpy as jnp
    ri = _repro_impair()
    from repro_torch.core import impair as ti
    rows = [dict(kind="fading", bw_lo=1e9, bw_hi=2e9, period=p, t0=t0,
                 loss=0.3, random_loss=True, jitter=1e-6, seed=s)
            for s, (p, t0) in enumerate([
                (1e-6, 0.0), (1e-6, 1e-7), (1e-6, -1e-7), (1e-6, 5e-4),
                (3e-6, 1e-6), (1e-6, 1e9), (1e-6, -1e9), (0.0, 2e-6)])]
    bw = np.full(len(rows), 3e9, np.float32)
    rp = ri._params_from_procs([ri.LinkProcess(**r) for r in rows], bw)
    tp = ti._params_from_procs([ti.LinkProcess(**r) for r in rows], bw,
                               device="cpu")
    t0s = np.array([np.inf, -np.inf, np.nan, 0.0], np.float32)
    rp = rp._replace(t0=jnp.concatenate([rp.t0, jnp.asarray(t0s)]),
                     **{f: jnp.concatenate([getattr(rp, f),
                                            getattr(rp, f)[:4]])
                        for f in rp._fields if f != "t0"})
    tp = tp._replace(t0=torch.cat([tp.t0, torch.as_tensor(t0s)]),
                     **{f: torch.cat([getattr(tp, f), getattr(tp, f)[:4]])
                        for f in tp._fields if f != "t0"})
    ep = jax.jit(ri._epoch)
    for t in _times() + [float(np.float32(k) * np.float32(1e-6))
                         for k in range(495, 506)]:
        _equal(ti._epoch(t, tp),
               np.asarray(ep(jnp.float32(t), rp)).astype(np.int64),
               f"epoch at t={t!r}")
    e = ti._epoch(0.0, tp)
    assert e[5] == 2 ** 31 and e[6] == 2 ** 31 - 1
    assert e[8] == 2 ** 31 and e[9] == 2 ** 31 - 1 and e[10] == 0


def test_qid0_slice_and_batched_leaves():
    """A row slice evaluated at its ``qid0`` is the slice of the full
    evaluation (``repro``'s too); a stacked [B, Q] regime evaluates each
    row as the regime alone."""
    import jax.numpy as jnp
    ri = _repro_impair()
    from repro_torch.core import impair as ti
    rp, tp = _regimes()
    lo, hi = 13, 29
    sl = ti.ImpairmentParams(*[x[lo:hi] for x in tp])
    rsl = ri.ImpairmentParams(*[x[lo:hi] for x in rp])
    for t in _times()[::5]:
        for fn, rfn in ((ti.link_bw_at, ri.link_bw_at),
                        (ti.link_loss_at, ri.link_loss_at),
                        (ti.link_jitter_at, ri.link_jitter_at)):
            full = fn(t, tp)
            part = fn(t, sl, qid0=lo)
            _equal(part, full[lo:hi].numpy(), f"{fn.__name__} slice")
            _equal(part, rfn(jnp.float32(t), rsl, qid0=lo),
                   f"{fn.__name__} slice against repro")
    _, tp2 = _regimes(seed=1)
    st = ti.stack_impairments([tp, tp2])
    for t in _times()[::11]:
        keep, jit = ti.impair_vectors(t, st)
        assert tuple(keep.shape) == (2, 49)
        for b, p in enumerate((tp, tp2)):
            k1, j1 = ti.impair_vectors(t, p)
            _equal(ti.link_bw_at(t, st)[b], ti.link_bw_at(t, p).numpy(),
                   "batched bw")
            _equal(keep[b], k1.numpy(), "batched keep")
            _equal(jit[b], j1.numpy(), "batched jit")


# -------------------------------------------------------------------------
# tests/test_property_impair.py's invariants on the port
# -------------------------------------------------------------------------

def _grid_params():
    from repro_torch.core import impair as ti
    procs = [
        ti.LinkProcess(),
        ti.LinkProcess(kind="const", bw_hi=5 * GBPS, loss=0.02,
                       jitter=2e-6),
        ti.LinkProcess(kind="schedule", bw_hi=100 * GBPS, bw_lo=25 * GBPS,
                       period=245 * US, up=225 * US, t0=40 * US),
        ti.LinkProcess(kind="oscillate", bw_lo=2.5e9, period=200e-6,
                       seed=5),
        ti.LinkProcess(kind="fading", bw_hi=25 * GBPS, bw_lo=5 * GBPS,
                       period=50e-6, seed=11),
        ti.netem(loss=0.1, jitter=5e-6, seed=9),
        ti.netem(loss=0.3, jitter=0.0, random_loss=False, seed=3),
    ]
    return ti._params_from_procs(procs, np.full(len(procs), 3.125e9,
                                                np.float32), device="cpu")


TS = [float(t) for t in np.concatenate([np.linspace(0.0, 2e-3, 97),
                                        np.linspace(0.0, 10.0, 23)])
      .astype(np.float32)]


def test_envelopes():
    """Capacity inside [min, max] of the process's rates and finite (an
    untaken branch's NaN never leaks), loss in [0, LOSS_MAX], jitter in
    [0, jitter]."""
    from repro_torch.core import impair as ti
    p = _grid_params()
    lo = torch.minimum(p.bw_lo, p.bw_hi)
    hi = torch.maximum(p.bw_lo, p.bw_hi)
    for t in TS:
        bw = ti.link_bw_at(t, p)
        assert torch.isfinite(bw).all()
        assert (bw >= lo - 1e-3).all() and (bw <= hi + 1e-3).all()
        loss = ti.link_loss_at(t, p)
        assert (loss >= 0.0).all() and (loss <= ti.LOSS_MAX).all()
        jit = ti.link_jitter_at(t, p)
        assert (jit >= 0.0).all() and (jit <= p.jitter + 1e-12).all()


def test_determinism_order_and_batching():
    """The same (seed, t) gives the same bits again, in reverse time
    order, and in every row of a stacked regime."""
    from repro_torch.core import impair as ti
    p = _grid_params()
    for t in TS[::7]:
        assert torch.equal(ti.link_bw_at(t, p), ti.link_bw_at(t, p))
        (ka, ja), (kb, jb) = ti.impair_vectors(t, p), ti.impair_vectors(t, p)
        assert torch.equal(ka, kb) and torch.equal(ja, jb)
    fwd = [ti.link_jitter_at(t, p) for t in TS[:20]]
    rev = [ti.link_jitter_at(t, p) for t in TS[:20][::-1]][::-1]
    assert all(torch.equal(a, b) for a, b in zip(fwd, rev))
    st = ti.stack_impairments([p, p, p])
    one = ti.link_bw_at(TS[5], p)
    for row in ti.link_bw_at(TS[5], st):
        assert torch.equal(row, one)


def test_seeds_and_channels_decorrelate():
    from repro_torch.core import impair as ti
    a = ti._params_from_procs(
        [ti.LinkProcess(kind="fading", bw_hi=2.0, bw_lo=1.0, period=1e-6,
                        loss=0.5, random_loss=True, jitter=1.0, seed=1)] * 4,
        np.full(4, 3.125e9, np.float32), device="cpu")
    b = a._replace(seed=(a.seed + 1) & 0xFFFFFFFF)
    ts = TS[:50]
    bw_a = torch.stack([ti.link_bw_at(t, a) for t in ts])
    bw_b = torch.stack([ti.link_bw_at(t, b) for t in ts])
    assert not torch.equal(bw_a, bw_b)
    u_loss = torch.stack([ti.link_loss_at(t, a) for t in ts]) / 0.5
    u_jit = torch.stack([ti.link_jitter_at(t, a) for t in ts])
    assert not torch.allclose(bw_a - 1.0, u_loss, atol=1e-3)
    assert not torch.allclose(bw_a - 1.0, u_jit, atol=1e-3)
    assert not torch.allclose(bw_a[:, 0], bw_a[:, 1], atol=1e-3)


def test_zero_preset_is_bitwise_identity():
    import repro_torch.core as tc
    topo = tc.fat_tree(4).topology(device="cpu")
    z = tc.no_impairment(topo)
    for t in TS[::11]:
        assert torch.equal(tc.link_bw_at(t, z), topo.bandwidth)
        keep, jit = tc.impair_vectors(t, z)
        assert (keep == 1.0).all() and (jit == 0.0).all()
        assert not torch.signbit(jit).any()


def test_schedule_impairment_is_circuit_bw_at():
    """``link_bw_at`` of ``schedule_impairment(p)`` equals
    ``rdcn.circuit_bw_at(t, p)`` bit for bit, over weeks and on the
    day/night edges."""
    import repro_torch.core as tc
    for sched in (tc.CircuitSchedule(day=50 * US, night=10 * US,
                                     matchings=4),
                  tc.CircuitSchedule(slot=6)):
        sp = sched.params("cpu")
        imp = tc.schedule_impairment(sp)
        step = sched.day + sched.night
        ts = np.concatenate([np.linspace(0.0, 3 * sched.week, 301),
                             np.arange(12) * step,
                             np.arange(12) * step + sched.day]
                            ).astype(np.float32)
        for t in ts:
            assert torch.equal(tc.link_bw_at(float(t), imp),
                               tc.circuit_bw_at(float(t), sp)), float(t)


# -------------------------------------------------------------------------
# fabric classes
# -------------------------------------------------------------------------

def test_fabric_impairments_match_repro():
    """``fabric_impairments`` with rules and a default, and with the
    classes a builder declares (``impair_class``; the last declaration of
    a class wins), on the k = 4 fat tree and the paper's leaf-spine, field
    for field ``repro``'s."""
    jcore, _ = sup.import_repro()
    ri = _repro_impair()
    from repro.core import fabric as rf
    import repro_torch.core as tc
    from repro_torch.core import fabric as tf, impair as ti
    osc = dict(kind="oscillate", bw_lo=2.5e9, period=200e-6, seed=5)
    lossy = dict(loss=0.01, jitter=1e-6, seed=9)
    for build in ("fat_tree", "leaf_spine"):
        out = []
        for core, fab_mod, imp, dev in ((jcore, rf, ri, {}),
                                        (tc, tf, ti, {"device": "cpu"})):
            fab = (core.fat_tree(4) if build == "fat_tree" else
                   fab_mod.leaf_spine_fabric(racks=8, hosts_per_rack=32,
                                             spines=2))
            out.append(imp.fabric_impairments(
                fab, rules={(fab_mod.TOR, fab_mod.HOST):
                            imp.LinkProcess(**osc)},
                default=imp.netem(**lossy), **dev))
        for f, a, b in zip(ti.ImpairmentParams._fields, out[1], out[0]):
            _equal(a, np.asarray(b).astype(np.int64) if f == "seed"
                   else np.asarray(b), f"{build} {f}")
    regs = []
    for fab_mod, imp, dev in ((rf, ri, {}), (tf, ti, {"device": "cpu"})):
        b = fab_mod.FabricBuilder("two-tier")
        hosts = [b.add_host() for _ in range(4)]
        tor = b.add_switch(fab_mod.TOR, 4e6)
        spine = b.add_switch(fab_mod.AGG, 4e6)
        for h in hosts:
            b.add_link(h, tor, 25 * GBPS, 1e-6)
            b.add_link(tor, h, 25 * GBPS, 1e-6, buffer=1e6)
        b.add_link(tor, spine, 100 * GBPS, 1e-6, buffer=1e6)
        b.add_link(spine, tor, 100 * GBPS, 1e-6, buffer=1e6)
        b.impair_class(fab_mod.TOR, fab_mod.HOST, imp.netem(loss=0.5))
        b.impair_class(fab_mod.TOR, fab_mod.HOST, imp.LinkProcess(**osc))
        b.impair_class(fab_mod.AGG, fab_mod.TOR, imp.netem(**lossy))
        fab = b.build()
        assert len(fab.impair_rules) == 2
        regs.append(imp.fabric_impairments(fab, **dev))
    for f, a, b in zip(ti.ImpairmentParams._fields, regs[1], regs[0]):
        _equal(a, np.asarray(b).astype(np.int64) if f == "seed"
               else np.asarray(b), f"builder classes {f}")


def test_link_process_validation():
    from repro_torch.core import impair as ti
    for kw in (dict(kind="bogus"), dict(loss=1.0), dict(jitter=-1.0),
               dict(kind="oscillate"), dict(kind="schedule", period=1e-6,
                                            up=2e-6)):
        with pytest.raises(ValueError):
            ti.LinkProcess(**kw)
    with pytest.raises(ValueError, match="processes"):
        ti._params_from_procs([ti.LinkProcess()], np.ones(2, np.float32),
                              device="cpu")


# -------------------------------------------------------------------------
# the entry points' rejections
# -------------------------------------------------------------------------

def test_rejections():
    """The fused backend rejects a regime on every entry point with the
    port's ``UnsupportedFeature`` (a ``NotImplementedError``, with
    ``repro``'s hint); ``bw_fn`` with ``impair`` raises ``ValueError``;
    so does a regime of the wrong width."""
    import repro_torch.core as tc
    from repro_torch.core import fluid
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    cfg = cfg._replace(steps=4)
    z = tc.no_impairment(topo)
    sch = tc.make_schedule(flows)
    fb, sb = tc.batch_of_one(flows), tc.batch_of_one(sch)
    bw_fn = tc.CircuitSchedule().bw_fn("cpu")
    calls = {
        "simulate": lambda **kw: tc.simulate(topo, flows, "powertcp",
                                             lcfg, cfg, impair=z,
                                             device="cpu", **kw),
        "simulate_slots": lambda **kw: tc.simulate_slots(
            topo, sch, "powertcp", 4, lcfg, cfg, impair=z, device="cpu",
            **kw),
        "simulate_batch": lambda **kw: tc.simulate_batch(
            topo, fb, "powertcp", cfg=cfg, impair_params=z, device="cpu",
            **kw),
        "simulate_slots_batch": lambda **kw: tc.simulate_slots_batch(
            topo, sb, "powertcp", 4, cfg=cfg, impair_params=z,
            device="cpu", **kw),
    }
    for name, call in calls.items():
        with pytest.raises(fluid.UnsupportedFeature) as e:
            call(backend="fused")
        assert isinstance(e.value, NotImplementedError), name
        assert e.value.hint == "use the reference or megakernel backend"
        assert "fused backend" in str(e.value)
        for backend in ("reference", "megakernel"):
            with pytest.raises(ValueError, match="mutually exclusive"):
                call(backend=backend, bw_fn=bw_fn)
    wide = tc.stack_impairments([z, z, z])
    with pytest.raises(ValueError, match="impairment regime of shape"):
        tc.simulate_batch(topo, fb, "powertcp", cfg=cfg, impair_params=wide,
                          device="cpu")
    src = open(os.path.join(REPO, "src", "repro_torch", "core",
                            "fluid.py")).read()
    assert '_unported("impair' not in src


# -------------------------------------------------------------------------
# the golden "impair" legs
# -------------------------------------------------------------------------

def test_golden_regime_is_gen_golden_s():
    sys.path.insert(0, REPO)
    sup.import_repro()
    from tools.gen_golden import impair_regime, scenario
    rp = impair_regime(scenario()[0])
    import repro_torch.core as tc
    topo = sup.golden_scenario(tc, device="cpu")[0]
    for f, a, b in zip(rp._fields, sup.golden_impair_regime(
            tc, topo, device="cpu"), rp):
        _equal(a, np.asarray(b).astype(np.int64) if f == "seed"
               else np.asarray(b), f)


@pytest.mark.parametrize("law", sorted(sup.golden()))
def test_golden_impair_leg(law):
    """The ``"impair"`` leg of the golden traces (the single bottleneck
    under the mixed regime: an oscillating capacity, 1% random loss, 1 us
    jitter) through the port's padded reference engine, within
    ``_check``'s tolerances; it must differ from the clean leg."""
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    if law == "retcp":
        lcfg = lcfg._replace(sched=tc.CircuitSchedule(
            day=50e-6, night=10e-6, matchings=2).params("cpu"))
    got = sup.pack(*tc.simulate(topo, flows, law, lcfg, cfg,
                                impair=sup.golden_impair_regime(
                                    tc, topo, device="cpu"), device="cpu"))
    want = sup.golden()[law]
    sup.check_golden(law, got, want["impair"], leg="[impair]")
    assert got["q"] != want["q"], f"{law}: the regime was a no-op"


def test_evaluators_take_a_column_of_tick_times():
    """Evaluated at a [T, 1] column of tick times (as ``chip_smoke.py``
    holds K4's evaluation over a run), each row is the evaluation at that
    tick's Python time bit for bit, for each of the fat tree's regimes."""
    import repro_torch.core as tc
    regs = tc.stack_impairments(list(sup.impair_regimes(
        tc, tc.fat_tree(4), device="cpu").values()))
    T = 1200
    t = (torch.arange(T).to(torch.float32) * 1e-6)[:, None]
    for b in range(int(regs.kind.shape[0])):
        p = tc.ImpairmentParams(*[x[b] for x in regs])
        keep, jit = tc.impair_vectors(t, p)
        bw = tc.link_bw_at(t, p)
        for i in range(0, T, 13):
            ts = float(np.float32(i) * np.float32(1e-6))
            k1, j1 = tc.impair_vectors(ts, p)
            assert torch.equal(bw[i], tc.link_bw_at(ts, p)), (b, i)
            assert torch.equal(keep[i], k1) and torch.equal(jit[i], j1)
