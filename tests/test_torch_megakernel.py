"""The port's megakernel backend against the JAX reference, on the CPU.

Mirrors ``tests/test_megakernel.py`` at its sizes (the 12-flow
single-bottleneck anchor of 4 000 ticks, S = 1, S < N, record_every > 1):

* the port's megakernel (the plain tick; K4 runs only on the card) equals
  the port's slot reference backend bit for bit: queue trace, FCTs,
  windows, per-slot rates and rings, for PowerTCP and theta-PowerTCP;
* it equals ``repro``'s ``simulate_slots(backend="megakernel")`` (the XLA
  lowering) bit for bit on the same inputs, made with numpy from a seed,
  and ``repro``'s Pallas lowering in interpret mode on a short case;
* the ported helpers (``suggest_maxdeg``, ``stable_sort_ids``,
  ``seg_ranks``, ``build_csr_gather``, ``integrate_arrivals``,
  ``queue_arrivals_sparse``, ``_due_table``) and the Dynamic-Thresholds
  caps equal ``repro``'s bit for bit;
* the new modules import neither ``jax`` nor ``repro``.

``repro`` is imported only through ``test_torch_support.import_repro``.
Runs are cached per module, so tests that compare the same run share it.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_support as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAWS = ("powertcp", "theta_powertcp")


def _jqa():
    """``repro.kernels.queue_arrivals`` (the module; the package exports a
    function of the same name)."""
    import importlib
    sup.import_repro()
    return importlib.import_module("repro.kernels.queue_arrivals")


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


_staggered = sup.staggered
_single_slot = sup.single_slot


# case -> (scenario builder, slots, steps, record_every)
CASES = {
    "anchor": (_staggered, 6, 4000, 0),      # S < N: slots recycled
    "single_slot": (_single_slot, 1, 4000, 0),
    "record_every": (_staggered, 16, 2000, 10),
}


def _scenario(core, case, **dev):
    build, slots, steps, re = CASES[case]
    if build is _staggered:
        topo, sched, cfg = build(core, steps=steps, **dev)
    else:
        topo, sched, cfg = build(core, **dev)
    return topo, sched, cfg._replace(record_every=re), slots


@functools.lru_cache(maxsize=None)
def _port(case, law, backend, block=None):
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    topo, sched, cfg, slots = _scenario(tc, case, device="cpu")
    lcfg = tc.default_law_config(sched, expected_flows=8.0)
    if block is None:
        st, rec = tc.simulate_slots(topo, sched, law, slots, lcfg, cfg,
                                    backend=backend, device="cpu")
        return st, rec
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), law, slots,
                              tc.batch_of_one(lcfg), cfg, backend, "cpu")
    with torch.no_grad():
        st, rec = tc.scenario(mk.simulate_slots_mega(sim, block=block), 0)
    return st._replace(fct=st.fct[:fluid._slot_n(sim)]), rec


@functools.lru_cache(maxsize=None)
def _jax(case, law):
    jcore, _ = sup.import_repro()
    topo, sched, cfg, slots = _scenario(jcore, case)
    lcfg = jcore.default_law_config(jcore.schedule_as_flows(sched),
                                    expected_flows=8.0)
    return jcore.simulate_slots(topo, sched, law, slots, lcfg, cfg,
                                backend="megakernel")


def _assert_bitwise(got, want, rings=True):
    st_g, rec_g = got
    st_w, rec_w = want
    for f in rec_w._fields:     # every Record field
        np.testing.assert_array_equal(_host(getattr(rec_g, f)),
                                      np.asarray(getattr(rec_w, f)),
                                      err_msg=f"record {f}")
    fct = _host(st_g.fct)
    np.testing.assert_array_equal(fct, np.asarray(st_w.fct),
                                  err_msg="fct")
    assert np.isfinite(fct).sum() >= 3, "scenario completes too few flows"
    for f in ("w", "q", "remaining") + (
            ("hist_q", "hist_out", "hist_lam", "hist_w") if rings else ()):
        np.testing.assert_array_equal(_host(getattr(st_g, f)),
                                      np.asarray(getattr(st_w, f)),
                                      err_msg=f"state {f}")


# -------------------------------------------------------------------------
# the plain megakernel against the port's slot reference and repro
# -------------------------------------------------------------------------

@pytest.mark.parametrize("law,case", [
    ("powertcp", "anchor"), ("theta_powertcp", "anchor"),
    ("powertcp", "single_slot"), ("powertcp", "record_every")])
def test_megakernel_equals_slot_reference(law, case):
    _assert_bitwise(_port(case, law, "megakernel"),
                    _port(case, law, "reference"))


@pytest.mark.parametrize("law", LAWS)
def test_megakernel_equals_repro_megakernel(law):
    _assert_bitwise(_port("anchor", law, "megakernel"), _jax("anchor", law))


def test_block_size_never_changes_the_result():
    """K = 7 puts block edges on ~570 ticks of the 4 000-tick anchor, and
    4 000 % 64 != 0 runs the remainder block (the default K above)."""
    _assert_bitwise(_port("anchor", "powertcp", "megakernel", block=7),
                    _port("anchor", "powertcp", "reference"))


def test_record_every_rows():
    _, rec = _port("record_every", "powertcp", "megakernel")
    assert rec.q.shape[0] == 200


def test_megakernel_equals_repro_pallas_interpret():
    """``repro``'s Pallas whole-tick kernel in interpret mode (as
    ``tests/test_megakernel.py`` runs it), 600 ticks in blocks of 64 with a
    remainder, against the port's plain tick in the same blocks."""
    jcore, _ = sup.import_repro()
    from repro.core.fluid import SlotSim, _resolve_law
    from repro.core.megakernel import simulate_slots_mega as jmega
    import repro_torch.core as tc
    topo, sched, cfg = _staggered(jcore, steps=600)
    lcfg = jcore.default_law_config(jcore.schedule_as_flows(sched),
                                    expected_flows=8.0)
    sim = SlotSim(topo, sched, _resolve_law("powertcp", "megakernel"), lcfg,
                  cfg, 16, "megakernel")
    want = jmega(sim, record=True, impl="pallas", block=64)
    topo, sched, cfg = _staggered(tc, steps=600, device="cpu")
    got = tc.simulate_slots(topo, sched, "powertcp", 16,
                            tc.default_law_config(sched, expected_flows=8.0),
                            cfg, backend="megakernel", device="cpu")
    n = int(sched.start.shape[0])
    _assert_bitwise(got, (want[0]._replace(fct=want[0].fct[:n]), want[1]))


@pytest.mark.parametrize("law", LAWS)
def test_gather_table_overflow_equals_slot_reference(law):
    """A gather table two entries wide overflows once three slots share
    the bottleneck: the plain tick then sums arrivals with the in-order
    walk of the hop list (``ordered_scatter_add``), which must give the
    slot reference's trajectory bit for bit."""
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    topo, sched, cfg, slots = _scenario(tc, "anchor", device="cpu")
    lcfg = tc.default_law_config(sched, expected_flows=8.0)
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), law, slots,
                              tc.batch_of_one(lcfg), cfg, "megakernel",
                              "cpu")
    tick = mk.make_tick(sim, maxdeg=2)
    due = torch.as_tensor(mk._due_table(sim.sched, int(cfg.steps), cfg.dt))
    with torch.no_grad():
        carry, rec, n_ovf = sup.plain_ticks(
            tick, tick.init_carry(fluid.init_slot_state(sim)), due)
    assert n_ovf > 1000, n_ovf
    N = fluid._slot_n(sim)
    st, rec = tc.scenario((mk._unpack_state(carry, N, topo.num_queues + 1),
                           rec), 0)
    _assert_bitwise((st._replace(fct=st.fct[:N]), rec),
                    _port("anchor", law, "reference"))


def test_quiet_and_ungated_ticks_equal_the_gated_tick():
    """The plain tick's ``quiet`` fast path and the ungated pass (the
    admit/retire pass every tick) change nothing."""
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    topo, sched, cfg, slots = _scenario(tc, "single_slot", device="cpu")
    lcfg = tc.default_law_config(sched, expected_flows=8.0)
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), "powertcp",
                              slots, tc.batch_of_one(lcfg),
                              cfg._replace(steps=1200), "megakernel", "cpu")
    with torch.no_grad():
        base = tc.scenario(mk.simulate_slots_mega(sim), 0)
        for kw in (dict(quiet=True), dict(gate=False)):
            _assert_bitwise(tc.scenario(mk.simulate_slots_mega(sim, **kw),
                                        0), base)


def test_padded_engine_runs_megakernel_as_reference():
    """As in ``repro``, the padded engine takes ``backend="megakernel"`` and
    runs the reference ops (the whole-tick engine is a slot path)."""
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    a = tc.simulate(topo, flows, "powertcp", lcfg, cfg, device="cpu")
    b = tc.simulate(topo, flows, "powertcp", lcfg, cfg,
                    backend="megakernel", device="cpu")
    _assert_bitwise(b, a, rings=False)


def test_every_law_has_a_megakernel_backend():
    import repro_torch.core as tc
    for name in tc.LAWS:
        assert "megakernel" in tc.law_backends(name)
        law = tc.get_law(name, "megakernel")
        assert law.backend == "megakernel"
        assert law.update is tc.get_law(name).update


def test_k4_needs_cuda_and_a_k4_law():
    """``impl="cuda"`` and K4's wrapper refuse CPU tensors; a law without
    a K4 path and a per-flow law scalar raise when K4's inputs are built;
    a per-flow gamma reaches K4 as per-flow gamma and 1 - gamma."""
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels.fused_tick import fused_tick_block
    topo, sched, cfg, slots = _scenario(tc, "single_slot", device="cpu")
    lcfg = tc.default_law_config(sched, expected_flows=8.0)
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), "powertcp",
                              slots, tc.batch_of_one(lcfg), cfg,
                              "megakernel", "cpu")
    with pytest.raises(ValueError, match="impl='torch'"):
        mk.simulate_slots_mega(sim, impl="cuda")
    tick = mk.make_tick(sim)
    assert tick.k4_params().law == 0
    carry = tick.init_carry(fluid.init_slot_state(sim))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_tick_block(tick.k4_params(), carry,
                         torch.zeros((1, 4), dtype=torch.int32))
    other = tc.Law("my_law", tc.LAWS["powertcp"].init,
                   tc.LAWS["powertcp"].update, backend="megakernel")
    with pytest.raises(NotImplementedError, match="no K4 path"):
        mk.make_tick(sim._replace(law=other)).k4_params()
    n = int(sched.start.shape[0])
    gamma = torch.linspace(0.5, 0.95, n)[None]
    params = mk.make_tick(sim._replace(law_cfg=sim.law_cfg._replace(
        gamma=gamma))).k4_params()
    torch.testing.assert_close(params.config["gamma"], gamma, rtol=0,
                               atol=0)
    torch.testing.assert_close(params.config["omg"], 1.0 - gamma, rtol=0,
                               atol=0)
    per_flow = sim.law_cfg._replace(hpcc_eta=torch.full((1, n), 0.9))
    with pytest.raises(ValueError, match="per scenario"):
        mk.make_tick(sim._replace(law_cfg=per_flow)).k4_params()


# -------------------------------------------------------------------------
# ported helpers, bitwise against repro
# -------------------------------------------------------------------------

def test_suggest_maxdeg_matches_repro():
    jqa = _jqa()
    from repro_torch.kernels.queue_arrivals import suggest_maxdeg
    rng = np.random.default_rng(4)
    for Q, S, hi in ((13, 9, 14), (200, 384, 40), (5, 2, 6), (3, 500, 4)):
        path = rng.integers(0, hi, (S * 3, 3)).astype(np.int32)
        assert suggest_maxdeg(path, Q, S) == \
            jqa.suggest_maxdeg(path, Q, S)


def test_stable_sort_and_seg_ranks_match_repro():
    jqa = _jqa()
    import jax.numpy as jnp
    from repro_torch.kernels.queue_arrivals import seg_ranks, stable_sort_ids
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 30, 257).astype(np.int32)
    js, jo = jqa.stable_sort_ids(jnp.asarray(ids), 30)
    ts, to = stable_sort_ids(torch.as_tensor(ids), 30)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(
        seg_ranks(ts).numpy(),
        np.asarray(jqa.seg_ranks(js)))


@pytest.mark.parametrize("maxdeg", [1, 3, 27])
def test_build_csr_gather_matches_repro(maxdeg):
    jqa = _jqa()
    import jax.numpy as jnp
    from repro_torch.kernels.queue_arrivals import build_csr_gather
    rng = np.random.default_rng(maxdeg)
    Q = 13
    path = rng.integers(0, Q + 1, (9, 3)).astype(np.int32)
    jinv, jovf = jqa.build_csr_gather(jnp.asarray(path), Q,
                                                    maxdeg)
    # the port's takes a batch of scenarios: a batch of one here
    tinv, tovf = build_csr_gather(torch.as_tensor(path)[None], Q, maxdeg)
    tinv, tovf = tinv[0], tovf[0]
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert bool(tovf) == bool(jovf)
    deg = np.bincount(path[path < Q].ravel(), minlength=Q).max()
    assert bool(tovf) == (deg > maxdeg)


def _queue_inputs(seed):
    rng = np.random.default_rng(seed)
    S, H, Q1 = 6, 2, 5
    return dict(
        path=rng.integers(0, Q1, (S, H)).astype(np.int32),
        lam=rng.uniform(0, 1e9, (S, H)).astype(np.float32),
        q=np.array([3e5, 0.0, 2e4, 7e5, 0.0], np.float32),
        bw=np.array([12.5e9, 3e9, 1e9, 12.5e9, 1e15], np.float32),
        caps=np.array([6e5, 6e6, 1e4, 6e6, 1e30], np.float32))


def test_integrate_and_queue_arrivals_sparse_match_repro():
    jqa = _jqa()
    import jax.numpy as jnp
    from repro_torch.kernels.queue_arrivals import (integrate_arrivals,
                                                    queue_arrivals_sparse)
    x = _queue_inputs(6)
    Q = x["q"].shape[0] - 1
    valid = x["path"] < Q
    jarr, jout, jq = jqa.queue_arrivals_sparse(
        jnp.asarray(x["lam"]), jnp.asarray(x["path"]), jnp.asarray(valid),
        jnp.asarray(x["q"]), jnp.asarray(x["bw"]), jnp.asarray(x["caps"]),
        dt=1e-6)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    tarr, tout, tq = queue_arrivals_sparse(
        t["lam"], t["path"], torch.as_tensor(valid), t["q"], t["bw"],
        t["caps"], dt=1e-6)
    for a, b in ((tarr, jarr), (tout, jout), (tq, jq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    iout, iq = integrate_arrivals(tarr, t["q"], t["bw"], t["caps"], dt=1e-6)
    np.testing.assert_array_equal(iout.numpy(), tout.numpy())
    np.testing.assert_array_equal(iq.numpy(), tq.numpy())


def test_sparse_queue_update_equals_reference_update():
    """``queue_arrivals_sparse`` is bit for bit ``fluid._queue_update`` of
    the reference backend."""
    from repro_torch.core import fluid
    from repro_torch.kernels.queue_arrivals import (build_csr_gather,
                                                    queue_arrivals_sparse)
    import repro_torch.core as tc
    topo = tc.LeafSpine(racks=2, hosts_per_rack=4, spines=1).topology(
        device="cpu")
    static = fluid._make_static(topo, 1e-6)
    Q = topo.num_queues
    rng = np.random.default_rng(7)
    path = torch.as_tensor(rng.integers(0, Q + 1, (16, 3)).astype(np.int32))
    lam = torch.as_tensor(rng.uniform(0, 1e9, (16, 3)).astype(np.float32))
    q = torch.as_tensor(np.concatenate([rng.uniform(0, 2e6, Q), [0.0]])
                        .astype(np.float32))
    valid = path < Q
    # the engine's queue update takes a batch: a batch of one
    inv, _ = build_csr_gather(path[None], Q, 16 * 3)
    ref = fluid._queue_update(topo, 1e-6, "reference", None, inv, q[None],
                              lam[None], valid[None], static, static.bw)
    got = queue_arrivals_sparse(lam, path, valid, q, static.bw,
                                fluid._buffer_caps(topo, q, static), dt=1e-6)
    for a, b in zip(got, ref):
        assert torch.equal(a, b[0])


def test_buffer_caps_match_repro_csr_form():
    """The megakernel folds the Dynamic-Thresholds caps through
    ``fluid._buffer_caps``; its switch table and caps equal ``repro``'s
    ``build_switch_csr`` and ``_buffer_caps_csr``."""
    jcore, _ = sup.import_repro()
    import jax.numpy as jnp
    from repro.core.megakernel import (_buffer_caps_csr as jcaps,
                                       build_switch_csr as jcsr)
    import repro_torch.core as tc
    from repro_torch.core import fluid
    jtopo = jcore.LeafSpine(racks=2, hosts_per_rack=4, spines=1).topology()
    ttopo = tc.LeafSpine(racks=2, hosts_per_rack=4, spines=1).topology(
        device="cpu")
    static = fluid._make_static(ttopo, 1e-6)
    np.testing.assert_array_equal(static.sw_table.numpy(), jcsr(jtopo))
    rng = np.random.default_rng(2)
    q = np.concatenate([rng.uniform(0, 2e6, ttopo.num_queues),
                        [0.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        fluid._buffer_caps(ttopo, torch.as_tensor(q), static).numpy(),
        np.asarray(jcaps(jtopo, jnp.asarray(q), jcsr(jtopo))))


def test_due_table_matches_repro_and_the_slot_engine():
    jcore, _ = sup.import_repro()
    from repro.core.megakernel import _due_table as jdue
    import repro_torch.core as tc
    from repro_torch.core import megakernel as mk
    _, jsched, _ = _staggered(jcore)
    _, tsched, _ = _staggered(tc, device="cpu")
    got = mk._due_table(tc.batch_of_one(tsched), 4000, 1e-6)[0]
    np.testing.assert_array_equal(got, np.asarray(jdue(jsched, 4000, 1e-6)))
    start = tsched.start.numpy()
    for t in (0, 1, 17, 1499, 3999):
        assert got[t] == np.searchsorted(
            start, np.float32(tc.fluid._tick_time(t, 1e-6)), side="right")


def test_block_size():
    from repro_torch.core.megakernel import block_size
    assert block_size(4000) == 64
    assert block_size(30) == 30
    assert block_size(2000, 10) == 60
    assert block_size(2000, 10, 7) == 10
    assert block_size(3998, 1, 7) == 7


def test_k4_layout_plan():
    """K4's working set fits in shared memory at the paper's shape (both
    laws) and not at a large S, where the same layout goes to a global
    buffer; its fields are those of ``enum Field`` in the source, in that
    order, at 16-byte aligned, non-overlapping offsets."""
    import re
    from repro_torch.kernels import fused_tick as ft
    for law in (0, 1):
        lay = ft.layout(384, 3, 288, 10, 34, 10, law)
        assert lay.smem and lay.nbytes <= 227 * 1024, lay.nbytes
    assert ft.layout(1536, 1, 1, 0, 0, 1, 0).smem
    assert not ft.layout(2048, 1, 1, 0, 0, 1, 0).smem
    assert not ft.layout(4096, 3, 288, 10, 34, 10, 0).smem
    fields = ft._fields(384, 3, 288, 10, 34, 10, 1)
    lay = ft.layout(384, 3, 288, 10, 34, 10, 1)
    ends = [o + 4 * n for o, (_, n) in zip(lay.offsets, fields)]
    assert all(o % 16 == 0 for o in lay.offsets)
    assert all(e <= o for e, o in zip(ends, lay.offsets[1:] + (lay.nbytes,)))
    with open(os.path.join(REPO, "src", "repro_torch", "csrc",
                           "fused_tick.cu")) as f:
        body = re.search(r"enum Field \{(.*?)kFields", f.read(), re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip()[2:].lower() for n in body.split(",") if n.strip()]
    assert names == [n for n, _ in fields]


# -------------------------------------------------------------------------
# import boundary
# -------------------------------------------------------------------------

def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.core.megakernel, "
            "repro_torch.kernels.fused_tick, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
    for rel in ("core/megakernel.py", "kernels/fused_tick.py"):
        with open(os.path.join(REPO, "src", "repro_torch", rel)) as f:
            text = f.read()
        assert "import jax" not in text and "from repro." not in text \
            and "import repro\n" not in text, rel
