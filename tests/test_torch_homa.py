"""The port's HOMA allocator and the padded engine's ``alloc_fn`` against
``repro`` on the CPU.

* ``homa_alloc_fn``'s allocator against ``repro``'s under ``jax.jit`` on
  random and adversarial inputs, exactly: ties in ``remaining`` (to the
  lower flow index), ``inf`` and NaN keys, +0.0 against -0.0, every flow
  inactive, one receiver and many, ``overcommit`` 1, 2 and 3, flows in
  and past their unscheduled first RTT; [F] and [B, F] layouts;
* ``simulate(alloc_fn=)`` bit for bit ``repro``'s in every ``Record``
  field and state leaf on
  ``test_fluid_sim.py::test_homa_allocator_grants_shortest_first``'s
  scenario (``powertcp``, its 3 000 ticks) and over 2 000 ticks on Fig.
  4's 10:1 incast as ``run_law``
  runs HOMA (``reno``, overcommit 1, ``expected_flows=16``, padded to 64
  flows); the megakernel backend's padded run (the reference ops) bit
  for bit the reference's;
* ``simulate_batch(alloc_fn=)``: a batch with [B, F] receivers bit for
  bit each scenario's own ``simulate``, and a batch sharing [F]
  receivers bit for bit ``repro``'s batched run;
* the fused backend (``powertcp``; the plain versions of K1's observe
  form and K3 here) against ``repro``'s fused run at rtol 1e-5;
* the golden ``torch_port_fig4.json``'s HOMA runs (``chip_smoke.py``
  phase 6i.2): the port's CPU runs of the same ticks bit for bit;
* the slot path rejects an allocator (``ValueError``), as ``repro``.
"""
import base64
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

import test_torch_support as sup

import repro_torch.core as tc

jcore, _ = sup.import_repro()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

INF = np.float32(np.inf)


class _Nic(NamedTuple):
    nic_rate: object


def _allocs(recv, bw, oc, tau, start):
    """(the port's allocator, ``repro``'s jitted one) over the same
    arguments; the jitted one closes over ``tau``/``start`` as the
    engine's program does."""
    got = tc.homa_alloc_fn(recv, bw, oc, torch.as_tensor(tau),
                           torch.as_tensor(start))
    jal = jcore.homa_alloc_fn(recv, bw, oc, jnp.asarray(tau),
                              jnp.asarray(start))
    want = jax.jit(lambda r, a, t, nic: jal(r, a, t, _Nic(nic), None))
    return got, want


def _case(rng, F, nrecv, kind):
    recv = rng.integers(0, nrecv, F).astype(np.int64)
    rem = rng.uniform(1e3, 1e6, F).astype(np.float32)
    active = rng.random(F) < 0.8
    if kind == "ties":
        rem = rng.choice(np.float32([5e4, 1e5, 2e5]), F)
    elif kind == "inf":
        rem[rng.random(F) < 0.3] = INF
    elif kind == "nan":
        rem[rng.random(F) < 0.2] = np.float32(np.nan)
    elif kind == "zeros":
        rem = rng.choice(np.float32([0.0, -0.0, 1e4]), F)
        active[:] = True
    elif kind == "inactive":
        active[:] = False
    tau = rng.uniform(5e-6, 3e-5, F).astype(np.float32)
    start = rng.uniform(0.0, 2e-4, F).astype(np.float32)
    nic = rng.choice(np.float32([3.125e9, 1.25e10]), F)
    t_sec = np.float32(rng.uniform(0.0, 2.5e-4))
    return recv, rem, active, tau, start, nic, t_sec


@pytest.mark.parametrize("kind", ("random", "ties", "inf", "nan", "zeros",
                                  "inactive"))
@pytest.mark.parametrize("nrecv", (1, 7))
@pytest.mark.parametrize("oc", (1, 2, 3))
def test_allocator_matches_repro(kind, nrecv, oc):
    rng = np.random.default_rng(hash((kind, nrecv, oc)) % 2 ** 32)
    for F in (1, 13, 200):
        recv, rem, active, tau, start, nic, t_sec = _case(rng, F, nrecv,
                                                          kind)
        got, want = _allocs(recv, 25e9 / 8, oc, tau, start)
        w = np.asarray(want(jnp.asarray(rem), jnp.asarray(active),
                            jnp.asarray(t_sec), jnp.asarray(nic)))
        g = got(torch.as_tensor(rem), torch.as_tensor(active), float(t_sec),
                _Nic(torch.as_tensor(nic)), None)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"F={F}")
        # the batched layout: a batch of one, and [B, F] receivers
        g1 = got(torch.as_tensor(rem)[None], torch.as_tensor(active)[None],
                 float(t_sec), _Nic(torch.as_tensor(nic)[None]), None)
        np.testing.assert_array_equal(g1[0].numpy(), w)


def test_allocator_batch_of_receivers_is_each_row():
    rng = np.random.default_rng(5)
    F, B = 40, 3
    rows = [_case(rng, F, 5, "ties") for _ in range(B)]
    recv = np.stack([r[0] for r in rows])
    rem, active, tau, start, nic = (np.stack([r[i] for r in rows])
                                    for i in (1, 2, 3, 4, 5))
    t_sec = float(rows[0][6])
    got = tc.homa_alloc_fn(recv, 3.125e9, 2, torch.as_tensor(tau),
                           torch.as_tensor(start))
    g = got(torch.as_tensor(rem), torch.as_tensor(active), t_sec,
            _Nic(torch.as_tensor(nic)), None)
    for b in range(B):
        _, want = _allocs(recv[b], 3.125e9, 2, tau[b], start[b])
        w = np.asarray(want(jnp.asarray(rem[b]), jnp.asarray(active[b]),
                            jnp.asarray(np.float32(t_sec)),
                            jnp.asarray(nic[b])))
        np.testing.assert_array_equal(g[b].numpy(), w, err_msg=f"row {b}")


def _same_run(got, want, what):
    st, rec = got
    wst, wrec = want
    for f in wrec._fields:
        np.testing.assert_array_equal(getattr(rec, f).cpu().numpy(),
                                      np.asarray(getattr(wrec, f)),
                                      err_msg=f"{what} rec.{f}")
    for f in wst._fields:
        w = getattr(wst, f)
        if w is None or f == "law":
            continue
        g = getattr(st, f)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=f"{what} state.{f}")


def _shortest_first(core, **dev):
    """``test_homa_allocator_grants_shortest_first``'s scenario: four 4 MB
    responses to one victim, no long flow, overcommit 1, ``powertcp``,
    its 3 000 ticks."""
    fab = core.LeafSpine(racks=2, hosts_per_rack=4, spines=1)
    flows, _ = core.incast_flows(fab, fan_in=4, req_bytes=4e6, sim_dt=1e-6,
                                 long_flow=False, **dev)
    alloc = core.homa_alloc_fn(np.zeros(4, np.int64), fab.host_bw, 1,
                               flows.tau, flows.start)
    cfg = core.SimConfig(dt=1e-6, steps=3000, hist=256)
    return (fab.topology(**dev), flows,
            core.default_law_config(flows, expected_flows=1.0), cfg, alloc)


@pytest.mark.parametrize("backend", ("reference", "megakernel"))
def test_simulate_shortest_first_matches_repro(backend):
    topo, flows, lcfg, cfg, alloc = _shortest_first(jcore)
    want = jcore.simulate(topo, flows, "powertcp", lcfg, cfg, alloc_fn=alloc)
    ttopo, tflows, tlcfg, tcfg, talloc = _shortest_first(tc, device="cpu")
    got = tc.simulate(ttopo, tflows, "powertcp", tlcfg, tcfg,
                      alloc_fn=talloc, backend=backend, device="cpu")
    _same_run(got, want, backend)
    fct = got[0].fct.numpy()
    # the test of repro's own: SRPT serializes equal flows
    assert np.isfinite(fct).sum() >= 2
    assert np.nanmin(fct) > 4e6 / 3.125e9 * 0.9


def test_simulate_shortest_first_fused_matches_repro():
    topo, flows, lcfg, cfg, alloc = _shortest_first(jcore)
    want, wrec = jcore.simulate(topo, flows, "powertcp", lcfg, cfg,
                                alloc_fn=alloc, backend="fused")
    ttopo, tflows, tlcfg, tcfg, talloc = _shortest_first(tc, device="cpu")
    got, rec = tc.simulate(ttopo, tflows, "powertcp", tlcfg, tcfg,
                           alloc_fn=talloc, backend="fused", device="cpu")
    g, w = got.fct.numpy(), np.asarray(want.fct)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    np.testing.assert_allclose(g, w, rtol=1e-5)
    np.testing.assert_allclose(rec.q.numpy(), np.asarray(wrec.q), rtol=1e-5,
                               atol=0.5)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-5)


def _fig4_homa(core, **dev):
    fab, topo, flows, bq, cfg = sup.fig4_scenario(
        core, steps=sup.HOMA_FIG4_STEPS, **dev)
    n = max(int(f.tau.shape[0]) for f in flows)
    fl, alloc, lcfg = sup.homa_run_args(core, fab, flows[0], pad_to=n,
                                        expected_flows=16.0)
    return topo, fl, alloc, lcfg, cfg, bq


def _unb64(s):
    return np.frombuffer(base64.b64decode(s), np.float32)


def _fct(lst):
    return np.array([np.nan if x is None else x for x in lst], np.float32)


def test_fig4_homa_matches_repro_and_golden():
    topo, fl, alloc, lcfg, cfg, bq = _fig4_homa(jcore)
    want = jcore.simulate(topo, fl, "reno", lcfg, cfg, alloc_fn=alloc)
    ttopo, tfl, talloc, tlcfg, tcfg, _ = _fig4_homa(tc, device="cpu")
    got = tc.simulate(ttopo, tfl, "reno", tlcfg, tcfg, alloc_fn=talloc,
                      device="cpu")
    _same_run(got, want, "fig4 10:1 HOMA")
    with open(sup.FIG4_REF) as f:
        ref = json.load(f)["homa"]["fig4_10"]
    st, rec = got
    np.testing.assert_array_equal(st.fct.numpy(), _fct(ref["fct_s"]))
    np.testing.assert_array_equal(rec.q[:, bq].numpy(), _unb64(ref["q"]))
    np.testing.assert_array_equal(rec.thru[:, bq].numpy(),
                                  _unb64(ref["thru"]))
    np.testing.assert_array_equal(rec.w_sum.numpy(), _unb64(ref["w_sum"]))
    assert rec.n_active.tolist() == ref["n_active"]
    # SRPT with overcommit 1: the responses finish one after another
    done = np.sort(st.fct.numpy()[np.isfinite(st.fct.numpy())])
    assert len(done) == 10 and (np.diff(done) > 0).all()


def test_websearch_homa_matches_golden():
    fab, topo, flows, cfg = sup.homa_ws_scenario(tc, device="cpu")
    fl, alloc, lcfg = sup.homa_run_args(tc, fab, flows)
    st, rec = tc.simulate(topo, fl, "reno", lcfg, cfg, alloc_fn=alloc,
                          record=True, device="cpu")
    with open(sup.FIG4_REF) as f:
        ref = json.load(f)["homa"]["ws"]
    assert ref["n_flows"] == int(fl.tau.shape[0])
    np.testing.assert_array_equal(st.fct.numpy(), _fct(ref["fct_s"]))
    np.testing.assert_array_equal(rec.q.numpy().ravel(), _unb64(ref["q"]))
    np.testing.assert_array_equal(rec.w_sum.numpy(), _unb64(ref["w_sum"]))


def test_simulate_batch_with_per_scenario_receivers():
    """Fig. 4's two incasts as one batch with [B, F] receivers: each
    scenario bit for bit its own ``simulate``."""
    fab, topo, flows, bq, cfg = sup.fig4_scenario(tc, steps=600,
                                                  device="cpu")
    fb = tc.stack_flows(flows, topo.num_queues)
    n = int(fb.tau.shape[1])
    recv = np.stack([sup.receiver_ids(tc.pad_flows(f, n, topo.num_queues),
                                      fab) for f in flows])
    alloc = tc.homa_alloc_fn(recv, fab.host_bw, 2, fb.tau, fb.start)
    lcfg = tc.default_law_config(fb, expected_flows=16.0)
    bst, brec = tc.simulate_batch(topo, fb, "reno", lcfg, cfg,
                                  alloc_fn=alloc, device="cpu")
    for b, f in enumerate(flows):
        fl = tc.pad_flows(f, n, topo.num_queues)
        a1 = tc.homa_alloc_fn(recv[b], fab.host_bw, 2, fl.tau, fl.start)
        st, rec = tc.simulate(topo, fl, "reno",
                              tc.default_law_config(fl, expected_flows=16.0),
                              cfg, alloc_fn=a1, device="cpu")
        for f_ in rec._fields:
            torch.testing.assert_close(getattr(brec, f_)[b],
                                       getattr(rec, f_), rtol=0, atol=0,
                                       equal_nan=True)
        for (name, g), (_, w) in zip(sup.tree_leaves(
                tc.scenario(bst, b), "state"), sup.tree_leaves(st, "state")):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m, n=name: f"{n}: {m}")
    assert int(torch.isfinite(bst.fct).sum()) > 0


def test_simulate_batch_shared_receivers_matches_repro():
    """Two incasts into the same victim (different responders): their
    receivers are one [F] row, shared by the batch as ``repro`` shares
    it under ``vmap``."""
    def build(core, **dev):
        fab = core.LeafSpine(racks=2, hosts_per_rack=8, spines=1)
        fls = [core.incast_flows(fab, 6, 2e5, 1e-6, seed=s, **dev)[0]
               for s in (0, 1)]
        fb = core.stack_flows(fls, fab.num_queues)
        recv = sup.receiver_ids(fls[0], fab)
        assert (recv == sup.receiver_ids(fls[1], fab)).all()
        cfg = core.SimConfig(dt=1e-6, steps=800, hist=256)
        return fab, fb, recv, cfg

    fab, fb, recv, cfg = build(jcore)
    alloc = jcore.homa_alloc_fn(recv, fab.host_bw, 1, fb.tau[0], fb.start[0])
    want = jcore.simulate_batch(fab.topology(), fb, "reno", cfg=cfg,
                                alloc_fn=alloc, expected_flows=4.0)
    tfab, tfb, trecv, tcfg = build(tc, device="cpu")
    talloc = tc.homa_alloc_fn(trecv, tfab.host_bw, 1, tfb.tau[0],
                              tfb.start[0])
    got = tc.simulate_batch(tfab.topology(device="cpu"), tfb, "reno",
                            cfg=tcfg, alloc_fn=talloc, expected_flows=4.0,
                            device="cpu")
    _same_run(got, want, "shared receivers")


def test_slot_path_rejects_an_allocator():
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    sim = tc.make_slot_sim(topo, tc.batch_of_one(tc.make_schedule(flows)),
                           "powertcp", 4, device="cpu")
    state = tc.init_slot_state(sim)
    with pytest.raises(ValueError, match="not supported on the slot path"):
        tc.slot_step(sim, state, alloc_fn=lambda *a: None)
