"""The feedback-channel laws of the port (``fncc``, ``pulser``,
``backpressure``, ``pcc``; ``repro_torch/core/feedback.py``) with the
hop clock, the pause and incast channels, the fat-tree and the
incast-burst generator, against the JAX reference, on the CPU.

* update by update: seeded ``PathObs`` (with the pause and incast
  channels), states, windows, rate caps, masks and times through
  ``repro``'s update under ``jax.jit`` (the config's arrays inputs, its
  Python scalars constants, as the engines compile it) and the port's,
  every leaf bit for bit, with the law's scalars as Python numbers and as
  tensors (divided); PCC's probes with ties (rates below one byte/s,
  where every probe scores the same) and NaN scores (a NaN RTT, and a
  probe rate of 0 against an infinite excess);
* ``_pause_step`` and ``_incast_count`` bit for bit against ``repro``'s;
* the property suite of ``tests/test_property_feedback.py``: the notify
  delay beats the receiver echo and is monotone in hop depth, reverse
  paths are contiguous walks, a one-way fabric raises, the pause
  hysteresis, a drained queue always unpauses, backpressure drains and
  unpauses end to end;
* the closed-form operating points of ``tests/test_laws_equilibrium.py``
  for the four laws, through the port's padded engine;
* ``fat_tree(4)`` and ``fat_tree(8)``: paths, forward delays, RTT steps
  and base RTTs of a host-pair grid equal to ``repro``'s, as are
  ``incast_burst``'s flows and victim queues;
* the four laws' clean legs of ``tests/golden/golden_laws.json``, within
  ``tests/test_golden_traces.py``'s tolerances;
* a reduced fat-tree anchor (``ANCHOR_STEPS`` ticks of each leg of
  ``benchmarks/feedback_fct.py``, two bursts 1 ms apart on the incast
  leg) through the port's padded and slot (S >= N) reference engines and
  the plain megakernel tick, for the four laws and ``powertcp``: every
  ``Record`` field and the FCTs bit for bit ``repro``'s (the padded run
  against ``repro``'s padded run, the others against its slot run);
* a batch of two whose ``fncc_eta``, ``pulser_n``, ``bp_xoff`` and
  ``pcc_eps`` differ by scenario (``stack_law_configs``) through
  ``simulate_slots_batch``, reference and plain megakernel, against
  ``repro``'s batched run;
* K4's inputs for the four laws (the per-scenario constants, the
  divisor mode of ``fncc_eta``, the ring's channels) and its layout at
  phase 6c's and the fat tree's shapes (the kernel itself runs in
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``); ``get_law(...,
  "fused")`` raising for the four, as in ``repro``.

Run as a script, this module writes ``chip_smoke.py`` phase 6e's and 6c's
reference data, ``tests/golden/torch_port_feedback.json``: ``repro``'s
slot engine (``simulate_slots_batch``, reference backend) on the CPU over
both legs of ``feedback_fct.run(quick=False)`` for its seven laws, and
over ``benchmarks/fig6_fct.py::run_paper_scale``'s scenario for the four
feedback laws (the per-flow FCTs as float32, with their statistics and
``run``'s verdict):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_feedback.py
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
LAWS = sup.FEEDBACK_LAWS


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# -------------------------------------------------------------------------
# update by update
# -------------------------------------------------------------------------

# the law scalars of the update-level cases: the defaults, and others
# (PCC's eps of 0.5 puts its first probe at a rate of exactly 0)
SCALARS = {"default": {},
           "other": dict(fncc_eta=0.9, pulser_n=3.0, bp_md=0.7,
                         pcc_eps=0.5, pcc_b=100.0)}


def _update_inputs(law, F=2048, H=5, seed=0):
    """Seeded inputs of one ``*_update`` call at the simulator's
    magnitudes, numpy: (PathObs fields, per-flow config, law state, w,
    rate_cap, upd, t). Sentinel hops, masked-off rows, paused and unpaused
    hops and sender counts from 0 to 20 included; PCC's rates include
    ones below a byte/s (every probe ties) and 0, and its RTTs a NaN and
    an infinity."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tau = rng.uniform(12e-6, 24e-6, F).astype(f32)
    hb = rng.choice([3.125e9, 12.5e9], F).astype(f32)
    w = (np.abs(rng.standard_normal(F)) * 1e5 + 1e4).astype(f32)
    theta = (tau * rng.uniform(0.9, 4.0, F)).astype(f32)
    theta[:4] = [np.nan, np.inf, tau[2], tau[3] * 1.5]
    theta[8] = np.inf
    obs = dict(q=(np.abs(rng.standard_normal((F, H))) * 1e6).astype(f32),
               qdot=(rng.standard_normal((F, H)) * 1e8).astype(f32),
               mu=(np.abs(rng.standard_normal((F, H))) * 1e9).astype(f32),
               b=rng.choice([3.125e9, 12.5e9], (F, H)).astype(f32),
               valid=rng.random((F, H)) > 0.3,
               theta=theta,
               w_old=(w * rng.uniform(0.5, 1.5, F)).astype(f32),
               dt_obs=rng.choice([1e-6, 2e-6, 30e-6], F).astype(f32),
               ecn_frac=np.zeros(F, f32),
               pause=(rng.random((F, H)) < 0.2).astype(f32),
               incast=rng.integers(0, 21, (F, H)).astype(f32))
    cfg = dict(beta=rng.uniform(1e3, 5e4, F).astype(f32), tau=tau,
               host_bw=hb)
    t = f32(rng.uniform(1e-4, 1e-3))
    rate = (hb * rng.uniform(0.0005, 1.0, F)).astype(f32)
    rate[4:8] = [0.0, 0.5, 0.9, 1e-30]
    rate[:2] = [rate[0], 0.0]
    state = {
        "fncc": dict(u=rng.uniform(0.2, 1.5, F).astype(f32)),
        "pulser": dict(dummy=np.zeros(F, f32)),
        "backpressure": dict(last_cut=(t - rng.uniform(0, 200e-6, F))
                             .astype(f32)),
        "pcc": dict(rate=rate),
    }[law]
    rate_cap = np.where(rng.random(F) < 0.5, np.inf,
                        rng.uniform(1e8, 1e10, F)).astype(f32)
    upd = rng.random(F) > 0.3
    return obs, cfg, state, w, rate_cap, upd, t


@pytest.mark.parametrize("traced", (False, True))
@pytest.mark.parametrize("scalars", sorted(SCALARS))
@pytest.mark.parametrize("law", LAWS)
def test_update_matches_repro(law, scalars, traced):
    """The port's update against ``repro``'s under ``jax.jit``: the law's
    scalars closed over as Python numbers (XLA folds a division by one
    into a product with its reciprocal; ``laws.div_config`` does the
    same) or, ``traced``, inputs of the program as a stacked config's are
    (divided)."""
    import jax
    import jax.numpy as jnp
    sup.import_repro()
    import repro.core.laws as jl
    import repro_torch.core as tc
    obs, cfg, state, w, rate_cap, upd, t = _update_inputs(law)
    sc = dict(SCALARS[scalars])
    jlaw, tlaw = jl.LAWS[law], tc.LAWS[law]
    jcfg0 = jl.LawConfig()._replace(**({} if traced else sc))

    def run(st, ob, w_, rc, up, t_, arrays):
        return jlaw.update(st, ob, w_, rc, up, jcfg0._replace(**arrays), t_)

    arrays = {k: jnp.asarray(v) for k, v in cfg.items()}
    tcfg = {k: torch.tensor(v) for k, v in cfg.items()}
    if traced:
        names = ("fncc_eta", "pulser_n", "bp_xoff", "bp_xon", "bp_md",
                 "pcc_eps", "pcc_b")
        vals = {k: sc.get(k, getattr(jl.LawConfig(), k)) for k in names}
        arrays.update({k: jnp.float32(v) for k, v in vals.items()})
        tcfg.update({k: torch.tensor(v, dtype=torch.float32)
                     for k, v in vals.items()})
    else:
        tcfg.update(sc)
    jstate = type(jlaw.init(1, jl.LawConfig(tau=jnp.ones(1),
                                            host_bw=jnp.ones(1))))
    got_j = jax.jit(run)(
        jstate(**{k: jnp.asarray(v) for k, v in state.items()}),
        jl.PathObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jnp.asarray(w), jnp.asarray(rate_cap), jnp.asarray(upd),
        jnp.float32(t), arrays)
    tstate = type(tlaw.init(1, tc.LawConfig(tau=torch.ones(1),
                                            host_bw=torch.ones(1))))
    got_t = tlaw.update(
        tstate(**{k: torch.tensor(v) for k, v in state.items()}),
        tc.PathObs(**{k: torch.tensor(v) for k, v in obs.items()}),
        torch.tensor(w), torch.tensor(rate_cap), torch.tensor(upd),
        tc.LawConfig(**tcfg), float(t))
    names = [f"state.{f}" for f in got_j[0]._fields] + ["w", "rate_cap"]
    for name, a, b in zip(names, list(got_j[0]) + list(got_j[1:]),
                          list(got_t[0]) + list(got_t[1:])):
        a, b = np.asarray(a), _host(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_pcc_probe_edges_are_exercised():
    """The PCC inputs above reach the argmax's edges: rows where every
    probe ties, where every score is NaN, and (eps 0.5: a probe rate of
    0 against an infinite excess) where the first score alone is NaN."""
    import repro_torch.core as tc
    from repro_torch.core import feedback
    obs, cfg, state, *_ = _update_inputs("pcc")
    for eps, want in ((0.05, ("tie", "all_nan")),
                      (0.5, ("tie", "all_nan", "first_nan"))):
        lcfg = tc.LawConfig(pcc_eps=eps, **{k: torch.tensor(v)
                                            for k, v in cfg.items()})
        hb, tau = lcfg.host_bw, lcfg.tau
        theta = torch.tensor(obs["theta"])
        excess = (torch.clamp_min(theta - tau, 0.0) /
                  torch.clamp_min(tau, 1e-12))
        rate = torch.tensor(state["rate"])
        scores = torch.stack([
            -(hb / torch.clamp_min(rate * m, 1.0))
            - (excess * (rate * m)) * (lcfg.pcc_b / torch.clamp_min(hb, 1.0))
            for m in feedback.pcc_multipliers(lcfg)])
        nan = torch.isnan(scores)
        seen = {"tie": bool((~nan.any(0) & (scores == scores[0]).all(0))
                            .any()),
                "all_nan": bool(nan.all(0).any()),
                "first_nan": bool((nan[0] & ~nan[1:].any(0)).any())}
        assert all(seen[k] for k in want), (eps, seen)


def test_pause_step_and_incast_count_match_repro():
    """``_pause_step`` over the hysteresis band's edges and random levels,
    paused and not, and ``_incast_count`` over random paths with sentinel
    hops and zero, positive and NaN delayed rates: bit for bit
    ``repro``'s."""
    import jax.numpy as jnp
    jcore, _ = sup.import_repro()
    from repro.core import fluid as jf
    import repro_torch.core as tc
    from repro_torch.core import fluid as tf
    rng = np.random.default_rng(1)
    q = np.concatenate([np.asarray([0.0, 1.0, 1e6 - 1, 1e6, 1e6 + 1,
                                    1.5e6, 2e6 - 1, 2e6, 2e6 + 1, 1e8,
                                    np.nan], np.float32),
                        rng.uniform(0, 3e6, 500).astype(np.float32)])
    for scalars in ({}, dict(bp_xoff=5e5, bp_xon=0.0)):
        jcfg = jcore.LawConfig(**scalars)
        tcfg = tc.LawConfig(**scalars)
        for pause in (np.zeros_like(q), np.ones_like(q),
                      (rng.random(q.shape) < 0.5).astype(np.float32)):
            want = np.asarray(jf._pause_step(jnp.asarray(q),
                                             jnp.asarray(pause), jcfg))
            got = tf._pause_step(torch.tensor(q), torch.tensor(pause), tcfg)
            np.testing.assert_array_equal(got.numpy(), want)
    F, H, Q = 300, 5, 40
    path = rng.integers(0, Q + 1, (F, H)).astype(np.int32)
    valid = path < Q
    lam = np.where(rng.random((F, H)) < 0.4, 0.0,
                   rng.uniform(0, 1e9, (F, H))).astype(np.float32)
    lam[0, 0] = np.nan
    want = np.asarray(jf._incast_count(jnp.zeros((Q + 1,), jnp.float32),
                                       jnp.asarray(path),
                                       jnp.asarray(valid), jnp.asarray(lam)))
    got = tf._incast_count(torch.tensor(path)[None],
                           torch.tensor(valid)[None],
                           torch.tensor(lam)[None], None, Q)[0]
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------------
# the property suite (tests/test_property_feedback.py) on the port
# -------------------------------------------------------------------------

def _fabrics():
    import repro_torch.core as tc
    return [("leaf_spine", tc.compile_routes(tc.leaf_spine_fabric(
                racks=4, hosts_per_rack=4, spines=2))),
            ("fat_tree", tc.fat_tree(4))]


def _pair_grid(routes, k=12):
    """Same-rack, cross-rack/pod and hash-diverse host pairs."""
    n = routes.fabric.n_hosts
    rng = np.random.default_rng(7)
    pairs = {(0, 1), (0, n - 1), (1, n // 2)}
    while len(pairs) < k:
        s, d = rng.integers(0, n, 2)
        if s != d:
            pairs.add((int(s), int(d)))
    return sorted(pairs)


@pytest.mark.parametrize("fabric", ("leaf_spine", "fat_tree"))
def test_notify_delay_beats_echo_and_is_monotone(fabric):
    """For every ECMP path and real hop the reverse-path notify delay is
    the forward delay bit for bit (symmetric fabrics), below the receiver
    echo's ``rtt - tf_h``, non-decreasing in hop depth and 0 on padded
    hops."""
    routes = dict(_fabrics())[fabric]
    for s, d in _pair_grid(routes):
        cp = routes.paths(s, d)
        nd = routes.notify_delays(s, d)
        assert np.array_equal(nd, cp.tf)
        for p in range(len(cp.links)):
            h = int(cp.n_hops[p])
            assert (nd[p, :h] < cp.rtt[p] - cp.tf[p, :h]).all()
            assert (np.diff(nd[p, :h]) >= 0.0).all()
            assert (nd[p, h:] == 0.0).all()


@pytest.mark.parametrize("fabric", ("leaf_spine", "fat_tree"))
def test_reverse_paths_are_contiguous_walks(fabric):
    routes = dict(_fabrics())[fabric]
    f = routes.fabric
    for s, d in _pair_grid(routes):
        for lp in routes.paths(s, d).links:
            rp = routes.reverse_path(lp)
            assert len(rp) == len(lp)
            assert int(f.link_src[rp[0]]) == d
            assert int(f.link_dst[rp[-1]]) == s
            for a, b in zip(rp, rp[1:]):
                assert int(f.link_dst[a]) == int(f.link_src[b])
            for fw, bw in zip(lp, reversed(rp)):
                assert int(f.link_src[fw]) == int(f.link_dst[bw])
                assert int(f.link_dst[fw]) == int(f.link_src[bw])


def test_one_way_fabric_rejects_reverse_path():
    import repro_torch.core as tc
    routes = tc.compile_routes(tc.single_bottleneck_fabric())
    assert (routes.fabric.reverse_links() == -1).any()
    with pytest.raises(ValueError, match="reverse"):
        routes.reverse_path(routes.paths(0, 1).links[0])
    with pytest.raises(ValueError, match="reverse"):
        routes.notify_delays(0, 1)


def _pause(q, pause):
    import repro_torch.core as tc
    from repro_torch.core.fluid import _pause_step
    return _pause_step(torch.tensor(q, dtype=torch.float32),
                       torch.tensor(pause, dtype=torch.float32),
                       tc.LawConfig()).numpy()


def test_pause_hysteresis_fixed_grid():
    import repro_torch.core as tc
    cfg = tc.LawConfig()
    qs = np.asarray([0.0, 1.0, 1e6 - 1, 1e6, 1e6 + 1, 1.5e6, 2e6 - 1,
                     2e6, 2e6 + 1, 1e8], np.float32)
    for pause in (np.zeros_like(qs), np.ones_like(qs)):
        out = _pause(qs, pause)
        assert ((out == 0.0) | (out == 1.0)).all()
        assert (out[qs <= cfg.bp_xon] == 0.0).all()
        assert (out[qs >= cfg.bp_xoff] == 1.0).all()
        mid = (qs > cfg.bp_xon) & (qs < cfg.bp_xoff)
        assert (out[mid] == pause[mid]).all()


def test_draining_queue_always_unpauses():
    pause = np.ones(1, np.float32)
    for q in np.linspace(3e6, 0.0, 40, dtype=np.float32):
        pause = _pause(np.asarray([q]), pause)
    assert float(pause[0]) == 0.0


def test_backpressure_completion_drains_and_unpauses():
    """Finite backpressure flows complete, the bottleneck drains and the
    carried pause state ends cleared."""
    import repro_torch.core as tc
    B = 100 * tc.GBPS
    topo = tc.single_bottleneck(bandwidth=B, buffer=16e6, device="cpu")
    flows = tc.make_flows_single(6, tau=20 * tc.US, nic=4 * B,
                                 sizes=[2e6] * 6, sim_dt=1e-6, device="cpu")
    cfg = tc.SimConfig(dt=1e-6, steps=6000, hist=256)
    lcfg = tc.default_law_config(flows, expected_flows=6.0)
    st, _ = tc.simulate(topo, flows, "backpressure", lcfg, cfg, device="cpu")
    assert np.isfinite(st.fct.numpy()).all()
    assert float(st.q[0]) < 1e3
    assert float(st.pause[0]) == 0.0


# -------------------------------------------------------------------------
# closed-form operating points (tests/test_laws_equilibrium.py)
# -------------------------------------------------------------------------

def _long_lived(law, n=4, steps=6000, update_period=0.0):
    """``test_laws_equilibrium.run_long_lived`` on the port: n long-lived
    flows at one 100G bottleneck, tau 20 us, NIC 4 x b."""
    import repro_torch.core as tc
    B = 100 * tc.GBPS
    topo = tc.single_bottleneck(bandwidth=B, buffer=16e6, device="cpu")
    flows = tc.make_flows_single(n, tau=20 * tc.US, nic=4.0 * B,
                                 sim_dt=1e-6, device="cpu")
    cfg = tc.SimConfig(dt=1e-6, steps=steps, hist=256,
                       update_period=update_period)
    lcfg = tc.default_law_config(flows, expected_flows=float(n))
    st, rec = tc.simulate(topo, flows, law, lcfg, cfg, device="cpu")
    return st, rec, lcfg, B, B * 20 * tc.US


def test_fncc_equilibrium():
    """W = eta * BDP + beta_hat, q = beta_hat - (1 - eta) * BDP, full
    throughput."""
    _, rec, lcfg, B, bdp = _long_lived("fncc")
    beta_hat = float(lcfg.beta.sum())
    eta = float(lcfg.fncc_eta)
    assert float(rec.w_sum[-1500:].mean()) == pytest.approx(
        eta * bdp + beta_hat, rel=0.03)
    assert float(rec.q[-1500:, 0].mean()) == pytest.approx(
        beta_hat - (1.0 - eta) * bdp, rel=0.05)
    assert float(rec.thru[-1000:, 0].mean()) == pytest.approx(B, rel=0.01)


def test_pulser_snaps_to_fair_share():
    """With n >= pulser_n senders each clamps to b * tau / n: W = BDP,
    zero queue, full throughput."""
    _, rec, lcfg, B, bdp = _long_lived("pulser", n=8)
    assert float(lcfg.pulser_n) <= 8.0
    assert float(rec.w_sum[-1500:].mean()) == pytest.approx(bdp, rel=0.02)
    assert float(rec.q[-1500:, 0].mean()) < 0.02 * bdp
    assert float(rec.thru[-1000:, 0].mean()) == pytest.approx(B, rel=0.01)


def test_backpressure_sawtooth_band():
    """The queue oscillates through the whole XON/XOFF band at full
    throughput, far from the 16 MB buffer."""
    _, rec, lcfg, B, _ = _long_lived("backpressure", steps=12000)
    qt = rec.q[-4000:, 0].numpy()
    assert float(qt.max()) >= float(lcfg.bp_xoff)
    assert float(qt.min()) <= float(lcfg.bp_xon)
    assert float(qt.max()) < 8e6
    assert float(rec.thru[-4000:, 0].mean()) == pytest.approx(B, rel=0.02)


def test_pcc_utility_equilibrium():
    """The standing queue q = (N * host_bw / b)^2 * b * tau / pcc_b, at
    fixed 20 us updates."""
    _, rec, lcfg, B, bdp = _long_lived("pcc", steps=20000,
                                       update_period=2e-5)
    q_pred = (4.0 * float(lcfg.host_bw[0]) / B) ** 2 * bdp / lcfg.pcc_b
    assert float(rec.q[-4000:, 0].mean()) == pytest.approx(q_pred, rel=0.05)
    assert float(rec.thru[-4000:, 0].mean()) == pytest.approx(B, rel=0.01)


# -------------------------------------------------------------------------
# builders and goldens
# -------------------------------------------------------------------------

@pytest.mark.parametrize("k", (4, 8))
def test_fat_tree_matches_repro(k):
    """The compiled fat-tree against ``repro``'s: its size, and the
    paths, forward delays, RTT steps and base RTTs of flows over a host
    pair grid (same-edge, intra-pod, inter-pod, hashed ECMP choices); and
    ``incast_burst``'s flows and victim queues."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    jft, tft = jcore.fat_tree(k), tc.fat_tree(k)
    assert (tft.n_hosts, tft.num_queues, tft.H) == \
        (jft.n_hosts, jft.num_queues, jft.H)
    for jt, tt in zip(jft.topology(), tft.topology(device="cpu")):
        np.testing.assert_array_equal(_host(tt), np.asarray(jt))
    rng = np.random.default_rng(k)
    n = 400
    src = rng.integers(0, tft.n_hosts, n)
    dst = rng.integers(0, tft.n_hosts, n)
    dst = np.where(dst == src, (dst + 1) % tft.n_hosts, dst)
    src[:3], dst[:3] = [0, 0, 0], [1, 2, tft.n_hosts - 1]
    sizes, starts = rng.uniform(1e4, 1e6, n), rng.uniform(0, 1e-3, n)
    jf = jft.make_flows(src, dst, sizes, starts, 1e-6, seed=5)
    tf = tft.make_flows(src, dst, sizes, starts, 1e-6, seed=5,
                        device="cpu")
    for f in jf._fields:
        np.testing.assert_array_equal(_host(getattr(tf, f)),
                                      np.asarray(getattr(jf, f)), err_msg=f)
    assert int((tf.path < tft.num_queues).sum(-1).max()) == 5
    (jb, jq), (tb, tq) = [
        core.incast_burst(ft, fan_in=8, req_bytes=2e5, n_bursts=3,
                          period=2e-3, sim_dt=1e-6, seed=1, **dev)
        for core, ft, dev in ((jcore, jft, {}), (tc, tft,
                                                 {"device": "cpu"}))]
    assert tq == jq
    for f in jb._fields:
        np.testing.assert_array_equal(_host(getattr(tb, f)),
                                      np.asarray(getattr(jb, f)), err_msg=f)


@pytest.mark.parametrize("law", LAWS)
def test_golden_leg(law):
    import repro_torch.core as tc
    topo, flows, lcfg, cfg = sup.golden_scenario(tc, device="cpu")
    got = sup.pack(*tc.simulate(topo, flows, law, lcfg, cfg, device="cpu"))
    sup.check_golden(law, got, sup.golden()[law], leg="[reference]")


def test_feedback_laws_have_no_fused_backend():
    import repro_torch.core as tc
    for law in LAWS:
        assert tc.law_backends(law) == ["megakernel", "reference"]
        with pytest.raises(KeyError, match="fused"):
            tc.get_law(law, "fused")


# -------------------------------------------------------------------------
# the engines against repro on the fat-tree
# -------------------------------------------------------------------------

ANCHOR_STEPS = 2000
ANCHOR_LAWS = LAWS + ("powertcp",)


def _anchor(core, leg, **dev):
    """(topo, schedule, cfg, law config) of a reduced leg of
    ``feedback_fct``: the first ``ANCHOR_STEPS`` ticks of the web-search
    leg of 2 ms, or two incast bursts 1 ms apart."""
    if leg == "ws":
        topo, sched, cfg, _, _ = sup.feedback_scenario(
            core, "ws", quick=True, steps=ANCHOR_STEPS, **dev)
    else:
        ft = core.fat_tree(4)
        flows, _ = core.incast_burst(ft, fan_in=8, req_bytes=2e5,
                                     n_bursts=2, period=1e-3,
                                     sim_dt=sup.FEEDBACK_DT, seed=1, **dev)
        topo, sched = ft.topology(**dev), core.make_schedule(flows)
        cfg = core.SimConfig(dt=sup.FEEDBACK_DT, steps=ANCHOR_STEPS,
                             hist=512, update_period=2e-6)
    lcfg = core.default_law_config(
        core.schedule_as_flows(sched),
        expected_flows=sup.FEEDBACK_EXPECTED_FLOWS)
    return topo, sched, cfg, lcfg


def _assert_runs_equal(got, want, what, min_done=5):
    """Every ``Record`` field and the FCTs bit for bit; ``want`` must
    complete ``min_done`` flows."""
    (sg, rg), (sw, rw) = got, want
    fg, fw = _host(sg.fct), _host(sw.fct)
    assert np.isfinite(fw).sum() >= min_done, f"{what}: too few complete"
    np.testing.assert_array_equal(fg, fw, err_msg=f"{what}: fct")
    for f in rw._fields:
        np.testing.assert_array_equal(_host(getattr(rg, f)),
                                      _host(getattr(rw, f)),
                                      err_msg=f"{what}: rec.{f}")


@pytest.mark.parametrize("leg", sup.FEEDBACK_LEGS)
@pytest.mark.parametrize("law", ANCHOR_LAWS)
def test_fat_tree_anchor_matches_repro(law, leg):
    """The port's padded and slot (S >= N) reference engines and plain
    megakernel tick over the reduced anchor, each bit for bit ``repro``'s
    (padded against its padded run, the slot engines against its slot
    run), on 5-hop paths."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    runs = {}
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        topo, sched, cfg, lcfg = _anchor(core, leg, **dev)
        n = int(sched.start.shape[0])
        runs[core] = [core.simulate(topo, core.schedule_as_flows(sched),
                                    law, lcfg, cfg, **dev),
                      core.simulate_slots(topo, sched, law, n, lcfg, cfg,
                                          **dev)]
        if core is tc:
            runs[core].append(core.simulate_slots(
                topo, sched, law, n, lcfg, cfg, backend="megakernel",
                **dev))
    jp, js = runs[jcore]
    tp, ts, tm = runs[tc]
    _assert_runs_equal(tp, jp, f"{law} {leg} padded")
    _assert_runs_equal(ts, js, f"{law} {leg} slot")
    _assert_runs_equal(tm, js, f"{law} {leg} megakernel")
    for name in ("pause", "hist_pause", "hist_inc"):
        want = getattr(js[0], name)
        for st in (ts[0], tm[0]):
            got = getattr(st, name)
            assert (got is None) == (want is None), name
            if want is not None:
                np.testing.assert_array_equal(_host(got), np.asarray(want),
                                              err_msg=name)


BATCH_SCALARS = sup.FEEDBACK_BATCH_SCALARS
BATCH_STEPS = 1000


@pytest.mark.parametrize("law", LAWS)
def test_batch_with_per_scenario_config_matches_repro(law):
    """The two legs' first ``BATCH_STEPS`` ticks as one batch whose law
    scalars differ by scenario (``stack_law_configs``), through the port's
    ``simulate_slots_batch`` (reference backend, and the plain megakernel
    tick) against ``repro``'s."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    out = []
    for core, dev in ((jcore, {}), (tc, {"device": "cpu"})):
        legs = [_anchor(core, leg, **dev) for leg in sup.FEEDBACK_LEGS]
        topo = legs[0][0]
        cfg = legs[0][2]._replace(steps=BATCH_STEPS)
        sb = core.stack_flow_schedules([lg[1] for lg in legs],
                                       topo.num_queues)
        n = int(sb.start.shape[-1])
        cfgs = [core.default_law_config(
            type(sb)(*[x[b] for x in sb]),
            expected_flows=sup.FEEDBACK_EXPECTED_FLOWS, **kw)
            for b, kw in enumerate(BATCH_SCALARS)]
        lcfg = core.stack_law_configs(cfgs)
        out.append(core.simulate_slots_batch(topo, sb, law, n, lcfg, cfg,
                                             **dev))
        if core is tc:
            out.append(core.simulate_slots_batch(
                topo, sb, law, n, lcfg, cfg, backend="megakernel", **dev))
    _assert_runs_equal(out[1], out[0], f"{law} batch against repro")
    _assert_runs_equal(out[2], out[0], f"{law} megakernel batch")


# -------------------------------------------------------------------------
# K4's inputs for the four laws
# -------------------------------------------------------------------------

@pytest.mark.parametrize("law", LAWS)
def test_k4_inputs_and_layout(law):
    """``tick.k4_params()`` for a batch of the anchor's two legs with
    Python and with stacked scalars: the law's id, its per-scenario
    constants as float32 (``fncc_eta``'s reciprocal as ``div_config``
    rounds it) and the divisor mode; the carry's ring of 3 + channels
    columns; and K4's layout at the fat tree's and phase 6c's shapes in
    shared memory, the pause state staged for backpressure only."""
    import repro_torch.core as tc
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels import fused_tick as ft
    legs = [_anchor(tc, leg, device="cpu") for leg in sup.FEEDBACK_LEGS]
    topo = legs[0][0]
    sb = tc.stack_flow_schedules([lg[1] for lg in legs], topo.num_queues)
    for stacked in (False, True):
        if stacked:
            cfgs = [tc.default_law_config(type(sb)(*[x[b] for x in sb]),
                                          expected_flows=8.0, **kw)
                    for b, kw in enumerate(BATCH_SCALARS)]
            lcfg, want = tc.stack_law_configs(cfgs), BATCH_SCALARS
        else:
            lcfg, want = None, (SCALARS["default"],) * 2
        sim = fluid.make_slot_sim(topo, sb, law, 8, lcfg, legs[0][2],
                                  "megakernel", "cpu", expected_flows=8.0)
        tick = mk.make_tick(sim)
        p = tick.k4_params()
        assert p.law == ft.LAW_NAMES.index(law)
        assert p.div_fncc == int(stacked)
        base = tc.LawConfig()
        for b in range(2):
            for f in ("fncc_eta", "pulser_n", "bp_xoff", "bp_xon", "bp_md",
                      "pcc_eps", "pcc_b"):
                v = np.float32(want[b].get(f, getattr(base, f)))
                assert p.lawp[b, ft.LAW_PARAMS.index(f)].item() == v, f
            eta = np.float32(want[b].get("fncc_eta", base.fncc_eta))
            inv = (np.float32(1.0) / eta)
            assert p.lawp[b, ft.LAW_PARAMS.index("fncc_inv_eta")].item() \
                == inv
        carry = tick.init_carry(fluid.init_slot_state(sim))
        nchan = 3 + (law == "backpressure") + (law == "pulser")
        assert mk.ring_channels(sim.law) == ft.ring_channels(law) == nchan
        assert tuple(carry.state.hist_q.shape) == (2, 512, nchan * 81)
        assert (carry.state.pause is not None) == (law == "backpressure")
    i = ft.LAW_NAMES.index(law)
    with open(sup.FIG6_REF) as f:
        S = json.load(f)["slots"]
    for shape in ((S, 3, 288, 10, 34, 10), (128, 5, 80, 20, 4, 20)):
        lay = ft.layout(*shape, i)
        assert lay.smem and lay.nbytes <= ft.SMEM_BUDGET, (shape, lay)
        words = dict(ft._fields(*shape, i))
        assert words["pause"] == (shape[2] + 1 if law == "backpressure"
                                  else 0)
        for f in ft.STATE_FIELDS:
            assert words[f] == (shape[0] if f in ft.LAW_STATE[law] else 0)


# -------------------------------------------------------------------------
# phase 6e's and 6c's reference data
# -------------------------------------------------------------------------

def _f32_list(x):
    """float32 values as the shortest decimals that read back to them
    (None for a flow that did not complete)."""
    return [None if not np.isfinite(v) else float(str(v))
            for v in np.asarray(x, np.float32)]


def _reference_run(jcore, topo, sched, cfg, law, slots):
    """``repro``'s slot engine over one schedule: its FCTs (float32, in
    schedule order)."""
    sb = jcore.stack_flow_schedules([sched], topo.num_queues)
    st, _ = jcore.simulate_slots_batch(
        topo, sb, law, slots, cfg=cfg, record=False, backend="reference",
        expected_flows=sup.FEEDBACK_EXPECTED_FLOWS)
    return np.asarray(st.fct[0], np.float32)[:int(sched.start.shape[0])]


def _write_feedback_reference():
    """Both legs of ``feedback_fct.run(quick=False)`` for its seven laws,
    and ``run_paper_scale``'s scenario for the four feedback laws, through
    ``repro``'s slot engine on the CPU, written to
    tests/golden/torch_port_feedback.json."""
    jcore, _ = sup.import_repro()
    data = {"source": "repro.core.simulate_slots_batch, backend="
                      "'reference', on the legs of "
                      "benchmarks/feedback_fct.py::run(quick=False) and the "
                      "scenario of benchmarks/fig6_fct.py::run_paper_scale",
            "expected_flows": sup.FEEDBACK_EXPECTED_FLOWS, "legs": {}}
    rows = []
    for leg in sup.FEEDBACK_LEGS:
        topo, sched, cfg, slots, bqs = sup.feedback_scenario(jcore, leg)
        size = np.asarray(sched.size, np.float64)
        runs = {}
        for law in sup.FEEDBACK_LAWS + sup.FEEDBACK_BASELINES:
            t0 = time.time()
            fct = _reference_run(jcore, topo, sched, cfg, law, slots)
            stats = sup.feedback_fct_us(fct, size)
            rows.append(stats)
            runs[law] = {"fct_s": _f32_list(fct), "stats": stats}
            print(f"{leg} {law}: {stats} ({time.time() - t0:.1f} s)",
                  flush=True)
        data["legs"][leg] = {
            "n_flows": int(size.shape[0]), "slots": slots,
            "steps": cfg.steps, "victim_queues": [int(q) for q in bqs],
            "schedule_sha256": sup.schedule_checksum(
                np.asarray(sched.size), np.asarray(sched.start)),
            "runs": runs}
    data["verdict"] = sup.feedback_verdict(rows)
    topo, sched, cfg, slots = sup.fig6_scenario(jcore)
    size = np.asarray(sched.size, np.float64)
    paper = {"n_flows": int(size.shape[0]), "slots": slots,
             "steps": cfg.steps,
             "schedule_sha256": sup.schedule_checksum(
                 np.asarray(sched.size), np.asarray(sched.start)),
             "stats": {}, "fct_s": {}}
    for law in sup.FEEDBACK_LAWS:
        t0 = time.time()
        sb = jcore.stack_flow_schedules([sched], topo.num_queues)
        st, _ = jcore.simulate_slots_batch(
            topo, sb, law, slots, cfg=cfg, record=False,
            backend="reference", expected_flows=sup.PAPER_EXPECTED_FLOWS)
        fct = np.asarray(st.fct[0], np.float32)[:size.shape[0]]
        paper["fct_s"][law] = _f32_list(fct)
        paper["stats"][law] = sup.fig6_stats(fct, size)
        print(f"paper {law}: {paper['stats'][law]} "
              f"({time.time() - t0:.1f} s)", flush=True)
    data["paper"] = paper
    with open(sup.FEEDBACK_REF, "w") as f:
        json.dump(data, f)
    print(f"wrote {sup.FEEDBACK_REF}: verdict {data['verdict']}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(REPO, "src"))
    _write_feedback_reference()
