"""K1/K2's observe form (``powertcp_observe_step``,
``theta_powertcp_observe_step``) and the engines' seam, on the CPU.

* The plain observe steps (``core/backends.py``) equal the sequence the
  engines ran before the observe form, reconstructed here op by op
  (``fluid._observe``, ``w_old``, ``upd``, ``dt_obs``,
  ``ref.*_step_ref``, the window clamp, the padded engine's hold, the
  update times), bit for bit: both laws, the padded engine with flows not
  yet started and the slot engine with slots admitted after their
  ``w_old`` row, fixed-period and RTT-paced updates, a batch of one and
  of two. Inputs are ``test_torch_support.observe_inputs`` (numpy, from
  a seed).
* The same inputs through ``repro``'s spelling of the observation (as
  ``repro.core.fluid.step`` and ``slot_step`` write it, eager ``jnp``)
  and ``repro.kernels.ref``'s laws, bit for bit.
* The seam: the fused laws' routines are what ``laws.observe_step``
  returns (and only for them); the engines call them once a tick; a fused
  run through them equals, bit for bit, the same run through the generic
  sequence with ``law.update`` (the registry entry removed).
* The kernel wrapper takes CUDA tensors only. Its card tests are in
  ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import test_torch_support as sup

LAWS = ("powertcp", "theta_powertcp")
ENGINES = ("padded", "slot")
PERIODS = (2e-6, 0.0)


def _inputs(engine, B, period, seed=0, F=24, Q=10, D=64, N=40):
    return sup.observe_inputs(engine, B, F, H=3, Q=Q, D=D,
                              N=None if engine == "padded" else N,
                              update_period=period, seed=seed)


def _todays_sequence(tc, law_name, static, cfg, x):
    """The tick's observation and law update as ``step`` / ``slot_step``
    spelled them inline before the observe form."""
    from repro_torch.core import fluid
    from repro_torch.core.types import MTU
    from repro_torch.kernels import ref
    D, dt = cfg.hist, cfg.dt
    lc = x.law_cfg
    if x.slot_flow is not None:
        gf = torch.clamp(x.slot_flow, 0, x.n_flows - 1)
        lc = fluid._gather_law_cfg(lc, gf, x.n_flows)
    q_obs, qdot, mu, _, theta_obs, wold_delay = fluid._observe(
        tc.get_law(law_name, "fused"), lc, static, cfg, x.ptr, x.hist_q,
        x.hist_out, x.path, x.valid, x.tf_steps, x.rtt_steps, x.tau,
        x.b_hop)
    w_old = fluid._ring(x.hist_w, torch.remainder(x.ptr - wold_delay, D),
                        x.rows)
    if x.admit_t is not None:
        w_old = torch.where(x.t - wold_delay >= x.admit_t, w_old,
                            x.nic * x.tau)
    upd = x.active & (x.t_sec >= x.next_update)
    dt_obs = torch.clamp_min(x.t_sec - x.last_update, dt)
    gs_prev = x.law_state.gamma_smooth
    if law_name == "powertcp":
        w, gs = ref.powertcp_step_ref(
            q_obs, qdot, mu, x.b_hop, x.valid, lc.tau, x.w, w_old, gs_prev,
            dt_obs, upd, lc.beta, gamma=0.9, w_min=MTU)
        state = (gs,)
    else:
        w, gs, prev = ref.theta_powertcp_step_ref(
            theta_obs, x.law_state.prev_theta, lc.tau, x.w, w_old, gs_prev,
            dt_obs, upd, lc.beta, gamma=0.9, w_min=MTU)
        state = (gs, prev)
    w = torch.minimum(torch.clamp_min(w, MTU),
                      8.0 * x.nic * x.tau + 8.0 * x.nic * x.theta_now)
    if x.started is not None:
        w = torch.where(x.started, w, x.w)
    if cfg.update_period > 0.0:
        nxt = float(np.float32(x.t_sec) + np.float32(cfg.update_period))
        next_update = torch.where(upd, nxt, x.next_update)
    else:
        next_update = torch.where(upd, x.t_sec + x.theta_now, x.next_update)
    last_update = torch.where(upd, x.t_sec, x.last_update)
    return state, w, next_update, last_update, dict(
        upd=upd, w_old_masked=None if x.admit_t is None
        else ~(x.t - wold_delay >= x.admit_t), wold_delay=wold_delay)


def _flat(out):
    """(law state leaves..., w, rate_cap, next_update, last_update) of a
    routine's result."""
    state, w, rate_cap, nu, lu = out
    return tuple(state) + (w, rate_cap, nu, lu)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("period", PERIODS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("law", LAWS)
def test_plain_observe_step_is_todays_sequence(law, engine, period, B):
    import repro_torch.core as tc
    from repro_torch.core import backends
    inp = _inputs(engine, B, period, seed=B)
    law_b, static, cfg, x = sup.observe_tick(tc, inp, law)
    state, w, nu, lu, seen = _todays_sequence(tc, law, static, cfg, x)
    plain = (backends.powertcp_observe_step_plain if law == "powertcp"
             else backends.theta_powertcp_observe_step_plain)
    got = _flat(plain(law_b, static, cfg, x))
    routine = _flat(tc.observe_step(law_b)(law_b, static, cfg, x))
    want = tuple(state) + (w, x.rate_cap, nu, lu)
    assert len(got) == len(want)
    for g, r, e in zip(got, routine, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(r, e, rtol=0, atol=0, equal_nan=True)
    # the inputs exercise every branch: rows that update and rows that do
    # not, a w_old older than the slot's admission, flows not started,
    # windows at either bound of the clamp, a clamped w_old delay
    upd = seen["upd"]
    assert 0 < int(upd.sum()) < upd.numel()
    if engine == "slot":
        assert int((seen["w_old_masked"] & upd).sum()) > 0
        assert int((x.slot_flow == inp["N"]).sum()) > 0
    else:
        assert int((~x.started).sum()) > 0
    assert int((w == 1000.0).sum()) + int((w == 8.0 * x.nic * x.tau
                                           + 8.0 * x.nic * x.theta_now
                                           ).sum()) > 0
    assert int((seen["wold_delay"][upd] == cfg.hist - 2).sum()) < \
        int(upd.sum())


def _jax_sequence(inp, law, b):
    """Scenario ``b`` of ``observe_inputs``' dict through ``repro``'s
    spelling of the observation (``repro.core.fluid.step``'s for the
    padded engine, ``slot_step``'s for the slot engine: eager ``jnp``) and
    ``repro.kernels.ref``'s law, the clamp, the hold and the update
    times."""
    import jax.numpy as jnp
    jcore, _ = sup.import_repro()
    from repro.core import fluid as jf
    from repro.kernels import ref as jref
    D, Q, dt = inp["D"], inp["Q"], inp["dt"]
    t, t_sec, ptr = inp["t"], inp["t_sec"], inp["t"] % D

    def a(k):
        return jnp.asarray(inp[k][b])
    path, tf, rtt = a("path"), a("tf_steps"), a("rtt_steps")
    tau, nic, theta_now = a("tau"), a("nic"), a("theta_now")
    hist_q, hist_out, hist_w = a("hist_q"), a("hist_out"), a("hist_w")
    bw = jnp.asarray(inp["bw"])
    valid = path < Q
    b_hop = bw[path]
    tb_steps = jnp.clip(rtt[:, None] - tf, 1, D - 2)
    ohidx = jnp.mod(ptr - tb_steps, D)
    ohprev = jnp.mod(ohidx - 1, D)
    q_obs = hist_q[ohidx, path]
    qdot = (q_obs - hist_q[ohprev, path]) * (1.0 / dt)
    mu = hist_out[ohidx, path]
    theta_obs = tau + jf._hop_sum(jnp.where(valid, q_obs / b_hop, 0.0))
    wold_delay = jnp.clip(jnp.round(theta_obs / dt).astype(jnp.int32), 1,
                          D - 2)
    w_old = hist_w[jnp.mod(ptr - wold_delay, D), jnp.arange(path.shape[0])]
    ctau, beta = a("cfg_tau"), a("cfg_beta")
    if inp["engine"] == "slot":
        gf = jnp.clip(a("slot_flow"), 0, inp["N"] - 1)
        ctau, beta = ctau[gf], beta[gf]
        w_old = jnp.where(t - wold_delay >= a("admit_t"), w_old, nic * tau)
    w = a("w")
    nu, lu = a("next_update"), a("last_update")
    upd = a("active") & (t_sec >= nu)
    dt_obs = jnp.maximum(t_sec - lu, dt)
    if law == "powertcp":
        wn, gs = jref.powertcp_step_ref(
            q=q_obs, qdot=qdot, mu=mu, b=b_hop, valid=valid, tau=ctau, w=w,
            w_old=w_old, gs_prev=a("gs_prev"), dt_obs=dt_obs, upd=upd,
            beta=beta, gamma=0.9, w_min=1000.0)
        state = (gs,)
    else:
        wn, gs, prev = jref.theta_powertcp_step_ref(
            theta=theta_obs, prev_theta=a("prev_theta"), tau=ctau, w=w,
            w_old=w_old, gs_prev=a("gs_prev"), dt_obs=dt_obs, upd=upd,
            beta=beta, gamma=0.9, w_min=1000.0)
        state = (gs, prev)
    wn = jnp.clip(wn, 1000.0, 8.0 * nic * tau + 8.0 * nic * theta_now)
    if inp["engine"] == "padded":
        wn = jnp.where(a("started"), wn, w)
    period = jnp.where(inp["update_period"] > 0.0,
                       jnp.float32(inp["update_period"]), theta_now)
    return tuple(np.asarray(x) for x in state + (
        wn, jnp.where(upd, t_sec + period, nu), jnp.where(upd, t_sec, lu)))


@pytest.mark.parametrize("period", PERIODS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("law", LAWS)
def test_plain_observe_step_matches_jax(law, engine, period):
    import repro_torch.core as tc
    from repro_torch.core import backends
    B = 2
    inp = _inputs(engine, B, period, seed=7)
    law_b, static, cfg, x = sup.observe_tick(tc, inp, law)
    plain = (backends.powertcp_observe_step_plain if law == "powertcp"
             else backends.theta_powertcp_observe_step_plain)
    state, w, _, nu, lu = plain(law_b, static, cfg, x)
    got = tuple(state) + (w, nu, lu)
    for b in range(B):
        for g, j in zip(got, _jax_sequence(inp, law, b)):
            np.testing.assert_array_equal(g[b].numpy(), j)


def test_observe_step_is_registered_for_the_fused_laws_only():
    import repro_torch.core as tc
    from repro_torch.core import backends
    assert tc.observe_step(tc.get_law("powertcp", "fused")) \
        is backends.powertcp_observe_step
    assert tc.observe_step(tc.get_law("theta_powertcp", "fused")) \
        is backends.theta_powertcp_observe_step
    for name in LAWS:
        for backend in ("reference", "megakernel"):
            assert tc.observe_step(tc.get_law(name, backend)) is None
    # a Law built around another update keeps the generic sequence
    other = tc.get_law("powertcp", "fused")._replace(
        update=tc.LAWS["powertcp"].update)
    assert tc.observe_step(other) is None
    with pytest.raises(KeyError):
        tc.register_observe_step("powertcp", "no_such_backend",
                                 backends.powertcp_observe_step)


def _small_run(tc, engine, law, steps=300):
    topo, sched, cfg = sup.staggered(tc, steps=steps, device="cpu")
    if engine == "padded":
        flows = tc.schedule_as_flows(sched)
        return tc.simulate(topo, flows, law,
                           tc.default_law_config(flows, expected_flows=8.0),
                           cfg, backend="fused", device="cpu")
    return tc.simulate_slots(topo, sched, law, 6,
                             tc.default_law_config(sched,
                                                   expected_flows=8.0),
                             cfg, backend="fused", device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("law", LAWS)
def test_engines_call_the_observe_step_once_a_tick(law, engine, monkeypatch):
    """A fused run calls the law's registered routine once a tick, and
    gives the bits of the same run through the generic sequence
    (``fluid._law_tick`` with the fused ``law.update``)."""
    import repro_torch.core as tc
    from repro_torch.core.laws import OBSERVE_STEPS
    key = (law, "fused")
    routine = OBSERVE_STEPS[key]
    calls = []

    def counted(*args):
        calls.append(1)
        return routine(*args)
    monkeypatch.setitem(OBSERVE_STEPS, key, counted)
    st, rec = _small_run(tc, engine, law)
    assert len(calls) == 300
    monkeypatch.delitem(OBSERVE_STEPS, key)
    st2, rec2 = _small_run(tc, engine, law)
    assert len(calls) == 300
    assert int(torch.isfinite(st.fct).sum()) > 0
    for f in ("w", "fct", "next_update", "last_update"):
        torch.testing.assert_close(getattr(st, f), getattr(st2, f), rtol=0,
                                   atol=0, equal_nan=True)
    for a, b in zip(st.law, st2.law):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for f in rec._fields:
        torch.testing.assert_close(getattr(rec, f), getattr(rec2, f),
                                   rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("law", LAWS)
def test_observe_kernels_take_cuda_tensors_only(law):
    import repro_torch.core as tc
    from repro_torch.core import backends
    from repro_torch.kernels.powertcp_step import (
        powertcp_observe_step, theta_powertcp_observe_step)
    inp = _inputs("slot", 1, 2e-6)
    law_b, static, cfg, x = sup.observe_tick(tc, inp, law)
    args = backends._kernel_args(static, cfg, x)
    with pytest.raises(ValueError, match="CUDA"):
        if law == "powertcp":
            powertcp_observe_step(hist_out=x.hist_out, **args)
        else:
            theta_powertcp_observe_step(
                prev_theta=x.law_state.prev_theta, **args)


def test_kernel_reads_law_config_leaves_by_their_shape():
    """``_cfg_mode``: a [B, 1] leaf is read per scenario, [B, F] per row,
    and on the slot engine [B, N] per schedule entry at the slots' flows;
    any other leaf raises."""
    import repro_torch.core as tc
    from repro_torch.kernels.powertcp_step import _cfg_mode
    inp = _inputs("slot", 2, 2e-6)
    _, _, _, x = sup.observe_tick(tc, inp, "powertcp")
    B, F, N = 2, 24, inp["N"]
    tau = x.law_cfg.tau
    assert _cfg_mode("cfg_tau", tau, B, F, N) == 2
    assert _cfg_mode("cfg_beta", torch.ones(B, 1), B, F, N) == 0
    assert _cfg_mode("cfg_beta", torch.ones(B, F), B, F, N) == 1
    assert _cfg_mode("cfg_beta", torch.ones(B, F), B, F, None) == 1
    with pytest.raises(ValueError, match="shape"):
        _cfg_mode("cfg_tau", tau, B, F, None)
    with pytest.raises(TypeError, match="tensor"):
        _cfg_mode("cfg_beta", 1000.0, B, F, N)
