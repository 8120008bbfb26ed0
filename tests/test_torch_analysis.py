"""The port's ODE analysis (``core/analysis.py``) against ``repro``'s, on
the CPU.

Mirrors the ``analysis`` cases of ``tests/test_laws_equilibrium.py`` at
their tolerances (no unique equilibrium for the current-based class,
Theorem 2's decay constant, Theorem 1's eigenvalues) and holds the
trajectories and portraits to ``repro``'s ``lax.scan`` (float32 on both
sides, rtol 1e-5 with atol 1 byte: XLA compiles the Euler step with its
own fusions, which moves a queue near zero by a few hundredths of a byte
against a bandwidth-delay product of 250 kB).
"""
import numpy as np
import pytest

import test_torch_support as sup

KINDS = ("voltage_q", "voltage_delay", "current", "power")


def _an():
    from repro_torch.core import analysis
    return analysis


def test_current_based_has_no_unique_equilibrium():
    """Paper section 2.2 / Fig. 3b via the ODE model."""
    an = _an()
    cfg = an.ODEConfig()
    spread_current = an.endpoint_spread("current", cfg)
    spread_power = an.endpoint_spread("power", cfg)
    spread_voltage = an.endpoint_spread("voltage_q", cfg)
    assert spread_current > 10 * max(spread_power, 1e-6)
    assert spread_power < 0.05
    assert spread_voltage < 0.2


def test_convergence_time_constant():
    """Theorem 2 on the ODE: w(t) - w_e decays as exp(-gamma_r t)."""
    an = _an()
    cfg = an.ODEConfig()
    w_e, q_e = an.equilibrium_powertcp(cfg)
    path = np.asarray(an.trajectory("power", w0=2 * w_e, q0=q_e, cfg=cfg))
    t_idx = int(round((1.0 / cfg.gamma_r) / cfg.dt))
    err0 = 2 * w_e - w_e
    err_t = path[t_idx, 1] - w_e
    assert err_t / err0 == pytest.approx(np.exp(-1.0), rel=0.08)
    t5 = int(round((5.0 / cfg.gamma_r) / cfg.dt))
    assert abs(path[t5, 1] - w_e) / err0 < 0.012
    assert an.convergence_time_constant(0.9, 20e-6) == pytest.approx(
        20e-6 / 0.9)


def test_eigenvalues_negative():
    an = _an()
    e1, e2 = an.eigenvalues_powertcp(an.ODEConfig())
    assert e1 < 0 and e2 < 0


@pytest.mark.parametrize("kind", KINDS)
def test_trajectory_matches_repro(kind):
    """Each class's trajectory from one start, and its portrait over a
    3 x 3 grid of starts, against ``repro``'s."""
    core, _ = sup.import_repro()
    from repro.core import analysis as jan
    an = _an()
    cfg = an.ODEConfig(steps=1500)
    jcfg = jan.ODEConfig(steps=1500)
    bdp = cfg.b * cfg.tau
    got = an.trajectory(kind, 1.7 * bdp, 0.6 * bdp, cfg)
    want = np.asarray(jan.trajectory(kind, 1.7 * bdp, 0.6 * bdp, jcfg))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1.0)
    got = an.phase_portrait(kind, cfg, grid=3)
    want = jan.phase_portrait(kind, jcfg, grid=3)
    assert got.shape == want.shape == (9, 1500, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1.0)
    assert an.equilibrium_powertcp(cfg) == jan.equilibrium_powertcp(jcfg)
    assert an.eigenvalues_powertcp(cfg) == jan.eigenvalues_powertcp(jcfg)
    with pytest.raises(ValueError):
        an.window_dot("bogus", None, None, None, cfg)
