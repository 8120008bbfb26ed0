"""Shared support for the PyTorch port's tests (``tests/test_torch_*.py``).

* ``import_repro()`` imports the JAX reference package. On jax 0.9,
  ``repro.core.laws`` runs ``in`` on ``batching.primitive_batchers``,
  which is a ``PrimitiveBatchersProxy`` without ``__contains__``; the
  shim gives the proxy class one that looks in
  ``fancy_primitive_batchers`` (subscripting the proxy raises). jax 0.9
  already batches ``optimization_barrier``, so the shim only lets the
  check pass. It is idempotent and changes nothing on jax versions whose
  proxy can already answer ``in``.
* ``golden()`` loads ``tests/golden/golden_laws.json``; ``golden_scenario``
  rebuilds its scenario (the constants of ``tools/gen_golden.py``) in
  either package.
* seeded kernel inputs and the paper scenario's constants, shared by the
  tests and ``chip_smoke.py``, and the ``cuda_device`` fixture that
  card-only tests take (it skips without a card; the decision is made
  when the test runs, never at import).

This module imports neither ``jax`` nor ``repro`` at import time, so the
card-only tests and ``chip_smoke.py`` can use it where JAX is absent.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "golden_laws.json")
PAPER_REF = os.path.join(HERE, "golden", "torch_port_paper_seed1.json")


def apply_jax_shim() -> None:
    """Let ``x in batching.primitive_batchers`` work on jax 0.9."""
    import jax._src.interpreters.batching as _batching
    from jax.interpreters import batching
    proxy = type(batching.primitive_batchers)
    try:
        object() in batching.primitive_batchers
    except TypeError:
        proxy.__contains__ = (
            lambda self, p: p in _batching.fancy_primitive_batchers)


def import_repro():
    """``repro.core`` and ``repro.kernels``, imported with the shim."""
    apply_jax_shim()
    import repro.core
    import repro.kernels
    return repro.core, repro.kernels


def golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


# the scenario of tools/gen_golden.py (sched left out: the PowerTCP laws
# do not read it)
GOLDEN_STEPS = 200
GOLDEN_FLOWS = 4


def golden_scenario(core, **dev):
    """(topo, flows, law_cfg, cfg) of the golden traces, built by ``core``
    (``repro.core`` or ``repro_torch.core``; ``dev`` is passed to the
    port's builders)."""
    topo = core.single_bottleneck(bandwidth=25 * core.GBPS, buffer=6e6,
                                  dt_alpha=0.0, **dev)
    flows = core.make_flows_single(
        GOLDEN_FLOWS, tau=20 * core.US, nic=25 * core.GBPS,
        sizes=[30e3, 60e3, 120e3, float("inf")],
        starts=[0.0, 20e-6, 40e-6, 0.0], sim_dt=1e-6, **dev)
    cfg = core.SimConfig(dt=1e-6, steps=GOLDEN_STEPS, hist=64)
    lcfg = core.default_law_config(flows,
                                   expected_flows=float(GOLDEN_FLOWS))
    return topo, flows, lcfg, cfg


def pack(st, rec) -> dict:
    """A run in the golden file's layout (``tools/gen_golden._pack``)."""
    def host(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                          np.float64)
    fct = host(st.fct)
    return {"q": host(rec.q[:, 0]).tolist(),
            "w_final": host(st.w).tolist(),
            "w_sum": host(rec.w_sum)[::10].tolist(),
            "fct_us": [None if not np.isfinite(x) else x * 1e6
                       for x in fct]}


def check_golden(law, got, want, leg=""):
    """``tests/test_golden_traces.py::_check``'s tolerances."""
    np.testing.assert_allclose(got["q"], want["q"], rtol=1e-5, atol=0.5,
                               err_msg=f"{law}{leg}: queue trace drifted")
    np.testing.assert_allclose(got["w_final"], want["w_final"], rtol=1e-5,
                               err_msg=f"{law}{leg}: final windows drifted")
    np.testing.assert_allclose(got["w_sum"], want["w_sum"], rtol=1e-5,
                               err_msg=f"{law}{leg}: w_sum trace drifted")
    for g, w in zip(got["fct_us"], want["fct_us"]):
        assert (g is None) == (w is None), \
            f"{law}{leg}: flow completion set changed"
        if g is not None:
            assert g == pytest.approx(w, rel=1e-5), f"{law}{leg}: FCT drifted"


# the paper's 256-host fabric (benchmarks/fig6_fct.py::paper_fabric) and
# the main path's scenario (benchmarks/run.py::smoke_slots)
PAPER = dict(racks=8, hosts_per_rack=32, spines=2)
PAPER_LOAD = 0.6
PAPER_DURATION = 0.03
PAPER_DT = 1e-6
PAPER_STEPS = int((PAPER_DURATION + 0.01) / PAPER_DT)
PAPER_SLOTS = 384
PAPER_EXPECTED_FLOWS = 8.0


def schedule_checksum(size, start) -> str:
    """sha256 over the float32 sizes and starts in schedule order."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(size, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(start, np.float32)).tobytes())
    return h.hexdigest()


# kernel inputs (numpy, from a seed) at the simulator's magnitudes
QUEUE_DT = 1e-6


def law_inputs(F, H, seed=0):
    """Algorithm-1 inputs at the simulator's magnitudes, numpy float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    w = (np.abs(rng.standard_normal(F)) * 1e5 + 1e4).astype(f32)
    return dict(
        q=(np.abs(rng.standard_normal((F, H))) * 1e6).astype(f32),
        qdot=(rng.standard_normal((F, H)) * 1e8).astype(f32),
        mu=(np.abs(rng.standard_normal((F, H))) * 1e9).astype(f32),
        b=rng.choice([3.125e9, 12.5e9], (F, H)).astype(f32),
        valid=rng.random((F, H)) > 0.3,
        tau=rng.uniform(12e-6, 24e-6, F).astype(f32),
        w=w, w_old=(w * f32(0.9)).astype(f32),
        gs_prev=rng.uniform(0.5, 2.0, F).astype(f32),
        dt_obs=rng.choice([1e-6, 2e-6, 30e-6], F).astype(f32),
        upd=rng.random(F) > 0.5,
        beta=rng.uniform(1e3, 5e4, F).astype(f32))


def theta_inputs(F, seed=0):
    """Algorithm-2 inputs, numpy float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tau = rng.uniform(12e-6, 24e-6, F).astype(f32)
    w = (np.abs(rng.standard_normal(F)) * 1e5 + 1e4).astype(f32)
    return dict(
        theta=(tau * (1 + np.abs(rng.standard_normal(F)) * 0.5)).astype(f32),
        prev_theta=(tau * (1 + np.abs(rng.standard_normal(F)) * 0.5)
                    ).astype(f32),
        tau=tau, w=w, w_old=(w * f32(0.9)).astype(f32),
        gs_prev=rng.uniform(0.5, 2.0, F).astype(f32),
        dt_obs=rng.choice([1e-6, 2e-6, 30e-6], F).astype(f32),
        upd=rng.random(F) > 0.5,
        beta=rng.uniform(1e3, 5e4, F).astype(f32))


def queue_inputs(H, F, Q, seed=0):
    """K3 inputs: [H,F] rates, an [H,F,Q] one-hot with ~20% sentinel
    (all-zero) hops, and [Q] queues, service rates and caps."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    path = rng.integers(0, Q, (H, F))
    onehot = np.eye(Q, dtype=f32)[path]
    onehot[:, rng.random(F) < 0.2] = 0.0          # padded (sentinel) hops
    return dict(lam_del=(np.abs(rng.standard_normal((H, F))) * 3e9
                         ).astype(f32),
                onehot=onehot,
                q=(np.abs(rng.standard_normal(Q)) * 1e5).astype(f32),
                out_rate=rng.choice([3.125e9, 12.5e9], Q).astype(f32),
                caps=np.full(Q, 6e6, f32))


@pytest.fixture
def cuda_device():
    """The CUDA device for card-only tests; skips here without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


# -------------------------------------------------------------------------
# the support module's own tests
# -------------------------------------------------------------------------

def test_jax_shim_is_idempotent():
    apply_jax_shim()
    apply_jax_shim()
    from jax._src.lax.lax import optimization_barrier_p
    from jax.interpreters import batching
    assert optimization_barrier_p in batching.primitive_batchers
    assert object() not in batching.primitive_batchers
    core, _ = import_repro()
    assert "powertcp" in core.LAWS


def test_goldens_load():
    data = golden()
    for law in ("powertcp", "theta_powertcp"):
        leg = data[law]
        assert len(leg["q"]) == GOLDEN_STEPS
        assert len(leg["w_final"]) == len(leg["fct_us"]) == GOLDEN_FLOWS
        assert len(leg["w_sum"]) == GOLDEN_STEPS // 10
