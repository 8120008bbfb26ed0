"""The port's chunk-streamed slot runs against its single-shot runs and
against ``repro``'s chunked runs, on the CPU.

Mirrors ``tests/test_chunk_stream.py`` (its 18-flow single bottleneck
through a pool of 8 slots, cut to 1 500 ticks):

* ``simulate_slots(..., chunk=C)`` is bit for bit the single-shot run for
  every C of ``CHUNK_GRID`` (C < S clamped up, C == S, primes, C == N,
  C > N) on the reference backend and on the megakernel backend (its
  plain tick; K4 on the card in ``test_torch_cuda.py`` and
  ``chip_smoke.py`` phase 6g), with the occupancy invariants on the way;
* the chunked runs equal ``repro``'s chunked runs bit for bit, live,
  also with a per-flow gamma (the window reads the schedule rows at the
  window-local index and the [N] law config at the global one) and under
  an impairment regime;
* ``_safe_ticks`` and ``_host_window`` equal ``repro``'s on seeded
  inputs;
* the rejections: ``record_every > 1``, the fused backend.

``repro`` is imported only through ``test_torch_support.import_repro``.
"""
import functools

import numpy as np
import pytest
import torch

import test_torch_support as sup

S = 8
STEPS = 1500
CHUNK_GRID = sup.CHUNK_GRID


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_bitmatch(got, want, what):
    st_c, rec_c = got
    st_0, rec_0 = want
    for name, a, b in (("q", rec_c.q, rec_0.q), ("fct", st_c.fct, st_0.fct),
                       ("w", st_c.w, st_0.w),
                       ("lam_f", rec_c.lam_f, rec_0.lam_f),
                       ("w_sum", rec_c.w_sum, rec_0.w_sum),
                       ("n_active", rec_c.n_active, rec_0.n_active),
                       ("hist_q", st_c.hist_q, st_0.hist_q),
                       ("hist_w", st_c.hist_w, st_0.hist_w)):
        assert np.array_equal(_host(a), _host(b), equal_nan=True), \
            f"{what}: {name} differs"
    assert int(st_c.cursor) == int(st_0.cursor), what


def _scenario(core, **dev):
    return sup.bottleneck18(core, steps=STEPS, **dev)


def _law_cfg(core, sched, gamma=False, arr=None):
    lcfg = core.default_law_config(core.schedule_as_flows(sched),
                                   expected_flows=8.0)
    if gamma:
        n = int(sched.start.shape[0])
        lcfg = lcfg._replace(gamma=arr(np.linspace(0.5, 0.95, n).astype(
            np.float32)))
    return lcfg


def _port(backend="reference", chunk=None, gamma=False, impair=False):
    import repro_torch.core as tc
    topo, sched, cfg = _scenario(tc, device="cpu")
    lcfg = _law_cfg(tc, sched, gamma, torch.tensor)
    imp = (sup.golden_impair_regime(tc, topo, device="cpu") if impair
           else None)
    return tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                             backend=backend, chunk=chunk, impair=imp,
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _single(backend="reference", gamma=False, impair=False):
    return _port(backend, None, gamma, impair)


@functools.lru_cache(maxsize=None)
def _repro(backend, chunk, gamma=False, impair=False):
    core, _ = sup.import_repro()
    import jax.numpy as jnp
    topo, sched, cfg = _scenario(core)
    lcfg = _law_cfg(core, sched, gamma, jnp.asarray)
    imp = sup.golden_impair_regime(core, topo) if impair else None
    return core.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                               backend=backend, chunk=chunk, impair=imp)


@pytest.mark.parametrize("backend", ["reference", "megakernel"])
@pytest.mark.parametrize("chunk", CHUNK_GRID)
def test_any_chunk_size_bitmatches_single_shot(backend, chunk):
    """The window size is a performance knob: any C (clamped into [S, N])
    gives the single-shot trajectory, on both backends."""
    from repro_torch.core import fluid
    out = _port(backend, chunk)
    _assert_bitmatch(out, _single(backend), f"{backend} chunk={chunk}")
    C = min(max(chunk, S), 18)
    assert fluid.LAST_CHUNKED["window"] == C
    if C < 18:
        assert max(fluid.LAST_CHUNKED["win_off"]) > 0


@pytest.mark.parametrize("chunk", [1, 13])
def test_chunk_boundary_invariants(chunk):
    """The active set never exceeds the pool, queues stay non-negative,
    every flow is admitted and completed, the tick counter is the
    horizon."""
    st, rec = _port("reference", chunk)
    assert int(_host(rec.n_active).max()) <= S
    assert float(_host(rec.q).min()) >= 0.0
    assert int(st.cursor) == 18
    assert int(st.hw) <= S
    assert np.isfinite(_host(st.fct)).all()
    assert int(st.t) == STEPS


@pytest.mark.parametrize("backend", ["reference", "megakernel"])
def test_chunked_matches_repro(backend):
    """The port's chunked run (C = S: the window slides every segment)
    against ``repro``'s chunked run of the same inputs, bit for bit."""
    _assert_bitmatch(_port(backend, 8), _repro(backend, 8),
                     f"{backend} chunk=8 against repro")


@pytest.mark.parametrize("backend", ["reference", "megakernel"])
def test_per_flow_gamma_chunked(backend):
    """A per-flow gamma: admission reads the schedule rows at ``f -
    win_off`` and the law config at ``f``; chunked == single-shot ==
    ``repro``'s chunked run."""
    got = _port(backend, 7, gamma=True)
    _assert_bitmatch(got, _single(backend, gamma=True),
                     f"{backend} per-flow gamma chunk=7")
    _assert_bitmatch(got, _repro(backend, 7, gamma=True),
                     f"{backend} per-flow gamma chunk=7 against repro")


def test_impaired_chunked():
    """Under an impairment regime (the golden scenario's: an oscillating
    link with random loss and jitter) the chunked run is the single-shot
    run on both backends, and ``repro``'s chunked run."""
    got = _port("megakernel", 7, impair=True)
    _assert_bitmatch(got, _single("megakernel", impair=True),
                     "impaired megakernel chunk=7")
    _assert_bitmatch(_port("reference", 7, impair=True),
                     _single("reference", impair=True),
                     "impaired reference chunk=7")
    _assert_bitmatch(got, _repro("megakernel", 7, impair=True),
                     "impaired chunk=7 against repro")


def test_window_helpers_equal_repro():
    """``_safe_ticks`` (the float32 bisection) and ``_host_window`` (with
    its inert padding) equal ``repro``'s on seeded inputs."""
    core, _ = sup.import_repro()
    from repro.core import fluid as jfluid
    from repro_torch.core import fluid
    import repro_torch.core as tc
    rng = np.random.default_rng(5)
    for _ in range(200):
        n = int(rng.integers(1, 60))
        start = np.sort(rng.uniform(0, 2e-3, n)).astype(np.float32)
        if rng.random() < 0.2:
            start[-int(rng.integers(1, n + 1)):] = np.inf
        w0, chunk = int(rng.integers(0, n)), int(rng.integers(1, 40))
        t0 = int(rng.integers(0, 2500))
        t_end = t0 + int(rng.integers(1, 3000))
        dt = float(rng.choice([1e-6, 0.5e-6, 2e-6]))
        assert fluid._safe_ticks(start, w0, chunk, t0, t_end, dt) == \
            jfluid._safe_ticks(start, w0, chunk, t0, t_end, dt)
    topo, sched, _ = _scenario(tc, device="cpu")
    jtopo, jsched, _ = _scenario(core)
    host = tc.FlowSchedule(*[x.numpy() for x in sched])
    jhost = type(jsched)(*[np.asarray(x) for x in jsched])
    for w0, chunk in ((0, 8), (5, 8), (12, 8), (17, 13), (0, 40)):
        got = fluid._host_window(host, w0, chunk, 1)
        want = jfluid._host_window(jhost, w0, chunk, 1)
        for f, a, b in zip(got._fields, got, want):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (f, w0, chunk)
            assert np.array_equal(a, b), (f, w0, chunk)


def test_chunk_rejections():
    """``record_every > 1`` and the fused backend raise ``ValueError`` with
    ``chunk=``, as in ``repro``."""
    import repro_torch.core as tc
    topo, sched, cfg = _scenario(tc, device="cpu")
    lcfg = _law_cfg(tc, sched)
    with pytest.raises(ValueError):
        tc.simulate_slots(topo, sched, "powertcp", S, lcfg,
                          cfg._replace(steps=512, record_every=8), chunk=8,
                          device="cpu")
    with pytest.raises(ValueError, match="fused"):
        tc.simulate_slots(topo, sched, "powertcp", S, lcfg, cfg,
                          backend="fused", chunk=8, device="cpu")
