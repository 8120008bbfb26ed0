"""The port's ``commsched`` against ``repro.commsched`` on the CPU.

* the nine tests of ``tests/test_commsched.py`` on the port (its outer
  sync over a one-rank gloo group);
* ``run_reduction`` for each controller on the steady, ``rdcn_bw_fn`` and
  ``contention_bg_fn`` links: every ``SimResult`` field equal to
  ``repro``'s; ``sync_plan`` and ``simulate_syncs`` equal;
* ``bucketize`` in JAX's flatten order (dict keys sorted) on trees whose
  insertion order is not sorted: the same buckets and key paths;
* ``quantize_int8`` bit for bit ``repro``'s eager form;
* the outer sync at one pod (a one-rank gloo group) bit for bit
  ``repro``'s jitted sync, and the one-process spelling
  (``test_torch_support.outer_sync_spelled``) bit for bit both;
* at 2 and 4 gloo ranks (``shardcomm.spawn``: ranks on this host, a
  ``FileStore`` in a temporary directory, no network), every rank's
  result bit for bit the spelling over all pods, with at most ``window``
  gathers in flight. ``repro`` is no yardstick there: its sync fails
  beyond one pod under jax 0.9 (``outer.py:146``, ``m[0]`` on a
  pod-sharded mean).

The spawned ranks import neither JAX nor ``repro``
(``test_torch_support.outer_sync_rank``).
"""
import numpy as np
import pytest
import torch

import test_torch_support as sup

from repro_torch import commsched as tcs
from repro_torch.commsched import outer as touter
from repro_torch.core import shardcomm

sup.apply_jax_shim()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from repro import commsched as jcs  # noqa: E402
from repro.commsched import simbackend as jsim  # noqa: E402

CONTROLLERS = ("theta_powertcp", "hpcc_like", "aimd", "static")


def _group():
    return shardcomm.one_rank_group("cpu")


# -- tests/test_commsched.py on the port -----------------------------------

def test_steady_link_all_controllers_fill():
    for name in CONTROLLERS:
        r = tcs.run_reduction(name, 5e8, tcs.DCNConfig())
        assert r.completion < 1.15 * r.optimal, (name, r.completion)


def test_powertcp_near_zero_queue_steady():
    r = tcs.run_reduction("theta_powertcp", 5e8, tcs.DCNConfig())
    bdp = 12.5e9 * 1e-3
    assert r.mean_queue < 0.1 * bdp
    a = tcs.run_reduction("aimd", 5e8, tcs.DCNConfig())
    assert a.mean_queue > 3 * max(r.mean_queue, 1.0)


def test_rdcn_powertcp_fills_circuit_bandwidth():
    cfg = tcs.DCNConfig(bw_fn=tcs.rdcn_bw_fn())
    p = tcs.run_reduction("theta_powertcp", 2e9, cfg)
    h = tcs.run_reduction("hpcc_like", 2e9, cfg)
    s = tcs.run_reduction("static", 2e9, cfg)
    assert p.completion < 1.5 * p.optimal
    assert p.completion < 0.5 * h.completion
    assert p.completion < 0.5 * s.completion


def test_bursty_contention_queue_tradeoff():
    from repro_torch.commsched.simbackend import contention_bg_fn
    cfg = tcs.DCNConfig(bg_fn=contention_bg_fn())
    p = tcs.run_reduction("theta_powertcp", 1e9, cfg)
    s = tcs.run_reduction("static", 1e9, cfg)
    assert p.completion < 1.25 * p.optimal
    assert p.mean_queue < 0.5 * s.mean_queue


def test_controller_convergence_time_constant():
    ccfg = tcs.ControllerConfig(tau=1e-3, bw_est=12.5e9)
    ctl = tcs.make_controller("theta_powertcp", ccfg)
    ctl.w = ctl.w_old = 8 * ctl.bdp
    t, start = 0.0, ctl.w
    for _ in range(10):
        t += 1e-3
        ctl.on_ack(t, 2e-3, 4e6)
    assert ctl.w < 0.15 * start
    idle = tcs.make_controller("theta_powertcp", ccfg)
    w0, t = idle.w, 0.0
    for _ in range(10):
        t += 1e-3
        idle.on_ack(t, 1e-3, 4e6)
    assert idle.w > w0


def test_bucketizer_deterministic_and_complete():
    tree = {"a": torch.zeros(1024), "b": torch.zeros(4096),
            "c": {"d": torch.zeros(128, 128)}}
    b1 = tcs.bucketize(tree, target_bytes=16e3)
    b2 = tcs.bucketize(tree, target_bytes=16e3)
    flat = [p for bucket in b1 for (p, _) in bucket]
    assert flat == [p for bucket in b2 for (p, _) in bucket]
    total = sum(leaf.numel() for bucket in b1 for (_, leaf) in bucket)
    assert total == 1024 + 4096 + 128 * 128


def test_window_to_buckets_bridge():
    assert tcs.window_to_buckets(1e9, 64e6, 32) == 16
    assert tcs.window_to_buckets(1e3, 64e6, 32) == 1
    assert tcs.window_to_buckets(1e12, 64e6, 32) == 32


def test_outer_sync_single_device_semantics():
    anchor = {"w": torch.ones(64)}
    local = {"w": torch.ones(64) * 0.5}
    ef = {"w": torch.zeros(64)}
    mom = {"w": torch.zeros(64)}
    sync = tcs.make_outer_sync(_group(), compress="int8_ef", window=1,
                               outer_lr=1.0, momentum=0.0)
    new_anchor, new_ef, _ = sync(anchor, local, ef, mom)
    np.testing.assert_allclose(new_anchor["w"].numpy(), 0.5, atol=0.01)
    assert float(torch.max(torch.abs(new_ef["w"]))) < 0.01


def test_straggler_bounded_staleness():
    from repro_torch.commsched.straggler import (StragglerPolicy,
                                                 simulate_syncs, sync_plan)
    r = simulate_syncs(npods=16, nsyncs=200, straggler_prob=0.08,
                       straggler_mult=6.0, seed=3)
    assert r["speedup"] > 1.3, r
    assert r["max_stale_pods"] <= 8
    healthy = simulate_syncs(npods=16, nsyncs=200, straggler_prob=0.0,
                             seed=4)
    assert 0.9 < healthy["speedup"] < 1.1
    plan = sync_plan([1.0, 1.1, 0.9, 10.0])
    assert plan["stale"] == [3]
    plan2 = sync_plan([1.0, 10.0, 10.0, 10.0],
                      StragglerPolicy(min_quorum=0.75))
    assert plan2["include"].sum() >= 3


# -- equal to repro --------------------------------------------------------

def _links():
    return {"steady": ({}, 5e8),
            "rdcn": (dict(bw_fn=("rdcn_bw_fn", {})), 2e9),
            "contention": (dict(bg_fn=("contention_bg_fn", {})), 1e9)}


@pytest.mark.parametrize("link", ("steady", "rdcn", "contention"))
@pytest.mark.parametrize("name", CONTROLLERS)
def test_run_reduction_matches_repro(name, link):
    kw, total = _links()[link]

    def cfg(pkg, sim):
        args = {k: getattr(sim, fn)(**a) for k, (fn, a) in kw.items()}
        return pkg.DCNConfig(**args)

    from repro_torch.commsched import simbackend as tsim
    got = tcs.run_reduction(name, total, cfg(tcs, tsim))
    want = jcs.run_reduction(name, total, cfg(jcs, jsim))
    for f in ("name", "completion", "mean_queue", "p99_queue", "mean_util",
              "optimal"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.trace.keys() == want.trace.keys()
    for k in want.trace:
        np.testing.assert_array_equal(got.trace[k], want.trace[k], err_msg=k)


def test_straggler_plans_match_repro():
    from repro.commsched import straggler as jst
    from repro_torch.commsched import straggler as tst
    rng = np.random.default_rng(7)
    for _ in range(50):
        ft = rng.lognormal(0.0, 0.5, int(rng.integers(1, 17))).tolist()
        q = float(rng.uniform(0.1, 1.0))
        got = tst.sync_plan(ft, tst.StragglerPolicy(min_quorum=q))
        want = jst.sync_plan(ft, jst.StragglerPolicy(min_quorum=q))
        assert got["start"] == want["start"]
        assert got["stale"] == want["stale"]
        np.testing.assert_array_equal(got["include"], want["include"])
    for kw in (dict(npods=16, nsyncs=200, straggler_prob=0.08,
                    straggler_mult=6.0, seed=3),
               dict(npods=5, nsyncs=50, seed=11)):
        assert tst.simulate_syncs(**kw) == jst.simulate_syncs(**kw)


def _jax_paths(buckets):
    def key(k):
        return getattr(k, "key", getattr(k, "idx", None))
    return [[tuple(key(k) for k in p) for p, _ in b] for b in buckets]


@pytest.mark.parametrize("target", (1.0, 4e3, 16e3, 1e9))
def test_bucketize_order_matches_repro(target):
    shapes = sup.outer_tree_shapes()
    tree = sup.outer_tree(shapes, 0)
    assert list(tree) != sorted(tree)            # insertion order unsorted
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tree)
    got = tcs.bucketize(tree, target_bytes=target)
    want = jcs.bucketize(jtree, target_bytes=target)
    assert [[p for p, _ in b] for b in got] == _jax_paths(want)
    for gb, wb in zip(got, want):
        for (_, g), (_, w) in zip(gb, wb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_int8_matches_repro_eager():
    rng = np.random.default_rng(3)
    for scale in (1.0, 1e-6, 3e4):
        x = (rng.standard_normal(4096) * scale).astype(np.float32)
        ef = (rng.standard_normal(4096) * scale * 1e-3).astype(np.float32)
        q, s, e = tcs.quantize_int8(torch.as_tensor(x), torch.as_tensor(ef))
        jq, js, je = jcs.quantize_int8(jnp.asarray(x), jnp.asarray(ef))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.dtype == torch.float32 and float(s) == float(js)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_array_equal(
            tcs.dequantize_int8(q, s).numpy(),
            np.asarray(jcs.dequantize_int8(jq, js)))
    # an all-zero tensor: the 1e-12 floor
    q, s, e = tcs.quantize_int8(torch.zeros(8), torch.zeros(8))
    jq, js, je = jcs.quantize_int8(jnp.zeros(8), jnp.zeros(8))
    assert float(s) == float(js)


def test_fma_is_one_rounding():
    """The outer sync's fused multiply-add against the test support's
    spelling (another algorithm) on random and midpoint inputs."""
    rng = np.random.default_rng(0)
    n = 200_000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    b[: n // 2] *= np.float32(2.0 ** -24)
    f = np.float32
    a[:3] = [f(1 + 2 ** -23), f(1 + 2 ** -23), -f(1 + 2 ** -23)]
    b[:3] = [f(2 ** -24 * (1 - 2 ** -23)), f(2 ** -24 * (1 + 2 ** -23)),
             f(2 ** -24 * (1 - 2 ** -23))]
    c[:3] = [f(1 + 2 ** -23), f(1.0), -f(1 + 2 ** -23)]
    a, b, c = map(torch.as_tensor, (a, b, c))
    got = touter._fma(a, b, c)
    assert torch.equal(got, sup.fma_spelled(a, b, c))
    assert got[:3].tolist() == [1 + 2 ** -23] * 2 + [-(1 + 2 ** -23)]


def _jax_sync(anchor, local, ef, mom, window, outer_lr=0.7, momentum=0.9):
    mesh = jax.make_mesh((1,), ("pod",))
    to = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x.numpy()), t)
    ja, jm = to(anchor), to(mom)
    jl = jax.tree_util.tree_map(lambda x: x[None], to(local))
    je = jax.tree_util.tree_map(lambda x: x[None], to(ef))
    sh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), ja)
    sync = jcs.make_outer_sync(mesh, sh, window=window, outer_lr=outer_lr,
                               momentum=momentum)
    na, ne, nm = jax.jit(sync)(ja, jl, je, jm)
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(na)],
            [np.asarray(x)[0] for x in jax.tree_util.tree_leaves(ne)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(nm)])


@pytest.mark.parametrize("window", (0, 1, 2, 3))
def test_outer_sync_one_pod_matches_repro(window):
    shapes = sup.outer_tree_shapes()
    anchor = sup.outer_tree(shapes, 1)
    mom = sup.outer_tree(shapes, 2, scale=0.01)
    local = sup.outer_tree(shapes, 3, scale=0.1)
    ef = sup.outer_tree(shapes, 4, scale=1e-3)
    want = _jax_sync(anchor, local, ef, mom, window)
    sync = tcs.make_outer_sync(_group(), window=window)
    got = sync(anchor, local, ef, mom)
    spelled = sup.outer_sync_spelled(anchor, [local], [ef], mom)
    spelled = (spelled[0], spelled[1][0], spelled[2])
    for what, g, s, w in zip(("anchor", "ef", "mom"), got, spelled, want):
        g = sup.sorted_leaves(g)
        assert len(g) == len(w) == len(s)
        for i, (gl, sl, wl) in enumerate(zip(g, s, w)):
            np.testing.assert_array_equal(gl.numpy(), wl,
                                          err_msg=f"{what} leaf {i}")
            np.testing.assert_array_equal(sl.numpy(), wl,
                                          err_msg=f"spelled {what} {i}")
    n = len(sup.sorted_leaves(anchor))
    assert sync.stats["gathers"] == n
    assert sync.stats["max_in_flight"] == (min(window, n) if window else n)


def test_outer_sync_uncompressed_one_pod_matches_repro():
    shapes = {"b": (9,), "a": (4, 4)}
    anchor, mom = sup.outer_tree(shapes, 1), sup.outer_tree(shapes, 2)
    local, ef = sup.outer_tree(shapes, 3), sup.outer_tree(shapes, 4)
    mesh = jax.make_mesh((1,), ("pod",))
    to = lambda t: {k: jnp.asarray(v.numpy()) for k, v in t.items()}  # noqa
    sh = {k: NamedSharding(mesh, P()) for k in shapes}
    jsync = jcs.make_outer_sync(mesh, sh, compress="none", window=1)
    na, ne, nm = jax.jit(jsync)(to(anchor), {k: v[None] for k, v in
                                              to(local).items()},
                                {k: v[None] for k, v in to(ef).items()},
                                to(mom))
    sync = tcs.make_outer_sync(_group(), compress="none", window=1)
    ga, ge, gm = sync(anchor, local, ef, mom)
    for k in shapes:
        np.testing.assert_array_equal(ga[k].numpy(), np.asarray(na[k]))
        np.testing.assert_array_equal(ge[k].numpy(), np.asarray(ne[k])[0])
        np.testing.assert_array_equal(gm[k].numpy(), np.asarray(nm[k]))


@pytest.mark.parametrize("world,window", ((2, 2), (4, 3)))
def test_outer_sync_gloo_ranks_match_spelling(world, window):
    shapes = sup.outer_tree_shapes()
    out = shardcomm.spawn(sup.outer_sync_rank, world,
                          (shapes, window, (11, 12, 20, 40)),
                          backend="gloo", device="cpu")
    n = len(sup.sorted_leaves(sup.outer_tree(shapes, 0)))
    assert out["leaves"] == n
    assert out["bad"] == [0] * world, out
    assert out["gathers"] == [n] * world
    assert out["max_in_flight"] == [window] * world


def test_qwen3_layer_tree_is_full_width():
    """Phase 6i.4's tree: one qwen3-14b decoder layer at full width."""
    def walk(t):
        return [t] if isinstance(t, tuple) else [x for k in sorted(t)
                                                 for x in walk(t[k])]
    leaves = walk(sup.qwen3_layer_shapes())
    assert len(leaves) == 11
    assert sum(int(np.prod(x)) for x in leaves) == 330_311_936
    assert (5120, 17408) in leaves and (17408, 5120) in leaves
