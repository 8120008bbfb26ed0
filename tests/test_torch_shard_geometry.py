"""The sharded engine's static tables against ``repro``'s, exactly, with no
process group: ``shard_geometry`` and ``comm_census`` over a grid of pool
sizes, queue counts and rank counts (CSR layout and not), the halo send
and receive tables and their overflow flags on random hop lists, the
block-local Dynamic-Thresholds caps against ``fluid._buffer_caps``,
``build_csr_gather_padded``, and the sharded tick's regime evaluation
(``impair.regime_at``) against the three evaluators it stands for.

``repro`` is imported only through ``test_torch_support.import_repro``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import test_torch_support as sup

NDEV = (1, 2, 4, 8)


def _fields(core):
    return core.FlowSchedule._fields


def _sched_pair(path, tf):
    """The same host schedule (only ``path`` and ``tf_steps`` matter to
    the geometry) in both packages."""
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    n = path.shape[0]
    cols = {f: np.zeros(n, np.float32) for f in _fields(tc)}
    cols.update(path=path.astype(np.int32), tf_steps=tf.astype(np.int32),
                order=np.arange(n, dtype=np.int32))
    port = tc.FlowSchedule(**{f: torch.as_tensor(cols[f])
                              for f in _fields(tc)})
    ref = jcore.FlowSchedule(**{f: cols[f] for f in _fields(jcore)})
    return port, ref


def _random_path(rng, n, H, Q):
    path = rng.integers(0, Q + 1, size=(n, H)).astype(np.int32)
    return path, rng.integers(1, 9, size=(n, H)).astype(np.int32)


@pytest.mark.parametrize("H,Q", [(1, 1), (3, 40), (5, 80), (5, 5120)])
def test_shard_geometry_and_census_equal_repro(H, Q):
    jcore, _ = sup.import_repro()
    from repro.core import shardslots as jshard
    from repro_torch.core import shardslots as tshard
    rng = np.random.default_rng(H * 1000 + Q)
    for S in (8, 24, 64, 256, 1024):
        port, ref = _sched_pair(*_random_path(rng, 3 * S, H, Q))
        for ndev in NDEV:
            if S % ndev:
                continue
            got = tshard.shard_geometry(port, S, Q, ndev)
            want = jshard.shard_geometry(ref, S, Q, ndev)
            assert tuple(got) == tuple(want), (S, Q, ndev)
            assert got.use_csr == (S * H > 128)
            for record in (True, False):
                for incast in (True, False):
                    assert tshard.comm_census(got, S, H, Q, record,
                                              incast) == \
                        jshard.comm_census(want, S, H, Q, record, incast)


def _mi_pair(S, H, Q, ndev, path, tf):
    from repro.core import shardslots as jshard
    from repro_torch.core import shardslots as tshard
    port, ref = _sched_pair(path, tf)
    return (tshard.shard_geometry(port, S, Q, ndev),
            jshard.shard_geometry(ref, S, Q, ndev))


def _halo_case(seed, ndev, Sl, H, Q, hot):
    """Every rank's send tables, the all-to-all done by hand and every
    rank's receive table, through both packages: all equal. Returns
    whether any table overflowed."""
    import jax.numpy as jnp
    from repro.core import shardslots as jshard
    from repro_torch.core import shardslots as tshard
    rng = np.random.default_rng(seed)
    S = Sl * ndev
    path, tf = _random_path(rng, S, H, Q)
    if hot:   # an incast-hot queue: every slot's first hop
        path[:, 0] = Q // 2
    mi_t, mi_j = _mi_pair(S, H, Q, ndev, path, tf)
    send, flags = [], []
    for r in range(ndev):
        pl = path[r * Sl:(r + 1) * Sl]
        sel_t, qid_t, ovf_t = tshard._halo_send_tables(
            torch.as_tensor(pl), mi_t, Q)
        sel_j, qid_j, ovf_j = jshard._halo_send_tables(jnp.asarray(pl),
                                                       mi_j, Q)
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
        np.testing.assert_array_equal(qid_t.numpy(), np.asarray(qid_j))
        assert bool(ovf_t) == bool(ovf_j)
        send.append(qid_t.numpy())
        flags.append(bool(ovf_t))
    for d in range(ndev):
        rqid = np.stack([send[s][d] for s in range(ndev)])
        inv_t, ovf_t = tshard._halo_recv_csr(torch.as_tensor(rqid), mi_t)
        inv_j, ovf_j = jshard._halo_recv_csr(jnp.asarray(rqid), mi_j)
        np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
        assert bool(ovf_t) == bool(ovf_j)
        flags.append(bool(ovf_t))
    return any(flags)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_halo_tables_equal_repro(ndev):
    for seed in range(3):
        _halo_case(seed, ndev, Sl=32, H=5, Q=80, hot=False)
    # a hot destination block: the overflow flags too (at 8 ranks the
    # hot block's rows exceed ``cap``)
    hot = _halo_case(7, ndev, Sl=32, H=5, Q=80, hot=True)
    assert hot or ndev < 8


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), ndev=st.sampled_from([1, 2, 4]),
       Sl=st.integers(8, 40), H=st.integers(2, 5),
       Q=st.integers(4, 100), hot=st.booleans())
def test_halo_tables_equal_repro_random(seed, ndev, Sl, H, Q, hot):
    if Sl * ndev * H <= 128:
        Sl = 128 // (ndev * H) + 1
    _halo_case(seed, ndev, Sl, H, Q, hot)


def test_block_caps_equal_buffer_caps():
    """Each rank's block of the Dynamic-Thresholds caps equals the
    reference fold's (``fluid._buffer_caps``) bit for bit, its tables
    equal ``repro``'s, on the k = 4 fat tree at several depths."""
    jcore, _ = sup.import_repro()
    from repro.core import shardslots as jshard
    import repro_torch.core as tc
    from repro_torch.core import fluid, shardslots as tshard
    ft = tc.fat_tree(4)
    topo = ft.topology(device="cpu")
    jtopo = jcore.fat_tree(4).topology()
    Q = int(topo.num_queues)
    static = fluid._make_static(topo, 1e-6)
    rng = np.random.default_rng(0)
    for ndev in NDEV:
        mi = tshard.ShardInfo(ndev=ndev, Sl=8, Qb=-(-(Q + 1) // ndev),
                              use_csr=True, maxdeg=4, cap=8, rb_every=2)
        q1p = mi.Qb * ndev
        tabs_np = tshard._block_caps_tables(topo, mi, q1p)
        want = jshard._block_caps_tables(jtopo, jshard.ShardInfo(*mi), q1p)
        for a, b in zip(tabs_np, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        tabs = tuple(torch.as_tensor(x) for x in tabs_np)
        for _ in range(3):
            q = torch.as_tensor(rng.uniform(0, 3e5, Q + 1).astype(
                np.float32))
            q[-1] = 0.0
            caps = fluid._buffer_caps(topo, q[None], static)[0]
            qp = torch.cat([q, q.new_zeros(q1p - (Q + 1))])
            for d in range(ndev):
                gidx = d * mi.Qb + torch.arange(mi.Qb, dtype=torch.int32)
                got = tshard._block_caps(topo, tabs, qp, d, gidx)
                real = gidx <= Q
                torch.testing.assert_close(got[real],
                                           caps[gidx[real].long()],
                                           rtol=0, atol=0)


def test_build_csr_gather_padded_equals_repro():
    jcore, jkern = sup.import_repro()
    import jax.numpy as jnp
    from repro.kernels.queue_arrivals import build_csr_gather_padded as jb
    from repro_torch.kernels.queue_arrivals import \
        build_csr_gather_padded as tb
    rng = np.random.default_rng(3)
    for S, H, Q, maxdeg, rows in ((16, 3, 20, 4, 24), (40, 5, 80, 2, 84),
                                  (8, 1, 5, 8, 6)):
        path = rng.integers(0, Q + 1, size=(S, H)).astype(np.int32)
        inv_t, ovf_t = tb(torch.as_tensor(path)[None], Q, maxdeg, rows)
        inv_j, ovf_j = jb(jnp.asarray(path), Q, maxdeg, rows)
        np.testing.assert_array_equal(inv_t[0].numpy(), np.asarray(inv_j))
        assert bool(ovf_t[0]) == bool(ovf_j)


def test_regime_at_equals_the_three_evaluators():
    """``impair.regime_at`` (the sharded tick's regime: three draws hashed
    in one pass) is bit for bit ``link_bw_at``, ``1 - link_loss_at`` and
    ``link_jitter_at``, whole and on row slices at their ``qid0``, over
    every process and loss kind and times on and off the epoch edges."""
    from repro_torch.core import impair as ti
    from repro_torch.core.types import tree_map
    rows, bw = sup.impair_kind_rows(64, 4)
    p = ti._params_from_procs([ti.LinkProcess(**r) for r in rows], bw,
                              device="cpu")
    times = list(np.arange(0, 900, 13).astype(np.float32)
                 * np.float32(1e-6)) + [-1e-7, 0.0, 2.5e-6, 0.13, 3.0]
    for lo, hi in ((0, 64), (0, 21), (21, 42), (42, 64)):
        ps = tree_map(lambda a: a[lo:hi], p)
        for t in times:
            got = ti.regime_at(float(t), ps, lo)
            want = (ti.link_bw_at(float(t), ps, lo),
                    1.0 - ti.link_loss_at(float(t), ps, lo),
                    ti.link_jitter_at(float(t), ps, lo))
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True)
            torch.testing.assert_close(got[0], ti.link_bw_at(float(t), p)[
                lo:hi], rtol=0, atol=0, equal_nan=True)
