"""The port's host-side builders against ``repro``'s: the same seeds give
exactly the same arrays (fabric routes, topology, Poisson web-search
traces, schedules, slot-pool sizes)."""
import numpy as np
import pytest
import torch

import test_torch_support as sup

import repro_torch.core as tc

jcore, _ = sup.import_repro()


def _eq(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def _eq_tuple(got, want):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (int, float)):
            assert g == w, f
        else:
            _eq(g, w, f)


def test_leaf_spine_small_topology_and_routes():
    fj = jcore.LeafSpine(racks=2, hosts_per_rack=4, spines=2)
    ft = tc.LeafSpine(racks=2, hosts_per_rack=4, spines=2)
    _eq_tuple(ft.topology(device="cpu"), fj.topology())
    rng = np.random.default_rng(5)
    src = rng.integers(0, 8, 40)
    dst = (src + rng.integers(1, 8, 40)) % 8
    sizes, starts = rng.uniform(1e3, 1e6, 40), rng.uniform(0, 1e-3, 40)
    _eq_tuple(ft.make_flows(src, dst, sizes, starts, 1e-6, device="cpu"),
              fj.make_flows(src, dst, sizes, starts, 1e-6))


def test_paper_fabric_routes():
    fj, ft = jcore.LeafSpine(**sup.PAPER), tc.LeafSpine(**sup.PAPER)
    _eq_tuple(ft.topology(device="cpu"), fj.topology())
    n = fj.n_hosts
    src = np.repeat(np.arange(n), 3)
    dst = (src + np.tile([1, 40, 200], n)) % n
    for got, want in zip(ft.routes().select(src, dst),
                         fj.routes().select(src, dst)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", (1, 2))
def test_poisson_websearch_and_schedule(seed):
    fj, ft = jcore.LeafSpine(**sup.PAPER), tc.LeafSpine(**sup.PAPER)
    flj = jcore.poisson_websearch(fj, 0.6, 2e-3, 1e-6, seed=seed)
    flt = tc.poisson_websearch(ft, 0.6, 2e-3, 1e-6, seed=seed, device="cpu")
    _eq_tuple(flt, flj)
    _eq_tuple(tc.make_schedule(flt), jcore.make_schedule(flj))
    _eq_tuple(tc.poisson_websearch_schedule(ft, 0.6, 2e-3, 1e-6, seed=seed,
                                            device="cpu"),
              jcore.poisson_websearch_schedule(fj, 0.6, 2e-3, 1e-6,
                                               seed=seed))


def test_suggest_slots_and_single_bottleneck():
    fj, ft = jcore.LeafSpine(**sup.PAPER), tc.LeafSpine(**sup.PAPER)
    for seed in (1, 2):
        sj = jcore.make_schedule(jcore.poisson_websearch(fj, 0.6, 5e-3, 1e-6,
                                                         seed=seed))
        st = tc.make_schedule(tc.poisson_websearch(ft, 0.6, 5e-3, 1e-6,
                                                   seed=seed, device="cpu"))
        assert tc.suggest_slots(st, 1e-6) == jcore.suggest_slots(sj, 1e-6)
        s = np.asarray(sj.start)
        assert tc.peak_concurrency(s, s + 1e-4) == \
            jcore.peak_concurrency(s, s + 1e-4)
    topo_j, flows_j, _, _ = sup.golden_scenario(jcore)
    topo_t, flows_t, _, _ = sup.golden_scenario(tc, device="cpu")
    _eq_tuple(topo_t, topo_j)
    _eq_tuple(flows_t, flows_j)
    assert tc.websearch_mean() == jcore.websearch_mean()
