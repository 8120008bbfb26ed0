"""The port's sharded engines over several ranks: gloo ranks spawned on
this host (``shardcomm.spawn``: a ``FileStore`` in a temporary directory,
no network), every run bit for bit the port's own unsharded engines,
which the other ``test_torch_*`` files hold to ``repro``.

Each width runs many checks in one spawn (a rank costs seconds to start).
At widths 2 and 4:

* the paper leaf-spine's impaired anchor
  (``test_torch_support.impair_paper_scenario``: 52 flows, 56 slots, the
  CSR layout, its first ``ANCHOR_STEPS`` ticks) for ``powertcp``,
  ``backpressure`` and ``pulser``, clean and under the mixed regime, the
  six runs split over the two widths so that each width covers the pause
  and the incast channel: every state leaf and record field the port's
  reference slot engine's;
* the replicated layout (the 12-flow single bottleneck, S * H = 12);
* a chunked run in the CSR layout (three incast bursts of 16 flows on
  the k = 4 fat tree, 100 us apart, in 32 slots, chunk 33: the window
  moves);
* a forced overflow at width 4: one incast of 96 flows into one host in
  96 slots, whose hot queue has more contributors than the gather
  table's width (``suggest_maxdeg`` falls back to 32 above 64): the
  agreed overflow flag is set and the ticks take the full gather (the
  halo tables' ``cap`` overflow is held against ``repro`` in
  ``test_torch_shard_geometry.py``);
* the batch split over the ranks: ``simulate_slots_batch`` (reference and
  megakernel backends) and ``simulate_batch`` with ``devices=W`` on a
  batch of 3 (padded by one at both widths) and ``run_sweep(devices=W)``,
  each leaf for leaf the unsharded call.

At width 8, ``test_shard_scenario``'s 8-device check: 20 flows in a pool
of 16 (2 slots a rank), whole and streamed in chunks of 9. And a rank
that raises fails the whole run.

The ranks import neither JAX nor ``repro``; nor does this file.
"""
import functools

import numpy as np
import pytest
import torch

import test_torch_support as sup

ANCHOR_STEPS = 400
SMALL_STEPS = 700
CHUNK_STEPS = 500
BATCH_STEPS = 300
# width -> the anchor's (law, regime) runs
ANCHOR_RUNS = {2: (("powertcp", "clean"), ("backpressure", "mixed"),
                   ("pulser", "clean")),
               4: (("powertcp", "mixed"), ("backpressure", "clean"),
                   ("pulser", "mixed"))}


def _tc():
    import repro_torch.core as tc
    return tc


def _bottleneck(n=12, steps=SMALL_STEPS, seed=0):
    tc = _tc()
    B = 100 * tc.GBPS
    topo = tc.single_bottleneck(bandwidth=B, buffer=16e6, device="cpu")
    rng = np.random.default_rng(seed)
    flows = tc.make_flows_single(n, tau=20 * tc.US, nic=B,
                                 sizes=rng.uniform(8e4, 4e5, n),
                                 starts=rng.uniform(0.0, 1.5e-3, n),
                                 sim_dt=1e-6, device="cpu")
    sched = tc.make_schedule(flows)
    cfg = tc.SimConfig(dt=1e-6, steps=steps, hist=256)
    return topo, sched, cfg, _lcfg(sched)


def _lcfg(sched):
    tc = _tc()
    return tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)


def _paper():
    tc = _tc()
    topo, sched, cfg, S, imp = sup.impair_paper_scenario(tc, device="cpu")
    return topo, sched, cfg._replace(steps=ANCHOR_STEPS), S, imp


def _fat_ws():
    tc = _tc()
    ft = tc.fat_tree(4)
    sched = tc.make_schedule(tc.poisson_websearch(ft, 0.25, 0.002, 1e-6,
                                                  seed=3, device="cpu"))
    cfg = tc.SimConfig(dt=1e-6, steps=BATCH_STEPS, hist=512,
                       update_period=2e-6)
    return ft, sched, cfg


def _incast(fan_in, n_bursts, steps):
    """Synchronized incast bursts on the k = 4 fat tree, ``period`` 100 us
    apart (``fan_in`` flows of 50 kB into one host each)."""
    tc = _tc()
    ft = tc.fat_tree(4)
    flows, _ = tc.incast_burst(ft, fan_in=fan_in, req_bytes=5e4,
                               n_bursts=n_bursts, period=1e-4, sim_dt=1e-6,
                               seed=1, device="cpu")
    cfg = tc.SimConfig(dt=1e-6, steps=steps, hist=512, update_period=2e-6)
    return ft.topology(device="cpu"), tc.make_schedule(flows), cfg


def _batch():
    """3 schedules of the fat tree (two seeds, the first twice) and their
    regimes (mixed, lossy, clean)."""
    tc = _tc()
    ft, sched, cfg = _fat_ws()
    other = tc.make_schedule(tc.poisson_websearch(ft, 0.25, 0.002, 1e-6,
                                                  seed=5, device="cpu"))
    topo = ft.topology(device="cpu")
    regs = sup.impair_regimes(tc, ft, device="cpu")
    sb = tc.stack_flow_schedules([sched, other, sched], topo.num_queues)
    imp = tc.stack_impairments([regs["mixed"], regs["lossy"],
                                regs["clean"]])
    return topo, sb, cfg._replace(steps=BATCH_STEPS), imp


def _sweep_spec():
    tc = _tc()
    ft, sched, cfg = _fat_ws()
    other = tc.make_schedule(tc.poisson_websearch(ft, 0.25, 0.002, 1e-6,
                                                  seed=5, device="cpu"))
    return ft.topology(device="cpu"), cfg._replace(steps=BATCH_STEPS), \
        tc.SweepSpec(laws=["powertcp", "pulser"],
                     flows=[tc.schedule_as_flows(s)
                            for s in (sched, other, sched)],
                     slots=40, expected_flows=8.0)


# -------------------------------------------------------------------------
# the runs: each is called on every rank (``devices`` or the group's
# size) and, with ``group=None`` and no devices, in this process as the
# unsharded reference
# -------------------------------------------------------------------------

def _run(name, group, W):
    tc = _tc()
    from repro_torch.core.shardslots import LAST_SHARDED
    kw = dict(group=group) if group is not None else {}

    def sharded(topo, sched, law, S, lcfg, cfg, **k):
        if group is None:
            return tc.simulate_slots(topo, sched, law, S, lcfg, cfg,
                                     device="cpu", **k), None
        out = tc.simulate_slots_sharded(topo, sched, law, S, lcfg, cfg,
                                        device="cpu", **kw, **k)
        return out, dict(LAST_SHARDED)

    kind, _, rest = name.partition(":")
    if kind == "anchor":
        law, regime = rest.split("/")
        topo, sched, cfg, S, imp = _paper()
        return sharded(topo, sched, law, S, _lcfg(sched), cfg,
                       impair=imp if regime == "mixed" else None)
    if kind == "bottleneck":
        topo, sched, cfg, lcfg = _bottleneck()
        return sharded(topo, sched, rest, 12, lcfg, cfg)
    if kind == "chunk":
        topo, sched, cfg = _incast(16, 3, CHUNK_STEPS)
        return sharded(topo, sched, rest, 32, _lcfg(sched), cfg, chunk=33)
    if kind == "incast":
        topo, sched, cfg = _incast(96, 1, BATCH_STEPS)
        return sharded(topo, sched, rest, 96, _lcfg(sched), cfg)
    if kind == "eight":
        topo, sched, cfg, lcfg = _bottleneck(n=20, steps=800)
        chunk = int(rest) if rest else None
        return sharded(topo, sched, "powertcp", 16, lcfg, cfg, chunk=chunk)
    dev = None if group is None else W
    if kind == "slots_batch":
        topo, sb, cfg, imp = _batch()
        return tc.simulate_slots_batch(
            topo, sb, "pulser", 40, cfg=cfg, backend=rest,
            expected_flows=8.0, impair_params=imp, devices=dev,
            device="cpu"), None
    if kind == "batch":
        topo, sb, cfg, imp = _batch()
        flows = tc.stack_flows([tc.schedule_as_flows(tc.scenario(sb, b))
                                for b in range(3)], topo.num_queues)
        return tc.simulate_batch(topo, flows, "backpressure", cfg=cfg,
                                 expected_flows=8.0, impair_params=imp,
                                 devices=dev, device="cpu"), None
    if kind == "sweep":
        topo, cfg, spec = _sweep_spec()
        res = tc.run_sweep(spec, topo, cfg, devices=dev, device="cpu")
        return (res.states, res.records, res.points), None
    raise ValueError(name)


def _rank_main(group, names):
    """Every check of one width on this rank; rank 0's results return."""
    return {n: _run(n, group, group.world) for n in names}


def _names(W):
    names = [f"anchor:{law}/{reg}" for law, reg in ANCHOR_RUNS.get(W, ())]
    if W == 8:
        return ["eight:", "eight:9"]
    names += ["bottleneck:pulser" if W == 2 else "bottleneck:backpressure",
              "chunk:powertcp" if W == 2 else "chunk:pulser",
              "slots_batch:reference", "batch:", "sweep:"]
    if W == 4:
        names += ["incast:powertcp", "slots_batch:megakernel"]
    return names


@functools.lru_cache(maxsize=None)
def _reference(name):
    return _run(name, None, 1)[0]


def _same(got, want, what):
    """Leaf for leaf, bit for bit (NaN equal to NaN); the reference
    engine's gather table ``inv`` is compared where both runs have one
    (the sharded single-scenario engine returns none)."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), what
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{what}: {m}")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (tuple, list)):
        fields = getattr(want, "_fields", range(len(want)))
        for f, x, y in zip(fields, got, want):
            if f == "inv" and x is None:
                continue
            _same(x, y, f"{what}.{f}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("W", [2, 4, 8])
def test_sharded_runs_bitmatch_unsharded(W):
    from repro_torch.core import shardcomm
    names = _names(W)
    got = shardcomm.spawn(_rank_main, W, (names,), device="cpu")
    for name in names:
        out, stats = got[name]
        _same(out, _reference(name), f"width {W} {name}")
        if stats is not None:
            assert stats["ndev"] == W
            csr = stats["geometry"]["use_csr"]
            assert csr == (not name.startswith(("bottleneck", "eight")))
            if name.startswith("incast"):
                assert stats["overflow_ticks"] > 0, stats
            if name.startswith("chunk") or name == "eight:9":
                assert stats["segments"] > 1, stats


def _failing_rank(group):
    if group.rank == 1:
        raise ValueError("rank 1 fails")
    group.barrier()
    return 0


def test_a_failing_rank_fails_the_run():
    """A rank's exception reaches the caller as the run's error: the rank
    that raised, or its peer's collective that lost it, whichever
    ``torch.multiprocessing.spawn`` sees first (the other rank is then
    stopped); no run quietly loses a rank."""
    from repro_torch.core import shardcomm
    with pytest.raises((torch.multiprocessing.ProcessRaisedException,
                        torch.multiprocessing.ProcessExitedException),
                       match="rank 1 fails|Connection|closed|reset"):
        shardcomm.spawn(_failing_rank, 2, device="cpu")
