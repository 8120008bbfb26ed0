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
  tests and ``chip_smoke.py``; Fig. 8's scenario and grid
  (``fig8_scenario``, ``fig8_group``, ``fig8_metrics``; ``FIG8_REF``, the
  reference metrics of ``repro``'s run); ``smoke_slots_pool`` (the slot pool of
  ``benchmarks/run.py::smoke_slots``) and ``SMOKE_REF``, the reference
  FCTs of its batched runs; ``observe_inputs`` / ``observe_tick`` (one
  tick's inputs to K1/K2's observe form); ``k4_against_plain`` and
  ``k4_grid_against_plain`` (K4, and its grid of one block per scenario,
  against the plain megakernel block on the card); the sum orders of K3 and K5 spelled in
  torch (``queue_arrivals_in_k3_order``, ``flash_in_k5_order``,
  ``rmsnorm_in_k6_order``); Fig. 4's scenario, metrics and verdict
  (``fig4_*``, ``FIG4_REF``), HOMA's run arguments (``receiver_ids``, a
  copy of ``benchmarks/common.py::_receiver_ids``; ``homa_run_args``,
  ``homa_ws_scenario``), the generator legs of phase 6i
  (``generator_scenario``, ``GENERATORS_REF``), the outer sync's trees
  (``outer_tree``, ``qwen3_layer_shapes``), its one-process spelling
  (``outer_sync_spelled``, with ``fma_spelled``) and its spawned rank
  (``outer_sync_rank``); and the
  edge shapes the kernels are held at; the LM slice's shapes and bars
  (``SERVE_*``, ``LM_TIGHT_*``, ``lm_teacher_forced``); and the
  ``cuda_device`` fixture that
  card-only tests take (it skips without a card; the decision is made
  when the test runs, never at import).

This module imports neither ``jax`` nor ``repro`` at import time, so the
card-only tests and ``chip_smoke.py`` can use it where JAX is absent.
"""
import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "golden_laws.json")
PAPER_REF = os.path.join(HERE, "golden", "torch_port_paper_seed1.json")
SMOKE_REF = os.path.join(HERE, "golden", "torch_port_smoke_slots.json")
FIG6_REF = os.path.join(HERE, "golden", "torch_port_fig6_paper.json")


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

# benchmarks/fig6_fct.py::run_paper_scale: the five laws on the paper
# fabric at 60% load, 90 ms of arrivals + 40 ms drain (130 000 ticks),
# the pool from ``suggest_slots``
FIG6_LAWS = ("powertcp", "theta_powertcp", "hpcc", "timely", "dcqcn")
FIG6_DURATION = 0.09
FIG6_STEPS = int((FIG6_DURATION + 0.04) / PAPER_DT)
FIG6_SEED = 1


def fig6_stats(fct, size) -> dict:
    """``benchmarks/common.py::fct_stats`` of one run: the p99.9 FCT (in
    us) of the short (< 10 kB), medium (100 kB - 1 MB) and long (> 1 MB)
    flows that completed, and the count completed."""
    fct = np.asarray(fct, np.float64)
    size = np.asarray(size, np.float64)
    done = np.isfinite(fct) & np.isfinite(size)
    out = {"completed": int(done.sum())}
    for name, m in (("short", size < 10e3),
                    ("med", (size >= 100e3) & (size <= 1e6)),
                    ("long", size > 1e6)):
        sel = done & m
        out[f"{name}_p999_us"] = (float(np.percentile(fct[sel], 99.9)) * 1e6
                                  if sel.any() else float("nan"))
    return out


def fig6_claims(stats: dict) -> bool:
    """``run_paper_scale``'s four orderings on short-flow p99.9."""
    p = {law: s["short_p999_us"] for law, s in stats.items()}
    return bool(p["powertcp"] <= 1.10 * p["hpcc"]
                and p["theta_powertcp"] <= 1.15 * p["hpcc"]
                and p["powertcp"] < 0.9 * p["timely"]
                and p["powertcp"] < 0.6 * p["dcqcn"])


def fig6_scenario(core, **dev):
    """(topo, schedule, cfg, slots) of ``run_paper_scale`` in either
    package."""
    fab = core.LeafSpine(**PAPER)
    flows = core.poisson_websearch(fab, PAPER_LOAD, FIG6_DURATION, PAPER_DT,
                                   seed=FIG6_SEED, **dev)
    sched = core.make_schedule(flows)
    cfg = core.SimConfig(dt=PAPER_DT, steps=FIG6_STEPS, hist=512,
                         update_period=2e-6)
    return (fab.topology(**dev), sched, cfg,
            int(core.suggest_slots(sched, PAPER_DT)))


# benchmarks/feedback_fct.py::run: the four feedback-channel laws and the
# receiver-echo baselines on the k = 4 fat-tree (5-hop inter-pod ECMP
# paths), one leg of web-search arrivals (``fabric_fct.anchor_scenario``:
# load 0.25, seed 3, the pool from ``suggest_slots``) and one of repeated
# incast bursts (``incast_scenario``: fan-in 8 of 200 kB, 2 ms apart,
# seed 1, a slot per flow); ``FEEDBACK_REF`` holds ``repro``'s slot-engine
# FCTs of both legs (``quick=False``) and of the four laws at phase 6c's
# paper scale
FEEDBACK_REF = os.path.join(HERE, "golden", "torch_port_feedback.json")
FEEDBACK_LAWS = ("fncc", "pulser", "backpressure", "pcc")
FEEDBACK_BASELINES = ("powertcp", "hpcc", "timely")
FEEDBACK_DT = 1e-6
FEEDBACK_EXPECTED_FLOWS = 8.0
FEEDBACK_LEGS = ("ws", "incast")
# a batch of two whose feedback-law scalars differ by scenario
FEEDBACK_BATCH_SCALARS = (
    dict(fncc_eta=0.9, pulser_n=4.0, bp_xoff=5e5, bp_xon=2e5, pcc_eps=0.05,
         pcc_b=512.0),
    dict(fncc_eta=0.97, pulser_n=8.0, bp_xoff=2e6, bp_xon=1e6, pcc_eps=0.1,
         pcc_b=200.0))


def feedback_scenario(core, leg, quick=False, steps=None, **dev):
    """(topo, schedule, cfg, slots, victim queues) of one leg of
    ``feedback_fct.run`` in either package: ``"ws"`` (web-search over 4
    ms, 2 ms quick, plus 4 ms of drain) or ``"incast"`` (3 bursts, 2
    quick; 9 000 ticks); ``steps`` cuts the run (the widths unchanged)."""
    dt = FEEDBACK_DT
    ft = core.fat_tree(4)
    if leg == "ws":
        duration = 0.002 if quick else 0.004
        flows = core.poisson_websearch(ft, 0.25, duration, dt, seed=3,
                                       **dev)
        bqs = []
        sched = core.make_schedule(flows)
        cfg = core.SimConfig(dt=dt, steps=int((duration + 0.004) / dt),
                             hist=512, update_period=2e-6)
        slots = int(core.suggest_slots(sched, dt))
    else:
        flows, bqs = core.incast_burst(ft, fan_in=8, req_bytes=2e5,
                                       n_bursts=2 if quick else 3,
                                       period=2e-3, sim_dt=dt, seed=1,
                                       **dev)
        sched = core.make_schedule(flows)
        cfg = core.SimConfig(dt=dt, steps=9000, hist=512,
                             update_period=2e-6)
        slots = int(sched.start.shape[0])
    if steps is not None:
        cfg = cfg._replace(steps=int(steps))
    return ft.topology(**dev), sched, cfg, slots, bqs


def feedback_fct_us(fct, size) -> dict:
    """``feedback_fct._fct_us`` of one run: ``fct_stats``' p99.9 and mean
    FCTs (us) of the short (< 10 kB) and of all flows that completed,
    None where none did, and the count completed."""
    fct = np.asarray(fct, np.float64)
    size = np.asarray(size, np.float64)
    done = np.isfinite(fct) & np.isfinite(size)
    out = {"completed": int(done.sum())}
    for name, m in (("short", size < 10e3), ("all", np.ones_like(done))):
        sel = done & m
        for stat, fn in (("p", lambda x: np.percentile(x, 99.9)),
                         ("mean", np.mean)):
            out[f"{name}_{stat}"] = (round(float(fn(fct[sel])) * 1e6, 3)
                                     if sel.any() else None)
    return out


def feedback_verdict(rows) -> bool:
    """``feedback_fct.run``'s return: every run's mean FCT is defined
    (``rows``: each run's ``feedback_fct_us``)."""
    return all(r["all_mean"] is not None for r in rows)


# benchmarks/fig8_rdcn.py (claim C5): ``rdcn_setup(weeks=4, slots=(0, 6))``
# — 8 flows at 25G into one VOQ, 4 weeks of 1 us ticks — and
# ``rdcn_specs``' grid: the three window laws and reTCP at both
# prebuffers, each law one group whose scenarios are its (prebuffer,
# schedule) pairs, prebuffer-major (``repro.core.sweep.expand``'s order)
FIG8_REF = os.path.join(HERE, "golden", "torch_port_fig8.json")
FIG8_SLOTS = (0, 6)
FIG8_WEEKS = 4
FIG8_PREBUFFERS = (1800e-6, 600e-6)
FIG8_EXPECTED_FLOWS = 32.0
FIG8_GROUPS = (("powertcp", (None,)), ("theta_powertcp", (None,)),
               ("hpcc", (None,)), ("retcp", FIG8_PREBUFFERS))


def fig8_scenario(core, weeks=FIG8_WEEKS, **dev):
    """(topo, flows, cfg, schedules) of ``rdcn_setup`` in either
    package."""
    scheds = [core.CircuitSchedule(slot=s) for s in FIG8_SLOTS]
    topo = core.voq_topology(scheds[0], **dev)
    dt = 1e-6
    flows = core.make_flows_single(8, tau=24e-6, nic=25 * 12.5e8,
                                   sim_dt=dt, **dev)
    cfg = core.SimConfig(dt=dt, steps=int(weeks * scheds[0].week / dt),
                         hist=256, update_period=0.0)
    return topo, flows, cfg, scheds


def fig8_point_name(law, prebuffer) -> str:
    """``fig8_rdcn.point_name``: reTCP's rows carry their prebuffer."""
    if prebuffer is None:
        return law
    return f"retcp_{int(round(prebuffer * 1e6))}us"


def fig8_group(core, law, prebuffers, src, scheds, **dev):
    """One law group of the grid as ``run_sweep`` builds it: (the points
    [(name, schedule slot)], the stacked law config, the stacked
    schedules ``bw_params``), a scenario per (prebuffer, schedule). Each
    config is the paper default over ``src`` (the flows or their
    schedule) with ``expected_flows`` 32, the scenario's schedule as
    ``sched`` and its prebuffer."""
    pts, cfgs, sch = [], [], []
    for pb in prebuffers:
        for sc in scheds:
            kw = {} if pb is None else {"retcp_prebuffer": pb}
            cfgs.append(core.default_law_config(
                src, expected_flows=FIG8_EXPECTED_FLOWS,
                sched=sc.params(**dev), **kw))
            pts.append((fig8_point_name(law, pb), sc.slot))
            sch.append(sc)
    return pts, core.stack_law_configs(cfgs), core.stack_schedules(sch,
                                                                   **dev)


def fig8_metrics(core, rec, sched, first=None) -> dict:
    """``fig8_rdcn.point_metrics`` of one scenario's record (circuit
    utilization and p99 queuing latency in s) and the mean queue, over
    the first ``first`` ticks (default all)."""
    n = first or int(rec.t.shape[0])
    t, q, thru = rec.t[:n], rec.q[:n, 0], rec.thru[:n, 0]
    if isinstance(q, torch.Tensor):
        # the eager engines keep the record's times on the host
        t = t.to(q.device)
    util = core.circuit_utilization(t, thru, sched)
    p99 = core.queuing_latency_percentile(q, t, sched, 99.0)
    qh = np.asarray(q.cpu() if isinstance(q, torch.Tensor) else q)
    return {"util": util, "p99_s": p99, "mean_q": float(qh.mean())}


def fig8_claims(rows: dict) -> bool:
    """``fig8_rdcn.run``'s claims over the slot-0 rows (``fig8_metrics``;
    the latencies compared in us, as ``run`` compares them)."""
    us = {k: v["p99_s"] * 1e6 for k, v in rows.items()}
    p = rows["powertcp"]
    return bool(p["util"] >= 0.85
                and us["powertcp"] * 2 <= us["retcp_1800us"]
                and us["powertcp"] * 2 <= us["retcp_600us"]
                and p["util"] >= rows["hpcc"]["util"]
                and us["powertcp"] <= 0.6 * us["hpcc"])


# benchmarks/impair_fct.py (per-link impairments, DESIGN.md section 17):
# ``smoke_impair``'s anchor, the k = 4 fat tree's web-search leg of 4 ms
# plus 4 ms of drain (``feedback_scenario``'s, a slot per flow) under
# ``anchor_impairments``' regimes, and the impaired pass of
# ``fabric_fct._fabric16_anchor_bitmatch`` on the paper's 256-host
# leaf-spine; ``IMPAIR_REF`` holds ``repro``'s slot-engine FCTs of both
IMPAIR_REF = os.path.join(HERE, "golden", "torch_port_impair.json")
IMPAIR_LAWS = ("powertcp", "hpcc", "timely")
IMPAIR_REGIMES = ("mixed", "oscillate", "lossy", "clean")
IMPAIR_PAPER_LAWS = ("powertcp", "backpressure", "pulser")
IMPAIR_EXPECTED_FLOWS = 8.0


def golden_impair_regime(core, topo, **dev):
    """``tools/gen_golden.py::impair_regime`` in either package: the golden
    scenario's one link oscillating down to 10 GB/s over 50 us, with 1%
    random loss and 1 us jitter (seed 7)."""
    bw = topo.bandwidth
    bw = np.asarray(bw.cpu() if isinstance(bw, torch.Tensor) else bw,
                    np.float32)
    proc = core.LinkProcess(kind="oscillate", bw_lo=10 * core.GBPS,
                            period=50 * core.US, loss=0.01, random_loss=True,
                            jitter=1e-6, seed=7)
    return core.impair._params_from_procs([proc], bw, **dev)


def impair_kind_rows(n=64, seed=0):
    """``LinkProcess`` fields (dicts) of ``n`` links of every process and
    loss kind, with random periods (zero ones among them), phases before
    and after 0 and seeds over the whole uint32 range, and the links'
    rates."""
    rng = np.random.default_rng(seed)
    kinds = ("const", "schedule", "oscillate", "fading")
    rows = []
    for i in range(n):
        k = kinds[i % 4]
        per = float(rng.choice([0.0, 1e-6, 3e-6, 50e-6])
                    if k in ("const", "fading")
                    else rng.choice([1e-6, 7e-6, 200e-6]))
        rows.append(dict(kind=k, bw_lo=float(rng.uniform(1e9, 5e9)),
                         period=per, up=per * 0.4,
                         t0=float(rng.uniform(-1e-4, 1e-3)),
                         loss=float(rng.uniform(0, 0.5)),
                         random_loss=bool(i % 3),
                         jitter=float(rng.uniform(0, 2e-6)),
                         seed=int(rng.integers(0, 2 ** 32))))
    return rows, rng.uniform(1e9, 1.25e10, n).astype(np.float32)


def impair_regimes(core, ft, **dev):
    """``impair_fct.anchor_impairments(ft)`` in either package: the
    ToR -> host links oscillating down to 2.5 GB/s over 200 us (seed 5),
    every other link ``netem(loss=0.01, jitter=1e-6, seed=9)``, each alone,
    and the zero preset; by name, in ``IMPAIR_REGIMES``' order."""
    tor, host = core.fabric.TOR, core.fabric.HOST
    osc = core.LinkProcess(kind="oscillate", bw_lo=2.5e9, period=200e-6,
                           seed=5)
    lossy = core.netem(loss=0.01, jitter=1e-6, seed=9)
    return {
        "mixed": core.fabric_impairments(ft, rules={(tor, host): osc},
                                         default=lossy, **dev),
        "oscillate": core.fabric_impairments(ft, rules={(tor, host): osc},
                                             **dev),
        "lossy": core.fabric_impairments(ft, default=lossy, **dev),
        "clean": core.no_impairment(ft.topology(**dev)),
    }


def impair_anchor_scenario(core, steps=None, **dev):
    """(topo, schedule, cfg, slots, regimes) of ``smoke_impair``'s anchor:
    37 flows over 8 000 ticks, a slot per flow (``steps`` cuts the run)."""
    topo, sched, cfg, _, _ = feedback_scenario(core, "ws", steps=steps,
                                               **dev)
    return (topo, sched, cfg, int(sched.start.shape[0]),
            impair_regimes(core, core.fat_tree(4), **dev))


def impair_paper_scenario(core, **dev):
    """(topo, schedule, cfg, slots, regime) of the impaired pass of
    ``fabric_fct._fabric16_anchor_bitmatch``: the paper's leaf-spine (8
    racks of 32 hosts, 2 spines), web-search at load 0.3 over 1.2 ms, seed
    11, 3 000 ticks, the pool ``suggest_slots`` rounded up to 8, and the
    mixed regime."""
    ls = core.compile_routes(core.leaf_spine_fabric(**PAPER))
    sched = core.make_schedule(core.poisson_websearch(ls, 0.3, 0.0012,
                                                      PAPER_DT, seed=11,
                                                      **dev))
    slots = -(-int(core.suggest_slots(sched, PAPER_DT)) // 8) * 8
    cfg = core.SimConfig(dt=PAPER_DT, steps=3000, hist=512,
                         update_period=2e-6)
    tor, host = core.fabric.TOR, core.fabric.HOST
    imp = core.fabric_impairments(
        ls, rules={(tor, host): core.LinkProcess(
            kind="oscillate", bw_lo=2.5e9, period=200e-6, seed=5)},
        default=core.netem(loss=0.01, jitter=1e-6, seed=9), **dev)
    return ls.topology(**dev), sched, cfg, slots, imp


# benchmarks/fault_fct.py: ``crash_resume_paper_scale`` (the paper's
# 256-host fabric, web-search at load 0.6 over 8 ms plus 8 ms of drain,
# seed 1, the pool from ``suggest_slots``, megakernel backend; snapshots
# every 3/8 of the run, a crash at 9/16) and ``guard_divergence`` (18 flows
# on one 100 Gbps bottleneck, PowerTCP poisoned from 0.5 ms, chunk 8,
# guarded). ``FAULT_REF`` holds ``repro``'s FCTs of the first and its
# diagnosis of the second
FAULT_REF = os.path.join(HERE, "golden", "torch_port_fault.json")
FAULT_LOAD, FAULT_DURATION, FAULT_SEED = 0.6, 0.008, 1
FAULT_CHUNK = 2048
FAULT_GUARD_AT = 0.5e-3
# test_chunk_stream.py's adversarial chunk sizes: C < S (clamped up),
# C == S, primes, C == N and C > N
CHUNK_GRID = [1, 3, 7, 8, 13, 18, 29, 40]


def fault_scenario(core, **dev):
    """(topo, schedule, cfg, slots, checkpoint cadence, crash tick) of
    ``fault_fct.crash_resume_paper_scale`` in either package."""
    fab = core.LeafSpine(**PAPER)
    flows = core.poisson_websearch(fab, FAULT_LOAD, FAULT_DURATION,
                                   PAPER_DT, seed=FAULT_SEED, **dev)
    sched = core.make_schedule(flows)
    steps = int((FAULT_DURATION + 0.008) / PAPER_DT)
    cfg = core.SimConfig(dt=PAPER_DT, steps=steps, hist=512,
                         update_period=2e-6)
    return (fab.topology(**dev), sched, cfg,
            int(core.suggest_slots(sched, PAPER_DT)),
            max(1, (steps * 3) // 8), (steps * 9) // 16)


def bottleneck18(core, steps=2500, hist=256, seed=2, **dev):
    """``tests/test_chunk_stream.py::_scenario`` in either package: 18
    flows of 60-300 kB on one 100 Gbps bottleneck, starting in the first
    1.2 ms (``fault_fct.guard_divergence`` runs it with ``hist=512``)."""
    B = 100 * core.GBPS
    topo = core.single_bottleneck(bandwidth=B, buffer=16e6, **dev)
    rng = np.random.default_rng(seed)
    n = 18
    flows = core.make_flows_single(n, tau=20 * core.US, nic=B,
                                   sizes=rng.uniform(6e4, 3e5, n),
                                   starts=rng.uniform(0.0, 1.2e-3, n),
                                   sim_dt=1e-6, **dev)
    return (topo, core.make_schedule(flows),
            core.SimConfig(dt=1e-6, steps=steps, hist=hist))


def resume_mismatches(st_a, rec_a, st_b, rec_b) -> list:
    """The fields of ``fault_fct._bitmatch`` (the resume contract) in
    which two runs differ: the queue trace, FCTs, windows, per-slot rates,
    sums, the cursor and the rings; [] when they are bit for bit equal."""
    def host(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)

    pairs = dict(q=(rec_a.q, rec_b.q), fct=(st_a.fct, st_b.fct),
                 w=(st_a.w, st_b.w), lam_f=(rec_a.lam_f, rec_b.lam_f),
                 w_sum=(rec_a.w_sum, rec_b.w_sum),
                 n_active=(rec_a.n_active, rec_b.n_active),
                 hist_q=(st_a.hist_q, st_b.hist_q),
                 hist_w=(st_a.hist_w, st_b.hist_w),
                 hist_lam=(st_a.hist_lam, st_b.hist_lam),
                 cursor=(st_a.cursor, st_b.cursor))
    return [k for k, (a, b) in pairs.items()
            if not np.array_equal(host(a), host(b), equal_nan=True)]


def smoke_slots_pool(starts, fcts, max_tf, peak_concurrency,
                     dt=PAPER_DT) -> int:
    """The slot pool of ``benchmarks/run.py::smoke_slots``: the largest
    realized concurrency over the scenarios, each flow live from its start
    to its padded-engine FCT plus the drain hold (``max_tf`` ticks),
    rounded up to 64 and clamped to the total flow count. ``starts`` and
    ``fcts`` are per scenario as ``smoke_slots`` reads them: the
    schedule's starts and the padded run's FCT row in its own flow order
    (``peak_concurrency`` from either package)."""
    hold = max_tf * dt
    peak = 0
    for start, fct in zip(starts, fcts):
        start = np.asarray(start, np.float64)
        fct = np.asarray(fct, np.float64)[:start.shape[0]]
        ends = start + np.where(np.isfinite(fct), fct, np.inf) + hold
        peak = max(peak, peak_concurrency(start, ends))
    n_total = sum(int(np.asarray(x).shape[0]) for x in starts)
    return min(-(-max(peak, 1) // 64) * 64, n_total)


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


# K3's split reduction (csrc/queue_arrivals.cu): rows of the [H*F, Q]
# incidence in chunks of 64, each chunk 4 groups of 16 rows
K3_GROUPS, K3_GROUP_ROWS = 4, 16

# H, F, Q+1 beyond the main path's: H*F not a multiple of the 64-row
# chunk, Q+1 not a multiple of the 64-column tile, a single chunk (R < 64
# and R = 64), and many chunks
QUEUE_EDGE_SHAPES = [(3, 257, 289), (1, 20, 70), (4, 16, 64), (5, 1000, 300)]


def queue_arrivals_in_k3_order(lam_del, onehot, q, out_rate, caps, dt):
    """K3's arithmetic in torch, in its order: the products lam * onehot
    (each rounded), summed within each group of 16 rows from 0 in row
    order, the 4 groups of a 64-row chunk added in order, the chunks'
    partials summed in 4 contiguous runs of ceil(chunks / 4) in chunk
    order, the runs added in order; then the integration. Elementwise
    float32 ops, so on the card too it rounds as the kernel does.

    The rows are r = h * F + f, so a chunk may span two hops: this is not
    the plain version's order (``kernels/ref.py::queue_arrivals_ref``,
    hop-major, each hop's flows added one after another, as ``repro``'s
    Pallas kernel adds them), which would make each queue's sum a chain
    of H * F dependent adds on the card; K3 is held to the plain version
    at rtol 1e-5."""
    H, F, Q = onehot.shape
    R = H * F
    rows = K3_GROUPS * K3_GROUP_ROWS
    chunks = max(1, -(-R // rows))
    prod = lam_del.reshape(R, 1) * onehot.reshape(R, Q)
    prod = torch.cat([prod, prod.new_zeros(chunks * rows - R, Q)])
    prod = prod.reshape(chunks, K3_GROUPS, K3_GROUP_ROWS, Q)
    grp = torch.zeros_like(prod[:, :, 0])
    for i in range(K3_GROUP_ROWS):
        grp = grp + prod[:, :, i]
    part = grp[:, 0]
    for j in range(1, K3_GROUPS):
        part = part + grp[:, j]
    per = -(-chunks // K3_GROUPS)
    arr = None
    for j in range(K3_GROUPS):
        run = torch.zeros_like(part[0])
        for k in range(min(chunks, j * per), min(chunks, (j + 1) * per)):
            run = run + part[k]
        arr = run if arr is None else arr + run
    q_new = torch.minimum(torch.clamp_min(q + (arr - out_rate) * dt, 0.0),
                          caps)
    return arr, q_new


# K1/K2's observe form: one tick's rings, rows and law config

OBSERVE_DT = 1e-6


def observe_inputs(engine, B, F, H=3, Q=288, D=512, N=None,
                   update_period=2e-6, seed=0):
    """One tick's inputs to K1/K2's observe form (``LawTick``) at the
    simulator's magnitudes, numpy, rows [B, F]: rings [B, D, Q+1] and
    [B, D, F] with zeros among the queues and a sentinel column that stays
    0, paths with a sentinel last hop on ~30% of the rows, about half the
    active rows due to update, some windows above the clamp. ``engine``
    "padded": the law config per flow and ~15% of the flows not started;
    "slot": the config per schedule entry (N of them) read at
    ``slot_flow`` (N on an empty slot, which is never active; the first
    and ~10% of the others), and ``admit_t`` within 80 ticks,
    so that some slots were admitted after their ``w_old`` row."""
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32
    Q1 = Q + 1
    t = int(rng.integers(1000, 5000))
    bw = np.concatenate([rng.choice([3.125e9, 12.5e9], Q),
                         [1e15]]).astype(f32)
    hist_q = (np.abs(rng.standard_normal((B, D, Q1))) * 5e4).astype(f32)
    hist_q[rng.random((B, D, Q1)) < 0.3] = 0.0
    hist_q[..., Q] = 0.0
    path = rng.integers(0, Q, (B, F, H)).astype(i32)
    path[..., -1][rng.random((B, F)) < 0.3] = Q
    tau = rng.uniform(12e-6, 24e-6, (B, F)).astype(f32)
    w = (np.abs(rng.standard_normal((B, F))) * 1e5 + 1e4).astype(f32)
    w[rng.random((B, F)) < 0.05] = 5e7
    t_sec = float(f32(t) * f32(OBSERVE_DT))
    n = F if engine == "padded" else N
    out = dict(
        engine=engine, Q=Q, D=D, N=N, t=t, t_sec=t_sec, dt=OBSERVE_DT,
        update_period=update_period, bw=bw, hist_q=hist_q,
        hist_out=(rng.random((B, D, Q1)) * bw).astype(f32),
        hist_w=(np.abs(rng.standard_normal((B, D, F))) * 1e5 + 1e4
                ).astype(f32),
        path=path, tf_steps=rng.integers(1, 12, (B, F, H)).astype(i32),
        rtt_steps=rng.integers(12, 26, (B, F)).astype(i32), tau=tau,
        nic=rng.choice([3.125e9, 12.5e9], (B, F)).astype(f32),
        theta_now=(tau + rng.uniform(0.0, 20e-6, (B, F))).astype(f32), w=w,
        gs_prev=rng.uniform(0.5, 2.0, (B, F)).astype(f32),
        prev_theta=(tau * (1 + np.abs(rng.standard_normal((B, F))) * 0.5)
                    ).astype(f32),
        next_update=(t_sec + rng.uniform(-4e-6, 4e-6, (B, F))).astype(f32),
        last_update=(t_sec - rng.uniform(0.0, 40e-6, (B, F))).astype(f32),
        active=rng.random((B, F)) > 0.2,
        cfg_tau=rng.uniform(12e-6, 24e-6, (B, n)).astype(f32),
        cfg_beta=rng.uniform(1e3, 5e4, (B, n)).astype(f32))
    if engine == "padded":
        out["started"] = rng.random((B, F)) > 0.15
    else:
        sf = rng.integers(0, N, (B, F)).astype(i32)
        sf[:, 0] = N
        sf[rng.random((B, F)) < 0.1] = N
        out["slot_flow"] = sf
        out["active"] &= sf < N
        out["admit_t"] = (t - rng.integers(0, 80, (B, F))).astype(i32)
    return out


def observe_tick(tc, inp, law, device="cpu"):
    """(the law bound to the fused backend, the tick's ``_Static``, its
    ``SimConfig``, the ``LawTick``) of ``observe_inputs``' dict on
    ``device``."""
    from repro_torch.core import fluid
    from repro_torch.core.laws import PowerTCPState, ThetaPowerTCPState
    dev = torch.device(device)

    def on(k):
        return None if k not in inp else torch.as_tensor(inp[k], device=dev)
    B, F = inp["w"].shape
    bw, path = on("bw"), on("path")
    static = fluid._Static(bw=bw, buf=torch.full_like(bw, 1e30),
                           sw_table=None, dt=torch.tensor(
                               inp["dt"], dtype=torch.float32, device=dev))
    cfg = tc.SimConfig(dt=inp["dt"], hist=inp["D"],
                       update_period=inp["update_period"])
    state = (PowerTCPState(on("gs_prev")) if law == "powertcp" else
             ThetaPowerTCPState(on("gs_prev"), on("prev_theta")))
    tick = fluid.LawTick(
        t=inp["t"], t_sec=inp["t_sec"], ptr=inp["t"] % inp["D"],
        hist_q=on("hist_q"), hist_out=on("hist_out"), hist_w=on("hist_w"),
        rows=torch.arange(F, device=dev), path=path,
        valid=path < inp["Q"], bw=bw, b_hop=bw[path],
        tf_steps=on("tf_steps"),
        rtt_steps=on("rtt_steps"), tau=on("tau"), nic=on("nic"),
        theta_now=on("theta_now"), active=on("active"), w=on("w"),
        rate_cap=torch.full((B, F), float("inf"), device=dev),
        law_state=state, next_update=on("next_update"),
        last_update=on("last_update"),
        law_cfg=tc.LawConfig(gamma=0.9, beta=on("cfg_beta"),
                             tau=on("cfg_tau")),
        started=on("started"), admit_t=on("admit_t"),
        slot_flow=on("slot_flow"), n_flows=inp["N"] or 0)
    return tc.get_law(law, "fused"), static, cfg, tick


# the megakernel's anchors (tests/test_megakernel.py)

def staggered(core, n=12, steps=4000, seed=0, **dev):
    """``tests/test_megakernel.py::_staggered`` in either package: n flows
    of 80-400 kB on one 100 Gbps bottleneck, starting in the first 1.5 ms
    (numpy draws from ``seed``)."""
    B, tau = 100 * core.GBPS, 20 * core.US
    topo = core.single_bottleneck(bandwidth=B, buffer=16e6, **dev)
    rng = np.random.default_rng(seed)
    flows = core.make_flows_single(n, tau=tau, nic=B,
                                   sizes=rng.uniform(8e4, 4e5, n),
                                   starts=rng.uniform(0.0, 1.5e-3, n),
                                   sim_dt=1e-6, **dev)
    return topo, core.make_schedule(flows), core.SimConfig(dt=1e-6,
                                                           steps=steps,
                                                           hist=256)


def single_slot(core, **dev):
    """``tests/test_megakernel.py::test_single_slot_pool``'s scenario:
    three 100 kB flows, 4 000 ticks (run with one slot)."""
    B, tau = 100 * core.GBPS, 20 * core.US
    topo = core.single_bottleneck(bandwidth=B, buffer=16e6, **dev)
    flows = core.make_flows_single(3, tau=tau, nic=B, sizes=[1e5] * 3,
                                   starts=[0.0, 1e-5, 2e-5], sim_dt=1e-6,
                                   **dev)
    return topo, core.make_schedule(flows), core.SimConfig(dt=1e-6,
                                                           steps=4000,
                                                           hist=256)


def tree_leaves(x, name="carry"):
    """(name, tensor) of every tensor in nested NamedTuples."""
    if isinstance(x, torch.Tensor):
        return [(name, x)]
    if isinstance(x, tuple):
        fields = getattr(x, "_fields", [str(i) for i in range(len(x))])
        return [p for f, v in zip(fields, x)
                for p in tree_leaves(v, f"{name}.{f}")]
    return []


def tree_clone(x):
    """A copy of nested NamedTuples of tensors (other leaves shared)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        vals = [tree_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def plain_ticks(tick, carry, due):
    """The plain megakernel tick looped over the due counts ``due`` ([B,
    T]). Returns (carry', records [B, T, ...], the number of ticks that
    ended with a gather table overflowed, so that a queue's arrivals came
    from the in-order walk of the hop list)."""
    recs, n_ovf = [], 0
    for k in range(int(due.shape[-1])):
        carry, rec = tick(carry, due[:, k])
        recs.append(rec)
        n_ovf += bool(torch.any(carry.ovf))
    return (carry, type(recs[0])(*[torch.stack(list(x), dim=1)
                                   for x in zip(*recs)]), n_ovf)


def k4_against_plain(tc, topo, sched, cfg, law, slots, blocks,
                     expected_flows=8.0, maxdeg=None, overflows=None,
                     law_cfg=None, bw_fn=None):
    """K4 against the plain megakernel tick on the card, from the same
    initial carry, for each K in ``blocks``: every carry leaf bit for bit
    (the gather table ``inv`` and its flag ``ovf`` included), and every
    record field (K4 adds the sums ``w_sum`` and ``lam`` in XLA:CPU's
    order, ``fluid._xla_sum``, as the plain tick does). ``maxdeg``
    narrows the gather table (default ``suggest_maxdeg``); ``overflows`` (by default True where ``maxdeg``
    is given) says whether the table must overflow on some tick, so that
    the plain tick's walk of the hop list is held too, or must never.
    Returns (the largest absolute difference in the two sums — every other
    value is equal —, the number of ticks with the table overflowed, the
    largest number of contributors of a queue at the end). ``law_cfg``
    (one scenario's) replaces the default config; ``bw_fn`` (one
    scenario's) is the run's time-varying bandwidth."""
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels.queue_arrivals import max_degree
    dev = sched.start.device
    sim = fluid.make_slot_sim(
        topo, tc.batch_of_one(sched), law, slots,
        None if law_cfg is None else tc.batch_of_one(law_cfg), cfg=cfg,
        backend="megakernel", device=dev, expected_flows=expected_flows)
    tick = mk.make_tick(sim, maxdeg=maxdeg, bw_fn=bw_fn)
    carry0 = tick.init_carry(fluid.init_slot_state(sim))
    due = torch.as_tensor(mk._due_table(sim.sched, int(cfg.steps), cfg.dt),
                          device=dev)
    want, wrec, n_ovf = plain_ticks(tick, tree_clone(carry0), due)
    if overflows is None and maxdeg is not None:
        overflows = True
    if overflows is not None:
        assert (n_ovf > 0) == overflows, \
            f"a gather table of width {tick.maxdeg} overflowed on {n_ovf} " \
            f"ticks"
    err = 0.0
    for K in blocks:
        got, grec = mk.run_blocks(tick, tree_clone(carry0), due, K, "cuda")
        torch.cuda.synchronize()
        assert got.state.t == want.state.t, (K, got.state.t, want.state.t)
        for (name, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(
                g, w, rtol=0, atol=0, equal_nan=True,
                msg=lambda m, n=name: f"K4 K={K} {n}: {m}")
        err = max(err, _records_equal(grec, wrec, f"K4 K={K}"))
    return err, n_ovf, max_degree(want.state.path, int(topo.num_queues))


def _records_equal(grec, wrec, what) -> float:
    """Every record field of K4's run ``grec`` bit for bit the plain
    run's ``wrec``. Returns the largest absolute difference of the sums
    ``w_sum`` and ``lam`` (0.0 where they are equal)."""
    err = 0.0
    for f in grec._fields:
        g = getattr(grec, f)
        w = getattr(wrec, f).to(device=g.device, dtype=g.dtype)
        if f in ("w_sum", "lam") and g.numel():
            err = max(err, float(torch.nan_to_num(torch.max(torch.abs(
                g.double() - w.double())))))
        torch.testing.assert_close(
            g, w, rtol=0, atol=0, equal_nan=True,
            msg=lambda m, n=f: f"{what} rec.{n}: {m}")
    return err


def k4_grid_against_plain(tc, topo, sched, cfg, law, slots, blocks,
                          gate=True, expected_flows=8.0, law_cfg=None,
                          bw_fn=None, bw_params=None, k4_gates=None,
                          impair=None):
    """K4's grid form against the plain block on the card: a batch of
    schedules ``sched`` ([B, N, ...], ``fluid.stack_flow_schedules``), one
    K4 block per scenario, against the plain tick of the batch, both with
    ``gate``, from the same initial carry, for each K in ``blocks``: every
    carry leaf and every record field bit for bit. ``k4_gates``
    runs K4 with each of those gates against the one plain run (the plain
    tick's ``gate`` changes none of its bits). ``law_cfg`` (stacked, as
    ``stack_law_configs`` builds it) replaces the default config;
    ``bw_fn``/``bw_params`` are the batch's time-varying bandwidth
    (``simulate_slots_batch``'s), ``impair`` its impairment regime (one
    per scenario or shared). Returns the largest absolute difference in
    the record sums (0.0)."""
    from repro_torch.core import fluid, megakernel as mk
    dev = sched.start.device
    sim = fluid.make_slot_sim(topo, sched, law, slots, law_cfg, cfg=cfg,
                              backend="megakernel", device=dev,
                              expected_flows=expected_flows, impair=impair)
    T = int(cfg.steps)
    grid = mk.make_tick(sim, gate=gate, bw_fn=bw_fn, bw_params=bw_params)
    carry0 = grid.init_carry(fluid.init_slot_state(sim))
    due = torch.as_tensor(mk._due_table(sim.sched, T, cfg.dt), device=dev)
    want, wrec = mk.run_blocks(grid, tree_clone(carry0), due, T, "torch")
    err = 0.0
    runs = [(K, g) for g in (k4_gates or (gate,)) for K in blocks]
    for K, g in runs:
        grid.gate = bool(g)
        got, grec = mk.run_blocks(grid, tree_clone(carry0), due, K, "cuda")
        torch.cuda.synchronize()
        assert got.state.t == want.state.t, (K, got.state.t, want.state.t)
        for (name, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(
                g, w, rtol=0, atol=0, equal_nan=True,
                msg=lambda m, n=name: f"K4 grid K={K} gate={g} {n}: {m}")
        err = max(err, _records_equal(grec, wrec, f"K4 grid K={K} gate={g}"))
    return err


def k4_window_against_plain(tc, topo, sched, cfg, law, slots, chunk,
                            t_from, ticks, gates=(True, False),
                            expected_flows=8.0):
    """K4 on a chunk window against the plain block on the card: the run
    of one schedule is brought to tick ``t_from`` by K4 on the whole
    schedule, then from that carry the window of ``chunk`` rows at the
    admission cursor (``win_off > 0`` and C < N, both asserted, with no
    flow beyond the window due over the ``ticks`` ticks that follow) runs
    those ticks through K4 with each of ``gates`` and through the plain
    block: every carry leaf and record field bit for bit. Returns
    (win_off, C, N, the largest absolute difference of the record sums
    (0.0))."""
    from repro_torch.core import fluid, megakernel as mk
    dev = sched.start.device
    cfg = cfg._replace(steps=t_from + ticks)
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), law, slots,
                              cfg=cfg, backend="megakernel", device=dev,
                              expected_flows=expected_flows)
    whole = mk.make_tick(sim)
    due = torch.as_tensor(mk._due_table(sim.sched, t_from + ticks, cfg.dt),
                          device=dev)
    carry, _ = mk.run_blocks(whole, whole.init_carry(
        fluid.init_slot_state(sim)), due[:, :t_from], 64, "cuda",
        record=False)
    N, Q = fluid._slot_n(sim), int(topo.num_queues)
    w0 = int(carry.state.cursor[0])
    C = min(max(int(chunk), int(slots)), N)
    host = tc.FlowSchedule(*[x[0].cpu().numpy() for x in sim.sched])
    assert 0 < w0 and C < N, (w0, C, N)
    assert fluid._safe_ticks(host.start, w0, C, t_from, t_from + ticks,
                             cfg.dt) >= ticks
    win = fluid._host_window(host, w0, C, Q)
    simw = sim._replace(sched=fluid._window_tensors(win, dev), n_flows=N,
                        win_off=w0, start_host=win.start[None])
    tick = mk.make_tick(simw, maxdeg=whole.maxdeg)
    t_grid = np.arange(t_from, t_from + ticks, dtype=np.int32).astype(
        np.float32) * np.float32(cfg.dt)
    due_w = w0 + np.searchsorted(win.start, t_grid, side="right")
    assert np.array_equal(due_w, due[0, t_from:].cpu().numpy())
    due_w = torch.as_tensor(due_w.astype(np.int32)[None], device=dev)
    want, wrec = mk.run_blocks(tick, tree_clone(carry), due_w, ticks,
                               "torch")
    err = 0.0
    for g in gates:
        tick.gate = bool(g)
        got, grec = mk.run_blocks(tick, tree_clone(carry), due_w, 64, "cuda")
        torch.cuda.synchronize()
        for (name, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(
                a, b, rtol=0, atol=0, equal_nan=True,
                msg=lambda m, n=name: f"K4 window gate={g} {n}: {m}")
        err = max(err, _records_equal(grec, wrec, f"K4 window gate={g}"))
    return w0, C, N, err


def k4_against_reference(tc, topo, sched, cfg, law, slots,
                         expected_flows=8.0, law_cfg=None):
    """``k4_batch_against_reference`` for one schedule (``law_cfg``, one
    scenario's, replaces the default config)."""
    return k4_batch_against_reference(
        tc, topo, tc.batch_of_one(sched), cfg, law, slots, expected_flows,
        None if law_cfg is None else tc.batch_of_one(law_cfg))


def k4_batch_against_reference(tc, topo, sched, cfg, law, slots,
                               expected_flows=8.0, law_cfg=None,
                               gates=(True,)):
    """``simulate_slots_batch`` with ``backend="megakernel"`` (K4 on the
    card, with each of ``gates``) against the eager
    ``backend="reference"`` slot engine over ``cfg.steps`` ticks of a
    batch of schedules ``sched`` ([B, N, ...]): the final carry's windows,
    rate caps, queues, progress, update times, rings (the feedback
    channels' included), law state, admission cursor and FCTs bit for bit
    (not the slots' retire bookkeeping: the megakernel retires a drained
    slot on the tick it drains, the reference on the next admission,
    which changes no trajectory), and every record field. ``law_cfg``
    (stacked) replaces the default config. Returns the number of flows
    completed."""
    from repro_torch.core import fluid, megakernel as mk
    dev = sched.start.device
    want, wrec = tc.simulate_slots_batch(
        topo, sched, law, slots, law_cfg, cfg=cfg, backend="reference",
        expected_flows=expected_flows, device=dev)
    for gate in gates:
        sim = fluid.make_slot_sim(topo, sched, law, slots, law_cfg, cfg,
                                  "megakernel", dev, expected_flows)
        got, grec = mk.simulate_slots_mega(sim, gate=gate)
        got = got._replace(fct=got.fct[..., :int(sched.start.shape[-1])])
        _same_state(got, grec, want, wrec, f"gate={gate}")
    return int(torch.isfinite(want.fct).sum())


def _same_state(got, grec, want, wrec, what):
    """``k4_batch_against_reference``'s comparison of two runs."""
    for f in ("w", "rate_cap", "q", "out_rate", "remaining", "next_update",
              "last_update", "hist_lam", "hist_q", "hist_out", "hist_w",
              "law", "cursor", "fct", "pause", "hist_pause", "hist_inc"):
        gl, wl = tree_leaves(getattr(got, f), f), tree_leaves(
            getattr(want, f), f)
        assert len(gl) == len(wl), (what, f, len(gl), len(wl))
        for (name, gv), (_, wv) in zip(gl, wl):
            torch.testing.assert_close(
                gv, wv, rtol=0, atol=0, equal_nan=True,
                msg=lambda m, n=name: f"K4 ({what}) against the reference "
                                      f"{n}: {m}")
    _records_equal(grec, wrec, f"K4 ({what}) against the reference")


# -------------------------------------------------------------------------
# the LM slice: K5/K6 inputs, the serve run's shape, the tight bar
# -------------------------------------------------------------------------

# chip_smoke.py's serve run: 4 requests of 512 tokens, 32 greedy tokens
# each (one prefill + 31 decode steps) into a cache of 544 positions
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_CACHE = 4, 512, 32, 544
# the tight bar of tests/test_torch_lm.py (bfloat16 compute): the largest
# and the mean absolute difference of logits and caches
LM_TIGHT_MAX, LM_TIGHT_MEAN = 0.0625, 0.01


def flash_inputs(B, H, KV, T, S, D, seed=0):
    """q [B,H,T,D], k/v [B,KV,S,D], float32 standard normal."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, T, D), (B, KV, S, D), (B, KV, S, D)))


# B, H, KV, T, S, D, causal, window, bf16: K5's tile and split edges.
# Prefill tiles hold 64 query rows and 64 keys (32 where D > 128), decode
# splits 64 keys; decode serves the G * T rows of a GQA group in 16-row
# mma tiles.
FLASH_EDGE_SHAPES = [
    (1, 4, 2, 63, 63, 64, True, 0, True),
    (1, 4, 2, 65, 65, 128, True, 0, True),
    (1, 2, 1, 127, 127, 64, True, 0, True),
    (1, 2, 1, 129, 129, 128, True, 0, True),
    (1, 4, 2, 65, 129, 64, True, 0, True),          # T < S
    (1, 2, 2, 127, 63, 128, False, 0, True),        # bidirectional
    (1, 4, 2, 200, 200, 128, True, 70, True),       # window over a tile
    (2, 10, 2, 1, 200, 128, True, 70, True),        # ... and in decode
    (2, 10, 2, 1, 1, 128, True, 0, True),           # decode S = 1
    (2, 10, 2, 1, 40, 128, True, 0, True),          # S below one split
    (2, 10, 2, 1, 130, 128, True, 0, True),         # a partial split
    (2, 10, 2, 2, 70, 128, True, 0, True),          # T = 2..4, G = 5
    (2, 10, 2, 3, 129, 64, True, 0, True),
    (1, 10, 2, 4, 65, 128, True, 0, True),          # 20 rows: 2 mma tiles
    (2, 4, 2, 70, 70, 16, True, 0, True),           # D = 16
    (2, 4, 2, 4, 100, 16, True, 0, True),
    (1, 2, 1, 100, 100, 256, True, 0, True),        # D = 256
    (1, 10, 2, 4, 100, 256, True, 0, True),
]

# B, H, KV, T, S, D, window, bf16: K5's backward with a sliding window
# (causal, T = S): lengths around its tiles' edges (64 query rows or keys
# a block, 32 a tile), windows of one key, of 17 and of T - 1, at head
# dims 16 (GQA, H = 4 over KV = 2) and 256 (recurrentgemma's MQA, 10 over
# 1, where dk and dv split their columns over two blocks); float32 twice
FLASH_BWD_WINDOW_SHAPES = [
    ((2, 4, 2) if D == 16 else (1, 10, 1)) + (T, T, D, w, True)
    for T in (63, 65, 96, 129) for D in (16, 256) for w in (1, 17, T - 1)
] + [(1, 4, 2, 129, 129, 16, 17, False), (1, 2, 1, 65, 65, 256, 64, False)]

# B, H, KV, T, S, D, causal, bf16: K5's backward at head dim 96
# (phi3-vision's) around its tiles' edges (64 query rows or keys a block,
# 32 a tile): T and S of 63, 65 and 129, causal and unmasked, T < S and
# T > S, GQA 4 over 2; float32 twice
FLASH_BWD_D96_SHAPES = [
    (1, 4, 2, 63, 63, 96, True, True),
    (1, 4, 2, 65, 65, 96, True, True),
    (1, 4, 2, 129, 129, 96, True, True),
    (1, 4, 2, 63, 129, 96, True, True),         # T < S
    (1, 4, 2, 65, 129, 96, False, True),        # unmasked, T < S
    (1, 4, 2, 129, 63, 96, False, True),        # unmasked, T > S
    (2, 4, 4, 65, 65, 96, False, True),
    (1, 4, 2, 65, 129, 96, True, False),
    (1, 4, 2, 129, 65, 96, False, False),
]

# keys per decode split of K5's split_mma (csrc/flash_attention.cu)
K5_SPLIT_KEYS = 64


def flash_in_k5_order(q, k, v, *, causal=True, window=0,
                      split=K5_SPLIT_KEYS):
    """K5's bf16 arithmetic spelled in float32 torch: the keys in splits
    of ``split``; per split and query row the max m of the visible scores,
    p = exp(s - m) (0 where masked), l = sum(p), and acc = p_hi V + p_lo V
    with p_hi = bf16(p) and p_lo = bf16(p - p_hi); then the splits merged
    in split order, out = sum(acc e^(m - M)) / max(sum(l e^(m - M)),
    1e-30). q [B,H,T,D], k/v [B,KV,S,D] (bf16 values); returns float32."""
    B, H, T, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    q, k, v = q.float(), k.float(), v.float()
    kk = k[:, :, None].expand(B, KV, G, S, D).reshape(B, H, S, D)
    vv = v[:, :, None].expand(B, KV, G, S, D).reshape(B, H, S, D)
    qi = torch.arange(T)[:, None] + (S - T)
    kj = torch.arange(S)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool)
    if causal:
        mask &= kj <= qi
        if window > 0:
            mask &= kj > qi - window
    parts = []
    for k0 in range(0, max(S, 1), split):
        sl = slice(k0, min(k0 + split, S))
        s = torch.einsum("bhtd,bhsd->bhts", q, kk[:, :, sl]) / math.sqrt(D)
        vis = mask[:, sl]
        s = torch.where(vis, s, -1e30)
        m = s.amax(-1, keepdim=True) if s.shape[-1] else torch.full(
            (B, H, T, 1), -1e30)
        p = torch.where(vis, torch.exp(s - m), 0.0)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = (torch.einsum("bhts,bhsd->bhtd", hi, vv[:, :, sl])
               + torch.einsum("bhts,bhsd->bhtd", lo, vv[:, :, sl]))
        parts.append((m, p.sum(-1, keepdim=True), acc))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - M)
        L = L + l * f
        A = A + acc * f
    return A / torch.clamp_min(L, 1e-30)


def rmsnorm_inputs(N, D, seed=0):
    """x [N,D] and scale [D] (around 1, as a trained norm's), float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32) * 3.0,
            (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32))


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in units of bfloat16's spacing at want."""
    w = want.float()
    spacing = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return float(torch.max(torch.abs(got.float() - w) / spacing))


def rmsnorm_in_k6_order(x, scale, eps=1e-6):
    """K6's arithmetic in torch, in its order (``csrc/rmsnorm.cu``): with
    the wrapper's ``plan`` (G lanes per row, vpt vectors of E elements a
    lane, vector v on lane v % G), each lane adds the squares of its
    slots' elements in order from +0.0 (elements past the row are +0.0);
    the lanes of each warp (or G-lane group) are added as the xor
    butterfly's tree, lane l with lane l + half; the warp sums in warp
    order; then ``1 / sqrt(sum / D + eps)`` and ``(x * inv) * scale``,
    rounded once to x's dtype. Elementwise float32 ops, so on the card too
    it rounds as the kernel does."""
    from repro_torch.kernels.rmsnorm import plan
    D = x.shape[-1]
    G, vpt, E = plan(D, x.element_size())
    xf = x.reshape(-1, D).float()
    N = xf.shape[0]
    xp = torch.cat([xf, xf.new_zeros(N, G * vpt * E - D)], 1)
    xp = xp.reshape(N, vpt, G, E)
    acc = xf.new_zeros(N, G)
    for k in range(vpt):
        for e in range(E):
            f = xp[:, k, :, e]
            acc = acc + f * f
    W = min(G, 32)
    part = acc.reshape(N, G // W, W)
    while part.shape[-1] > 1:
        h = part.shape[-1] // 2
        part = part[..., :h] + part[..., h:]
    tot = part[:, 0, 0]
    for w in range(1, G // W):
        tot = tot + part[:, w, 0]
    # a true division: on the card, torch divides by a Python scalar as a
    # product with its reciprocal
    root = torch.sqrt(tot / torch.full_like(tot, D) + eps)
    inv = torch.ones_like(root) / root
    y = (xf * inv[:, None]) * scale.float()
    return y.to(x.dtype).reshape(x.shape)


def flash_bwd_in_k5_order(q, k, v, o, lse, do, *, causal=True, window=0,
                          hpc=None):
    """K5's bf16 backward (``csrc/flash_attention.cu``, the wgmma kernels)
    spelled in float32 torch: delta = rowsum(do * o) as each lane of a
    quad adds the columns c = lane mod 4 in order, then (p0 + p1) + (p2 +
    p3); p = 2^(s (scale log2e) - lse log2e) (0 where masked), ds = p (dp
    - delta), each rounded once to bf16 for the gradient products; dq over
    tiles of BK keys (32 at D = 256, else 64) added in key order, times
    scale; dk and dv of each chunk of ``hpc`` query heads (the wrapper's
    ``bwd_heads_per_chunk``; all G by default) over its heads in ascending
    order and each head's 64-query tiles in order, the chunks added in
    ascending order, dk times scale. Every product within a tile is a
    float32 einsum (the tensor cores' own order inside). q, do [B,H,T,D],
    k, v [B,KV,S,D] (bf16 values), o [B,H,T,D], lse [B,H,T]; returns (dq,
    dk, dv) rounded to bf16."""
    B, H, T, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    hpc = G if hpc is None else hpc
    BK = 32 if D > 128 else 64
    dev = q.device
    f32 = torch.float32
    qf, kf, vf, dof = (x.to(f32) for x in (q, k, v, do))
    kk = kf[:, :, None].expand(B, KV, G, S, D).reshape(B, H, S, D)
    vv = vf[:, :, None].expand(B, KV, G, S, D).reshape(B, H, S, D)
    prod = dof * o.to(f32)
    parts = []
    for j in range(4):
        acc = torch.zeros((B, H, T), dtype=f32, device=dev)
        for c in range(j, D, 4):
            acc = acc + prod[..., c]
        parts.append(acc)
    delta = (parts[0] + parts[1]) + (parts[2] + parts[3])
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=f32)
    sc = scale * torch.tensor(1.4426950408889634, dtype=f32)
    ls2 = lse.to(f32) * torch.tensor(1.4426950408889634, dtype=f32)
    qi = torch.arange(T, device=dev)[:, None] + (S - T)
    kj = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= kj <= qi
        if window > 0:
            mask &= kj > qi - window
    s = torch.einsum("bhtd,bhsd->bhts", qf, kk)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vv)
    p = torch.where(mask, torch.exp2(s * sc - ls2[..., None]), 0.0)
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    pb, dsb = (x.to(torch.bfloat16).to(f32) for x in (p, ds))
    dq = torch.zeros((B, H, T, D), dtype=f32, device=dev)
    for k0 in range(0, S, BK):
        sl = slice(k0, k0 + BK)
        dq = dq + torch.einsum("bhts,bhsd->bhtd", dsb[..., sl], kk[:, :, sl])
    dk = dv = None
    for c0 in range(0, G, hpc):
        ck = torch.zeros((B, KV, S, D), dtype=f32, device=dev)
        cv = torch.zeros_like(ck)
        for g in range(c0, min(c0 + hpc, G)):
            heads = torch.arange(KV, device=dev) * G + g
            for t0 in range(0, T, 64):
                sl = slice(t0, t0 + 64)
                ck = ck + torch.einsum("bhts,bhtd->bhsd",
                                       dsb[:, heads, sl], qf[:, heads, sl])
                cv = cv + torch.einsum("bhts,bhtd->bhsd",
                                       pb[:, heads, sl], dof[:, heads, sl])
        dk = ck if dk is None else dk + ck
        dv = cv if dv is None else dv + cv
    bf = torch.bfloat16
    return (dq * scale).to(bf), (dk * scale).to(bf), dv.to(bf)


def rmsnorm_bwd_in_k6_order(x, scale, dy, eps=1e-6, sms=132):
    """K6's backward (``csrc/rmsnorm.cu``, ``rmsnorm_bwd_kernel``) in
    torch, in its order: each row's sums of x^2 and of (dy * scale) * x
    as ``rmsnorm_in_k6_order`` takes the square sum (lane slots in order,
    the xor butterfly, the warps in order), inv = 1 / sqrt(ss / D + eps),
    c = gx / D, dx = inv * g - (x * (inv * inv) * inv) * c; dscale's
    terms (dy * x) * inv added over each block's rows (``rmsnorm.
    bwd_rows_per_block`` for ``sms`` SMs): each group of a narrow block
    over its rows i, i + groups, ... in order from +0.0, the groups in
    group order; then each column's block partials cut into
    ``BWD_SEGMENTS`` runs, each added from +0.0 in block order, the runs
    in run order. Elementwise float32 ops, so on the card too it rounds
    as the kernel does. Returns (dx in x's dtype, dscale float32)."""
    from repro_torch.kernels.rmsnorm import (BWD_SEGMENTS, NARROW_THREADS,
                                             bwd_rows_per_block, plan)
    D = x.shape[-1]
    G, vpt, E = plan(D, x.element_size())
    xf = x.reshape(-1, D).float()
    gf = dy.reshape(-1, D).float()
    N = xf.shape[0]
    sf = scale.float()
    pad = G * vpt * E - D

    def lanes(v):
        return torch.cat([v, v.new_zeros(N, pad)], 1).reshape(N, vpt, G, E)

    def row_sum(terms):
        acc = terms.new_zeros(N, G)
        for k in range(vpt):
            for e in range(E):
                acc = acc + terms[:, k, :, e]
        W = min(G, 32)
        part = acc.reshape(N, G // W, W)
        while part.shape[-1] > 1:
            h = part.shape[-1] // 2
            part = part[..., :h] + part[..., h:]
        tot = part[:, 0, 0]
        for w in range(1, G // W):
            tot = tot + part[:, w, 0]
        return tot

    xl = lanes(xf)
    ss = row_sum(xl * xl)
    g = gf * sf
    gx = row_sum(lanes(g) * xl)
    Dt = torch.full_like(ss, D)
    root = torch.sqrt(ss / Dt + eps)
    inv = (torch.ones_like(root) / root)[:, None]
    c = (gx / Dt)[:, None]
    inv3 = (inv * inv) * inv
    dx = inv * g - (xf * inv3) * c
    terms = (gf * xf) * inv
    groups = 1 if G > 32 else NARROW_THREADS // G
    R = bwd_rows_per_block(N, G, sms)
    P = -(-N // R)
    rounds = -(-R // groups)
    t = torch.cat([terms, terms.new_zeros(P * R - N, D)])
    t = torch.cat([t.reshape(P, R, D),
                   t.new_zeros(P, rounds * groups - R, D)], 1)
    t = t.reshape(P, rounds, groups, D)
    acc = t.new_zeros(P, groups, D)
    for i in range(rounds):
        acc = acc + t[:, i]
    part = acc[:, 0]
    for q in range(1, groups):
        part = part + acc[:, q]
    runs = []
    for j in range(BWD_SEGMENTS):
        r = part.new_zeros(D)
        for b in range(P * j // BWD_SEGMENTS, P * (j + 1) // BWD_SEGMENTS):
            r = r + part[b]
        runs.append(r)
    ds = runs[0]
    for r in runs[1:]:
        ds = ds + r
    return dx.to(x.dtype).reshape(x.shape), ds


def lm_teacher_forced(params, cfg, prompt, tokens, cache_len, extras=None):
    """The port's prefill of ``prompt`` [B,P] (with the batch's other
    inputs ``extras``), then one decode step per column of ``tokens``
    [B,N] (teacher forced). Returns [(what, tensor on the CPU)]: the
    logits of each forward and every leaf of the cache."""
    from repro_torch.models.lm import lm_decode_step, lm_prefill
    P = prompt.shape[1]
    out = []
    logits, cache = lm_prefill(params, {"tokens": prompt, **(extras or {})},
                               cfg, cache_len)
    out.append(("prefill logits", logits.cpu()))
    for i in range(tokens.shape[1]):
        logits, cache = lm_decode_step(params, tokens[:, i:i + 1], cache,
                                       P + i, cfg)
        out.append((f"decode {i} logits", logits.cpu()))
    for key in sorted(cache):
        for n in sorted(cache[key]):
            out.append((f"cache {key} {n}", cache[key][n].cpu()))
    return out


@pytest.fixture
def cuda_device():
    """The CUDA device for card-only tests; skips here without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


# benchmarks/fig4_incast.py::run: a victim already receiving a long-lived
# flow is hit by 10 and 63 synchronized 500 kB responses on the 64-host
# leaf-spine, both fan-ins one batch, 8 000 ticks; ``FIG4_REF`` holds
# ``repro``'s padded runs of the five window laws and its HOMA runs
# (``HOMA_*``: Fig. 4's 10:1 and Fig. 6's web-search leg, cut to their
# first ticks)
FIG4_REF = os.path.join(HERE, "golden", "torch_port_fig4.json")
FIG4_LAWS = ("powertcp", "theta_powertcp", "hpcc", "timely", "dcqcn")
FIG4_FANS = (10, 63)
FIG4_REQ_BYTES = 500e3
FIG4_DT = 1e-6
FIG4_STEPS = 8000
FIG4_EXPECTED_FLOWS = 16.0
HOMA_FIG4_STEPS = 2000
HOMA_WS_STEPS = 1000
HOMA_WS_LOAD, HOMA_WS_DURATION, HOMA_WS_SEED = 0.6, 0.03, 1


def fig4_scenario(core, steps=FIG4_STEPS, **dev):
    """(fabric, topo, the two incasts' flows [10:1, 63:1], the victim's
    ingress queue, cfg) of ``fig4_incast.run`` in either package."""
    fab = core.LeafSpine()
    flows, bq = [], None
    for fan in FIG4_FANS:
        fl, bq = core.incast_flows(fab, fan, req_bytes=FIG4_REQ_BYTES,
                                   sim_dt=FIG4_DT, **dev)
        flows.append(fl)
    cfg = core.SimConfig(dt=FIG4_DT, steps=steps, hist=512,
                         update_period=2e-6)
    return fab, fab.topology(**dev), flows, bq, cfg


def fig4_bdp(fab) -> float:
    """``fig4_incast.run``'s bdp: the host rate times 4 one-way hops."""
    return fab.host_bw * 4 * (2 * fab.d_host + 2 * fab.d_fabric)


def fig4_metrics(size, fct, q, th, steps, dt, bdp) -> dict:
    """``fig4_incast._metrics``: the victim queue's peak (MB) and final
    (KB) depth, its drain time (us) from the peak to below 1.5 BDP, and
    the throughput dip over the 2 000 ticks after the last response
    completes. ``size`` is the scenario's (unpadded) sizes, ``fct`` its
    FCT row, ``q`` and ``th`` the victim queue's depth and normalized
    throughput traces (numpy)."""
    roll = np.convolve(th, np.ones(100) / 100, mode="valid")
    size = np.asarray(size)
    fct = np.asarray(fct)[:size.shape[0]]
    fin = np.isfinite(size) & np.isfinite(fct)
    done_t = fct[fin].max() if fin.any() else np.nan
    di = int(min(done_t / dt, steps - 400)) if np.isfinite(done_t) \
        else steps - 400
    dip = 1.0 - float(roll[di:di + 2000].min())
    pk = int(q.argmax())
    near0 = q < 1.5 * bdp
    drain = (np.argmax(near0[pk:]) + pk) if near0[pk:].any() else steps
    return {"peak_q_MB": float(q.max() / 1e6), "end_q_KB": float(q[-1] / 1e3),
            "drain_us": float(drain - pk) * dt * 1e6, "dip_after": dip}


def fig4_claims(small: dict, big: dict, fab) -> bool:
    """``fig4_incast.run``'s verdict over the 10:1 (``small``) and 63:1
    (``big``) metrics by law."""
    p, h, d = small["powertcp"], small["hpcc"], small["dcqcn"]
    rtt2 = 2 * (2 * fab.d_host + 2 * fab.d_fabric)
    beta_hat_63 = 64 * fab.host_bw * rtt2 / 16.0 / 1e3
    return bool(p["end_q_KB"] < 150.0
                and p["dip_after"] <= h["dip_after"] + 0.02
                and d["peak_q_MB"] > 4 * p["peak_q_MB"]
                and abs(big["powertcp"]["end_q_KB"] - beta_hat_63)
                <= 0.5 * beta_hat_63
                and big["powertcp"]["end_q_KB"]
                < 0.5 * big["timely"]["end_q_KB"])


def receiver_ids(flows, fabric) -> np.ndarray:
    """``benchmarks/common.py::_receiver_ids``: each flow's receiver host,
    read from the last host-downlink queue of its path (0 for a flow with
    none, as a padded flow)."""
    path = np.asarray(flows.path.cpu() if isinstance(flows.path, torch.Tensor)
                      else flows.path)
    R, S = fabric.racks, fabric.spines
    base = 2 * R * S
    recv = np.zeros(path.shape[0], np.int64)
    for i in range(path.shape[0]):
        hops = path[i][path[i] < fabric.num_queues]
        host_q = [q for q in hops if q >= base]
        recv[i] = (host_q[-1] - base) if host_q else 0
    return recv


def homa_run_args(core, fab, flows, pad_to=None, expected_flows=8.0):
    """``common.run_law(law="homa")``'s arguments for one scenario:
    (flows padded to ``pad_to``, the allocator with overcommit 1, the
    law config). The law is ``reno``, whose window never binds: the
    grants cap the rate."""
    if pad_to is not None:
        flows = core.pad_flows(flows, pad_to, fab.num_queues)
    alloc = core.homa_alloc_fn(receiver_ids(flows, fab), fab.host_bw, 1,
                               flows.tau, flows.start)
    return flows, alloc, core.default_law_config(
        flows, expected_flows=expected_flows)


def homa_ws_scenario(core, steps=HOMA_WS_STEPS, **dev):
    """(fabric, topo, flows, cfg) of ``fig6_fct.run_load(0.6)``'s HOMA leg
    for seed 1 (the 64-host leaf-spine, 30 ms of web-search arrivals),
    cut to its first ``steps`` ticks."""
    fab = core.LeafSpine()
    flows = core.poisson_websearch(fab, HOMA_WS_LOAD, HOMA_WS_DURATION,
                                   FIG4_DT, seed=HOMA_WS_SEED, **dev)
    cfg = core.SimConfig(dt=FIG4_DT, steps=steps, hist=512,
                         update_period=2e-6)
    return fab, fab.topology(**dev), flows, cfg


# the paper-scale generators on the 256-host fabric: permutation traffic
# at load 0.6 and the section 4.1 incast workload (20 000 requests/s of
# 1 MB, 16 responses each) over 12 ms, seed 1, 25 000 ticks, the pool
# from ``suggest_slots``; and the all-to-all matrix on the k = 4 fat tree
# (240 flows of 100 kB, starts jittered over 100 us), 4 000 ticks.
# ``GENERATORS_REF`` holds ``repro``'s slot-engine FCTs of the three
GENERATORS_REF = os.path.join(HERE, "golden", "torch_port_generators.json")
GEN_LEGS = ("permutation", "synthetic_incast", "all_to_all")
GEN_DURATION = 0.012
GEN_STEPS = 25_000
GEN_A2A_STEPS = 4000
GEN_A2A_BYTES = 1e5
GEN_A2A_STAGGER = 100e-6
GEN_LAW = "powertcp"
GEN_EXPECTED_FLOWS = 8.0


def generator_scenario(core, leg, steps=None, **dev):
    """(topo, schedule, cfg, slots) of one generator leg in either
    package; ``steps`` cuts the run."""
    dt = PAPER_DT
    if leg == "all_to_all":
        fab = core.fat_tree(4)
        flows = core.all_to_all_flows(fab, GEN_A2A_BYTES, dt,
                                      stagger=GEN_A2A_STAGGER, **dev)
        T = GEN_A2A_STEPS
    else:
        fab = core.LeafSpine(**PAPER)
        if leg == "permutation":
            flows = core.permutation_traffic(fab, PAPER_LOAD, GEN_DURATION,
                                             dt, seed=1, **dev)
        else:
            flows = core.synthetic_incast_workload(fab, 20_000.0, 1e6,
                                                   GEN_DURATION, dt, seed=1,
                                                   **dev)
        T = GEN_STEPS
    sched = core.make_schedule(flows)
    cfg = core.SimConfig(dt=dt, steps=T if steps is None else int(steps),
                         hist=512, update_period=2e-6)
    return (fab.topology(**dev), sched, cfg,
            int(core.suggest_slots(sched, dt)))


# the outer sync: a small tree for the CPU tests, whose dict keys are not
# in sorted order (the flatten order sorts them)
def outer_tree_shapes():
    return {"w_out": (33, 17), "emb": (257,),
            "blocks": [{"z": (64, 8), "a": (1000,)}, {"z": (5,), "a": (3, 7)}],
            "b": (1,)}


def outer_tree(shapes, seed, scale=1.0, device="cpu"):
    """A float32 tree shaped as ``shapes`` (nested dicts and lists of
    shapes) of normal draws times ``scale``, from a ``torch.Generator`` on
    ``device`` seeded with ``seed``, leaf after leaf in the flatten order
    (dict keys sorted); the dicts keep ``shapes``' key order."""
    g = torch.Generator(device=device).manual_seed(int(seed))

    def build(x):
        if isinstance(x, dict):
            vals = {k: build(x[k]) for k in sorted(x)}
            return {k: vals[k] for k in x}
        if isinstance(x, list):
            return [build(v) for v in x]
        t = torch.empty(tuple(x), dtype=torch.float32, device=device)
        return t.normal_(0.0, 1.0, generator=g).mul_(scale)

    return build(shapes)


def qwen3_layer_shapes():
    """The shapes of one qwen3-14b decoder layer at full width (the port's
    ``block_specs``: d_model 5120, 40 / 8 heads of 128, d_ff 17 408;
    330 311 936 parameters)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import block_specs
    from repro_torch.models.spec import is_spec

    def walk(t):
        return tuple(t.shape) if is_spec(t) else {k: walk(v)
                                                  for k, v in t.items()}
    return walk(block_specs(get_config("qwen3-14b"), "attn"))


def sorted_leaves(tree):
    """The tensors of nested dicts and lists, dict keys sorted (JAX's
    flatten order)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in sorted_leaves(x)]
    return [tree]


def fma_spelled(a, b, c):
    """float32 ``a * b + c`` with one rounding: the float64 product is
    exact, and the float64 sum ``head`` with its error ``tail`` (TwoSum)
    is the exact result; ``head`` rounded to nearest float32 is right
    except where ``head`` is a float32 midpoint and ``tail`` points past
    it, where the neighbour on ``tail``'s side is."""
    a, b, c = (torch.as_tensor(v).to(torch.float64) for v in (a, b, c))
    p = a * b
    head = p + c
    z = head - p
    tail = (p - (head - z)) + (c - z)
    r = head.to(torch.float32)
    r64 = r.to(torch.float64)
    other = torch.nextafter(r, torch.where(
        head > r64, float("inf"), float("-inf")).to(torch.float32))
    mid = (r64 + other.to(torch.float64)) * 0.5
    past = ((tail > 0) & (r64 < head)) | ((tail < 0) & (r64 > head))
    fix = torch.isfinite(head) & (head != r64) & (head == mid) & past
    return torch.where(fix, other, r)


def outer_sync_spelled(anchor, locals_, efs, mom, outer_lr=0.7,
                       momentum=0.9):
    """The outer sync over P pods spelled in one process, leaf by leaf in
    the flatten order: each pod's ``y = (anchor - local) + ef``, its scale
    ``max(|y|, 1e-12) * float32(1/127)``, ``q = clip(round(y / scale))``
    and error feedback ``y - q * scale`` (one rounding); the de-quantized
    blocks ``q * scale`` summed in pod order, times ``float32(1/P)``
    (P > 1); then ``mom' = momentum * mom + mean`` and ``anchor' = anchor
    - outer_lr * (momentum * mom' + mean)``, each with one rounding.
    Returns (the new anchor's leaves, [each pod's new error feedback
    leaves], the new momentum's leaves)."""
    P = len(locals_)
    recip = torch.tensor(np.float32(1.0) / np.float32(127.0))
    a_l, m_l = sorted_leaves(anchor), sorted_leaves(mom)
    l_l = [sorted_leaves(t) for t in locals_]
    e_l = [sorted_leaves(t) for t in efs]
    new_a, new_m, new_e = [], [], [[] for _ in range(P)]
    for i, a in enumerate(a_l):
        deq = []
        for p in range(P):
            y = (a.float() - l_l[p][i].float()) + e_l[p][i]
            mx = torch.clamp(torch.max(torch.abs(y)),
                             min=np.float32(1e-12))
            scale = mx * recip.to(y.device)
            q = torch.clamp(torch.round(y / scale), -127, 127)
            new_e[p].append(fma_spelled(-q, scale, y))
            deq.append(q * scale)
        total = deq[0]
        for p in range(1, P):
            total = total + deq[p]
        if P > 1:
            total = total * torch.tensor(np.float32(1.0) / np.float32(P),
                                         device=total.device)
        m = fma_spelled(np.float32(momentum), m_l[i].float(), total)
        inner = fma_spelled(np.float32(momentum), m, total)
        new_a.append(fma_spelled(-np.float32(outer_lr), inner,
                                 a.float()).to(a.dtype))
        new_m.append(m)
    return new_a, new_e, new_m


def outer_sync_rank(group, shapes, window, seeds):
    """One pod of a spawned outer sync (``shardcomm.spawn``): every rank
    builds on its device the replicated anchor and momentum and every
    pod's local parameters and error feedback from ``seeds`` (rank r is
    pod r), runs ``make_outer_sync(group, window=window)`` on its own
    (timed), and compares its result with ``outer_sync_spelled`` over all
    pods, bit for bit. Returns rank 0's view: each rank's number of
    mismatching leaves, gathers and most gathers in flight, the leaf
    count, the bytes gathered and rank 0's wall seconds."""
    import time as _time
    from repro_torch.commsched import make_outer_sync
    dev = group.device
    P = group.world
    anchor = outer_tree(shapes, seeds[0], device=dev)
    mom = outer_tree(shapes, seeds[1], scale=0.01, device=dev)
    locals_ = [outer_tree(shapes, seeds[2] + p, scale=0.1, device=dev)
               for p in range(P)]
    efs = [outer_tree(shapes, seeds[3] + p, scale=1e-3, device=dev)
           for p in range(P)]
    sync = make_outer_sync(group, window=window)
    r = group.rank
    group.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = _time.perf_counter()
    got_a, got_e, got_m = sync(anchor, locals_[r], efs[r], mom)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = _time.perf_counter() - t0
    got = sorted_leaves(got_a) + sorted_leaves(got_e) + sorted_leaves(got_m)
    del got_a, got_e, got_m
    want_a, want_e, want_m = outer_sync_spelled(anchor, locals_, efs, mom)
    bad = 0
    for g, w in zip(got, want_a + want_e[r] + want_m):
        bad += int(not torch.equal(g, w))
    counts = group.all_gather(torch.tensor([bad, sync.stats["gathers"],
                                            sync.stats["max_in_flight"]],
                                           device=dev))
    return dict(bad=counts[:, 0].tolist(), gathers=counts[:, 1].tolist(),
                max_in_flight=counts[:, 2].tolist(),
                leaves=len(want_a), bytes=sync.stats["bytes"], wall_s=wall)


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


# -------------------------------------------------------------------------
# the trainer slice: the backward kernels' inputs and bars, numpy params,
# the golden run's settings, the crash/restart mirror
# -------------------------------------------------------------------------

# the backward kernels against their plain versions: the largest absolute
# difference over the largest absolute gradient (the forward's bars)
BWD_BAR_BF16, BWD_BAR_F32 = 2e-2, 2e-5
# K5's bf16 backward against its order spelled in torch
# (``flash_bwd_in_k5_order``), on the card: not bit for bit, since the
# tensor cores add inside a product in their own order and exp2 is MUFU's
# approximation; the float32 sums then differ in their last bits, which
# can move a gradient to the neighbouring bfloat16 value (at most 2^-7 =
# 7.8e-3 of the largest gradient) or, rarely, move a p or ds to the next
# bf16 value
K5_ORDER_BAR = 1e-2


def flash_bwd_inputs(B, H, KV, T, S, D, seed=0):
    """q [B,H,T,D], k/v [B,KV,S,D] and the output's gradient do [B,H,T,D],
    float32 standard normal."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, T, D), (B, KV, S, D), (B, KV, S, D),
                               (B, H, T, D)))


def rmsnorm_bwd_inputs(N, D, seed=0):
    """x [N,D], scale [D] (``rmsnorm_inputs``) and dy [N,D], float32."""
    x, s = rmsnorm_inputs(N, D, seed)
    dy = np.random.default_rng(seed + 1).standard_normal((N, D))
    return x, s, dy.astype(np.float32)


def bwd_errs(got, want):
    """Each gradient's largest error over its largest plain value, the
    latter floored at 1e-3 of the largest plain value of all of them: a
    gradient that is zero in exact arithmetic (dq and dk under a window of
    one key, where each query sees only itself) is held to the scale of
    the others, not to its own rounding noise."""
    top = max(float(w.float().abs().max()) for w in want)
    return [float((g.float() - w.float()).abs().max()
                  / max(float(w.float().abs().max()), 1e-3 * top, 1e-30))
            for g, w in zip(got, want)]


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def numpy_params(specs, seed):
    """A parameter tree for ``specs`` (the port's ``lm_specs``: a tree of
    dicts of ``ParamSpec``s, the same keys as ``repro``'s) drawn with numpy
    from ``seed``, leaf by leaf in sorted-key order: standard normal times
    the spec's scale, float32; ones, zeros and constants as declared. Both
    packages start from it (``jax.tree.map(jnp.asarray, ...)``,
    ``params_from_numpy``)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if not isinstance(t, dict):
            if t.init == "zeros":
                return np.zeros(t.shape, np.float32)
            if t.init == "ones":
                return np.ones(t.shape, np.float32)
            if t.init == "constant":
                return np.full(t.shape, t.scale, np.float32)
            return (rng.standard_normal(t.shape) * t.scale).astype(
                np.float32)
        return {k: walk(t[k]) for k in sorted(t)}
    return walk(specs)


# the golden run (``tests/golden/torch_port_train.json``, ``repro`` on the
# CPU with float32 compute and its attention computed the K5 way): the
# REDUCED qwen3-14b from ``numpy_params(..., TRAIN_PARAM_SEED)``, these
# train and data settings, ``TRAIN_STEPS`` losses
TRAIN_REF = os.path.join(HERE, "golden", "torch_port_train.json")
TRAIN_TCFG = dict(microbatch=2, remat="full", lr=1e-2, warmup_steps=2,
                  total_steps=20)
TRAIN_DCFG = dict(batch=8, seq=32)
TRAIN_STEPS = 10
TRAIN_PARAM_SEED = 0
# the port's losses against the golden's, absolute, on the CPU
# (tests/test_torch_train.py) and on the card (chip_smoke.py phase 9c)
TRAIN_LOSS_BAR = 1e-3


def train_golden() -> dict:
    with open(TRAIN_REF) as f:
        return json.load(f)


def crash_restart(train_driver, CrashInjected, cfg, tcfg, dcfg, ckpt_dir,
                  device, steps=10, every=3, crash_at=5):
    """``tests/test_fault_tolerance.py::test_crash_restart_bitwise`` for
    the port on ``device``: an uninterrupted run, a run that crashes after
    step ``crash_at`` with checkpoints every ``every`` steps, and the run
    that resumes from them (each drawing its parameters from
    ``tcfg.seed``). Returns (reference, resumed); raises if the crash did
    not happen or the resumed run did not start from a checkpoint."""
    ref = train_driver(cfg, tcfg, dcfg, steps=steps, device=device)
    try:
        train_driver(cfg, tcfg, dcfg, steps=steps, ckpt_dir=ckpt_dir,
                     ckpt_every=every, crash_at=crash_at, device=device)
    except CrashInjected:
        pass
    else:
        raise AssertionError("crash_at did not crash the run")
    resumed = train_driver(cfg, tcfg, dcfg, steps=steps, ckpt_dir=ckpt_dir,
                           ckpt_every=every, device=device)
    if resumed["start_step"] == 0:
        raise AssertionError("the resumed run restored no checkpoint")
    return ref, resumed
