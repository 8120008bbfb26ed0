#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and the
CUDA toolkit (``nvcc``). Phases, each of which fails the script (non-zero
exit, traceback) if anything in it is wrong:

1. probe: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from ``src/repro_torch/csrc``, one nvcc per
   source, all at once;
3. kernels: K1 ``powertcp_step`` and K2 ``theta_powertcp_step`` against
   their plain PyTorch versions bit for bit, K3 ``queue_arrivals`` at
   rtol 1e-5 / atol 1e-3 bytes, at the main path's shapes and ragged
   ones; then each timed (CUDA graph replays of many launches, median of
   rounds) beside its plain version and, for K3, ``torch.einsum`` (the
   library yardstick, used nowhere in the port);
4. goldens: the ``powertcp`` and ``theta_powertcp`` legs of
   ``tests/golden/golden_laws.json`` through the port's ``simulate`` on
   the card, both backends, at ``tests/test_golden_traces.py``'s
   tolerances;
5. main path: PowerTCP on the 256-host paper fabric (seed 1, 60% load,
   30 ms of web-search arrivals + 10 ms drain, 40 000 ticks of 1 us):
   (a) ``simulate_slots`` fused, 384 slots; (b) ``simulate_slots``
   reference; (c) ``simulate`` (padded) fused; (d) theta-PowerTCP,
   ``simulate_slots`` fused. Each run starts with the kernel launch
   counts at zero; the fused runs must launch the law kernel and K3 once
   per tick, the reference run none. Each is held to the JAX reference's
   per-flow FCTs (``tests/golden/torch_port_paper_seed1.json``): the same
   completion set, and a short-flow (< 10 kB) p99.9 FCT within 1e-3.

``--profile`` adds a last phase: the first 200 ticks of each main-path
run under ``torch.profiler``, with the device time and device launches
per tick, the device-busy share and the kernels that take the most
device time.

It prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when CUDA is not available or the checkout's sources are missing.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

REPLACES = {
    "powertcp_step": "src/repro/kernels/powertcp_step.py:51",
    "theta_powertcp_step": "src/repro/kernels/powertcp_step.py:101",
    "queue_arrivals": "src/repro/kernels/queue_arrivals.py:312",
}
SOURCES = {
    "powertcp_step": "src/repro_torch/csrc/powertcp_step.cu",
    "theta_powertcp_step": "src/repro_torch/csrc/powertcp_step.cu",
    "queue_arrivals": "src/repro_torch/csrc/queue_arrivals.cu",
}


def log(*args):
    print(*args, flush=True)


# -------------------------------------------------------------------------
# timing and bounds
# -------------------------------------------------------------------------

def graph_ms(torch, fn, reps=100, rounds=7):
    """Device time of one ``fn()`` call: ``reps`` calls captured in one
    CUDA graph, replayed ``rounds`` times between CUDA events; the median
    round over ``reps``. The graph takes the host's launch cost out."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def law_cost(F, H):
    """Bytes each input read once + each output written once, and flops,
    of one K1 call: per hop 4 float inputs + 1 mask byte and ~9 flops;
    per flow 6 float inputs + 1 mask byte, 2 float outputs, ~15 flops."""
    return F * H * (4 * 4 + 1) + F * (6 * 4 + 1 + 2 * 4), F * (9 * H + 15)


def theta_cost(F):
    """K2: 8 float inputs + 1 mask byte, 3 float outputs, ~18 flops."""
    return F * (8 * 4 + 1 + 3 * 4), F * 18


def queue_cost(H, F, Q):
    """K3: lam [H,F] + incidence [H,F,Q] + q/out/caps [Q] read, arr and
    q_new [Q] written; 2 flops per incidence entry + 5 per queue."""
    return 4 * (H * F + H * F * Q + 3 * Q + 2 * Q), 2 * H * F * Q + 5 * Q


# -------------------------------------------------------------------------
# phases
# -------------------------------------------------------------------------

def phase_probe(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {ROOT}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(f"[probe] nvidia-smi: {smi}")
    return name, smi


def phase_build(kernels):
    t0 = time.time()
    logs = kernels.build()
    secs = time.time() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] built {sorted(logs) or 'nothing (cached)'} in "
        f"{secs:.2f} s")
    return secs


def phase_kernels(torch, sup, dev):
    """Each kernel against its plain version, then timed. Returns
    {name: row} for the kernels line (at the slot engine's shapes, S=384)
    plus the padded engine's rows under ``name + '@padded'``."""
    from repro_torch.kernels import (powertcp_step, queue_arrivals, ref,
                                     theta_powertcp_step)

    def on(kw):
        return {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}

    def maxerr(got, want):
        return max(float(torch.max(torch.abs(g - w))) if g.numel() else 0.0
                   for g, w in zip(got, want))

    errs = {"powertcp_step": 0.0, "theta_powertcp_step": 0.0,
            "queue_arrivals": 0.0}
    for F, H in ((2406, 3), (384, 3), (1, 1), (257, 5), (1, 5), (257, 1)):
        kw = on(sup.law_inputs(F, H, seed=F + H))
        got = powertcp_step(**kw, gamma=0.9, w_min=1000.0)
        want = ref.powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        errs["powertcp_step"] = max(errs["powertcp_step"], maxerr(got, want))
        log(f"[kernels] powertcp_step F={F} H={H}: bitwise equal")
    for F in (2406, 384, 1, 257):
        kw = on(sup.theta_inputs(F, seed=F))
        got = theta_powertcp_step(**kw, gamma=0.9, w_min=1000.0)
        want = ref.theta_powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        errs["theta_powertcp_step"] = max(errs["theta_powertcp_step"],
                                          maxerr(got, want))
        log(f"[kernels] theta_powertcp_step F={F}: bitwise equal")
    for H, F, Q in ((3, 2406, 289), (3, 384, 289), (1, 1, 2), (5, 257, 129),
                    (1, 257, 2), (5, 1, 129)):
        kw = on(sup.queue_inputs(H, F, Q, seed=H + F + Q))
        got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
        e = maxerr(got, want)
        errs["queue_arrivals"] = max(errs["queue_arrivals"], e)
        log(f"[kernels] queue_arrivals H={H} F={F} Q={Q}: max abs err "
            f"{e!r} (rtol 1e-5, atol 1e-3)")

    rows = {}
    for tag, F in (("", 384), ("@padded", 2406)):
        H, Q = 3, 289
        kw = on(sup.law_inputs(F, H, seed=1))
        nbytes, flops = law_cost(F, H)
        b, by = bound_ms(nbytes, flops)
        rows["powertcp_step" + tag] = dict(
            shape=f"F={F} H={H}",
            ms=graph_ms(torch, lambda: powertcp_step(**kw)),
            plain_ms=graph_ms(torch, lambda: ref.powertcp_step_ref(**kw)),
            bound_ms=b, bound_by=by, library_ms=None)
        kw = on(sup.theta_inputs(F, seed=1))
        nbytes, flops = theta_cost(F)
        b, by = bound_ms(nbytes, flops)
        rows["theta_powertcp_step" + tag] = dict(
            shape=f"F={F}",
            ms=graph_ms(torch, lambda: theta_powertcp_step(**kw)),
            plain_ms=graph_ms(torch,
                              lambda: ref.theta_powertcp_step_ref(**kw)),
            bound_ms=b, bound_by=by, library_ms=None)
        kw = on(sup.queue_inputs(H, F, Q, seed=1))
        nbytes, flops = queue_cost(H, F, Q)
        b, by = bound_ms(nbytes, flops)
        lam, oh = kw["lam_del"], kw["onehot"]
        rows["queue_arrivals" + tag] = dict(
            shape=f"H={H} F={F} Q+1={Q}",
            ms=graph_ms(torch,
                        lambda: queue_arrivals(**kw, dt=sup.QUEUE_DT)),
            plain_ms=graph_ms(torch, lambda: ref.queue_arrivals_ref(
                **kw, dt=sup.QUEUE_DT)),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch,
                                lambda: torch.einsum("hf,hfq->q", lam, oh)))
    for name, row in rows.items():
        row["max_abs_err"] = errs[name.split("@")[0]]
        log(f"[kernels] time {name} ({row['shape']}): ms {row['ms']!r} "
            f"plain_ms {row['plain_ms']!r} bound_ms {row['bound_ms']!r} "
            f"({row['bound_by']}) library_ms {row['library_ms']!r}")
    return rows


def phase_goldens(tc, sup, dev):
    """The golden scenario (``tools/gen_golden.py``'s constants) through
    the port on the card, both backends, at the golden tolerances."""
    data = sup.golden()
    for law in ("powertcp", "theta_powertcp"):
        for backend in ("reference", "fused"):
            topo, flows, lcfg, cfg = sup.golden_scenario(tc, device=dev)
            got = sup.pack(*tc.simulate(topo, flows, law, lcfg, cfg,
                                        backend=backend, device=dev))
            sup.check_golden(law, got, data[law], leg=f"[{backend}]")
            log(f"[goldens] {law} {backend}: within the golden tolerances")


def paper_scenario(tc, sup, dev, ref):
    fab = tc.LeafSpine(**ref["fabric"])
    flows = tc.poisson_websearch(fab, ref["load"], ref["duration_s"],
                                 ref["dt_s"], seed=ref["seed"], device=dev)
    sched = tc.make_schedule(flows)
    n = int(sched.start.shape[0])
    if n != ref["n_flows"] or sup.schedule_checksum(
            sched.size.cpu().numpy(), sched.start.cpu().numpy()) \
            != ref["schedule_sha256"]:
        raise AssertionError("the port's paper schedule differs from the "
                             "reference's")
    return fab.topology(device=dev), sched


MAIN_RUNS = (("a", "slot", "powertcp", "fused"),
             ("b", "slot", "powertcp", "reference"),
             ("c", "padded", "powertcp", "fused"),
             ("d", "slot", "theta_powertcp", "fused"))


def run_main(torch, tc, kernels, dev, ref, topo, sched, key, engine, law,
             backend, steps):
    """One main-path run with the launch counts zeroed just before it and
    read just after. Returns (fct [N] in schedule order, summary)."""
    cfg = tc.SimConfig(dt=ref["dt_s"], steps=steps, hist=ref["hist"],
                       update_period=ref["update_period_s"])
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if engine == "slot":
        lcfg = tc.default_law_config(sched,
                                     expected_flows=ref["expected_flows"])
        st, _ = tc.simulate_slots(topo, sched, law, ref["slots"], lcfg, cfg,
                                  record=False, backend=backend, device=dev)
    else:
        flows = tc.schedule_as_flows(sched)
        lcfg = tc.default_law_config(flows,
                                     expected_flows=ref["expected_flows"])
        st, _ = tc.simulate(topo, flows, law, lcfg, cfg, record=False,
                            backend=backend, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    law_kernel = ("theta_powertcp_step" if law == "theta_powertcp"
                  else "powertcp_step")
    want = ({law_kernel: steps, "queue_arrivals": steps}
            if backend == "fused" else {})
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"run ({key}): {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    fct = st.fct.double().cpu().numpy()
    if not np.all(np.isfinite(fct) | np.isnan(fct)):
        raise AssertionError(f"run ({key}): non-finite FCTs")
    return fct, dict(run=key, engine=engine, law=law, backend=backend,
                     steps=steps, wall_s=wall, us_per_tick=wall / steps * 1e6,
                     launches=launches)


def compare_fct(key, fct, ref_fct, sizes):
    done = np.isfinite(fct)
    ref_done = np.isfinite(ref_fct)
    if not np.array_equal(done, ref_done):
        raise AssertionError(f"run ({key}): completion set differs from the "
                             f"reference ({done.sum()} vs {ref_done.sum()})")
    short = done & (sizes < 10e3)
    p = float(np.percentile(fct[short], 99.9))
    pr = float(np.percentile(ref_fct[short], 99.9))
    rel = abs(p - pr) / max(pr, 1e-12)
    if not rel < 1e-3:
        raise AssertionError(f"run ({key}): short-flow p99.9 {p} vs "
                             f"reference {pr} (rel err {rel})")
    return dict(completed=int(done.sum()), n_flows=int(fct.size),
                short_p999_us=p * 1e6, ref_short_p999_us=pr * 1e6,
                p999_rel_err=rel,
                fct_max_rel_err=float(np.max(np.abs(fct[done] - ref_fct[done])
                                             / ref_fct[done])))


def phase_main(torch, tc, kernels, sup, dev):
    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    topo, sched = paper_scenario(tc, sup, dev, ref)
    sizes = sched.size.double().cpu().numpy()
    launches = {k: 0 for k in kernels.LAUNCHES}
    summaries = []
    for key, engine, law, backend in MAIN_RUNS:
        fct, summ = run_main(torch, tc, kernels, dev, ref, topo, sched, key,
                             engine, law, backend, ref["steps"])
        ref_fct = np.array([np.nan if x is None else x
                            for x in ref["fct_s"][law]])
        summ.update(compare_fct(key, fct, ref_fct, sizes))
        for k, n in summ["launches"].items():
            launches[k] += n
        summaries.append(summ)
        log(f"[main] ({key}) {engine} {law} {backend}: wall "
            f"{summ['wall_s']:.3f} s, {summ['us_per_tick']:.2f} us/tick, "
            f"completed {summ['completed']}/{summ['n_flows']}, short p99.9 "
            f"{summ['short_p999_us']:.4f} us (reference "
            f"{summ['ref_short_p999_us']:.4f}, rel err "
            f"{summ['p999_rel_err']:.3g}), launches {summ['launches']}")
    log("[main] " + json.dumps({"main_path": summaries}))
    return launches, summaries


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def phase_profile(torch, tc, sup, dev, summaries, ticks=200):
    """``--profile``: the first ``ticks`` ticks of each main-path run under
    ``torch.profiler``. Prints the device time and device launches per
    tick, the device-busy share against that run's unprofiled wall time
    per tick, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    topo, sched = paper_scenario(tc, sup, dev, ref)
    cfg = tc.SimConfig(dt=ref["dt_s"], steps=ticks, hist=ref["hist"],
                       update_period=ref["update_period_s"])
    for summ in summaries:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if summ["engine"] == "slot":
                lcfg = tc.default_law_config(
                    sched, expected_flows=ref["expected_flows"])
                tc.simulate_slots(topo, sched, summ["law"], ref["slots"],
                                  lcfg, cfg, record=False,
                                  backend=summ["backend"], device=dev)
            else:
                flows = tc.schedule_as_flows(sched)
                lcfg = tc.default_law_config(
                    flows, expected_flows=ref["expected_flows"])
                tc.simulate(topo, flows, summ["law"], lcfg, cfg,
                            record=False, backend=summ["backend"],
                            device=dev)
            torch.cuda.synchronize()
        # device-side events only (kernels, copies, fills): a CPU op's
        # entry repeats the device time of the kernels it launched
        avgs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(_self_device_us(e) for e in avgs) / ticks
        n_dev = sum(e.count for e in avgs) / ticks
        if n_dev == 0:
            raise AssertionError(f"run ({summ['run']}): the profiler saw "
                                 f"no device work")
        top = sorted(avgs, key=_self_device_us, reverse=True)[:8]
        log(f"[profile] ({summ['run']}) first {ticks} ticks: device "
            f"{dev_us:.2f} us/tick, busy share {dev_us / summ['us_per_tick']!r}"
            f" of the unprofiled {summ['us_per_tick']:.2f} us/tick; "
            f"{n_dev:.2f} device launches/tick, "
            f"{summ['us_per_tick'] / n_dev:.2f} us of wall time each")
        for e in top:
            log(f"[profile] ({summ['run']})   {_self_device_us(e) / ticks:9.3f}"
                f" us/tick  {e.count / ticks:6.2f} calls/tick  {e.key[:90]}")


def main():
    import torch
    name, smi = phase_probe(torch)
    sys.path[:0] = [SRC, os.path.join(ROOT, "tests")]
    import repro_torch.core as tc
    import test_torch_support as sup
    from repro_torch import kernels

    dev = "cuda"
    t0 = time.perf_counter()
    phase_build(kernels)
    rows = phase_kernels(torch, sup, dev)
    log(f"[time] build + kernels: {time.perf_counter() - t0:.1f} s")
    phase_goldens(tc, sup, dev)
    log(f"[time] + goldens: {time.perf_counter() - t0:.1f} s")
    launches, summaries = phase_main(torch, tc, kernels, sup, dev)
    log(f"[time] + main path: {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, tc, sup, dev, summaries)
        log(f"[time] + profile: {time.perf_counter() - t0:.1f} s")

    for k in ("powertcp_step", "theta_powertcp_step", "queue_arrivals"):
        if launches[k] == 0:
            raise AssertionError(f"the main path never launched {k}")
    line = []
    for k in ("powertcp_step", "theta_powertcp_step", "queue_arrivals"):
        row = rows[k]
        line.append({"name": k, "route": "cuda", "source": SOURCES[k],
                     "replaces": REPLACES[k], "launches": launches[k],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"],
                     "shape": row["shape"],
                     "padded_ms": rows[k + "@padded"]["ms"],
                     "padded_shape": rows[k + "@padded"]["shape"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
