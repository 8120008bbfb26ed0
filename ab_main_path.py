#!/usr/bin/env python3
"""Wall time per tick of the port's main-path runs for two checkouts of
the repo, alternating on one GPU: A, B, B, A.

    python3 ab_main_path.py [--ticks N] [--runs a,c,d,e,g,h] TREE_A TREE_B

Each pass runs in a fresh process with ``TREE/src`` on its path (the
tree's own kernels, built into ``TREE/build`` at first use) and times,
on the paper scenario of ``tests/golden/torch_port_paper_seed1.json``
(the 256-host fabric, seed 1, 384 slots), the runs of ``chip_smoke.py``
phase 6 through the public entry points: (a) ``simulate_slots`` fused,
(c) ``simulate`` (padded) fused, (d) theta-PowerTCP ``simulate_slots``
fused over the first N ticks (default 5 000), and (e) ``simulate_slots``
megakernel over the whole 40 000 ticks; then, on phase 6c's scenario
(``benchmarks/fig6_fct.py::run_paper_scale``: 130 000 ticks, 448 slots),
(g) ``powertcp`` and (h) ``dcqcn`` megakernel (``--runs`` picks a
subset, e.g. ``--runs e`` for K4 alone; (g) and (h) only when named).
Each tree's first pass also
times the build of its K4 source (``csrc/fused_tick.cu``, one ``nvcc``
before any other kernel is built). Every run is warmed up first
(a few ticks: the build and the first launches are not timed), then
timed ``REPS`` times and its median taken: the first timed run of a
process is at times 15-25% slower than the next ones;
the wall clock is the host's, around work that ends in
``torch.cuda.synchronize()``. Prints one JSON line per pass and, last, the
mean of each tree's two passes per run with the card's name and power
limit, and whether every pass gave the same FCTs bit for bit (a
SHA-256 of each run's FCT table). Run it from the repo root on a machine
with one CUDA GPU, e.g. with the parent commit unpacked into a gitignored
directory:

    git archive HEAD~1 | (mkdir -p build/ab/parent && tar -x -C build/ab/parent)
    python3 ab_main_path.py build/ab/parent .
"""
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUNS = (("a", "slot", "powertcp", "fused"),
        ("c", "padded", "powertcp", "fused"),
        ("d", "slot", "theta_powertcp", "fused"),
        ("e", "slot", "powertcp", "megakernel"),
        ("g", "fig6", "powertcp", "megakernel"),
        ("h", "fig6", "dcqcn", "megakernel"))


# timed runs of each run in a pass; the median is kept
REPS = 3


def child(tree: str, ticks: int, keys) -> dict:
    """One pass in this process over ``tree``'s port, runs ``keys``."""
    sys.path[:0] = [os.path.join(tree, "src")]
    import torch
    import repro_torch.core as tc
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build([n for n in _build.SOURCES
                          if n.partition("@")[0] == "fused_tick"])
    out = {"build_fused_tick_s": (time.perf_counter() - t0) if built
           else None}
    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_port_paper_seed1.json")) as f:
        ref = json.load(f)
    dev = "cuda"
    fab = tc.LeafSpine(**ref["fabric"])
    flows = tc.poisson_websearch(fab, ref["load"], ref["duration_s"],
                                 ref["dt_s"], seed=ref["seed"], device=dev)
    sched = tc.make_schedule(flows)
    assert int(sched.start.shape[0]) == ref["n_flows"]
    topo = fab.topology(device=dev)
    pflows = tc.schedule_as_flows(sched)

    if {"g", "h"} & set(keys):
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import test_torch_support as sup
        fig6 = sup.fig6_scenario(tc, device=dev)

    def run(engine, law, backend, steps):
        cfg = tc.SimConfig(dt=ref["dt_s"], steps=steps, hist=ref["hist"],
                           update_period=ref["update_period_s"])
        if engine == "fig6":
            ftopo, fsched, fcfg, fslots = fig6
            return tc.simulate_slots(
                ftopo, fsched, law, fslots, tc.default_law_config(
                    fsched, expected_flows=sup.PAPER_EXPECTED_FLOWS),
                fcfg._replace(steps=steps), record=False, backend=backend,
                device=dev)
        if engine == "slot":
            lcfg = tc.default_law_config(
                sched, expected_flows=ref["expected_flows"])
            return tc.simulate_slots(topo, sched, law, ref["slots"], lcfg,
                                     cfg, record=False, backend=backend,
                                     device=dev)
        lcfg = tc.default_law_config(pflows,
                                     expected_flows=ref["expected_flows"])
        return tc.simulate(topo, pflows, law, lcfg, cfg, record=False,
                           backend=backend, device=dev)

    for key, engine, law, backend in RUNS:
        if key not in keys:
            continue
        steps = (fig6[2].steps if engine == "fig6" else ref["steps"]
                 if backend == "megakernel" else ticks)
        run(engine, law, backend, 64)                       # warm-up
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = run(engine, law, backend, steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2]
        done = int(torch.isfinite(st.fct).sum())
        out[key] = dict(steps=steps, wall_s=wall, walls_s=walls,
                        us_per_tick=wall / steps * 1e6, completed=done,
                        fct_sha256=hashlib.sha256(
                            st.fct.cpu().numpy().tobytes()).hexdigest())
    return out


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        print(json.dumps(child(args[1], int(args[2]), args[3].split(","))),
              flush=True)
        return
    ticks, keys = 5000, [k for k, e, *_ in RUNS if e != "fig6"]
    while args and args[0] in ("--ticks", "--runs"):
        if args[0] == "--ticks":
            ticks = int(args[1])
        else:
            keys = args[1].split(",")
        args = args[2:]
    if len(args) != 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_main_path.py: CUDA is not available")
    trees = [os.path.abspath(t) for t in args]
    for t in trees:
        if not os.path.isdir(os.path.join(t, "src", "repro_torch")):
            sys.exit(f"ab_main_path.py: {t} holds no src/repro_torch")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    passes, builds = {0: [], 1: []}, {}
    for i in (0, 1, 1, 0):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", trees[i],
             str(ticks), ",".join(keys)], capture_output=True, text=True,
            timeout=1800)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            sys.exit(f"ab_main_path.py: the pass over {trees[i]} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        build_s = got.pop("build_fused_tick_s")
        if build_s is not None:
            builds[i] = build_s
        passes[i].append(got)
        print(json.dumps({"tree": args[i], "runs": got}), flush=True)
    summary = {}
    for key in keys:
        means = [sum(p[key]["us_per_tick"] for p in passes[i]) / 2
                 for i in (0, 1)]
        if len({p[key]["completed"] for i in (0, 1)
                for p in passes[i]}) != 1:
            sys.exit(f"ab_main_path.py: run ({key}) completes a different "
                     f"number of flows in some pass")
        summary[key] = dict(us_per_tick_a=means[0], us_per_tick_b=means[1],
                            b_over_a=means[1] / means[0],
                            fct_bitwise_equal=len({
                                p[key]["fct_sha256"] for i in (0, 1)
                                for p in passes[i]}) == 1)
    print(smi, flush=True)
    print(json.dumps({"trees": args, "ticks": ticks, "reps": REPS,
                      "device": smi,
                      "build_fused_tick_s": [builds.get(0), builds.get(1)],
                      "runs": summary}), flush=True)


if __name__ == "__main__":
    main()
