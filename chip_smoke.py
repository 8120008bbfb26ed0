#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a machine with a CUDA GPU and the
CUDA toolkit (``nvcc``). Phases, each of which fails the script (non-zero
exit, traceback) if anything in it is wrong:

1. probe: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (K1/K2, K3, K4,
   K5, K6), one nvcc per source, all at once;
3. kernels: K1 ``powertcp_step`` and K2 ``theta_powertcp_step`` against
   their plain PyTorch versions bit for bit, K3 ``queue_arrivals`` at
   rtol 1e-5 / atol 1e-3 bytes, at the main path's shapes, ragged ones
   and the edges of K3's row chunks and column tiles; K3 also bit for
   bit against its own sum order spelled in torch and against itself
   run twice (its elected combine); then each timed (CUDA graph replays
   of many launches, median of rounds) beside its plain version and, for
   K3, ``torch.einsum`` (the library yardstick, used nowhere in the
   port);
4. K4 ``fused_tick_block`` (the megakernel, 64 ticks per launch) against
   its plain version from the same initial carry, every carry leaf bit
   for bit (the records' per-tick sums at rtol 1e-5): the 12-flow anchor
   of ``tests/test_megakernel.py`` with K in {1, 7, 64}, S < N for both
   laws, S = 1, and the first 2 000 ticks of the paper scenario for both
   laws, each with the gather table at its suggested width, and the
   anchor and the paper ticks again with the table narrowed until it
   overflows (the plain tick then walks the hop list; K4's contributor
   lists are never truncated, and it writes the table and its flag as
   the plain tick does); then timed over the whole 40 000-tick paper
   run, every launch (CUDA events between back-to-back launches), with a
   bound counted from each launch's data, the plain block run from the
   same carry at five launches of that run, timed and held bit for bit,
   and a pass of one tick per launch that counts the admit ticks;
5. goldens: the ``powertcp`` and ``theta_powertcp`` legs of
   ``tests/golden/golden_laws.json`` through the port's ``simulate`` on
   the card, both backends, at ``tests/test_golden_traces.py``'s
   tolerances;
6. main path: PowerTCP on the 256-host paper fabric (seed 1, 60% load,
   30 ms of web-search arrivals + 10 ms drain, 40 000 ticks of 1 us):
   (a) ``simulate_slots`` fused, 384 slots; (b) ``simulate_slots``
   reference; (c) ``simulate`` (padded) fused; (d) theta-PowerTCP,
   ``simulate_slots`` fused; (e) ``simulate_slots`` megakernel; (f)
   theta-PowerTCP, ``simulate_slots`` megakernel. Each run starts with
   the kernel launch counts at zero; the fused runs must launch the law
   kernel and K3 once per tick, the megakernel runs K4 once per 64 ticks
   (625 times) and nothing else, the reference run none. Each is held to
   the JAX reference's per-flow FCTs
   (``tests/golden/torch_port_paper_seed1.json``): the same completion
   set, and a short-flow (< 10 kB) p99.9 FCT within 1e-3.

7. LM kernels: K5 ``flash_attention`` and K6 ``rmsnorm`` against their
   plain PyTorch versions at the serve run's shapes (K5: prefill q
   [4,40,512,128] over k/v [4,8,512,128], decode q [4,40,1,128] over the
   first 513 and 543 positions of a [4,544,8,128] cache, read in place;
   K6: the layer norms' [2048,5120] and [4,5120] rows, the qk-norms'
   [81920,128], [16384,128] and [160,128]), K5 at 2e-2 and K6 within one
   bfloat16 ulp; K5 also at the edges of its query tiles, key tiles and
   decode splits (``test_torch_support.FLASH_EDGE_SHAPES``: T and S of
   63-129, a window across a tile, decode at S = 1, below one split and
   with a partial one, T = 2..4 over a GQA group of 5, D = 16 and 256),
   and bit for bit against itself run twice at the serve shapes; then
   each timed beside its plain version and one PyTorch
   call for the same function (``F.scaled_dot_product_attention`` with
   ``enable_gqa``, ``F.rms_norm``; the library yardstick, used nowhere in
   the port; ``F.rms_norm`` takes the scale in bf16, as its fused path
   needs, and is also timed with the same float32 scale K6 reads);
8. serve: qwen3-14b at full width (40 layers, d_model 5120, float32
   params drawn on the card from a ``torch.Generator`` seeded 0) through
   ``repro_torch.serve.decode_loop``: 4 prompts of 512 tokens from a seed,
   32 greedy tokens each (one prefill and 31 decode steps), cache of 544
   positions. The launch counts are zeroed just before and read just
   after: K5 once per layer per forward (1 280), K6 four times per layer
   plus the final norm per forward (5 152), no other kernel. Every
   logit finite, every token below the vocabulary. Prints the prefill
   time, ms per decode step, tokens/s and the peak device memory. The
   memory is freed before and after, so that the ~60 GB of params never
   meet another phase's tensors.

``--profile`` adds a phase after 6: each main-path run under
``torch.profiler`` (the first 200 ticks of the eager runs, the whole
40 000 ticks of the megakernel runs), with the device time and device
launches per tick, the device-busy share and the kernels that take the
most device time; and phase 8 runs the serve run a second time under
``torch.profiler``, with K5's and K6's share of its device time.

The redesigned kernels (``src/repro_torch/csrc``): K3 is a split
reduction over 64-row chunks of the incidence on a grid of 64-column
tiles, whose last block per tile (elected by a counter) adds the chunks'
partials in chunk order and integrates the queues; K5 runs bf16 on the
tensor cores (``mma.sync``, P split into bf16 halves), prefill in
64-row query tiles over ``cp.async`` double-buffered key tiles, decode
split over 64-key ranges with one block per (b, kv head, split) serving
the whole GQA group and the last block merging the splits in order. Both
keep one launch per call and sum in a fixed order. K6 holds each row in
registers as 16-byte vectors, a block of 128 threads per wide row and 16
lanes per 128-wide row, with a fixed-order butterfly and warp-order sum
(phase 7 also holds it bit for bit against that order spelled in torch,
in bfloat16 and float32, and against a second run, and prints its time
beside ``F.rms_norm`` at each serve shape). K4 stages its carry, the
topology it indexes and its temporaries in shared memory for the launch,
with each queue's full contributor list (a CSR rebuilt by a block-wide
stable counting sort on admit ticks) in place of the truncated gather
table and its overflow walk; ``k4_timing`` splits its launch times by
the table's overflow flag and by the launch's admit ticks (counted by a
third pass of one tick per launch).

It prints one ``{"kernels": [...]}`` line (K1-K6), the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``. It exits non-zero, printing
no result, when CUDA is not available or the checkout's sources are
missing.
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
# tensor cores, dense bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12

SIM_KERNELS = ("powertcp_step", "theta_powertcp_step", "queue_arrivals",
               "fused_tick_block")
LM_KERNELS = ("flash_attention", "rmsnorm")
KERNELS = SIM_KERNELS + LM_KERNELS
REPLACES = {
    "powertcp_step": "src/repro/kernels/powertcp_step.py:51",
    "theta_powertcp_step": "src/repro/kernels/powertcp_step.py:101",
    "queue_arrivals": "src/repro/kernels/queue_arrivals.py:312",
    "fused_tick_block": "src/repro/kernels/fused_tick.py:74",
    "flash_attention": "src/repro/kernels/flash_attention.py:98",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:26",
}
SOURCES = {
    "powertcp_step": "src/repro_torch/csrc/powertcp_step.cu",
    "theta_powertcp_step": "src/repro_torch/csrc/powertcp_step.cu",
    "queue_arrivals": "src/repro_torch/csrc/queue_arrivals.cu",
    "fused_tick_block": "src/repro_torch/csrc/fused_tick.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
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


def bound_ms(nbytes, flops, peak_ops=PEAK_F32_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_ops * 1e3
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


def flash_cost(B, H, KV, T, S, D, itemsize=2):
    """K5, causal with the queries at the last T of S positions: q, k, v
    read once and the output written once; 4·D flops (two products, each
    a multiply and an add) per visible query-key pair."""
    pairs = sum(min(S, t + S - T + 1) for t in range(T))
    return (2 * B * H * T * D + 2 * B * KV * S * D) * itemsize, \
        4 * B * H * D * pairs


def rmsnorm_cost(N, D, itemsize=2):
    """K6: x read and y written once, the float32 scale read once; per
    element a square-add, a multiply by the inverse root and one by the
    scale (4 flops)."""
    return 2 * N * D * itemsize + 4 * D, 4 * N * D


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
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
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
    for H, F, Q in [(3, 2406, 289), (3, 384, 289), (1, 1, 2), (5, 257, 129),
                    (1, 257, 2), (5, 1, 129)] + sup.QUEUE_EDGE_SHAPES:
        kw = on(sup.queue_inputs(H, F, Q, seed=H + F + Q))
        got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
        again = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        spelled = sup.queue_arrivals_in_k3_order(**kw, dt=sup.QUEUE_DT)
        torch.cuda.synchronize()
        for g, w, a, o in zip(got, want, again, spelled):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
            torch.testing.assert_close(a, g, rtol=0, atol=0)
            torch.testing.assert_close(g, o, rtol=0, atol=0)
        e = maxerr(got, want)
        errs["queue_arrivals"] = max(errs["queue_arrivals"], e)
        log(f"[kernels] queue_arrivals H={H} F={F} Q={Q}: max abs err "
            f"{e!r} (rtol 1e-5, atol 1e-3); bitwise equal to its order "
            f"spelled in torch and to a second run")

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
             ("d", "slot", "theta_powertcp", "fused"),
             ("e", "slot", "powertcp", "megakernel"),
             ("f", "slot", "theta_powertcp", "megakernel"))


def expected_launches(law, backend, steps):
    """Launches each kernel must count in one main-path run: the fused
    backend one law kernel and one K3 per tick, the megakernel one K4 per
    block of 64 ticks (and one for a remainder), the reference none."""
    from repro_torch.kernels import DEFAULT_BLOCK
    if backend == "fused":
        law_kernel = ("theta_powertcp_step" if law == "theta_powertcp"
                      else "powertcp_step")
        return {law_kernel: steps, "queue_arrivals": steps}
    if backend == "megakernel":
        return {"fused_tick_block": -(-steps // DEFAULT_BLOCK)}
    return {}


# -------------------------------------------------------------------------
# K4: the megakernel against its plain version
# -------------------------------------------------------------------------

def k4_pool(carry, fluid, bw, law, dt):
    """What one K4 launch must read of its rings, counted from the pool in
    ``carry`` at a launch's edge: per slot holding a flow, the rows of
    ``hist_lam`` back to its longest hop delay tf and of ``hist_w`` back
    to its window delay wd (from the delayed queue observation, as the
    tick computes it); per queue, the rows of the packed ``hist_q`` back
    to the longest feedback delay tb of a hop on it, 3 columns for
    PowerTCP (q, out, qdot), 1 for theta-PowerTCP. Also the admission
    cursor, the FCTs written so far, the gather table's live entries, the
    slots in use and the overflow flag."""
    import torch
    st = carry.state
    N = int(st.fct.shape[0]) - 1
    Q = int(bw.shape[0]) - 1
    D = int(st.hist_lam.shape[0])
    occ = st.slot_flow < N
    valid = st.path < Q
    live = valid & occ[:, None]
    tb = torch.clamp(st.rtt_steps[:, None] - st.tf_steps, 1, D - 2)
    q_back = torch.zeros(Q + 1, dtype=torch.int32, device=tb.device)
    q_back.scatter_reduce_(0, st.path.flatten().long(),
                           torch.where(live, tb, 0).flatten(), "amax")
    oh = torch.remainder(int(st.t) % D - tb, D)
    theta = st.tau + fluid._hop_sum(torch.where(
        valid, st.hist_q[oh, st.path] / bw[st.path], 0.0))
    wd = torch.clamp(torch.round(theta / dt).to(torch.int32), 1, D - 2)
    return dict(
        lam=int(torch.where(live, st.tf_steps, 0).amax(1).sum()),
        q=int(q_back[:Q].sum()) * (3 if law == "powertcp" else 1),
        w=int(torch.where(occ, wd, 0).sum()),
        inv=int(valid.sum()) + Q + 1,
        cursor=int(st.cursor), fct=int(torch.isfinite(st.fct[:N]).sum()),
        live=int(occ.sum()), ovf=bool(carry.ovf))


def k4_cost(S, H, Q1, K, nsw, swdeg, law, pre, post):
    """Bytes and flops of one K-tick launch of K4, counted from
    ``csrc/fused_tick.cu`` and this launch's data (``k4_pool`` at its
    first and last tick; the larger count of the two where the pool
    decides). Bytes, each read once or written once: the slot vectors and
    queue vectors read and written; K rows of each ring written; the ring
    elements from before the launch that its reads reach; the gather
    table's live entries read (and written when the cursor moved); the
    FCTs flushed; the topology, the due table and the schedule rows of
    the admitted flows read. Rows a launch writes and then reads are its
    own and cost nothing more. Flops per tick: per slot-hop ~6 for
    theta_now and theta_obs, plus 8 for PowerTCP's normalized power; per
    slot ~34 (rate, law, clamp, progress; theta-PowerTCP adds 5); per
    valid hop one arrival add; per queue ~10 (caps, integration,
    gradient); per switch its fold."""
    admitted = post["cursor"] - pre["cursor"]
    inv = max(pre["inv"], post["inv"])
    words = (2 * S * (2 * H + 17 + (law == "theta_powertcp")) + 4 * Q1
             + K * (2 * S + 3 * Q1)
             + sum(max(pre[k], post[k]) for k in ("lam", "q", "w"))
             + inv * (2 if admitted else 1) + post["fct"] - pre["fct"]
             + 3 * Q1 + nsw * (swdeg + 1) + K + admitted * (2 * H + 10))
    per_tick = S * H * (6 + (8 if law == "powertcp" else 0) + 1) \
        + S * (34 + (5 if law == "theta_powertcp" else 0)) + 10 * Q1 \
        + nsw * swdeg
    return 4 * words, K * per_tick


def phase_k4(torch, tc, sup, dev, paper_ticks=2000):
    """K4 against its plain version at the anchor shapes, with the gather
    table at its suggested width and narrowed until it overflows, then
    timed over a whole paper run. Returns the kernels-line row of K4."""
    check = sup.k4_against_plain
    topo, sched, cfg = sup.staggered(tc, device=dev)
    err = 0.0
    for law, slots, blocks, maxdeg in (
            ("powertcp", 16, (1, 7, 64), None),
            ("powertcp", 6, (64,), None),       # S < N: recycled slots
            ("theta_powertcp", 6, (64,), None),
            ("powertcp", 16, (1, 64), 2),       # the table overflows
            ("theta_powertcp", 6, (64,), 2)):
        e, n_ovf, _ = check(tc, topo, sched, cfg, law, slots, blocks,
                            maxdeg=maxdeg)
        err = max(err, e)
        log(f"[k4] {law}: anchor 12 flows x 4000 ticks, S={slots}, K in "
            f"{blocks}, table width {maxdeg or 'suggested'} (overflowed on "
            f"{n_ovf} ticks): bitwise equal")
    e, _, _ = check(tc, *sup.single_slot(tc, device=dev), "powertcp", 1,
                    (64,))
    err = max(err, e)
    log("[k4] S=1, 3 flows x 4000 ticks: bitwise equal")

    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    ptopo, psched = paper_scenario(tc, sup, dev, ref)
    pcfg = tc.SimConfig(dt=ref["dt_s"], steps=paper_ticks, hist=ref["hist"],
                        update_period=ref["update_period_s"])
    for law, maxdeg in (("powertcp", None), ("theta_powertcp", None),
                        ("powertcp", 4), ("theta_powertcp", 4)):
        e, n_ovf, deg = check(tc, ptopo, psched, pcfg, law, ref["slots"],
                              (64,), expected_flows=ref["expected_flows"],
                              maxdeg=maxdeg)
        err = max(err, e)
        log(f"[k4] {law}: paper scenario, first {paper_ticks} ticks, "
            f"S={ref['slots']}, table width {maxdeg or 'suggested'} "
            f"(overflowed on {n_ovf} ticks, busiest queue {deg} "
            f"contributors): bitwise equal")
    row = k4_timing(torch, tc, sup, dev, ref, ptopo, psched)
    row["max_abs_err"] = err
    return row


def k4_timing(torch, tc, sup, dev, ref, topo, sched, law="powertcp"):
    """K4 over the whole 40 000-tick paper run, launch by launch, three
    times from the same initial carry. Pass 1 times every launch: the
    launches go back to back with a CUDA event after each, the queue kept
    ahead of the host, so each interval is one launch's device time. Pass
    2 counts each launch's data for its bound (``k4_pool``, read between
    launches), and at five launches spread over the run also runs the
    plain block from the same carry, timed by the host clock and held
    bit for bit against K4's. Pass 3 runs one tick per launch and logs
    the admission cursor on the card after each tick, which gives each
    64-tick launch's admit ticks (the ticks that rebuild the contributor
    lists). The three passes must end on the same carry. The kernels line
    takes the mean launch time and the mean bound over the run; the log
    splits the launch times by the gather table's overflow flag and by
    admit ticks."""
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels import ops, ref as kref
    cfg = tc.SimConfig(dt=ref["dt_s"], steps=ref["steps"], hist=ref["hist"],
                       update_period=ref["update_period_s"])
    lcfg = tc.default_law_config(sched, expected_flows=ref["expected_flows"])
    sim = fluid.make_slot_sim(topo, sched, law, ref["slots"], lcfg, cfg,
                              "megakernel", dev)
    tick = mk.make_tick(sim)
    carry0 = tick.init_carry(fluid.init_slot_state(sim))
    due = torch.as_tensor(mk._due_table(sim.sched, cfg.steps, cfg.dt),
                          device=dev)
    K = mk.DEFAULT_BLOCK
    n = cfg.steps // K
    blocks = [due[i * K:(i + 1) * K] for i in range(n)]

    carry = sup.tree_clone(carry0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(n):
        carry, _ = ops.fused_tick_block(tick, carry, blocks[i], record=False)
        ev[i + 1].record()
    ev[n].synchronize()
    ms = np.array([ev[i].elapsed_time(ev[i + 1]) for i in range(n)])
    end1 = carry

    static = sim.static
    S, H = (int(x) for x in carry0.state.path.shape)
    Q1 = int(static.bw.shape[0])
    nsw, swdeg = ((0, 0) if static.sw_table is None
                  else tuple(static.sw_table.shape))
    carry = sup.tree_clone(carry0)
    pre = k4_pool(carry, fluid, static.bw, law, cfg.dt)
    samples = set(int(x) for x in np.linspace(0, n - 1, 7)[1:-1])
    bounds, pools, plain = [], [pre], []
    for i in range(n):
        if i in samples:
            pc = sup.tree_clone(carry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc, _ = kref.fused_tick_block_ref(tick, pc, blocks[i],
                                              record=False)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        carry, _ = ops.fused_tick_block(tick, carry, blocks[i], record=False)
        if i in samples:
            for (name, g), (_, w) in zip(sup.tree_leaves(carry),
                                         sup.tree_leaves(pc)):
                torch.testing.assert_close(
                    g, w, rtol=0, atol=0, equal_nan=True,
                    msg=lambda m, nm=name: f"K4 launch {i} {nm}: {m}")
        post = k4_pool(carry, fluid, static.bw, law, cfg.dt)
        nbytes, flops = k4_cost(S, H, Q1, K, nsw, swdeg, law, pre, post)
        bounds.append(bound_ms(nbytes, flops))
        pools.append(post)
        pre = post
    end2 = carry
    carry = sup.tree_clone(carry0)
    cursors = torch.empty(n * K, dtype=torch.int32, device=dev)
    for t in range(n * K):
        carry, _ = ops.fused_tick_block(tick, carry, due[t:t + 1],
                                        record=False)
        cursors[t] = carry.state.cursor
    for end, what in ((end2, "pass 2"), (carry, "pass 3 (one tick a launch)")):
        for (name, g), (_, w) in zip(sup.tree_leaves(end),
                                     sup.tree_leaves(end1)):
            torch.testing.assert_close(
                g, w, rtol=0, atol=0, equal_nan=True,
                msg=lambda m, nm=name, wh=what: f"K4 {wh} {nm}: {m}")
    cur = np.concatenate([[int(carry0.state.cursor)],
                          cursors.cpu().numpy().astype(np.int64)])
    admit = (np.diff(cur) > 0).reshape(n, K).sum(1)
    log(f"[k4] plain block at launches {sorted(samples)} of the paper run: "
        f"bitwise equal to K4; the three K4 passes end on the same carry")

    bms = np.array([b for b, _ in bounds])
    by = max(set(b for _, b in bounds), key=[b for _, b in bounds].count)
    ovf = np.array([p["ovf"] for p in pools[:-1]])
    live = np.array([p["live"] for p in pools[1:]])
    adm = np.array([b["cursor"] - a["cursor"]
                    for a, b in zip(pools, pools[1:])])
    q10, q50, q90 = (float(x) for x in np.percentile(ms, [10, 50, 90]))
    def mean(sel):
        return float(ms[sel].mean()) if sel.any() else float("nan")

    row = dict(shape=f"S={S} H={H} Q+1={Q1} D={ref['hist']} K={K}",
               ms=float(ms.mean()), plain_ms=float(np.mean(plain)),
               bound_ms=float(bms.mean()), bound_by=by, library_ms=None,
               us_per_tick=float(ms.mean()) / K * 1e3,
               ms_overflowed=mean(ovf), ms_not_overflowed=mean(~ovf),
               admit_ticks=int(admit.sum()))
    log(f"[k4] time fused_tick_block ({row['shape']}, {law}, {n} launches "
        f"over the whole run): mean {row['ms']!r} ms per launch "
        f"({row['us_per_tick']!r} us/tick), median {q50!r}, p10 {q10!r}, "
        f"p90 {q90!r}, max {float(ms.max())!r}; plain_ms {row['plain_ms']!r}"
        f" (mean of {len(plain)}); bound mean {row['bound_ms']!r} ms "
        f"({by}), min {float(bms.min())!r}, max {float(bms.max())!r}")
    log(f"[k4] table width {tick.maxdeg}: overflowed at the start of "
        f"{int(ovf.sum())} of {n} launches; mean ms per launch with it "
        f"{row['ms_overflowed']!r}, without {row['ms_not_overflowed']!r}")
    log(f"[k4] admit ticks (the cursor moved; the contributor lists are "
        f"rebuilt): {row['admit_ticks']} of {n * K} ticks; mean ms per "
        f"launch with none {mean(admit == 0)!r} ({int((admit == 0).sum())} "
        f"launches), 1-4 {mean((admit > 0) & (admit < 5))!r} "
        f"({int(((admit > 0) & (admit < 5)).sum())}), 5 or more "
        f"{mean(admit >= 5)!r} ({int((admit >= 5).sum())})")
    for lo in range(0, n, n // 10 + 1):
        sl = slice(lo, min(lo + n // 10 + 1, n))
        log(f"[k4]   launches {sl.start}-{sl.stop - 1} (ticks "
            f"{sl.start * K}-{sl.stop * K - 1}): mean {float(ms[sl].mean())!r}"
            f" ms, slots in use {float(live[sl].mean()):.1f}, admitted "
            f"{int(adm[sl].sum())} on {int(admit[sl].sum())} ticks, "
            f"overflowed {int(ovf[sl].sum())}, bound "
            f"{float(bms[sl].mean())!r} ms")
    return row


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
    want = expected_launches(law, backend, steps)
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
            f"{summ['p999_rel_err']:.3g}), largest per-flow FCT rel err "
            f"{summ['fct_max_rel_err']!r}, launches {summ['launches']}")
    log("[main] " + json.dumps({"main_path": summaries}))
    return launches, summaries


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def phase_profile(torch, tc, sup, dev, summaries, ticks=200):
    """``--profile``: each main-path run under ``torch.profiler`` — the
    first ``ticks`` ticks of the eager runs, the whole run of the
    megakernel runs (it takes about a second). Prints the device time and
    device launches per tick, the device-busy share against that run's
    unprofiled wall time per tick, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    topo, sched = paper_scenario(tc, sup, dev, ref)
    for summ in summaries:
        n = summ["steps"] if summ["backend"] == "megakernel" else ticks
        cfg = tc.SimConfig(dt=ref["dt_s"], steps=n, hist=ref["hist"],
                           update_period=ref["update_period_s"])
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
        dev_us = sum(_self_device_us(e) for e in avgs) / n
        n_dev = sum(e.count for e in avgs) / n
        if n_dev == 0:
            raise AssertionError(f"run ({summ['run']}): the profiler saw "
                                 f"no device work")
        top = sorted(avgs, key=_self_device_us, reverse=True)[:8]
        log(f"[profile] ({summ['run']}) first {n} ticks: device "
            f"{dev_us:.2f} us/tick, busy share {dev_us / summ['us_per_tick']!r}"
            f" of the unprofiled {summ['us_per_tick']:.2f} us/tick; "
            f"{n_dev:.2f} device launches/tick, "
            f"{summ['us_per_tick'] / n_dev:.2f} us of wall time each")
        for e in top:
            log(f"[profile] ({summ['run']})   {_self_device_us(e) / n:9.3f}"
                f" us/tick  {e.count / n:6.2f} calls/tick  {e.key[:90]}")


# -------------------------------------------------------------------------
# the LM slice: K5, K6 and the qwen3-14b serve run
# -------------------------------------------------------------------------

def free_memory(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_lm_kernels(torch, sup, dev):
    """K5 and K6 against their plain versions at the serve run's shapes,
    then timed beside the plain version and the PyTorch call for the same
    function. Returns {name: row} for the kernels line (K5 at the prefill
    shape with its decode shape under ``decode_*``; K6 at the prefill
    layer norm's rows with the qk-norm's and the decode rows beside)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, rmsnorm
    bf = torch.bfloat16
    B, H, KV, D = (sup.SERVE_BATCH, 40, 8, 128)
    P, C = sup.SERVE_PROMPT, sup.SERVE_CACHE

    def flash_case(T, S, seed):
        q, k, v = (torch.as_tensor(a, device=dev).to(bf) for a in
                   sup.flash_inputs(B, H, KV, T, S, D, seed=seed))
        if T == 1:      # the decode reads the cache in place: [B,S,KV,D]
            cache = torch.zeros(B, C, KV, D, dtype=bf, device=dev)
            cache[:, :S] = k.permute(0, 2, 1, 3)
            k = v = cache[:, :S].permute(0, 2, 1, 3)
            q = q.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        return q, k, v

    err = {"flash_attention": 0.0, "rmsnorm": 0.0}
    cases = {"prefill": (P, P), "decode_first": (1, P + 1),
             "decode": (1, C - 1)}
    for tag, (T, S) in cases.items():
        q, k, v = flash_case(T, S, seed=T + S)
        got = flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        again = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        e = float((got.float() - want.float()).abs().max())
        err["flash_attention"] = max(err["flash_attention"], e)
        log(f"[lm] flash_attention {tag} q {list(q.shape)} k/v "
            f"{list(k.shape)}: max abs err {e!r} (rtol/atol 2e-2); "
            f"bitwise equal to a second run")
    for (Be, He, KVe, T, S, De, causal, window,
         _) in sup.FLASH_EDGE_SHAPES:
        q, k, v = (torch.as_tensor(a, device=dev).to(bf) for a in
                   sup.flash_inputs(Be, He, KVe, T, S, De, seed=T + S))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        e = float((got.float() - want.float()).abs().max())
        err["flash_attention"] = max(err["flash_attention"], e)
        log(f"[lm] flash_attention edge q {list(q.shape)} k/v "
            f"{list(k.shape)} causal {causal} window {window}: max abs err "
            f"{e!r} (rtol/atol 2e-2)")
    norm_rows = {"ln prefill": B * P, "qk prefill": B * P * H,
                 "k prefill": B * P * KV, "ln decode": B, "qk decode": B * H}
    for tag, N in norm_rows.items():
        Dn = 5120 if tag.startswith("ln") else D
        x, s = (torch.as_tensor(a, device=dev)
                for a in sup.rmsnorm_inputs(N, Dn, seed=N))
        x32, x = x, x.to(bf)
        got = rmsnorm(x, s, eps=1e-6)
        want = ref.rmsnorm_ref(x, s, eps=1e-6)
        again = rmsnorm(x, s, eps=1e-6)
        spelled = sup.rmsnorm_in_k6_order(x, s, 1e-6)
        got32 = rmsnorm(x32, s, eps=1e-6)
        spelled32 = sup.rmsnorm_in_k6_order(x32, s, 1e-6)
        torch.cuda.synchronize()
        ulps = sup.bf16_ulps(got, want)
        if ulps > 1.0:
            raise AssertionError(f"rmsnorm {tag}: {ulps} bfloat16 ulps off")
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        torch.testing.assert_close(got, spelled, rtol=0, atol=0)
        torch.testing.assert_close(got32, ref.rmsnorm_ref(x32, s, eps=1e-6),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got32, spelled32, rtol=0, atol=0)
        e = float((got.float() - want.float()).abs().max())
        err["rmsnorm"] = max(err["rmsnorm"], e)
        log(f"[lm] rmsnorm {tag} [{N}, {Dn}]: max abs err {e!r}, "
            f"{ulps!r} bfloat16 ulps (at most 1); float32 within rtol 1e-5; "
            f"both bitwise equal to its order spelled in torch, bfloat16 to "
            f"a second run")

    rows = {}
    for tag, (T, S) in (("", cases["prefill"]), ("decode_", cases["decode"])):
        q, k, v = flash_case(T, S, seed=1)
        nbytes, flops = flash_cost(B, H, KV, T, S, D)
        b, by = bound_ms(nbytes, flops, PEAK_BF16_S)
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)) if T == S else (
            lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True))
        rows[tag] = dict(
            shape=f"q [{B},{H},{T},{D}] k/v [{B},{KV},{S},{D}] bf16",
            ms=graph_ms(torch, lambda: flash_attention(q, k, v)),
            plain_ms=graph_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v)),
            bound_ms=b, bound_by=by, library_ms=graph_ms(torch, lib))
    k5 = dict(rows[""], max_abs_err=err["flash_attention"])
    for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        k5["decode_" + key] = rows["decode_"][key]
    rows = {}
    for tag, (N, Dn) in (("", (B * P, 5120)), ("qk_", (B * P * H, D)),
                         ("decode_", (B, 5120))):
        x, s = (torch.as_tensor(a, device=dev)
                for a in sup.rmsnorm_inputs(N, Dn, seed=1))
        x = x.to(bf)
        sb = s.to(bf)
        nbytes, flops = rmsnorm_cost(N, Dn)
        b, by = bound_ms(nbytes, flops)
        rows[tag] = dict(
            shape=f"x [{N},{Dn}] bf16, scale f32",
            ms=graph_ms(torch, lambda: rmsnorm(x, s)),
            plain_ms=graph_ms(torch, lambda: ref.rmsnorm_ref(x, s)),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch, lambda: F.rms_norm(x, (Dn,), sb,
                                                          1e-6)),
            library_f32_scale_ms=graph_ms(
                torch, lambda: F.rms_norm(x, (Dn,), s, 1e-6), reps=20,
                rounds=3))
    for tag, row in rows.items():
        log(f"[lm] time rmsnorm {row['shape']}: K6 {row['ms'] * 1e3!r} us, "
            f"F.rms_norm {row['library_ms'] * 1e3!r} us with the scale in "
            f"bf16 (K6 / F.rms_norm {row['ms'] / row['library_ms']!r}), "
            f"{row['library_f32_scale_ms'] * 1e3!r} us with the same float32 "
            f"scale; bound {row['bound_ms'] * 1e3!r} us")
    k6 = dict(rows[""], max_abs_err=err["rmsnorm"])
    for pre in ("qk_", "decode_"):
        for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_f32_scale_ms"):
            k6[pre + key] = rows[pre][key]
    out = {"flash_attention": k5, "rmsnorm": k6}
    for name, row in out.items():
        log(f"[lm] time {name}: " + json.dumps(row))
    return out


def serve_expected_launches(cfg, forwards):
    """Per forward: K5 once per layer, K6 for ln1, ln2, q_norm and k_norm
    of each layer plus the final norm; no other kernel."""
    L = cfg.num_layers
    return {"flash_attention": L * forwards,
            "rmsnorm": (4 * L + 1) * forwards}


def phase_serve(torch, kernels, sup, dev, profile=False):
    """qwen3-14b at full width through ``decode_loop`` (see the module
    docstring). Returns (launches, summary)."""
    from repro_torch import configs, models, serve
    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("qwen3-14b")
    specs = models.lm_specs(cfg)
    t0 = time.perf_counter()
    params = models.init_params(
        specs, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1)
    tv = cfg.true_vocab or cfg.vocab_size
    prompt = torch.randint(0, tv, (sup.SERVE_BATCH, sup.SERVE_PROMPT),
                           generator=gen, device=dev)
    log(f"[serve] {cfg.name}: {models.num_params(specs)} params "
        f"({models.num_bytes(specs) / 1e9:.2f} GB float32) drawn on the card"
        f" in {init_s:.2f} s; prompts {list(prompt.shape)}, "
        f"{sup.SERVE_STEPS} greedy tokens, cache {sup.SERVE_CACHE}")

    stamps, finite = [], []

    def on_logits(lg):
        finite.append(torch.isfinite(lg).all())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def run():
        stamps.clear()
        finite.clear()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        toks = serve.decode_loop(params, cfg, prompt, sup.SERVE_STEPS,
                                 cache_len=sup.SERVE_CACHE,
                                 on_logits=on_logits)
        torch.cuda.synchronize()
        return toks

    kernels.reset_launches()
    toks = run()
    launches = dict(kernels.LAUNCHES)
    want = serve_expected_launches(cfg, sup.SERVE_STEPS)
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"serve: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    if len(finite) != sup.SERVE_STEPS or not all(bool(f) for f in finite):
        raise AssertionError("serve: non-finite logits")
    if tuple(toks.shape) != (sup.SERVE_BATCH, sup.SERVE_STEPS) or not bool(
            ((toks >= 0) & (toks < tv)).all()):
        raise AssertionError(f"serve: tokens {toks.shape} outside "
                             f"[0, {tv})")
    steps = np.diff(stamps)
    summ = dict(prefill_s=float(steps[0]),
                decode_ms_per_step=float(steps[1:].mean() * 1e3),
                decode_ms_min=float(steps[1:].min() * 1e3),
                decode_ms_max=float(steps[1:].max() * 1e3),
                total_s=float(stamps[-1] - stamps[0]),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches)
    summ["decode_tokens_per_s"] = sup.SERVE_BATCH / (
        summ["decode_ms_per_step"] / 1e3)
    summ["tokens_per_s"] = sup.SERVE_BATCH * sup.SERVE_STEPS / summ["total_s"]
    log(f"[serve] prefill {summ['prefill_s']!r} s, decode "
        f"{summ['decode_ms_per_step']!r} ms/step (min "
        f"{summ['decode_ms_min']!r}, max {summ['decode_ms_max']!r}), "
        f"{summ['decode_tokens_per_s']!r} tokens/s in decode, "
        f"{summ['tokens_per_s']!r} tokens/s end to end, peak "
        f"{summ['peak_gb']!r} GB; launches {launches}; all logits finite; "
        f"first tokens {toks[:, :6].tolist()}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            run()
        avgs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(_self_device_us(e) for e in avgs)
        share = {k: sum(_self_device_us(e) for e in avgs
                        if k in e.key) / max(total, 1e-9)
                 for k in ("flash_tiled_mma", "flash_split_mma",
                           "rmsnorm_kernel")}
        wall = stamps[-1] - stamps[0]
        log(f"[profile] (g) serve: device {total / 1e3:.1f} ms of "
            f"{wall * 1e3:.1f} ms wall (busy share {total / 1e6 / wall!r}); "
            f"share of device time: K5 prefill {share['flash_tiled_mma']!r},"
            f" K5 decode {share['flash_split_mma']!r}, K6 "
            f"{share['rmsnorm_kernel']!r}")
        for e in sorted(avgs, key=_self_device_us, reverse=True)[:10]:
            log(f"[profile] (g)   {_self_device_us(e) / 1e3:9.3f} ms  "
                f"{e.count:6d} calls  {e.key[:90]}")
    del params, prompt, toks
    free_memory(torch)
    return launches, summ


def kernels_line(rows, launches):
    line = []
    for k in KERNELS:
        row = rows[k]
        entry = {"name": k, "route": "cuda", "source": SOURCES[k],
                 "replaces": REPLACES[k], "launches": launches[k]}
        entry.update({key: val for key, val in row.items()})
        if k + "@padded" in rows:
            entry.update(padded_ms=rows[k + "@padded"]["ms"],
                         padded_shape=rows[k + "@padded"]["shape"])
        line.append(entry)
    return line


def main():
    import torch
    name, smi = phase_probe(torch)
    sys.path[:0] = [SRC, os.path.join(ROOT, "tests")]
    import repro_torch.core as tc
    import test_torch_support as sup
    from repro_torch import kernels

    dev = "cuda"
    profile = "--profile" in sys.argv[1:]
    t0 = time.perf_counter()
    phase_build(kernels)
    rows = phase_kernels(torch, sup, dev)
    log(f"[time] build + kernels: {time.perf_counter() - t0:.1f} s")
    rows["fused_tick_block"] = phase_k4(torch, tc, sup, dev)
    log(f"[time] + K4: {time.perf_counter() - t0:.1f} s")
    phase_goldens(tc, sup, dev)
    log(f"[time] + goldens: {time.perf_counter() - t0:.1f} s")
    launches, summaries = phase_main(torch, tc, kernels, sup, dev)
    log(f"[time] + main path: {time.perf_counter() - t0:.1f} s")
    if profile:
        phase_profile(torch, tc, sup, dev, summaries)
        log(f"[time] + profile: {time.perf_counter() - t0:.1f} s")
    rows.update(phase_lm_kernels(torch, sup, dev))
    log(f"[time] + LM kernels: {time.perf_counter() - t0:.1f} s")
    serve_launches, serve_summ = phase_serve(torch, kernels, sup, dev,
                                             profile)
    log("[serve] " + json.dumps({"serve": serve_summ}))
    log(f"[time] + serve: {time.perf_counter() - t0:.1f} s")
    for k in LM_KERNELS:
        launches[k] = serve_launches[k]

    for k in KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"the main path never launched {k}")
    line = kernels_line(rows, launches)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
