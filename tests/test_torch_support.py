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
  tests and ``chip_smoke.py``; the sum orders of K3 and K5 spelled in
  torch (``queue_arrivals_in_k3_order``, ``flash_in_k5_order``,
  ``rmsnorm_in_k6_order``) and the
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
    float32 ops, so on the card too it rounds as the kernel does."""
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
    """The plain megakernel tick looped over the due counts ``due``.
    Returns (carry', records stacked over the ticks, the number of ticks
    that ended with the gather table overflowed, so that a queue's
    arrivals came from the in-order walk of the hop list)."""
    recs, n_ovf = [], 0
    for due_t in due.tolist():
        carry, rec = tick(carry, int(due_t))
        recs.append(rec)
        n_ovf += bool(carry.ovf)
    return (carry, type(recs[0])(*[torch.stack(list(x)) for x in zip(*recs)]),
            n_ovf)


def k4_against_plain(tc, topo, sched, cfg, law, slots, blocks,
                     expected_flows=8.0, maxdeg=None, overflows=None):
    """K4 against the plain megakernel tick on the card, from the same
    initial carry, for each K in ``blocks``: every carry leaf bit for bit
    (the gather table ``inv`` and its flag ``ovf`` included), and the
    records; their per-tick sums ``w_sum`` and ``lam`` at rtol 1e-5,
    because K4 adds them in its own fixed order and the plain tick with
    ``torch.sum``. ``maxdeg`` narrows the gather table (default
    ``suggest_maxdeg``); ``overflows`` (by default True where ``maxdeg``
    is given) says whether the table must overflow on some tick, so that
    the plain tick's walk of the hop list is held too, or must never.
    Returns (the largest absolute difference in the two sums — every other
    value is equal —, the number of ticks with the table overflowed, the
    largest number of contributors of a queue at the end)."""
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels.queue_arrivals import max_degree
    dev = sched.start.device
    lcfg = tc.default_law_config(sched, expected_flows=expected_flows)
    sim = fluid.make_slot_sim(topo, sched, law, slots, lcfg, cfg,
                              "megakernel", dev)
    tick = mk.make_tick(sim, maxdeg=maxdeg)
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
        for f in grec._fields:
            g = getattr(grec, f)
            w = getattr(wrec, f).to(g.dtype)
            tol = 1e-5 if f in ("w_sum", "lam") else 0.0
            torch.testing.assert_close(
                g, w, rtol=tol, atol=0, equal_nan=True,
                msg=lambda m, n=f: f"K4 K={K} rec.{n}: {m}")
            if tol and g.numel():
                err = max(err, float(torch.max(torch.abs(g.double()
                                                         - w.double()))))
    return err, n_ovf, max_degree(want.state.path, int(topo.num_queues))


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


def lm_teacher_forced(params, cfg, prompt, tokens, cache_len):
    """The port's prefill of ``prompt`` [B,P], then one decode step per
    column of ``tokens`` [B,N] (teacher forced). Returns [(what, tensor on
    the CPU)]: the logits of each forward and the first block's cache."""
    from repro_torch.models.lm import lm_decode_step, lm_prefill
    P = prompt.shape[1]
    out = []
    logits, cache = lm_prefill(params, {"tokens": prompt}, cfg, cache_len)
    out.append(("prefill logits", logits.cpu()))
    for i in range(tokens.shape[1]):
        logits, cache = lm_decode_step(params, tokens[:, i:i + 1], cache,
                                       P + i, cfg)
        out.append((f"decode {i} logits", logits.cpu()))
    for n in ("k", "v"):
        out.append((f"cache {n}", cache["b0_attn"][n].cpu()))
    return out


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
