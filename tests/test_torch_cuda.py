"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 ``powertcp_step`` and K2 ``theta_powertcp_step`` bit for bit (built
with ``-fmad=false``, they round every product as the plain versions do),
K3 ``queue_arrivals`` at rtol 1e-5 / atol 1e-3 bytes (its arrival sum
runs in its own fixed order), at the main path's shapes (F = 384 slots
or 2 406 padded flows, H = 3, Q+1 = 289), ragged ones and the edges of
its row chunks and column tiles, and bit for bit against its order
spelled in torch and against itself run twice (the elected combine); K4
``fused_tick_block`` against the plain megakernel block on every carry
leaf and record bit for bit at
the anchor shapes of ``tests/test_megakernel.py``, with the gather table
at its suggested width and narrowed until it overflows (a queue 46
contributors past it, and one at exactly its width), on a pool too large
for its shared-memory layout, and the megakernel backend's launches; K5
``flash_attention`` against its plain version at 2e-5 in float32 and
2e-2 in bfloat16 on the shapes of
``tests/test_kernels.py``'s ``FLASH_CASES``, the serve run's prefill
and decode shapes (the decode reading strided views of a cache) and the
edges of its query tiles, key tiles and decode splits, bit for bit
against itself run twice, and raising on views ``cp.async`` cannot
copy; K6
``rmsnorm`` within one bfloat16 ulp in bfloat16 and at rtol 1e-5 in
float32 on the serve run's rows, and bit for bit against its order
spelled in torch and itself run twice, at those rows and ragged ones;
K4's grid form (a batch of B scenarios, one block each, B in 1-3, with
and without gate) against each scenario's plain block, K1-K3 taking a
batch in one launch, and the batched megakernel backend's launches;
each of K4's thirteen laws against the plain tick, a
per-flow gamma, a batch with per-scenario law constants, and DCQCN's
``powf`` against ``torch.pow``; the four feedback-channel laws on the
fat tree's 5-hop paths (both legs of ``benchmarks/feedback_fct.py``,
``gate`` True and False, S >= N and S < N) and as a batch with their
scalars per scenario; K4 evaluating two circuit schedules in
its body (Fig. 8's slots 0 and 6, a block each) for the PowerTCP laws,
HPCC and reTCP (its own schedule and prebuffer), and a schedule shared
by the batch, against the plain tick, and its schedule evaluation
against ``circuit_bw_at`` over Fig. 8's 4 weeks; K4 under per-link
impairments (one law per feedback channel, a regime per scenario and a
shared one) and its evaluation of a regime against ``core/impair.py``;
K1/K2's observe form and K3 with a bandwidth row per scenario;
K1/K2's observe form (``powertcp_observe_step``,
``theta_powertcp_observe_step``) bit for bit against its plain version
at the main path's shapes (S = 384, P = 2 406, B = 2 x 128, and a ragged
5-hop batch), both update modes, and a fused run of each engine
launching one observe kernel and one K3 a tick and nothing else;
K4 on a chunk window (``win_off > 0``, C < N) against the plain block,
chunk-streamed K4 runs bit for bit the unchunked run over
``CHUNK_GRID``, a crash resumed on K4 bit for bit, and a fault-tolerant
megakernel sweep with no fallback and no failure;
the sharded slot engine (``simulate_slots_sharded``) at one rank over
NCCL and over two gloo ranks sharing the card, against K4 on the paper
leaf-spine's impaired anchor;
HOMA's allocator on the card bit for bit its CPU result, HOMA through
the padded engine on the card against ``repro``'s golden run, Fig. 4's
two incasts (the long-lived flow from ``start = -1``) as a K4 grid
against the plain tick, and ``commsched``'s outer sync over a one-rank
NCCL group against its one-process spelling;
and the REDUCED qwen3-14b model on the
card against the port on the CPU at the tight bar of
``tests/test_torch_lm.py``; the trainer's backward kernels, K5's
``flash_attention_bwd`` and K6's ``rmsnorm_bwd``, against their plain
versions (relative to the largest gradient: 2e-2 in bfloat16, 2e-5 in
float32) and bit for bit against a second launch, the two
``autograd.Function``s launching them on CUDA tensors, and one REDUCED
train step on the card against the port on the CPU; K5 at head dim 80
and its backward at 80 and 256, the other five REDUCED architectures on
the card against the CPU, and the MoE layer bit for bit run to run;
K5 at head dim 96 and its backward there (``FLASH_BWD_D96_SHAPES``),
whisper's unmasked encoder and cross-attention shapes, and the REDUCED
whisper and phi3-vision on the card against the CPU.
Every test takes the ``cuda_device``
fixture and skips without a card; this module imports neither JAX nor
``repro``, so it runs where only PyTorch is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import test_torch_support as sup
from test_torch_support import cuda_device  # noqa: F401  (fixture)

from repro_torch.kernels import (powertcp_step, queue_arrivals, ref,
                                 theta_powertcp_step)


def _on(kw, device):
    return {k: torch.as_tensor(v, device=device) for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("F,H", [(1, 1), (257, 5), (384, 3), (2406, 3)])
def test_powertcp_step_kernel(cuda_device, F, H):
    kw = _on(sup.law_inputs(F, H), cuda_device)
    got = powertcp_step(**kw, gamma=0.9, w_min=1000.0)
    want = ref.powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 257, 384, 2406])
def test_theta_powertcp_step_kernel(cuda_device, F):
    kw = _on(sup.theta_inputs(F), cuda_device)
    got = theta_powertcp_step(**kw, gamma=0.9, w_min=1000.0)
    want = ref.theta_powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,F,Q", [(1, 1, 2), (5, 257, 129), (3, 384, 289),
                                   (3, 2406, 289)] + sup.QUEUE_EDGE_SHAPES)
def test_queue_arrivals_kernel(cuda_device, H, F, Q):
    kw = _on(sup.queue_inputs(H, F, Q), cuda_device)
    got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
    want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("H,F,Q", [(3, 384, 289), (3, 2406, 289),
                                   (1, 20, 70), (5, 1000, 300)])
def test_queue_arrivals_kernel_is_its_order_run_to_run(cuda_device, H, F,
                                                       Q):
    """K3 twice on the same inputs gives the same bits, and those of its
    sum order spelled in torch (elementwise float32 ops on the card)."""
    kw = _on(sup.queue_inputs(H, F, Q, seed=7), cuda_device)
    first = queue_arrivals(**kw, dt=sup.QUEUE_DT)
    again = queue_arrivals(**kw, dt=sup.QUEUE_DT)
    spelled = sup.queue_arrivals_in_k3_order(**kw, dt=sup.QUEUE_DT)
    for f, a, s in zip(first, again, spelled):
        torch.testing.assert_close(a, f, rtol=0, atol=0)
        torch.testing.assert_close(f, s, rtol=0, atol=0)


@pytest.mark.cuda
def test_wrappers_count_their_launches(cuda_device):
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    kw = _on(sup.law_inputs(8, 3), cuda_device)
    powertcp_step(**kw)
    powertcp_step(**kw)
    assert LAUNCHES["powertcp_step"] == 2
    assert LAUNCHES["queue_arrivals"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("law,slots,blocks,maxdeg", [
    ("powertcp", 16, (1, 7, 64), None),    # S >= N, block edges everywhere
    ("powertcp", 6, (64,), None),          # S < N: slots recycled
    ("theta_powertcp", 6, (64,), None),
    ("powertcp", 16, (1, 64), 2),          # the gather table overflows
    ("theta_powertcp", 6, (64,), 2)])
def test_fused_tick_block_kernel_anchor(cuda_device, law, slots, blocks,
                                        maxdeg):
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, device=cuda_device)
    sup.k4_against_plain(tc, topo, sched, cfg, law, slots, blocks,
                         maxdeg=maxdeg)


@pytest.mark.cuda
@pytest.mark.parametrize("law,n,slots,maxdeg,overflows", [
    ("powertcp", 48, 48, 2, True),         # 48 contributors: 46 past the
    ("theta_powertcp", 48, 48, 2, True),   # table's width
    ("powertcp", 12, 16, 12, False)])      # exactly maxdeg: a full row
def test_fused_tick_block_kernel_contributor_lists(cuda_device, law, n,
                                                   slots, maxdeg, overflows):
    """K4's untruncated contributor lists against the plain tick's gather
    table, bit for bit with ``inv`` and ``ovf``: a queue whose degree
    passes the table's width by more than 32 (the plain tick walks the hop
    list), and one whose degree is exactly the width (a full row that is
    not truncated)."""
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, n=n, device=cuda_device)
    _, n_ovf, degree = sup.k4_against_plain(
        tc, topo, sched, cfg, law, slots, (64,), maxdeg=maxdeg,
        overflows=overflows)
    if overflows:
        assert degree > maxdeg + 32, degree
    else:
        assert degree == maxdeg and n_ovf == 0, (degree, n_ovf)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_fused_tick_block_kernel_global_layout(cuda_device, law):
    """A pool whose staged working set does not fit in shared memory: the
    same kernel runs on its layout in a global scratch buffer, bit for bit
    against the plain tick."""
    import repro_torch.core as tc
    from repro_torch.kernels.fused_tick import layout
    slots = 2048
    assert not layout(slots, 1, 1, 0, 0, 1, int(law != "powertcp")).smem
    topo, sched, cfg = sup.staggered(tc, steps=1000, device=cuda_device)
    sup.k4_against_plain(tc, topo, sched, cfg, law, slots, (64, 7))


@pytest.mark.cuda
def test_fused_tick_block_kernel_single_slot(cuda_device):
    import repro_torch.core as tc
    sup.k4_against_plain(tc, *sup.single_slot(tc, device=cuda_device),
                         "powertcp", 1, (64,))


@pytest.mark.cuda
def test_megakernel_backend_launches_only_k4(cuda_device):
    """``simulate_slots(backend="megakernel")`` on the card runs K4 once per
    64-tick block (4 000 ticks: 62 blocks and a remainder) and no other
    kernel, with the plain tick's results on the CPU."""
    import repro_torch.core as tc
    from repro_torch.kernels import LAUNCHES, reset_launches
    out = []
    for dev in (cuda_device, "cpu"):
        topo, sched, cfg = sup.staggered(tc, device=dev)
        lcfg = tc.default_law_config(sched, expected_flows=8.0)
        reset_launches()
        st, rec = tc.simulate_slots(topo, sched, "powertcp", 6, lcfg, cfg,
                                    backend="megakernel", device=dev)
        out.append((st.fct.cpu(), rec.q.cpu(), dict(LAUNCHES)))
    (fg, qg, lg), (fc, qc, lc) = out
    assert lg == {"powertcp_step": 0, "theta_powertcp_step": 0,
                  "powertcp_observe_step": 0,
                  "theta_powertcp_observe_step": 0,
                  "queue_arrivals": 0, "fused_tick_block": 63, "rmsnorm": 0,
                  "rmsnorm_bwd": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0}
    assert sum(lc.values()) == 0
    torch.testing.assert_close(fg, fc, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(qg, qc, rtol=0, atol=0)


def _staggered_batch(tc, B, steps, device):
    """B seeds of the 12-flow anchor, stacked (``stack_flow_schedules``)."""
    scen = [sup.staggered(tc, steps=steps, seed=b, device=device)
            for b in range(B)]
    topo, cfg = scen[0][0], scen[0][2]
    return topo, tc.stack_flow_schedules([x[1] for x in scen],
                                         topo.num_queues), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_fused_tick_block_kernel_grid(cuda_device, B, gate, law):
    """K4's grid form, one block per scenario, against each scenario's
    plain block with the same ``gate``, K = 64 and a ragged K = 7."""
    import repro_torch.core as tc
    topo, sched, cfg = _staggered_batch(tc, B, 1500, cuda_device)
    sup.k4_grid_against_plain(tc, topo, sched, cfg, law, 6, (64, 7),
                              gate=gate)


K4_LAW_NAMES = ("powertcp", "theta_powertcp", "hpcc", "swift",
                "gradient_mimd", "timely", "dcqcn", "reno", "fncc", "pulser",
                "backpressure", "pcc")


@pytest.mark.cuda
@pytest.mark.parametrize("slots,blocks", [(16, (1, 64)), (6, (64, 7))])
@pytest.mark.parametrize("law", K4_LAW_NAMES)
def test_fused_tick_block_kernel_each_law(cuda_device, law, slots, blocks):
    """Each law's K4 routine against the plain tick, every carry leaf (its
    state included) bit for bit, S >= N and S < N."""
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, device=cuda_device)
    sup.k4_against_plain(tc, topo, sched, cfg, law, slots, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp", "swift",
                                 "gradient_mimd"])
def test_fused_tick_block_kernel_per_flow_gamma(cuda_device, law):
    """A per-flow gamma (``linspace(0.5, 0.95)`` over the schedule), read
    per slot through ``slot_flow`` with 1 - gamma, bit for bit against the
    plain tick."""
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, device=cuda_device)
    n = int(sched.start.shape[0])
    lcfg = tc.default_law_config(sched, expected_flows=8.0)._replace(
        gamma=torch.linspace(0.5, 0.95, n, device=cuda_device))
    sup.k4_against_plain(tc, topo, sched, cfg, law, 6, (64,), law_cfg=lcfg)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["hpcc", "dcqcn", "reno", "timely"])
def test_fused_tick_block_kernel_grid_per_scenario_config(cuda_device, law):
    """A batch whose ``hpcc_eta``, ``dcqcn_rai`` and DCQCN marking
    thresholds differ by scenario (``stack_law_configs``: the engines
    divide by the stacked eta and span, K4 too), K4's grid against the
    plain block of the batch."""
    import repro_torch.core as tc
    topo, sched, cfg = _staggered_batch(tc, 2, 1500, cuda_device)
    cfgs = [tc.default_law_config(type(sched)(*[x[b] for x in sched]),
                                  expected_flows=8.0, hpcc_eta=eta,
                                  dcqcn_rai=rai, dcqcn_kmin=kmin)
            for b, (eta, rai, kmin) in enumerate(((0.9, 40e6, 3e5),
                                                  (0.97, 80e6, 5e5)))]
    sup.k4_grid_against_plain(tc, topo, sched, cfg, law, 6, (64,),
                              law_cfg=tc.stack_law_configs(cfgs))


# the feedback-channel laws at the fat tree's shape: the first ticks of
# both legs of benchmarks/feedback_fct.py (quick), 5-hop paths
FEEDBACK_K4_STEPS = 1500


def _feedback_leg(tc, leg, device):
    return sup.feedback_scenario(tc, leg, quick=True,
                                 steps=FEEDBACK_K4_STEPS, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("leg", sup.FEEDBACK_LEGS)
@pytest.mark.parametrize("law", sup.FEEDBACK_LAWS)
def test_fused_tick_block_kernel_feedback_law_fat_tree(cuda_device, law, leg,
                                                       gate):
    """Each feedback law's K4 (the hop clock, the pause and sender-count
    columns of the ring) against the plain tick on the fat tree's 5-hop
    paths, every carry leaf bit for bit, ``gate`` True and False, K = 64
    and a ragged 7, a slot per flow and a pool of 10."""
    import repro_torch.core as tc
    topo, sched, cfg, slots, _ = _feedback_leg(tc, leg, cuda_device)
    sb = tc.stack_flow_schedules([sched], topo.num_queues)
    for S in (slots, 10):
        sup.k4_grid_against_plain(tc, topo, sb, cfg, law, S, (64, 7),
                                  gate=gate)


@pytest.mark.cuda
@pytest.mark.parametrize("law", sup.FEEDBACK_LAWS)
def test_fused_tick_block_kernel_feedback_grid_per_scenario_config(
        cuda_device, law):
    """Both fat-tree legs as one batch whose ``fncc_eta``, ``pulser_n``,
    ``bp_xoff`` / ``bp_xon`` and PCC's ``pcc_eps`` / ``pcc_b`` differ by
    scenario (``stack_law_configs``: K4 divides by the stacked eta), K4's
    grid against the plain block of the batch."""
    import repro_torch.core as tc
    legs = [_feedback_leg(tc, leg, cuda_device) for leg in sup.FEEDBACK_LEGS]
    topo, cfg = legs[0][0], legs[0][2]
    sb = tc.stack_flow_schedules([lg[1] for lg in legs], topo.num_queues)
    cfgs = [tc.default_law_config(type(sb)(*[x[b] for x in sb]),
                                  expected_flows=8.0, **kw)
            for b, kw in enumerate(sup.FEEDBACK_BATCH_SCALARS)]
    sup.k4_grid_against_plain(tc, topo, sb, cfg, law, int(sb.start.shape[-1]),
                              (64,), law_cfg=tc.stack_law_configs(cfgs))


@pytest.mark.cuda
def test_megakernel_feedback_law_without_k4_raises_on_cuda(cuda_device):
    """A feedback law whose update is not the registered one has no K4
    path: the megakernel backend raises on the card, falling back to
    nothing."""
    import repro_torch.core as tc
    topo, sched, cfg, _, _ = _feedback_leg(tc, "incast", cuda_device)
    law = tc.LAWS["backpressure"]
    other = law._replace(update=lambda *a: law.update(*a))
    with pytest.raises(NotImplementedError, match="no K4 path"):
        tc.simulate_slots(topo, sched, other, 16, cfg=cfg._replace(steps=64),
                          backend="megakernel", device=cuda_device)


@pytest.mark.cuda
def test_fused_tick_powf_is_torch_pow(cuda_device):
    """DCQCN's ``powf`` in K4's build equals ``torch.pow`` on the card over
    DCQCN's inputs, so its K4 routine is held bit for bit."""
    from repro_torch.kernels import fused_tick as ft
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.cat([torch.rand(1 << 16, generator=g) * 0.2 + 0.8,
                   torch.tensor([0.0, 1.0])]).to(cuda_device)
    y = torch.cat([1.0 + torch.rand(1 << 16, generator=g) * 1999.0,
                   torch.tensor([3.0, 3.0])]).to(cuda_device)
    torch.testing.assert_close(ft.powf(x, y), torch.pow(x, y), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H,Q", [(2, 128, 3, 289), (3, 257, 5, 129)])
def test_law_and_queue_kernels_take_a_batch(cuda_device, B, F, H, Q):
    """K1/K2 over a batch's flat rows and K3 with a scenario per grid
    plane: the plain versions' results, and each scenario the bits of a
    launch of its own."""
    parts = [_on(sup.law_inputs(F, H, seed=b), cuda_device)
             for b in range(B)]
    kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    got = powertcp_step(**kw)
    for i, w in enumerate(ref.powertcp_step_ref(**kw)):
        torch.testing.assert_close(got[i], w, rtol=0, atol=0)
        torch.testing.assert_close(got[i], torch.stack(
            [powertcp_step(**p)[i] for p in parts]), rtol=0, atol=0)
    parts = [_on(sup.theta_inputs(F, seed=b), cuda_device) for b in range(B)]
    kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    for g, w in zip(theta_powertcp_step(**kw),
                    ref.theta_powertcp_step_ref(**kw)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    parts = [_on(sup.queue_inputs(H, F, Q, seed=b), cuda_device)
             for b in range(B)]
    kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    for shared in (False, True):
        if shared:
            kw["out_rate"] = kw["caps"] = parts[0]["caps"]
        got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
        for b in range(B):
            one = dict(parts[b])
            if shared:
                one["out_rate"] = one["caps"] = parts[0]["caps"]
            for g, a in zip(got, queue_arrivals(**one, dt=sup.QUEUE_DT)):
                torch.testing.assert_close(g[b], a, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sequential", [False, True])
def test_batched_megakernel_launches(cuda_device, sequential):
    """``simulate_slots_batch(backend="megakernel")`` with B = 2 over
    40 000 ticks launches K4 625 times for the whole batch, or 1 250 times
    (625 per scenario) with ``sequential``, and nothing else; the FCTs are
    the plain tick's on the CPU."""
    import repro_torch.core as tc
    from repro_torch.kernels import LAUNCHES, reset_launches
    out = []
    for dev, steps in ((cuda_device, 40000), (cuda_device, 4000),
                       ("cpu", 4000)):
        topo, sched, cfg = _staggered_batch(tc, 2, steps, dev)
        reset_launches()
        st, _ = tc.simulate_slots_batch(topo, sched, "powertcp", 6, cfg=cfg,
                                        record=False, backend="megakernel",
                                        expected_flows=8.0,
                                        sequential=sequential, device=dev)
        out.append((st.fct.cpu(), dict(LAUNCHES)))
    assert out[0][1] == {"powertcp_step": 0, "theta_powertcp_step": 0,
                         "powertcp_observe_step": 0,
                         "theta_powertcp_observe_step": 0,
                         "queue_arrivals": 0,
                         "fused_tick_block": 1250 if sequential else 625,
                         "rmsnorm": 0, "rmsnorm_bwd": 0,
                         "flash_attention": 0, "flash_attention_bwd": 0}
    assert sum(out[2][1].values()) == 0
    torch.testing.assert_close(out[1][0], out[2][0], rtol=0, atol=0,
                               equal_nan=True)


# K1/K2's observe form: S = 384 slots over the paper's 2 406 flows, P =
# 2 406 padded flows, B = 2 x 128 slots over 2 436 (phase 6b's batch),
# and a ragged padded batch with 5-hop paths
OBSERVE_SHAPES = [("slot", 1, 384, 3, 2406), ("padded", 1, 2406, 3, None),
                  ("slot", 2, 128, 3, 2436), ("padded", 2, 257, 5, None)]


def _observe_plain(law):
    from repro_torch.core import backends
    return (backends.powertcp_observe_step_plain if law == "powertcp"
            else backends.theta_powertcp_observe_step_plain)


def _observe_key(law):
    return ("powertcp_observe_step" if law == "powertcp"
            else "theta_powertcp_observe_step")


@pytest.mark.cuda
@pytest.mark.parametrize("period", [2e-6, 0.0])
@pytest.mark.parametrize("engine,B,F,H,N", OBSERVE_SHAPES)
@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_observe_step_kernel(cuda_device, law, engine, B, F, H, N, period):
    """The fused law's observe-and-update routine on CUDA tensors launches
    its observe kernel once and equals the plain version on the same
    tensors bit for bit, every output."""
    import repro_torch.core as tc
    from repro_torch.kernels import LAUNCHES, reset_launches
    inp = sup.observe_inputs(engine, B, F, H=H, N=N, update_period=period,
                             seed=F + H)
    law_b, static, cfg, x = sup.observe_tick(tc, inp, law, cuda_device)
    reset_launches()
    state, w, rate_cap, nu, lu = tc.observe_step(law_b)(law_b, static, cfg,
                                                        x)
    got = tuple(state) + (w, rate_cap, nu, lu)
    assert LAUNCHES[_observe_key(law)] == 1
    assert sum(LAUNCHES.values()) == 1
    state, w, rate_cap, nu, lu = _observe_plain(law)(law_b, static, cfg, x)
    for g, e in zip(got, tuple(state) + (w, rate_cap, nu, lu)):
        torch.testing.assert_close(g, e, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["padded", "slot"])
@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_fused_runs_launch_one_observe_kernel_a_tick(cuda_device, law,
                                                     engine):
    """A fused run on the card launches its law's observe kernel and K3
    once a tick and nothing else (no old-form K1/K2), and completes the
    flows the same run completes on the CPU, at the same FCTs within the
    fused backend's rtol 1e-5 (K3 sums in its own order)."""
    import repro_torch.core as tc
    from repro_torch.kernels import LAUNCHES, reset_launches
    steps, out = 4000, []
    for dev in (cuda_device, "cpu"):
        topo, sched, cfg = sup.staggered(tc, steps=steps, device=dev)
        reset_launches()
        if engine == "padded":
            flows = tc.schedule_as_flows(sched)
            st, _ = tc.simulate(
                topo, flows, law,
                tc.default_law_config(flows, expected_flows=8.0), cfg,
                record=False, backend="fused", device=dev)
        else:
            st, _ = tc.simulate_slots(
                topo, sched, law, 6,
                tc.default_law_config(sched, expected_flows=8.0), cfg,
                record=False, backend="fused", device=dev)
        out.append((st.fct.cpu().numpy(), dict(LAUNCHES)))
    want = {k: 0 for k in out[0][1]}
    want[_observe_key(law)] = want["queue_arrivals"] = steps
    assert out[0][1] == want
    assert sum(out[1][1].values()) == 0
    (fg, _), (fc, _) = out
    assert np.isfinite(fc).sum() > 0
    np.testing.assert_array_equal(np.isfinite(fg), np.isfinite(fc))
    np.testing.assert_allclose(fg, fc, rtol=1e-5)


@pytest.mark.cuda
def test_megakernel_law_without_k4_raises_on_cuda(cuda_device):
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, steps=64, device=cuda_device)
    other = tc.Law("my_law", tc.LAWS["powertcp"].init,
                   tc.LAWS["powertcp"].update)
    with pytest.raises(NotImplementedError, match="no K4 path"):
        tc.simulate_slots(topo, sched, other, 6, backend="megakernel",
                          device=cuda_device)


# -------------------------------------------------------------------------
# time-varying bandwidth (Fig. 8): K4's circuit schedule and reTCP, K1-K3
# with a bandwidth per scenario
# -------------------------------------------------------------------------

def _fig8_grid(tc, law, pb, device, steps):
    """Fig. 8's first ``steps`` ticks as the megakernel runs one law
    group: slots 0 and 6 stacked, (topo, schedules, cfg, law config,
    bw_params)."""
    topo, flows, cfg, scheds = sup.fig8_scenario(tc, device=device)
    sch = tc.make_schedule(flows)
    _, lcfg, bwp = sup.fig8_group(tc, law, (pb,), sch, scheds,
                                  device=device)
    sb = tc.stack_flow_schedules([sch] * 2, topo.num_queues)
    return topo, sb, cfg._replace(steps=steps), lcfg, bwp


FIG8_K4_CASES = [("powertcp", None, True), ("theta_powertcp", None, True),
                 ("hpcc", None, True), ("retcp", 1800e-6, True),
                 ("retcp", 600e-6, True), ("powertcp", None, False),
                 ("retcp", 600e-6, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("law,pb,gate", FIG8_K4_CASES)
def test_fused_tick_block_kernel_circuit_schedule(cuda_device, law, pb,
                                                  gate):
    """K4 evaluating two different circuit schedules (slots 0 and 6) in
    its body, a block each, with reTCP's own schedule and prebuffer, over
    Fig. 8's first 2 000 ticks (both schedules' first edges): every carry
    leaf bit for bit the plain block of the batch, K = 64 and a ragged
    K = 7."""
    import repro_torch.core as tc
    topo, sb, cfg, lcfg, bwp = _fig8_grid(tc, law, pb, cuda_device, 2000)
    sup.k4_grid_against_plain(tc, topo, sb, cfg, law, 8, (64, 7), gate=gate,
                              law_cfg=lcfg, bw_fn=tc.circuit_bw_at,
                              bw_params=bwp)


@pytest.mark.cuda
def test_fused_tick_block_kernel_shared_schedule(cuda_device):
    """One scenario with ``CircuitSchedule(slot=6).bw_fn()`` as its
    bandwidth and reTCP reading slot 0's schedule (the two need not be
    the same), against the plain tick."""
    import repro_torch.core as tc
    topo, flows, cfg, scheds = sup.fig8_scenario(tc, device=cuda_device)
    sch = tc.make_schedule(flows)
    lcfg = tc.default_law_config(sch, expected_flows=32.0,
                                 sched=scheds[0].params(cuda_device),
                                 retcp_prebuffer=600e-6)
    sup.k4_against_plain(tc, topo, sch, cfg._replace(steps=2000), "retcp",
                         8, (64,), law_cfg=lcfg,
                         bw_fn=scheds[1].bw_fn(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("slot", [0, 6, 11, 23])
def test_fused_tick_schedule_is_circuit_bw_at(cuda_device, slot):
    """K4's schedule evaluation (``fused_tick.schedule``, compiled with
    K4's flags) over every tick of Fig. 8's 4 weeks: the VOQ's rate equal
    to ``circuit_bw_at``'s on the card, and reTCP's scaling flag to
    ``circuit_up(t + prebuffer) | circuit_up(t)``, for each prebuffer."""
    import repro_torch.core as tc
    from repro_torch.core import rdcn
    from repro_torch.kernels import fused_tick as ft
    _, _, cfg, _ = sup.fig8_scenario(tc, device=cuda_device)
    T = cfg.steps
    sc = tc.CircuitSchedule(slot=slot)
    p = sc.params(cuda_device)
    t = torch.arange(T, dtype=torch.int32, device=cuda_device).to(
        torch.float32) * np.float32(cfg.dt)
    for pb in (0.0, 600e-6, 1800e-6):
        sched = torch.stack(list(p))[None].contiguous()
        bw, on = ft.schedule(sched, 0, T, cfg.dt, torch.full(
            (1,), pb, dtype=torch.float32, device=cuda_device))
        torch.testing.assert_close(bw[0], tc.circuit_bw_at(t, p)[:, 0],
                                   rtol=0, atol=0)
        want = (tc.circuit_up(rdcn._plus_prebuffer(t, pb), p)
                | tc.circuit_up(t, p))
        assert torch.equal(on[0].bool(), want)


@pytest.mark.cuda
def test_fused_tick_impair_is_core_impair(cuda_device):
    """K4's evaluation of an impairment regime alone
    (``fused_tick.impair``, compiled with K4's flags) over 3 000 ticks:
    each queue's rate, survival fraction and jitter bit for bit
    ``core/impair.py``'s on the card, for the fat tree's four regimes
    stacked (one per scenario) and for one shared regime."""
    import repro_torch.core as tc
    from repro_torch.core import impair as ti, megakernel as mk
    from repro_torch.kernels import fused_tick as ft
    regs = sup.impair_regimes(tc, tc.fat_tree(4), device=cuda_device)
    T = 3000
    t = (torch.arange(T, device=cuda_device).to(torch.float32)
         * 1e-6)[:, None]
    four = tc.stack_impairments(list(regs.values()))
    for reg, B in ((four, 4), (regs["mixed"], 1)):
        Q = int(reg.kind.shape[-1])
        gb, gk, gj = ft.impair(mk._k4_impair(reg, B, Q, cuda_device), 0, T,
                               1e-6)
        for b in range(B):
            p = ti.ImpairmentParams(*[x[b] for x in reg]) if B > 1 else reg
            keep, jit = ti.impair_vectors(t, p)
            assert torch.equal(gb[b], ti.link_bw_at(t, p))
            assert torch.equal(gk[b], keep[:, :Q])
            assert torch.equal(gj[b], jit[:, :Q])


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("law", ["powertcp", "fncc", "backpressure",
                                 "pulser"])
def test_fused_tick_block_kernel_impaired(cuda_device, law, gate):
    """One law per feedback channel (receiver echo, the hop clock, the
    pause and the sender-count columns) on the fat tree under the mixed
    regime, K4 against the plain tick over 1 000 ticks, every carry leaf
    and record bit for bit: a batch of two regimes (one per scenario, K =
    64 and a ragged 7) and one regime shared by the batch."""
    import repro_torch.core as tc
    topo, sched, cfg, S, regs = sup.impair_anchor_scenario(
        tc, steps=1000, device=cuda_device)
    sb = tc.stack_flow_schedules([sched] * 2, topo.num_queues)
    for reg in (tc.stack_impairments([regs["mixed"], regs["oscillate"]]),
                regs["lossy"]):
        sup.k4_grid_against_plain(tc, topo, sb, cfg, law, S, (64, 7),
                                  gate=gate, impair=reg)


# -------------------------------------------------------------------------
# K4 on a chunk window: chunk-streamed runs, resume, sweeps
# -------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("law", ["powertcp", "fncc"])
def test_fused_tick_block_kernel_on_a_chunk_window(cuda_device, law):
    """K4 reading a chunk window (``win_off > 0``, C < N: the schedule
    rows at ``f - win_off``, the law config at ``f``) against the plain
    block on the same window, gate True and False, every carry leaf and
    record bit for bit: the 18-flow bottleneck from tick 600, a window of
    8 rows."""
    import repro_torch.core as tc
    topo, sched, cfg = sup.bottleneck18(tc, device=cuda_device)
    w0, C, N, _ = sup.k4_window_against_plain(tc, topo, sched, cfg, law, 8,
                                              8, 600, 300)
    assert w0 > 0 and C < N


def _chunk_k4(tc, chunk, dev, **kw):
    topo, sched, cfg = sup.bottleneck18(tc, steps=1500, device=dev)
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)
    return tc.simulate_slots(topo, sched, "powertcp", 8, lcfg, cfg,
                             backend="megakernel", chunk=chunk, device=dev,
                             **kw)


@pytest.mark.cuda
def test_chunked_k4_is_unchunked_k4(cuda_device):
    """Over ``CHUNK_GRID`` the chunk-streamed megakernel run (K4 on every
    segment) is bit for bit the unchunked K4 run, and K4 launched on every
    segment."""
    import repro_torch.core as tc
    from repro_torch import kernels
    from repro_torch.core import fluid
    want = _chunk_k4(tc, None, cuda_device)
    for chunk in sup.CHUNK_GRID:
        kernels.reset_launches()
        got = _chunk_k4(tc, chunk, cuda_device)
        bad = sup.resume_mismatches(got[0], got[1], want[0], want[1])
        assert not bad, (chunk, bad)
        assert kernels.LAUNCHES["fused_tick_block"] >= \
            fluid.LAST_CHUNKED["segments"]


@pytest.mark.cuda
def test_k4_resume_is_bit_for_bit(cuda_device, tmp_path):
    """Inject -> crash -> resume on K4: the resumed run (from tick 600)
    is bit for bit the uninterrupted one."""
    import repro_torch.core as tc
    ck = tc.CheckpointSpec(path=str(tmp_path), every=300, keep=2)
    want = _chunk_k4(tc, 8, cuda_device)
    with pytest.raises(tc.InjectedCrash):
        _chunk_k4(tc, 8, cuda_device, checkpoint=ck,
                  faults=tc.crash_at_tick(700))
    assert tc.latest_checkpoint(str(tmp_path)) == 600
    topo, sched, cfg = sup.bottleneck18(tc, steps=1500, device=cuda_device)
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)
    got = tc.resume_slots(topo, sched, "powertcp", 8, ck, law_cfg=lcfg,
                          cfg=cfg, backend="megakernel", chunk=8,
                          device=cuda_device)
    assert not sup.resume_mismatches(got[0], got[1], want[0], want[1])


@pytest.mark.cuda
def test_k4_sweep_is_fault_tolerant_without_fallback(cuda_device):
    """``run_sweep(backend="megakernel", fault_tolerant=True)`` on the
    fat tree's anchor under two regimes: no fallback, no failure, and each
    point bit for bit its own K4 run."""
    import repro_torch.core as tc
    topo, sched, cfg, S, regs = sup.impair_anchor_scenario(
        tc, steps=2000, device=cuda_device)
    fl = tc.schedule_as_flows(sched)
    names = ("mixed", "clean")
    spec = tc.SweepSpec(laws=("powertcp", "hpcc"), flows=[fl],
                        impairments=[regs[n] for n in names],
                        expected_flows=8.0, slots=S, backend="megakernel")
    res = tc.run_sweep(spec, topo, cfg, record=False, fault_tolerant=True,
                       device=cuda_device)
    assert res.fallbacks == () and res.failures == ()
    for p in res.points:
        st, _ = tc.simulate_slots(
            topo, sched, p.law, S,
            tc.default_law_config(sched, expected_flows=8.0), cfg,
            record=False, backend="megakernel",
            impair=regs[names[p.impair_idx]], device=cuda_device)
        torch.testing.assert_close(res.state(p.index).fct, st.fct, rtol=0,
                                   atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["powertcp", "theta_powertcp"])
def test_observe_and_queue_kernels_take_a_bandwidth_per_scenario(
        cuda_device, law):
    """K1/K2's observe form and K3 with a [B, Q+1] bandwidth: rows that
    differ by scenario against the plain version bit for bit (K3 at its
    tolerance), and rows equal to the shared [Q+1] vector bit for bit the
    shared call (stride 0)."""
    import repro_torch.core as tc
    from repro_torch.core import fluid
    inp = sup.observe_inputs("slot", 2, 128, N=2436, seed=5)
    law_b, static, cfg, x = sup.observe_tick(tc, inp, law, cuda_device)
    fn, plain = tc.observe_step(law_b), _observe_plain(law)
    shared = x.bw
    rows = torch.stack([shared, torch.cat([shared[:-1] * 4.0,
                                           shared[-1:]])])
    for bw in (rows, shared.expand(2, -1).contiguous()):
        xb = x._replace(bw=bw, b_hop=fluid._hop_bw(bw, x.path))
        got = sup.tree_leaves(fn(law_b, static, cfg, xb))
        for (_, g), (_, w) in zip(got, sup.tree_leaves(
                plain(law_b, static, cfg, xb))):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    for (_, g), (_, w) in zip(got, sup.tree_leaves(
            fn(law_b, static, cfg, x._replace(bw=shared)))):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    q = _on(sup.queue_inputs(3, 128, 289, seed=2), cuda_device)
    kw = {k: torch.stack([v, v]) for k, v in q.items()}
    kw["caps"] = q["caps"]
    for out_rate in (torch.stack([q["out_rate"], q["out_rate"] * 4.0]),
                     torch.stack([q["out_rate"]] * 2)):
        got = queue_arrivals(**dict(kw, out_rate=out_rate),
                             dt=sup.QUEUE_DT)
        want = ref.queue_arrivals_ref(**dict(kw, out_rate=out_rate),
                                      dt=sup.QUEUE_DT)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
    same = queue_arrivals(**dict(kw, out_rate=q["out_rate"]),
                          dt=sup.QUEUE_DT)
    for g, w in zip(got, same):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -------------------------------------------------------------------------
# K5 flash_attention, K6 rmsnorm and the LM slice
# -------------------------------------------------------------------------

# B, H, KV, T, S, D, causal, window, bf16: tests/test_kernels.py's
# FLASH_CASES, the serve run's prefill and decode shapes, decode (T <= 4,
# the split form) with a window, without causal, at D = 256, and the
# REDUCED model's head dim 16
FLASH_SHAPES = [
    (2, 4, 2, 128, 128, 64, True, 0, False),
    (1, 4, 4, 100, 100, 64, True, 0, False),
    (2, 2, 1, 64, 256, 32, True, 0, False),
    (1, 4, 2, 128, 128, 64, True, 48, False),
    (1, 2, 2, 96, 160, 128, False, 0, False),
    (1, 2, 2, 128, 128, 64, True, 0, True),
    (1, 1, 1, 8, 8, 256, True, 0, False),
    (1, 2, 1, 33, 77, 64, True, 16, True),
    (4, 40, 8, 512, 512, 128, True, 0, True),      # serve prefill
    (4, 40, 8, 1, 513, 128, True, 0, True),        # serve decode, first
    (4, 40, 8, 1, 543, 128, True, 0, True),        # serve decode, last
    (2, 4, 2, 1, 300, 128, True, 64, False),
    (2, 4, 2, 3, 77, 256, False, 0, True),
    (1, 2, 1, 4, 4, 32, True, 0, False),
    (4, 4, 2, 24, 24, 16, True, 0, True),          # REDUCED qwen3-14b
    (4, 4, 2, 1, 31, 16, True, 0, True),
    (2, 32, 32, 128, 128, 80, True, 0, True),      # stablelm-3b, D = 80
    (2, 32, 32, 1, 97, 80, True, 0, True),
    (1, 4, 2, 3, 70, 80, True, 16, True),
    (1, 4, 4, 70, 70, 80, True, 0, False),
    (1, 2, 2, 2, 33, 80, False, 0, False),
    (2, 32, 32, 128, 128, 96, True, 0, True),      # phi3-vision, D = 96
    (2, 32, 32, 1, 97, 96, True, 0, True),
    (1, 4, 2, 70, 70, 96, True, 0, False),
    (1, 4, 2, 65, 129, 96, False, 0, True),
    (1, 20, 20, 1500, 1500, 64, False, 0, True),   # whisper's encoder
    (4, 20, 20, 1, 1500, 64, False, 0, True),      # ... its cross decode
    (2, 20, 20, 100, 1500, 64, False, 0, True),    # ... its cross prefill
] + sup.FLASH_EDGE_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,S,D,causal,window,bf16", FLASH_SHAPES)
def test_flash_attention_kernel(cuda_device, B, H, KV, T, S, D, causal,
                                window, bf16):
    from repro_torch.kernels import flash_attention
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(dt)
               for a in sup.flash_inputs(B, H, KV, T, S, D, seed=T + S))
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and tuple(got.shape) == (B, H, T, D)
    tol = 2e-2 if bf16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_a_strided_cache(cuda_device):
    """The model's decode: q a [B,H,1,D] view of [B,1,H,D], k/v the first
    index+1 positions of a [B,S,KV,D] cache seen as [B,KV,S,D]; against
    the plain version on contiguous copies, bit for bit with the kernel
    on those copies."""
    from repro_torch.kernels import flash_attention
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cache = torch.randn(4, 544, 8, 128, generator=g, device=cuda_device,
                        dtype=torch.float32).to(torch.bfloat16)
    q = torch.randn(4, 1, 40, 128, generator=g, device=cuda_device,
                    dtype=torch.float32).to(torch.bfloat16)
    qv, kv = q.permute(0, 2, 1, 3), cache[:, :520].permute(0, 2, 1, 3)
    got = flash_attention(qv, kv, kv)
    same = flash_attention(qv.contiguous(), kv.contiguous(), kv.contiguous())
    torch.testing.assert_close(got, same, rtol=0, atol=0)
    want = ref.flash_attention_ref(qv.contiguous(), kv.contiguous(),
                                   kv.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert got.permute(0, 2, 1, 3).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,S,D", [(4, 40, 8, 512, 512, 128),
                                          (4, 40, 8, 1, 543, 128),
                                          (1, 10, 2, 4, 130, 128),
                                          (1, 2, 1, 129, 129, 256)])
def test_flash_attention_kernel_is_the_same_run_to_run(cuda_device, B, H,
                                                       KV, T, S, D):
    from repro_torch.kernels import flash_attention
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(torch.bfloat16)
               for a in sup.flash_inputs(B, H, KV, T, S, D, seed=3))
    first = flash_attention(q, k, v)
    for _ in range(3):
        torch.testing.assert_close(flash_attention(q, k, v), first, rtol=0,
                                   atol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_raises_on_a_misaligned_view(cuda_device):
    """bfloat16 K5 stages q, k and v with 16-byte cp.async copies: a base
    that is not 16-byte aligned or a stride that is not a multiple of 8
    elements is refused, not read some other way."""
    from repro_torch.kernels import flash_attention
    bf = torch.bfloat16
    q = torch.zeros(1, 2, 8, 64, dtype=bf, device=cuda_device)
    k = torch.zeros(1, 1, 8, 64, dtype=bf, device=cuda_device)
    shifted = torch.zeros(2 * 8 * 64 + 1, dtype=bf,
                          device=cuda_device)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, k, k)
    wide = torch.zeros(1, 1, 8, 68, dtype=bf, device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(q, wide, wide)
    flash_attention(q, k, k)        # the aligned views go through


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(4 * 512, 5120), (4, 5120),
                                 (4 * 512 * 40, 128), (4 * 512 * 8, 128),
                                 (4 * 40, 128), (7, 64), (513, 128)])
@pytest.mark.parametrize("bf16", [True, False])
def test_rmsnorm_kernel(cuda_device, N, D, bf16):
    from repro_torch.kernels import rmsnorm
    x, s = (torch.as_tensor(a, device=cuda_device)
            for a in sup.rmsnorm_inputs(N, D, seed=N + D))
    if bf16:
        x = x.to(torch.bfloat16)
    got = rmsnorm(x, s, eps=1e-6)
    want = ref.rmsnorm_ref(x, s, eps=1e-6)
    assert got.dtype == x.dtype and got.shape == x.shape
    if bf16:
        assert sup.bf16_ulps(got, want) <= 1.0
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(4 * 512, 5120), (4, 5120),
                                 (4 * 512 * 40, 128), (4 * 512 * 8, 128),
                                 (4 * 40, 128), (9, 64), (33, 200),
                                 (5, 5121)])
@pytest.mark.parametrize("bf16", [True, False])
def test_rmsnorm_kernel_is_its_order_run_to_run(cuda_device, N, D, bf16):
    """K6 twice on the same inputs gives the same bits, and those of its
    sum order spelled in torch (elementwise float32 ops on the card), at
    the serve run's rows and at ragged D (one element at a time)."""
    from repro_torch.kernels import rmsnorm
    x, s = (torch.as_tensor(a, device=cuda_device)
            for a in sup.rmsnorm_inputs(N, D, seed=N * D))
    if bf16:
        x = x.to(torch.bfloat16)
    first = rmsnorm(x, s, eps=1e-6)
    torch.testing.assert_close(rmsnorm(x, s, eps=1e-6), first, rtol=0,
                               atol=0)
    torch.testing.assert_close(first, sup.rmsnorm_in_k6_order(x, s, 1e-6),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_rmsnorm_kernel_reads_a_misaligned_view(cuda_device):
    """A row base off the 16-byte grid takes the element-at-a-time loads
    and gives the same bits as the aligned copy."""
    from repro_torch.kernels import rmsnorm
    x, s = (torch.as_tensor(a, device=cuda_device)
            for a in sup.rmsnorm_inputs(4, 5120, seed=2))
    x = x.to(torch.bfloat16)
    flat = torch.zeros(4 * 5120 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(4, 5120)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    torch.testing.assert_close(rmsnorm(shifted, s), rmsnorm(x, s), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu(cuda_device):
    """REDUCED qwen3-14b, params from a seeded generator: prefill + 8
    teacher-forced decode steps on the card against the port on the CPU
    at the tight bar, with K5 once and K6 4L + 1 times per forward."""
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = configs.reduced_config("qwen3-14b")
    params = models.init_params(models.lm_specs(cfg),
                                torch.Generator().manual_seed(0), "cpu")
    gpu = models.params_from_numpy(_to_numpy(params), cuda_device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 24)))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 8)))
    want = sup.lm_teacher_forced(params, cfg, prompt, toks, 40)
    reset_launches()
    got = sup.lm_teacher_forced(gpu, cfg, prompt.to(cuda_device),
                                toks.to(cuda_device), 40)
    L = cfg.num_layers
    assert LAUNCHES["flash_attention"] == 9 * L
    assert LAUNCHES["rmsnorm"] == 9 * (4 * L + 1)
    for (what, g), (_, w) in zip(got, want):
        d = (g.float() - w.float()).abs()
        assert float(d.max()) <= sup.LM_TIGHT_MAX, what
        assert float(d.mean()) <= sup.LM_TIGHT_MEAN, what


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_405b", "gemma_7b", "stablelm_3b",
                                  "qwen3_moe_30b_a3b",
                                  "granite_moe_3b_a800m"])
def test_reduced_archs_on_card_match_cpu(cuda_device, arch):
    """Each REDUCED architecture, float32 compute, numpy params: prefill +
    4 teacher-forced decode steps on the card against the port on the
    CPU (relative to the largest value, 1e-4), with K5 once a layer a
    forward and K6 for the rmsnorm norms and the qk-norm (none for
    stablelm's layernorm)."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              compute_dtype="float32")
    tree = sup.numpy_params(models.lm_specs(cfg), 1)
    rng = np.random.default_rng(1)
    tv = cfg.true_vocab or cfg.vocab_size
    prompt = torch.as_tensor(rng.integers(0, tv, (2, 20)))
    toks = torch.as_tensor(rng.integers(0, tv, (2, 4)))
    want = sup.lm_teacher_forced(models.params_from_numpy(tree, "cpu"), cfg,
                                 prompt, toks, 32)
    reset_launches()
    got = sup.lm_teacher_forced(models.params_from_numpy(tree, cuda_device),
                                cfg, prompt.to(cuda_device),
                                toks.to(cuda_device), 32)
    L = cfg.num_layers
    norms = (2 * L + 1 if cfg.norm == "rmsnorm" else 0) + (
        2 * L if cfg.qk_norm else 0)
    assert LAUNCHES["flash_attention"] == 5 * L
    assert LAUNCHES["rmsnorm"] == 5 * norms
    for (what, g), (_, w) in zip(got, want):
        assert sup.rel_err(g, w) <= 1e-4, what


@pytest.mark.cuda
def test_moe_combine_and_backward_are_the_same_run_to_run(cuda_device):
    """The REDUCED qwen3-moe's MoE layer on the card (bfloat16, k = 8 of
    16 experts, the capacity cut so that picks are dropped): its output
    and the gradients of its input and weights bit for bit across three
    runs (the combine and the token gather's backward add each token's k
    rows in sort order, no atomics), and the combine against the port on
    the CPU bit for bit given the same expert outputs."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(configs.reduced_config("qwen3_moe_30b_a3b"),
                              num_experts=16, experts_per_token=8,
                              moe_capacity=0.5)
    tree = sup.numpy_params(L.moe_specs(cfg), 2)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32))
    w = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32))
    runs = []
    for _ in range(3):
        p = models.params_from_numpy(tree, cuda_device)
        for t in p.values():
            t.requires_grad_(True)
        xi = x.to(cuda_device, torch.bfloat16).requires_grad_(True)
        y = L.moe_apply(p, xi, cfg)
        (y.float() * w.to(cuda_device)).sum().backward()
        runs.append([y.detach(), xi.grad] + [p[k].grad for k in sorted(p)])
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)
    xf = x.reshape(-1, cfg.d_model).to(torch.bfloat16)
    n, E, k = xf.shape[0], cfg.num_experts, cfg.experts_per_token
    C = L.moe_capacity(cfg, n)
    eid = torch.as_tensor(np.argsort(np.random.default_rng(5).random(
        (n, E)), axis=-1)[:, :k].copy())
    gate = torch.rand(n, k, generator=torch.Generator().manual_seed(6))
    out = {}
    for dev in ("cpu", cuda_device):
        _, _, keep, dest, sg, rank = L._moe_dispatch(
            xf.to(dev), eid.to(dev), gate.to(dev), E, k, C, torch.bfloat16)
        y = torch.arange(E * C * cfg.d_model, dtype=torch.float32).reshape(
            E * C, cfg.d_model).remainder(97).mul(0.013).to(torch.bfloat16)
        out[str(dev)] = L._moe_combine(y.to(dev), keep, dest, sg, rank,
                                       torch.bfloat16).cpu()
        assert not bool(keep.all())
    assert torch.equal(out[str(cuda_device)], out["cpu"])


# the sharded engine's card checks: the paper leaf-spine's impaired pass
# (52 flows, 56 slots), its first SHARD_TICKS ticks
SHARD_TICKS = 600
SHARD_STATE = ("w", "rate_cap", "q", "out_rate", "remaining", "next_update",
               "last_update", "hist_lam", "hist_q", "hist_out", "hist_w",
               "law", "cursor", "fct", "pause", "hist_pause", "hist_inc")


def _shard_run(device, group=None, law="powertcp"):
    import repro_torch.core as tc
    topo, sched, cfg, S, imp = sup.impair_paper_scenario(tc, device=device)
    cfg = cfg._replace(steps=SHARD_TICKS)
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)
    if group is False:
        return tc.simulate_slots(topo, sched, law, S, lcfg, cfg,
                                 backend="megakernel", impair=imp,
                                 device=device)
    return tc.simulate_slots_sharded(topo, sched, law, S, lcfg, cfg,
                                     impair=imp, group=group, device=device)


def _same_shard_run(got, want):
    for f in SHARD_STATE:
        for (n, g), (_, w) in zip(sup.tree_leaves(getattr(got[0], f), f),
                                  sup.tree_leaves(getattr(want[0], f), f)):
            torch.testing.assert_close(g, w.to(g.device), rtol=0, atol=0,
                                       equal_nan=True, msg=n)
    for f in got[1]._fields:
        g, w = getattr(got[1], f), getattr(want[1], f)
        torch.testing.assert_close(g, w.to(g.device, g.dtype), rtol=0,
                                   atol=0, equal_nan=True, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["powertcp", "backpressure", "pulser"])
def test_sharded_one_rank_nccl_against_k4(cuda_device, law):
    """World 1 over NCCL (the one-rank default group): every trajectory
    leaf and record field K4's, one law per feedback channel."""
    from repro_torch.core import shardcomm
    group = shardcomm.current_group(cuda_device)
    assert group.world == 1
    _same_shard_run(_shard_run(cuda_device, group, law),
                    _shard_run(cuda_device, False, law))


def _card_rank(group):
    from repro_torch.core.types import tree_map
    st, rec = _shard_run(group.device, group)
    return tree_map(lambda x: x.cpu(), st), tree_map(lambda x: x.cpu(), rec)


@pytest.mark.cuda
def test_sharded_two_gloo_ranks_on_the_card(cuda_device):
    """Two gloo ranks on the one card (host-staged collectives): bit for
    bit the one-rank run and K4."""
    from repro_torch.core import shardcomm
    got = shardcomm.spawn(_card_rank, 2, backend="gloo", device=cuda_device)
    _same_shard_run(got, _shard_run(cuda_device,
                                    shardcomm.current_group(cuda_device)))
    _same_shard_run(got, _shard_run(cuda_device, False))


@pytest.mark.cuda
@pytest.mark.parametrize("oc", [1, 3])
def test_homa_allocator_on_card_is_its_cpu_result(cuda_device, oc):
    """HOMA's allocator on CUDA tensors bit for bit its CPU result: ties,
    inf and NaN keys, +0.0 and -0.0, inactive flows, many receivers, a
    [B, F] batch of receivers."""
    import repro_torch.core as tc
    rng = np.random.default_rng(oc)
    B, F = 3, 700
    recv = rng.integers(0, 9, (B, F))
    rem = rng.choice(np.float32([0.0, -0.0, 5e4, 1e5, np.inf, np.nan]),
                     (B, F))
    rem[:, ::3] = rng.uniform(1e3, 1e6, (B, F))[:, ::3]
    active = rng.random((B, F)) < 0.8
    tau = rng.uniform(5e-6, 3e-5, (B, F)).astype(np.float32)
    start = rng.uniform(0.0, 2e-4, (B, F)).astype(np.float32)
    nic = rng.choice(np.float32([3.125e9, 1.25e10]), (B, F))
    t_sec = float(np.float32(1e-4))

    class Nic:
        pass

    out = []
    for dev in ("cpu", cuda_device):
        on = {k: torch.as_tensor(v, device=dev) for k, v in
              dict(rem=rem, active=active, tau=tau, start=start,
                   nic=nic).items()}
        fl = Nic()
        fl.nic_rate = on["nic"]
        alloc = tc.homa_alloc_fn(recv, 25e9 / 8, oc, on["tau"], on["start"])
        out.append(alloc(on["rem"], on["active"], t_sec, fl, None).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_fig4_incast_k4_against_plain(cuda_device):
    """Fig. 4's 10:1 and 63:1 incasts (the long-lived flow admitted at
    tick 0 with ``start = -1``, ``size = inf``) as one K4 grid of two
    blocks, bit for bit the plain tick over 640 ticks."""
    import repro_torch.core as tc
    _, topo, flows, _, cfg = sup.fig4_scenario(tc, steps=640,
                                               device=cuda_device)
    sb = tc.stack_flow_schedules([tc.make_schedule(f) for f in flows],
                                 topo.num_queues)
    for law in ("powertcp", "hpcc"):
        sup.k4_grid_against_plain(tc, topo, sb, cfg, law,
                                  int(sb.start.shape[-1]), (1, 64),
                                  expected_flows=sup.FIG4_EXPECTED_FLOWS)


@pytest.mark.cuda
def test_homa_padded_on_card_matches_golden(cuda_device):
    """HOMA on Fig. 4's 10:1 incast through the padded reference engine
    on the card: the golden's FCTs and victim queue trace (``repro``'s
    CPU run) over its 2 000 ticks."""
    import base64
    import json
    import repro_torch.core as tc
    fab, topo, flows, bq, cfg = sup.fig4_scenario(
        tc, steps=sup.HOMA_FIG4_STEPS, device=cuda_device)
    fl, alloc, lcfg = sup.homa_run_args(tc, fab, flows[0], pad_to=64,
                                        expected_flows=16.0)
    st, rec = tc.simulate(topo, fl, "reno", lcfg, cfg, alloc_fn=alloc,
                          device=cuda_device)
    with open(sup.FIG4_REF) as f:
        ref = json.load(f)["homa"]["fig4_10"]
    want = np.array([np.nan if x is None else x for x in ref["fct_s"]],
                    np.float32)
    np.testing.assert_array_equal(st.fct.cpu().numpy(), want)
    np.testing.assert_allclose(
        rec.q[:, bq].cpu().numpy(),
        np.frombuffer(base64.b64decode(ref["q"]), np.float32),
        rtol=1e-5, atol=0.5)


@pytest.mark.cuda
def test_outer_sync_nccl_world_one(cuda_device):
    """The outer sync over a one-rank NCCL group on the card: bit for bit
    the one-process spelling, at most ``window`` gathers in flight."""
    from repro_torch.commsched import make_outer_sync
    from repro_torch.core import shardcomm
    group = shardcomm.current_group(cuda_device)
    assert group.world == 1
    shapes = sup.outer_tree_shapes()
    anchor = sup.outer_tree(shapes, 1, device=cuda_device)
    mom = sup.outer_tree(shapes, 2, scale=0.01, device=cuda_device)
    local = sup.outer_tree(shapes, 3, scale=0.1, device=cuda_device)
    ef = sup.outer_tree(shapes, 4, scale=1e-3, device=cuda_device)
    sync = make_outer_sync(group, window=2)
    got = sync(anchor, local, ef, mom)
    want = sup.outer_sync_spelled(anchor, [local], [ef], mom)
    for g, w in zip(sup.sorted_leaves(got[0]) + sup.sorted_leaves(got[1])
                    + sup.sorted_leaves(got[2]), want[0] + want[1][0] + want[2]):
        assert torch.equal(g, w)
    assert sync.stats["max_in_flight"] == 2


# -------------------------------------------------------------------------
# the trainer: K5's and K6's backward kernels, the autograd Functions, a
# REDUCED train step
# -------------------------------------------------------------------------

FLASH_BWD_SHAPES = [
    # B, H, KV, T, S, D, causal, bf16
    (1, 40, 8, 1024, 1024, 128, True, True),     # the training shape
    (2, 4, 2, 32, 32, 16, True, True),           # REDUCED qwen3-14b
    (2, 4, 2, 32, 32, 16, True, False),
    (1, 4, 2, 100, 100, 64, True, False),
    (1, 4, 2, 65, 129, 64, True, True),          # T < S
    (1, 2, 2, 127, 63, 128, False, True),        # unmasked
    (1, 2, 1, 129, 129, 128, True, False),
    (2, 10, 2, 70, 70, 32, True, True),
    (1, 2, 1, 3, 40, 128, True, True),           # T <= 4: the tiled form
    (1, 8, 8, 130, 130, 80, True, True),         # stablelm-3b, D = 80
    (1, 4, 2, 65, 97, 80, True, False),
    (1, 4, 4, 130, 130, 256, True, True),        # gemma-7b, D = 256
    (1, 4, 2, 70, 70, 256, False, True),
    (1, 2, 2, 65, 65, 256, True, False),
    (1, 32, 32, 1024, 1024, 96, True, True),     # phi3-vision, D = 96
    (1, 20, 20, 1500, 1500, 64, False, True),    # whisper's encoder
    (1, 20, 20, 448, 1500, 64, False, True),     # ... its cross-attention
] + sup.FLASH_BWD_D96_SHAPES


def _flash_bwd_case(dev, B, H, KV, T, S, D, causal, bf16, seed=0):
    """(q, k, v, o, lse, do) on ``dev``: o and lse from the plain forward."""
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do = (torch.as_tensor(a, device=dev).to(dt)
                   for a in sup.flash_bwd_inputs(B, H, KV, T, S, D, seed))
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                     return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,S,D,causal,bf16", FLASH_BWD_SHAPES)
def test_flash_attention_bwd_kernel(cuda_device, B, H, KV, T, S, D, causal,
                                    bf16):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    args = _flash_bwd_case(cuda_device, B, H, KV, T, S, D, causal, bf16,
                           seed=T + S)
    got = flash_attention_bwd(*args, causal=causal)
    want = ref.flash_attention_bwd_ref(*args, causal=causal)
    again = flash_attention_bwd(*args, causal=causal)
    bar = sup.BWD_BAR_BF16 if bf16 else sup.BWD_BAR_F32
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert sup.rel_err(g, w) <= bar, (name, sup.rel_err(g, w))
        torch.testing.assert_close(a, g, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_lse_and_window(cuda_device):
    """The forward's log-sum-exp (bf16 and float32, T <= 4 included)
    against the plain version's, its output bit for bit the forward's
    without it where both take the tiled form (T > 4; at T <= 4 the LSE
    takes the tiled form, held to the plain version); with a window the
    backward launches its kernel (one launch), held to the plain
    version."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    for T, S, bf16 in ((64, 64, True), (3, 40, True), (70, 90, False),
                       (2, 9, False)):
        q, k, v, o, lse, do = _flash_bwd_case(cuda_device, 2, 4, 2, T, S,
                                              64, True, bf16)
        out, got = flash_attention(q, k, v, return_lse=True)
        torch.testing.assert_close(got, lse, rtol=1e-5, atol=1e-5)
        if T > 4:
            torch.testing.assert_close(out, flash_attention(q, k, v),
                                       rtol=0, atol=0)
        tol = 2e-2 if bf16 else 2e-5
        torch.testing.assert_close(out.float(), o.float(), rtol=tol,
                                   atol=tol)
    from repro_torch.kernels import LAUNCHES, reset_launches
    q, k, v, _, _, do = _flash_bwd_case(cuda_device, 2, 4, 2, 70, 70, 64,
                                        True, True)
    o, lse = flash_attention(q, k, v, window=4, return_lse=True)
    reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=4)
    assert LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                       window=4)
    for g, w in zip(got, want):
        assert sup.rel_err(g, w) <= sup.BWD_BAR_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,S,D,window,bf16",
                         sup.FLASH_BWD_WINDOW_SHAPES)
def test_flash_attention_bwd_window_kernel(cuda_device, B, H, KV, T, S, D,
                                           window, bf16):
    """K5's backward with a sliding window (causal) against its plain
    version at its tiles' edges (``sup.FLASH_BWD_WINDOW_SHAPES``), o and
    lse from the windowed forward kernel, each gradient relative to its
    largest value (``sup.bwd_errs``: floored at 1e-3 of the largest of
    the three, since a window of one makes dq and dk zero), and bit for
    bit a second launch."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    q, k, v, _, _, do = _flash_bwd_case(cuda_device, B, H, KV, T, S, D,
                                        True, bf16, seed=T + window)
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    args = (q, k, v, o, lse, do)
    got = flash_attention_bwd(*args, causal=True, window=window)
    want = ref.flash_attention_bwd_ref(*args, causal=True, window=window)
    again = flash_attention_bwd(*args, causal=True, window=window)
    bar = sup.BWD_BAR_BF16 if bf16 else sup.BWD_BAR_F32
    errs = sup.bwd_errs(got, want)
    for name, g, w, a, e in zip(("dq", "dk", "dv"), got, want, again, errs):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert e <= bar, (name, e)
        torch.testing.assert_close(a, g, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [3, 7, 8, 20])
def test_ring_decode_through_k5(cuda_device, index):
    """``attn_decode(kind="local")`` on the card (the REDUCED
    recurrentgemma's window of 8 slots, bfloat16 compute) before, at and
    past the ring's wrap: one K5 launch over the first min(index + 1, 8)
    slots, the output against the port on the CPU (2e-2 of the largest)
    and the new k/v written at slot index % 8."""
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import layers as L
    cfg = configs.reduced_config("recurrentgemma_2b")
    tree = sup.numpy_params(L.attn_specs(cfg), 2)
    rng = np.random.default_rng(index)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ring = rng.standard_normal((2, cfg.window, cfg.num_kv_heads,
                                cfg.head_dim)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        p = models.params_from_numpy(tree, dev)
        ck, cv = (torch.as_tensor(ring, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        reset_launches()
        y, ck, cv = L.attn_decode(p, torch.as_tensor(x, device=dev), ck, cv,
                                  index, cfg, "local")
        out[str(dev)] = (y.float().cpu(), ck.float().cpu(), dict(LAUNCHES))
    (yc, kc, _), (yg, kg, launched) = out["cpu"], out[str(cuda_device)]
    assert launched["flash_attention"] == 1
    assert sup.rel_err(yg, yc) <= 2e-2
    slot = index % cfg.window
    keep = [s for s in range(cfg.window) if s != slot]
    torch.testing.assert_close(kg[:, keep], kc[:, keep], rtol=0, atol=0)
    assert sup.rel_err(kg[:, slot], kc[:, slot]) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_130m"])
def test_reduced_recurrent_archs_on_card_match_cpu(cuda_device, arch):
    """The REDUCED recurrentgemma and mamba2, float32 compute, numpy
    params: a prompt of 20 (past recurrentgemma's window of 8) + 4
    teacher-forced decode steps on the card against the port on the CPU
    (relative to the largest value, 1e-4; every cache leaf), with K5 once
    a local layer a forward and K6 for ln1, ln2 (not in an ssm block) and
    ln_f."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              compute_dtype="float32")
    tree = sup.numpy_params(models.lm_specs(cfg), 1)
    rng = np.random.default_rng(1)
    tv = cfg.true_vocab or cfg.vocab_size
    prompt = torch.as_tensor(rng.integers(0, tv, (2, 20)))
    toks = torch.as_tensor(rng.integers(0, tv, (2, 4)))
    want = sup.lm_teacher_forced(models.params_from_numpy(tree, "cpu"), cfg,
                                 prompt, toks, 32)
    reset_launches()
    got = sup.lm_teacher_forced(models.params_from_numpy(tree, cuda_device),
                                cfg, prompt.to(cuda_device),
                                toks.to(cuda_device), 32)
    G = cfg.pattern_groups
    local = G * cfg.pattern.count("local")
    norms = G * sum(1 if k == "ssm" else 2 for k in cfg.pattern) + 1
    assert LAUNCHES["flash_attention"] == 5 * local
    assert LAUNCHES["rmsnorm"] == 5 * norms
    assert len(got) == len(want)
    for (what, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert sup.rel_err(g, w) <= 1e-4, what


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper_large_v3", "phi3_vision_4_2b"])
def test_reduced_encdec_archs_on_card_match_cpu(cuda_device, arch):
    """The REDUCED whisper and phi3-vision, float32 compute, numpy params
    and frontend embeddings: a prompt of 20 (phi3-vision's first 8 image
    positions) + 4 teacher-forced decode steps on the card against the
    port on the CPU (relative to the largest value, 1e-4; every cache
    leaf, whisper's cross keys and values included), with K5 on every
    self- and cross-attention (whisper's encoder once, in the prefill)
    and K6 for phi3-vision's norms."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              compute_dtype="float32")
    tree = sup.numpy_params(models.lm_specs(cfg), 1)
    rng = np.random.default_rng(1)
    tv = cfg.true_vocab or cfg.vocab_size
    prompt = torch.as_tensor(rng.integers(0, tv, (2, 20)))
    toks = torch.as_tensor(rng.integers(0, tv, (2, 4)))
    extras = {}
    if cfg.enc_layers:
        extras["enc_feats"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.num_image_tokens:
        extras["img_embeds"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    want = sup.lm_teacher_forced(models.params_from_numpy(tree, "cpu"), cfg,
                                 prompt, toks, 32, extras)
    reset_launches()
    got = sup.lm_teacher_forced(
        models.params_from_numpy(tree, cuda_device), cfg,
        prompt.to(cuda_device), toks.to(cuda_device), 32,
        {k: v.to(cuda_device) for k, v in extras.items()})
    L = cfg.num_layers
    dec = cfg.pattern.count("dec") * cfg.pattern_groups
    assert LAUNCHES["flash_attention"] == 5 * (L + dec) + cfg.enc_layers
    norms = 2 * L + 1 if cfg.norm == "rmsnorm" else 0
    assert LAUNCHES["rmsnorm"] == 5 * norms
    assert len(got) == len(want)
    for (what, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert sup.rel_err(g, w) <= 1e-4, what


@pytest.mark.cuda
def test_reduced_whisper_train_step_on_card_matches_cpu(cuda_device):
    """REDUCED whisper, float32 compute, numpy params, 24 decoder tokens
    over its 16 frames: the loss and every gradient of one microbatch on
    the card (K5's unmasked backward through the encoder and the
    cross-attention, its causal one through the decoder) against the port
    on the CPU (relative to each leaf's largest gradient, 1e-4)."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.spec import _leaves
    from repro_torch.train import DataConfig, SyntheticData, xent_loss
    cfg = dataclasses.replace(configs.reduced_config("whisper_large_v3"),
                              compute_dtype="float32")
    batch = SyntheticData(cfg, DataConfig(batch=2, seq=24)).batch_at(0)
    tree = sup.numpy_params(models.lm_specs(cfg), 0)
    out = {}
    for dev in ("cpu", cuda_device):
        params = models.params_from_numpy(tree, dev)
        b = {n: torch.as_tensor(a, device=dev) for n, a in batch.items()}
        for p in _leaves(params):
            p.requires_grad_(True)
        reset_launches()
        loss = xent_loss(models.lm_forward(params, b, cfg, remat="full"),
                         b["labels"], cfg)
        loss.backward()
        out[str(dev)] = (float(loss.detach()),
                         [p.grad.cpu() for p in _leaves(params)],
                         dict(LAUNCHES))
    attn = 2 * cfg.num_layers + cfg.enc_layers      # self + cross, encoder
    launched = out[str(cuda_device)][2]
    assert launched["flash_attention"] == 2 * attn
    assert launched["flash_attention_bwd"] == attn
    (lc, gc, _), (lg, gg, _) = out["cpu"], out[str(cuda_device)]
    assert abs(lc - lg) <= 1e-5
    for g, w in zip(gg, gc):
        assert sup.rel_err(g, w) <= 1e-4


@pytest.mark.cuda
def test_reduced_recurrentgemma_train_step_on_card_matches_cpu(cuda_device):
    """REDUCED recurrentgemma, float32 compute, numpy params, sequences of
    32 (four of its windows): the loss and every gradient of one
    microbatch on the card (K5 with its windowed backward, K6 and its
    backward, the RG-LRU scan by autograd) against the port on the CPU
    (relative to each leaf's largest gradient, 1e-4)."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.spec import _leaves
    from repro_torch.train import DataConfig, SyntheticData, xent_loss
    cfg = dataclasses.replace(configs.reduced_config("recurrentgemma_2b"),
                              compute_dtype="float32")
    batch = SyntheticData(cfg, DataConfig(batch=2, seq=32)).batch_at(0)
    tree = sup.numpy_params(models.lm_specs(cfg), 0)
    out = {}
    for dev in ("cpu", cuda_device):
        params = models.params_from_numpy(tree, dev)
        b = {n: torch.as_tensor(a, device=dev) for n, a in batch.items()}
        for p in _leaves(params):
            p.requires_grad_(True)
        reset_launches()
        loss = xent_loss(models.lm_forward(params, b, cfg, remat="full"),
                         b["labels"], cfg)
        loss.backward()
        out[str(dev)] = (float(loss.detach()),
                         [p.grad.cpu() for p in _leaves(params)],
                         dict(LAUNCHES))
    local = cfg.pattern_groups * cfg.pattern.count("local")
    launched = out[str(cuda_device)][2]
    assert launched["flash_attention"] == 2 * local
    assert launched["flash_attention_bwd"] == local
    assert launched["rmsnorm_bwd"] == 2 * cfg.num_layers + 1
    (lc, gc, _), (lg, gg, _) = out["cpu"], out[str(cuda_device)]
    assert abs(lc - lg) <= 1e-5
    for g, w in zip(gg, gc):
        assert sup.rel_err(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(1024, 5120), (1024 * 40, 128),
                                 (1024 * 8, 128), (64, 64), (7, 16),
                                 (33, 200), (5, 5121)])
@pytest.mark.parametrize("bf16", [True, False])
def test_rmsnorm_bwd_kernel(cuda_device, N, D, bf16):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    x, s, dy = (torch.as_tensor(a, device=cuda_device)
                for a in sup.rmsnorm_bwd_inputs(N, D, seed=N + D))
    if bf16:
        x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    got = rmsnorm_bwd(x, s, dy, eps=1e-6)
    want = ref.rmsnorm_bwd_ref(x, s, dy, eps=1e-6)
    again = rmsnorm_bwd(x, s, dy, eps=1e-6)
    bar = sup.BWD_BAR_BF16 if bf16 else sup.BWD_BAR_F32
    for name, g, w, a in zip(("dx", "dscale"), got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert sup.rel_err(g, w) <= bar, (name, sup.rel_err(g, w))
        torch.testing.assert_close(a, g, rtol=0, atol=0)


# B, H, KV, T, S, D, causal, window: K5's bf16 backward against its order
# spelled in torch: qwen3-14b's and qwen3-moe's groups split into chunks,
# whisper's cross-attention (unmasked, T < S), partial tiles at D = 96 and
# 80, MQA with a window at D = 256 (dk/dv split by columns), D = 16
K5_ORDER_SHAPES = [
    (1, 40, 8, 1024, 1024, 128, True, 0),
    (1, 32, 4, 1024, 1024, 128, True, 0),
    (1, 20, 20, 448, 1500, 64, False, 0),
    (1, 4, 2, 65, 129, 96, True, 0),
    (2, 4, 2, 63, 63, 80, True, 0),
    (1, 10, 1, 129, 129, 256, True, 17),
    (1, 8, 8, 130, 130, 16, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,S,D,causal,window", K5_ORDER_SHAPES)
def test_flash_attention_bwd_kernel_is_its_order(cuda_device, B, H, KV, T,
                                                 S, D, causal, window):
    """The bf16 backward against ``sup.flash_bwd_in_k5_order`` with the
    wrapper's chunks of the group's heads, at ``sup.K5_ORDER_BAR`` of each
    gradient's largest value (``sup.bwd_errs``), one launch a call."""
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.flash_attention import (bwd_heads_per_chunk,
                                                     flash_attention,
                                                     flash_attention_bwd)
    q, k, v, _, _, do = _flash_bwd_case(cuda_device, B, H, KV, T, S, D,
                                        causal, True, seed=T + D + window)
    o, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    assert LAUNCHES["flash_attention_bwd"] == 1
    hpc = bwd_heads_per_chunk(B, H, KV, S, D, _build.sm_count(cuda_device))
    want = sup.flash_bwd_in_k5_order(q, k, v, o, lse, do, causal=causal,
                                     window=window, hpc=hpc)
    for name, e in zip(("dq", "dk", "dv"), sup.bwd_errs(got, want)):
        assert e <= sup.K5_ORDER_BAR, (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(1024, 5120), (1024 * 40, 128), (7, 16),
                                 (33, 200), (5, 5121), (4096, 2048)])
@pytest.mark.parametrize("bf16", [True, False])
def test_rmsnorm_bwd_kernel_is_its_order(cuda_device, N, D, bf16):
    """K6's backward bit for bit its order spelled in torch
    (``sup.rmsnorm_bwd_in_k6_order`` with the card's SM count), one launch
    a call."""
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    x, s, dy = (torch.as_tensor(a, device=cuda_device)
                for a in sup.rmsnorm_bwd_inputs(N, D, seed=N + D))
    if bf16:
        x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    reset_launches()
    got = rmsnorm_bwd(x, s, dy, eps=1e-6)
    assert LAUNCHES["rmsnorm_bwd"] == 1
    want = sup.rmsnorm_bwd_in_k6_order(x, s, dy, 1e-6,
                                       sms=_build.sm_count(cuda_device))
    for name, g, w in zip(("dx", "dscale"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_backward_kernels_use_wgmma_and_no_float_atomic(cuda_device):
    """The compiled bf16 K5 backward kernels run Hopper's warpgroup
    products (HGMMA in their SASS), and neither backward's kernels take a
    float atomic (``cuobjdump -sass`` of the built libraries)."""
    import re
    import shutil
    import subprocess
    from repro_torch.kernels import _build
    _build.build(("flash_attention", "rmsnorm"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, names, wgmma in (
            ("flash_attention", ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
                                 "flash_bwd_dq_f32", "flash_bwd_dkv_f32"),
             ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")),
            ("rmsnorm", ("rmsnorm_bwd_kernel",), ())):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        seen = set()
        for section in sass.split("Function : ")[1:]:
            fname = section.split("\n", 1)[0]
            name = next((n for n in names if n in fname), None)
            if name is None:
                continue
            seen.add(name)
            if name in wgmma:
                assert "HGMMA" in section, fname
            for line in section.splitlines():
                assert not re.search(r"\b(ATOM|ATOMG|RED)\S*\.F(16|32|64)",
                                     line), (fname, line)
        assert seen == set(names), (lib, seen)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
def test_autograd_functions_launch_the_backward_kernels(cuda_device, bf16):
    """``ops.flash_attention`` and ``ops.rmsnorm`` on CUDA tensors that
    require grad: one forward and one backward launch each, gradients
    against the same Functions on the CPU; without grad, the forward
    alone."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    dt = torch.bfloat16 if bf16 else torch.float32
    bar = sup.BWD_BAR_BF16 if bf16 else sup.BWD_BAR_F32
    q, k, v, do = (torch.as_tensor(a).to(dt)
                   for a in sup.flash_bwd_inputs(2, 4, 2, 48, 48, 64, 1))
    x, s, dy = (torch.as_tensor(a) for a in sup.rmsnorm_bwd_inputs(40, 128))
    x, dy = x.to(dt), dy.to(dt)
    grads = {}
    for dev in ("cpu", cuda_device):
        ins = [t.detach().to(dev).requires_grad_()
               for t in (q, k, v, x, s)]
        reset_launches()
        o = ops.flash_attention(*ins[:3], causal=True)
        y = ops.rmsnorm(ins[3], ins[4])
        torch.autograd.backward((o, y), (do.to(dev), dy.to(dev)))
        grads[str(dev)] = [t.grad.cpu() for t in ins]
        launched = dict(LAUNCHES)
    assert (launched["flash_attention"], launched["flash_attention_bwd"],
            launched["rmsnorm"], launched["rmsnorm_bwd"]) == (1, 1, 1, 1)
    for g, w in zip(grads[str(cuda_device)], grads["cpu"]):
        assert sup.rel_err(g, w) <= bar
    reset_launches()
    with torch.no_grad():
        ops.flash_attention(*(t.to(cuda_device) for t in (q, k, v)))
    assert LAUNCHES["flash_attention"] == 1
    assert LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.cuda
def test_reduced_train_step_on_card_matches_cpu(cuda_device):
    """REDUCED qwen3-14b, float32 compute, numpy params: the loss and
    every gradient of one microbatch on the card (K5, K6 and their
    backward kernels) against the port on the CPU (relative to each
    leaf's largest gradient, 1e-4), then one train step's loss (1e-5)."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train_preset
    from repro_torch.models.spec import _leaves
    from repro_torch.train import (DataConfig, SyntheticData, init_opt,
                                   make_train_step, xent_loss)
    cfg = dataclasses.replace(configs.reduced_config("qwen3-14b"),
                              compute_dtype="float32")
    tcfg = dataclasses.replace(train_preset("qwen3_14b"), microbatch=2)
    batch = SyntheticData(cfg, DataConfig(batch=4, seq=32)).batch_at(0)
    tree = sup.numpy_params(models.lm_specs(cfg), 0)
    out = {}
    for dev in ("cpu", cuda_device):
        params = models.params_from_numpy(tree, dev)
        b = {n: torch.as_tensor(a, device=dev) for n, a in batch.items()}
        for p in _leaves(params):
            p.requires_grad_(True)
        reset_launches()
        loss = xent_loss(models.lm_forward(params, b, cfg, remat="full"),
                         b["labels"], cfg)
        loss.backward()
        grads = [p.grad.cpu() for p in _leaves(params)]
        launched = dict(LAUNCHES)
        _, _, metrics = make_train_step(cfg, tcfg)(
            params, init_opt(params, tcfg), b)
        out[str(dev)] = (float(loss.detach()), grads,
                         float(metrics["loss"]))
    L = cfg.num_layers
    assert launched["flash_attention"] == 2 * L
    assert launched["flash_attention_bwd"] == L
    assert launched["rmsnorm"] == 2 * 4 * L + 1
    assert launched["rmsnorm_bwd"] == 4 * L + 1
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[str(cuda_device)]
    assert abs(lc - lg) <= 1e-5 and abs(sc - sg) <= 1e-5
    for g, w in zip(gg, gc):
        assert sup.rel_err(g, w) <= 1e-4
