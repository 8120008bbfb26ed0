"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 ``powertcp_step`` and K2 ``theta_powertcp_step`` bit for bit (built
with ``-fmad=false``, they round every product as the plain versions do),
K3 ``queue_arrivals`` at rtol 1e-5 / atol 1e-3 bytes (its arrival sum
runs in its own fixed order), at the main path's shapes (F = 384 slots
or 2 406 padded flows, H = 3, Q+1 = 289), ragged ones and the edges of
its row chunks and column tiles, and bit for bit against its order
spelled in torch and against itself run twice (the elected combine); K4
``fused_tick_block`` against the plain megakernel block on every carry
leaf bit for bit (the records' ``w_sum``/``lam`` sums at rtol 1e-5) at
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
and the REDUCED qwen3-14b model on the
card against the port on the CPU at the tight bar of
``tests/test_torch_lm.py``. Every test takes the ``cuda_device``
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
                  "queue_arrivals": 0, "fused_tick_block": 63, "rmsnorm": 0,
                  "flash_attention": 0}
    assert sum(lc.values()) == 0
    torch.testing.assert_close(fg, fc, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(qg, qc, rtol=0, atol=0)


@pytest.mark.cuda
def test_megakernel_law_without_k4_raises_on_cuda(cuda_device):
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, steps=64, device=cuda_device)
    other = tc.Law("my_law", tc.LAWS["powertcp"].init,
                   tc.LAWS["powertcp"].update)
    with pytest.raises(NotImplementedError, match="item 8"):
        tc.simulate_slots(topo, sched, other, 6, backend="megakernel",
                          device=cuda_device)


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
