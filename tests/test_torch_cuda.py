"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 ``powertcp_step`` and K2 ``theta_powertcp_step`` bit for bit (built
with ``-fmad=false``, they round every product as the plain versions do),
K3 ``queue_arrivals`` at rtol 1e-5 / atol 1e-3 bytes (its arrival sum
runs in its own fixed order), at the main path's shapes (F = 384 slots
or 2 406 padded flows, H = 3, Q+1 = 289) and ragged ones; K4
``fused_tick_block`` against the plain megakernel block on every carry
leaf bit for bit (the records' ``w_sum``/``lam`` sums at rtol 1e-5) at
the anchor shapes of ``tests/test_megakernel.py``, with the gather table
at its suggested width and narrowed until it overflows, and the
megakernel backend's launches. Every test takes the ``cuda_device``
fixture and skips without a card; this module imports neither JAX nor
``repro``, so it runs where only PyTorch is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
                                   (3, 2406, 289)])
def test_queue_arrivals_kernel(cuda_device, H, F, Q):
    kw = _on(sup.queue_inputs(H, F, Q), cuda_device)
    got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
    want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)


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
    ("powertcp", 16, (1, 64), 2),          # the gather table overflows:
    ("theta_powertcp", 6, (64,), 2)])      # K4 walks the hop list
def test_fused_tick_block_kernel_anchor(cuda_device, law, slots, blocks,
                                        maxdeg):
    import repro_torch.core as tc
    topo, sched, cfg = sup.staggered(tc, device=cuda_device)
    sup.k4_against_plain(tc, topo, sched, cfg, law, slots, blocks,
                         maxdeg=maxdeg)


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
                  "queue_arrivals": 0, "fused_tick_block": 63}
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
