"""The port's kernels against the JAX reference (CPU) and on the card.

On the CPU the kernels' plain PyTorch versions (``repro_torch.kernels.ref``)
are held against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode, on the same numpy inputs:

* K1 ``powertcp_step`` and K2 ``theta_powertcp_step``: bit for bit
  against ``repro.kernels.ref`` (the same association, every op rounded);
  against the interpret-mode Pallas kernel at rtol 1e-5 (atol 1e-6 on
  the smoothed power), the tolerance ``tests/test_kernels.py`` holds that
  kernel to against ``repro.kernels.ref``: under XLA the kernel's
  products may be contracted into FMAs, and where the smoothing cancels
  (a falling RTT) the last bit grows to a few 1e-6 — the JAX kernel and
  the JAX oracle differ by as much.
* K3 ``queue_arrivals``: rtol 1e-5 against both (every form sums the
  arrivals in its own order); and the CUDA kernel's own order spelled in
  torch (``test_torch_support.queue_arrivals_in_k3_order``: 64-row
  chunks summed in chunk order) against the interpret-mode Pallas kernel
  at the kernel's bar, rtol 1e-5 / atol 1e-3.
* the reference backend's in-order sparse helpers (``build_csr_gather``,
  ``csr_gather_arrivals``, ``ordered_scatter_add``), ``update_incidence``
  and ``types.pad_hops``: bit for bit against ``repro``'s.
* K5 ``flash_attention`` and K6 ``rmsnorm``: on every case of
  ``tests/test_kernels.py`` (``FLASH_CASES``, its rmsnorm cases), against
  ``repro.kernels.ref`` and the interpret-mode Pallas kernels at that
  file's tolerances, 2e-5 in float32 and 2e-2 in bfloat16 (the plain
  versions and ``repro``'s oracles compute the same thing, but sum in
  another order and round their bfloat16 outputs once). K5's tensor-core
  arithmetic (P split into bf16 halves p_hi + p_lo, 64-key splits merged
  in split order; ``test_torch_support.flash_in_k5_order``) against the
  plain version and ``repro.kernels.ref`` within 1e-4 in float32 compute
  on the REDUCED qwen3-14b attention shapes, so that a tolerance fault
  shows before a chip run. K6's sum order (lanes of a row in registers,
  an xor butterfly, warps in order; ``test_torch_support.
  rmsnorm_in_k6_order``) and its plan against ``repro.kernels.ref`` and
  the interpret-mode Pallas kernel within one bfloat16 ulp / rtol 1e-5,
  also at the serve run's [4, 5120] and [2048, 5120] rows.

``tests/test_torch_cuda.py`` holds the CUDA kernels themselves against
these plain versions on the card.
"""
import importlib

import numpy as np
import pytest
import torch

import test_torch_support as sup

from repro_torch.kernels import ops, ref

jcore, jkernels = sup.import_repro()
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.powertcp_step import (  # noqa: E402
    powertcp_step as j_powertcp_step,
    theta_powertcp_step as j_theta_powertcp_step)
from repro.kernels.queue_arrivals import (  # noqa: E402
    queue_arrivals as j_queue_arrivals)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as j_flash_attention)
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm  # noqa: E402

SIZES_F = (1, 7, 256, 300)
SIZES_H = (1, 3, 5)
SIZES_Q = (2, 17, 289)


def _torch(kw, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in kw.items()}


def _jax(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


@pytest.mark.parametrize("H", SIZES_H)
@pytest.mark.parametrize("F", SIZES_F)
def test_powertcp_step_plain_matches_jax(F, H):
    kw = sup.law_inputs(F, H, seed=F * 10 + H)
    w, gs = ref.powertcp_step_ref(**_torch(kw), gamma=0.9, w_min=1000.0)
    wr, gr = jref.powertcp_step_ref(**_jax(kw), gamma=0.9, w_min=1000.0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(gr))
    wk, gk = j_powertcp_step(**_jax(kw), interpret=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(wk), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gk), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("F", SIZES_F)
def test_theta_powertcp_step_plain_matches_jax(F):
    kw = sup.theta_inputs(F, seed=F)
    w, gs, pv = ref.theta_powertcp_step_ref(**_torch(kw), gamma=0.9,
                                            w_min=1000.0)
    wr, gr, pr = jref.theta_powertcp_step_ref(**_jax(kw), gamma=0.9,
                                              w_min=1000.0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(gr))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(pr))
    wk, gk, pk = j_theta_powertcp_step(**_jax(kw), interpret=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(wk), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gk), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(pk))


@pytest.mark.parametrize("Q", SIZES_Q)
@pytest.mark.parametrize("H,F", [(1, 1), (3, 7), (5, 256), (3, 300)])
def test_queue_arrivals_plain_matches_jax(H, F, Q):
    kw, dt = sup.queue_inputs(H, F, Q, seed=H * 1000 + F + Q), sup.QUEUE_DT
    arr, qn = ref.queue_arrivals_ref(**_torch(kw), dt=dt)
    ar, qr = jref.queue_arrivals_ref(**_jax(kw), dt=dt)
    np.testing.assert_allclose(arr.numpy(), np.asarray(ar), rtol=1e-5)
    np.testing.assert_allclose(qn.numpy(), np.asarray(qr), rtol=1e-5)
    ak, qk = j_queue_arrivals(**_jax(kw), dt=dt, interpret=True)
    np.testing.assert_allclose(arr.numpy(), np.asarray(ak), rtol=1e-5)
    np.testing.assert_allclose(qn.numpy(), np.asarray(qk), rtol=1e-5)


@pytest.mark.parametrize("H,F,Q", [(1, 1, 2), (3, 300, 289),
                                   (5, 257, 129), (3, 257, 289),
                                   (1, 20, 70), (4, 16, 64)])
def test_queue_arrivals_k3_order_matches_jax(H, F, Q):
    kw, dt = sup.queue_inputs(H, F, Q, seed=H + F + Q), sup.QUEUE_DT
    arr, qn = sup.queue_arrivals_in_k3_order(**_torch(kw), dt=dt)
    ak, qk = j_queue_arrivals(**_jax(kw), dt=dt, interpret=True)
    np.testing.assert_allclose(arr.numpy(), np.asarray(ak), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(qn.numpy(), np.asarray(qk), rtol=1e-5,
                               atol=1e-3)
    ar, qr = ref.queue_arrivals_ref(**_torch(kw), dt=dt)
    torch.testing.assert_close(arr, ar, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(qn, qr, rtol=1e-5, atol=1e-3)


# B, H, KV, T, S, D, causal, window: the REDUCED qwen3-14b attention
# (prefill of 24 tokens, decode into a cache of 40) and decode with T > 1
K5_ORDER_CASES = [(4, 4, 2, 24, 24, 16, True, 0),
                  (4, 4, 2, 1, 31, 16, True, 0),
                  (4, 4, 2, 3, 40, 16, True, 0),
                  (2, 4, 2, 1, 40, 16, True, 12),
                  (2, 4, 2, 24, 24, 16, False, 0)]


@pytest.mark.parametrize("split", [sup.K5_SPLIT_KEYS, 8])
@pytest.mark.parametrize("B,H,KV,T,S,D,causal,window", K5_ORDER_CASES)
def test_flash_k5_order_matches_plain_and_jax(B, H, KV, T, S, D, causal,
                                              window, split):
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16).float() for a in
               sup.flash_inputs(B, H, KV, T, S, D, seed=T + S + split))
    got = sup.flash_in_k5_order(q, k, v, causal=causal, window=window,
                                split=split)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    jwant = jref.flash_attention_ref(*(jnp.asarray(x.numpy())
                                       for x in (q, k, v)),
                                     causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-4,
                               atol=1e-4)


# B, H, KV, T, S, D, causal, window, bf16 — tests/test_kernels.py's
# FLASH_CASES
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, False),
    (1, 4, 4, 100, 100, 64, True, 0, False),      # ragged T
    (2, 2, 1, 64, 256, 32, True, 0, False),       # MQA + T<S offset
    (1, 4, 2, 128, 128, 64, True, 48, False),     # sliding window
    (1, 2, 2, 96, 160, 128, False, 0, False),     # bidirectional
    (1, 2, 2, 128, 128, 64, True, 0, True),
    (1, 1, 1, 8, 8, 256, True, 0, False),         # tiny + head_dim 256
    (1, 2, 1, 33, 77, 64, True, 16, True),        # ragged everything
]
# N, D, bf16 — tests/test_kernels.py's rmsnorm cases
RMSNORM_CASES = [(64, 128, False), (100, 256, True), (7, 64, False),
                 (1, 512, False), (513, 128, True)]


def _bf16_pair(a, bf16):
    """The same values as a JAX array and a torch tensor (float32, or
    bfloat16 rounded once by JAX and carried across bit for bit)."""
    if not bf16:
        return jnp.asarray(a), torch.as_tensor(a)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.as_tensor(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _close(got, want, bf16):
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,T,S,D,causal,window,bf16", FLASH_CASES)
def test_flash_attention_plain_matches_jax(B, H, KV, T, S, D, causal,
                                           window, bf16):
    rng = np.random.default_rng(B * 1000 + T + S + D)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16_pair(rng.standard_normal(shape).astype(np.float32), bf16)
        for shape in ((B, H, T, D), (B, KV, S, D), (B, KV, S, D)))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, H, T, D)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window), bf16)
    _close(got, j_flash_attention(jq, jk, jv, causal=causal, window=window,
                                  bq=32, bk=32, interpret=True), bf16)


@pytest.mark.parametrize("N,D,bf16", RMSNORM_CASES)
def test_rmsnorm_plain_matches_jax(N, D, bf16):
    rng = np.random.default_rng(N + D)
    jx, tx = _bf16_pair(rng.standard_normal((N, D)).astype(np.float32), bf16)
    js, ts = _bf16_pair(rng.standard_normal((D,)).astype(np.float32), bf16)
    got = ref.rmsnorm_ref(tx, ts)
    assert got.dtype == tx.dtype
    _close(got, jref.rmsnorm_ref(jx, js), bf16)
    _close(got, j_rmsnorm(jx, js, interpret=True), bf16)


def test_rmsnorm_plain_3d_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 128)).astype(np.float32)
    s = rng.standard_normal((128,)).astype(np.float32)
    got = ref.rmsnorm_ref(torch.as_tensor(x), torch.as_tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_rmsnorm(jnp.asarray(x), jnp.asarray(s), interpret=True)),
        atol=1e-5, rtol=1e-5)


def test_rmsnorm_plan():
    """K6's lanes per row, vectors per lane and elements per vector at the
    serve shapes, ragged rows and the widest rows it holds."""
    from repro_torch.kernels.rmsnorm import plan
    assert plan(5120, 2) == (160, 4, 8)       # layer norms, bfloat16
    assert plan(5120, 4) == (320, 4, 4)
    assert plan(128, 2) == (16, 1, 8)         # qk-norms: two rows a warp
    assert plan(128, 4) == (32, 1, 4)
    assert plan(5121, 2) == (192, 4, 8)
    assert plan(64, 2) == (8, 1, 8)
    assert plan(200, 2) == (32, 1, 8)
    assert plan(1000, 2) == (32, 4, 8)
    assert plan(1024, 2) == (32, 4, 8)
    assert plan(2048, 2) == (64, 4, 8)
    assert plan(40000, 2) == (512, 10, 8)
    with pytest.raises(ValueError, match="wider"):
        plan(512 * 16 * 8 + 8, 2)


# K6's order at tests/test_kernels.py's rmsnorm cases, the serve run's
# layer-norm rows and a ragged wide row
K6_ORDER_CASES = RMSNORM_CASES + [(4, 5120, True), (4, 5120, False),
                                  (2048, 5120, True), (2048, 5120, False),
                                  (7, 5121, True)]


@pytest.mark.parametrize("N,D,bf16", K6_ORDER_CASES)
def test_rmsnorm_k6_order_matches_jax(N, D, bf16):
    """K6's sum order spelled in torch against ``repro``'s rmsnorm (its
    plain version and interpret-mode Pallas): within one bfloat16 ulp in
    bfloat16, rtol 1e-5 in float32."""
    rng = np.random.default_rng(N + D + 1)
    jx, tx = _bf16_pair(rng.standard_normal((N, D)).astype(np.float32) * 3,
                        bf16)
    js, ts = _bf16_pair((1.0 + 0.1 * rng.standard_normal(D))
                        .astype(np.float32), bf16)
    got = sup.rmsnorm_in_k6_order(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (jref.rmsnorm_ref(jx, js), j_rmsnorm(jx, js, interpret=True)):
        w = torch.as_tensor(np.array(want.astype(jnp.float32)))
        if bf16:
            assert sup.bf16_ulps(got, w) <= 1.0
        else:
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


def test_ops_dispatch_lm_kernels_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 6, 32), (1, 2, 9, 32), (1, 2, 9, 32)))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True, window=4),
        ref.flash_attention_ref(q, k, v, causal=True, window=4),
        rtol=0, atol=0)
    x, s = torch.as_tensor(rng.standard_normal((3, 32)).astype(np.float32)), \
        torch.ones(32)
    torch.testing.assert_close(ops.rmsnorm(x, s, eps=1e-5),
                               ref.rmsnorm_ref(x, s, eps=1e-5), rtol=0,
                               atol=0)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    kw = sup.law_inputs(9, 3)
    got = ops.powertcp_step(**{k: v for k, v in _torch(kw).items()},
                            gamma=0.9, w_min=1000.0)
    want = ref.powertcp_step_ref(**_torch(kw), gamma=0.9, w_min=1000.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cuda_wrappers_reject_cpu_tensors():
    from repro_torch.kernels import powertcp_step, queue_arrivals
    kw = sup.law_inputs(4, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        powertcp_step(**_torch(kw))
    qkw, dt = sup.queue_inputs(1, 3, 2), sup.QUEUE_DT
    with pytest.raises(ValueError, match="CUDA tensors"):
        queue_arrivals(**_torch(qkw), dt=dt)


def test_lm_wrappers_reject_cpu_tensors():
    from repro_torch.kernels import flash_attention, rmsnorm
    q = torch.zeros(1, 2, 3, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm(q, torch.ones(32))


# -------------------------------------------------------------------------
# the reference backend's in-order sparse helpers, bit for bit
# -------------------------------------------------------------------------

def _queue_modules():
    """The two ``kernels/queue_arrivals.py`` modules (each package's
    ``kernels`` re-exports the K3 function under the module's name)."""
    return (importlib.import_module("repro.kernels.queue_arrivals"),
            importlib.import_module("repro_torch.kernels.queue_arrivals"))


def _hop_table(S, H, Q, seed):
    """An [S, H] hop table with ~25% sentinel (== Q) hops, int32."""
    rng = np.random.default_rng(seed)
    path = rng.integers(0, Q, (S, H)).astype(np.int32)
    path[rng.random((S, H)) < 0.25] = Q
    return path


@pytest.mark.parametrize("S,H,Q", [(1, 1, 2), (40, 3, 17), (300, 5, 17)])
def test_csr_gather_matches_jax(S, H, Q):
    jqa, tqa = _queue_modules()
    path = _hop_table(S, H, Q, seed=S + H)
    rng = np.random.default_rng(S * H)
    contrib = (np.abs(rng.standard_normal((S, H))) * 3e9).astype(np.float32)
    contrib[path == Q] = 0.0
    # the port's helpers take a batch of scenarios: a batch of one here
    exact = tqa.max_degree(torch.as_tensor(path)[None], Q)
    for maxdeg in (exact, max(exact // 2, 1)):
        inv, over = tqa.build_csr_gather(torch.as_tensor(path)[None], Q,
                                         maxdeg)
        jinv, jover = jqa.build_csr_gather(jnp.asarray(path), Q, maxdeg)
        np.testing.assert_array_equal(inv[0].numpy(), np.asarray(jinv))
        assert bool(over[0]) == bool(jover)
    inv, _ = tqa.build_csr_gather(torch.as_tensor(path)[None], Q, exact)
    zero = np.zeros(Q + 1, np.float32)
    got = tqa.csr_gather_arrivals(torch.as_tensor(contrib)[None], inv,
                                  torch.as_tensor(zero)[None])[0]
    want = jqa.csr_gather_arrivals(jnp.asarray(contrib), jnp.asarray(
        inv[0].numpy().astype(np.int32)), jnp.asarray(zero))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's ordered_scatter_add == repro's at every row count (repro
    # unrolls up to 128 rows and scatters above)
    got = tqa.ordered_scatter_add(torch.as_tensor(zero),
                                  torch.as_tensor(path),
                                  torch.as_tensor(contrib))
    want = jqa.ordered_scatter_add(jnp.asarray(zero), jnp.asarray(path),
                                   jnp.asarray(contrib))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,H,Q", [(1, 1, 2), (33, 3, 17)])
def test_update_incidence_matches_jax(S, H, Q):
    jqa, tqa = _queue_modules()
    path = _hop_table(S, H, Q, seed=7 * S + H)
    rng = np.random.default_rng(S)
    inc = (rng.random((H, S, Q + 1)) < 0.1).astype(np.float32)
    changed = rng.random(S) < 0.5
    got = tqa.update_incidence(torch.as_tensor(inc), torch.as_tensor(path),
                               torch.as_tensor(changed), Q)
    want = jqa.update_incidence(jnp.asarray(inc), jnp.asarray(path),
                                jnp.asarray(changed), Q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_hops_matches_jax():
    from repro_torch.core import Flows, pad_hops
    kw = sup.golden_scenario(jcore)[1]._asdict()
    jflows = jcore.pad_hops(jcore.Flows(**kw), 4, 1)
    tflows = pad_hops(Flows(**{k: torch.as_tensor(np.array(v))
                               for k, v in kw.items()}), 4, 1)
    for f in jflows._fields:
        np.testing.assert_array_equal(getattr(tflows, f).numpy(),
                                      np.asarray(getattr(jflows, f)),
                                      err_msg=f)
    with pytest.raises(ValueError, match="shrink"):
        pad_hops(tflows, 2, 1)
