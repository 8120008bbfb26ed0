"""The plain versions of K5's and K6's backward passes and the two
``torch.autograd.Function``s around the kernels, on the CPU.

* ``kernels/ref.py::flash_attention_bwd_ref`` (P recomputed from the
  forward's log-sum-exp, ``delta = rowsum(do * o)``) against autograd of
  the plain forward and against ``jax.grad`` of ``repro.kernels.ref``'s
  attention with the same cotangent: causal, windowed, unmasked, GQA,
  T < S, float32 and bfloat16; its log-sum-exp against
  ``jax.nn.logsumexp`` of the masked scores;
* ``rmsnorm_bwd_ref`` (float32 statistics, dscale summed over the rows in
  row order) against autograd of ``rmsnorm_ref`` and ``jax.grad`` of
  ``repro.kernels.ref.rmsnorm_ref``;
* the bf16 K5 backward's and the K6 backward's sum orders spelled in
  torch (``test_torch_support.flash_bwd_in_k5_order``,
  ``rmsnorm_bwd_in_k6_order``: P and dS rounded once to bf16, dq's key
  tiles, dk and dv over chunks of the group's heads; K6's row sums and
  dscale's block runs) against the plain versions and ``jax.grad`` at the
  same bars, and the kernels' sources: the bf16 backward on ``wgmma``,
  no ``mma.sync`` and no float atomic in either backward;
* ``ops.flash_attention`` and ``ops.rmsnorm`` with inputs that require
  grad go through ``_FlashAttention`` and ``_RMSNorm`` (on the CPU their
  forward and backward run the plain versions), and their gradients match
  autograd of the plain forwards; without grad they return the plain
  forward with no graph.

Bars, each relative to the largest gradient (``test_torch_support.
rel_err``): float32 1e-5 (the same arithmetic summed in other orders;
measured at most 4.4e-7); bfloat16 2e-2, K5's bar (the gradients are
rounded to bfloat16, whose spacing is 2^-8 of a value, and autograd of
the plain forward takes delta from the unrounded output; measured at
most 6.9e-3).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_support as sup

sup.apply_jax_shim()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

F32_BAR, BF16_BAR = 1e-5, sup.BWD_BAR_BF16

FLASH_CASES = [
    # B, H, KV, T, S, D, causal, window
    (2, 4, 2, 16, 16, 16, True, 0),
    (1, 4, 2, 9, 21, 16, True, 0),         # T < S
    (1, 6, 3, 24, 24, 32, True, 5),        # windowed
    (2, 2, 1, 7, 13, 16, False, 0),        # unmasked, T < S
    (1, 4, 4, 12, 12, 8, True, 0),         # no grouping
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(arrays, dtype):
    """The arrays rounded once to ``dtype``, as JAX and torch values."""
    js = [jnp.asarray(a).astype(dtype) for a in arrays]
    ts = [torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name)) for j in js]
    return js, ts


def _rel(got, want):
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,KV,T,S,D,causal,window", FLASH_CASES)
def test_flash_attention_bwd_ref(B, H, KV, T, S, D, causal, window, dtype):
    bar = F32_BAR if dtype == jnp.float32 else BF16_BAR
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        sup.flash_bwd_inputs(B, H, KV, T, S, D, seed=T * S), dtype)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    # autograd of the plain forward
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(out, leaves, do)
    # jax.grad of repro's plain attention, cotangent do
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    jgrads = vjp(jdo)
    for name, g, a, j in zip(("dq", "dk", "dv"), got, auto, jgrads):
        assert _rel(g, a) <= bar, (name, "autograd", _rel(g, a))
        assert _rel(g, j) <= bar, (name, "jax", _rel(g, j))
    # the log-sum-exp of the masked scores
    s = jnp.einsum("bhtd,bhsd->bhts", jq.astype(jnp.float32),
                   jnp.repeat(jk, H // KV, axis=1).astype(jnp.float32)
                   ) / np.sqrt(D)
    qi, kj = np.arange(T)[:, None] + S - T, np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= kj <= qi
        if window:
            mask &= kj > qi - window
    want = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)
    np.testing.assert_allclose(_np(lse), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("N,D", [(7, 16), (40, 128), (3, 5120), (33, 200)])
def test_rmsnorm_bwd_ref(N, D, dtype):
    bar = F32_BAR if dtype == jnp.float32 else BF16_BAR
    x, s, dy = sup.rmsnorm_bwd_inputs(N, D, seed=N + D)
    (jx, jdy), (tx, tdy) = _both((x, dy), dtype)
    ts = torch.as_tensor(s)
    dx, ds = ref.rmsnorm_bwd_ref(tx, ts, tdy, eps=1e-6)
    assert dx.dtype == tx.dtype and ds.dtype == torch.float32
    leaves = [tx.detach().clone().requires_grad_(),
              ts.detach().clone().requires_grad_()]
    auto = torch.autograd.grad(ref.rmsnorm_ref(*leaves, eps=1e-6), leaves,
                               tdy)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, eps=1e-6), jx,
                     jnp.asarray(s))
    jgrads = vjp(jdy)
    for name, g, a, j in zip(("dx", "dscale"), (dx, ds), auto, jgrads):
        assert _rel(g, a) <= bar, (name, "autograd", _rel(g, a))
        assert _rel(g, j) <= bar, (name, "jax", _rel(g, j))


def test_rmsnorm_bwd_ref_sums_dscale_in_row_order():
    x, s, dy = (torch.as_tensor(a) for a in sup.rmsnorm_bwd_inputs(9, 32))
    _, ds = ref.rmsnorm_bwd_ref(x, s, dy)
    inv = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    rows = dy * x * inv
    acc = torch.zeros(32)
    for r in rows:
        acc = acc + r
    assert torch.equal(ds, acc)


@pytest.mark.parametrize("bf16", [False, True])
def test_autograd_functions_match_plain_autograd(bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    bar = BF16_BAR if bf16 else F32_BAR
    q, k, v, do = (torch.as_tensor(a).to(dt)
                   for a in sup.flash_bwd_inputs(2, 4, 2, 12, 12, 16, 3))
    x, s, dy = (torch.as_tensor(a) for a in sup.rmsnorm_bwd_inputs(6, 64))
    x, dy = x.to(dt), dy.to(dt)
    for causal, window in ((True, 0), (True, 4), (False, 0)):
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*a, causal=causal, window=window)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        got = torch.autograd.grad(out, a, do)
        want = torch.autograd.grad(
            ref.flash_attention_ref(*b, causal=causal, window=window), b, do)
        for g, w in zip(got, want):
            assert sup.rel_err(g, w) <= bar
    a = [t.clone().requires_grad_() for t in (x, s)]
    b = [t.clone().requires_grad_() for t in (x, s)]
    y = ops.rmsnorm(*a)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    got = torch.autograd.grad(y, a, dy)
    want = torch.autograd.grad(ref.rmsnorm_ref(*b), b, dy)
    for g, w in zip(got, want):
        assert sup.rel_err(g, w) <= bar
    # only one input requiring grad still builds the Function's graph
    y = ops.rmsnorm(x, s.clone().requires_grad_())
    assert y.grad_fn is not None


def test_ops_without_grad_are_the_plain_forward():
    q, k, v, _ = (torch.as_tensor(a)
                  for a in sup.flash_bwd_inputs(1, 2, 1, 5, 5, 16, 0))
    x, s, _ = (torch.as_tensor(a) for a in sup.rmsnorm_bwd_inputs(3, 16))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention_ref(q, k, v))
    with torch.no_grad():
        y = ops.rmsnorm(x, s.clone().requires_grad_())
    assert y.grad_fn is None and torch.equal(y, ref.rmsnorm_ref(x, s))


# B, H, KV, T, S, D, causal, window, query heads a dk/dv chunk (None: the
# whole group): FLASH_CASES, head dims 80, 96 and 256, a partial 64-row
# tile, and groups split over several chunks
K5_ORDER_CASES = [c + (None,) for c in FLASH_CASES] + [
    (1, 4, 2, 20, 20, 80, True, 0, None),       # stablelm-3b's D = 80
    (1, 4, 2, 33, 47, 96, True, 0, None),       # phi3-vision's D = 96
    (1, 2, 1, 40, 40, 256, True, 0, None),      # D = 256: 32-key dq tiles
    (1, 2, 1, 65, 65, 32, True, 0, None),       # T = 65: a partial tile
    (1, 10, 2, 40, 40, 32, True, 0, 2),         # G = 5 in chunks of 2
    (1, 8, 1, 70, 70, 16, True, 9, 3),          # MQA, a window, 3 chunks
    (1, 6, 2, 30, 50, 16, False, 0, 1),         # unmasked, T < S
]


@pytest.mark.parametrize("B,H,KV,T,S,D,causal,window,hpc", K5_ORDER_CASES)
def test_flash_bwd_in_k5_order(B, H, KV, T, S, D, causal, window, hpc):
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        sup.flash_bwd_inputs(B, H, KV, T, S, D, seed=T + S + D), jnp.bfloat16)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    got = sup.flash_bwd_in_k5_order(q, k, v, o, lse, do, causal=causal,
                                    window=window, hpc=hpc)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    jgrads = [torch.as_tensor(np.array(_np(j))) for j in vjp(jdo)]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
    for name, e, j in zip(("dq", "dk", "dv"), sup.bwd_errs(got, want),
                          sup.bwd_errs(got, jgrads)):
        assert e <= BF16_BAR, (name, "plain", e)
        assert j <= BF16_BAR, (name, "jax", j)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("N,D,sms", [(7, 16, 132), (40, 128, 132),
                                     (3, 5120, 132), (33, 200, 132),
                                     (300, 128, 4), (64, 2048, 4),
                                     (5, 5121, 132)])
def test_rmsnorm_bwd_in_k6_order(N, D, sms, dtype):
    bar = F32_BAR if dtype == jnp.float32 else BF16_BAR
    x, s, dy = sup.rmsnorm_bwd_inputs(N, D, seed=N + D)
    (jx, jdy), (tx, tdy) = _both((x, dy), dtype)
    ts = torch.as_tensor(s)
    dx, ds = sup.rmsnorm_bwd_in_k6_order(tx, ts, tdy, 1e-6, sms=sms)
    assert dx.dtype == tx.dtype and ds.dtype == torch.float32
    want = ref.rmsnorm_bwd_ref(tx, ts, tdy, eps=1e-6)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, eps=1e-6), jx,
                     jnp.asarray(s))
    for name, g, w, j in zip(("dx", "dscale"), (dx, ds), want, vjp(jdy)):
        assert _rel(g, w) <= bar, (name, "plain", _rel(g, w))
        assert _rel(g, j) <= bar, (name, "jax", _rel(g, j))


CSRC = Path(ref.__file__).resolve().parent.parent / "csrc"


def _kernel_body(src, name):
    """The text of ``__global__`` function ``name`` in ``src``."""
    start = re.search(rf"\n\s*{name}\(", src).start()
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("source,kernels,wgmma", [
    ("flash_attention.cu", ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"),
     True),
    ("rmsnorm.cu", ("rmsnorm_bwd_kernel",), False)])
def test_backward_sources_use_wgmma_and_no_float_atomic(source, kernels,
                                                         wgmma):
    """The bf16 K5 backward computes its products with ``wgmma`` and no
    ``mma.sync``; neither backward takes an atomic but on its integer
    counters."""
    src = (CSRC / source).read_text()
    if wgmma:
        assert "wgmma.mma_async" in src
        assert "flash_bwd_dq_mma" not in src and "flash_bwd_dkv_mma" not in src
    for name in kernels:
        body = _kernel_body(src, name)
        if wgmma:
            assert "wgmma_ss(" in body and "wgmma_rs(" in body, name
            assert "mma16816" not in body, name
        for call in re.findall(r"atomic\w*\(([^,]*),", body):
            assert "count" in call, (name, call)
