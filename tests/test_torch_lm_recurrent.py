"""The port's recurrent and state-space architectures (recurrentgemma-2b:
RG-LRU ``"rec"`` blocks and sliding-window ``"local"`` attention with a
ring cache; mamba2-130m: ``"ssm"`` blocks, the chunked SSD) against
``repro`` on the CPU, at their REDUCED sizes (recurrentgemma: 6 layers
of the pattern rec, rec, local, d_model 64, window 8; mamba2: 2 layers,
d_model 64, 8 heads of 16, state 16).

The weights are drawn with numpy from a seed
(``test_torch_support.numpy_params``) and carried into both packages;
prompts and tokens are numpy draws. ``repro`` runs compiled
(``jax.jit``), its attention computed the K5 way
(``test_torch_lm.sdpa_k5``), as ``tests/test_torch_lm_archs.py`` does.
Sequences: recurrentgemma's forward at T = 24 (three windows), its
prompt of 5 decoded past the ring's wrap at 8, and of 12 (the ring
wrapped in the prefill) for the greedy tokens; mamba2's at T = 300 (two
chunks of ``CHUNK`` = 256, the second padded). Bars:

* **the model** (forward logits, prefill, teacher-forced decode, every
  cache leaf with its shape and dtype): 1e-4 with float32 compute;
  ``LM_TIGHT_MAX`` / ``LM_TIGHT_MEAN`` with bfloat16. Greedy tokens as
  ``tests/test_torch_lm.py`` holds them.
* **one train step** against ``repro``'s jitted step:
  ``test_torch_train.py::test_train_step_matches_jitted_repro``'s bars.
* **bit for bit**: ``rglru_scan`` (``jax.lax.associative_scan``'s
  recursion with its fused multiply-adds) with and without ``h0``; the
  depthwise conv in bfloat16 (and in float32); the SSD's cumulative sum
  (``ssm._cumsum``, XLA:CPU's order); the RG-LRU gates in bfloat16.
* **the float32 transcendentals** (ROADMAP.md, Queue 3 fault 7): the
  gates' ``sigmoid``, ``softplus`` and ``exp`` and the SSD's decays are
  torch's; ``_gates`` in float32 and ``ssd_chunked`` (chunk 8, several
  chunks) are held to ``repro``'s within ``FAULT7_REL`` of the largest
  value.
* **the ring decode**'s attention against ``repro``'s ``attn_decode``
  (K5 way) at an index below, at and past the window; the windowed
  backward's plain version (``kernels/ref.py::flash_attention_bwd_ref``)
  against ``jax.grad`` of ``repro``'s ``_sdpa`` with the ``"local"``
  mask.

``repro`` compiles its model paths in a layer scan, where XLA:CPU keeps
a bfloat16 sum read back as float32 unrounded (Ground rules): the norm
after a residual add reads the float32 sum, which the port follows
(``models/lm.py::_add``), and the gated norm's product
(``ssm._rmsnorm_gated``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_support as sup

sup.apply_jax_shim()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.models.layers as JL  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.models import lm_specs as j_lm_specs  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.lm import lm_decode_step as j_decode  # noqa: E402
from repro.models.lm import lm_forward as j_forward  # noqa: E402
from repro.models.lm import lm_prefill as j_prefill  # noqa: E402
from repro.models.spec import is_spec as j_is_spec  # noqa: E402
from repro.serve import cache_bytes as j_cache_bytes  # noqa: E402
from repro.serve import cache_specs as j_cache_specs  # noqa: E402
from repro.serve import decode_loop as j_decode_loop  # noqa: E402

from test_torch_lm import _spec_table, sdpa_k5  # noqa: E402

import repro_torch.models.layers as TL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.lm import (lm_decode_step, lm_forward,  # noqa: E402
                                   lm_prefill)
from repro_torch.models.spec import _leaves  # noqa: E402

ARCHS = ["recurrentgemma_2b", "mamba2_130m"]
TIGHT_MAX, TIGHT_MEAN = sup.LM_TIGHT_MAX, sup.LM_TIGHT_MEAN
F32_MAX = 1e-4
PARAM_SEED = 5
B = 2
# forward length, prompt, teacher-forced decode steps, greedy prompt
SHAPES = {"recurrentgemma_2b": dict(T=24, P=5, steps=8, greedy_P=12),
          "mamba2_130m": dict(T=300, P=300, steps=4, greedy_P=12)}
GREEDY_STEPS = 8
# Queue 3 fault 7: the float32 transcendentals' share of the largest
# value (measured at most 3e-7 for the gates and 2e-7 for the SSD)
FAULT7_REL = 2e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(arch, compute="bfloat16"):
    j = dataclasses.replace(jconfigs.reduced_config(arch),
                            compute_dtype=compute)
    return j, tconfigs.ModelConfig(**dataclasses.asdict(j))


def _params(arch, seed=PARAM_SEED):
    """numpy params of the REDUCED config, and both packages' trees."""
    tree = sup.numpy_params(tmodels.lm_specs(_cfgs(arch)[1]), seed)
    return (tree, jax.tree.map(jnp.asarray, tree),
            tmodels.params_from_numpy(tree, "cpu"))


def _pair(a, dtype=jnp.float32):
    """The same values as a JAX array and a torch tensor (rounded once, by
    JAX, to ``dtype``)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.as_tensor(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, jnp.dtype(dtype).name))


def _bits_equal(want, got, what=""):
    w, g = _np(want), _np(got)
    assert w.shape == g.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _rel(want, got):
    w, g = _np(want), _np(got)
    return float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))


# -------------------------------------------------------------------------
# configs, specs, caches
# -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_repro(arch):
    from repro.models import num_bytes, num_params
    for get, tget in ((jconfigs.get_config, tconfigs.get_config),
                      (jconfigs.reduced_config, tconfigs.reduced_config)):
        jc, tc = get(arch), tget(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        js, ts = j_lm_specs(jc), tmodels.lm_specs(tc)
        assert _spec_table(js, j_is_spec) == _spec_table(ts, tmodels.is_spec)
        assert num_params(js) == tmodels.num_params(ts)
        assert num_bytes(js) == tmodels.num_bytes(ts)
        for cache_len in (6, 40, 5000):     # below and past the window
            assert _spec_table(j_cache_specs(jc, 2, cache_len),
                               j_is_spec) == \
                _spec_table(tserve.cache_specs(tc, 2, cache_len),
                            tmodels.is_spec)
            assert j_cache_bytes(jc, 2, cache_len) == \
                tserve.cache_bytes(tc, 2, cache_len)
    assert arch in tconfigs.PORTED
    full = tmodels.num_params(tmodels.lm_specs(tconfigs.get_config(arch)))
    assert full == {"recurrentgemma_2b": 2_673_297_920,
                    "mamba2_130m": 129_100_224}[arch]


def test_init_params_leaves_of_new_kinds():
    """``init_params`` draws the rec and ssm leaves with their declared
    inits and dtypes: ``lam``, ``a_log``, ``dt_bias`` and ``d_skip`` in
    float32 inside a bfloat16 tree, the constants and ones as declared,
    the block-diagonal gates [nb, bs, bs] at their fan-in scale."""
    for arch in ARCHS:
        cfg = dataclasses.replace(tconfigs.reduced_config(arch),
                                  param_dtype="bfloat16")
        p = tmodels.init_params(tmodels.lm_specs(cfg),
                                torch.Generator().manual_seed(0), "cpu")
        if arch == "recurrentgemma_2b":
            rec = p["blocks"]["b0_rec"]["rec"]
            assert rec["lam"].dtype == torch.float32
            assert bool((rec["lam"] == 0.08).all())
            assert rec["w_a"].dtype == torch.bfloat16
            assert tuple(rec["w_a"].shape) == (2, 16, 4, 4)
            assert not bool(rec["conv_b"].any())
            assert abs(float(rec["w_a"].float().std()) * 2 - 1) < 0.1
            assert "attn" in p["blocks"]["b2_local"]
        else:
            ssm = p["blocks"]["b0_ssm"]["ssm"]
            assert {k: ssm[k].dtype for k in ("a_log", "dt_bias", "d_skip")} \
                == dict.fromkeys(("a_log", "dt_bias", "d_skip"),
                                 torch.float32)
            assert bool((ssm["a_log"] == 0.5).all())
            assert not bool(ssm["dt_bias"].any())
            assert bool((ssm["d_skip"] == 1).all())
            assert bool((ssm["norm"] == 1).all())
            assert "mlp" not in p["blocks"]["b0_ssm"]


# -------------------------------------------------------------------------
# RG-LRU: the scan, the conv, the gates
# -------------------------------------------------------------------------

@pytest.mark.parametrize("S", [37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_repro_bitwise(S, with_h0):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 48)).astype(np.float32)
    b = rng.standard_normal((2, S, 48)).astype(np.float32)
    h0 = rng.standard_normal((2, 48)).astype(np.float32) if with_h0 else None
    want = jax.jit(JR.rglru_scan)(a, b, None if h0 is None
                                  else jnp.asarray(h0))
    got = TR.rglru_scan(torch.as_tensor(a), torch.as_tensor(b),
                        None if h0 is None else torch.as_tensor(h0))
    _bits_equal(want, got)


def test_rglru_decode_update_matches_repro_bitwise():
    """``a * h + b`` as XLA:CPU fuses it (``rglru._fma``)."""
    rng = np.random.default_rng(0)
    a, h, b = (rng.standard_normal((4, 4096)).astype(np.float32)
               for _ in range(3))
    want = jax.jit(lambda a, h, b: a * h + b)(a, h, b)
    got = TR._fma(*(torch.as_tensor(x) for x in (a, h, b)))
    _bits_equal(want, got)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_repro_bitwise(dtype, with_state):
    """The depthwise causal conv (the RG-LRU's, and the SSD's with its
    SiLU) and the conv tail it hands on, bit for bit; but the SSD's
    output in float32 within ``FAULT7_REL``, where its SiLU's ``exp`` is
    torch's (fault 7)."""
    rng = np.random.default_rng(3)
    x, tx = _pair(rng.standard_normal((2, 9, 40)), dtype)
    w, tw = _pair(rng.standard_normal((4, 40)) * 0.5, dtype)
    bias, tb = _pair(rng.standard_normal(40) * 0.1, dtype)
    st, tst = (_pair(rng.standard_normal((2, 3, 40)), dtype) if with_state
               else (None, None))
    for jfn, tfn in ((JR._conv, TR._conv),
                     (JS._conv_forward, TS._conv_forward)):
        jo, js = jax.jit(jfn)(x, w, bias, st)
        to, ts = tfn(tx, tw, tb, tst)
        assert to.dtype == tx.dtype
        if tfn is TS._conv_forward and dtype == jnp.float32:
            assert _rel(jo, to) <= FAULT7_REL
        else:
            _bits_equal(jo, to, "out")
        _bits_equal(js, ts, "state")


def test_gates_match_repro():
    """``_gates`` against ``jax.jit(_gates)``: bit for bit in bfloat16
    compute, and within ``FAULT7_REL`` of the largest value in float32,
    where torch's ``sigmoid``, ``softplus`` and ``exp`` are not XLA:CPU's
    (fault 7)."""
    cfg = tconfigs.reduced_config("recurrentgemma_2b")
    tree = sup.numpy_params(TR.rglru_specs(cfg), 2)
    rng = np.random.default_rng(4)
    for cd in (jnp.bfloat16, jnp.float32):
        xb, txb = _pair(rng.standard_normal((2, 12, 64)), cd)
        jp = jax.tree.map(jnp.asarray, tree)
        tp = tmodels.params_from_numpy(tree, "cpu")
        ja, jg = jax.jit(lambda xb, p: JR._gates(xb, p, cd))(xb, jp)
        ta, tg = TR._gates(txb, tp, txb.dtype)
        assert ta.dtype == tg.dtype == torch.float32
        if cd == jnp.bfloat16:
            # the gate products round to bfloat16 before float32, so only
            # the transcendentals could differ: none do on these values
            assert _rel(ja, ta) <= FAULT7_REL and _rel(jg, tg) <= FAULT7_REL
        else:
            assert _rel(ja, ta) <= FAULT7_REL, _rel(ja, ta)
            assert _rel(jg, tg) <= FAULT7_REL, _rel(jg, tg)


# -------------------------------------------------------------------------
# SSD
# -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_cumsum_matches_repro_bitwise(dtype):
    """``ssm._cumsum`` against ``jax.jit(jnp.cumsum)``: one sequential
    prefix up to 16, two and three levels of blocks of 16 beyond,
    padded."""
    rng = np.random.default_rng(6)
    for n in (1, 5, 16, 17, 64, 256, 300, 5000):
        x, tx = _pair(rng.standard_normal((3, n, 2)) * 3.0, dtype)
        want = jax.jit(lambda v: jnp.cumsum(v, axis=1))(x)
        _bits_equal(want, TS._cumsum(tx, 1), f"n={n}")


def _ssd_inputs(b, s, h, p, g, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    a = -np.exp(np.full(h, 0.5))
    B_ = rng.standard_normal((b, s, g, n))
    C_ = rng.standard_normal((b, s, g, n))
    h0 = rng.standard_normal((b, h, p, n))
    return [_pair(v, dtype) for v in (x, dt, a, B_, C_, h0)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_repro(dtype, with_h0):
    """``ssd_chunked`` at chunk 8 over 37 steps (five chunks, the last
    padded) and at ``CHUNK``: in float32 within ``FAULT7_REL`` of the
    largest output (torch's ``exp``, fault 7); in bfloat16 within one
    bfloat16 spacing of each output (measured 0 to 1: the einsums sum in
    their own order)."""
    pairs = _ssd_inputs(2, 37, 4, 8, 1, 8, dtype)
    jx, tx = zip(*pairs)
    for chunk in (8, TS.CHUNK):
        kw = dict(chunk=chunk)
        jy, jf = jax.jit(lambda *a: JS.ssd_chunked(
            *a[:5], h0=a[5] if with_h0 else None, **kw))(*jx)
        ty, tf = TS.ssd_chunked(*tx[:5], h0=tx[5] if with_h0 else None,
                                **kw)
        assert ty.dtype == tf.dtype == tx[0].dtype
        assert ty.shape == (2, 37, 4, 8) and tf.shape == (2, 4, 8, 8)
        for what, w, g in (("y", jy, ty), ("state", jf, tf)):
            if dtype == jnp.float32:
                assert _rel(w, g) <= FAULT7_REL, (chunk, what, _rel(w, g))
            else:
                want = torch.as_tensor(_np(w))
                assert sup.bf16_ulps(g, want) <= 1.0, (chunk, what)


def test_ssd_decode_step_matches_repro():
    """One SSD decode step against ``repro``'s (float32: within
    ``FAULT7_REL``; bfloat16 bit for bit)."""
    rng = np.random.default_rng(9)
    for dtype in (jnp.float32, jnp.bfloat16):
        shapes = ((2, 4, 8, 8), (2, 4, 8), (2, 4), (4,), (2, 1, 8),
                  (2, 1, 8))
        vals = [rng.standard_normal(s) for s in shapes]
        vals[2] = np.log1p(np.exp(vals[2]))
        vals[3] = -np.exp(np.full(4, 0.5))
        jx, tx = zip(*(_pair(v, dtype) for v in vals))
        jy, js = jax.jit(JS.ssd_decode_step)(*jx)
        ty, ts = TS.ssd_decode_step(*tx)
        for w, g in ((jy, ty), (js, ts)):
            if dtype == jnp.float32:
                assert _rel(w, g) <= FAULT7_REL
            else:
                _bits_equal(w, g)


# -------------------------------------------------------------------------
# local attention: the ring decode, the windowed backward
# -------------------------------------------------------------------------

@pytest.mark.parametrize("index", [3, 7, 8, 20])
def test_ring_decode_matches_repro(monkeypatch, index):
    """``attn_decode(kind="local")`` against ``repro``'s (K5 way) at an
    index below, at and past the window of 8 (float32 compute): the
    output within 1e-5; the new k/v at slot index % S only, within 1e-5
    (their projections sum in their own order), every other slot bit for
    bit; with a cache shorter than the window (6 slots), too."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs("recurrentgemma_2b", "float32")
    tree = sup.numpy_params(TL.attn_specs(tc), 3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tmodels.params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(index)
    for S in (jc.window, 6):
        if S < jc.window and index >= S:
            continue                    # repro's cache_len bounds index
        x, tx = _pair(rng.standard_normal((2, 1, 64)))
        ring = rng.standard_normal((2, S, 1, 16))
        (jk, tk), (jv, tv) = _pair(ring), _pair(ring * 0.5)
        jy, jk2, jv2 = jax.jit(lambda p, x, k, v: JL.attn_decode(
            p, x, k, v, index, jc, "local"))(jp, x, jk, jv)
        ty, tk2, tv2 = TL.attn_decode(tp, tx, tk.clone(), tv.clone(), index,
                                      tc, "local")
        assert np.abs(_np(jy) - _np(ty)).max() <= 1e-5
        slot = index % S
        keep = [s for s in range(S) if s != slot]
        for j0, t0, j2, t2 in ((jk, tk, jk2, tk2), (jv, tv, jv2, tv2)):
            _bits_equal(j2[:, keep], t2[:, keep])
            _bits_equal(t0[:, keep], t2[:, keep])
            assert np.abs(_np(j2[:, slot]) - _np(t2[:, slot])).max() <= 1e-5
            assert not np.array_equal(_np(t0[:, slot]), _np(t2[:, slot]))


def test_windowed_backward_plain_matches_jax_grad():
    """``flash_attention_bwd_ref`` with a window against ``jax.grad`` of
    ``repro``'s ``_sdpa`` (float32) with the ``"local"`` mask, GQA 4 over
    2, T = 40 over a window of 9: within 1e-5 of each largest gradient."""
    B_, H, KV, T, D, w = 2, 4, 2, 40, 16, 9
    q, k, v, do = sup.flash_bwd_inputs(B_, H, KV, T, T, D, seed=1)
    cfg = dataclasses.replace(jconfigs.reduced_config("recurrentgemma_2b"),
                              compute_dtype="float32", window=w)
    mask = JL._self_mask("local", T, w)

    def out(q, k, v):                   # [B,T,H,D] layouts for _sdpa
        y = JL._sdpa(q, k, v, mask, cfg)
        return y.reshape(B_, T, H, D).transpose(0, 2, 1, 3)

    tr = (lambda a: jnp.asarray(a).transpose(0, 2, 1, 3))
    jo, vjp = jax.vjp(out, tr(q), tr(k), tr(v))
    jdq, jdk, jdv = (np.asarray(g).transpose(0, 2, 1, 3)
                     for g in vjp(jnp.asarray(do)))
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, window=w, return_lse=True)
    assert np.abs(o.numpy() - np.asarray(jo)).max() <= 1e-5
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=True,
                                      window=w)
    for want, g in zip((jdq, jdk, jdv), got):
        assert _rel(want, g) <= 1e-5


# -------------------------------------------------------------------------
# the model: forward, prefill + decode, greedy tokens, one train step
# -------------------------------------------------------------------------

def _hold(what, want, got, compute):
    w, g = _np(want), _np(got)
    assert w.shape == g.shape, what
    d = np.abs(w - g)
    if compute == "float32":
        assert float(d.max()) <= F32_MAX, f"{what}: max {d.max()}"
    else:
        assert float(d.max()) <= TIGHT_MAX and \
            float(d.mean()) <= TIGHT_MEAN, \
            f"{what}: max {d.max()} mean {d.mean()}"


def _tokens(cfg, shape, seed):
    tv = cfg.true_vocab or cfg.vocab_size
    return np.random.default_rng(seed).integers(0, tv, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _j_serve(cfg, cache_len):
    return (jax.jit(lambda p, tok: j_prefill(p, {"tokens": tok}, cfg,
                                             cache_len)),
            jax.jit(lambda p, tok, c, i: j_decode(p, tok, c, i, cfg)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_repro(monkeypatch, arch, compute):
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, compute)
    _, jp, tp = _params(arch)
    tok = _tokens(tc, (B, SHAPES[arch]["T"]), 1)
    want = jax.jit(lambda p, t: j_forward(p, {"tokens": t}, jc))(
        jp, jnp.asarray(tok))
    got = lm_forward(tp, {"tokens": torch.as_tensor(tok)}, tc, remat="none")
    assert got.dtype == torch.float32
    _hold("forward logits", want, got, compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_matches_repro(monkeypatch, arch, compute):
    """Prefill + teacher-forced decode steps (recurrentgemma's from a
    prompt of 5, through the ring's wrap at index 8): the logits of each
    forward, then every cache leaf after the prefill and after the last
    step, with its shape and dtype (the RG-LRU state in float32, the rest
    in the compute dtype, the ring at the window's size)."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, compute)
    _, jp, tp = _params(arch)
    P, steps = SHAPES[arch]["P"], SHAPES[arch]["steps"]
    cache_len = P + steps
    prompt, toks = _tokens(tc, (B, P), 11), _tokens(tc, (B, steps), 12)
    prefill, decode = _j_serve(jc, cache_len)
    jl, jcache = prefill(jp, jnp.asarray(prompt))
    tl, tcache = lm_prefill(tp, {"tokens": torch.as_tensor(prompt)}, tc,
                            cache_len)
    _hold("prefill logits", jl, tl, compute)

    def caches(when):
        assert sorted(jcache) == sorted(tcache)
        for key in jcache:
            assert sorted(jcache[key]) == sorted(tcache[key])
            for n in jcache[key]:
                j, t = jcache[key][n], tcache[key][n]
                assert str(t.dtype) == f"torch.{jnp.dtype(j.dtype).name}", \
                    (key, n)
                _hold(f"{when} cache {key} {n}", j, t, compute)
    caches("prefill")
    for i in range(steps):
        jl, jcache = decode(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.int32(P + i))
        tl, tcache = lm_decode_step(tp, torch.as_tensor(toks[:, i:i + 1]),
                                    tcache, P + i, tc)
        _hold(f"decode {i} logits", jl, tl, compute)
    caches("final")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_repro(monkeypatch, arch, compute):
    """``decode_loop``'s greedy tokens from a prompt of 12 (recurrentgemma's
    ring wrapped in the prefill), held as ``tests/test_torch_lm.py``
    holds them: equal, or in bfloat16 equal up to the first step where
    the reference's top two logits are within the tight bar; every token
    below the true vocabulary."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, compute)
    _, jp, tp = _params(arch)
    P = SHAPES[arch]["greedy_P"]
    prompt = _tokens(tc, (B, P), 13)
    cache_len = P + GREEDY_STEPS
    want = np.asarray(j_decode_loop(jp, jc, jnp.asarray(prompt),
                                    GREEDY_STEPS, cache_len=cache_len))
    got = tserve.decode_loop(tp, tc, torch.as_tensor(prompt), GREEDY_STEPS,
                             cache_len=cache_len).numpy()
    assert got.shape == (B, GREEDY_STEPS)
    assert int(got.max()) < (tc.true_vocab or tc.vocab_size)
    if compute == "float32" or np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)
        return
    prefill, decode = _j_serve(jc, cache_len)
    lg, cache = prefill(jp, jnp.asarray(prompt))
    tv = tc.true_vocab or tc.vocab_size
    for i in range(GREEDY_STEPS):
        top = np.sort(_np(lg[:, 0, :tv]), axis=-1)
        margin = top[:, -1] - top[:, -2]
        for b in range(B):
            if got[b, i] != want[b, i]:
                assert (got[b, :i] == want[b, :i]).all() and \
                    margin[b] <= TIGHT_MAX, (b, i, got[b], want[b])
                return
        lg, cache = decode(jp, jnp.asarray(want[:, i:i + 1]), cache,
                           jnp.int32(P + i))


TRAIN_TCFG = dict(microbatch=2, remat="full", lr=1e-2, warmup_steps=2,
                  total_steps=20)
# recurrentgemma's sequences hold three windows; mamba2's two chunks
TRAIN_SEQ = {"recurrentgemma_2b": 24, "mamba2_130m": 272}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_repro(monkeypatch, arch, compute):
    """From the same numpy params and fresh optimizer state, one step of
    ``make_train_step`` against ``repro``'s jitted one (microbatch 2, remat
    "full"), held as ``tests/test_torch_lm_archs.py`` holds the other
    architectures: loss, grad norm, lr and first moment within the bar
    (1e-4 in float32 compute, ``LM_TIGHT_MAX`` in bfloat16); the
    parameters within it wherever Adam's denominator is above 100 eps,
    else within the step's range 2 lr (1 + weight decay); every leaf
    moved."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, compute)
    tcfg = tconfigs.TrainConfig(**TRAIN_TCFG)
    jtcfg = jconfigs.TrainConfig(**TRAIN_TCFG)
    tree, jp, tp = _params(arch)
    batch = jtrain.SyntheticData(jc, jtrain.DataConfig(
        batch=4, seq=TRAIN_SEQ[arch])).batch_at(3)
    jp2, jo, jm = jax.jit(jtrain.make_train_step(jc, jtcfg))(
        jp, jtrain.init_opt(jp, jtcfg),
        {n: jnp.asarray(x) for n, x in batch.items()})
    tp2, to, tm = ttrain.make_train_step(tc, tcfg)(
        tp, ttrain.init_opt(tp, tcfg),
        {n: torch.as_tensor(x) for n, x in batch.items()})
    bar = F32_MAX if compute == "float32" else TIGHT_MAX
    assert int(to.step) == int(jo.step) == 1
    assert np.isfinite(float(tm["loss"]))
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= bar, \
            (k, float(tm[k]), float(jm[k]))
    for a, b in zip(jax.tree.leaves(jo.mu), _leaves(to.mu)):
        assert np.abs(_np(a) - _np(b)).max() <= bar
    c2 = 1.0 - tcfg.adam_b2
    span = 2 * float(jm["lr"]) * (1 + tcfg.weight_decay)
    moved = 0
    for a, b, v, p0 in zip(jax.tree.leaves(jp2), _leaves(tp2),
                           jax.tree.leaves(jo.nu), jax.tree.leaves(tree)):
        d = np.abs(_np(a) - _np(b))
        free = np.sqrt(_np(v) / c2) > 100 * 1e-8
        assert d[free].max(initial=0.0) <= bar
        assert d.max(initial=0.0) <= max(bar, span)
        moved += int((_np(b) != p0).any())
    assert moved == len(jax.tree.leaves(tree))
