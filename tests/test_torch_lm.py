"""The port's LM serving path (``repro_torch.configs``, ``models``,
``serve``) against ``repro``'s on the CPU, at the REDUCED qwen3-14b size
(2 layers, d_model 64, 4 heads over 2 kv heads, head_dim 16).

The params are ``repro``'s (``init_params`` with ``jax.random.key(0)``)
carried across with ``params_from_numpy``; prompts and tokens are drawn
with numpy from a seed. On the CPU the port's K5 and K6 calls run their
plain versions (``kernels/ref.py``).

Two bars for the whole slice:

* **tight**: against ``repro`` with its causal self-attention computed
  the K5 way (``_sdpa`` patched inside the test: float32 scores and
  float32 softmax over the mask, out in the compute dtype; the port's
  attention is K5, which keeps both in float32 where ``_sdpa`` rounds
  them to bfloat16). In bfloat16 the two still differ where XLA's and
  PyTorch's float32 sums inside a bfloat16 product round the other way
  (about 0.03% of a projection's outputs), and those flips propagate
  through the layers: measured at most 0.044 on the logits (max |logit|
  3.5, where bfloat16's spacing is 1/64) and 0.031 on the cache, mean at
  most 0.0076 and 0.0019. Held to 0.0625 (four of those spacings) max and
  0.01 mean. With float32 compute there is no bfloat16 rounding to flip:
  measured 4.6e-6, held to 1e-4. Greedy ``decode_loop`` tokens are equal
  in float32 compute; in bfloat16, up to the first step where the
  reference's own top two logits are within the tight bar (its logits
  are bfloat16 values, and its top two tie exactly at some steps).
* **loose**: against ``repro`` as it stands, whose ``_sdpa`` rounds the
  scores and softmax weights to bfloat16. Measured at most 0.055 on the
  logits; held to 0.1. Greedy tokens are not compared here.

Each layer function is held to its ``repro.models.layers`` twin on the
same inputs: bit for bit where both compute alike, within one bfloat16
ulp where a bfloat16 product sums in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_support as sup

sup.apply_jax_shim()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.models.layers as JL  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import lm_specs as j_lm_specs  # noqa: E402
from repro.models.lm import lm_decode_step as j_decode  # noqa: E402
from repro.models.lm import lm_prefill as j_prefill  # noqa: E402
from repro.serve import cache_bytes as j_cache_bytes  # noqa: E402
from repro.serve import cache_specs as j_cache_specs  # noqa: E402
from repro.serve import decode_loop as j_decode_loop  # noqa: E402

import repro_torch.models.layers as TL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.models.lm import lm_decode_step, lm_prefill  # noqa: E402

ARCH = "qwen3-14b"
B, P, CACHE, DECODE_STEPS, GREEDY_STEPS = 4, 24, 40, 8, 12
TIGHT_MAX, TIGHT_MEAN = sup.LM_TIGHT_MAX, sup.LM_TIGHT_MEAN
LOOSE_MAX, F32_MAX = 0.1, 1e-4
BF16_ULP = 2.0 ** -7          # relative spacing of bfloat16 near 1


def sdpa_k5(q, k, v, mask, cfg):
    """``repro``'s ``_sdpa`` computed the K5 way: float32 scores and
    softmax over the mask, out in q's dtype."""
    Bq, T, H, Dh = q.shape
    KV = k.shape[2]
    qf = q.reshape(Bq, T, KV, H // KV, Dh).astype(jnp.float32)
    s = jnp.einsum("btkgh,bskh->bkgts", qf,
                   k.astype(jnp.float32)) * (1.0 / np.sqrt(Dh))
    if mask.ndim == 2:
        mask = mask[None, None, None]
    elif mask.ndim == 3:
        mask = mask[:, None, None]
    w = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    out = jnp.einsum("bkgts,bskh->btkgh", w, v.astype(jnp.float32))
    return out.astype(q.dtype).reshape(Bq, T, H * Dh)


@pytest.fixture(scope="module")
def model():
    cfg = j_reduced(ARCH)
    params = j_init(j_lm_specs(cfg), jax.random.key(0))
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    return cfg, tconfigs.reduced_config(ARCH), params, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype=jnp.bfloat16):
    """The same values as a JAX array and a torch tensor (rounded once, by
    JAX, to ``dtype``)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.as_tensor(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, jnp.dtype(dtype).name))


def _diff(want, got):
    d = np.abs(_np(want) - _np(got))
    return float(d.max()), float(d.mean())


# -------------------------------------------------------------------------
# configs and specs
# -------------------------------------------------------------------------

def _spec_table(tree, is_leaf):
    out = {}

    def walk(t, path):
        if is_leaf(t):
            out[path] = (tuple(t.shape), str(t.dtype), tuple(t.axes), t.init,
                         float(t.scale))
        else:
            for k in t:
                walk(t[k], path + (k,))
    walk(tree, ())
    return out


def test_configs_and_specs_match_jax(model):
    from repro.configs import get_config, padded_vocab
    from repro.models import num_bytes, num_params
    from repro.models.spec import is_spec
    for get, tget in ((get_config, tconfigs.get_config),
                      (j_reduced, tconfigs.reduced_config)):
        jc, tc = get(ARCH), tget(ARCH)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.pattern_groups == tc.pattern_groups
        js, ts = j_lm_specs(jc), tmodels.lm_specs(tc)
        assert _spec_table(js, is_spec) == _spec_table(ts, tmodels.is_spec)
        assert num_params(js) == tmodels.num_params(ts)
        assert num_bytes(js) == tmodels.num_bytes(ts)
        assert _spec_table(j_cache_specs(jc, 4, 544), is_spec) == \
            _spec_table(tserve.cache_specs(tc, 4, 544), tmodels.is_spec)
        assert j_cache_bytes(jc, 4, 544) == tserve.cache_bytes(tc, 4, 544)
    assert tmodels.num_params(tmodels.lm_specs(
        tconfigs.get_config(ARCH))) == 14_768_307_200
    assert tconfigs.padded_vocab(151936) == padded_vocab(151936)
    assert tconfigs.canon("qwen3-14b") == "qwen3_14b"


@pytest.mark.parametrize("arch", ["whisper_large_v3", "phi3_vision_4_2b"])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="item 15"):
        tconfigs.get_config(arch)
    with pytest.raises(NotImplementedError, match="item 15"):
        tconfigs.reduced_config(arch)


def test_unported_configurations_raise(model):
    _, tcfg, _, tparams = model
    for change in ({"pattern": ("dec",)}, {"pattern": ("enc",)},
                   {"gated_mlp": False}, {"learned_pos": True},
                   {"enc_layers": 2}, {"num_image_tokens": 4}):
        cfg = dataclasses.replace(tcfg, **change)
        with pytest.raises(NotImplementedError, match="item 15"):
            tmodels.lm_specs(cfg)
        with pytest.raises(NotImplementedError, match="item 15"):
            tserve.cache_specs(cfg, 1, 8)
        with pytest.raises(NotImplementedError, match="item 15"):
            lm_prefill(tparams, {"tokens": torch.zeros(1, 2, dtype=torch.long)},
                       cfg, 4)
    with pytest.raises(NotImplementedError, match="item 15"):
        tserve.decode_loop(tparams, tcfg, torch.zeros(1, 2, dtype=torch.long),
                           2, extras={"enc_feats": None})


def test_init_params_and_cache_on_device(model):
    _, tcfg, _, _ = model
    specs = tmodels.lm_specs(tcfg)
    a = tmodels.init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = tmodels.init_params(specs, torch.Generator().manual_seed(3), "cpu")
    table = _spec_table(specs, tmodels.is_spec)
    for path, (shape, dtype, _, init, scale) in table.items():
        x, y = a, b
        for k in path:
            x, y = x[k], y[k]
        assert tuple(x.shape) == shape and str(x.dtype) == f"torch.{dtype}"
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        if init == "ones":
            assert bool((x == 1).all())
        elif init == "normal" and x.numel() > 1000:
            assert abs(float(x.std()) / scale - 1.0) < 0.05
    cache = tserve.init_cache(tcfg, 2, 16, device="cpu")
    assert cache["b0_attn"]["k"].dtype == torch.bfloat16
    assert tuple(cache["b0_attn"]["k"].shape) == (2, 2, 16, 2, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodels.init_params(specs, torch.Generator(), "cuda")


def test_from_numpy_carries_bfloat16_bit_for_bit():
    rng = np.random.default_rng(0)
    j = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    t = tmodels.cache_from_numpy({"a": {"k": np.asarray(j)}}, "cpu")["a"]["k"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), _np(j))
    f = tmodels.params_from_numpy({"w": np.arange(4, dtype=np.float32)},
                                  "cpu")["w"]
    assert f.dtype == torch.float32 and f.tolist() == [0.0, 1.0, 2.0, 3.0]


# -------------------------------------------------------------------------
# layer functions against their repro twins
# -------------------------------------------------------------------------

def _block(params, tparams, g=0):
    bp = jax.tree.map(lambda a: a[g], params["blocks"]["b0_attn"])
    tbp = {k: {kk: vv[g] for kk, vv in v.items()}
           for k, v in tparams["blocks"]["b0_attn"].items()}
    return bp, tbp


def _x(cfg, T=24, seed=0):
    rng = np.random.default_rng(seed)
    return _pair(rng.standard_normal((B, T, cfg.d_model)).astype(np.float32))


def test_norms_match_jax(model):
    cfg, tcfg, params, tparams = model
    bp, tbp = _block(params, tparams)
    jx, tx = _x(cfg)
    np.testing.assert_array_equal(
        _np(TL.norm_apply(tbp["ln1"], tx, "rmsnorm")),
        _np(JL.norm_apply(bp["ln1"], jx, "rmsnorm")))
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng.standard_normal((B, 24, 4, 16)).astype(np.float32))
    np.testing.assert_array_equal(
        _np(TL._rms(tq, tbp["attn"]["q_norm"])),
        _np(JL._rms(jq, bp["attn"]["q_norm"])))


@pytest.mark.parametrize("frac,theta", [(1.0, 1e6), (0.25, 1e4)])
def test_rope_matches_jax(frac, theta):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng.standard_normal((B, 24, 4, 16)).astype(np.float32))
    pos = np.arange(7, 31)[None]
    np.testing.assert_array_equal(
        _np(TL.rope(tq, torch.as_tensor(pos), frac, theta)),
        _np(JL.rope(jq, jnp.asarray(pos), frac, theta)))


def test_qkv_mlp_embed_unembed_match_jax(model):
    cfg, tcfg, params, tparams = model
    bp, tbp = _block(params, tparams)
    jx, tx = _x(cfg, seed=4)
    pos = np.arange(24)[None]
    got = TL._qkv(tbp["attn"], tx, tcfg, torch.as_tensor(pos))
    want = JL._qkv(bp["attn"], jx, jx, cfg, jnp.asarray(pos),
                   jnp.asarray(pos))
    for g, w in zip(got, want):     # bf16 products: one ulp of slack
        np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_ULP, atol=1e-6)
    np.testing.assert_allclose(_np(TL.mlp_apply(tbp["mlp"], tx, tcfg)),
                               _np(JL.mlp_apply(bp["mlp"], jx, cfg)),
                               rtol=BF16_ULP, atol=1e-6)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 24))
    np.testing.assert_array_equal(
        _np(TL.embed_apply(tparams["embed"], torch.as_tensor(tokens), tcfg)),
        _np(JL.embed_apply(params["embed"], jnp.asarray(tokens), cfg)))
    got = TL.unembed_apply(tparams["embed"], tx, tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        _np(got), _np(JL.unembed_apply(params["embed"], jx, cfg)),
        rtol=BF16_ULP, atol=1e-6)


def test_sdpa_matches_jax(model):
    """The port's plain ``_sdpa`` (``repro``'s bfloat16 roundings) against
    ``repro``'s, causal and with a [B,T,S] mask."""
    cfg, tcfg, _, _ = model
    rng = np.random.default_rng(6)
    jq, tq = _pair(rng.standard_normal((B, 12, 4, 16)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((B, 12, 2, 16)).astype(np.float32))
    jv, tv = _pair(rng.standard_normal((B, 12, 2, 16)).astype(np.float32))
    causal = np.tril(np.ones((12, 12), bool))
    masks = (causal, np.broadcast_to(rng.random((B, 12, 12)) < 0.7,
                                     (B, 12, 12)) | np.eye(12, dtype=bool))
    for m in masks:
        np.testing.assert_allclose(
            _np(TL._sdpa(tq, tk, tv, torch.as_tensor(np.array(m)), tcfg)),
            _np(JL._sdpa(jq, jk, jv, jnp.asarray(m), cfg)),
            rtol=BF16_ULP, atol=1e-6)


def test_attention_matches_jax_k5_way(model, monkeypatch):
    """attn_forward (prefill) and attn_decode against ``repro``'s with the
    K5-way ``_sdpa``: the new cache entries bit for bit in the projection
    slack, the outputs within one bfloat16 ulp."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    cfg, tcfg, params, tparams = model
    bp, tbp = _block(params, tparams)
    jx, tx = _x(cfg, seed=7)
    jy, (jk, jv) = JL.attn_forward(bp["attn"], jx, cfg, return_kv=True)
    ty, (tk, tv) = TL.attn_forward(tbp["attn"], tx, tcfg, return_kv=True)
    for g, w in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_ULP, atol=1e-6)
    S = 30
    ck = np.zeros((B, S, 2, 16), np.float32)
    ck[:, :24] = _np(jk)
    cv = np.zeros((B, S, 2, 16), np.float32)
    cv[:, :24] = _np(jv)
    (jck, tck), (jcv, tcv) = _pair(ck), _pair(cv)
    jx1, tx1 = _x(cfg, T=1, seed=8)
    jy, jck, jcv = JL.attn_decode(bp["attn"], jx1, jck, jcv, 24, cfg)
    ty, tck, tcv = TL.attn_decode(tbp["attn"], tx1, tck, tcv, 24, tcfg)
    for g, w in ((ty, jy), (tck, jck), (tcv, jcv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_ULP, atol=1e-6)


# -------------------------------------------------------------------------
# the slice: prefill, teacher-forced decode, greedy decode_loop
# -------------------------------------------------------------------------

def _prompt_and_tokens(cfg, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(
                np.int32))


def _run_both(cfg, tcfg, params, tparams):
    """Prefill + DECODE_STEPS teacher-forced steps through both packages.
    Returns [(what, jax result, port result)]."""
    prompt, toks = _prompt_and_tokens(cfg)
    out = []
    jl, jc = j_prefill(params, {"tokens": jnp.asarray(prompt)}, cfg, CACHE)
    tl, tc = lm_prefill(tparams, {"tokens": torch.as_tensor(prompt)}, tcfg,
                        CACHE)
    out.append(("prefill logits", jl, tl))
    for n in ("k", "v"):       # the port's decode writes its cache in place
        out.append((f"prefill cache {n}", jc["b0_attn"][n],
                    tc["b0_attn"][n].clone()))
    for i in range(DECODE_STEPS):
        jl, jc = j_decode(params, jnp.asarray(toks[:, i:i + 1]), jc,
                          jnp.int32(P + i), cfg)
        tl, tc = lm_decode_step(tparams, torch.as_tensor(toks[:, i:i + 1]),
                                tc, P + i, tcfg)
        out.append((f"decode {i} logits", jl, tl))
    for n in ("k", "v"):
        out.append((f"final cache {n}", jc["b0_attn"][n], tc["b0_attn"][n]))
    return out


def test_slice_tight_bar(model, monkeypatch):
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    cfg, tcfg, params, tparams = model
    for what, want, got in _run_both(cfg, tcfg, params, tparams):
        assert _np(got).shape == _np(want).shape, what
        dmax, dmean = _diff(want, got)
        assert dmax <= TIGHT_MAX and dmean <= TIGHT_MEAN, \
            f"{what}: max {dmax} mean {dmean}"


def test_slice_tight_bar_float32_compute(model, monkeypatch):
    """With float32 compute there is no bfloat16 rounding to flip: the
    port equals the K5-way JAX model to float32 summation order."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    cfg, tcfg, params, tparams = model
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    for what, want, got in _run_both(cfg, tcfg, params, tparams):
        dmax, _ = _diff(want, got)
        assert dmax <= F32_MAX, f"{what}: max {dmax}"


def _greedy_margins(params, cfg, prompt, tokens):
    """The reference's top-1 minus top-2 logit at each step of its own
    greedy path ``tokens`` [B, GREEDY_STEPS] (prefill, then teacher-forced
    decode steps)."""
    lg, cache = j_prefill(params, {"tokens": jnp.asarray(prompt)}, cfg,
                          CACHE)
    out = []
    for i in range(GREEDY_STEPS):
        top = np.sort(_np(lg[:, 0]), axis=-1)
        out.append(top[:, -1] - top[:, -2])
        if i + 1 < GREEDY_STEPS:
            lg, cache = j_decode(params, jnp.asarray(tokens[:, i:i + 1]),
                                 cache, jnp.int32(P + i), cfg)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_slice_greedy_tokens_equal_k5_way(model, monkeypatch, compute):
    """``decode_loop``'s greedy tokens against ``repro``'s K5-way
    ``decode_loop``, 4 prompts x 12 steps. In float32 compute they are
    equal. In bfloat16 the reference's logits are bfloat16 values (spacing
    1/64 near |logit| 3) and its top two tie exactly at some steps, where
    the argmax follows rounding noise within the tight bar; there the
    tokens are equal up to the first step at which the reference's top-1
    margin is within the tight bar (after it the contexts differ)."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    cfg, tcfg, params, tparams = model
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    tcfg = dataclasses.replace(tcfg, compute_dtype=compute)
    prompt, _ = _prompt_and_tokens(cfg, seed=12)
    want = np.asarray(j_decode_loop(params, cfg, jnp.asarray(prompt),
                                    GREEDY_STEPS, cache_len=CACHE))
    got = tserve.decode_loop(tparams, tcfg, torch.as_tensor(prompt),
                             GREEDY_STEPS, cache_len=CACHE).numpy()
    assert got.shape == (B, GREEDY_STEPS)
    if compute == "float32":
        np.testing.assert_array_equal(got, want)
        return
    margins = _greedy_margins(params, cfg, prompt, want)
    for b in range(B):
        bad = np.flatnonzero(got[b] != want[b])
        if bad.size:
            f = int(bad[0])
            assert margins[b, f] <= TIGHT_MAX, \
                f"row {b} step {f}: {got[b]} vs {want[b]}, reference " \
                f"margin {margins[b, f]}"


def test_slice_loose_bar(model):
    cfg, tcfg, params, tparams = model
    for what, want, got in _run_both(cfg, tcfg, params, tparams):
        if "logits" in what:
            dmax, _ = _diff(want, got)
            assert dmax <= LOOSE_MAX, f"{what}: max {dmax}"


def test_step_builders_and_sampling(model):
    _, tcfg, _, tparams = model
    prompt, toks = _prompt_and_tokens(tcfg, seed=13)
    prompt = torch.as_tensor(prompt)
    lg, cache = tserve.make_prefill_step(tcfg, CACHE)(
        tparams, {"tokens": prompt})
    full = tserve.make_forward(tcfg)(tparams, {"tokens": prompt})
    assert tuple(full.shape) == (B, P, tcfg.vocab_size)
    torch.testing.assert_close(lg[:, 0], full[:, -1], rtol=0, atol=TIGHT_MAX)
    lg2, _ = tserve.make_serve_step(tcfg)(
        tparams, torch.as_tensor(toks[:, :1]), cache, P)
    assert tuple(lg2.shape) == (B, 1, tcfg.vocab_size)
    assert bool(torch.isfinite(lg2).all())
    runs = [tserve.decode_loop(tparams, tcfg, prompt, 6, temperature=0.8,
                               generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert bool((runs[0] < tcfg.vocab_size).all())
    assert not torch.equal(runs[0], runs[2])
