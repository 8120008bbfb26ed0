"""The port's other dense and MoE architectures (llama3-405b, gemma-7b,
stablelm-3b, qwen3-moe-30b-a3b, granite-moe-3b-a800m) against ``repro``
on the CPU, at their REDUCED sizes (2 layers, d_model 64, head dims 16
and 32, 5 or 8 experts).

The weights are drawn with numpy from a seed
(``test_torch_support.numpy_params``) and carried into both packages
(``jax.tree.map(jnp.asarray, ...)``, ``params_from_numpy``); prompts and
tokens are numpy draws. ``repro``'s attention is computed the K5 way
(``test_torch_lm.sdpa_k5``) wherever the port's K5 path is compared, as
``tests/test_torch_lm.py`` does. Bars:

* **the slice** (prefill, teacher-forced decode, the cache): 1e-4 with
  float32 compute; ``LM_TIGHT_MAX`` / ``LM_TIGHT_MEAN`` with bfloat16.
  Greedy ``decode_loop`` tokens are equal in float32 compute and, in
  bfloat16, equal up to the first step where the reference's own top two
  logits are within the tight bar (``test_torch_lm``'s rule).
* **one train step** against ``repro``'s jitted step from the same numpy
  state: ``test_torch_train.py::test_train_step_matches_jitted_repro``'s
  bars; the MoE configs in bfloat16 with ``repro``'s router picks
  imposed (ROADMAP.md, Queue 3 fault 6, closed), and with their own
  picks, each router call within ``FAULT6_PICKS_MAX`` of ``repro``'s and
  the loss and grad norm within ``LM_TIGHT_MAX``. The global norm within
  16 float32 ulps of ``repro``'s (fault 5).
* **bit for bit** against ``repro``'s functions: GeGLU over every finite
  bfloat16 value (but the tiniest, whose results are subnormal); the
  embedding scale; the layernorm with bfloat16 in and out (float32
  statistics; with float32 in and out within 4 float32 ulps of the
  largest output, since XLA:CPU's ``rsqrt`` is its own); the router's picks, tied
  probabilities included; ``_moe_dispatch`` and ``_moe_combine`` at
  k = 8, with and without dropped picks; the gradient of the dispatch's
  token gather (each token's k rows added in sort order).
* **the MoE layer's input gradient** against ``jax.grad``: within 1e-5
  of the largest gradient with float32 compute.

``repro``'s model paths run their blocks in a compiled scan, where XLA
keeps a bfloat16 result that is read back as float32 unrounded; its
layer functions are compared compiled (``jax.jit``) where that matters
(the router), and its prefill and decode are compiled once per config.
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
from repro.models.lm import lm_decode_step as j_decode  # noqa: E402
from repro.models.lm import lm_prefill as j_prefill  # noqa: E402
from repro.models.spec import is_spec as j_is_spec  # noqa: E402
from repro.serve import cache_specs as j_cache_specs  # noqa: E402
from repro.serve import decode_loop as j_decode_loop  # noqa: E402

from test_torch_lm import _spec_table, sdpa_k5  # noqa: E402

import repro_torch.models.layers as TL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.models.lm import lm_decode_step, lm_prefill  # noqa: E402
from repro_torch.models.spec import _leaves  # noqa: E402

ARCHS = ["llama3_405b", "gemma_7b", "stablelm_3b", "qwen3_moe_30b_a3b",
         "granite_moe_3b_a800m"]
B, P, CACHE, DECODE_STEPS, GREEDY_STEPS = 2, 12, 24, 4, 8
TIGHT_MAX, TIGHT_MEAN = sup.LM_TIGHT_MAX, sup.LM_TIGHT_MEAN
F32_MAX = 1e-4
PARAM_SEED = 5


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


def _pair(a, dtype=jnp.bfloat16):
    """The same values as a JAX array and a torch tensor (rounded once, by
    JAX, to ``dtype``)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.as_tensor(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, jnp.dtype(dtype).name))


def _block_key(cfg):
    return f"b0_{cfg.pattern[0]}"


# -------------------------------------------------------------------------
# configs and specs
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
        assert _spec_table(j_cache_specs(jc, 2, 40), j_is_spec) == \
            _spec_table(tserve.cache_specs(tc, 2, 40), tmodels.is_spec)
    assert arch in tconfigs.PORTED


def test_init_params_leaves_of_new_kinds():
    """``init_params`` draws the new leaves with their declared inits: the
    layernorm's bias (zeros), the experts' [d, E, f] / [f, E, d] and the
    router (normal at the fan-in scale); a tied model has no unembed."""
    for arch in ("stablelm_3b", "granite_moe_3b_a800m"):
        cfg = tconfigs.reduced_config(arch)
        p = tmodels.init_params(tmodels.lm_specs(cfg),
                                torch.Generator().manual_seed(0), "cpu")
        blk = p["blocks"][_block_key(cfg)]
        if cfg.norm == "layernorm":
            assert not bool(blk["ln1"]["bias"].any())
            assert not bool(p["ln_f"]["bias"].any())
        else:
            assert tuple(blk["mlp"]["wd"].shape) == (
                2, cfg.moe_d_ff, cfg.num_experts, cfg.d_model)
            assert abs(float(blk["mlp"]["wg"].std()) * np.sqrt(64) - 1) < 0.05
        assert ("unembed" in p["embed"]) == (not cfg.tie_embeddings)


# -------------------------------------------------------------------------
# the layer functions, bit for bit
# -------------------------------------------------------------------------

def _all_bf16():
    """Every finite bfloat16 value, as float32, but those below 2^-120 in
    magnitude, whose activations come near the subnormal range (XLA:CPU
    flushes subnormal results to zero, torch does not)."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    return x[np.isfinite(x) & ((x == 0) | (np.abs(x) >= 2.0 ** -120))]


def test_gelu_matches_repro_bitwise():
    jx, tx = _pair(_all_bf16())
    np.testing.assert_array_equal(_np(TL._act(tx, "gelu")),
                                  _np(JL._act(jx, "gelu")))
    # SiLU's 1 / (1 + exp(-x)) is subnormal below x = -87
    keep = _np(jx) > -64
    np.testing.assert_array_equal(_np(TL._act(tx[keep], "silu")),
                                  _np(JL._act(jx[keep], "silu")))
    # float32: XLA:CPU's tanh is its own approximation (measured 5.8e-7)
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    jx, tx = _pair(x * 4, jnp.float32)
    np.testing.assert_allclose(_np(TL._act(tx, "gelu")),
                               _np(JL._act(jx, "gelu")), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("d_model", [64, 3072])
def test_embed_scale_matches_repro_bitwise(d_model):
    """gemma's sqrt(d_model) scale: exact at 64 (8), rounded to bfloat16
    at 3 072 (55.43 -> 55.5) as JAX rounds the Python float."""
    jc, tc = _cfgs("gemma_7b")
    jc = dataclasses.replace(jc, d_model=d_model)
    tc = dataclasses.replace(tc, d_model=d_model)
    rng = np.random.default_rng(1)
    table = (rng.standard_normal((jc.vocab_size, d_model)) * 0.5).astype(
        np.float32)
    tokens = rng.integers(0, jc.vocab_size, (B, 16))
    np.testing.assert_array_equal(
        _np(TL.embed_apply({"embedding": torch.as_tensor(table)},
                           torch.as_tensor(tokens), tc)),
        _np(JL.embed_apply({"embedding": jnp.asarray(table)},
                           jnp.asarray(tokens), jc)))


def _f32_ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("d", [64, 80])
def test_layernorm_matches_repro(d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((96, d)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jx, tx = _pair(x)
    np.testing.assert_array_equal(
        _np(TL.norm_apply(tp, tx, "layernorm")),
        _np(JL.norm_apply(jp, jx, "layernorm")))
    jx, tx = _pair(x, jnp.float32)
    want = _np(JL.norm_apply(jp, jx, "layernorm"))
    d = np.abs(_np(TL.norm_apply(tp, tx, "layernorm")) - want)
    assert d.max() <= 4 * np.spacing(np.abs(want).max())
    assert set(tmodels.layers.norm_specs(d, "layernorm", "float32")) == {
        "scale", "bias"}


def _moe_block(arch, seed=PARAM_SEED):
    tree, jp, tp = _params(arch, seed)
    key = _block_key(_cfgs(arch)[1])
    jb = jax.tree.map(lambda a: a[0], jp["blocks"][key]["mlp"])
    tb = {k: v[0] for k, v in tp["blocks"][key]["mlp"].items()}
    return jb, tb


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b",
                                  "granite_moe_3b_a800m"])
def test_router_picks_match_repro(arch):
    """The router's experts bit for bit, gates within 1e-6, against
    ``repro``'s router compiled (as its model runs it, inside a scan: XLA
    keeps the logits in float32): on random tokens, on zero tokens (every
    probability tied: the first k experts), and with three router columns
    equal (their probabilities tie exactly, the lower index first)."""
    jc, tc = _cfgs(arch)
    jb, tb = _moe_block(arch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((96, jc.d_model)).astype(np.float32)
    x[:8] = 0.0
    jx, tx = _pair(x)
    router = np.array(jb["router"])
    router[:, 3] = router[:, 1]
    router[:, 4] = router[:, 1]
    j_router = jax.jit(lambda r, xf: JL._router({"router": r}, xf, jc))
    for r in (np.array(jb["router"]), router):
        jg, je = j_router(jnp.asarray(r), jx)
        tg, te = TL._router({"router": torch.as_tensor(r)}, tx, tc)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-6, atol=0)
    assert te[:8].tolist() == [list(range(jc.experts_per_token))] * 8
    tied = (te == 1) | (te == 3) | (te == 4)
    assert int(tied.sum(-1).max()) >= 2


def _dispatch_inputs(n=64, E=16, k=8, d=32, seed=3):
    """Picks of k distinct experts of E per token (a random permutation's
    first k), float32 gates, bfloat16 tokens."""
    rng = np.random.default_rng(seed)
    eid = np.argsort(rng.random((n, E)), axis=-1)[:, :k].astype(np.int32)
    gate = rng.random((n, k)).astype(np.float32)
    gate /= gate.sum(-1, keepdims=True)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return eid, gate, x


@pytest.mark.parametrize("C", [8, 40])
def test_dispatch_combine_match_repro_bitwise(C):
    """k = 8 of E = 16 over 64 tokens: C = 8 drops picks (32 a expert on
    average), C = 40 keeps them all. The buffer, the sort's metadata and
    the combine of random expert outputs, bit for bit in bfloat16."""
    E, k = 16, 8
    eid, gate, x = _dispatch_inputs(E=E, k=k)
    jx, tx = _pair(x)
    cd = jnp.bfloat16
    jbuf, jst, jkeep, jdest, jsg = JL._moe_dispatch(
        jx, jnp.asarray(eid), jnp.asarray(gate), E, k, C, cd)
    tbuf, tst, tkeep, tdest, tsg, rank = TL._moe_dispatch(
        tx, torch.as_tensor(eid).long(), torch.as_tensor(gate), E, k, C,
        torch.bfloat16)
    np.testing.assert_array_equal(_np(tbuf), _np(jbuf))
    for t, j in ((tst, jst), (tkeep, jkeep), (tdest, jdest)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tsg.numpy(), np.asarray(jsg))
    assert bool(tkeep.all()) == (C == 40)
    y = np.random.default_rng(4).standard_normal((E * C, x.shape[1]))
    jy, ty = _pair(y.astype(np.float32))
    got = TL._moe_combine(ty, tkeep, tdest, tsg, rank, torch.bfloat16)
    want = JL._moe_combine(jy, jst, jkeep, jdest, jsg, x.shape[0],
                           x.shape[1], cd)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("C", [8, 40])
def test_dispatch_gradient_matches_repro_bitwise(C):
    """The tokens' gradient through the dispatch (the gather ``xf[st]``
    whose transpose adds each token's k rows in sort order) against
    ``jax.vjp``, bit for bit in bfloat16."""
    E, k = 16, 8
    eid, gate, x = _dispatch_inputs(E=E, k=k, seed=5)
    jx, tx = _pair(x)
    g = np.random.default_rng(6).standard_normal((E, C, x.shape[1]))
    jg, tg = _pair(g.astype(np.float32))
    _, vjp = jax.vjp(lambda xf: JL._moe_dispatch(
        xf, jnp.asarray(eid), jnp.asarray(gate), E, k, C, jnp.bfloat16)[0],
        jx)
    (want,) = vjp(jg)
    tx = tx.requires_grad_()
    buf = TL._moe_dispatch(tx, torch.as_tensor(eid).long(),
                           torch.as_tensor(gate), E, k, C,
                           torch.bfloat16)[0]
    buf.backward(tg)
    np.testing.assert_array_equal(_np(tx.grad), _np(want))


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b",
                                  "granite_moe_3b_a800m"])
def test_moe_apply_and_input_gradient_match_repro(arch):
    """``moe_apply`` and the gradient of a weighted sum of it with respect
    to its input, against ``repro`` and ``jax.grad`` with float32 compute
    (relative to the largest value, 1e-5), the capacity cut so that
    picks are dropped."""
    jc, tc = _cfgs(arch, "float32")
    jc = dataclasses.replace(jc, moe_capacity=0.5)
    tc = dataclasses.replace(tc, moe_capacity=0.5)
    jb, tb = _moe_block(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 24, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((B, 24, jc.d_model)).astype(np.float32)
    jy = jax.jit(lambda a: JL.moe_apply(jb, a, jc))(jnp.asarray(x))
    jgx = jax.jit(jax.grad(lambda a: jnp.sum(JL.moe_apply(jb, a, jc) * w)))(
        jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_()
    ty = TL.moe_apply(tb, tx, tc)
    (ty * torch.as_tensor(w)).sum().backward()
    assert sup.rel_err(ty.detach(), torch.as_tensor(_np(jy))) <= 1e-5
    assert sup.rel_err(tx.grad, torch.as_tensor(_np(jgx))) <= 1e-5


# -------------------------------------------------------------------------
# the slice: prefill, teacher-forced decode, greedy decode_loop
# -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_serve(cfg):
    """``repro``'s prefill and decode step for ``cfg``, each compiled once
    (its blocks run in a compiled scan either way)."""
    return (jax.jit(lambda p, tok: j_prefill(p, {"tokens": tok}, cfg,
                                             CACHE)),
            jax.jit(lambda p, tok, c, i: j_decode(p, tok, c, i, cfg)))


def _prompt_and_tokens(cfg, seed=11):
    rng = np.random.default_rng(seed)
    tv = cfg.true_vocab or cfg.vocab_size
    return (rng.integers(0, tv, (B, P)).astype(np.int32),
            rng.integers(0, tv, (B, DECODE_STEPS)).astype(np.int32))


def _run_both(arch, compute):
    """Prefill + DECODE_STEPS teacher-forced steps through both packages.
    Returns [(what, jax result, port result)]."""
    jc, tc = _cfgs(arch, compute)
    _, jp, tp = _params(arch)
    key = _block_key(tc)
    prompt, toks = _prompt_and_tokens(tc)
    out = []
    prefill, decode = _j_serve(jc)
    jl, jcache = prefill(jp, jnp.asarray(prompt))
    tl, tcache = lm_prefill(tp, {"tokens": torch.as_tensor(prompt)}, tc,
                            CACHE)
    out.append(("prefill logits", jl, tl))
    for n in ("k", "v"):
        out.append((f"prefill cache {n}", jcache[key][n],
                    tcache[key][n].clone()))
    for i in range(DECODE_STEPS):
        jl, jcache = decode(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.int32(P + i))
        tl, tcache = lm_decode_step(tp, torch.as_tensor(toks[:, i:i + 1]),
                                    tcache, P + i, tc)
        out.append((f"decode {i} logits", jl, tl))
    for n in ("k", "v"):
        out.append((f"final cache {n}", jcache[key][n], tcache[key][n]))
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_matches_repro(monkeypatch, arch, compute):
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    for what, want, got in _run_both(arch, compute):
        assert _np(got).shape == _np(want).shape, what
        d = np.abs(_np(want) - _np(got))
        if compute == "float32":
            assert float(d.max()) <= F32_MAX, f"{what}: max {d.max()}"
        else:
            assert float(d.max()) <= TIGHT_MAX and \
                float(d.mean()) <= TIGHT_MEAN, \
                f"{what}: max {d.max()} mean {d.mean()}"


def _greedy_margins(jp, cfg, prompt, tokens):
    """The reference's top-1 minus top-2 logit (over the true vocab) at
    each step of its own greedy path."""
    tv = cfg.true_vocab or cfg.vocab_size
    prefill, decode = _j_serve(cfg)
    lg, cache = prefill(jp, jnp.asarray(prompt))
    out = []
    for i in range(GREEDY_STEPS):
        top = np.sort(_np(lg[:, 0, :tv]), axis=-1)
        out.append(top[:, -1] - top[:, -2])
        if i + 1 < GREEDY_STEPS:
            lg, cache = decode(jp, jnp.asarray(tokens[:, i:i + 1]), cache,
                               jnp.int32(P + i))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_repro(monkeypatch, arch, compute):
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, compute)
    _, jp, tp = _params(arch)
    prompt, _ = _prompt_and_tokens(tc, seed=12)
    want = np.asarray(j_decode_loop(jp, jc, jnp.asarray(prompt),
                                    GREEDY_STEPS, cache_len=CACHE))
    got = tserve.decode_loop(tp, tc, torch.as_tensor(prompt), GREEDY_STEPS,
                             cache_len=CACHE).numpy()
    assert got.shape == (B, GREEDY_STEPS)
    assert int(got.max()) < (tc.true_vocab or tc.vocab_size)
    if compute == "float32" or np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)
        return
    margins = _greedy_margins(jp, jc, prompt, want)
    for b in range(B):
        bad = np.flatnonzero(got[b] != want[b])
        if bad.size:
            f = int(bad[0])
            assert margins[b, f] <= TIGHT_MAX, \
                f"row {b} step {f}: {got[b]} vs {want[b]}, reference " \
                f"margin {margins[b, f]}"


# -------------------------------------------------------------------------
# one train step against repro's jitted step
# -------------------------------------------------------------------------

TRAIN_TCFG = dict(microbatch=2, remat="full", lr=1e-2, warmup_steps=2,
                  total_steps=20)
TRAIN_DCFG = dict(batch=4, seq=16)


def _record_repro_picks(monkeypatch):
    """Record the experts ``repro``'s router picks, call by call (an
    ordered callback inside its compiled step). Returns the list."""
    picks = []
    router = JL._router

    def recording(p, xf, cfg):
        gate, eid = router(p, xf, cfg)
        jax.debug.callback(lambda e: picks.append(np.asarray(e)), eid,
                           ordered=True)
        return gate, eid

    monkeypatch.setattr(JL, "_router", recording)
    return picks


def _impose_repro_picks(monkeypatch):
    """``_record_repro_picks``, and hand the picks, in the same order, to
    the port's router in place of its own top-k. Returns (the recorded
    picks, the list of the port's calls' indices)."""
    picks = _record_repro_picks(monkeypatch)
    used = []

    def imposed(probs, k):
        used.append(len(used))
        return torch.as_tensor(np.array(picks[used[-1]])).long()

    monkeypatch.setattr(TL, "_top_k", imposed)
    return picks, used


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_repro(monkeypatch, arch, compute):
    """From the same numpy params and fresh optimizer state, one step of
    ``make_train_step`` against ``repro``'s jitted one (microbatch 2, remat
    "full"), held as ``test_torch_train.py``'s step test holds qwen3-14b:
    loss, grad norm, lr and first moment within the bar (1e-4 in float32
    compute, ``LM_TIGHT_MAX`` in bfloat16); the parameters within it
    wherever Adam's denominator is above 100 eps, else within the step's
    range 2 lr (1 + weight decay).

    The MoE configs in bfloat16 take ``repro``'s router picks, call by
    call (both packages route each layer of each microbatch in the
    forward and again in its recompute, in the same order): their
    bfloat16 activations differ from ``repro``'s in the last bit here and
    there (where they do, a near tie between two experts can move to the
    other side: ROADMAP.md, Queue 3 fault 6, closed since the norms read
    the residual stream's float32 sums), and a token sent to another
    expert is a different computation, not a rounding.
    ``test_moe_train_step_own_router_bf16`` runs the port's own picks."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, compute)
    settings = dict(TRAIN_TCFG)
    picks = None
    if compute == "bfloat16" and jc.family == "moe":
        picks, used = _impose_repro_picks(monkeypatch)
    tcfg = tconfigs.TrainConfig(**settings)
    jtcfg = jconfigs.TrainConfig(**settings)
    tree, jp, tp = _params(arch)
    batch = jtrain.SyntheticData(jc, jtrain.DataConfig(
        **TRAIN_DCFG)).batch_at(3)
    jp2, jo, jm = jax.jit(jtrain.make_train_step(jc, jtcfg))(
        jp, jtrain.init_opt(jp, jtcfg),
        {n: jnp.asarray(x) for n, x in batch.items()})
    if picks is not None:       # each layer in the forward and recompute
        assert len(picks) == 2 * jc.num_layers * tcfg.microbatch
    tp2, to, tm = ttrain.make_train_step(tc, tcfg)(
        tp, ttrain.init_opt(tp, tcfg),
        {n: torch.as_tensor(x) for n, x in batch.items()})
    if picks is not None:
        assert len(used) == len(picks)
    bar = F32_MAX if compute == "float32" else TIGHT_MAX
    assert int(to.step) == int(jo.step) == 1
    assert np.isfinite(float(tm["loss"]))
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= bar, k
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


# tokens of a router call (a layer of a microbatch, in the forward or its
# recompute) that the port's bfloat16 MoE step sends to another set of
# experts than ``repro``'s (Queue 3 fault 6): 1 at most of 32 while the
# norms read the rounded residual stream; none since they read its
# float32 sums, as ``repro``'s compiled scan does (``models/lm.py::_add``)
FAULT6_PICKS_MAX = 0.0


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b",
                                  "granite_moe_3b_a800m"])
def test_moe_train_step_own_router_bf16(monkeypatch, arch):
    """One bfloat16 MoE train step as ``test_train_step_matches_jitted_repro``
    runs it (microbatch 2, remat "full"), with the port's own router: call
    by call, the share of tokens whose set of experts differs from
    ``repro``'s stays within ``FAULT6_PICKS_MAX`` (measured: none of 32 a
    call for either), each recompute routes as its forward did, and the
    loss and the grad norm are within ``LM_TIGHT_MAX`` of ``repro``'s
    (measured 0 and 4.8e-8 off the loss, 2.7e-4 and 1.2e-3 off the grad
    norm)."""
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, tc = _cfgs(arch, "bfloat16")
    tcfg = tconfigs.TrainConfig(**TRAIN_TCFG)
    jtcfg = jconfigs.TrainConfig(**TRAIN_TCFG)
    want = _record_repro_picks(monkeypatch)
    got = []
    top_k = TL._top_k

    def recording(probs, k):
        eid = top_k(probs, k)
        got.append(eid.numpy().copy())
        return eid

    monkeypatch.setattr(TL, "_top_k", recording)
    _, jp, tp = _params(arch)
    batch = jtrain.SyntheticData(jc, jtrain.DataConfig(
        **TRAIN_DCFG)).batch_at(3)
    _, _, jm = jax.jit(jtrain.make_train_step(jc, jtcfg))(
        jp, jtrain.init_opt(jp, jtcfg),
        {n: jnp.asarray(x) for n, x in batch.items()})
    _, _, tm = ttrain.make_train_step(tc, tcfg)(
        tp, ttrain.init_opt(tp, tcfg),
        {n: torch.as_tensor(x) for n, x in batch.items()})
    calls = 2 * jc.num_layers * tcfg.microbatch
    assert len(want) == len(got) == calls
    for i, (a, b) in enumerate(zip(want, got)):
        moved = (np.sort(a, -1) != np.sort(b, -1)).any(-1).mean()
        assert moved <= FAULT6_PICKS_MAX, f"call {i}: {moved} of the tokens"
    L = jc.num_layers
    for m in range(tcfg.microbatch):          # forward L0.., recompute ..L0
        seq = got[2 * L * m:2 * L * (m + 1)]
        for layer in range(L):
            np.testing.assert_array_equal(seq[layer], seq[2 * L - 1 - layer])
    assert np.isfinite(float(tm["loss"]))
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= TIGHT_MAX, k


def test_global_norm_against_jitted_repro():
    """The optimizer's global norm over the REDUCED qwen3-14b's and
    qwen3-moe's gradients against ``repro``'s compiled: its per-leaf sums
    still add in PyTorch's order (ROADMAP.md, Queue 3 fault 5), within 16
    float32 ulps (measured at most 12 over 20 draws)."""
    from repro.train.optim import global_norm as j_global_norm
    for arch in ("qwen3_14b", "qwen3_moe_30b_a3b"):
        tree = sup.numpy_params(tmodels.lm_specs(_cfgs(arch)[1]), 3)
        rng = np.random.default_rng(0)
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                        * 0.05).astype(np.float32), tree)
        want = np.float32(jax.jit(j_global_norm)(grads))
        got = np.float32(ttrain.optim.global_norm(
            tmodels.params_from_numpy(grads, "cpu")))
        assert _f32_ulps(got, want) <= 16
