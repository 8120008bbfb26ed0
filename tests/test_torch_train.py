"""The port's one-card trainer (``repro_torch.train``, the training
configs, ``launch.train_preset``, the remat policies of ``lm_forward``)
against ``repro``'s on the CPU, at the REDUCED qwen3-14b size (2 layers,
d_model 64, 4 heads over 2 kv heads, head_dim 16, vocab 512).

Parameters come from ``test_torch_support.numpy_params`` (numpy, a
seed), or are ``repro``'s state after some steps carried across with
``params_from_numpy`` / ``opt_from_numpy``; ``repro``'s attention is
computed the K5 way (``test_torch_lm.sdpa_k5``: float32 scores and
softmax) where the port's K5 path is compared, as in
``tests/test_torch_lm.py``. Bars:

* **configs, presets, data**: equal, byte for byte.
* **lr_schedule**: the warmup bit for bit ``repro``'s jitted schedule;
  the cosine decay within lr 2^-22, an ulp of the cosine times 0.5 lr
  and the product's rounding (XLA's ``cos`` is its own, one ulp off at
  about 1% of steps, ROADMAP.md Queue 3; measured 2 ulps of the rate).
* **adamw_update** against ``repro``'s jitted update from the same
  state: with the clip off, float32 moments bit for bit, bfloat16 ones
  within one bfloat16 ulp, and the parameters within 3e-7 (XLA's fused
  multiply-adds are spelled in the port; a few hundred of 140 000
  parameters still differ in the last bits: measured 3e-8 with float32
  moments, 2.4e-7 with bfloat16); with the clip on, ``global_norm`` sums
  in another order and its scale moves every update by an ulp: moments
  within 1e-8
  (first) and 1e-10 (second), parameters within 4e-6 (measured 1.9e-6),
  bfloat16 moments within one bfloat16 ulp.
* **xent_loss** and its gradient (padded vocab, label -1): rtol 1e-6.
* **remat**: the four policies give the same loss and gradients, bit for
  bit (mirrors ``tests/test_archs_smoke.py::test_remat_equivalence``).
* **make_train_step** against ``repro``'s jitted step from carried state
  (microbatch 1 and 2, remat ``"none"`` and ``"full"``): with float32
  compute loss, grad norm and first moment within ``F32_MAX`` (1e-4) and
  the parameters within it wherever Adam's denominator
  ``sqrt(v_hat) + eps`` is above 100 eps (where it is not, the update
  ``lr m_hat / (sqrt(v_hat) + eps)`` turns on the last bits of a gradient
  of ~1e-8 and is held to its range, 2 lr (1 + weight decay)); with
  bfloat16 compute everything within the tight bar (``LM_TIGHT_MAX``).
* **10 steps**: the losses of ``train_driver`` within
  ``TRAIN_LOSS_BAR`` of the golden (``tests/golden/torch_port_train.json``,
  ``repro`` on the CPU, float32 compute), which ``repro`` reproduces bit
  for bit here.
* **fault tolerance** (mirrors ``tests/test_fault_tolerance.py``): a
  crash after step 5 resumed from its checkpoint gives the uninterrupted
  run's losses and parameters bit for bit; checkpoints restore onto
  another device, ``keep`` holds, writes are atomic; a float32
  checkpoint written by ``repro`` restores into the port's tree and one
  written by the port into ``repro``'s.

Regenerate the golden (``repro`` on the CPU, ~5 s):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_train.py
"""
import dataclasses
import json
import os

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
from repro.launch.presets import train_preset as j_preset  # noqa: E402
from repro.train.optim import lr_schedule as j_lr  # noqa: E402

from test_torch_lm import sdpa_k5  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.launch import train_preset  # noqa: E402
from repro_torch.models.lm import REMAT_POLICIES  # noqa: E402
from repro_torch.models.spec import _leaves  # noqa: E402

ARCH = "qwen3_14b"
F32_MAX, TIGHT_MAX = 1e-4, sup.LM_TIGHT_MAX


def _tcfg(**kw):
    return tconfigs.TrainConfig(**{**sup.TRAIN_TCFG, **kw})


def _jcfg(tc):
    return jconfigs.TrainConfig(**dataclasses.asdict(tc))


def _model(compute="float32"):
    """(repro's config, the port's) of the REDUCED qwen3-14b."""
    j = dataclasses.replace(jconfigs.reduced_config(ARCH),
                            compute_dtype=compute)
    return j, tconfigs.ModelConfig(**dataclasses.asdict(j))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(cfg, seed=sup.TRAIN_PARAM_SEED):
    return sup.numpy_params(tmodels.lm_specs(cfg), seed)


# -------------------------------------------------------------------------
# configs, presets, data
# -------------------------------------------------------------------------

def test_train_shape_mesh_configs_equal_repro():
    assert dataclasses.asdict(tconfigs.TrainConfig()) == dataclasses.asdict(
        jconfigs.TrainConfig())
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for k, v in tconfigs.SHAPES.items():
        assert v.is_decode == jconfigs.SHAPES[k].is_decode
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 4, 8), ("pod", "data", "model"))):
        t, j = (c.MeshConfig(shape, axes) for c in (tconfigs, jconfigs))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.num_devices, t.batch_axes, t.model_size) == (
            j.num_devices, j.batch_axes, j.model_size)
    assert dataclasses.asdict(tconfigs.MeshConfig()) == dataclasses.asdict(
        jconfigs.MeshConfig())


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_preset_equals_repro(arch):
    assert dataclasses.asdict(train_preset(arch)) == dataclasses.asdict(
        j_preset(arch))


@pytest.mark.parametrize("arch", ["qwen3_14b", "whisper_large_v3",
                                  "phi3_vision_4_2b", "gemma_7b"])
def test_synthetic_data_is_repro_bytes_and_seekable(arch):
    jc = jconfigs.reduced_config(arch)
    tc = tconfigs.ModelConfig(**dataclasses.asdict(jc))
    dcfg = dict(batch=4, seq=24, seed=7)
    jd = jtrain.SyntheticData(jc, jtrain.DataConfig(**dcfg))
    td = ttrain.SyntheticData(tc, ttrain.DataConfig(**dcfg))
    assert dataclasses.asdict(ttrain.DataConfig()) == dataclasses.asdict(
        jtrain.DataConfig())
    b5 = td.batch_at(5)
    for k in (0, 5, 9):
        want, got = jd.batch_at(k), td.batch_at(k)
        assert want.keys() == got.keys()
        for n in want:
            assert got[n].dtype == want[n].dtype
            assert got[n].tobytes() == want[n].tobytes()
    for k in (9, 1, 7):
        td.batch_at(k)
    for n, x in td.batch_at(5).items():
        np.testing.assert_array_equal(x, b5[n])


# -------------------------------------------------------------------------
# the optimizer and the loss
# -------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(lr=1e-2, warmup_steps=2,
                                             total_steps=20),
                                dict(warmup_steps=7, total_steps=1003)])
def test_lr_schedule_matches_jitted_repro(kw):
    tc = tconfigs.TrainConfig(**kw)
    steps = np.arange(0, tc.total_steps + 50, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: j_lr(s, _jcfg(tc))))(
        jnp.asarray(steps)))
    got = ttrain.lr_schedule(torch.as_tensor(steps), tc).numpy()
    warm = steps < tc.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got, want, rtol=0, atol=tc.lr * 2.0 ** -22)


def _adam_state(tc, seed=1):
    """params (numpy), grads and repro's OptState (numpy) at step 3."""
    _, cfg = _model()
    tree = _params(cfg)
    rng = np.random.default_rng(seed)

    def draw(scale, square=False):
        def one(a):
            x = rng.standard_normal(a.shape).astype(np.float32) * scale
            x = x * x if square else x
            return np.asarray(jnp.asarray(x).astype(tc.moments_dtype))
        return jax.tree.map(one, tree)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05)
                         .astype(np.float32), tree)
    opt = jtrain.OptState(np.int32(3), draw(0.01), draw(0.01, square=True))
    return tree, grads, opt


def _bf16_bits(x):
    return (np.asarray(x, np.float32).view(np.int32) >> 16).astype(np.int64)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jitted_repro(clip, moments):
    tc = _tcfg(clip_norm=clip, moments_dtype=moments)
    tree, grads, opt = _adam_state(tc)
    J = jax.tree.map
    jp, jo, jm = jax.jit(lambda p, g, o: jtrain.adamw_update(
        p, g, o, _jcfg(tc)))(J(jnp.asarray, tree), J(jnp.asarray, grads),
                             J(jnp.asarray, opt))
    tp = tmodels.params_from_numpy(tree, "cpu")
    to = tmodels.opt_from_numpy(opt, "cpu")
    tp, to, tm = ttrain.adamw_update(
        tp, tmodels.params_from_numpy(grads, "cpu"), to, tc)
    assert int(to.step) == int(jo.step) == 4
    assert float(tm["lr"]) == float(jm["lr"])
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jp), _leaves(tp)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=3e-7 if clip == 0 else 4e-6)
    for i, (js, ts) in enumerate(((jo.mu, to.mu), (jo.nu, to.nu))):
        for a, b in zip(jax.tree.leaves(js), _leaves(ts)):
            assert str(b.dtype) == f"torch.{moments}"
            if moments == "bfloat16":
                assert np.abs(_bf16_bits(_np(a)) - _bf16_bits(_np(b))).max() \
                    <= 1
            elif clip == 0:
                np.testing.assert_array_equal(_np(b), _np(a))
            else:
                np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                           atol=(1e-8, 1e-10)[i])


def test_opt_specs_and_init_opt():
    from repro.models import lm_specs as j_lm_specs
    from repro.models.spec import is_spec
    jc, cfg = _model()
    tc = _tcfg(moments_dtype="bfloat16")
    specs = ttrain.opt_specs(tmodels.lm_specs(cfg), tc)
    jspecs = jtrain.opt_specs(j_lm_specs(jc), _jcfg(tc))
    assert tuple(specs.step) == tuple(jspecs.step)
    for t, j in ((specs.mu, jspecs.mu), (specs.nu, jspecs.nu)):
        assert [tuple(x) for x in _leaves(t)] == [
            tuple(x) for x in jax.tree.leaves(j, is_leaf=is_spec)]
    opt = ttrain.init_opt(tmodels.params_from_numpy(_params(cfg), "cpu"), tc)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    for m in _leaves(opt.mu) + _leaves(opt.nu):
        assert m.dtype == torch.bfloat16 and not bool(m.any())


def test_xent_loss_matches_repro():
    jc, tc = _model()
    jc = dataclasses.replace(jc, true_vocab=500)
    tc = dataclasses.replace(tc, true_vocab=500)
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 8, 512)) * 3).astype(np.float32)
    labels = rng.integers(0, 500, (2, 8)).astype(np.int32)
    labels[0, :3] = -1
    jl, jg = jax.value_and_grad(lambda x: jtrain.xent_loss(
        x, jnp.asarray(labels), jc))(jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_()
    tl = ttrain.xent_loss(x, torch.as_tensor(labels), tc)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(_np(x.grad), _np(jg), rtol=1e-6, atol=1e-9)
    assert not bool(x.grad[..., 500:].any())


# -------------------------------------------------------------------------
# the remat policies and the train step
# -------------------------------------------------------------------------

def test_remat_policies_equal_bitwise():
    _, cfg = _model()
    cfg = dataclasses.replace(cfg, num_layers=4, compute_dtype="bfloat16")
    tree = _params(cfg, seed=2)
    rng = np.random.default_rng(0)
    batch = {n: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
             for n in ("tokens", "labels")}
    out = {}
    for remat in REMAT_POLICIES:
        params = tmodels.params_from_numpy(tree, "cpu")
        for p in _leaves(params):
            p.requires_grad_(True)
        loss = ttrain.xent_loss(tmodels.lm_forward(params, batch, cfg,
                                                   remat=remat),
                                batch["labels"], cfg)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in _leaves(params)])
    assert set(out) == {"none", "full", "dots", "nested"}
    for remat, (loss, grads) in out.items():
        assert torch.equal(loss, out["none"][0]), remat
        for g, w in zip(grads, out["none"][1]):
            assert torch.equal(g, w), remat
    with pytest.raises(ValueError, match="remat"):
        tmodels.lm_forward(params, batch, cfg, remat="everything")


def _carried(jc, tc, steps=2):
    """repro's (params, opt) after ``steps`` jitted steps from numpy
    params, as numpy trees."""
    tree = _params(_model()[1])
    jp = jax.tree.map(jnp.asarray, tree)
    out = jtrain.train_driver(jc, _jcfg(tc), jtrain.DataConfig(
        **sup.TRAIN_DCFG), steps=steps, params=jp,
        opt=jtrain.init_opt(jp, _jcfg(tc)))
    return (jax.tree.map(np.asarray, out["params"]),
            jax.tree.map(np.asarray, out["opt"]))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("mb,remat", [(1, "none"), (2, "full")])
def test_train_step_matches_jitted_repro(monkeypatch, compute, mb, remat):
    monkeypatch.setattr(JL, "_sdpa", sdpa_k5)
    jc, cfg = _model(compute)
    tc = _tcfg(microbatch=mb, remat=remat)
    tree, opt = _carried(jc, tc)
    batch = jtrain.SyntheticData(jc, jtrain.DataConfig(
        **sup.TRAIN_DCFG)).batch_at(7)
    jp, jo, jm = jax.jit(jtrain.make_train_step(jc, _jcfg(tc)))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, opt),
        {n: jnp.asarray(x) for n, x in batch.items()})
    tp, to, tm = ttrain.make_train_step(cfg, tc)(
        tmodels.params_from_numpy(tree, "cpu"),
        tmodels.opt_from_numpy(opt, "cpu"),
        {n: torch.as_tensor(x) for n, x in batch.items()})
    bar = F32_MAX if compute == "float32" else TIGHT_MAX
    assert int(to.step) == int(jo.step) == 3
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= bar, k
    for a, b in zip(jax.tree.leaves(jo.mu), _leaves(to.mu)):
        assert np.abs(_np(a) - _np(b)).max() <= bar
    c2 = 1.0 - tc.adam_b2 ** 3
    span = 2 * float(jm["lr"]) * (1 + tc.weight_decay)
    for a, b, v in zip(jax.tree.leaves(jp), _leaves(tp),
                       jax.tree.leaves(jo.nu)):
        d = np.abs(_np(a) - _np(b))
        free = np.sqrt(_np(v) / c2) > 100 * 1e-8
        assert d[free].max(initial=0.0) <= bar
        assert d.max(initial=0.0) <= max(bar, span)


def test_ten_steps_within_golden_bar():
    """The port's ``train_driver`` from the golden's numpy params, float32
    compute, on the CPU: every loss within ``TRAIN_LOSS_BAR`` of
    ``repro``'s."""
    _, cfg = _model()
    tc = _tcfg()
    params = tmodels.params_from_numpy(_params(cfg), "cpu")
    out = ttrain.train_driver(cfg, tc, ttrain.DataConfig(**sup.TRAIN_DCFG),
                              steps=sup.TRAIN_STEPS, params=params,
                              opt=ttrain.init_opt(params, tc))
    want = np.array(sup.train_golden()["losses"])
    assert len(out["losses"]) == sup.TRAIN_STEPS
    assert np.abs(np.array(out["losses"]) - want).max() <= sup.TRAIN_LOSS_BAR
    assert out["losses"][-1] < out["losses"][0]


def _repro_golden_losses():
    JL._sdpa, old = sdpa_k5, JL._sdpa
    try:
        jc, cfg = _model()
        tc = _jcfg(_tcfg())
        jp = jax.tree.map(jnp.asarray, _params(cfg))
        out = jtrain.train_driver(
            jc, tc, jtrain.DataConfig(**sup.TRAIN_DCFG),
            steps=sup.TRAIN_STEPS, params=jp, opt=jtrain.init_opt(jp, tc))
    finally:
        JL._sdpa = old
    return out["losses"]


def test_golden_is_repros_run():
    gold = sup.train_golden()
    assert gold["losses"] == _repro_golden_losses()
    assert (gold["tcfg"], gold["dcfg"], gold["param_seed"]) == (
        sup.TRAIN_TCFG, sup.TRAIN_DCFG, sup.TRAIN_PARAM_SEED)


# -------------------------------------------------------------------------
# fault tolerance and checkpoints
# -------------------------------------------------------------------------

def test_crash_restart_bitwise(tmp_path):
    _, cfg = _model("bfloat16")
    tc = _tcfg(remat="none")
    dc = ttrain.DataConfig(**sup.TRAIN_DCFG)
    ref, res = sup.crash_restart(ttrain.train_driver, ttrain.CrashInjected,
                                 cfg, tc, dc, str(tmp_path), "cpu")
    # checkpoints after steps 2 and 5; the crash comes after step 5's
    assert res["start_step"] == 6
    assert ref["losses"][6:] == res["losses"]
    for a, b in zip(_leaves(ref["params"]), _leaves(res["params"])):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(ref["opt"].mu) + _leaves(ref["opt"].nu),
                    _leaves(res["opt"].mu) + _leaves(res["opt"].nu)):
        assert torch.equal(a, b)


def test_elastic_restore_onto_another_device(tmp_path):
    _, cfg = _model()
    params = tmodels.init_params(tmodels.lm_specs(cfg),
                                 torch.Generator().manual_seed(1), "cpu")
    ck = ttrain.Checkpointer(str(tmp_path))
    ck.save(0, params, blocking=True)
    meta = torch.empty(0, device="meta")
    template = jax.tree.map(lambda _: meta, _params(cfg))
    step, restored = ck.restore(template, device="cpu")
    assert step == 0
    for a, b in zip(_leaves(params), _leaves(restored)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_async_save_and_gc(tmp_path):
    ck = ttrain.Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save(s, {"w": torch.arange(8.0) + s})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    _, r = ck.restore({"w": torch.zeros(8)}, step=4)
    assert torch.equal(r["w"], torch.arange(8.0) + 4)
    ck3 = ttrain.Checkpointer(str(tmp_path / "three"))
    for s in range(6):
        ck3.save(s, {"w": torch.ones(2)})
    ck3.wait()
    assert ck3.all_steps() == [3, 4, 5] and ck3.latest_step() == 5


def test_checkpoint_atomicity_and_bf16_leaves(tmp_path):
    ck = ttrain.Checkpointer(str(tmp_path))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    tree = (x, ttrain.OptState(torch.tensor(7, dtype=torch.int32),
                               {"a": x.to(torch.bfloat16)},
                               {"a": x.to(torch.bfloat16)}))
    ck.save(7, tree, blocking=True)
    names = os.listdir(tmp_path)
    assert "step_7" in names and not any(n.startswith(".tmp") for n in names)
    with open(tmp_path / "step_7" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"][".1.mu.a"]["dtype"] == "bfloat16"
    _, (y, opt) = ck.restore(tree)
    assert torch.equal(y, x) and int(opt.step) == 7
    assert opt.mu["a"].dtype == torch.bfloat16
    assert torch.equal(opt.nu["a"], x.to(torch.bfloat16))


def test_checkpoints_cross_between_packages(tmp_path):
    """A float32 (params, opt) checkpoint written by ``repro`` restores
    into the port's tree bit for bit, and one written by the port into
    ``repro``'s, with the same files and manifest keys."""
    _, cfg = _model()
    tc = _tcfg()
    tree = _params(cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = (jp, jtrain.init_opt(jp, _jcfg(tc))._replace(
        step=jnp.int32(4)))
    jtrain.Checkpointer(str(tmp_path / "j")).save(4, jstate, blocking=True)
    tp = tmodels.params_from_numpy(tree, "cpu")
    tstate = (tp, ttrain.init_opt(tp, tc))
    step, (rp, ro) = ttrain.Checkpointer(str(tmp_path / "j")).restore(
        tstate)
    assert step == 4 and int(ro.step) == 4 and ro.step.dtype == torch.int32
    for a, b in zip(jax.tree.leaves(jstate), _leaves(rp) + [ro.step]
                    + _leaves(ro.mu) + _leaves(ro.nu)):
        np.testing.assert_array_equal(_np(b), _np(a))
    ttrain.Checkpointer(str(tmp_path / "t")).save(4, (rp, ro),
                                                  blocking=True)
    for d in ("j", "t"):
        with open(tmp_path / d / "step_4" / "manifest.json") as f:
            keys = sorted(json.load(f)["leaves"])
        if d == "j":
            jkeys = keys
    assert keys == jkeys
    step, back = jtrain.Checkpointer(str(tmp_path / "t")).restore(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def write_train_golden():
    """``repro``'s 10 losses of the golden run (see ``TRAIN_*`` in
    ``test_torch_support``), into ``tests/golden/torch_port_train.json``."""
    out = dict(
        source="repro.train.train_driver on the CPU: the REDUCED qwen3-14b "
               "(float32 compute, _sdpa computed the K5 way as "
               "tests/test_torch_lm.py::sdpa_k5 does), params from "
               "test_torch_support.numpy_params",
        arch=ARCH, compute_dtype="float32", param_seed=sup.TRAIN_PARAM_SEED,
        tcfg=sup.TRAIN_TCFG, dcfg=sup.TRAIN_DCFG, steps=sup.TRAIN_STEPS,
        losses=_repro_golden_losses())
    with open(sup.TRAIN_REF, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    print(sup.TRAIN_REF, write_train_golden()["losses"])
