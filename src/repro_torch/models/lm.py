"""Decoder-only language model (twin of ``repro.models.lm``, the ``"attn"``
block kind).

Layers are organized in *pattern groups* as in ``repro``: parameters and
caches are stacked along a leading ``layers`` axis of length
``G = num_layers / len(pattern)``, and a Python loop over the groups
takes the place of ``lax.scan``. Only the ``"attn"`` kind (pre-norm GQA
causal self-attention + SwiGLU MLP) is ported; ``check_config`` rejects
every configuration outside the slice, naming its ROADMAP item.

``lm_forward`` takes ``repro``'s remat policies, with
``torch.utils.checkpoint`` (non-reentrant) in place of ``jax.checkpoint``
around each pattern group: ``"none"``; ``"full"`` (only the groups'
boundaries are kept, each group's forward runs again in the backward);
``"dots"`` (a selective checkpoint that keeps the matrix products'
outputs, as ``checkpoint_dots``); ``"nested"`` (sqrt(G) two-level: the
outer segments' boundaries kept, each group inside recomputed under its
own checkpoint). The policies change what is stored, not what is
computed: losses and gradients are the same bits under all four.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from .spec import ParamSpec, tree_map_specs
from . import layers as L

# what this slice serves, against ``repro``'s ModelConfig fields; any
# other value is the business of a later slice (ROADMAP.md, Queue 1
# item 15: MoE, SSM, RG-LRU, local ring, encoder-decoder, VLM, the other
# configs)
_SCOPE = {"norm": "rmsnorm", "act": "silu", "gated_mlp": True,
          "tie_embeddings": False, "embed_scale": False, "learned_pos": False,
          "enc_layers": 0, "num_image_tokens": 0}


def check_config(cfg):
    """Raise ``NotImplementedError`` for a configuration outside the
    slice: block kinds other than ``"attn"`` or another norm, activation,
    MLP, embedding or frontend."""
    bad = [f"block kind {k!r}" for k in cfg.pattern if k != "attn"]
    bad += [f"{f}={getattr(cfg, f)!r}" for f, v in _SCOPE.items()
            if getattr(cfg, f) != v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 15)")


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------


def block_specs(cfg):
    dt = cfg.param_dtype
    return {"ln1": L.norm_specs(cfg.d_model, dt),
            "attn": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg.d_model, dt),
            "mlp": L.mlp_specs(cfg)}


def _stack(specs, G: int):
    return tree_map_specs(
        lambda s: ParamSpec((G,) + s.shape, s.dtype, ("layers",) + s.axes,
                            s.init, s.scale), specs)


def lm_specs(cfg):
    check_config(cfg)
    G = cfg.pattern_groups
    group = {f"b{j}_{kind}": block_specs(cfg)
             for j, kind in enumerate(cfg.pattern)}
    return {
        "embed": L.embed_specs(cfg),
        "blocks": _stack(group, G),
        "ln_f": L.norm_specs(cfg.d_model, cfg.param_dtype),
    }


def _group(tree, g: int):
    """Group ``g`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _batch_tokens(batch):
    extra = set(batch) - {"tokens", "labels"}
    if extra:
        raise NotImplementedError(
            f"batch inputs {sorted(extra)} are not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 15: encoder-decoder, VLM)")
    return batch["tokens"]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _apply_block(bp, x, cfg):
    x = x + L.attn_forward(bp["attn"], L.norm_apply(bp["ln1"], x), cfg)
    return x + L.mlp_apply(bp["mlp"], L.norm_apply(bp["ln2"], x), cfg)


REMAT_POLICIES = ("none", "full", "dots", "nested")

# the matrix products whose outputs the "dots" policy keeps (the einsums
# of models/layers.py reach these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, policy: str):
    """``fn`` under ``torch.utils.checkpoint`` for ``policy`` ("full":
    everything recomputed; "dots": the matrix products kept)."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _nested_split(G: int) -> int:
    """Outer length for sqrt(G) two-level remat (largest divisor <= sqrt)."""
    best = 1
    for d in range(1, int(G ** 0.5) + 1):
        if G % d == 0:
            best = d
    return best


def _run_blocks(blocks, x, cfg, remat: str = "full"):
    """The pattern groups over ``x`` under a remat policy."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_POLICIES}")

    def group(h, g):
        gp = _group(blocks, g)
        for j, kind in enumerate(cfg.pattern):
            h = _apply_block(gp[f"b{j}_{kind}"], h, cfg)
        return h

    G = cfg.pattern_groups
    if remat == "nested":
        inner = G // _nested_split(G)
        one = _checkpointed(group, "full")

        def segment(h, o):
            for g in range(o * inner, (o + 1) * inner):
                h = one(h, g)
            return h
        outer = _checkpointed(segment, "full")
        for o in range(G // inner):
            x = outer(x, o)
        return x
    step = group if remat == "none" else _checkpointed(group, remat)
    for g in range(G):
        x = step(x, g)
    return x


def lm_forward(params, batch, cfg, remat: str = "full"):
    """Training/prefill forward -> logits [B, T, vocab] (float32).
    ``batch``: dict with "tokens" [B,T] int (and "labels", not read);
    ``remat``: one of ``REMAT_POLICIES``."""
    check_config(cfg)
    x = L.embed_apply(params["embed"], _batch_tokens(batch), cfg)
    x = _run_blocks(params["blocks"], x, cfg, remat)
    x = L.norm_apply(params["ln_f"], x)
    return L.unembed_apply(params["embed"], x, cfg)


# --------------------------------------------------------------------------
# Prefill (full sequence, emits the decode cache)
# --------------------------------------------------------------------------


def _prefill_block(bp, x, cfg, new):
    """Returns x after the block; writes the block's keys and values into
    the first T positions of ``new`` ({"k", "v"}: [B, cache_len, KV, Dh])
    and zeros after them."""
    y, (k, v) = L.attn_forward(bp["attn"], L.norm_apply(bp["ln1"], x), cfg,
                               return_kv=True)
    x = x + y
    T = k.shape[1]
    for n, t in (("k", k), ("v", v)):
        new[n][:, :T] = t
        new[n][:, T:] = 0
    return x + L.mlp_apply(bp["mlp"], L.norm_apply(bp["ln2"], x), cfg)


def lm_prefill(params, batch, cfg, cache_len: int):
    """Run the prompt, return (last-token logits [B,1,vocab], decode cache
    {"b{j}_{kind}": {"k", "v": [G, B, cache_len, KV, Dh]}})."""
    check_config(cfg)
    tokens = _batch_tokens(batch)
    x = L.embed_apply(params["embed"], tokens, cfg)
    B, T = tokens.shape
    G = cfg.pattern_groups
    shape = (G, B, cache_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {f"b{j}_{kind}": {n: torch.empty(shape, dtype=x.dtype,
                                             device=x.device)
                              for n in ("k", "v")}
             for j, kind in enumerate(cfg.pattern)}
    for g in range(G):
        gp = _group(params["blocks"], g)
        for j, kind in enumerate(cfg.pattern):
            key = f"b{j}_{kind}"
            x = _prefill_block(gp[key], x, cfg, _group(cache[key], g))
    x = L.norm_apply(params["ln_f"], x)
    logits = L.unembed_apply(params["embed"], x[:, -1:], cfg)
    return logits, cache


# --------------------------------------------------------------------------
# Decode (single token, layer-stacked cache)
# --------------------------------------------------------------------------


def _decode_block(bp, x, cfg, cache, index):
    """Returns x after the block; the block's cache is updated in place."""
    y, _, _ = L.attn_decode(bp["attn"], L.norm_apply(bp["ln1"], x),
                            cache["k"], cache["v"], index, cfg)
    x = x + y
    return x + L.mlp_apply(bp["mlp"], L.norm_apply(bp["ln2"], x), cfg)


def lm_decode_step(params, token, cache, index, cfg):
    """token: [B,1] int; cache: the tree ``lm_prefill`` returns (leading G
    on the block caches), updated in place at ``index`` and returned;
    index: tokens already in context. Returns (logits [B,1,vocab], cache).
    """
    check_config(cfg)
    x = L.embed_apply(params["embed"], token, cfg)
    for g in range(cfg.pattern_groups):
        gp = _group(params["blocks"], g)
        for j, kind in enumerate(cfg.pattern):
            key = f"b{j}_{kind}"
            x = _decode_block(gp[key], x, cfg, _group(cache[key], g), index)
    x = L.norm_apply(params["ln_f"], x)
    return L.unembed_apply(params["embed"], x, cfg), cache
