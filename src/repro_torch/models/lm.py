"""Decoder-only language model (twin of ``repro.models.lm``, the ``"attn"``
block kind).

Layers are organized in *pattern groups* as in ``repro``: parameters and
caches are stacked along a leading ``layers`` axis of length
``G = num_layers / len(pattern)``, and a Python loop over the groups
takes the place of ``lax.scan``. Only the ``"attn"`` kind (pre-norm GQA
causal self-attention + SwiGLU MLP) is ported; ``check_config`` rejects
every configuration outside the slice, naming its ROADMAP item. There is
no training path yet (item 15), so ``lm_forward`` takes no remat policy.
"""
from __future__ import annotations

import torch

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


def lm_forward(params, batch, cfg):
    """Full-sequence forward -> logits [B, T, vocab] (float32).
    ``batch``: dict with "tokens" [B,T] int."""
    check_config(cfg)
    x = L.embed_apply(params["embed"], _batch_tokens(batch), cfg)
    for g in range(cfg.pattern_groups):
        gp = _group(params["blocks"], g)
        for j, kind in enumerate(cfg.pattern):
            x = _apply_block(gp[f"b{j}_{kind}"], x, cfg)
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
