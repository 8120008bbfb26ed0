"""Decoder-only language model (twin of ``repro.models.lm``, its
decoder-only block kinds).

Layers are organized in *pattern groups* as in ``repro``: parameters and
caches are stacked along a leading ``layers`` axis of length
``G = num_layers / len(pattern)``, and a Python loop over the groups
takes the place of ``lax.scan``. Five kinds are ported:

  attn   pre-norm GQA self-attention (causal) + gated MLP
  moe    the same attention + a mixture of experts
  local  sliding-window self-attention + gated MLP (a ring cache)
  rec    RG-LRU recurrent block + gated MLP          (Griffin)
  ssm    Mamba2 SSD mixer (no separate MLP)

with either norm, either activation and tied, untied or scaled
embeddings; ``check_config`` rejects every configuration outside them
(the encoder-decoder and the VLM), naming its ROADMAP item.

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
from . import rglru as R
from . import ssm as S

# what the port serves, against ``repro``'s ModelConfig fields (a field's
# allowed values); any other value is the business of a later slice
# (ROADMAP.md, Queue 1 item 15e: encoder-decoder, VLM)
KINDS = ("attn", "moe", "local", "rec", "ssm")
_SCOPE = {"norm": ("rmsnorm", "layernorm"), "act": ("silu", "gelu"),
          "gated_mlp": (True,), "learned_pos": (False,), "enc_layers": (0,),
          "num_image_tokens": (0,)}


def check_config(cfg):
    """Raise ``NotImplementedError`` for a configuration outside the
    port: block kinds other than ``KINDS``, or another norm, activation,
    MLP, embedding or frontend."""
    bad = [f"block kind {k!r}" for k in cfg.pattern if k not in KINDS]
    bad += [f"{f}={getattr(cfg, f)!r}" for f, v in _SCOPE.items()
            if getattr(cfg, f) not in v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 15)")


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------


def block_specs(cfg, kind: str):
    dt = cfg.param_dtype
    s = {"ln1": L.norm_specs(cfg.d_model, cfg.norm, dt)}
    if kind in ("attn", "local", "moe"):
        s["attn"] = L.attn_specs(cfg)
    if kind == "rec":
        s["rec"] = R.rglru_specs(cfg)
    if kind == "ssm":
        s["ssm"] = S.mamba_specs(cfg)
    if kind != "ssm":
        s["ln2"] = L.norm_specs(cfg.d_model, cfg.norm, dt)
        s["mlp"] = L.moe_specs(cfg) if kind == "moe" else L.mlp_specs(cfg)
    return s


def _stack(specs, G: int):
    return tree_map_specs(
        lambda s: ParamSpec((G,) + s.shape, s.dtype, ("layers",) + s.axes,
                            s.init, s.scale), specs)


def lm_specs(cfg):
    check_config(cfg)
    G = cfg.pattern_groups
    group = {f"b{j}_{kind}": block_specs(cfg, kind)
             for j, kind in enumerate(cfg.pattern)}
    return {
        "embed": L.embed_specs(cfg),
        "blocks": _stack(group, G),
        "ln_f": L.norm_specs(cfg.d_model, cfg.norm, cfg.param_dtype),
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


def _add(x, y):
    """The residual add: (x + y in the compute dtype, the sum the next norm
    reads). XLA:CPU computes a bfloat16 sum that is only read back as
    float32 in float32 (it allows excess precision), so inside one body of
    ``repro``'s compiled layer scan (a pattern group) the norm after a
    residual add reads the unrounded float32 sum of its two operands,
    while the residual stream itself carries the rounded sum. The first
    norm of a group reads the rounded carry (``xn`` None)."""
    out = x + y
    if out.dtype == torch.float32:
        return out, out
    return out, x.float() + y.float()


def _norm(p, x, xn, cfg):
    """The block's pre-norm of the residual stream: of ``xn`` (``_add``'s
    float32 sum) where given, else of x; out in x's dtype."""
    return L.norm_apply(p, x if xn is None else xn, cfg.norm).to(x.dtype)


def _mlp(bp, x, xn, kind, cfg):
    """The block's MLP half: ``moe_apply`` for ``"moe"`` blocks, as
    ``repro`` picks it."""
    mlp = L.moe_apply if kind == "moe" else L.mlp_apply
    return mlp(bp["mlp"], _norm(bp["ln2"], x, xn, cfg), cfg)


def _attn_kind(kind: str) -> str:
    """The attention mask of a block kind."""
    return "local" if kind == "local" else "causal"


def _apply_block(bp, x, xn, kind, cfg):
    """One block over the residual stream (x, xn): returns the new pair."""
    h = _norm(bp["ln1"], x, xn, cfg)
    if kind == "ssm":
        return _add(x, S.mamba_forward(bp["ssm"], h, cfg))
    if kind == "rec":
        y = R.rglru_forward(bp["rec"], h, cfg)
    else:
        y = L.attn_forward(bp["attn"], h, cfg, _attn_kind(kind))
    x, xn = _add(x, y)
    return _add(x, _mlp(bp, x, xn, kind, cfg))


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
        hn = None
        for j, kind in enumerate(cfg.pattern):
            h, hn = _apply_block(gp[f"b{j}_{kind}"], h, hn, kind, cfg)
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
    x = L.norm_apply(params["ln_f"], x, cfg.norm)
    return L.unembed_apply(params["embed"], x, cfg)


# --------------------------------------------------------------------------
# Prefill (full sequence, emits the decode cache)
# --------------------------------------------------------------------------


def _ring_fill(buf, k):
    """``repro``'s ``_ring_fill`` into ``buf`` [B, W, ...]: zeros, with the
    last m = min(T, W) of k's T positions at their ring slots pos % W."""
    W, T = buf.shape[1], k.shape[1]
    m = min(T, W)
    slot = torch.arange(T - m, T, device=k.device) % W
    buf.zero_()
    buf[:, slot] = k[:, T - m:]


def _prefill_block(bp, x, xn, kind, cfg, new):
    """Returns the residual stream (x, xn) after the block (``_add``);
    writes the block's decode cache into ``new`` (``_new_cache``'s views
    of group g): the keys and values into the first T positions of the
    full cache and zeros after them, the last ``window`` keys and values
    into the ring, the recurrent state and the conv tail of ``"rec"`` and
    ``"ssm"`` blocks."""
    h = _norm(bp["ln1"], x, xn, cfg)
    if kind == "ssm":
        y, st, cs = S.mamba_forward(bp["ssm"], h, cfg, return_state=True)
        new["state"].copy_(st)
        new["conv"].copy_(cs)
        return _add(x, y)
    if kind == "rec":
        y, hs, cs = R.rglru_forward(bp["rec"], h, cfg, return_state=True)
        new["h"].copy_(hs)
        new["conv"].copy_(cs)
    else:
        y, (k, v) = L.attn_forward(bp["attn"], h, cfg, _attn_kind(kind),
                                   return_kv=True)
        T = k.shape[1]
        for n, t in (("k", k), ("v", v)):
            if kind == "local":
                _ring_fill(new[n], t)
            else:
                new[n][:, :T] = t
                new[n][:, T:] = 0
    x, xn = _add(x, y)
    return _add(x, _mlp(bp, x, xn, kind, cfg))


def _new_cache(cfg, B: int, cache_len: int, dtype, device):
    """The empty decode cache ``lm_prefill`` fills, in the dtypes
    ``repro``'s prefill returns: keys and values [G, B, cache_len, KV, Dh]
    (a ``"local"`` ring [G, B, window, KV, Dh], as ``repro``'s
    ``_ring_fill`` makes it whatever the cache length), the RG-LRU state
    ``h`` [G, B, d_rnn] in float32, the SSD ``state`` [G, B, H, P, N] and
    the conv tails [G, B, k-1, channels] in the compute dtype ``dtype``."""
    G = cfg.pattern_groups
    cache = {}
    for j, kind in enumerate(cfg.pattern):
        if kind == "rec":
            dr = cfg.d_rnn_eff
            shapes = {"h": ((G, B, dr), torch.float32),
                      "conv": ((G, B, cfg.rglru_conv - 1, dr), dtype)}
        elif kind == "ssm":
            d_in, H, N, conv_ch, _ = S.mamba_dims(cfg)
            shapes = {"state": ((G, B, H, d_in // H, N), dtype),
                      "conv": ((G, B, cfg.ssm_conv - 1, conv_ch), dtype)}
        else:
            S_len = cfg.window if kind == "local" else cache_len
            kv = ((G, B, S_len, cfg.num_kv_heads, cfg.head_dim), dtype)
            shapes = {"k": kv, "v": kv}
        cache[f"b{j}_{kind}"] = {
            n: torch.empty(shape, dtype=dt, device=device)
            for n, (shape, dt) in shapes.items()}
    return cache


def lm_prefill(params, batch, cfg, cache_len: int):
    """Run the prompt, return (last-token logits [B,1,vocab], decode cache
    ``_new_cache``: {"b{j}_{kind}": its leaves with a leading G})."""
    check_config(cfg)
    tokens = _batch_tokens(batch)
    x = L.embed_apply(params["embed"], tokens, cfg)
    B, T = tokens.shape
    cache = _new_cache(cfg, B, cache_len, x.dtype, x.device)
    for g in range(cfg.pattern_groups):
        gp = _group(params["blocks"], g)
        xn = None
        for j, kind in enumerate(cfg.pattern):
            key = f"b{j}_{kind}"
            x, xn = _prefill_block(gp[key], x, xn, kind, cfg,
                                   _group(cache[key], g))
    x = L.norm_apply(params["ln_f"], x, cfg.norm)
    logits = L.unembed_apply(params["embed"], x[:, -1:], cfg)
    return logits, cache


# --------------------------------------------------------------------------
# Decode (single token, layer-stacked cache)
# --------------------------------------------------------------------------


def _decode_block(bp, x, xn, kind, cfg, cache, index):
    """Returns the residual stream (x, xn) after the block (``_add``); the
    block's cache is updated in place (each leaf keeps its dtype)."""
    h = _norm(bp["ln1"], x, xn, cfg)
    if kind == "ssm":
        y, st, cs = S.mamba_decode(bp["ssm"], h, cfg, cache["state"],
                                   cache["conv"])
        cache["state"].copy_(st)
        cache["conv"].copy_(cs)
        return _add(x, y)
    if kind == "rec":
        y, hs, cs = R.rglru_decode(bp["rec"], h, cfg, cache["h"],
                                   cache["conv"])
        cache["h"].copy_(hs)
        cache["conv"].copy_(cs)
    else:
        y, _, _ = L.attn_decode(bp["attn"], h, cache["k"], cache["v"], index,
                                cfg, _attn_kind(kind))
    x, xn = _add(x, y)
    return _add(x, _mlp(bp, x, xn, kind, cfg))


def lm_decode_step(params, token, cache, index, cfg):
    """token: [B,1] int; cache: the tree ``lm_prefill`` returns (leading G
    on the block caches), updated in place at ``index`` and returned;
    index: tokens already in context. Returns (logits [B,1,vocab], cache).
    """
    check_config(cfg)
    x = L.embed_apply(params["embed"], token, cfg)
    for g in range(cfg.pattern_groups):
        gp = _group(params["blocks"], g)
        xn = None
        for j, kind in enumerate(cfg.pattern):
            key = f"b{j}_{kind}"
            x, xn = _decode_block(gp[key], x, xn, kind, cfg,
                                  _group(cache[key], g), index)
    x = L.norm_apply(params["ln_f"], x, cfg.norm)
    return L.unembed_apply(params["embed"], x, cfg), cache
