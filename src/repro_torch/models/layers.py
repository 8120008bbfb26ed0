"""Transformer building blocks (twin of ``repro.models.layers``: the
causal ``"attn"`` and ``"moe"`` blocks and the sliding-window
``"local"`` attention).

Everything is a (specs, apply) pair over plain dicts of tensors. Numerics
follow ``repro``: params in ``cfg.param_dtype``, each weight cast to
``cfg.compute_dtype`` at its use (a second, bf16 copy of the weights is
never kept), softmax and norms in float32.

The two LM kernels sit where ``repro.kernels.ops`` says model code should
call them: ``norm_apply`` and the qk-norm ``_rms`` go through
``kernels.ops.rmsnorm`` (K6), and causal and sliding-window
self-attention, in prefill and decode (the full cache and the local
ring), through ``kernels.ops.flash_attention`` (K5). K5 keeps the scores
and the softmax weights in float32 where ``repro``'s ``_sdpa`` rounds both
to bfloat16, so the port's attention is the kernel's, not ``_sdpa``'s
(the tests hold the two apart).

The scope (rmsnorm and layernorm, SwiGLU and GeGLU, RoPE, tied, untied
and scaled embeddings, causal and sliding-window self-attention, the
mixture of experts' global dispatch) is checked once, in
``lm.check_config``; the branches of ``repro``'s layers for other
configurations (plain MLPs, learned-position embeddings, cross and
bidirectional attention, the MoE's per-shard dispatch) come with the
slices that run them (ROADMAP.md, Queue 1 item 15). The mesh helpers
(``constrain``, ``tp_proj_out``'s sharded branch) wait for the sharding
slice (item 15b): ``tp_proj_out`` is a plain product.

Where XLA:CPU rounds each operation of a ``repro`` expression to
bfloat16, the port spells it op by op (``_silu``, ``_gelu``), with the
expression's Python constants as tensors of the compute dtype
(``_const``): torch multiplies a bfloat16 tensor by a Python float in
float32 and rounds once, JAX first rounds the float to bfloat16.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..kernels import ops
from .spec import ParamSpec, fan_in_normal, torch_dtype


def _cd(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype, device: torch.device):
    """``value`` as a 0-d tensor of ``dtype`` on ``device``, made once (a
    tensor built from a Python scalar on the card is a host-to-device
    copy, which would stall the host at every call)."""
    return torch.tensor(value, dtype=torch.float64).to(dtype).to(device)


def tp_proj_out(h, w, cfg):
    """h: [B, T, F], w: [F, d] -> [B, T, d] in the compute dtype."""
    cd = _cd(cfg)
    return torch.einsum("btf,fd->btd", h.to(cd), w.to(cd))


# --------------------------------------------------------------------------
# Norms: rmsnorm through K6, layernorm plain
# --------------------------------------------------------------------------


def norm_specs(d: int, kind: str, dtype: str):
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), dtype, ("embed",), "ones"),
                "bias": ParamSpec((d,), dtype, ("embed",), "zeros")}
    return {"scale": ParamSpec((d,), dtype, ("embed",), "ones")}


def _layernorm(p, x, eps):
    """``repro``'s layernorm: mean, variance, rsqrt, scale and bias in
    float32, out in x's dtype (K6 is RMSNorm only, and ``repro`` has no
    Pallas layernorm). torch's means and ``rsqrt`` round their last bit
    otherwise than XLA:CPU's, which a bfloat16 output hides but for a few
    in 10^5 values at width 2 560; spelling ``jnp.mean``'s sum order
    (``fluid._xla_sum``) would still differ in ``rsqrt``'s last bit, and
    takes dozens of small launches a mean on the card."""
    xf = x.float()
    c = xf - torch.mean(xf, dim=-1, keepdim=True)
    y = c * torch.rsqrt(torch.mean(c * c, dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_apply(p, x, kind: str, eps: float = 1e-6):
    if kind == "layernorm":
        return _layernorm(p, x, eps)
    return ops.rmsnorm(x, p["scale"], eps=eps)


def _rms(x, scale, eps=1e-6):
    return ops.rmsnorm(x, scale, eps=eps)


# --------------------------------------------------------------------------
# RoPE (supports partial rotation)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device):
    """theta ** (-arange(half) / half) in float32, made once per device (a
    tensor built from the Python scalar on the card is a host-to-device
    copy, which would stall the host at every call)."""
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32),
                     expo).to(device)


def rope(x, positions, frac: float = 1.0, theta: float = 10000.0):
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    d = x.shape[-1]
    rot = int(d * frac) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs      # [...,T,half]
    ang = ang.unsqueeze(-2)                                   # head axis
    x1, x2 = xr[..., :half], xr[..., half:]
    c, s = torch.cos(ang), torch.sin(ang)
    y = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([y.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# Attention (GQA; causal / sliding-window)
# --------------------------------------------------------------------------


def attn_specs(cfg):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    s = {
        "wq": fan_in_normal((d, H, Dh), 0, dt, ("embed", "heads", "head_dim")),
        "wk": fan_in_normal((d, KV, Dh), 0, dt, ("embed", "kv", "head_dim")),
        "wv": fan_in_normal((d, KV, Dh), 0, dt, ("embed", "kv", "head_dim")),
        "wo": fan_in_normal((H * Dh, d), 0, dt, (None, "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((Dh,), dt, (None,), "ones")
        s["k_norm"] = ParamSpec((Dh,), dt, (None,), "ones")
    return s


def _qkv(p, x, cfg, positions):
    cd = _cd(cfg)
    q = torch.einsum("btd,dhk->bthk", x.to(cd), p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x.to(cd), p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x.to(cd), p["wv"].to(cd))
    if "q_norm" in p:
        q = _rms(q, p["q_norm"])
        k = _rms(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_frac, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_frac, cfg.rope_theta)
    return q, k, v


def _heads_first(x):
    """[B, T, H, D] -> the [B, H, T, D] view K5 takes (no copy)."""
    return x.permute(0, 2, 1, 3)


def _flash(q, k, v, window: int = 0):
    """Causal K5 on the model's layout: q [B,T,H,Dh], k/v [B,S,KV,Dh] ->
    [B,T,H*Dh]; with ``window`` > 0 a query sees only the ``window`` last
    positions up to its own. The kernel's output is laid out [B,T,H,Dh],
    so the reshape is free."""
    B, T, H, Dh = q.shape
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=True, window=window)
    return out.permute(0, 2, 1, 3).reshape(B, T, H * Dh)


def _sdpa(q, k, v, mask, cfg):
    """``repro``'s plain attention with its bfloat16 roundings (scaled q,
    scores and softmax weights in the compute dtype): q [B,T,H,Dh], k/v
    [B,S,KV,Dh], mask broadcastable to [B,?,T,S]. The port's causal,
    sliding-window and ring-buffer attention runs K5 instead; this is
    kept for the mask kind K5 does not serve, the encoder-decoder's cross
    attention, which comes with a later slice (ROADMAP.md, Queue 1 item
    15e)."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, T, KV, G, Dh) * float(1.0 / math.sqrt(Dh))
    scores = torch.einsum("btkgh,bskh->bkgts", q, k).float()
    if mask.ndim == 2:          # [T,S]
        mask = mask[None, None, None]
    elif mask.ndim == 3:        # [B,T,S]
        mask = mask[:, None, None]
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", w, v)
    return out.reshape(B, T, H * Dh)


def _window(cfg, kind: str) -> int:
    """K5's window for a mask kind: ``cfg.window`` for ``"local"`` (keys
    j > t - window, ``repro``'s ``_self_mask``), 0 (none) for
    ``"causal"``."""
    if kind not in ("causal", "local"):
        raise NotImplementedError(
            f"{kind!r} attention is not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 15e)")
    return cfg.window if kind == "local" else 0


def attn_forward(p, x, cfg, kind: str = "causal", return_kv: bool = False):
    """Full-sequence self-attention (training / prefill) through K5,
    causal or, for ``kind="local"``, sliding-window."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, pos)
    y = tp_proj_out(_flash(q, k, v, _window(cfg, kind)), p["wo"], cfg)
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p, x, cache_k, cache_v, index: int, cfg,
                kind: str = "causal"):
    """One-token decode. cache_[kv]: [B, S, KV, Dh] (S = the full length,
    or for ``kind="local"`` the ring's size); ``index`` is the number of
    tokens already in context (this token's position). The new k/v are
    written in place (the caches are returned too, as ``repro`` returns
    its updated copies) at ``index``, or in the ring at ``index % S``.
    K5 then reads the first ``n = min(index + 1, S)`` slots, every one of
    them seen: in the full cache they are positions 0..index, which
    ``repro``'s ``valid = sidx <= index`` keeps; in the ring, slot s holds
    position ``index - ((index - s) mod S)``, which before the ring wraps
    (index < S) is s for the slots up to index (the later ones are
    ``repro``'s negative positions), and after it lies in
    (index - S, index], inside the window since S <= window: ``repro``'s
    ``valid`` keeps those same n slots. The order in which the slots are
    read does not change the softmax's value, only the float32 order of
    its sums."""
    index = int(index)
    _window(cfg, kind)
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                     device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, pos)
    S = cache_k.shape[1]
    slot = index % S if kind == "local" else index
    cache_k[:, slot:slot + 1] = k_new.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v_new.to(cache_v.dtype)
    n = min(index + 1, S)
    out = _flash(q, cache_k[:, :n].to(q.dtype), cache_v[:, :n].to(q.dtype))
    y = torch.einsum("bte,ed->btd", out, p["wo"].to(_cd(cfg)))
    return y, cache_k, cache_v


# --------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------


def mlp_specs(cfg):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {"wu": fan_in_normal((d, f), 0, dt, ("embed", "mlp")),
            "wd": fan_in_normal((f, d), 0, dt, ("mlp", "embed")),
            "wg": fan_in_normal((d, f), 0, dt, ("embed", "mlp"))}


def _silu(x):
    """SiLU as ``repro``'s ``jax.nn.silu`` is lowered by XLA:
    ``x * (1 / (1 + exp(-x)))``, each operation rounded to x's dtype (a
    fused ``F.silu`` rounds once and differs in about a third of the
    bfloat16 results)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# sqrt(2 / pi), as ``jax.nn.gelu`` takes it (numpy float64, then x's dtype)
_GELU_C = float(np.sqrt(2 / np.pi))


def _gelu(x):
    """GELU as ``repro``'s ``jax.nn.gelu`` (the tanh form) is lowered by
    XLA: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with
    ``x**3`` as ``(x * x) * x``, each operation rounded to x's dtype and
    the constants taken in x's dtype (``F.gelu(approximate="tanh")``
    differs in ~40% of the bfloat16 results)."""
    c = _const(_GELU_C, x.dtype, x.device)
    k = _const(0.044715, x.dtype, x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * ((x * x) * x)))))


def _act(x, act: str):
    return _gelu(x) if act == "gelu" else _silu(x)


def mlp_apply(p, x, cfg):
    cd = _cd(cfg)
    h = torch.einsum("btd,df->btf", x.to(cd), p["wu"].to(cd))
    g = torch.einsum("btd,df->btf", x.to(cd), p["wg"].to(cd))
    return tp_proj_out(_act(g, cfg.act) * h, p["wd"], cfg)


# --------------------------------------------------------------------------
# Mixture of Experts (top-k router, sort-based capacity dispatch; the
# global path, which ``repro`` runs without a mesh). Token dropping keeps
# every shape static.
#
# No float sum here has an atomic or an unordered scatter-add: the
# combine adds each token's k contributions to zeros one at a time, in
# ascending position of the expert sort, in the compute dtype, as XLA:CPU
# applies ``repro``'s scatter-add; the dispatch's token gather has the
# same k-way sum as its backward (``_TokenGather``). Buffers are filled
# by gathers (each slot reads the sorted entry that lands there), so the
# forward is a gather everywhere and the backward of each gather a
# scatter onto distinct rows.
# --------------------------------------------------------------------------


def moe_specs(cfg):
    d, E, f, dt = cfg.d_model, cfg.num_experts, cfg.moe_d_ff, cfg.param_dtype
    return {
        "router": fan_in_normal((d, E), 0, dt, ("embed", None)),
        "wg": fan_in_normal((d, E, f), 0, dt, ("embed", "experts", "mlp")),
        "wu": fan_in_normal((d, E, f), 0, dt, ("embed", "experts", "mlp")),
        "wd": fan_in_normal((f, E, d), 0, dt, ("mlp", "experts", "embed")),
    }


def moe_capacity(cfg, tokens: int) -> int:
    c = int(np.ceil(tokens * cfg.experts_per_token * cfg.moe_capacity
                    / cfg.num_experts))
    return max(int(np.ceil(c / 8.0)) * 8, 8)


def _top_k(probs, k: int):
    """The indices of each row's k largest values, largest first and the
    lower index first among equal values: ``jax.lax.top_k``'s order, by a
    stable descending sort (``torch.topk`` promises no order for ties,
    which bfloat16 activations make frequent)."""
    return torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _router(p, xf, cfg):
    """(gate [n, k] float32, eid [n, k]): the k most probable experts of
    each token (``_top_k``), their probabilities renormalized by
    ``maximum(sum, 1e-9)``. The logits are the float32 products of the
    compute-dtype operands, not rounded to the compute dtype: ``repro``
    runs the router inside a compiled scan, where XLA drops the round trip
    of its ``einsum(...).astype(float32)`` through bfloat16, and a rounding
    there would turn near ties into ties. The gates are picked from the
    probabilities by compare and ``where`` (so their gradient is a
    ``where`` too, not a scatter); they differ from ``repro``'s in the
    last float32 bits (XLA:CPU's ``exp`` and sums are its own), which the
    compute dtype's rounding of the gate mostly hides."""
    cd = _cd(cfg)
    k, E = cfg.experts_per_token, cfg.num_experts
    logits = torch.einsum("td,de->te", xf.to(cd).float(),
                          p["router"].to(cd).float())
    probs = torch.softmax(logits, dim=-1)
    eid = _top_k(probs, k)
    pick = eid[:, :, None] == torch.arange(E, device=xf.device)
    gate = torch.where(pick, probs[:, None, :], 0.0).sum(dim=-1)
    return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), eid


def _token_sum(vals, rank):
    """out[t] = the rows ``rank[t, 0], rank[t, 1], ...`` of ``vals`` added
    to zeros one at a time, in vals' dtype: vals [n*k, d] in sort order,
    rank [n, k] each token's positions in that order, ascending."""
    acc = torch.zeros((rank.shape[0], vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    for j in range(rank.shape[1]):
        acc = acc + vals[rank[:, j]]
    return acc


class _TokenGather(torch.autograd.Function):
    """xf[st] (a token's row once for each of its k picks, in sort order),
    whose gradient is each token's k rows added in ascending sort position
    (``_token_sum``), the order in which XLA:CPU applies the scatter-add
    that transposes ``repro``'s gather."""

    @staticmethod
    def forward(ctx, xf, st, rank):
        ctx.save_for_backward(rank)
        return xf[st]

    @staticmethod
    def backward(ctx, g):
        (rank,) = ctx.saved_tensors
        return _token_sum(g, rank), None, None


def _moe_dispatch(xf, eid, gate, E, k, C, cd):
    """Sort-based capacity dispatch. xf [n,d]; eid/gate [n,k]. Returns
    (buf [E,C,d], st, keep, dest, sg, rank): ``repro``'s buffer and
    metadata, and each token's positions in the sort (for the combine).
    The sort is stable (``jnp.argsort``'s); expert e's segment starts at
    the number of picks below e; pick i of expert e keeps slot e*C + i
    while i < C, and a later pick is dropped (``dest`` E*C)."""
    n, d = xf.shape
    dev = xf.device
    flat_e = eid.reshape(-1)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    experts = torch.arange(E, device=dev)
    offset = torch.searchsorted(se, experts)               # segment starts
    counts = torch.searchsorted(se, experts, right=True) - offset
    pos = torch.arange(n * k, device=dev) - offset[se]     # rank in expert
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E * C)
    rank = torch.sort(torch.argsort(order).reshape(n, k), dim=-1).values
    xs = _TokenGather.apply(xf.to(cd), st, rank)
    slot = torch.arange(C, device=dev)
    src = offset[:, None] + slot                            # [E, C]
    filled = slot < counts[:, None]
    buf = torch.where(filled[..., None],
                      xs[torch.where(filled, src, 0).reshape(-1)].reshape(
                          E, C, d), 0.0)
    return buf, st, keep, dest, sg, rank


def _moe_combine(y, keep, dest, sg, rank, cd):
    """Inverse of dispatch: y [E*C, d] -> [n, d], each kept pick's expert
    output times its gate (in the compute dtype), a token's picks added in
    sort order (``_token_sum``)."""
    gathered = torch.where(keep[:, None], y[torch.where(keep, dest, 0)],
                           0.0)
    return _token_sum(gathered * sg[:, None].to(cd), rank)


def _expert_ffn(p, buf, cfg):
    cd = _cd(cfg)
    h_g = torch.einsum("ecd,def->ecf", buf, p["wg"].to(cd))
    h_u = torch.einsum("ecd,def->ecf", buf, p["wu"].to(cd))
    h = _act(h_g, cfg.act) * h_u
    return torch.einsum("ecf,fed->ecd", h, p["wd"].to(cd))


def moe_apply(p, x, cfg):
    """x: [B, T, d] -> [B, T, d]. Aux-loss-free top-k with renormalized
    gates; dropped tokens pass through the residual. ``repro``'s global
    path (one sort over all tokens), which it takes without a mesh, as on
    one card; the per-shard ``"local"`` path comes with the sharding slice
    (ROADMAP.md, Queue 1 item 15b)."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    cd = _cd(cfg)
    n = B * T
    xf = x.reshape(n, d)
    C = moe_capacity(cfg, n)
    gate, eid = _router(p, xf, cfg)
    buf, _, keep, dest, sg, rank = _moe_dispatch(xf, eid, gate, E, k, C, cd)
    y = _expert_ffn(p, buf, cfg).reshape(E * C, d)
    return _moe_combine(y, keep, dest, sg, rank, cd).reshape(B, T, d)


# --------------------------------------------------------------------------
# Embedding / unembedding (untied or tied, optionally sqrt(d)-scaled)
# --------------------------------------------------------------------------


def embed_specs(cfg):
    dt = cfg.param_dtype
    s = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), dt,
                                ("vocab", "embed"), "normal", 0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = fan_in_normal((cfg.d_model, cfg.vocab_size), 0, dt,
                                     ("embed", "vocab"))
    return s


def embed_apply(p, tokens, cfg):
    """The embedding rows in the compute dtype; gemma-style, times
    sqrt(d_model) taken in the compute dtype, as JAX rounds the Python
    float (55.43 -> 55.5 in bfloat16 at d_model 3 072)."""
    x = p["embedding"][tokens.long()].to(_cd(cfg))
    if cfg.embed_scale:
        x = x * _const(float(np.sqrt(cfg.d_model)), x.dtype, x.device)
    return x


def unembed_apply(p, x, cfg):
    cd = _cd(cfg)
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", x.to(cd),
                            p["embedding"].to(cd)).float()
    return torch.einsum("btd,dv->btv", x.to(cd),
                        p["unembed"].to(cd)).float()
