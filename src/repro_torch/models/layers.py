"""Transformer building blocks (twin of ``repro.models.layers``, the dense
causal subset that qwen3-14b runs).

Everything is a (specs, apply) pair over plain dicts of tensors. Numerics
follow ``repro``: params in ``cfg.param_dtype``, each weight cast to
``cfg.compute_dtype`` at its use (a second, bf16 copy of the weights is
never kept), softmax and norms in float32.

The two LM kernels sit where ``repro.kernels.ops`` says model code should
call them: ``norm_apply`` and the qk-norm ``_rms`` go through
``kernels.ops.rmsnorm`` (K6), and causal self-attention, in prefill and
decode, through ``kernels.ops.flash_attention`` (K5). K5 keeps the scores
and the softmax weights in float32 where ``repro``'s ``_sdpa`` rounds both
to bfloat16, so the port's attention is the kernel's, not ``_sdpa``'s
(the tests hold the two apart).

The slice's scope (rmsnorm, SwiGLU, RoPE, untied embeddings, causal
self-attention) is checked once, in ``lm.check_config``; the branches of
``repro``'s layers for other configurations (layernorm, GeGLU and plain
MLPs, tied or scaled or learned-position embeddings, cross, bidirectional
and ring-buffer attention, MoE) come with the slices that run them
(ROADMAP.md, Queue 1 item 15). The mesh helpers (``constrain``,
``tp_proj_out``'s sharded branch) wait for the sharding slice (item 14):
``tp_proj_out`` is a plain product.
"""
from __future__ import annotations

import functools
import math

import torch

from ..kernels import ops
from .spec import ParamSpec, fan_in_normal, torch_dtype


def _cd(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def tp_proj_out(h, w, cfg):
    """h: [B, T, F], w: [F, d] -> [B, T, d] in the compute dtype."""
    cd = _cd(cfg)
    return torch.einsum("btf,fd->btd", h.to(cd), w.to(cd))


# --------------------------------------------------------------------------
# Norms (rmsnorm)
# --------------------------------------------------------------------------


def norm_specs(d: int, dtype: str):
    return {"scale": ParamSpec((d,), dtype, ("embed",), "ones")}


def norm_apply(p, x, eps: float = 1e-6):
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
# Attention (GQA, causal)
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


def _flash(q, k, v):
    """Causal K5 on the model's layout: q [B,T,H,Dh], k/v [B,S,KV,Dh] ->
    [B,T,H*Dh]. The kernel's output is laid out [B,T,H,Dh], so the reshape
    is free."""
    B, T, H, Dh = q.shape
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=True)
    return out.permute(0, 2, 1, 3).reshape(B, T, H * Dh)


def _sdpa(q, k, v, mask, cfg):
    """``repro``'s plain attention with its bfloat16 roundings (scaled q,
    scores and softmax weights in the compute dtype): q [B,T,H,Dh], k/v
    [B,S,KV,Dh], mask broadcastable to [B,?,T,S]. The port's causal
    attention runs K5 instead; this is kept for the mask kinds K5 does not
    serve (cross, ring-buffer decode), which come with later slices
    (ROADMAP.md, Queue 1 item 15)."""
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


def attn_forward(p, x, cfg, return_kv: bool = False):
    """Full-sequence causal self-attention (prefill) through K5."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, pos)
    y = tp_proj_out(_flash(q, k, v), p["wo"], cfg)
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p, x, cache_k, cache_v, index: int, cfg):
    """One-token decode. cache_[kv]: [B, S, KV, Dh]; ``index`` is the number
    of tokens already in context (this token's position). The new k/v are
    written into the cache at ``index`` in place (the caches are returned
    too, as ``repro`` returns its updated copies). K5 reads the cache's
    first ``index + 1`` positions causally, which masks what ``repro``'s
    ``valid = sidx <= index`` masks."""
    index = int(index)
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                     device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, pos)
    cache_k[:, index:index + 1] = k_new.to(cache_k.dtype)
    cache_v[:, index:index + 1] = v_new.to(cache_v.dtype)
    out = _flash(q, cache_k[:, :index + 1].to(q.dtype),
                 cache_v[:, :index + 1].to(q.dtype))
    y = torch.einsum("bte,ed->btd", out, p["wo"].to(_cd(cfg)))
    return y, cache_k, cache_v


# --------------------------------------------------------------------------
# Dense MLP (SwiGLU)
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


def mlp_apply(p, x, cfg):
    cd = _cd(cfg)
    h = torch.einsum("btd,df->btf", x.to(cd), p["wu"].to(cd))
    g = torch.einsum("btd,df->btf", x.to(cd), p["wg"].to(cd))
    return tp_proj_out(_silu(g) * h, p["wd"], cfg)


# --------------------------------------------------------------------------
# Embedding / unembedding (untied)
# --------------------------------------------------------------------------


def embed_specs(cfg):
    dt = cfg.param_dtype
    return {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), dt,
                                   ("vocab", "embed"), "normal", 0.02),
            "unembed": fan_in_normal((cfg.d_model, cfg.vocab_size), 0, dt,
                                     ("embed", "vocab"))}


def embed_apply(p, tokens, cfg):
    return p["embedding"][tokens.long()].to(_cd(cfg))


def unembed_apply(p, x, cfg):
    cd = _cd(cfg)
    return torch.einsum("btd,dv->btv", x.to(cd),
                        p["unembed"].to(cd)).float()
