"""Mamba2 mixer via SSD (state-space duality), arXiv:2405.21060 (twin of
``repro.models.ssm``).

Forward (training/prefill) uses the chunked SSD algorithm: quadratic
attention-like blocks within chunks of length ``CHUNK`` plus a linear
inter-chunk state recurrence (a loop over the chunks in place of
``lax.scan``). Decode is the O(1) recurrent update on a per-head state of
shape [P, N].

Layout (mamba2-130m): d_model=768, expand=2 -> d_inner=1536, headdim P=64
-> H=24 heads, state N=128, groups G=1, conv width 4 over the (x|B|C)
channels. in_proj emits [z | x | B | C | dt].

``repro`` has no Pallas kernel here: the products are ``torch.einsum``s
and the gated norm (``_rmsnorm_gated``) is plain float32 torch, not K6,
as ``repro`` computes it in jnp. Each three-operand einsum of ``repro``
is spelled as the two products JAX splits it into, in JAX's order (the
elementwise one first, but for ``y_off``, which contracts C with the
states first).
Where XLA:CPU compiles the inter-chunk recurrence's ``prev * dec + st``
as a fused multiply-add, the port rounds it once too (``rglru._fma``).
The within-chunk cumulative sums follow ``jnp.cumsum``'s order as
XLA:CPU lowers it (``_cumsum``: sequential sums within blocks of 16, the
blocks' offsets by the same rule one level up), which ``torch.cumsum``
does not. The decays' ``exp`` is torch's, which differs from XLA:CPU's
in the last float32 bits (ROADMAP.md, Queue 3 fault 7).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .rglru import _conv, _fma
from .layers import _silu
from .spec import ParamSpec, fan_in_normal, torch_dtype

CHUNK = 256
NGROUPS = 1


def mamba_dims(cfg):
    d_in = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    conv_ch = d_in + 2 * NGROUPS * N
    d_proj = 2 * d_in + 2 * NGROUPS * N + H
    return d_in, H, N, conv_ch, d_proj


def mamba_specs(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, H, N, conv_ch, d_proj = mamba_dims(cfg)
    return {
        "in_proj": fan_in_normal((d, d_proj), 0, dt, ("embed", "inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), dt, (None, "inner"),
                            "normal", 1.0 / np.sqrt(cfg.ssm_conv)),
        "conv_b": ParamSpec((conv_ch,), dt, ("inner",), "zeros"),
        "a_log": ParamSpec((H,), "float32", (None,), "constant", 0.5),
        "dt_bias": ParamSpec((H,), "float32", (None,), "zeros"),
        "d_skip": ParamSpec((H,), "float32", (None,), "ones"),
        "norm": ParamSpec((d_in,), dt, ("inner",), "ones"),
        "out_proj": fan_in_normal((d_in, d), 0, dt, ("inner", "embed")),
    }


# XLA:CPU's cumulative sum: a reduce-window over at most this many
# elements, longer axes split into blocks of it
_CUMSUM_BASE = 16


def _prefix(x):
    """The inclusive prefix sums over the last dim, added one at a time
    from the left, each addition in x's dtype."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def _exclusive(t):
    """0, t0, t0 + t1, ...: the offsets of blocks whose totals are t."""
    z = torch.zeros_like(t[..., :1])
    if t.shape[-1] == 1:
        return z
    head = (_prefix(t[..., :-1]) if t.shape[-1] <= _CUMSUM_BASE
            else _cumsum_last(t)[..., :-1])
    return torch.cat([z, head], dim=-1)


def _cumsum_last(x):
    """``jnp.cumsum`` over the last dim in XLA:CPU's order: up to
    ``_CUMSUM_BASE`` elements one sequential prefix; beyond, zero-padded
    to whole blocks of ``_CUMSUM_BASE``, each block's prefix, plus the
    block's offset (``_exclusive`` of the blocks' totals), each addition
    rounded to x's dtype."""
    n = x.shape[-1]
    if n <= _CUMSUM_BASE:
        return _prefix(x)
    m = -(-n // _CUMSUM_BASE) * _CUMSUM_BASE
    blocks = F.pad(x, (0, m - n)).reshape(
        x.shape[:-1] + (m // _CUMSUM_BASE, _CUMSUM_BASE))
    part = _prefix(blocks)
    out = part + _exclusive(part[..., -1])[..., None]
    return out.reshape(x.shape[:-1] + (m,))[..., :n]


def _cumsum(x, dim: int):
    """``jnp.cumsum(x, axis=dim)`` as XLA:CPU computes it."""
    return _cumsum_last(x.movedim(dim, -1)).movedim(-1, dim)


def _segsum(cs):
    """``repro``'s ``_segsum`` from the cumulative sums ``cs`` [..., L] of
    its input (the within-chunk ``acs``, already at hand): [..., L, L]
    lower-tri differences (log decays), -inf above the diagonal."""
    L = cs.shape[-1]
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=cs.device))
    return torch.where(mask, ss, float("-inf"))


def _repeat_groups(t, rep: int, dim: int):
    """``jnp.repeat(t, rep, axis=dim)``: each group's slice ``rep`` times
    in a row, by broadcasting (its gradient a plain sum over the copies,
    where ``repeat_interleave``'s is an atomic scatter-add on the
    card)."""
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1)
    t = t.expand(*t.shape[:dim + 1], rep, *t.shape[dim + 2:])
    shape[dim] *= rep
    return t.reshape(shape)


def _pad_time(t, pad):
    """t [b, s, ...] with ``pad`` zero steps appended along s."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_chunked(x, dt, a, B, C, chunk: int = CHUNK, h0=None):
    """Chunked SSD scan.

    x: [b, s, h, p]; dt: [b, s, h] (>0); a: [h] (<0); B, C: [b, s, g, n].
    Returns y: [b, s, h, p] and final state [b, h, p, n].
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = (_pad_time(t, pad) for t in (x, dt, B, C))
    sc = x.shape[1]
    c = sc // chunk
    rep = h // g

    xc = x.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Bc = _repeat_groups(B.reshape(b, c, chunk, g, n), rep, 3)  # [b,c,l,h,n]
    Cc = _repeat_groups(C.reshape(b, c, chunk, g, n), rep, 3)
    ac = dtc * a[None, None, None, :]                  # [b,c,l,h] log decay
    acs = _cumsum(ac, 2)                               # within-chunk cumsum
    xdt = xc * dtc[..., None]                          # fold dt into x

    # -- intra-chunk (quadratic within chunk) --------------------------------
    Lmat = torch.exp(_segsum(acs.transpose(2, 3)))     # [b,c,h,l,l]
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp",
                          scores * Lmat.to(scores.dtype), xdt)

    # -- chunk states + inter-chunk recurrence -------------------------------
    decay_states = torch.exp(acs[:, :, -1:, :] - acs)  # [b,c,l,h]
    states = torch.einsum("bclhn,bclhp->bchpn", Bc,
                          decay_states.to(Bc.dtype)[..., None] * xdt)
    chunk_decay = torch.exp(acs[:, :, -1, :])          # [b,c,h]

    carry = (x.new_zeros((b, h, p, n)) if h0 is None else h0.to(x.dtype))
    prev = []
    for ci in range(c):
        prev.append(carry)
        dec = chunk_decay[:, ci, :, None, None].to(carry.dtype)
        carry = _fma(carry.float(), dec.float(),
                     states[:, ci].float()).to(carry.dtype)
    prev_states = torch.stack(prev, dim=1)             # [b,c,h,p,n]

    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, prev_states) \
        * torch.exp(acs).to(Cc.dtype)[..., None]
    y = (y_diag + y_off).reshape(b, sc, h, p)[:, :s]
    return y, carry


def ssd_decode_step(state, x, dt, a, B, C):
    """state: [b,h,p,n]; x: [b,h,p]; dt: [b,h]; a: [h]; B,C: [b,g,n]."""
    h = x.shape[1]
    g = B.shape[1]
    rep = h // g
    Bh = _repeat_groups(B, rep, 1)                     # [b,h,n]
    Ch = _repeat_groups(C, rep, 1)
    dec = torch.exp(dt * a[None, :])                   # [b,h]
    upd = (x * dt.to(x.dtype)[..., None])[..., None] \
        * Bh.to(x.dtype)[:, :, None, :]
    new = state * dec[..., None, None].to(state.dtype) + upd
    y = torch.einsum("bhpn,bhn->bhp", new, Ch.to(new.dtype))
    return y, new


def _split_proj(zxbcdt, cfg):
    d_in, H, N, _, _ = mamba_dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * NGROUPS * N]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - H:]
    return z, xbc, dt_raw


def _conv_forward(xbc, w, bias, state=None):
    """Causal depthwise conv over time (``rglru._conv``), then SiLU.
    xbc: [b,s,ch]; w: [k,ch]."""
    out, new_state = _conv(xbc, w, bias, state)
    return _silu(out), new_state


def _dt_and_a(dt_raw, p, cd):
    """softplus(dt_raw + dt_bias) and A = -exp(a_log), in the compute
    dtype."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float()).to(cd)
    return dt, (-torch.exp(p["a_log"].float())).to(cd)


def mamba_forward(p, x, cfg, state=None, conv_state=None,
                  return_state: bool = False):
    """Full-sequence mixer. x: [b, s, d_model]."""
    b, s, _ = x.shape
    cd = torch_dtype(cfg.compute_dtype)
    d_in, H, N, conv_ch, _ = mamba_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", x.to(cd), p["in_proj"].to(cd))
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc, conv_out = _conv_forward(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :d_in].reshape(b, s, H, -1)
    B = xbc[..., d_in:d_in + NGROUPS * N].reshape(b, s, NGROUPS, N)
    C = xbc[..., d_in + NGROUPS * N:].reshape(b, s, NGROUPS, N)
    dt, a = _dt_and_a(dt_raw, p, cd)
    y, final = ssd_chunked(xs, dt, a, B, C, h0=state)
    y = y + xs * p["d_skip"].to(cd)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = _rmsnorm_gated(y, z, p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(cd))
    if return_state:
        return out, final, conv_out
    return out


def mamba_decode(p, x, cfg, state, conv_state):
    """One-token step. x: [b, 1, d]; state: [b,h,p,n]; conv: [b,k-1,ch]."""
    b = x.shape[0]
    cd = torch_dtype(cfg.compute_dtype)
    d_in, H, N, conv_ch, _ = mamba_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", x.to(cd), p["in_proj"].to(cd))
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc, conv_state = _conv_forward(xbc, p["conv_w"], p["conv_b"],
                                    conv_state)
    xs = xbc[:, 0, :d_in].reshape(b, H, -1)
    B = xbc[:, 0, d_in:d_in + NGROUPS * N].reshape(b, NGROUPS, N)
    C = xbc[:, 0, d_in + NGROUPS * N:].reshape(b, NGROUPS, N)
    dt, a = _dt_and_a(dt_raw[:, 0], p, cd)
    y, state = ssd_decode_step(state, xs, dt, a, B, C)
    y = y + xs * p["d_skip"].to(cd)[None, :, None]
    y = y.reshape(b, 1, d_in)
    y = _rmsnorm_gated(y, z, p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(cd))
    return out, state, conv_state


def _rmsnorm_gated(y, z, scale, eps=1e-6):
    """RMSNorm of y * silu(z) over the last dim, in float32, out in y's
    dtype (plain torch, as ``repro`` computes it). The product is taken
    in float32 of its two compute-dtype factors: XLA:CPU computes a
    bfloat16 operation whose result is only read back as float32 in
    float32 (it allows excess precision), so ``repro``'s product is not
    rounded to bfloat16."""
    yf = y.float() * _silu(z).float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)
