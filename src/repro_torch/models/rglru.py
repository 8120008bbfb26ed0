"""RG-LRU recurrent block (twin of ``repro.models.rglru``; Griffin /
RecurrentGemma, arXiv:2402.19427).

Block layout (recurrentgemma-2b, d_rnn = 2560):
  x -> [branch a] linear -> conv1d(4, depthwise) -> RG-LRU -> * gelu(branch b)
       [branch b] linear
    -> down-projection back to d_model

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_a x_t)            recurrence gate
  i_t = sigmoid(W_x x_t)            input gate
  a_t = exp(-c * softplus(Lambda) * r_t),   c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``repro`` has no Pallas kernel here: the products are ``torch.einsum``s,
the gates and the scan elementwise torch, differentiated by autograd.

Numerics. The scan is ``jax.lax.associative_scan``'s recursion spelled
in torch (``rglru_scan``), with its combine's ``b1 * a2 + b2`` a fused
multiply-add as XLA:CPU compiles it (``_fma``), so the hidden states are
``repro``'s bits for the same gates; a sequential loop, or the unfused
sum, differs in half of them. The depthwise conv (``_conv``) adds its
four products one at a time in the compute dtype, as ``repro`` does
(fused in float32, as XLA:CPU fuses them). The gates' ``sigmoid``, ``softplus`` and ``exp`` are torch's, which
differ from XLA:CPU's float32 ones in the last bits (ROADMAP.md, Queue 3
fault 7).
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import _gelu
from .spec import ParamSpec, fan_in_normal, torch_dtype

RGLRU_C = 8.0

# Gate matrices are block-diagonal, 16 blocks (``repro``'s choice, so each
# block lives inside one tensor-parallel shard).
GATE_BLOCKS = 16


def _gate_blocks(dr: int) -> int:
    nb = GATE_BLOCKS
    while dr % nb:
        nb //= 2
    return max(nb, 1)


def rglru_specs(cfg):
    d, dr, dt = cfg.d_model, cfg.d_rnn_eff, cfg.param_dtype
    nb = _gate_blocks(dr)
    bs = dr // nb
    return {
        "w_in": fan_in_normal((d, dr), 0, dt, ("embed", "rnn")),
        "w_gate": fan_in_normal((d, dr), 0, dt, ("embed", "rnn")),
        "conv_w": ParamSpec((cfg.rglru_conv, dr), dt, (None, "rnn"),
                            "normal", 1.0 / np.sqrt(cfg.rglru_conv)),
        "conv_b": ParamSpec((dr,), dt, ("rnn",), "zeros"),
        "w_a": fan_in_normal((nb, bs, bs), 1, dt, ("rnn", None, None)),
        "w_x": fan_in_normal((nb, bs, bs), 1, dt, ("rnn", None, None)),
        # Lambda init so that a ~ U(0.9, 0.999)^c at r=1 (paper appendix)
        "lam": ParamSpec((dr,), "float32", (None,), "constant", 0.08),
        "w_out": fan_in_normal((dr, d), 0, dt, ("rnn", "embed")),
    }


def _fma(a, b, c):
    """a * b + c rounded once to float32, as a fused multiply-add (``a`` a
    float32 tensor, ``b`` a float32 value or tensor, ``c`` a float32
    tensor): the product of two float32 values is exact in float64. Where
    XLA:CPU contracts a multiply-add (here, and in ``train/optim.py``),
    the port spells it so."""
    return torch.add(a.double() * (b.double() if torch.is_tensor(b) else b),
                     c.double()).float()


def _gates(xb, p, cd):
    """(a, gated input) in float32 for xb [B, S, dr] in the compute
    dtype."""
    B, S, dr = xb.shape
    nb = p["w_a"].shape[0]
    x4 = xb.reshape(B, S, nb, dr // nb)
    r = torch.sigmoid(torch.einsum("bsnk,nkj->bsnj", x4, p["w_a"].to(cd))
                      .reshape(B, S, dr).float())
    i = torch.sigmoid(torch.einsum("bsnk,nkj->bsnj", x4, p["w_x"].to(cd))
                      .reshape(B, S, dr).float())
    log_a = -RGLRU_C * torch.nn.functional.softplus(p["lam"].float())[
        None, None] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), 1e-9, 1.0)) \
        * i * xb.float()
    return a, gated


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along dim 1 (``even`` holds as many elements
    as ``odd`` or one more)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]],
                                                      dim=1)


def _combine(x, y):
    """The scan's operator: (a1, b1) then (a2, b2) is (a1 a2, b1 a2 + b2),
    the sum a fused multiply-add."""
    (a1, b1), (a2, b2) = x, y
    return a1 * a2, _fma(b1, a2, b2)


def _assoc_scan(a, b):
    """``jax.lax.associative_scan(op, (a, b), axis=1)``'s recursion: combine
    adjacent pairs, scan the reduced sequence, fill in the even elements,
    interleave. log2(S) levels of whole-tensor operations."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t via associative scan. a, b: [B, S, D]
    float32; h0 [B, D] folds into the first step as a fused
    multiply-add."""
    if h0 is not None:
        b = torch.cat([_fma(a[:, :1], h0[:, None].float(), b[:, :1]),
                       b[:, 1:]], dim=1)
    return _assoc_scan(a, b)[1]


def rglru_forward(p, x, cfg, h0=None, conv_state=None,
                  return_state: bool = False):
    """x: [B, S, d_model] -> [B, S, d_model] (and, with ``return_state``,
    the last hidden state [B, dr] float32 and the conv tail)."""
    cd = torch_dtype(cfg.compute_dtype)
    xb = torch.einsum("bsd,dr->bsr", x.to(cd), p["w_in"].to(cd))
    gate = torch.einsum("bsd,dr->bsr", x.to(cd), p["w_gate"].to(cd))
    xb, conv_out = _conv(xb, p["conv_w"], p["conv_b"], conv_state)
    a, bterm = _gates(xb, p, cd)
    h = rglru_scan(a, bterm, h0)
    y = h.to(cd) * _gelu(gate)
    out = torch.einsum("bsr,rd->bsd", y, p["w_out"].to(cd))
    if return_state:
        return out, h[:, -1].float(), conv_out
    return out


def rglru_decode(p, x, cfg, h, conv_state):
    """One-token step. h: [B, d_rnn] float32; conv_state: [B, k-1, d_rnn].
    Returns (out, h_new, conv_state)."""
    cd = torch_dtype(cfg.compute_dtype)
    xb = torch.einsum("bsd,dr->bsr", x.to(cd), p["w_in"].to(cd))
    gate = torch.einsum("bsd,dr->bsr", x.to(cd), p["w_gate"].to(cd))
    xb, conv_state = _conv(xb, p["conv_w"], p["conv_b"], conv_state)
    a, bterm = _gates(xb, p, cd)
    h_new = _fma(a[:, 0], h.float(), bterm[:, 0])
    y = h_new[:, None].to(cd) * _gelu(gate)
    out = torch.einsum("bsr,rd->bsd", y, p["w_out"].to(cd))
    return out, h_new, conv_state


def _conv(xb, w, bias, state=None):
    """Causal depthwise conv over time, xb [B, S, ch], w [k, ch]: the k
    products added to zeros one at a time, then the bias, each operation
    in xb's dtype, as ``repro`` writes it. In float32 XLA:CPU contracts
    the sum into fused multiply-adds (the first product into the second's
    sum, then each later one into the running sum), which the port
    spells. Returns (out, the last k-1 inputs)."""
    k = w.shape[0]
    if state is None:
        pad = xb.new_zeros((xb.shape[0], k - 1, xb.shape[2]))
    else:
        pad = state.to(xb.dtype)
    full = torch.cat([pad, xb], dim=1)
    S = xb.shape[1]
    taps = [(full[:, i:i + S], w[i][None, None].to(xb.dtype))
            for i in range(k)]
    if xb.dtype == torch.float32 and k > 1:
        out = _fma(*taps[0], taps[1][0] * taps[1][1])
        for x_i, w_i in taps[2:]:
            out = _fma(x_i, w_i, out)
    else:
        out = 0
        for x_i, w_i in taps:
            out = out + x_i * w_i
    new_state = full[:, full.shape[1] - (k - 1):] if k > 1 else pad[:, :0]
    return out + bias.to(xb.dtype)[None, None], new_state
