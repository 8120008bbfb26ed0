"""Device dispatch of the kernels (twin of ``repro.kernels.ops``).

CUDA tensors go to the hand-written CUDA kernels, CPU tensors to their
plain PyTorch versions (``kernels/ref.py``). The choice follows only the
device of the tensors given: there is no switch, and no fallback — on a
CUDA tensor a kernel that fails to build or launch raises.

``flash_attention`` and ``rmsnorm`` carry gradients through
``torch.autograd.Function``s (``_FlashAttention``, ``_RMSNorm``) when an
input requires grad: forward and backward each dispatch on the device,
the backward to K5's and K6's backward kernels on the card
(``flash_attention_bwd``, ``rmsnorm_bwd``) and to their plain versions
on the CPU. Without grad they call the forward alone, as the serve path
always does.
"""
from __future__ import annotations

import torch

from . import ref
from . import flash_attention as _flash
from . import fused_tick as _tick
from . import powertcp_step as _law
from . import queue_arrivals as _queue
from . import rmsnorm as _rmsnorm


def on_cuda(x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def powertcp_step(q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs,
                  upd, beta, *, gamma=0.9, w_min=1000.0):
    args = (q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs, upd,
            beta)
    if on_cuda(q):
        return _law.powertcp_step(*args, gamma=gamma, w_min=w_min)
    return ref.powertcp_step_ref(*args, gamma=gamma, w_min=w_min)


def theta_powertcp_step(theta, prev_theta, tau, w, w_old, gs_prev, dt_obs,
                        upd, beta, *, gamma=0.9, w_min=1000.0):
    args = (theta, prev_theta, tau, w, w_old, gs_prev, dt_obs, upd, beta)
    if on_cuda(theta):
        return _law.theta_powertcp_step(*args, gamma=gamma, w_min=w_min)
    return ref.theta_powertcp_step_ref(*args, gamma=gamma, w_min=w_min)


def queue_arrivals(lam_del, onehot, q, out_rate, caps, *, dt):
    if on_cuda(onehot):
        return _queue.queue_arrivals(lam_del, onehot, q, out_rate, caps,
                                     dt=dt)
    return ref.queue_arrivals_ref(lam_del, onehot, q, out_rate, caps, dt)


def fused_tick_block(tick, carry, due_block, *, record=True, record_every=1):
    """K ticks of the megakernel over a batch's carry: K4 on CUDA tensors
    (with ``tick.k4_params()``, ``tick.gate`` and the schedule window's
    offset ``tick.win_off``, one block per scenario), the plain tick loop
    on CPU tensors."""
    if on_cuda(carry.state.w):
        return _tick.fused_tick_block(tick.k4_params(), carry, due_block,
                                      record=record,
                                      record_every=record_every,
                                      gate=tick.gate, win_off=tick.win_off)
    return ref.fused_tick_block_ref(tick, carry, due_block, record=record,
                                    record_every=record_every)


class _FlashAttention(torch.autograd.Function):
    """K5 with its backward: the forward keeps the output and its
    float32 log-sum-exp, the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if on_cuda(q):
            o, lse = _flash.flash_attention(q, k, v, causal=causal,
                                            window=window, return_lse=True)
        else:
            o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        args = (q, k, v, o, lse, do)
        if on_cuda(q):
            dq, dk, dv = _flash.flash_attention_bwd(
                *args, causal=ctx.causal, window=ctx.window)
        else:
            dq, dk, dv = ref.flash_attention_bwd_ref(
                *args, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


class _RMSNorm(torch.autograd.Function):
    """K6 with its backward (rstd recomputed from x)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        if on_cuda(x):
            y = _rmsnorm.rmsnorm(x, scale, eps=eps)
        else:
            y = ref.rmsnorm_ref(x, scale, eps=eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if on_cuda(x):
            dx, dscale = _rmsnorm.rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        else:
            dx, dscale = ref.rmsnorm_bwd_ref(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B,H,T,D]; k, v: [B,KV,S,D]. K5 on CUDA tensors, the plain
    attention on CPU tensors; differentiable (``_FlashAttention``) when an
    input requires grad."""
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    if on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def rmsnorm(x, scale, *, eps=1e-6):
    """RMSNorm over the last dim: K6 on CUDA tensors, the plain version on
    CPU tensors; differentiable (``_RMSNorm``) when an input requires
    grad."""
    if _wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    if on_cuda(x):
        return _rmsnorm.rmsnorm(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps=eps)
