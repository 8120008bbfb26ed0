"""Device dispatch of the kernels (twin of ``repro.kernels.ops``).

CUDA tensors go to the hand-written CUDA kernels, CPU tensors to their
plain PyTorch versions (``kernels/ref.py``). The choice follows only the
device of the tensors given: there is no switch, and no fallback — on a
CUDA tensor a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from . import ref
from . import flash_attention as _flash
from . import fused_tick as _tick
from . import powertcp_step as _law
from . import queue_arrivals as _queue
from . import rmsnorm as _rmsnorm


def _on_cuda(x) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def powertcp_step(q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs,
                  upd, beta, *, gamma=0.9, w_min=1000.0):
    args = (q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs, upd,
            beta)
    if _on_cuda(q):
        return _law.powertcp_step(*args, gamma=gamma, w_min=w_min)
    return ref.powertcp_step_ref(*args, gamma=gamma, w_min=w_min)


def theta_powertcp_step(theta, prev_theta, tau, w, w_old, gs_prev, dt_obs,
                        upd, beta, *, gamma=0.9, w_min=1000.0):
    args = (theta, prev_theta, tau, w, w_old, gs_prev, dt_obs, upd, beta)
    if _on_cuda(theta):
        return _law.theta_powertcp_step(*args, gamma=gamma, w_min=w_min)
    return ref.theta_powertcp_step_ref(*args, gamma=gamma, w_min=w_min)


def queue_arrivals(lam_del, onehot, q, out_rate, caps, *, dt):
    if _on_cuda(onehot):
        return _queue.queue_arrivals(lam_del, onehot, q, out_rate, caps,
                                     dt=dt)
    return ref.queue_arrivals_ref(lam_del, onehot, q, out_rate, caps, dt)


def fused_tick_block(tick, carry, due_block, *, record=True, record_every=1):
    """K ticks of the megakernel: K4 on CUDA tensors (with
    ``tick.k4_params()``), the plain tick loop on CPU tensors."""
    if _on_cuda(carry.state.w):
        return _tick.fused_tick_block(tick.k4_params(), carry, due_block,
                                      record=record,
                                      record_every=record_every)
    return ref.fused_tick_block_ref(tick, carry, due_block, record=record,
                                    record_every=record_every)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B,H,T,D]; k, v: [B,KV,S,D]. K5 on CUDA tensors, the plain
    attention on CPU tensors."""
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def rmsnorm(x, scale, *, eps=1e-6):
    """RMSNorm over the last dim: K6 on CUDA tensors, the plain version on
    CPU tensors."""
    if _on_cuda(x):
        return _rmsnorm.rmsnorm(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps=eps)
