"""Device dispatch of the kernels (twin of ``repro.kernels.ops``).

CUDA tensors go to the hand-written CUDA kernels, CPU tensors to their
plain PyTorch versions (``kernels/ref.py``). The choice follows only the
device of the tensors given: there is no switch, and no fallback — on a
CUDA tensor a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from . import ref
from . import powertcp_step as _law
from . import queue_arrivals as _queue


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
