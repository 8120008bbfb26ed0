"""Wrappers of the PowerTCP control-law kernels (``csrc/powertcp_step.cu``).

K1 ``powertcp_step`` replaces ``repro/kernels/powertcp_step.py::powertcp_step``
(Algorithm 1: NORMPOWER over the path's hops, EWMA smoothing and
UPDATEWINDOW in one pass); K2 ``theta_powertcp_step`` replaces
``theta_powertcp_step`` (Algorithm 2, elementwise). One CUDA thread per
flow; per-hop inputs in the engine's [F, H] layout. Both are bound by the
bytes they move (about 13 words per flow), and at the simulator's widths
by the launch itself.

These launch the CUDA kernel and take CUDA tensors only; ``kernels/ops.py``
sends CPU tensors to the plain versions in ``kernels/ref.py`` instead.
The kernels equal those plain versions bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "powertcp_step_f32": [_P] * 14 + [_I, _I, _F, _F, _F, _P],
    "theta_powertcp_step_f32": [_P] * 12 + [_I, _F, _F, _F, _P],
}


def _lib():
    return _build.library("powertcp_step", _SIGNATURES)


def powertcp_step(q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs,
                  upd, beta, *, gamma=0.9, w_min=1000.0):
    """Per-hop tensors [F, H] (float32; ``valid`` bool); per-flow tensors
    [F] (float32; ``upd`` bool). Returns (w, gs)."""
    F, H = q.shape
    flow = (F,)
    _build.check_tensors(
        "powertcp_step",
        dict(q=q, qdot=qdot, mu=mu, b=b, valid=valid, tau=tau, w=w,
             w_old=w_old, gs_prev=gs_prev, dt_obs=dt_obs, upd=upd,
             beta=beta),
        dict(q=(F, H), qdot=(F, H), mu=(F, H), b=(F, H), valid=(F, H),
             tau=flow, w=flow, w_old=flow, gs_prev=flow, dt_obs=flow,
             upd=flow, beta=flow), q.device)
    w_out = torch.empty_like(w)
    gs_out = torch.empty_like(w)
    if F == 0:
        return w_out, gs_out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.powertcp_step_f32(
            q.data_ptr(), qdot.data_ptr(), mu.data_ptr(), b.data_ptr(),
            valid.data_ptr(), tau.data_ptr(), w.data_ptr(),
            w_old.data_ptr(), gs_prev.data_ptr(), dt_obs.data_ptr(),
            upd.data_ptr(), beta.data_ptr(), w_out.data_ptr(),
            gs_out.data_ptr(), F, H, gamma, 1.0 - gamma, w_min, stream)
    _build.check(err, "powertcp_step")
    _build.LAUNCHES["powertcp_step"] += 1
    return w_out, gs_out


def theta_powertcp_step(theta, prev_theta, tau, w, w_old, gs_prev, dt_obs,
                        upd, beta, *, gamma=0.9, w_min=1000.0):
    """All tensors per flow [F] (float32; ``upd`` bool). Returns
    (w, gs, prev_theta)."""
    (F,) = theta.shape
    flow = (F,)
    _build.check_tensors(
        "theta_powertcp_step",
        dict(theta=theta, prev_theta=prev_theta, tau=tau, w=w,
             w_old=w_old, gs_prev=gs_prev, dt_obs=dt_obs, upd=upd,
             beta=beta),
        dict(theta=flow, prev_theta=flow, tau=flow, w=flow, w_old=flow,
             gs_prev=flow, dt_obs=flow, upd=flow, beta=flow), theta.device)
    w_out = torch.empty_like(w)
    gs_out = torch.empty_like(w)
    prev_out = torch.empty_like(w)
    if F == 0:
        return w_out, gs_out, prev_out
    lib = _lib()
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.theta_powertcp_step_f32(
            theta.data_ptr(), prev_theta.data_ptr(), tau.data_ptr(),
            w.data_ptr(), w_old.data_ptr(), gs_prev.data_ptr(),
            dt_obs.data_ptr(), upd.data_ptr(), beta.data_ptr(),
            w_out.data_ptr(), gs_out.data_ptr(), prev_out.data_ptr(), F,
            gamma, 1.0 - gamma, w_min, stream)
    _build.check(err, "theta_powertcp_step")
    _build.LAUNCHES["theta_powertcp_step"] += 1
    return w_out, gs_out, prev_out
