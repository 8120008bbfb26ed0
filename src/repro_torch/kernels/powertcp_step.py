"""Wrappers of the PowerTCP control-law kernels (``csrc/powertcp_step.cu``).

K1 ``powertcp_step`` replaces ``repro/kernels/powertcp_step.py::powertcp_step``
(Algorithm 1: NORMPOWER over the path's hops, EWMA smoothing and
UPDATEWINDOW in one pass); K2 ``theta_powertcp_step`` replaces
``theta_powertcp_step`` (Algorithm 2, elementwise). One CUDA thread per
flow; per-hop inputs in the engine's [F, H] layout. Both are bound by the
bytes they move (about 13 words per flow), and at the simulator's widths
by the launch itself. A batch of scenarios ([B, F, H] and [B, F]) is one
launch over its B*F flat rows: the rows are independent, so the batch
changes nothing in any row's arithmetic.

These launch the CUDA kernel and take CUDA tensors only; ``kernels/ops.py``
sends CPU tensors to the plain versions in ``kernels/ref.py`` instead.
The kernels equal those plain versions bit for bit.

The engines' form of each law, ``powertcp_observe_step`` and
``theta_powertcp_observe_step``, reads its telemetry from the engine's
rings itself: one launch a tick for the batch does what the tick's
observation (``core/fluid.py::_observe``), the law, the window clamp and
the update times do as ~50 eager ops. Their plain versions are that op
sequence (``core/backends.py``, which also sends CPU tensors there); the
kernels equal it bit for bit. ``launch_floor`` launches an empty kernel
through the same interface, the floor the law kernels stand against.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_OBS_PTRS = ("hist_q hist_out hist_w path tf_steps rtt_steps bw tau nic "
             "theta_now w gs_prev prev_theta next_update last_update active "
             "started admit_t slot_flow cfg_tau cfg_beta w_out gs_out "
             "prev_out next_out last_out").split()
_OBS_INTS = ("B F H D Q N ptr t tau_mode beta_mode has_period "
             "bw_stride").split()
_OBS_FLOATS = ("t_sec dt inv_dt next_period gamma one_minus_gamma "
               "w_min").split()
MAX_HOPS = 16


class _ObserveArgs(ctypes.Structure):
    """``struct ObserveArgs`` of ``csrc/powertcp_step.cu``, field for
    field."""
    _fields_ = ([(n, _P) for n in _OBS_PTRS] + [(n, _I) for n in _OBS_INTS]
                + [(n, _F) for n in _OBS_FLOATS])


_SIGNATURES = {
    "powertcp_step_f32": [_P] * 14 + [_I, _I, _F, _F, _F, _P],
    "theta_powertcp_step_f32": [_P] * 12 + [_I, _F, _F, _F, _P],
    "powertcp_observe_step_f32": [ctypes.POINTER(_ObserveArgs), _P],
    "theta_powertcp_observe_step_f32": [ctypes.POINTER(_ObserveArgs), _P],
    "observe_step_abi": [],
    "launch_floor_f32": [_P],
}


def _lib():
    lib = _build.library("powertcp_step", _SIGNATURES)
    size = lib.observe_step_abi()
    if size != ctypes.sizeof(_ObserveArgs):
        raise RuntimeError(
            f"powertcp_step: csrc/powertcp_step.cu's ObserveArgs ({size} "
            f"bytes) does not match the wrapper's "
            f"({ctypes.sizeof(_ObserveArgs)})")
    return lib


def powertcp_step(q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs,
                  upd, beta, *, gamma=0.9, w_min=1000.0):
    """Per-hop tensors [..., F, H] (float32; ``valid`` bool); per-flow
    tensors [..., F] (float32; ``upd`` bool), any leading batch axes
    flattened into the rows of one launch. Returns (w, gs)."""
    H = q.shape[-1]
    flow = tuple(q.shape[:-1])
    F = 1
    for n in flow:
        F *= n
    _build.check_tensors(
        "powertcp_step",
        dict(q=q, qdot=qdot, mu=mu, b=b, valid=valid, tau=tau, w=w,
             w_old=w_old, gs_prev=gs_prev, dt_obs=dt_obs, upd=upd,
             beta=beta),
        dict(q=flow + (H,), qdot=flow + (H,), mu=flow + (H,),
             b=flow + (H,), valid=flow + (H,), tau=flow, w=flow, w_old=flow, gs_prev=flow, dt_obs=flow,
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
    """All tensors per flow [..., F] (float32; ``upd`` bool), any leading
    batch axes flattened into the rows of one launch. Returns
    (w, gs, prev_theta)."""
    flow = tuple(theta.shape)
    F = theta.numel()
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


def _cfg_mode(name, x, B, F, n_flows):
    """How the kernel reads a law-config leaf: 0 per scenario ([B, 1]),
    1 per row ([B, F]), 2 per schedule entry ([B, n_flows], through the
    rows' ``slot_flow``; given ``n_flows``)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"observe step: {name} must be a tensor, got "
                        f"{type(x).__name__}")
    shape = tuple(x.shape)
    if n_flows is not None and shape == (B, n_flows):
        return 2
    if shape == (B, 1):
        return 0
    if shape == (B, F):
        return 1
    raise ValueError(f"observe step: {name} has shape {shape}; expected "
                     f"({B}, 1), ({B}, {F})"
                     + ("" if n_flows is None else f" or ({B}, {n_flows})"))


def _observe_step(law, *, hist_q, hist_out, hist_w, path, tf_steps,
                  rtt_steps, bw, tau, nic, theta_now, w, gs_prev, prev_theta,
                  next_update, last_update, active, started, admit_t,
                  slot_flow, n_flows, cfg_tau, cfg_beta, t, t_sec, ptr, dt,
                  update_period, gamma, w_min):
    what = ("powertcp_observe_step", "theta_powertcp_observe_step")[law]
    B, F = (int(n) for n in w.shape)
    H = int(path.shape[-1])
    D, Q1 = (int(n) for n in hist_q.shape[-2:])
    if H > MAX_HOPS:
        raise ValueError(f"{what}: paths of {H} hops; the kernel unrolls at "
                         f"most {MAX_HOPS}")
    if not 0 <= ptr < D:
        raise ValueError(f"{what}: ring pointer {ptr} outside [0, {D})")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    row, hop = (B, F), (B, F, H)
    leaves = {"hist_q": (hist_q, f32, (B, D, Q1)),
              "hist_w": (hist_w, f32, (B, D, F)),
              "path": (path, i32, hop), "tf_steps": (tf_steps, i32, hop),
              "rtt_steps": (rtt_steps, i32, row),
              "bw": (bw, f32, (Q1,) if bw.dim() == 1 else (B, Q1)),
              "tau": (tau, f32, row), "nic": (nic, f32, row),
              "theta_now": (theta_now, f32, row), "w": (w, f32, row),
              "gs_prev": (gs_prev, f32, row),
              "next_update": (next_update, f32, row),
              "last_update": (last_update, f32, row),
              "active": (active, b8, row),
              "cfg_tau": (cfg_tau, f32, None),
              "cfg_beta": (cfg_beta, f32, None)}
    for name, x, dtype, shape in (("hist_out", hist_out, f32, (B, D, Q1)),
                                  ("prev_theta", prev_theta, f32, row),
                                  ("started", started, b8, row),
                                  ("admit_t", admit_t, i32, row),
                                  ("slot_flow", slot_flow, i32, row)):
        if x is not None:
            leaves[name] = (x, dtype, shape)
    if (law == 0) != (hist_out is not None) or \
            (law == 1) != (prev_theta is not None):
        raise ValueError(f"{what}: hist_out is Algorithm 1's and prev_theta "
                         f"Algorithm 2's")
    if (slot_flow is None) != (n_flows is None):
        raise ValueError(f"{what}: slot_flow and n_flows go together")
    nf = None if slot_flow is None else int(n_flows)
    modes = {k: _cfg_mode(k, leaves[k][0], B, F, nf)
             for k in ("cfg_tau", "cfg_beta")}
    shapes = {k: (v[2] if v[2] is not None else tuple(v[0].shape))
              for k, v in leaves.items()}
    _build.check_tensors(what, {k: v[0] for k, v in leaves.items()}, shapes,
                         w.device, dtypes={k: v[1] for k, v in leaves.items()})
    outs = {k: torch.empty_like(w) for k in ("w_out", "gs_out", "next_out",
                                             "last_out")}
    if law == 1:
        outs["prev_out"] = torch.empty_like(w)
    if B * F:
        args = _ObserveArgs()
        for k, (x, _, _) in leaves.items():
            setattr(args, k, x.data_ptr())
        for k, x in outs.items():
            setattr(args, k, x.data_ptr())
        for k, v in dict(B=B, F=F, H=H, D=D, Q=Q1 - 1, N=nf or 0, ptr=ptr,
                         t=t, tau_mode=modes["cfg_tau"],
                         beta_mode=modes["cfg_beta"],
                         has_period=int(update_period > 0.0),
                         bw_stride=0 if bw.dim() == 1 else Q1).items():
            setattr(args, k, v)
        # the float32 values torch makes of these Python scalars
        nxt = float(np.float32(t_sec) + np.float32(update_period))
        for k, v in dict(t_sec=t_sec, dt=dt, inv_dt=1.0 / dt,
                         next_period=nxt, gamma=gamma,
                         one_minus_gamma=1.0 - gamma, w_min=w_min).items():
            setattr(args, k, v)
        lib = _lib()
        fn = getattr(lib, what + "_f32")
        with torch.cuda.device(w.device):
            stream = torch.cuda.current_stream(w.device).cuda_stream
            err = fn(ctypes.byref(args), stream)
        _build.check(err, what)
        _build.LAUNCHES[what] += 1
    res = [outs["w_out"], outs["gs_out"]]
    if law == 1:
        res.append(outs["prev_out"])
    return tuple(res) + (outs["next_out"], outs["last_out"])


def powertcp_observe_step(*, hist_q, hist_out, hist_w, path, tf_steps,
                          rtt_steps, bw, tau, nic, theta_now, w, gs_prev,
                          next_update, last_update, active, cfg_tau,
                          cfg_beta, t, t_sec, ptr, dt, update_period,
                          gamma=0.9, w_min=1000.0, started=None,
                          admit_t=None, slot_flow=None, n_flows=None):
    """Algorithm 1 with its observation, for a batch's rows [B, F]: the
    delayed per-hop INT telemetry of ``hist_q``/``hist_out`` [B, D, Q+1]
    along ``path`` [B, F, H] (``rtt_steps - tf_steps`` ticks back from ring
    row ``ptr``), the RTT sample and the ``w_old`` it dates in ``hist_w``
    [B, D, F] (each hop's service rate from ``bw``, [Q+1] shared by the
    batch or [B, Q+1] per scenario), ``upd = active & (t_sec >=
    next_update)``, ``dt_obs``, the
    law on the rows' config (``cfg_tau``/``cfg_beta`` [B, 1], [B, F], or
    [B, n_flows] read at ``slot_flow``), the window clamp ``[w_min,
    8 nic tau + 8 nic theta_now]``, the hold of rows not ``started``
    (padded engine) and the update times (``update_period`` > 0, else
    RTT-paced). ``admit_t`` (slot engine) stands the row's initial window
    ``nic * tau`` in for a ``w_old`` older than its admission. Returns
    (w, gamma_smooth, next_update, last_update)."""
    return _observe_step(
        0, hist_q=hist_q, hist_out=hist_out, hist_w=hist_w, path=path,
        tf_steps=tf_steps, rtt_steps=rtt_steps, bw=bw, tau=tau, nic=nic,
        theta_now=theta_now, w=w, gs_prev=gs_prev, prev_theta=None,
        next_update=next_update, last_update=last_update, active=active,
        started=started, admit_t=admit_t, slot_flow=slot_flow,
        n_flows=n_flows, cfg_tau=cfg_tau, cfg_beta=cfg_beta, t=t,
        t_sec=t_sec, ptr=ptr, dt=dt, update_period=update_period,
        gamma=gamma, w_min=w_min)


def theta_powertcp_observe_step(*, hist_q, hist_w, path, tf_steps,
                                rtt_steps, bw, tau, nic, theta_now, w,
                                gs_prev, prev_theta, next_update,
                                last_update, active, cfg_tau, cfg_beta, t,
                                t_sec, ptr, dt, update_period, gamma=0.9,
                                w_min=1000.0, started=None, admit_t=None,
                                slot_flow=None, n_flows=None):
    """Algorithm 2 with its observation (the RTT sample only; arguments as
    ``powertcp_observe_step``, with ``prev_theta`` in place of
    ``hist_out``). Returns (w, gamma_smooth, prev_theta, next_update,
    last_update)."""
    return _observe_step(
        1, hist_q=hist_q, hist_out=None, hist_w=hist_w, path=path,
        tf_steps=tf_steps, rtt_steps=rtt_steps, bw=bw, tau=tau, nic=nic,
        theta_now=theta_now, w=w, gs_prev=gs_prev, prev_theta=prev_theta,
        next_update=next_update, last_update=last_update, active=active,
        started=started, admit_t=admit_t, slot_flow=slot_flow,
        n_flows=n_flows, cfg_tau=cfg_tau, cfg_beta=cfg_beta, t=t,
        t_sec=t_sec, ptr=ptr, dt=dt, update_period=update_period,
        gamma=gamma, w_min=w_min)


def launch_floor(device) -> None:
    """Launch an empty kernel on ``device``'s current stream through this
    library's interface: the floor under the law kernels' times. Counted
    nowhere."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib.launch_floor_f32(stream), "launch_floor")
