"""Plain PyTorch versions of the hand-written kernels (twins of
``repro.kernels.ref``).

Each is written the most obvious way. They are what a wrapper runs on a
CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel against on
the card: K1 and K2 bit for bit (the kernels are built with
``-fmad=false`` and round every product the way these do), K3 at rtol
1e-5 (its arrival sum runs in another order), K4 bit for bit on every
carry leaf and record field (K4 adds the record sums ``w_sum`` and
``lam`` in the plain tick's order, XLA:CPU's), K5 at
2e-5 in float32 and 2e-2 in bfloat16 (the tolerances ``tests/test_kernels.py`` holds the Pallas
kernel to: the online softmax adds in another order and rescales), K6 at
rtol 1e-5 in float32 and one bfloat16 ulp in bfloat16 (its square sum
runs in its own fixed order).
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: [B,H,T,D]; k,v: [B,KV,S,D]; GQA via H % KV == 0 (query head h
    reads kv head h // (H/KV)). float32 scores and softmax; the queries are
    the last T of the S positions. Returns [B,H,T,D] in q's dtype."""
    B, H, T, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kk = k[:, :, None].expand(B, KV, G, S, D).reshape(B, H, S, D)
    vv = v[:, :, None].expand(B, KV, G, S, D).reshape(B, H, S, D)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kk.float()) * scale
    qi = torch.arange(T, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        off = S - T          # queries are the last T positions of S
        mask &= kj <= qi + off
        if window > 0:
            mask &= kj > qi + off - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vv.float()).to(q.dtype)


def rmsnorm_ref(x, scale, eps=1e-6):
    """``x·rsqrt(mean(x²)+eps)·scale`` over the last dim, float32
    statistics, out in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def powertcp_step_ref(q, qdot, mu, b, valid, tau, w, w_old, gs_prev,
                      dt_obs, upd, beta, gamma=0.9, w_min=1000.0):
    """Algorithm 1 (NORMPOWER + smoothing + UPDATEWINDOW), vectorized over
    flows. Per-hop tensors [...,F,H]; per-flow tensors [...,F]. Returns
    (w, gs)."""
    tau2 = tau[..., None]
    current = qdot + mu
    voltage = q + b * tau2
    base = b * b * tau2
    gnorm = torch.where(valid,
                        current * voltage / torch.clamp_min(base, 1.0), 0.0)
    gmax = torch.amax(gnorm, dim=-1)
    d = torch.minimum(torch.clamp_min(dt_obs, 0.0), tau)
    gs = (gs_prev * (tau - d) + gmax * d) / torch.clamp_min(tau, 1e-12)
    gs_out = torch.where(upd, gs, gs_prev)
    target = w_old / torch.clamp_min(gs_out, 1e-9) + beta
    w_new = gamma * target + (1.0 - gamma) * w
    w_out = torch.where(upd, torch.clamp_min(w_new, w_min), w)
    return w_out, gs_out


def theta_powertcp_step_ref(theta, prev_theta, tau, w, w_old, gs_prev,
                            dt_obs, upd, beta, gamma=0.9, w_min=1000.0):
    """Algorithm 2 (theta-PowerTCP): RTT-only power + smoothing +
    UPDATEWINDOW. All per-flow tensors [F]. Returns (w, gs, prev_theta)."""
    thetadot = (theta - prev_theta) / torch.clamp_min(dt_obs, 1e-12)
    gnorm = (thetadot + 1.0) * theta / torch.clamp_min(tau, 1e-12)
    d = torch.minimum(torch.clamp_min(dt_obs, 0.0), tau)
    gs = (gs_prev * (tau - d) + gnorm * d) / torch.clamp_min(tau, 1e-12)
    gs_out = torch.where(upd, gs, gs_prev)
    target = w_old / torch.clamp_min(gs_out, 1e-9) + beta
    w_new = gamma * target + (1.0 - gamma) * w
    w_out = torch.where(upd, torch.clamp_min(w_new, w_min), w)
    prev_out = torch.where(upd, theta, prev_theta)
    return w_out, gs_out, prev_out


def _ordered_colsum(p):
    """Each column of ``p`` [F, Q] summed over its rows in ascending row
    order, from +0.0. Only the nonzero products are walked: adding an
    exact zero to such a sum changes no bit."""
    nz = p != 0.0
    F, Q = p.shape
    rank = torch.cumsum(nz, dim=0, dtype=torch.int64) - 1
    deg = int(nz.sum(dim=0).max()) if p.numel() else 0
    table = torch.full((max(deg, 1), Q), F, dtype=torch.int64,
                       device=p.device)
    rows, cols = torch.nonzero(nz, as_tuple=True)
    table[rank[rows, cols], cols] = rows
    padded = torch.cat([p, p.new_zeros(1, Q)])
    col = torch.arange(Q, device=p.device)
    acc = p.new_zeros(Q)
    for j in range(deg):
        acc = acc + padded[table[j], col]
    return acc


def queue_arrivals_ref(lam_del, onehot, q, out_rate, caps, dt):
    """Dense fluid-queue update: arrivals are the incidence-weighted sum
    of the delayed per-hop rates, then q' = clip(q + (arr - out) dt, 0, caps).
    The sum is hop-major, as ``repro``'s Pallas kernel takes it: each
    hop's products summed over the flows in ascending order, and the hops'
    partials added in hop order.

    lam_del: [H,F]; onehot: [H,F,Q]; q/out_rate/caps: [Q]. A batch
    ([B,H,F], [B,H,F,Q], q [B,Q], out_rate/caps [Q] or [B,Q]) is summed
    scenario by scenario, each as on its own. Returns (arrivals [...,Q],
    q_new [...,Q])."""
    if onehot.dim() == 4:
        out = [queue_arrivals_ref(
            lam_del[b], onehot[b], q[b],
            out_rate if out_rate.dim() == 1 else out_rate[b],
            caps if caps.dim() == 1 else caps[b], dt)
            for b in range(onehot.shape[0])]
        return tuple(torch.stack(x) for x in zip(*out))
    arr = torch.zeros_like(q)
    for h in range(int(onehot.shape[0])):
        arr = arr + _ordered_colsum(lam_del[h][:, None] * onehot[h])
    q_new = torch.minimum(torch.clamp_min(q + (arr - out_rate) * dt, 0.0),
                          caps)
    return arr, q_new


def fused_tick_block_ref(tick, carry, due_block, record=True,
                         record_every=1):
    """K whole ticks of the megakernel (``core.megakernel.make_tick``'s
    plain tick over a batch's carry) looped one by one, K the length of
    ``due_block`` ([B, K], the due counts of the block's ticks). Returns
    (carry', records [B, nrec, ...] of the block's recorded ticks — every
    ``record_every``-th — or None)."""
    re = max(int(record_every), 1)
    recs = []
    for k in range(int(due_block.shape[-1])):
        carry, rec = tick(carry, due_block[:, k])
        if record and (k + 1) % re == 0:
            recs.append(rec)
    if not record:
        return carry, None
    return carry, type(recs[0])(*[torch.stack(list(x), dim=1)
                                  for x in zip(*recs)])
