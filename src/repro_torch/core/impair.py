"""Per-link impairment processes (twin of ``repro.core.impair``): lossy,
time-varying, heterogeneous links.

Every queued link carries an independent capacity / loss / jitter
process, described by ``ImpairmentParams`` (a NamedTuple of [Q] tensors,
or [B, Q] for a batch of regimes, ``stack_impairments``) and evaluated by
pure functions of the tick's time:

  ``link_bw_at(t, p)``      -> [Q] float32 service rates (bytes/s)
  ``link_loss_at(t, p)``    -> [Q] float32 loss fractions in [0, LOSS_MAX]
  ``link_jitter_at(t, p)``  -> [Q] float32 added per-hop delay (seconds)

Process kinds (``ImpairmentParams.kind``, per link): ``KIND_CONST`` (the
fixed capacity ``bw_hi``; ``no_impairment(topo)`` reproduces the
topology's rates value for value), ``KIND_SCHEDULE`` (a day/night square
wave in ``rdcn.circuit_up``'s ops, so ``schedule_impairment(p)`` equals
``rdcn.circuit_bw_at`` bit for bit), ``KIND_OSCILLATE`` (a triangle wave
between ``bw_lo`` and ``bw_hi``) and ``KIND_FADING`` (a uniform draw in
[bw_lo, bw_hi] per ``period``-long epoch). Loss is ``LOSS_CONST`` or
``LOSS_RANDOM`` (a draw in [0, loss) per epoch); jitter is a draw in [0,
jitter] per epoch.

The randomness is counter-based and stateless: a lowbias32 hash over
(seed, link id, epoch), ``_mix32``. torch has no uint32 arithmetic, so
the hash runs in int64 holding values in [0, 2^32), each product split so
that no partial product leaves int64 (``_mul32``); the draws equal
``repro``'s bit for bit. The epoch's float -> int32 conversion saturates
and takes NaN to 0, as XLA's does (``_floor_i32``).

The engines fold a regime in as ``repro``'s do: the impaired rates go
through ``fluid._bandwidth``, the survival fraction ``keep = 1 - loss``
scales each queue's accumulated arrivals (``kernels.queue_arrivals.
apply_loss``) and, as a left-to-right product over a path's hops
(``fluid._hop_keep``), the goodput; the jitter is added to each hop's
q / b in the RTT sums. A zero process multiplies by 1.0 and adds +0.0,
so ``no_impairment`` is bitwise the clean run. K4 evaluates the same
arithmetic in its own body (``csrc/fused_tick.cu``).

Every ``jnp`` op of ``repro`` maps to one torch op on float32 tensors:
the divisions divide by tensors (``repro`` pins them against XLA's
reciprocal rewrite), ``jnp.mod`` is ``torch.remainder``, and the four
kinds are all computed before the nested select, so a NaN from a zero
``period`` stays in an untaken branch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import Topology, resolve_device

# process kinds (ImpairmentParams.kind)
KIND_CONST = 0
KIND_SCHEDULE = 1
KIND_OSCILLATE = 2
KIND_FADING = 3

# loss kinds (ImpairmentParams.loss_kind)
LOSS_CONST = 0
LOSS_RANDOM = 1

# loss saturates below 1.0, so the survival product and the served rate
# never reach exact zero (a stuck flow would never complete)
LOSS_MAX = 0.999

_KIND_NAMES = {"const": KIND_CONST, "schedule": KIND_SCHEDULE,
               "oscillate": KIND_OSCILLATE, "fading": KIND_FADING}

# one salt per channel: the capacity, loss and jitter draws of a link are
# independent streams of one (seed, epoch) counter
_SALT_BW = 0x9c83a5d1
_SALT_LOSS = 0x2c1b3c6d
_SALT_JIT = 0x66e9d5a7

# the schedule edges' nudge off the tick knife edge (``rdcn`` reads it
# from here)
_EDGE_NUDGE = 1e-7

_M32 = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


class ImpairmentParams(NamedTuple):
    """A per-link impairment regime: one row per queued link, in queue
    order, [Q] leaves (or [B, Q], a regime per scenario). Floats are
    float32, ``kind`` and ``loss_kind`` int32, ``seed`` int64 holding a
    uint32."""
    kind: torch.Tensor               # [Q] int32 process kind (KIND_*)
    bw_hi: torch.Tensor              # [Q] float32 bytes/s upper capacity
    bw_lo: torch.Tensor              # [Q] float32 bytes/s lower capacity
    period: torch.Tensor             # [Q] float32 seconds (wave/epoch)
    up: torch.Tensor                 # [Q] float32 seconds at bw_hi
    t0: torch.Tensor                 # [Q] float32 phase offset (seconds)
    loss: torch.Tensor               # [Q] float32 loss fraction (or cap)
    loss_kind: torch.Tensor          # [Q] int32 LOSS_CONST / LOSS_RANDOM
    jitter: torch.Tensor             # [Q] float32 max added delay (s)
    seed: torch.Tensor               # [Q] int64 per-link stream seed


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``: ``c`` split into 16-bit halves, so each partial
    product stays below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer finalizer over uint32 values held in int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    x = x ^ (x >> 16)
    return x


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` converted to int32 as XLA converts it (saturating at
    the int32 range, NaN to 0), as int64."""
    f = torch.floor(x)
    big, small, nan = f >= 2.0 ** 31, f < -2.0 ** 31, torch.isnan(f)
    v = torch.where(big | small | nan, 0.0, f).to(torch.int64)
    return torch.where(big, _INT32_MAX, torch.where(small, _INT32_MIN, v))


def _epoch(t_sec, p: ImpairmentParams) -> torch.Tensor:
    """[Q] uint32 epoch counter (int64): the ``period``-long window that
    ``t`` falls in, shifted by ``t0`` and nudged off the tick edge as the
    RDCN schedule is; ``period <= 0`` rows take 1 us epochs; a negative
    epoch (t < t0) wraps through the int32 -> uint32 cast."""
    ph = t_sec - p.t0 + _EDGE_NUDGE
    return _floor_i32(ph / torch.clamp_min(p.period, 1e-6)) & _M32


def _u01(t_sec, p: ImpairmentParams, salt, qid0=0) -> torch.Tensor:
    """[Q] uniform draws in [0, 1): the hash chain (seed ^ salt) -> link
    id -> epoch, its top 24 bits scaled to float32 (exact). ``qid0``
    offsets the link ids of a row slice of the full regime, so the slice
    draws the full evaluation's values. A tuple of K salts hashes them in
    one pass: [K, Q] draws."""
    n = int(p.kind.shape[-1])
    qid = (int(qid0) + torch.arange(n, dtype=torch.int64,
                                    device=p.kind.device)) & _M32
    if isinstance(salt, tuple):
        salt = torch.tensor(salt, dtype=torch.int64,
                            device=p.seed.device).view(
                                (len(salt),) + (1,) * p.seed.dim())
    h = _mix32(p.seed ^ salt)
    h = _mix32(h ^ _mul32(qid, 0x9E3779B9))
    h = _mix32(h ^ _epoch(t_sec, p))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def link_bw_at(t_sec, p: ImpairmentParams, qid0=0, u=None) -> torch.Tensor:
    """[Q] per-link service rates at ``t_sec`` (bytes/s): the four kinds
    evaluated, then selected (``repro``'s nested ``where``). The schedule
    branch is ``rdcn.circuit_up``'s ops. ``u``: the capacity draws, when
    already hashed (``regime_at``)."""
    ph = torch.remainder(t_sec - p.t0 + _EDGE_NUDGE, p.period)
    up = (ph >= 0.0) & (ph < p.up)
    sched = torch.where(up, p.bw_hi, p.bw_lo)
    frac = ph / p.period
    tri = 1.0 - torch.abs(2.0 * frac - 1.0)
    osc = p.bw_lo + (p.bw_hi - p.bw_lo) * tri
    if u is None:
        u = _u01(t_sec, p, _SALT_BW, qid0)
    fad = p.bw_lo + (p.bw_hi - p.bw_lo) * u
    bw = torch.where(p.kind == KIND_SCHEDULE, sched,
                     torch.where(p.kind == KIND_OSCILLATE, osc,
                                 torch.where(p.kind == KIND_FADING, fad,
                                             p.bw_hi)))
    return bw.to(torch.float32)


def link_loss_at(t_sec, p: ImpairmentParams, qid0=0,
                 u=None) -> torch.Tensor:
    """[Q] per-link loss fractions at ``t_sec``, clipped to [0,
    ``LOSS_MAX``]: a draw in [0, loss) per epoch (``LOSS_RANDOM``) or the
    fraction itself. A zero ``loss`` row is exactly 0.0."""
    if u is None:
        u = _u01(t_sec, p, _SALT_LOSS, qid0)
    loss = torch.where(p.loss_kind == LOSS_RANDOM, p.loss * u, p.loss)
    return torch.clamp(loss.to(torch.float32), 0.0, LOSS_MAX)


def link_jitter_at(t_sec, p: ImpairmentParams, qid0=0,
                   u=None) -> torch.Tensor:
    """[Q] per-link added queuing delay at ``t_sec`` (seconds): a draw in
    [0, jitter] per epoch; a zero ``jitter`` row is exactly +0.0."""
    if u is None:
        u = _u01(t_sec, p, _SALT_JIT, qid0)
    return torch.clamp_min(p.jitter * u, 0.0)


def regime_at(t_sec, p: ImpairmentParams, qid0=0):
    """(``link_bw_at``, ``1 - link_loss_at``, ``link_jitter_at``) at
    ``t_sec``, the three draws of every link hashed in one pass: the same
    values for a third of the hash's ops (the sharded engine's regime)."""
    u = _u01(t_sec, p, (_SALT_BW, _SALT_LOSS, _SALT_JIT), qid0)
    return (link_bw_at(t_sec, p, qid0, u[0]),
            1.0 - link_loss_at(t_sec, p, qid0, u[1]),
            link_jitter_at(t_sec, p, qid0, u[2]))


def impair_vectors(t_sec, p: ImpairmentParams):
    """(keep, jit): the survival fractions ``1 - loss`` and the added
    per-hop delays, [Q+1] (or [B, Q+1]), the sentinel queue's identities
    (keep 1.0, jitter 0.0) appended."""
    keep = 1.0 - link_loss_at(t_sec, p)
    jit = link_jitter_at(t_sec, p)
    lead = tuple(keep.shape[:-1])
    return (torch.cat([keep, keep.new_ones(lead + (1,))], -1),
            torch.cat([jit, jit.new_zeros(lead + (1,))], -1))


# --------------------------------------------------------------------------
# host-side description: per-link-class processes, netem-style presets
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkProcess:
    """Static description of one link's impairment process.

    ``bw_hi``/``bw_lo`` <= 0 default to the link's own fabric capacity
    (a pure loss/jitter process needs no bandwidth; without ``bw_lo`` the
    capacity does not vary). ``period`` <= 0 means 1 us epochs for the
    random draws and is invalid for the schedule and oscillate kinds.
    """
    kind: str = "const"              # const | schedule | oscillate | fading
    bw_hi: float = 0.0               # bytes/s (0 => link's fabric capacity)
    bw_lo: float = 0.0               # bytes/s (0 => same as bw_hi)
    period: float = 0.0              # seconds
    up: float = 0.0                  # seconds at bw_hi (schedule kind)
    t0: float = 0.0                  # phase offset (seconds)
    loss: float = 0.0                # loss fraction (or its random cap)
    random_loss: bool = False        # per-epoch uniform draw in [0, loss)
    jitter: float = 0.0              # max added delay (seconds)
    seed: int = 0                    # stream seed (links decorrelate by id)

    def __post_init__(self):
        if self.kind not in _KIND_NAMES:
            raise ValueError(f"unknown impairment kind {self.kind!r}; "
                             f"expected one of {sorted(_KIND_NAMES)}")
        if not 0.0 <= self.loss <= LOSS_MAX:
            raise ValueError(f"loss {self.loss} outside [0, {LOSS_MAX}]")
        if self.jitter < 0.0:
            raise ValueError(f"jitter {self.jitter} must be >= 0")
        if self.kind in ("schedule", "oscillate") and self.period <= 0.0:
            raise ValueError(f"kind {self.kind!r} needs period > 0")
        if self.kind == "schedule" and not 0.0 <= self.up <= self.period:
            raise ValueError("schedule needs 0 <= up <= period")


def netem(rate: Optional[float] = None, loss: float = 0.0,
          jitter: float = 0.0, random_loss: bool = True,
          period: float = 0.0, seed: int = 0) -> LinkProcess:
    """netem-style preset: an optional fixed ``rate`` (bytes/s), a
    ``loss`` fraction and ``jitter`` seconds, as a constant-capacity
    process; ``random_loss`` draws the loss per epoch, ``period`` sets the
    epoch (0 => 1 us)."""
    return LinkProcess(kind="const", bw_hi=0.0 if rate is None else rate,
                       loss=loss, random_loss=random_loss, jitter=jitter,
                       period=period, seed=seed)


def _params_from_procs(procs: Sequence[LinkProcess], link_bw: np.ndarray,
                       device="cuda") -> ImpairmentParams:
    """Compile per-queue ``LinkProcess`` rows (with the links' own
    capacities as the bandwidth defaults) into ``ImpairmentParams`` on
    ``device``."""
    n = len(procs)
    if n != len(link_bw):
        raise ValueError(f"{n} processes for {len(link_bw)} queued links")
    kind = np.zeros(n, np.int32)
    f = {k: np.zeros(n, np.float32) for k in
         ("bw_hi", "bw_lo", "period", "up", "t0", "loss", "jitter")}
    loss_kind = np.zeros(n, np.int32)
    seed = np.zeros(n, np.int64)
    for i, p in enumerate(procs):
        kind[i] = _KIND_NAMES[p.kind]
        hi = p.bw_hi if p.bw_hi > 0.0 else float(link_bw[i])
        lo = p.bw_lo if p.bw_lo > 0.0 else hi
        f["bw_hi"][i] = hi
        f["bw_lo"][i] = lo
        f["period"][i] = p.period
        f["up"][i] = p.up
        f["t0"][i] = p.t0
        f["loss"][i] = p.loss
        f["jitter"][i] = p.jitter
        loss_kind[i] = LOSS_RANDOM if p.random_loss else LOSS_CONST
        seed[i] = int(np.uint32(p.seed))
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, device=dev)
    return ImpairmentParams(
        kind=t(kind), bw_hi=t(f["bw_hi"]), bw_lo=t(f["bw_lo"]),
        period=t(f["period"]), up=t(f["up"]), t0=t(f["t0"]),
        loss=t(f["loss"]), loss_kind=t(loss_kind), jitter=t(f["jitter"]),
        seed=t(seed))


def no_impairment(topo: Topology) -> ImpairmentParams:
    """The zero preset, on the topology's device: every link a constant
    process at its own capacity, no loss, no jitter — bitwise the
    unimpaired engines."""
    bw = topo.bandwidth.cpu().numpy().astype(np.float32)
    return _params_from_procs([LinkProcess()] * len(bw), bw,
                              topo.bandwidth.device)


def schedule_impairment(sp) -> ImpairmentParams:
    """The degenerate RDCN instance: one queue whose capacity process is
    the circuit schedule ``sp`` (an ``rdcn.ScheduleParams``);
    ``link_bw_at(t, schedule_impairment(sp))`` is ``rdcn.circuit_bw_at(t,
    sp)`` bit for bit."""
    dev = sp.week.device

    def one(x):
        return torch.as_tensor(x, device=dev).to(torch.float32).reshape(1)
    zf = torch.zeros(1, dtype=torch.float32, device=dev)
    zi = torch.zeros(1, dtype=torch.int32, device=dev)
    return ImpairmentParams(
        kind=torch.full((1,), KIND_SCHEDULE, dtype=torch.int32, device=dev),
        bw_hi=one(sp.circuit_bw), bw_lo=one(sp.packet_bw),
        period=one(sp.week), up=one(sp.day), t0=one(sp.t0), loss=zf,
        loss_kind=zi, jitter=zf.clone(),
        seed=torch.zeros(1, dtype=torch.int64, device=dev))


def fabric_impairments(fab_or_routes,
                       rules: Optional[Dict[Tuple[int, int],
                                            LinkProcess]] = None,
                       default: Optional[LinkProcess] = None,
                       device="cuda") -> ImpairmentParams:
    """Compile per-link-class processes for a fabric's queued links, on
    ``device``.

    ``rules`` maps (src_tier, dst_tier) -> ``LinkProcess`` (tiers as in
    ``fabric.HOST/TOR/AGG/CORE``); unmatched links take ``default`` (or
    the zero process). Without ``rules`` the fabric's declared classes
    (``FabricBuilder.impair_class``) apply. Takes a ``Fabric`` or a
    ``FabricRoutes`` (its ``.fabric``). Links of one class share the class
    seed and still draw independent streams (the hash folds the queue id
    in)."""
    fab = getattr(fab_or_routes, "fabric", fab_or_routes)
    if rules is None:
        rules = dict(getattr(fab, "impair_rules", ()) or ())
    default = default or LinkProcess()
    ql = fab.queued_links()
    procs = []
    for l in ql:
        key = (int(fab.tier[fab.link_src[l]]),
               int(fab.tier[fab.link_dst[l]]))
        procs.append(rules.get(key, default))
    return _params_from_procs(procs, np.asarray(fab.link_bw[ql], np.float32),
                              device)


def stack_impairments(ps: List[ImpairmentParams]) -> ImpairmentParams:
    """Stack regimes along a new leading batch axis ([B, Q] leaves): the
    ``impair_params`` of the batched drivers."""
    return ImpairmentParams(*[torch.stack(xs) for xs in zip(*ps)])


__all__ = ["KIND_CONST", "KIND_SCHEDULE", "KIND_OSCILLATE", "KIND_FADING",
           "LOSS_CONST", "LOSS_RANDOM", "LOSS_MAX", "ImpairmentParams",
           "LinkProcess", "fabric_impairments", "impair_vectors",
           "link_bw_at", "link_jitter_at", "link_loss_at", "netem",
           "no_impairment", "schedule_impairment", "stack_impairments"]
