"""Core datatypes of the fluid-model simulator (twin of ``repro.core.types``).

Units: time in seconds, data in bytes, rates and bandwidth in bytes/s
(100 Gbps == 12.5e9 B/s).

Every struct is a NamedTuple of tensors on one device. Float leaves are
float32 and integer leaves int32, as in ``repro``; host-side numpy
(float64 by default) is cast when it enters (``from_numpy`` and the
builders). Tick counters that the host loop owns (``SimState.t``,
``SlotState.t``) are Python ints: the tick loop runs on the host, so the
host always knows the tick, and indexing the rings with it costs no
device round trip.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Handy unit constants.
GBPS = 1e9 / 8.0          # bytes/sec per Gbit/sec
MTU = 1000.0              # bytes; fluid model uses MTU only for increments
US = 1e-6                 # seconds per microsecond
KB = 1e3
MB = 1e6


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default
    everywhere; without a usable CUDA device it raises instead of
    carrying on on the CPU — the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


class Topology(NamedTuple):
    """Static description of the simulated fabric (see ``repro``)."""
    num_queues: int                 # Q (excluding the sentinel)
    bandwidth: torch.Tensor         # [Q] bytes/s, service rate per queue
    buffer: torch.Tensor            # [Q] bytes, hard cap per queue
    switch_of_queue: torch.Tensor   # [Q] int32, switch id (DT buffer sharing)
    num_switches: int
    switch_buffer: torch.Tensor     # [S] bytes, shared buffer per switch
    dt_alpha: float = 1.0           # Dynamic-Thresholds alpha (<=0 disables DT)


class Flows(NamedTuple):
    """Static per-flow description (F flows). Real hops occupy a
    contiguous prefix of ``path``; padding (queue id == num_queues, the
    sentinel) follows the final real hop with ``tf_steps == 0``."""
    path: torch.Tensor              # [F, H] int32 queue ids; pad == num_queues
    tf_steps: torch.Tensor          # [F, H] int32 forward delay (steps) to each hop
    rtt_steps: torch.Tensor         # [F] int32 base round-trip feedback delay
    tau: torch.Tensor               # [F] base RTT (seconds)
    nic_rate: torch.Tensor          # [F] host NIC line rate bytes/s
    size: torch.Tensor              # [F] flow size bytes (inf => long-lived)
    start: torch.Tensor             # [F] start time (seconds)
    stop: torch.Tensor              # [F] hard stop time (inf => none)
    weight: torch.Tensor            # [F] additive-increase weight multiplier


class FlowSchedule(NamedTuple):
    """Time-sorted arrival schedule for the flow-slot engine: the fields of
    ``Flows`` in ascending ``start`` order, plus ``order``, the original
    ``Flows`` index of each entry (-1 for padding)."""
    path: torch.Tensor              # [N, H] int32
    tf_steps: torch.Tensor          # [N, H] int32
    rtt_steps: torch.Tensor         # [N] int32
    tau: torch.Tensor               # [N]
    nic_rate: torch.Tensor          # [N]
    size: torch.Tensor              # [N]
    start: torch.Tensor             # [N] sorted ascending
    stop: torch.Tensor              # [N]
    weight: torch.Tensor            # [N]
    order: torch.Tensor             # [N] int32 original Flows index


def pad_hops(x, hops: int, pad_queue: int):
    """Pad the hop axis of a ``Flows``/``FlowSchedule`` to ``hops`` with
    sentinel hops (queue ``pad_queue``, forward delay 0)."""
    H = int(x.path.shape[-1])
    if H == hops:
        return x
    if H > hops:
        raise ValueError(f"cannot shrink hop axis {H} -> {hops}")
    add = hops - H

    def cat(a, fill):
        pad = torch.full(a.shape[:-1] + (add,), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a, pad], dim=-1)

    return x._replace(path=cat(x.path, pad_queue),
                      tf_steps=cat(x.tf_steps, 0))


class PathObs(NamedTuple):
    """What a sender observes at window-update time (delayed INT metadata
    of Algorithm 1 plus the RTT sample of Algorithm 2)."""
    q: torch.Tensor                 # [F, H] bytes
    qdot: torch.Tensor              # [F, H] bytes/s
    mu: torch.Tensor                # [F, H] bytes/s (txRate)
    b: torch.Tensor                 # [F, H] bytes/s (link bandwidth)
    valid: torch.Tensor             # [F, H] bool
    theta: torch.Tensor             # [F] measured RTT (seconds, delayed)
    w_old: torch.Tensor             # [F] window one RTT ago
    dt_obs: torch.Tensor            # [F] seconds since previous update
    ecn_frac: torch.Tensor          # [F] fraction of marked traffic
    # feedback channels: None unless the law declares them
    # (``Law.uses_pause`` / ``uses_incast``)
    pause: Optional[torch.Tensor] = None   # [F, H] per-hop pause state (0/1)
    incast: Optional[torch.Tensor] = None  # [F, H] per-hop live senders


class SimConfig(NamedTuple):
    dt: float = 1e-6                # simulator step (seconds)
    steps: int = 10000
    hist: int = 256                 # ring buffer length (>= max rtt_steps + 2)
    update_period: float = 0.0      # 0 => once per measured RTT, else fixed (s)
    record_every: int = 0           # >0 => record time series every k steps


class SimState(NamedTuple):
    t: int                          # host tick counter
    w: torch.Tensor                 # [F] congestion window (bytes)
    rate_cap: torch.Tensor          # [F] explicit rate cap (bytes/s)
    q: torch.Tensor                 # [Q+1] queue bytes (sentinel appended)
    out_rate: torch.Tensor          # [Q+1] egress tx rate, last step
    hist_lam: torch.Tensor          # [D, F] sending-rate history
    hist_q: torch.Tensor            # [D, Q+1]
    hist_out: torch.Tensor          # [D, Q+1]
    hist_w: torch.Tensor            # [D, F]
    remaining: torch.Tensor         # [F] bytes left
    fct: torch.Tensor               # [F] completion time (nan until done)
    next_update: torch.Tensor       # [F]
    last_update: torch.Tensor       # [F]
    law: tuple                      # law-specific NamedTuple of [F] tensors
    # feedback channels: None unless the law declares them
    pause: Optional[torch.Tensor] = None       # [Q+1] XON/XOFF state
    hist_pause: Optional[torch.Tensor] = None  # [D, Q+1]
    hist_inc: Optional[torch.Tensor] = None    # [D, Q+1] live senders


class SlotState(NamedTuple):
    """State of the flow-slot engine (``fluid.slot_step``); see ``repro``.

    ``slot_flow == N`` marks a free slot. ``fct`` is [N] in schedule order
    on return from ``simulate_slots``; while the tick loop runs it
    carries one more trailing cell that absorbs the completion writes of
    slots that did not complete (the twin of ``mode="drop"``).
    ``admitted`` is the host's copy of ``cursor`` and ``inv`` the
    reference backend's gather table of the resident slots; both change
    only on ticks that run the admit/retire pass.
    """
    t: int                          # host tick counter
    admitted: int                   # host copy of cursor
    cursor: torch.Tensor            # int32 next schedule index to admit
    hw: torch.Tensor                # int32 fresh-slot high-water mark
    slot_flow: torch.Tensor         # [S] int32 schedule index (N == free)
    admit_t: torch.Tensor           # [S] int32 admission step
    free_at: torch.Tensor           # [S] int32 step when slot is reusable
    path: torch.Tensor              # [S, H] int32
    tf_steps: torch.Tensor          # [S, H] int32
    rtt_steps: torch.Tensor         # [S] int32
    tau: torch.Tensor               # [S]
    nic_rate: torch.Tensor          # [S]
    start: torch.Tensor             # [S]
    stop: torch.Tensor              # [S]
    w: torch.Tensor                 # [S]
    rate_cap: torch.Tensor          # [S]
    q: torch.Tensor                 # [Q+1]
    out_rate: torch.Tensor          # [Q+1]
    hist_lam: torch.Tensor          # [D, S]
    hist_q: torch.Tensor            # [D, Q+1]
    hist_out: torch.Tensor          # [D, Q+1]
    hist_w: torch.Tensor            # [D, S]
    remaining: torch.Tensor         # [S]
    next_update: torch.Tensor       # [S]
    last_update: torch.Tensor       # [S]
    law: tuple                      # law-specific NamedTuple of [S] tensors
    fct: torch.Tensor               # [N] (+1 drop cell while running)
    incidence: Optional[torch.Tensor] = None  # [H, S, Q+1] (fused backend)
    inv: Optional[torch.Tensor] = None  # [Q+1, maxdeg] int32 (reference)
    # feedback channels (as ``SimState``'s): None unless declared
    pause: Optional[torch.Tensor] = None       # [Q+1]
    hist_pause: Optional[torch.Tensor] = None  # [D, Q+1]
    hist_inc: Optional[torch.Tensor] = None    # [D, Q+1]


class CheckpointSpec(NamedTuple):
    """Chunk-boundary checkpointing policy (``repro.core.types``').

    ``simulate_slots(..., checkpoint=CheckpointSpec(path))`` snapshots the
    full carry (pool vectors, queues, telemetry rings, law state, the
    megakernel's gather table and pending buffers) plus the recorded trace
    so far at chunk-segment boundaries, each snapshot one atomically
    renamed ``ckpt-<tick>.npz`` (``core/ckpt.py``); ``fluid.resume_slots``
    continues from the newest snapshot bit for bit.

    ``every`` is the cadence in simulated ticks: the loop shortens
    segments so that boundaries land exactly on its multiples (0: a
    snapshot at every segment boundary). ``keep`` bounds how many
    snapshots stay on disk (the oldest are removed after each successful
    write).
    """
    path: str
    every: int = 0
    keep: int = 2


class Record(NamedTuple):
    """Per-step recordings (subsampled by ``record_every``), stacked over
    the recorded steps."""
    t: torch.Tensor                 # seconds
    q: torch.Tensor                 # [Q+1]
    w_sum: torch.Tensor             # scalar, aggregate window
    thru: torch.Tensor              # [Q+1] egress rate
    lam: torch.Tensor               # scalar, aggregate send rate
    lam_f: torch.Tensor             # [F] per-flow / per-slot send rates
    n_active: torch.Tensor          # scalar int32, flows actively sending


def tree_map(fn, *trees):
    """``fn`` over the array leaves (tensors, numpy arrays) of NamedTuple
    trees of one structure (nested tuples included); every other leaf
    (None, a host tick counter, a Python scalar) is the first tree's."""
    first = trees[0]
    if isinstance(first, (torch.Tensor, np.ndarray)):
        return fn(*trees)
    if isinstance(first, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(first)(*vals) if hasattr(first, "_fields") else \
            tuple(vals)
    return first


def batch_of_one(tree):
    """``tree`` with a leading batch axis of one on every array leaf: the
    form in which the engines take a single scenario."""
    return tree_map(lambda x: x[None], tree)


def scenario(tree, b):
    """Scenario ``b`` of a batched tree (tensor leaves as views)."""
    return tree_map(lambda x: x[b], tree)


def stack_trees(items):
    """Trees of one structure stacked leaf by leaf on a new leading
    axis."""
    return tree_map(lambda *xs: torch.stack(xs) if isinstance(
        xs[0], torch.Tensor) else np.stack(xs), *items)


def cat_trees(items):
    """Batched trees of one structure joined on their leading axis."""
    return tree_map(lambda *xs: torch.cat(xs) if isinstance(
        xs[0], torch.Tensor) else np.concatenate(xs), *items)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float32), device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    raise TypeError(f"cannot convert dtype {a.dtype} to a tensor")


def _convert(x, device):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, tuple):
        vals = [_convert(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return _to_tensor(x, device)


def from_numpy(cls, arrays, device="cuda"):
    """Build the port's ``cls`` (a NamedTuple above, ``LawConfig`` or a
    law state) from the same structure given as numpy arrays — e.g. a
    ``repro`` pytree mapped through ``np.asarray``, or a dict of its
    fields. Float arrays become float32 tensors and integer arrays int32,
    as in ``repro``; Python scalars (ints, floats, flags) and ``None``
    pass through; nested tuples convert leaf by leaf. Fields missing from
    ``arrays`` take ``cls``'s defaults."""
    dev = resolve_device(device)
    get = (arrays.get if isinstance(arrays, dict)
           else lambda k, d=None: getattr(arrays, k, d))
    kw = {}
    for name in cls._fields:
        missing = object()
        v = get(name, missing)
        if v is missing:
            continue
        kw[name] = _convert(v, dev)
    return cls(**kw)
