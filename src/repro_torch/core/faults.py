"""Fault injection and the feature-rejection taxonomy (twin of
``repro.core.faults``).

Two things live here, both engine-agnostic:

  * the exception taxonomy the execution layer keys on:
    ``UnsupportedFeature`` (an engine declares a combination it does not
    implement, with a remediation hint; ``run_sweep``'s backend fallback
    chain catches exactly this), ``InjectedCrash`` (a test harness killed
    the run at a deterministic tick or segment; the chunk-boundary
    checkpoint written just before is the recovery point),
    ``TransientFault`` (an injected stand-in for the retryable failure
    class: allocator pressure, a flaky device) and ``is_transient`` (the
    retry predicate);

  * deterministic fault injectors: ``crash_at_tick`` / ``crash_at_chunk``
    build a ``FaultSpec`` that the chunk-streamed loop honours (it
    bounds segment lengths so the crash lands exactly on the requested
    tick, after any due checkpoint is written), and ``poison_law`` wraps
    a law so that its window turns NaN from a chosen simulated time: the
    probe of the divergence guards (``core/guard.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .laws import Law


class UnsupportedFeature(NotImplementedError):
    """An engine's declared rejection of a feature combination.

    Subclasses ``NotImplementedError`` so that ``except
    NotImplementedError`` callers keep working; carries a ``hint`` naming
    the supported route. The sweep runner's backend fallback chain
    triggers on exactly this type: a plain ValueError/TypeError, or a
    kernel's build or launch error, stays a hard error.
    """

    def __init__(self, message: str, hint: str = ""):
        self.hint = hint
        super().__init__(message + (f" (hint: {hint})" if hint else ""))


class InjectedCrash(RuntimeError):
    """Raised by the chunk-streamed loop when a ``FaultSpec`` fires.

    Not retryable (``is_transient`` excludes it): it simulates the process
    dying, and the contract under test is that everything up to the last
    chunk-boundary checkpoint is durable and ``resume_slots`` continues
    bit for bit.
    """

    def __init__(self, tick: int, segment: int):
        self.tick = int(tick)
        self.segment = int(segment)
        super().__init__(f"injected crash at tick {tick} "
                         f"(segment boundary {segment})")


class TransientFault(RuntimeError):
    """An injected retryable failure (a stand-in for allocator pressure,
    a flaky device, ...). ``run_sweep``'s bounded retry with backoff
    treats it, and plain RuntimeErrors outside the taxonomy, as worth
    retrying."""


def is_transient(exc: BaseException) -> bool:
    """The retry predicate: a RuntimeError is presumed transient unless it
    is part of the structured taxonomy (a declared rejection, a divergence
    diagnosis or a simulated process death: retrying those cannot
    succeed). ``torch.cuda.OutOfMemoryError`` and a kernel's launch error
    are RuntimeErrors, so they are retried. Shape, type and value errors
    are never transient."""
    from .guard import DivergenceError
    if isinstance(exc, (UnsupportedFeature, DivergenceError, InjectedCrash)):
        return False
    return isinstance(exc, RuntimeError)


class FaultSpec(NamedTuple):
    """Deterministic crash injection for the chunk-streamed loop.

    ``crash_tick`` kills the run when the simulated tick counter reaches
    exactly that value (the loop shortens segments so that a boundary
    lands on it); ``crash_segment`` kills it after that many completed
    segments. Checkpoints due at the crash boundary are written before the
    crash fires: the injected failure models the process dying after its
    last durable write, the worst recoverable case.
    """
    crash_tick: Optional[int] = None
    crash_segment: Optional[int] = None


def crash_at_tick(tick: int) -> FaultSpec:
    """Crash when the simulated tick counter reaches ``tick`` (> 0)."""
    if int(tick) <= 0:
        raise ValueError(f"crash tick must be > 0, got {tick}")
    return FaultSpec(crash_tick=int(tick))


def crash_at_chunk(segment: int) -> FaultSpec:
    """Crash after ``segment`` (> 0) completed chunk segments."""
    if int(segment) <= 0:
        raise ValueError(f"crash segment must be > 0, got {segment}")
    return FaultSpec(crash_segment=int(segment))


def _poison_first_float(state, poison: bool):
    """``state`` with its first floating-point leaf (depth first, in field
    order) NaN where ``poison``; returns (state, whether a leaf was
    found)."""
    if isinstance(state, torch.Tensor):
        if state.is_floating_point():
            return (torch.full_like(state, float("nan")) if poison
                    else state), True
        return state, False
    if isinstance(state, tuple):
        vals, done = list(state), False
        for i, x in enumerate(vals):
            vals[i], done = _poison_first_float(x, poison)
            if done:
                break
        return (type(state)(*vals) if hasattr(state, "_fields")
                else tuple(vals)), done
    return state, False


def poison_law(law: Union[str, Law], at_t: float = 0.0,
               backend: str = "reference") -> Law:
    """A law whose window output turns NaN from simulated time ``at_t``.

    Wraps the registered update so that every masked window write at
    ``t >= at_t`` emits NaN, and the first floating-point leaf of the law's
    state is NaN on every tick from ``at_t`` (the window poison alone can
    heal where an engine clamps the window; no engine launders law state).
    The comparison is in float32, as ``repro``'s traced tick time compares.
    The wrapped law has no K4 path: on the card the megakernel backend
    raises ``NotImplementedError`` for it.
    """
    from .laws import get_law
    inner = law if isinstance(law, Law) else get_law(law, backend)
    at32 = np.float32(at_t)

    def update(state, obs, w, rate_cap, upd, cfg, t):
        state, w, rate_cap = inner.update(state, obs, w, rate_cap, upd,
                                          cfg, t)
        late = bool(np.float32(t) >= at32)
        if late:
            w = torch.where(upd, torch.full_like(w, float("nan")), w)
        state, _ = _poison_first_float(state, late)
        return state, w, rate_cap

    return inner._replace(name=f"poisoned_{inner.name}", update=update)
