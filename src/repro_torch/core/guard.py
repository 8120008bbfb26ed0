"""Divergence guards: structured finite checks on engine carries (twin of
``repro.core.guard``).

A blown-up law config does not raise inside a tick loop: it floods the
carry with NaN. The guard turns that into a diagnosis:
``check_divergence(state, law, tick)`` evaluates one stacked
finite-reduction over every checked leaf (one host transfer) and raises
``DivergenceError`` naming the law, the tick, and the first non-finite
field in the carry's field order.

The chunk-streamed loop calls it at segment boundaries under
``simulate_slots(..., guard=True)``, where the host already reads the
admission cursor back. It reads and never writes, so it changes no bit of
a clean run.

Per-leaf policy (field names, applied to the last path component):

  * ``fct`` and the megakernel's ``pend`` lanes are skipped: NaN is their
    "not finished" encoding;
  * inf-encoded sentinels (``rate_cap``, ``remaining``, ``start``,
    ``stop``, ``next_update``, ``last_update``) and law-private state
    (anything under a ``law`` field) are checked for NaN only;
  * integer and bool leaves are skipped, as are the host's counters (the
    port's ``t`` and ``admitted``) and the reference backend's gather
    table ``inv``, so the first non-finite field is the one ``repro``
    names;
  * everything else (windows, queues, rates, telemetry rings) must be
    finite.

Field paths are the NamedTuple field names joined by dots (``law.u``,
``state.w``), the form ``repro``'s ``keystr`` paths take.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


class DivergenceError(RuntimeError):
    """A guarded run's carry went non-finite. ``law``/``tick``/``field``
    name the diagnosis; ``is_transient`` excludes it (retrying a divergent
    config cannot succeed)."""

    def __init__(self, law: str, tick: int, field: str):
        self.law = str(law)
        self.tick = int(tick)
        self.field = str(field)
        super().__init__(
            f"law '{law}' diverged by tick {tick}: first non-finite "
            f"field '{field}' (check the law config for this point)")


# NaN is these fields' encoding ("not finished" / "empty pending lane")
_SKIP = ("fct", "pend")
# inf-encoded sentinels: free slots park next_update at inf, long-lived
# flows carry remaining/size inf, rate caps default inf
_INF_OK = frozenset({"rate_cap", "remaining", "start", "stop",
                     "next_update", "last_update"})


def _leaf_mode(names: List[str]) -> str:
    """'skip' | 'nan' (NaN illegal, inf legal) | 'finite' (both illegal)."""
    last = names[-1] if names else ""
    if any(n in _SKIP for n in names):
        return "skip"
    if last in _INF_OK or "law" in names[:-1]:
        return "nan"
    return "finite"


def _named_leaves(tree, names=()):
    """(path names, tensor) of every tensor in nested NamedTuples, in
    field order."""
    if isinstance(tree, torch.Tensor):
        return [(list(names), tree)]
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", [str(i) for i in range(len(tree))])
        return [p for f, v in zip(fields, tree)
                for p in _named_leaves(v, names + (f,))]
    return []


def finite_flags(state) -> Tuple[List[str], torch.Tensor]:
    """(checked leaf names, [K] bool tensor: True means clean), one
    reduction per checked float leaf stacked into one vector, so that the
    caller pays one transfer."""
    names, flags = [], []
    for path, leaf in _named_leaves(state):
        mode = _leaf_mode(path)
        if mode == "skip" or not leaf.is_floating_point():
            continue
        ok = (~torch.any(torch.isnan(leaf)) if mode == "nan"
              else torch.all(torch.isfinite(leaf)))
        names.append(".".join(path))
        flags.append(ok)
    if not flags:
        return names, torch.ones((0,), dtype=torch.bool)
    return names, torch.stack(flags)


def first_divergent_field(state) -> str:
    """The first flagged leaf's name, or '' when the carry is clean (the
    post-hoc form ``run_sweep`` uses on finished batch rows)."""
    names, flags = finite_flags(state)
    if not names:
        return ""
    for name, ok in zip(names, flags.cpu().tolist()):
        if not ok:
            return name
    return ""


def check_divergence(state, law_name: str, tick: int) -> None:
    """The host's boundary check: one transfer; raises ``DivergenceError``
    on the first flagged leaf, else returns."""
    field = first_divergent_field(state)
    if field:
        raise DivergenceError(law_name, tick, field)
