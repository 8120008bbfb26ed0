"""Straggler mitigation for multi-pod outer syncs: bounded staleness.

At 1000+-node scale some pod is always slow (preemption, thermals, a bad
host). A hard-synchronous outer sync runs at the speed of the slowest pod;
DiLoCo's H-step structure lets us do better: a pod that hasn't finished its
inner window within ``patience x median`` is skipped for this sync and its
(still error-fed) delta joins the next one — bounded staleness of one sync.

``simulate_syncs`` scores the policy against per-pod step-time
distributions (lognormal with injected stragglers), reporting wall-clock
per sync and the staleness histogram — the napkin model behind the
``patience`` default. The host-side decision function ``sync_plan`` is
pure and unit-tested; the sync it gates is ``commsched.make_outer_sync``
(skipped pods contribute a zero delta via their mask, which the EF residual
carries forward). (A copy of ``repro.commsched.straggler``.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    patience: float = 1.5        # wait up to patience * median pod time
    min_quorum: float = 0.5      # never sync with fewer than this fraction


def sync_plan(finish_times: Sequence[float],
              policy: StragglerPolicy = StragglerPolicy()) -> Dict:
    """Given each pod's projected inner-window finish time, decide when to
    run the sync and which pods participate.

    Returns {"start": t, "include": bool mask, "stale": indices skipped}.
    """
    ft = np.asarray(finish_times, np.float64)
    med = float(np.median(ft))
    deadline = policy.patience * med
    include = ft <= deadline
    quorum = max(int(np.ceil(policy.min_quorum * len(ft))), 1)
    if include.sum() < quorum:                 # degenerate: wait for quorum
        order = np.argsort(ft)
        include = np.zeros(len(ft), bool)
        include[order[:quorum]] = True
        deadline = float(ft[order[quorum - 1]])
    return {"start": float(max(deadline, ft[include].max())),
            "include": include,
            "stale": np.where(~include)[0].tolist()}


def simulate_syncs(npods: int, nsyncs: int,
                   policy: StragglerPolicy = StragglerPolicy(),
                   straggler_prob: float = 0.05,
                   straggler_mult: float = 5.0, seed: int = 0) -> Dict:
    """Compare synchronous vs bounded-staleness wall-clock over nsyncs.

    Pod inner-window times ~ lognormal(mean 1); with prob straggler_prob a
    pod takes straggler_mult x longer (preemption model).
    """
    rng = np.random.default_rng(seed)
    t_sync_total = 0.0
    t_policy_total = 0.0
    stale_counts: List[int] = []
    carry = np.zeros(npods)                    # leftover work from skips
    for _ in range(nsyncs):
        base = rng.lognormal(mean=0.0, sigma=0.2, size=npods)
        slow = rng.random(npods) < straggler_prob
        times = base * np.where(slow, straggler_mult, 1.0)
        t_sync_total += times.max()
        plan = sync_plan(times + carry, policy)
        t_policy_total += plan["start"]
        stale_counts.append(len(plan["stale"]))
        # skipped pods resume with their remaining work
        carry = np.where(plan["include"], 0.0,
                         np.maximum(times + carry - plan["start"], 0.0))
    return {
        "wall_sync": t_sync_total,
        "wall_policy": t_policy_total,
        "speedup": t_sync_total / max(t_policy_total, 1e-9),
        "mean_stale_pods": float(np.mean(stale_counts)),
        "max_stale_pods": int(np.max(stale_counts)),
    }
