"""Training driver: init/restore -> step loop -> periodic async checkpoints
(twin of ``repro.train.loop``).

Fault tolerance contract (the port's tests mirror
``tests/test_fault_tolerance.py``):
  * deterministic seekable data => a restart at step k consumes exactly the
    batches a crash-free run would have consumed;
  * checkpoints carry (params, opt, step); restore is elastic across
    devices;
  * ``crash_at`` injects a hard failure mid-run (after the step executes,
    before its checkpoint) to prove restart converges to the same state.

The parameters are drawn on the device from a ``torch.Generator`` seeded
with ``tcfg.seed`` (its draws are not ``jax.random``'s: to start both
packages from one state, hand ``params`` and ``opt`` in).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core.types import resolve_device
from ..models.lm import lm_specs
from ..models.spec import _leaves, init_params
from .checkpoint import Checkpointer
from .data import DataConfig, SyntheticData
from .optim import init_opt
from .step import make_train_step


class CrashInjected(RuntimeError):
    pass


def train_driver(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 steps: int, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, resume: bool = True,
                 crash_at: Optional[int] = None,
                 hooks: Optional[List[Callable]] = None,
                 params=None, opt=None, device=None) -> Dict:
    """Returns {"params", "opt", "losses", "start_step", "steps_run"}.
    ``device``: where a fresh run draws its parameters and where the
    batches go ("cuda" unless given; with ``params`` handed in, their
    device)."""
    if device is None:
        device = _leaves(params)[0].device if params is not None else "cuda"
    dev = resolve_device(device)
    data = SyntheticData(cfg, dcfg)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = init_params(lm_specs(cfg), gen, dev)
        opt = init_opt(params, tcfg)
        if ckpt and resume and ckpt.latest_step() is not None:
            start, (params, opt) = ckpt.restore((params, opt), device=dev)
            start += 1

    losses = []
    for k in range(start, steps):
        batch = {kk: torch.from_numpy(v).to(dev)
                 for kk, v in data.batch_at(k).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        for h in (hooks or []):
            h(k, params, opt, metrics)
        if ckpt and ckpt_every and (k + 1) % ckpt_every == 0:
            ckpt.save(k, (params, opt))
        if crash_at is not None and k == crash_at:
            if ckpt:
                ckpt.wait()
            raise CrashInjected(f"injected failure after step {k}")
    if ckpt:
        ckpt.wait()
    return {"params": params, "opt": opt, "losses": losses,
            "start_step": start, "steps_run": steps - start}
