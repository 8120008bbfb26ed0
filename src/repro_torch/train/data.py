"""Deterministic, seekable synthetic-language data pipeline (a copy of
``repro.train.data``: numpy only, so the batches are ``repro``'s bytes).

Every batch is a pure function of ``(seed, step)`` via counter-based Philox
bits — no state files, no iterators to fast-forward. After a crash/restart
the loop resumes at step k and reads exactly the batch it would have read,
so restarts replay zero duplicate tokens (the fault-tolerance property the
restart test asserts).

The synthetic "language" is a noisy integer-sequence task (next token =
(prev*a + c) mod vocab with occasional resampling), so tiny models show a
real, monotonically decreasing loss — useful for convergence smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 64
    seed: int = 1234
    noise: float = 0.05        # resample fraction (keeps entropy non-zero)
    mult: int = 5              # affine next-token rule
    add: int = 7


class SyntheticData:
    def __init__(self, model_cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = model_cfg
        self.d = dcfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.d.seed, counter=step))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        d, cfg = self.d, self.cfg
        tv = cfg.true_vocab or cfg.vocab_size
        rng = self._rng(step)
        first = rng.integers(0, tv, size=(d.batch, 1))
        toks = [first]
        for _ in range(d.seq):
            toks.append((toks[-1] * d.mult + d.add) % tv)
        seq = np.concatenate(toks, axis=1)              # [B, seq+1]
        noise = rng.random(seq.shape) < d.noise
        seq = np.where(noise, rng.integers(0, tv, size=seq.shape), seq)
        out = {"tokens": seq[:, :-1].astype(np.int32),
               "labels": seq[:, 1:].astype(np.int32)}
        if cfg.enc_layers:
            out["enc_feats"] = rng.standard_normal(
                (d.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.num_image_tokens:
            out["img_embeds"] = rng.standard_normal(
                (d.batch, cfg.num_image_tokens, cfg.d_model)
            ).astype(np.float32)
        return out
