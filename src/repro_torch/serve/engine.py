"""Serving step builders and the batched-decode driver (twin of
``repro.serve.engine``).

``decode_loop`` prefills a batch of prompts and decodes greedily (or by
temperature sampling) one token per step for every sequence. The device
is the params' device; the cache is updated in place from step to step.
Sampling draws from an explicit ``torch.Generator``: reproducible under a
seed, but its draws are not JAX's, so only greedy decoding is compared
with ``repro``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..models.lm import lm_decode_step, lm_forward, lm_prefill


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return lm_prefill(params, batch, cfg, cache_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, cache, index):
        return lm_decode_step(params, token, cache, index, cfg)
    return serve_step


def make_forward(cfg: ModelConfig, remat: str = "none"):
    """Plain forward (no cache kept)."""
    def fwd(params, batch):
        return lm_forward(params, batch, cfg, remat=remat)
    return fwd


def decode_loop(params, cfg: ModelConfig, prompt, steps: int,
                cache_len: Optional[int] = None, temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                extras: Optional[dict] = None, on_logits=None):
    """Greedy/sampled generation. prompt: [B, P] int. Returns [B, steps]
    int64: the token picked from the prefill's logits, then one per decode
    step. ``on_logits(logits)``, if given, sees every step's logits."""
    if extras:
        raise NotImplementedError(
            "extra batch inputs are not ported to repro_torch yet "
            "(ROADMAP.md, Queue 1 item 15: encoder-decoder, VLM)")
    B, P = prompt.shape
    cache_len = cache_len or (P + steps)
    logits, cache = lm_prefill(params, {"tokens": prompt}, cfg, cache_len)
    tv = cfg.true_vocab or cfg.vocab_size

    def pick(lg):
        if on_logits is not None:
            on_logits(lg)
        lg = lg[:, 0, :tv]
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    toks = [pick(logits)]
    for i in range(steps - 1):
        logits, cache = lm_decode_step(params, toks[-1][:, None], cache,
                                       P + i, cfg)
        toks.append(pick(logits))
    return torch.stack(toks, dim=1)
