"""Train-step builder: loss, microbatch gradient accumulation, optimizer
(twin of ``repro.train.step``).

The returned ``train_step(params, opt, batch)`` updates ``params`` (a
tree of leaf tensors) and the optimizer state in place and returns them
with the step's metrics. Microbatches run one after another, each a
forward and a backward, so activation memory scales with the microbatch;
their gradients are added in ``accum_dtype`` in ``repro``'s order (zeros
+ g1 + g2 + ..., then / k, which XLA compiles as a product with the
float32 reciprocal of k) as each leaf's gradient is finished, through a
post-accumulate hook, so that one microbatch's gradients are never held
beside the sum. The parameters are set to require grad.

``repro``'s ``_shard_like_params`` (each gradient constrained to its
parameter's logical axes) is a no-op on one card and is left out; it
comes with the multi-card trainer (ROADMAP.md, Queue 1 item 15).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models.lm import lm_forward
from ..models.spec import _leaves, torch_dtype
from .optim import _f32, _tree_map, adamw_update


def xent_loss(logits, labels, cfg: ModelConfig):
    """Mean token cross-entropy; masks label==-1 and padded vocab columns.
    The gold logit is picked by a compare against the column index (its
    gradient a ``where``), not by ``gather``, whose backward on the card is
    an atomic scatter-add."""
    tv = cfg.true_vocab or cfg.vocab_size
    col = torch.arange(logits.shape[-1], device=logits.device)
    if tv < cfg.vocab_size:
        logits = torch.where(col < tv, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    pick = col == torch.clamp_min(labels, 0).to(col.dtype)[..., None]
    gold = torch.where(pick, logits, 0.0).sum(dim=-1)
    mask = (labels >= 0).to(torch.float32)
    ll = (gold - logz) * mask
    return -torch.sum(ll) / torch.clamp_min(torch.sum(mask), 1.0)


def _batch_slice(batch, i: int, k: int):
    return {n: x[i * (x.shape[0] // k):(i + 1) * (x.shape[0] // k)]
            for n, x in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    accum_dtype = torch_dtype(getattr(tcfg, "accum_dtype", "float32"))

    def loss_fn(params, mb):
        logits = lm_forward(params, mb, cfg, remat=tcfg.remat)
        return xent_loss(logits, mb["labels"], cfg)

    def train_step(params, opt, batch):
        k = max(tcfg.microbatch, 1)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if k == 1:
            loss = loss_fn(params, batch)
            loss.backward()
            grads = _tree_map(lambda p: p.grad, params)
            loss = loss.detach()
        else:
            gsum = {id(p): torch.zeros(p.shape, dtype=accum_dtype,
                                       device=p.device) for p in leaves}

            def add(p):
                gsum[id(p)].add_(p.grad.to(accum_dtype))
                p.grad = None
            hooks = [p.register_post_accumulate_grad_hook(add)
                     for p in leaves]
            try:
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for i in range(k):
                    loss = loss_fn(params, _batch_slice(batch, i, k))
                    loss.backward()
                    lsum = lsum + loss.detach()
            finally:
                for h in hooks:
                    h.remove()
            inv = _f32(1.0 / k)
            grads = _tree_map(lambda p: gsum[id(p)].mul_(inv), params)
            loss = lsum * inv
        for p in leaves:
            p.grad = None
        params, opt, metrics = adamw_update(params, grads, opt, tcfg)
        metrics["loss"] = loss
        return params, opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, remat: str = "none"):
    def eval_step(params, batch):
        logits = lm_forward(params, batch, cfg, remat=remat)
        return xent_loss(logits, batch["labels"], cfg)
    return eval_step
