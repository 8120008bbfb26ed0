"""Input declarations per (arch x shape) cell (twin of
``repro.configs.inputs``).

``input_specs`` returns ParamSpec trees (the same declaration language as
model params), so a cell's inputs are declared without allocating. The
modality frontends are stubs, as in ``repro``: whisper cells carry
precomputed frame embeddings [B, 1500, d_model]; phi-3-vision cells carry
patch embeddings [B, 576, d_model].
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.spec import ParamSpec
from .base import ModelConfig, ShapeConfig


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    d = {"tokens": ParamSpec((B, S), "int32", ("batch", None), "zeros")}
    if shape.kind == "train":
        d["labels"] = ParamSpec((B, S), "int32", ("batch", None), "zeros")
    if cfg.enc_layers:
        d["enc_feats"] = ParamSpec((B, cfg.enc_seq, cfg.d_model), "bfloat16",
                                   ("batch", None, None), "zeros")
    if cfg.num_image_tokens:
        d["img_embeds"] = ParamSpec(
            (B, cfg.num_image_tokens, cfg.d_model), "bfloat16",
            ("batch", None, None), "zeros")
    return d


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[str, Dict]:
    """Returns (step_kind, spec tree for the step's data arguments).

    step_kind: "train" -> train_step(params, opt, batch)
               "prefill" -> forward(params, batch)
               "decode" -> serve_step(params, token, cache, index)
    """
    if shape.kind in ("train", "prefill"):
        return shape.kind, {"batch": batch_specs(cfg, shape)}
    # decode: one new token against a cache of seq_len context
    from ..serve.cache import cache_specs
    B, S = shape.global_batch, shape.seq_len
    d = {
        "token": ParamSpec((B, 1), "int32", ("batch", None), "zeros"),
        "cache": cache_specs(cfg, B, S),
        "index": ParamSpec((), "int32", (), "constant", float(S - 1)),
    }
    return "decode", d
