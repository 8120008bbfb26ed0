"""stablelm-3b — Dense transformer, LayerNorm + 25%% partial RoPE.

Source: hf:stabilityai/stablelm-3b-4e1t; 32L d_model=2560 32H MHA d_ff=6912 vocab=50304
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    act="silu",
    rope_frac=0.25,
    pattern=("attn",),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    norm="layernorm",
    rope_frac=0.25,
    pattern=("attn",),
)
