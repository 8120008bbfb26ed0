"""qwen3-14b — Dense GQA transformer with qk-norm.

Source: hf:Qwen/Qwen3-14B; 40L d_model=5120 40H kv=8 d_ff=17408 vocab=151936
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1000000.0,
    pattern=("attn",),
)

# reduced same-family config for CPU tests
REDUCED = ModelConfig(
    name="qwen3-14b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    pattern=("attn",),
)
