"""qwen3-moe-30b-a3b — MoE transformer, 128 experts top-8, GQA, qk-norm.

Source: hf:Qwen/Qwen3-30B-A3B; 48L d_model=2048 32H kv=4 expert_d_ff=768 vocab=151936
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1000000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    pattern=("moe",),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    qk_norm=True,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=96,
    pattern=("moe",),
)
