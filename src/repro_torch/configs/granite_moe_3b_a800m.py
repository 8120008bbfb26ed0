"""granite-moe-3b-a800m — MoE transformer, 40 experts top-8 (numeric field of the assignment; the bracketed 32 disagrees -- see DESIGN.md).

Source: hf:ibm-granite/granite-3.0-3b-a800m-base; 32L d_model=1536 24H kv=8 expert_d_ff=512 vocab=49155
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49408,
    true_vocab=49155,
    norm="rmsnorm",
    act="silu",
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
    pattern=("moe",),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    true_vocab=507,
    num_experts=5,
    experts_per_token=2,
    moe_d_ff=96,
    tie_embeddings=True,
    pattern=("moe",),
)
