"""llama3-405b — Dense GQA frontier-scale transformer. bf16 params + bf16 moments (memory note in DESIGN.md section 6).

Source: arXiv:2407.21783; 126L d_model=16384 128H kv=8 d_ff=53248 vocab=128256
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    norm="rmsnorm",
    act="silu",
    rope_theta=500000.0,
    param_dtype="bfloat16",
    pattern=("attn",),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    param_dtype="bfloat16",
    pattern=("attn",),
)
