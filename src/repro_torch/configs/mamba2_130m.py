"""mamba2-130m — Attention-free SSM (state-space duality / SSD).

Source: arXiv:2405.21060; 24L d_model=768 ssm_state=128 vocab=50280
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50432,
    true_vocab=50280,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_conv=4,
    ssm_headdim=64,
    pattern=("ssm",),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    tie_embeddings=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_headdim=16,
    pattern=("ssm",),
)
