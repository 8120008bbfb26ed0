"""gemma-7b — Dense transformer, GeGLU, head_dim=256.

Source: arXiv:2403.08295; 28L d_model=3072 16H kv=16 d_ff=24576 vocab=256000
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    norm="rmsnorm",
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    pattern=("attn",),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="gemma-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    pattern=("attn",),
)
