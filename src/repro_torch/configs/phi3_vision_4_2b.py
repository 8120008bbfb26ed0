"""phi3-vision-4-2b — phi3-mini text backbone + CLIP vision stub (input_specs provides 576 precomputed patch embeddings).

Source: hf:microsoft/Phi-3-vision-128k-instruct; 32L d_model=3072 32H MHA d_ff=8192 vocab=32064
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    norm="rmsnorm",
    act="silu",
    num_image_tokens=576,
    pattern=("attn",),
)

# reduced same-family config for CPU tests
REDUCED = ModelConfig(
    name="phi3-vision-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    num_image_tokens=8,
    pattern=("attn",),
)
