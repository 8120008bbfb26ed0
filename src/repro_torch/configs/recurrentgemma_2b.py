"""recurrentgemma-2b — RG-LRU + local attention hybrid (Griffin), 1 local per 3 layers.

Source: arXiv:2402.19427 (RecurrentGemma); 26L d_model=2560 10H MQA d_ff=7680 vocab=256000
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
    embed_scale=True,
    tie_embeddings=True,
    d_rnn=2560,
    rglru_conv=4,
    # 26 layers: (rec,rec,local) cycle, trailing rec pair -> 13-pattern x2,
    pattern=("rec", "rec", "local", "rec", "rec", "local", "rec", "rec", "local", "rec", "rec", "local", "rec"),
)

# reduced same-family config for CPU smoke tests (one fwd/train step)
REDUCED = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=8,
    norm="rmsnorm",
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    d_rnn=64,
    pattern=("rec", "rec", "local"),
)
