"""whisper-large-v3 — Encoder-decoder audio backbone; conv frontend is a stub (input_specs provides 1500 precomputed frame embeddings).

Source: arXiv:2212.04356; 32+32L d_model=1280 20H MHA d_ff=5120 vocab=51866
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51968,
    true_vocab=51866,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    learned_pos=True,
    tie_embeddings=True,
    enc_layers=32,
    enc_seq=1500,
    max_pos=32768,
    pattern=("dec",),
)

# reduced same-family config for CPU tests
REDUCED = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    learned_pos=True,
    tie_embeddings=True,
    enc_layers=2,
    enc_seq=16,
    max_pos=64,
    pattern=("dec",),
)
