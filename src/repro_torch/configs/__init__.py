"""Model, shape, mesh and training configuration (twin of
``repro.configs``; the registry's attn and moe architectures)."""
from .base import MeshConfig, ModelConfig, SHAPES, ShapeConfig, TrainConfig
from .registry import PORTED, canon, get_config, padded_vocab, reduced_config

__all__ = ["MeshConfig", "ModelConfig", "SHAPES", "ShapeConfig",
           "TrainConfig", "PORTED", "canon", "get_config", "padded_vocab",
           "reduced_config"]
