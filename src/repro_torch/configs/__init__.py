"""Model, shape, mesh and training configuration (twin of
``repro.configs``; the registry's architectures but the
encoder-decoder and the VLM)."""
from .base import MeshConfig, ModelConfig, SHAPES, ShapeConfig, TrainConfig
from .registry import PORTED, canon, get_config, padded_vocab, reduced_config

__all__ = ["MeshConfig", "ModelConfig", "SHAPES", "ShapeConfig",
           "TrainConfig", "PORTED", "canon", "get_config", "padded_vocab",
           "reduced_config"]
