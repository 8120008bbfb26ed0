"""Model, shape, mesh and training configuration (twin of
``repro.configs``; all ten of the registry's architectures). The cells'
input declarations are in ``configs.inputs``, as in ``repro``."""
from .base import MeshConfig, ModelConfig, SHAPES, ShapeConfig, TrainConfig
from .registry import PORTED, canon, get_config, padded_vocab, reduced_config

__all__ = ["MeshConfig", "ModelConfig", "SHAPES", "ShapeConfig",
           "TrainConfig", "PORTED", "canon", "get_config", "padded_vocab",
           "reduced_config"]
