"""Model configuration (twin of ``repro.configs``; ``ModelConfig`` and the
qwen3-14b entry of the registry)."""
from .base import ModelConfig
from .registry import PORTED, canon, get_config, padded_vocab, reduced_config

__all__ = ["ModelConfig", "PORTED", "canon", "get_config", "padded_vocab",
           "reduced_config"]
