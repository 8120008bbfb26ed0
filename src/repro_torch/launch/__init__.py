"""Launch helpers (twin of ``repro.launch``): the per-arch training
presets. The mesh, dry-run and HLO-analysis modules are not ported
(ROADMAP.md, Queue 1 item 15)."""
from .presets import train_preset

__all__ = ["train_preset"]
