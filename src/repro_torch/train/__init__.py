"""Training on one card (twin of ``repro.train``): optimizer, step
builder, data pipeline, checkpointing, driver."""
from .optim import (OptState, adamw_update, global_norm, init_opt,
                    lr_schedule, opt_specs)
from .step import make_eval_step, make_train_step, xent_loss
from .data import DataConfig, SyntheticData
from .checkpoint import Checkpointer
from .loop import CrashInjected, train_driver

__all__ = ["OptState", "adamw_update", "global_norm", "init_opt",
           "lr_schedule", "opt_specs", "make_eval_step", "make_train_step",
           "xent_loss", "DataConfig", "SyntheticData", "Checkpointer",
           "CrashInjected", "train_driver"]
