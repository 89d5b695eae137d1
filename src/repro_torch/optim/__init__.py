"""The optimizer (port of ``repro/optim``)."""

from .adamw import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_at_step,
    trainable_parameters,
)

__all__ = [
    "OptimizerConfig",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "lr_at_step",
    "trainable_parameters",
]
