"""The optimizer (port of ``repro/optim``)."""

from .adamw import (
    OptimizerConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_at_step,
    trainable_parameters,
)

__all__ = [
    "OptimizerConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "lr_at_step",
    "trainable_parameters",
]
