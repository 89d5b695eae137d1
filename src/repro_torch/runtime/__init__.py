"""Training runtime (port of ``repro/runtime``; one device)."""

from .steps import TrainRunConfig, init_train_state, make_train_step

__all__ = ["TrainRunConfig", "init_train_state", "make_train_step"]
