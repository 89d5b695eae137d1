"""Architecture registry of the port (port of ``repro/configs/__init__.py``):
the dense ``tiny-lm-*`` rungs, ``tiny-moe``, smollm-360m and
granite-moe-3b-a800m. Other architectures raise until the slice that
serves their family is ported."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import granite_moe_3b_a800m, smollm_360m
from .paper import PAPER_MODELS

REGISTRY = {m.ARCH_ID: m for m in (smollm_360m, granite_moe_3b_a800m)}


def get_config(arch: str) -> ModelConfig:
    if arch in REGISTRY:
        return REGISTRY[arch].config()
    if arch in PAPER_MODELS:
        return PAPER_MODELS[arch]()
    raise KeyError(
        f"unknown arch {arch!r} in the port; known: "
        f"{sorted(REGISTRY) + sorted(PAPER_MODELS)} (the SSM/xLSTM/hybrid "
        f"families arrive with their slices)"
    )


def get_smoke(arch: str) -> ModelConfig:
    if arch in REGISTRY:
        return REGISTRY[arch].smoke()
    raise KeyError(f"unknown arch {arch!r}")


__all__ = ["REGISTRY", "get_config", "get_smoke"]
