"""Architecture registry of the port (port of ``repro/configs/__init__.py``):
the ``tiny-*`` rungs (dense, MoE, SSM, xLSTM, hybrid), smollm-360m,
granite-moe-3b-a800m, xlstm-350m and jamba-1.5-large-398b (its smoke config
and its widths; the full model does not fit one card). Other architectures
raise until the slice that serves their family is ported."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import granite_moe_3b_a800m, jamba_1_5_large_398b, smollm_360m, xlstm_350m
from .paper import PAPER_MODELS

REGISTRY = {m.ARCH_ID: m for m in (smollm_360m, granite_moe_3b_a800m, xlstm_350m,
                                   jamba_1_5_large_398b)}


def get_config(arch: str) -> ModelConfig:
    if arch in REGISTRY:
        return REGISTRY[arch].config()
    if arch in PAPER_MODELS:
        return PAPER_MODELS[arch]()
    raise KeyError(
        f"unknown arch {arch!r} in the port; known: "
        f"{sorted(REGISTRY) + sorted(PAPER_MODELS)}"
    )


def get_smoke(arch: str) -> ModelConfig:
    if arch in REGISTRY:
        return REGISTRY[arch].smoke()
    raise KeyError(f"unknown arch {arch!r}")


__all__ = ["REGISTRY", "get_config", "get_smoke"]
