"""Architecture registry of the port (port of ``repro/configs/__init__.py``):
the reference's ten architectures in its order (``ARCH_IDS``), each with
its published ``config()`` and its reduced ``smoke()``, and the paper's
``tiny-*`` rungs. llama3-405b, dbrx-132b, internvl2-76b and
jamba-1.5-large-398b do not fit one card; the port runs them as smoke
configs (and the Jamba-width Mamba block). ``configs/shapes.py`` holds the
dry run's shape stand-ins (meta tensors)."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (
    dbrx_132b,
    granite_moe_3b_a800m,
    internvl2_76b,
    jamba_1_5_large_398b,
    llama3_405b,
    musicgen_medium,
    phi4_mini_3_8b,
    smollm_360m,
    stablelm_3b,
    xlstm_350m,
)
from .paper import PAPER_MODELS
from .shapes import SHAPES, ShapeSpec, applicable, batch_specs, cache_specs

_MODULES = (
    musicgen_medium,
    xlstm_350m,
    stablelm_3b,
    smollm_360m,
    llama3_405b,
    phi4_mini_3_8b,
    granite_moe_3b_a800m,
    dbrx_132b,
    internvl2_76b,
    jamba_1_5_large_398b,
)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


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


__all__ = ["ARCH_IDS", "REGISTRY", "SHAPES", "ShapeSpec", "applicable", "batch_specs",
           "cache_specs", "get_config", "get_smoke"]
