"""Quantizable-site registry (port of ``repro/quant/families/__init__.py``):
one adapter per (kind, LayerSpec value). The port registers the dense
adapters; MoE, Mamba and xLSTM arrive with the family slice."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from .base import BlockAdapter, Pair, SiteSpec, TapContext, TapFn, both
from .dense import AttentionAdapter, MLPAdapter

_REGISTRY: dict[tuple[str, str], BlockAdapter] = {
    (a.kind, a.name): a for a in (AttentionAdapter(), MLPAdapter())
}


def get_adapter(kind: str, name: str) -> BlockAdapter:
    """The adapter for a LayerSpec component, or NotImplementedError."""
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        raise NotImplementedError(
            f"no adapter for {kind} {name!r} in the port (registered: "
            f"{sorted(_REGISTRY)}); the MoE/SSM/xLSTM families arrive with "
            f"the family slice of the port"
        ) from None


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every pattern component has an
    adapter ("none" components are skipped)."""
    for spec in cfg.pattern:
        for kind, name in (("mixer", spec.mixer), ("ffn", spec.ffn)):
            if name != "none":
                get_adapter(kind, name)


__all__ = [
    "BlockAdapter",
    "Pair",
    "SiteSpec",
    "TapContext",
    "TapFn",
    "both",
    "check_supported",
    "get_adapter",
]
