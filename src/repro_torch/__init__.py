"""PyTorch/CUDA port of the ``repro`` package (AXE accumulator-aware PTQ
and packed W4A8 serving), for one NVIDIA H100.

The package mirrors ``src/repro`` path for path, so each module names its
JAX reference. It imports ``torch`` and numpy only. Every entry point takes
an explicit ``device=`` that defaults to ``"cuda"`` and raises when no card
is present; the CPU is used only when a caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
