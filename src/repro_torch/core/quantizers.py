"""Uniform quantizers on tensors (port of the serving part of
``repro/core/quantizers.py``)."""

from __future__ import annotations

import torch

from .alphabet import Alphabet

ROUND_NEAREST = "nearest"
ROUND_ZERO = "zero"


def round_fn(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == ROUND_NEAREST:
        return torch.round(x)  # half to even, as jnp.rint
    if mode == ROUND_ZERO:
        return torch.trunc(x)
    raise ValueError(f"unknown rounding mode {mode!r}")


def quantize_int(x: torch.Tensor, alphabet: Alphabet,
                 rounding: str = ROUND_NEAREST) -> torch.Tensor:
    """Integer-domain quantizer: round then clip to the alphabet (float carrier)."""
    return torch.clamp(round_fn(x, rounding), alphabet.qmin, alphabet.qmax)


def weight_scales(w: torch.Tensor, alphabet: Alphabet, axis: int = 0,
                  eps: float = 1e-12) -> torch.Tensor:
    """s = max|w| / (2^(M-1)-1) per output channel; ``w`` is (K, C) with the
    reduction over ``axis`` (default 0 = input dim), kept as a size-1 dim."""
    absmax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    return torch.clamp(absmax / float(alphabet.qmax), min=eps)
