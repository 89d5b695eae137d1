"""Serving-side wrappers around the kernels (port of
``repro/kernels/ops.py``, the part the serving path runs)."""

from __future__ import annotations

import torch


def quantize_activations(x: torch.Tensor):
    """Dynamic per-tensor asymmetric 8-bit activation quantization (the A8
    half of W4A8 when no calibrated activation quantizer ships with the
    artifact). Returns (codes uint8, scale f32, zp f32) as 0-d tensors on
    ``x``'s device: no host read."""
    xf = x.to(torch.float32)
    lo = torch.clamp(torch.amin(xf), max=0.0)
    hi = torch.clamp(torch.amax(xf), min=0.0)
    scale = torch.clamp((hi - lo) / 255.0, min=1e-8)
    zp = torch.clamp(torch.round(-lo / scale), 0.0, 255.0)
    codes = torch.clamp(torch.round(xf / scale) + zp, 0.0, 255.0).to(torch.uint8)
    return codes, scale, zp


__all__ = ["quantize_activations"]
