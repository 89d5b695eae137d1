"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``:
the serving path's activation quantizer and the GPFQ panel solver)."""

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


def gpfq_quantize_panel(w_int, xg, xh, lam, budget_b, *, w_bits: int = 4, tile: int = 128,
                        rounding: str = "nearest"):
    """The reference's panel-solver call: split budgets [-B, B], tile ids in
    natural order. Returns the (K, C) codes; the CUDA kernel runs for CUDA
    tensors, its plain version for CPU tensors."""
    from .gpfq_solve import gpfq_solve

    tile_ids = torch.arange(w_int.shape[0], device=w_int.device) // tile
    q, _, _, _ = gpfq_solve(w_int, xg, xh, lam, tile_ids, -float(budget_b), float(budget_b),
                            w_bits=w_bits, mode="split", rounding=rounding)
    return q


__all__ = ["gpfq_quantize_panel", "quantize_activations"]
