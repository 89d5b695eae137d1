"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``:
the serving path's activation quantizer, the fused norm-and-quantize and
the GPFQ panel solver)."""

from __future__ import annotations

import torch


def quantize_activations(x: torch.Tensor, *, per_expert: bool = False, range_reduce=None):
    """Dynamic per-tensor asymmetric 8-bit activation quantization (the A8
    half of W4A8 when no calibrated activation quantizer ships with the
    artifact). Returns (codes uint8, scale f32, zp f32), the scale and zero
    point 0-d tensors on ``x``'s device: no host read.

    ``per_expert``: ``x`` is (E, M, K), one expert's rows a slice, and each
    slice is quantized on its own, as the reference's quantizer is under
    ``vmap``: its min and max include the capacity rows the dispatch left
    at zero, and an expert that got no token takes the 1e-8 scale floor.
    The scale and zero point are then (E,).

    ``range_reduce`` takes the range as the f32 pair (max, -min), stacked
    on a leading axis of 2 (each (E,) with ``per_expert``), and returns it
    reduced over whatever else holds parts of the tensor (a K-sharded
    site's ranks), so every part quantizes with the whole tensor's (or
    each whole expert's) scale and zero point."""
    xf = x.to(torch.float32)
    if per_expert:
        flat = xf.reshape(xf.shape[0], -1)
        lo = torch.clamp(torch.amin(flat, dim=1), max=0.0)
        hi = torch.clamp(torch.amax(flat, dim=1), min=0.0)
    else:
        lo = torch.clamp(torch.amin(xf), max=0.0)
        hi = torch.clamp(torch.amax(xf), min=0.0)
    if range_reduce is not None:
        both = range_reduce(torch.stack([hi, -lo]))
        hi, lo = both[0], -both[1]
    scale = torch.clamp((hi - lo) / 255.0, min=1e-8)
    zp = torch.clamp(torch.round(-lo / scale), 0.0, 255.0)
    shape = (-1,) + (1,) * (xf.dim() - 1) if per_expert else ()
    codes = torch.clamp(torch.round(xf / scale.reshape(shape)) + zp.reshape(shape), 0.0,
                        255.0).to(torch.uint8)
    return codes, scale, zp


def norm_and_quantize(x, gamma, act_scale, act_zp, **kw):
    """RMSNorm then the 8-bit activation quantizer, fused: kernel B6 for
    CUDA tensors, its plain version for CPU tensors (``block_m``, ``bits``
    and ``eps`` as the reference takes them)."""
    from .quant_rmsnorm import quant_rmsnorm

    return quant_rmsnorm(x, gamma, act_scale, act_zp, **kw)


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


__all__ = ["gpfq_quantize_panel", "norm_and_quantize", "quantize_activations"]
