"""Plain oracles of the kernels (port of ``repro/kernels/ref.py``): the
W4A8 GEMM in exact integer arithmetic, the GPFQ loop and the fused
RMSNorm quantizer, on either device."""

from __future__ import annotations

import torch

from .w4a8_mm import exact_int_matmul, unpack_int4


def w4a8_matmul_ref(x_int8, w_packed, w_scale, act_scale, act_zp):
    """Dequantize-then-matmul with exact integer accumulation, in the
    reference oracle's operation order ``(acc - corr) * act_scale * w_scale``
    (the kernel's plain version, ``w4a8_matmul_plain``, keeps the kernel's
    order instead)."""
    q = unpack_int4(w_packed).to(torch.int32)  # (K, N)
    acc = exact_int_matmul(x_int8, q).to(torch.float32)
    corr = (q.sum(dim=0) * act_zp).to(torch.float32)
    return (acc - corr[None, :]) * act_scale * w_scale.to(torch.float32)[None, :]


def w4a8_tile_partials_ref(x_int8, w_packed, tile: int):
    """Per-K-tile int32 partial sums (M, n_tiles, N): the inner-accumulator
    watermark of each certified tile."""
    return tile_partials(x_int8, unpack_int4(w_packed), tile)


def tile_partials(x_int8, q, tile: int):
    """Per-K-tile int32 partial sums (M, n_tiles, N) of codes ``x_int8``
    (M, K) against integer weight codes ``q`` (K, N)."""
    m, k = x_int8.shape
    n = q.shape[1]
    nt = k // tile
    xt = x_int8.reshape(m, nt, tile).transpose(0, 1)  # (nt, M, tile)
    qt = q.reshape(nt, tile, n)
    if x_int8.is_cuda:
        parts = torch.bmm(xt.to(torch.float64), qt.to(torch.float64)).to(torch.int32)
    else:
        parts = torch.bmm(xt.to(torch.int32), qt.to(torch.int32))
    return parts.transpose(0, 1)  # (M, nt, N)


def gpfq_solve_ref(w_int, xg, xh, *, w_bits, lam, budget_b, tile, rounding="nearest"):
    """The GPFQ loop with split budgets [-B, B] and natural tile ids, through
    the kernel's plain version on any device (the reference's oracle is
    ``_gpfq_loop``, which the plain version transcribes)."""
    from .gpfq_solve import gpfq_solve_plain, row_terms

    k, c = w_int.shape
    n_tiles = (k + tile - 1) // tile
    lam = torch.broadcast_to(torch.as_tensor(lam, dtype=torch.float32, device=w_int.device),
                             (n_tiles, c)).contiguous()
    tid = torch.arange(k, device=w_int.device, dtype=torch.int32) // tile
    hg, hn = row_terms(xg, xh)
    q, _, _, _ = gpfq_solve_plain(w_int, xg, xh, hg, hn, lam, tid, -float(budget_b),
                                  float(budget_b), qmax=float(2 ** (w_bits - 1) - 1),
                                  mode="split", rounding=rounding)
    return q


def quant_rmsnorm_ref(x, gamma, act_scale, act_zp, *, eps=1e-6, bits=8):
    """RMSNorm times gamma, then the quantizer dividing by ``act_scale``
    (``repro/kernels/ref.py:66``; the kernel multiplies by its reciprocal)."""
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    y = xf * scale * gamma.to(torch.float32)
    q = torch.round(y / act_scale) + act_zp
    return torch.clamp(q, 0, 2**bits - 1).to(torch.uint8)
