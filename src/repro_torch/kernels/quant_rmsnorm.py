"""Fused RMSNorm + asymmetric 8-bit activation quantization (port of
``repro/kernels/quant_rmsnorm.py``, kernel B6).

Every norm output of the W4A8 datapath is quantized to 8-bit codes right
away; fusing the two keeps the f32 intermediate out of device memory and
writes only the 1-byte codes. :func:`quant_rmsnorm` launches the
hand-written CUDA kernel (``csrc/quant_rmsnorm.cu``, replacing the Pallas
``_kernel`` at ``repro/kernels/quant_rmsnorm.py:22``) for CUDA tensors and
runs its plain version :func:`quant_rmsnorm_plain` for CPU tensors.
``quant_rmsnorm.launches`` counts kernel launches.

As in the reference, the wrapper forms ``inv_scale = 1 / act_scale`` in f32
and the kernel multiplies by it (``kernels/ref.py``'s
``quant_rmsnorm_ref`` divides instead, so the two may part by one code at
a rounding boundary).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_IN_DTYPES = (torch.float32, torch.bfloat16)


def quantizer_pair(act_scale, act_zp, device) -> torch.Tensor:
    """The (2,) f32 device pair {1 / act_scale, act_zp}, each formed in f32."""
    scale = torch.as_tensor(act_scale, dtype=torch.float32, device=device).reshape(())
    zp = torch.as_tensor(act_zp, dtype=torch.float32, device=device).reshape(())
    return torch.stack([torch.reciprocal(scale), zp])


def quant_rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, qp: torch.Tensor, *,
                        eps: float, qmax: float) -> torch.Tensor:
    """B6's plain version on the kernel's arguments, in the kernel's order:
    the mean of squares in f32, times 1/sqrt(ms + eps), times gamma, then
    the quantizer multiplying by ``qp[0]``."""
    xf = x.to(torch.float32)
    d = torch.tensor(float(xf.shape[-1]), device=x.device)  # a device divisor: true division
    ms = torch.sum(xf * xf, dim=-1, keepdim=True) / d
    r = torch.reciprocal(torch.sqrt(ms + eps))
    y = xf * r * gamma
    q = torch.round(y * qp[0]) + qp[1]
    return torch.clamp(q, 0.0, qmax).to(torch.uint8)


def quant_rmsnorm_kernel(x: torch.Tensor, gamma: torch.Tensor, qp: torch.Tensor, *,
                         eps: float, qmax: float) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (the arguments of
    :func:`quant_rmsnorm_plain`). Checks device, dtype, shape and
    contiguity and raises on what the kernel does not take; raises if the
    launch returns a CUDA error."""
    if not x.is_cuda:
        raise ValueError(f"quant_rmsnorm_kernel takes CUDA tensors, got {x.device}")
    m, d = x.shape
    for name, t in (("x", x), ("gamma", gamma), ("qp", qp)):
        if t.device != x.device:
            raise ValueError(f"quant_rmsnorm: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_rmsnorm: {name} must be contiguous")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"quant_rmsnorm: x must be float32 or bfloat16, got {x.dtype}")
    if gamma.dtype != torch.float32 or qp.dtype != torch.float32:
        raise TypeError("quant_rmsnorm: gamma and qp must be float32")
    if gamma.shape != (d,) or qp.shape != (2,):
        raise ValueError(f"quant_rmsnorm: gamma {tuple(gamma.shape)} / qp {tuple(qp.shape)} "
                         f"for D={d}")
    out = torch.empty((m, d), dtype=torch.uint8, device=x.device)
    if m == 0:
        return out
    err = _library().quant_rmsnorm_launch(
        x.data_ptr(), gamma.data_ptr(), qp.data_ptr(), out.data_ptr(), m, d,
        int(x.dtype == torch.bfloat16), eps, qmax,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_rmsnorm kernel launch failed: CUDA error {err}")
    quant_rmsnorm.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library (built with nvcc at first use)."""
    from ._build import load_library

    lib = load_library("quant_rmsnorm")
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.quant_rmsnorm_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.quant_rmsnorm_launch.restype = ctypes.c_int
    return lib


def quant_rmsnorm(
    x: torch.Tensor,  # (M, D) float32 or bfloat16
    gamma: torch.Tensor,  # (D,)
    act_scale,
    act_zp,
    *,
    block_m: int = 256,
    bits: int = 8,
    eps: float = 1e-6,
) -> torch.Tensor:
    """RMSNorm times gamma, quantized to (M, D) uint8 codes: the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors. ``block_m`` is the
    reference's row block: the kernel runs a block per row, but M must
    still be a multiple of it, as the reference requires."""
    m, d = x.shape
    if m % block_m:
        raise ValueError(f"quant_rmsnorm: M={m} is not a multiple of block_m={block_m}")
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    qp = quantizer_pair(act_scale, act_zp, x.device)
    qmax = float(2**bits - 1)
    if not x.is_cuda:
        return quant_rmsnorm_plain(x, gamma, qp, eps=eps, qmax=qmax)
    return quant_rmsnorm_kernel(x.contiguous(), gamma, qp, eps=eps, qmax=qmax)


#: kernel launches since the last reset (the main-path proof of chip_smoke)
quant_rmsnorm.launches = 0


__all__ = [
    "quant_rmsnorm",
    "quant_rmsnorm_kernel",
    "quant_rmsnorm_plain",
    "quantizer_pair",
]
