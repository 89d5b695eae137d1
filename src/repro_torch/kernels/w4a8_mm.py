"""W4A8 integer GEMM with multi-stage accumulation (port of
``repro/kernels/w4a8_mm.py``): the serving hot spot AXE certifies.

Datapath, as in the reference:

  * weights arrive int4-packed, two codes per int8 byte along K (row 2k is
    the low nibble, sign-extended by an arithmetic shift);
  * activations arrive as 8-bit codes: uint8 from the dynamic per-tensor
    quantizer and from unsigned static quantizers, int8 from signed static
    ones;
  * each certified K tile of T = ``block_k`` gives an int32 partial, the
    inner accumulator that AXE bounds by 2^(P_I-1)-1; the partials sum into
    the int32 outer accumulator (P_O of Eq. 22);
  * the epilogue computes ``(float(acc) - corr[n]) * sw[n]`` with
    ``corr = col_sums * act_zp`` and ``sw = w_scale * act_scale`` formed by
    the wrapper, then casts to ``out_dtype``.

:func:`w4a8_matmul` launches the hand-written CUDA kernel
(``csrc/w4a8_mm.cu``, replacing the Pallas ``_kernel`` at
``repro/kernels/w4a8_mm.py:140``) for CUDA tensors, and runs its plain
version :func:`w4a8_matmul_plain` for CPU tensors or when a caller asks for
the reference. Integer sums are exact, so the kernel tiles K however suits
the card; the ``assert_inner`` debug check still checks every certified
T-wide tile. ``w4a8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_ACT_DTYPES = (torch.uint8, torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) int8 -> (..., K, N) int8 in [-8, 7]; row 2k = low
    nibble. Leading dims pass through."""
    low = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    high = torch.bitwise_right_shift(packed, 4)  # arithmetic: sign-extends
    *lead, k2, n = packed.shape
    return torch.stack([low, high], dim=-2).reshape(*lead, 2 * k2, n)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int codes in [-8, 7] -> (..., K//2, N) int8 packed."""
    q = q.to(torch.int8)
    *lead, k, n = q.shape
    if k % 2:
        raise ValueError(f"K must be even to pack int4, got K={k}")
    pairs = q.reshape(*lead, k // 2, 2, n)
    low = torch.bitwise_and(pairs[..., 0, :], 0x0F)
    high = torch.bitwise_left_shift(torch.bitwise_and(pairs[..., 1, :], 0x0F), 4)
    return torch.bitwise_or(low, high).to(torch.int8)


def exact_int_matmul(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact integer product of integer-valued (M, K) and (K, N) tensors,
    as int32. The CPU has an int32 matmul; CUDA has none, so there the
    product runs in float64, exact for every sum below 2^53."""
    if x.is_cuda:
        return (x.to(torch.float64) @ q.to(torch.float64)).to(torch.int32)
    return x.to(torch.int32) @ q.to(torch.int32)


def datapath_kernel_args(spec) -> dict:
    """Map a :class:`~repro_torch.quant.spec.DatapathSpec` onto the
    wrapper's accumulator knobs: the certified K tile and P_I."""
    return {"block_k": spec.block_k(), "p_inner": spec.p_inner}


def _fit_block(dim: int, pref: int) -> int:
    """Largest block <= pref that divides dim (pref itself when it divides)."""
    if dim % pref == 0:
        return pref
    g = math.gcd(dim, pref)
    return g if g else dim


def check_inner(x: torch.Tensor, w_packed: torch.Tensor, block_k: int,
                p_inner: int) -> int:
    """Debug check of the P_I certificate: every certified K tile's int32
    partial (tile width ``_fit_block(K, block_k)``, as the reference
    wrapper takes it) must satisfy |partial| <= 2^(P_I-1)-1. Returns the
    watermark; raises OverflowError otherwise. Reads one scalar to host."""
    from .ref import w4a8_tile_partials_ref

    bk = _fit_block(x.shape[1], block_k)
    limit = 2 ** (p_inner - 1) - 1
    watermark = int(w4a8_tile_partials_ref(x, w_packed, bk).abs().max())
    if watermark > limit:
        raise OverflowError(
            f"inner accumulator overflow: {watermark} > {limit} "
            f"(P_I={p_inner}, T={bk})")
    return watermark


def w4a8_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, sw: torch.Tensor,
                      corr: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's plain version on the same arguments: exact integer
    accumulation, then the kernel's epilogue in the kernel's order."""
    acc = exact_int_matmul(x, unpack_int4(w_packed)).to(torch.float32)
    return ((acc - corr.reshape(1, -1)) * sw.reshape(1, -1)).to(out_dtype)


def w4a8_matmul_kernel(x: torch.Tensor, w_packed: torch.Tensor, sw: torch.Tensor,
                       corr: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors, with ``sw``/``corr`` already
    formed (the arguments of :func:`w4a8_matmul_plain`). Checks device,
    dtype, shape, contiguity and alignment and raises on what the kernel
    does not take; raises if the launch returns a CUDA error."""
    m, k = x.shape
    n = w_packed.shape[1]
    if not x.is_cuda:
        raise ValueError(f"w4a8_matmul_kernel takes CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("w_packed", w_packed), ("sw", sw), ("corr", corr)):
        if t.device != x.device:
            raise ValueError(f"w4a8_matmul: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"w4a8_matmul: {name} must be contiguous")
    if x.dtype not in _ACT_DTYPES or w_packed.dtype != torch.int8:
        raise TypeError(f"w4a8_matmul: codes {x.dtype} / weights {w_packed.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"w4a8_matmul: out_dtype {out_dtype}")
    if sw.dtype != torch.float32 or corr.dtype != torch.float32:
        raise TypeError("w4a8_matmul: sw and corr must be float32")
    if w_packed.shape[0] * 2 != k:
        raise ValueError(f"x {tuple(x.shape)} does not match w_packed {tuple(w_packed.shape)}")
    if sw.numel() != n or corr.numel() != n:
        raise ValueError(f"w4a8_matmul: sw/corr need {n} entries")
    if k % 4 or n % 4:
        raise ValueError(
            f"w4a8_matmul kernel takes K and N multiples of 4, got K={k} N={n}")
    if x.data_ptr() % 4 or w_packed.data_ptr() % 4:
        raise ValueError("w4a8_matmul kernel needs 4-byte aligned x and w_packed")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    err = _library().w4a8_matmul_launch(
        x.data_ptr(), w_packed.data_ptr(), sw.data_ptr(), corr.data_ptr(),
        out.data_ptr(), m, n, k, int(x.dtype == torch.int8),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"w4a8_matmul kernel launch failed: CUDA error {err}")
    w4a8_matmul.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library (built with nvcc at first use)."""
    from ._build import load_library

    lib = load_library("w4a8_mm")
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.w4a8_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.w4a8_matmul_launch.restype = ctypes.c_int
    return lib


def w4a8_matmul(
    x: torch.Tensor,  # (M, K) uint8 or int8 activation codes
    w_packed: torch.Tensor,  # (K//2, N) int8 packed int4 weights
    w_scale: torch.Tensor,  # (N,) per-channel weight scales
    act_scale,
    act_zp,
    *,
    block_k: int = 128,  # the certified tile T (assert_inner only)
    p_inner: int = 16,
    assert_inner: bool = False,
    out_dtype=torch.float32,
    col_sums: torch.Tensor | None = None,  # (N,) or (1, N) int32, pack-time
    reference: bool = False,
) -> torch.Tensor:
    """W4A8 GEMM: the CUDA kernel for CUDA tensors, its plain version for
    CPU tensors or when ``reference`` is set. Raises on what the kernel
    does not take; never falls back."""
    m, k = x.shape
    k2, n = w_packed.shape
    if k != 2 * k2:
        raise ValueError(f"x {tuple(x.shape)} does not match w_packed {tuple(w_packed.shape)}")
    if x.dtype not in _ACT_DTYPES:
        raise TypeError(f"activation codes must be uint8 or int8, got {x.dtype}")
    if w_packed.dtype != torch.int8:
        raise TypeError(f"w_packed must be int8, got {w_packed.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if _fit_block(k, block_k) % 2:
        raise ValueError(f"K tile {_fit_block(k, block_k)} must be even (K={k})")
    if col_sums is None:
        col_sums = unpack_int4(w_packed).to(torch.int32).sum(dim=0)
    corr = col_sums.reshape(-1).to(torch.float32) * act_zp
    sw = w_scale.reshape(-1).to(torch.float32) * act_scale
    if assert_inner:
        check_inner(x, w_packed, block_k, p_inner)
    if reference or not x.is_cuda:
        return w4a8_matmul_plain(x, w_packed, sw, corr, out_dtype)
    return w4a8_matmul_kernel(x, w_packed, sw.contiguous(), corr.contiguous(), out_dtype)


#: kernel launches since the last reset (the main-path proof of chip_smoke)
w4a8_matmul.launches = 0


def w4a8_decode_matmul(x, w_packed, w_scale, col_sums, act_scale, act_zp, **kw):
    """Decode-shaped entry (M = batch): ``col_sums`` is required, so no
    full-weight unpack runs on the serving path. The CUDA kernel takes
    every M through one code path (rows beyond M are masked in-kernel)."""
    if col_sums is None:
        raise ValueError("w4a8_decode_matmul needs the pack-time col_sums")
    return w4a8_matmul(x, w_packed, w_scale, act_scale, act_zp,
                       col_sums=col_sums, **kw)


__all__ = [
    "check_inner",
    "datapath_kernel_args",
    "exact_int_matmul",
    "pack_int4",
    "unpack_int4",
    "w4a8_decode_matmul",
    "w4a8_matmul",
    "w4a8_matmul_kernel",
    "w4a8_matmul_plain",
]
