"""Fused RMSNorm + asymmetric 8-bit activation quantization (port of
``repro/kernels/quant_rmsnorm.py``, kernel B6).

Every norm output of the W4A8 datapath is quantized to 8-bit codes right
away; fusing the two keeps the f32 intermediate out of device memory and
writes only the 1-byte codes. :func:`quant_rmsnorm` launches the
hand-written CUDA kernel (``csrc/quant_rmsnorm.cu``, replacing the Pallas
``_kernel`` at ``repro/kernels/quant_rmsnorm.py:22``) for CUDA tensors and
runs its plain version :func:`quant_rmsnorm_plain` for CPU tensors.
``quant_rmsnorm.launches`` counts kernel launches.

:func:`rmsnorm_plan` (computed once per width, type and alignment) lays a
row out over the kernel's threads; :func:`quant_rmsnorm_model` is the plain
version with the sum of squares taken in the kernel's order under that
plan, so the kernel is bit-equal to it on the card.

As in the reference, ``inv_scale = 1 / act_scale`` is formed in f32 and the
kernel multiplies by it (``kernels/ref.py``'s ``quant_rmsnorm_ref``
divides instead, so the two may part by one code at a rounding boundary).
A Python number is turned into that f32 value on the host; a 0-d float32
tensor on the card goes to the kernel as a pointer, and the kernel forms
the reciprocal, so a call is one launch either way.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

_IN_DTYPES = (torch.float32, torch.bfloat16)

#: bytes a thread loads at once where rows are 16-byte aligned
VEC_BYTES = 16
#: 16-byte vectors a thread holds in registers (single elements: MAX_SCALARS)
MAX_VECTORS, MAX_SCALARS = 4, 8
#: threads a row at most (one block); blocks have at least MIN_BLOCK threads
MAX_THREADS, MIN_BLOCK = 1024, 256
#: shared memory a block may take on the H100 (opt-in), and what a staged
#: row leaves free for the warp sums
SMEM_BYTES, STAGED_RESERVE = 232448, 256


@dataclass(frozen=True)
class RMSNormPlan:
    """How B6 lays out a row of ``d`` elements (bf16 or f32). Thread t of a
    row's ``threads`` holds vectors t, t + threads, ... (``vec`` elements
    each: 16 bytes, or 1 where rows are not 16-byte aligned) in
    ``per_thread`` slots; a block of ``block`` threads takes ``block //
    threads`` rows at a time. ``staged`` rows are too wide for registers:
    one row a block, its first ``held`` vectors kept in shared memory. A
    function of D, the type and the alignment alone, so a captured launch
    replays unchanged."""

    d: int
    bf16: bool
    vec: int
    threads: int
    per_thread: int
    block: int
    staged: bool
    held: int

    @property
    def rows_per_block(self) -> int:
        return self.block // self.threads

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block (the C launcher's formula)."""
        if self.staged:
            return STAGED_RESERVE + self.held * self.vec * (2 if self.bf16 else 4)
        return 4 * (-(-self.d // 4) * 4) + 4 * 2 * (self.block // 32)


@functools.cache
def rmsnorm_plan(d: int, bf16: bool, aligned: bool = True) -> RMSNormPlan:
    """The plan of a row of ``d`` elements (``aligned``: x is 16-byte
    aligned). Threads a row double from one warp until each holds at most
    MAX_VECTORS vectors (MAX_SCALARS elements); past 1024 threads the row
    is staged through shared memory."""
    es = 2 if bf16 else 4
    vec = VEC_BYTES // es if aligned and (d * es) % VEC_BYTES == 0 else 1
    nvec = d // vec
    cap = MAX_VECTORS if vec > 1 else MAX_SCALARS
    threads = 32
    while threads < MAX_THREADS and -(-nvec // threads) > cap:
        threads *= 2
    need = -(-nvec // threads)
    if need <= cap:  # single elements take a power-of-two number of slots
        per = need if vec > 1 else 1 << (need - 1).bit_length()
        return RMSNormPlan(d, bf16, vec, threads, per, max(MIN_BLOCK, threads), False, 0)
    held = min(nvec, (SMEM_BYTES - STAGED_RESERVE) // (vec * es))
    return RMSNormPlan(d, bf16, vec, MAX_THREADS, need, MAX_THREADS, True, held)


def quantizer_pair(act_scale, act_zp, device) -> torch.Tensor:
    """The (2,) f32 pair {1 / act_scale, act_zp}, each formed in f32."""
    scale = torch.as_tensor(act_scale, dtype=torch.float32, device=device).reshape(())
    zp = torch.as_tensor(act_zp, dtype=torch.float32, device=device).reshape(())
    return torch.stack([torch.reciprocal(scale), zp])


def _quantize(xf, total, gamma, qp, *, eps: float, qmax: float) -> torch.Tensor:
    """Codes from the rows' sums of squares ``total`` (M, 1): the mean in
    f32, times 1/sqrt(ms + eps), times gamma, then the quantizer multiplying
    by ``qp[0]``."""
    d = torch.tensor(float(xf.shape[-1]), device=xf.device)  # a device divisor: true division
    r = torch.reciprocal(torch.sqrt(total / d + eps))
    y = xf * r * gamma
    q = torch.round(y * qp[0]) + qp[1]
    return torch.clamp(q, 0.0, qmax).to(torch.uint8)


def quant_rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, qp: torch.Tensor, *,
                        eps: float, qmax: float) -> torch.Tensor:
    """B6's plain version on the kernel's arguments, in the kernel's order
    of operations (the sum of squares in ``torch.sum``'s order)."""
    xf = x.to(torch.float32)
    return _quantize(xf, torch.sum(xf * xf, dim=-1, keepdim=True), gamma, qp, eps=eps,
                     qmax=qmax)


def sum_squares_in_kernel_order(xf: torch.Tensor, plan: RMSNormPlan) -> torch.Tensor:
    """The rows' sums of squares (M, 1) of f32 ``xf`` in the kernel's order
    under ``plan``: each thread's partial over its vectors in order, a
    shuffle tree over each warp's 32 partials (lane i adds lane i ^ off),
    then the warps in index order. Every add is one f32 tensor add."""
    m, d = xf.shape
    t, v = plan.threads, plan.vec
    slots = -(-(d // v) // t)
    sq = torch.zeros((m, slots * t * v), dtype=torch.float32, device=xf.device)
    sq[:, :d] = xf * xf
    sq = sq.reshape(m, slots, t, v)  # column (k * t + thread) * v + e
    part = torch.zeros((m, t), dtype=torch.float32, device=xf.device)
    for k in range(slots):
        for e in range(v):
            part = part + sq[:, k, :, e]
    lanes = part.reshape(m, t // 32, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
    warps = lanes[..., 0]
    total = warps[:, :1]
    for w in range(1, t // 32):
        total = total + warps[:, w:w + 1]
    return total


def quant_rmsnorm_model(x: torch.Tensor, gamma: torch.Tensor, qp: torch.Tensor,
                        plan: RMSNormPlan, *, eps: float, qmax: float) -> torch.Tensor:
    """The plain version with the sum of squares in the kernel's order under
    ``plan`` (:func:`sum_squares_in_kernel_order`): the kernel's codes bit
    for bit. For tests and ``chip_smoke.py``."""
    xf = x.to(torch.float32)
    return _quantize(xf, sum_squares_in_kernel_order(xf, plan), gamma, qp, eps=eps, qmax=qmax)


def _quantizer_args(act_scale, act_zp, device) -> tuple:
    """(scale pointer, zp pointer, inv_scale, zp, the pointed-to tensors):
    a one-element tensor on ``device`` goes as a float32 pointer (the
    kernel forms 1 / act_scale); anything else is read on the host and
    formed in f32 here."""
    ptrs, vals, keep = [], [], []
    for i, v in enumerate((act_scale, act_zp)):
        if isinstance(v, torch.Tensor) and v.device == device:
            if v.numel() != 1:
                raise ValueError(f"quant_rmsnorm: act_scale/act_zp must be scalars, got "
                                 f"shape {tuple(v.shape)}")
            v = v.reshape(()).to(torch.float32)
            ptrs.append(v.data_ptr())
            vals.append(0.0)
            keep.append(v)
        else:
            f = np.float32(float(v))
            ptrs.append(None)
            vals.append(float(np.float32(1.0) / f) if i == 0 else float(f))
    return ptrs[0], ptrs[1], vals[0], vals[1], keep


def _launch(x, gamma, act_scale, act_zp, out, *, eps: float, qmax: float,
            probe: bool) -> RMSNormPlan:
    if not x.is_cuda:
        raise ValueError(f"quant_rmsnorm_kernel takes CUDA tensors, got {x.device}")
    m, d = x.shape
    for name, t in (("x", x), ("gamma", gamma)):
        if t.device != x.device:
            raise ValueError(f"quant_rmsnorm: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_rmsnorm: {name} must be contiguous")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"quant_rmsnorm: x must be float32 or bfloat16, got {x.dtype}")
    if gamma.dtype != torch.float32:
        raise TypeError("quant_rmsnorm: gamma must be float32")
    if gamma.shape != (d,):
        raise ValueError(f"quant_rmsnorm: gamma {tuple(gamma.shape)} for D={d}")
    bf16 = x.dtype == torch.bfloat16
    plan = rmsnorm_plan(d, bf16, x.data_ptr() % VEC_BYTES == 0)
    if m == 0:
        return plan
    # _alive: the device scalars the kernel reads, held through the launch
    sp, zp_ptr, inv_scale, zp, _alive = _quantizer_args(act_scale, act_zp, x.device)
    err = _library().quant_rmsnorm_launch(
        x.data_ptr(), gamma.data_ptr(), sp, zp_ptr, out.data_ptr(), m, d, int(bf16),
        inv_scale, zp, eps, qmax, plan.vec, plan.threads, plan.per_thread, plan.block,
        int(plan.staged), plan.held, int(probe),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_rmsnorm kernel launch failed: CUDA error {err}")
    return plan


def quant_rmsnorm_kernel(x: torch.Tensor, gamma: torch.Tensor, act_scale, act_zp, *,
                         eps: float, qmax: float) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: x (M, D) f32 or bf16, gamma
    (D,) f32, both contiguous; ``act_scale``/``act_zp`` Python numbers or
    one-element tensors (float32 ones on x's device go to the kernel as
    pointers). One launch a call; raises on what the kernel does not take
    or if the launch returns a CUDA error."""
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    plan = _launch(x, gamma, act_scale, act_zp, out, eps=eps, qmax=qmax, probe=False)
    if x.shape[0]:
        quant_rmsnorm.launches += 1
    quant_rmsnorm.last_plan = plan
    return out


def quant_rmsnorm_floor(x: torch.Tensor, gamma: torch.Tensor) -> None:
    """An empty kernel on the grid, block and shared memory that
    :func:`quant_rmsnorm_kernel` takes for these arguments: the floor of a
    call's time in a timing harness (``chip_smoke.py``). Counts nothing."""
    out = torch.empty((0,), dtype=torch.uint8, device=x.device)
    _launch(x, gamma, 1.0, 0.0, out, eps=0.0, qmax=0.0, probe=True)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library (built with nvcc at first use)."""
    from ._build import load_library

    lib = load_library("quant_rmsnorm")
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.quant_rmsnorm_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
    reference's row block: the kernel lays rows out by its own plan, but M
    must still be a multiple of it, as the reference requires."""
    m, d = x.shape
    if m % block_m:
        raise ValueError(f"quant_rmsnorm: M={m} is not a multiple of block_m={block_m}")
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    qmax = float(2**bits - 1)
    if not x.is_cuda:
        return quant_rmsnorm_plain(x, gamma, quantizer_pair(act_scale, act_zp, x.device),
                                   eps=eps, qmax=qmax)
    return quant_rmsnorm_kernel(x.contiguous(), gamma, act_scale, act_zp, eps=eps, qmax=qmax)


#: kernel launches since the last reset (the main-path proof of chip_smoke)
quant_rmsnorm.launches = 0
#: the plan of the last launch
quant_rmsnorm.last_plan = None


__all__ = [
    "RMSNormPlan",
    "quant_rmsnorm",
    "quant_rmsnorm_floor",
    "quant_rmsnorm_kernel",
    "quant_rmsnorm_model",
    "quant_rmsnorm_plain",
    "quantizer_pair",
    "rmsnorm_plan",
    "sum_squares_in_kernel_order",
]
