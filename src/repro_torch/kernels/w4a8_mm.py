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
the reference. The kernel runs on the int8 tensor cores at every M;
:func:`w4a8_plan` (computed once per shape) splits K over up to 8 blocks
a tile where the tiles alone would leave SMs idle, and those blocks form
one thread block cluster that sums their tiles through distributed shared
memory: one launch a call, and nothing from the host but the shape's
plan, so a launch replays in a CUDA graph. Integer sums are exact, so the
kernel tiles and splits K however suits the card; the ``assert_inner``
debug check still checks every certified T-wide tile.
``w4a8_matmul.launches`` counts kernel launches.

The 2:4 sparse GEMM :func:`w4a8_sparse_matmul` (kernel B4, replacing the
Pallas ``_sparse_kernel`` at ``repro/kernels/w4a8_mm.py:311``) takes the
weights as :func:`compress_2to4` stores them and runs B1's datapath on
them: the same kernel source with a loader that expands each group of 4 K
rows in registers (``w4a8_sparse_matmul.launches`` counts it apart), and
the plain version :func:`w4a8_sparse_matmul_plain`. Both are bit-equal to
B1 on the dense-with-zeros codes.

:func:`w4a8_expert_matmul` (B1e) and :func:`w4a8_sparse_expert_matmul`
(B4e) are B1 and B4 over an expert axis, the counterpart of the batched
``pallas_call`` that ``jax.vmap(packed_linear)`` makes of the same two
Pallas kernels at ``repro/models/moe.py:122``: (E, M, K) codes against
(E, K/2, N) stacks, each expert with its own scales and activation
quantizer, in one launch, each with a launch counter of its own and a
plain version of E calls of B1's or B4's. :func:`w4a8_expert_plan` picks
the tier (:func:`expert_tier`): the decode tier (the product transposed,
the tokens on the mma's n8 side, 128 columns of an expert a block) at
the few rows an expert of decode and small admits, else the tile tier
(B1/B4's kernel, its grid rows walking E problems).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

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


def compress_2to4(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) 2:4-sparse int codes -> (packed (..., K//4, N) int8,
    meta (..., K//4, N) int8). Per group of 4 K rows and column the (<= 2)
    kept codes go into one packed byte (low nibble = first) and their
    in-group positions into one meta byte (bits 0-1 / 2-3). Nonzero slots
    come first in in-group order (stable), as in the reference, so a group
    with fewer than 2 nonzeros pads with zero codes at the first zero slots.
    The 2:4 property itself is checked by ``certify``, not here."""
    q = q.to(torch.int8)
    *lead, k, n = q.shape
    if k % 4:
        raise ValueError(f"2:4 compression needs K % 4 == 0, got K={k}")
    g = q.reshape(*lead, k // 4, 4, n)
    order = torch.argsort((g == 0).to(torch.uint8), dim=-2, stable=True)
    idx = order[..., :2, :]  # (..., k//4, 2, n) positions of the kept codes
    vals = torch.gather(g, -2, idx)
    meta = torch.bitwise_or(idx[..., 0, :], torch.bitwise_left_shift(idx[..., 1, :], 2))
    return pack_int4(vals.reshape(*lead, k // 2, n)), meta.to(torch.int8)


def unpack_sparse24(packed: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """(..., K//4, N) packed + meta -> (..., K, N) int8 dense-with-zeros
    codes. The two position terms add, as in the reference, so a meta with
    equal positions sums its codes. Leading dims pass through."""
    vals = unpack_int4(packed)  # (..., K//2, N)
    *lead, k2, n = vals.shape
    v = vals.reshape(*lead, k2 // 2, 2, n)
    m = meta.to(torch.int32)
    i0 = torch.bitwise_and(m, 3).unsqueeze(-2)  # (..., g4, 1, n)
    i1 = torch.bitwise_and(torch.bitwise_right_shift(m, 2), 3).unsqueeze(-2)
    pos = torch.arange(4, dtype=torch.int32, device=packed.device).reshape(4, 1)
    zero = torch.zeros((), dtype=torch.int8, device=packed.device)
    dense = (torch.where(pos == i0, v[..., 0:1, :], zero)
             + torch.where(pos == i1, v[..., 1:2, :], zero))
    return dense.reshape(*lead, 2 * k2, n)


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
                p_inner: int, meta: torch.Tensor | None = None) -> int:
    """Debug check of the P_I certificate: every certified K tile's int32
    partial (tile width ``_fit_block(K, block_k)``, as the reference
    wrapper takes it) must satisfy |partial| <= 2^(P_I-1)-1; with ``meta``
    the weights are 2:4-compressed and the tiles are those of the expanded
    codes. Returns the watermark; raises OverflowError otherwise. Reads one
    scalar to host, so a captured CUDA graph cannot hold it: under capture
    it raises instead."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("assert_inner reads a scalar to the host and cannot run in a "
                           "captured CUDA graph: serve without it, or check the site eagerly")
    from .ref import tile_partials

    bk = _fit_block(x.shape[1], block_k)
    limit = 2 ** (p_inner - 1) - 1
    q = unpack_int4(w_packed) if meta is None else unpack_sparse24(w_packed, meta)
    watermark = int(tile_partials(x, q, bk).abs().max())
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


def w4a8_sparse_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, w_meta: torch.Tensor,
                             sw: torch.Tensor, corr: torch.Tensor,
                             out_dtype=torch.float32) -> torch.Tensor:
    """B4's plain version: expand with :func:`unpack_sparse24`, then B1's
    exact integer product and epilogue."""
    acc = exact_int_matmul(x, unpack_sparse24(w_packed, w_meta)).to(torch.float32)
    return ((acc - corr.reshape(1, -1)) * sw.reshape(1, -1)).to(out_dtype)


#: 64 x 64 output tiles, 128 threads, 128 K rows a pipeline stage; a K
#: chunk keeps at least MIN_STEPS stages where the call has more than one
#: row tile (one stage where it has one: the split's sum then moves only
#: the few live rows), the split aims at BLOCKS_PER_SM blocks an SM, and a
#: split's chunks of a tile are one thread block cluster: at most
#: MAX_CHUNKS
TILE_M, TILE_N, STAGE_K = 64, 64, 128
MIN_STEPS, BLOCKS_PER_SM, MAX_CHUNKS = 2, 2, 8
#: the H100's SM count, for plans made without a card
H100_SMS = 132


#: the expert axis's decode tier (B1e, B4e): 128 output columns of one
#: expert a block, its K chunk streamed through a ring of up to
#: DECODE_RING stages of DECODE_STAGE_K rows (the kernel's kDecMaxRing:
#: its shared-memory attribute is sized for it); K is split over a cluster of
#: up to MAX_CHUNKS blocks where the experts' column tiles give fewer than
#: DECODE_BLOCKS_PER_SM blocks an SM. It takes up to DECODE_MAX_M rows an
#: expert: up to DECODE_NARROW_M in its narrow width (two token tiles of
#: 8), above it in the wide one (ten). The tiers' times at granite's sites
#: (scripts/torch_expert_tiers.py) set where each runs: the decode tier up
#: to DECODE_M rows; from there to TILE_M (one row tile) the tile tier
#: while its tiles fit one wave of TILE_BLOCKS_PER_SM blocks an SM (its
#: shared memory allows three), else the decode tier; the decode tier
#: again up to DECODE_MAX_M (where the tile tier takes a second row tile),
#: the tile tier above
DECODE_M, DECODE_MAX_M, DECODE_NARROW_M, TILE_BLOCKS_PER_SM = 48, 80, 16, 3
DECODE_COLS, DECODE_STAGE_K, DECODE_RING, DECODE_BLOCKS_PER_SM = 128, 128, 2, 3
#: the H100's shared memory a block may use (bytes)
SMEM_LIMIT = 232_448


@dataclass(frozen=True)
class W4A8Plan:
    """How one call of B1/B4 (or B1e/B4e) runs: its load width in bytes (16
    where the layout allows, else 4, and 1 for a ragged N, N % 4 != 0,
    whose weight rows start at any byte: the kernel then loads its panel
    byte by byte and stores each output on its own), K rows a chunk and
    the grid. The
    ``tile`` tier's grid is (64-column tiles, row tiles, K chunks); the
    expert axis's ``decode`` tier's is (128-column tiles, experts, K
    chunks), each block keeping ``ring`` stages in flight. A function of the
    shape alone, so a captured launch replays unchanged."""

    vec: int
    ck: int
    grid: tuple[int, int, int]
    tier: str = "tile"
    ring: int = 0

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _load_width(n: int, k: int, aligned: bool) -> int:
    """The kernel's load width: 16 bytes where N and K are multiples of 16
    and the operands 16-byte aligned, 4 where N % 4 == 0, else 1 (ragged)."""
    if n % 4:
        return 1
    return 16 if aligned and n % 16 == 0 and k % 16 == 0 else 4


@functools.cache
def w4a8_plan(m: int, n: int, k: int, aligned: bool = True, n_sm: int = H100_SMS,
              experts: int = 1) -> W4A8Plan:
    """The plan of one (M, N, K) call, computed once per shape; ``aligned``
    says x, w (and meta) are 16-byte aligned. K is split until about
    BLOCKS_PER_SM blocks an SM, while a chunk keeps its least number of
    stages (one at decode, where M fits one row tile; else MIN_STEPS).
    ``experts`` > 1 plans the expert-axis kernel: E problems of (M, N, K),
    expert e's row tiles at grid rows [e * row_tiles, (e + 1) * row_tiles),
    and the split counts the tiles of all E."""
    vec = _load_width(n, k, aligned)
    row_tiles = -(-m // TILE_M)
    tiles = experts * row_tiles * -(-n // TILE_N)
    steps = -(-k // STAGE_K)
    min_steps = 1 if m <= TILE_M else MIN_STEPS
    split = max(1, min(-(-BLOCKS_PER_SM * n_sm // tiles), steps // min_steps, MAX_CHUNKS))
    ck = STAGE_K * -(-steps // split)
    return W4A8Plan(vec, ck, (-(-n // TILE_N), experts * row_tiles, max(1, -(-k // ck))))


def decode_smem_bytes(m: int, ring: int, chunks: int) -> int:
    """Dynamic shared memory of one decode-tier block (``dec_smem_bytes``
    in the kernel): the ring of stages (8192 bytes of weights and 16 or 80
    rows of codes at a 144-byte pitch) and a K split's receive buffer of
    the chunks' vectors (past the ring in the narrow width, in its place
    in the wide one), then the 128 columns' sw and corr."""
    narrow = m <= DECODE_NARROW_M
    stage = DECODE_STAGE_K // 2 * DECODE_COLS + (16 if narrow else 80) * (DECODE_STAGE_K + 16)
    rx = chunks * -(-m * DECODE_COLS // 4 // chunks) * 16 if chunks > 1 else 0
    rings = ring * stage
    return (rings + rx if narrow else max(rings, rx)) + 2 * DECODE_COLS * 4


def expert_tier(m: int, n: int, experts: int, n_sm: int = H100_SMS) -> str:
    """The tier of a B1e/B4e call of E problems with ``m`` rows an expert
    and ``n`` columns: ``decode`` up to DECODE_M rows and from TILE_M + 1
    to DECODE_MAX_M; in between (one row tile) ``tile`` while its E x
    column tiles fit one wave, else ``decode``; ``tile`` above. A ragged
    N (N % 4 != 0) takes the tile tier, whose kernel has the byte loader."""
    if m > DECODE_MAX_M or n % 4:
        return "tile"
    if m <= DECODE_M or m > TILE_M:
        return "decode"
    fits = experts * -(-n // TILE_N) <= TILE_BLOCKS_PER_SM * n_sm
    return "tile" if fits else "decode"


@functools.cache
def w4a8_expert_plan(m: int, n: int, k: int, experts: int, aligned: bool = True,
                     n_sm: int = H100_SMS) -> W4A8Plan:
    """The plan of one B1e/B4e call: E problems of (M, N, K). In the
    decode tier (:func:`expert_tier`): one block per 128 columns of an
    expert, K split over a cluster until DECODE_BLOCKS_PER_SM blocks an
    SM (chunks of whole 128-row stages, at most MAX_CHUNKS), a ring as deep
    as the chunk up to DECODE_RING stages. In the tile tier:
    :func:`w4a8_plan` over the experts' row tiles."""
    if expert_tier(m, n, experts, n_sm) == "tile":
        return w4a8_plan(m, n, k, aligned, n_sm, experts)
    vec = _load_width(n, k, aligned)
    cols = -(-n // DECODE_COLS)
    steps = -(-k // DECODE_STAGE_K)
    split = max(1, min(-(-DECODE_BLOCKS_PER_SM * n_sm // (experts * cols)), steps, MAX_CHUNKS))
    stages = max(1, -(-steps // split))
    ring = min(DECODE_RING, stages)
    ck = DECODE_STAGE_K * stages
    return W4A8Plan(vec, ck, (cols, experts, max(1, -(-k // ck))), tier="decode", ring=ring)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(name: str, x, weights, sw, corr, out_dtype, rows_per_k: int):
    """Check and launch the B1 (``weights`` = (w_packed,)) or B4 (``(packed,
    meta)``) entry point on CUDA tensors with the shape's plan; raise on
    what the kernel does not take or on a CUDA error from the launch.
    Returns the output and the plan it launched with (None if empty).
    An expert-axis entry (B1e, B4e) takes ``x`` (E, M, K), weights (E, ...,
    N) and ``sw``/``corr`` (E, N), and launches once for all E."""
    experts = x.shape[0] if x.dim() == 3 else 1
    lead = (experts,) if x.dim() == 3 else ()
    m, k = x.shape[-2:]
    n = weights[0].shape[-1]
    if not x.is_cuda:
        raise ValueError(f"{name}_kernel takes CUDA tensors, got {x.device}")
    named = (("x", x), ("sw", sw), ("corr", corr)) + tuple(
        zip(("w_packed", "w_meta"), weights))
    for what, t in named:
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.dtype not in _ACT_DTYPES or any(w.dtype != torch.int8 for w in weights):
        raise TypeError(f"{name}: codes {x.dtype} / weights {[w.dtype for w in weights]}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype}")
    if sw.dtype != torch.float32 or corr.dtype != torch.float32:
        raise TypeError(f"{name}: sw and corr must be float32")
    if any(w.shape != (*lead, k // rows_per_k, n) for w in weights) or k % rows_per_k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match weights "
                         f"{[tuple(w.shape) for w in weights]}")
    if sw.numel() != experts * n or corr.numel() != experts * n:
        raise ValueError(f"{name}: sw/corr need {experts * n} entries")
    if k % 4:
        raise ValueError(f"{name} kernel takes K a multiple of 4, got K={k}")
    if x.data_ptr() % 4 or (n % 4 == 0 and any(w.data_ptr() % 4 for w in weights)):
        raise ValueError(f"{name} kernel needs 4-byte aligned codes (and weights where "
                         f"N % 4 == 0)")
    out = torch.empty((*lead, m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0 or experts == 0:
        return out, None
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *weights))
    n_sm = _sm_count(x.device.index)
    plan = (w4a8_expert_plan(m, n, k, experts, aligned, n_sm) if lead
            else w4a8_plan(m, n, k, aligned, n_sm))
    flags = (int(x.dtype == torch.int8), int(out_dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.tier == "decode":
        err = _library().w4a8_expert_decode_launch(
            x.data_ptr(), weights[0].data_ptr(),
            weights[1].data_ptr() if len(weights) > 1 else None, sw.data_ptr(),
            corr.data_ptr(), out.data_ptr(), experts, m, n, k, *flags, plan.vec, plan.ck,
            plan.ring, *plan.grid, stream)
    else:
        err = getattr(_library(), f"{name}_launch")(
            x.data_ptr(), *(w.data_ptr() for w in weights), sw.data_ptr(), corr.data_ptr(),
            out.data_ptr(), *lead, m, n, k, *flags, plan.vec, plan.ck, *plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out, plan


def w4a8_matmul_kernel(x: torch.Tensor, w_packed: torch.Tensor, sw: torch.Tensor,
                       corr: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors, with ``sw``/``corr`` already
    formed (the arguments of :func:`w4a8_matmul_plain`). Checks device,
    dtype, shape, contiguity and alignment and raises on what the kernel
    does not take; raises if the launch returns a CUDA error."""
    out, w4a8_matmul.last_plan = _launch("w4a8_matmul", x, (w_packed,), sw, corr, out_dtype,
                                         rows_per_k=2)
    w4a8_matmul.launches += 1
    return out


def w4a8_sparse_matmul_kernel(x: torch.Tensor, w_packed: torch.Tensor, w_meta: torch.Tensor,
                              sw: torch.Tensor, corr: torch.Tensor,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Launch kernel B4 on CUDA tensors (the arguments of
    :func:`w4a8_sparse_matmul_plain`), with the checks of B1's launcher."""
    out, w4a8_sparse_matmul.last_plan = _launch("w4a8_sparse_matmul", x, (w_packed, w_meta),
                                                sw, corr, out_dtype, rows_per_k=4)
    w4a8_sparse_matmul.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library (built with nvcc at first use)."""
    from ._build import load_library

    lib = load_library("w4a8_mm")
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.w4a8_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.w4a8_matmul_launch.restype = ctypes.c_int
    lib.w4a8_sparse_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.w4a8_sparse_matmul_launch.restype = ctypes.c_int
    lib.w4a8_expert_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.w4a8_expert_matmul_launch.restype = ctypes.c_int
    lib.w4a8_sparse_expert_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.w4a8_sparse_expert_matmul_launch.restype = ctypes.c_int
    lib.w4a8_expert_decode_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.w4a8_expert_decode_launch.restype = ctypes.c_int
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


#: kernel launches since the last reset (the main-path proof of chip_smoke),
#: and the plan of the last launch
w4a8_matmul.launches = 0
w4a8_matmul.last_plan = None


def w4a8_decode_matmul(x, w_packed, w_scale, col_sums, act_scale, act_zp, **kw):
    """Decode-shaped entry (M = batch): ``col_sums`` is required, so no
    full-weight unpack runs on the serving path. The CUDA kernel takes any
    M; :func:`w4a8_plan` splits K for small ones."""
    if col_sums is None:
        raise ValueError("w4a8_decode_matmul needs the pack-time col_sums")
    return w4a8_matmul(x, w_packed, w_scale, act_scale, act_zp,
                       col_sums=col_sums, **kw)


def w4a8_sparse_matmul(
    x: torch.Tensor,  # (M, K) uint8 or int8 activation codes
    w_packed: torch.Tensor,  # (K//4, N) int8 packed 2:4 codes (2 nibbles per group)
    w_meta: torch.Tensor,  # (K//4, N) int8 in-group positions
    w_scale: torch.Tensor,  # (N,) per-channel weight scales
    act_scale,
    act_zp,
    *,
    col_sums: torch.Tensor,  # (N,) or (1, N) int32, pack-time: required
    block_k: int = 128,
    p_inner: int = 16,
    assert_inner: bool = False,
    out_dtype=torch.float32,
    reference: bool = False,
) -> torch.Tensor:
    """W4A8 GEMM over 2:4-compressed weights, bit-identical to
    :func:`w4a8_matmul` on the dense-with-zeros codes: kernel B4 for CUDA
    tensors, its plain version for CPU tensors or when ``reference`` is
    set. ``corr``/``sw`` are formed as for B1. Never falls back."""
    m, k = x.shape
    k4, n = w_packed.shape
    if k != 4 * k4 or w_meta.shape != w_packed.shape:
        raise ValueError(f"x {tuple(x.shape)} does not match w_packed {tuple(w_packed.shape)} "
                         f"/ w_meta {tuple(w_meta.shape)}")
    if x.dtype not in _ACT_DTYPES:
        raise TypeError(f"activation codes must be uint8 or int8, got {x.dtype}")
    if w_packed.dtype != torch.int8 or w_meta.dtype != torch.int8:
        raise TypeError(f"w_packed and w_meta must be int8, got {w_packed.dtype}, "
                        f"{w_meta.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if _fit_block(k, block_k) % 4:
        raise ValueError(f"K tile {_fit_block(k, block_k)} must be a multiple of 4 for "
                         f"2:4 codes (K={k})")
    if col_sums is None:
        raise ValueError("w4a8_sparse_matmul needs the pack-time col_sums")
    corr = col_sums.reshape(-1).to(torch.float32) * act_zp
    sw = w_scale.reshape(-1).to(torch.float32) * act_scale
    if assert_inner:
        check_inner(x, w_packed, block_k, p_inner, meta=w_meta)
    if reference or not x.is_cuda:
        return w4a8_sparse_matmul_plain(x, w_packed, w_meta, sw, corr, out_dtype)
    return w4a8_sparse_matmul_kernel(x, w_packed, w_meta, sw.contiguous(), corr.contiguous(),
                                     out_dtype)


#: kernel B4 launches since the last reset, and the plan of the last launch
w4a8_sparse_matmul.launches = 0
w4a8_sparse_matmul.last_plan = None


def w4a8_sparse_decode_matmul(x, w_packed, w_meta, w_scale, col_sums, act_scale, act_zp, **kw):
    """Decode-shaped entry of the 2:4 GEMM (the sparse counterpart of
    :func:`w4a8_decode_matmul`)."""
    return w4a8_sparse_matmul(x, w_packed, w_meta, w_scale, act_scale, act_zp,
                              col_sums=col_sums, **kw)


# ---------------------------------------------------------------------------
# The expert axis (B1e, B4e)
# ---------------------------------------------------------------------------
def _expert_epilogue(w_scale, col_sums, act_scale, act_zp, experts: int, n: int):
    """Each expert's ``sw`` and ``corr`` rows, (E, N) f32, formed as B1's
    wrapper forms them from that expert's scales and zero point."""
    sw = w_scale.reshape(experts, n).to(torch.float32) * act_scale.reshape(experts, 1)
    corr = col_sums.reshape(experts, n).to(torch.float32) * act_zp.reshape(experts, 1)
    return sw, corr


def w4a8_expert_matmul_plain(x, w_packed, sw, corr, out_dtype=torch.float32):
    """B1e's plain version: E calls of :func:`w4a8_matmul_plain`, one an
    expert, on the expert's slices and its ``sw``/``corr`` rows."""
    return torch.stack([w4a8_matmul_plain(x[e], w_packed[e], sw[e], corr[e], out_dtype)
                        for e in range(x.shape[0])])


def w4a8_sparse_expert_matmul_plain(x, w_packed, w_meta, sw, corr, out_dtype=torch.float32):
    """B4e's plain version: E calls of :func:`w4a8_sparse_matmul_plain`."""
    return torch.stack([
        w4a8_sparse_matmul_plain(x[e], w_packed[e], w_meta[e], sw[e], corr[e], out_dtype)
        for e in range(x.shape[0])])


def _check_expert_args(name, x, weights, act_scale, act_zp, out_dtype, rows_per_k):
    if x.dim() != 3 or any(w.dim() != 3 for w in weights):
        raise ValueError(f"{name}: x (E, M, K) and weights (E, K/{rows_per_k}, N), got "
                         f"{tuple(x.shape)} / {[tuple(w.shape) for w in weights]}")
    e, _, k = x.shape
    if any(w.shape[:2] != (e, k // rows_per_k) for w in weights) or k % rows_per_k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match weights "
                         f"{[tuple(w.shape) for w in weights]}")
    if act_scale.numel() != e or act_zp.numel() != e:
        raise ValueError(f"{name}: act_scale/act_zp need one entry an expert ({e})")
    if x.dtype not in _ACT_DTYPES:
        raise TypeError(f"activation codes must be uint8 or int8, got {x.dtype}")
    if any(w.dtype != torch.int8 for w in weights):
        raise TypeError(f"{name}: weights must be int8, got {[w.dtype for w in weights]}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")


def w4a8_expert_matmul(
    x: torch.Tensor,  # (E, M, K) uint8 or int8 activation codes, one slice an expert
    w_packed: torch.Tensor,  # (E, K//2, N) int8 packed int4 weights
    w_scale: torch.Tensor,  # (E, N) (or (E, 1, N)) per-channel weight scales
    col_sums: torch.Tensor,  # (E, N) (or (E, 1, N)) int32, pack-time
    act_scale: torch.Tensor,  # (E,) one activation quantizer an expert
    act_zp: torch.Tensor,  # (E,)
    *,
    block_k: int = 128,
    p_inner: int = 16,
    assert_inner: bool = False,
    out_dtype=torch.float32,
    reference: bool = False,
) -> torch.Tensor:
    """B1 over an expert axis (B1e): per expert e, ``(acc_e - zp_e *
    col_sums_e) * w_scale_e * act_scale_e``, bit-equal to E calls of
    :func:`w4a8_decode_matmul` on the slices. CUDA tensors launch the
    kernel once for all E (``w4a8_expert_matmul.launches`` counts it, apart
    from B1's count); CPU tensors, or ``reference``, take the plain
    version. Never falls back. Returns (E, M, N).

    With ``w_scale`` ones, ``act_scale`` ones(E), ``act_zp`` zeros(E) and
    f32 out, the epilogue gives each expert's integer accumulator alone,
    exactly (below 2^24): a K-sharded stacked site's shard runs so."""
    _check_expert_args("w4a8_expert_matmul", x, (w_packed,), act_scale, act_zp, out_dtype, 2)
    e, _, k = x.shape
    n = w_packed.shape[-1]
    if _fit_block(k, block_k) % 2:
        raise ValueError(f"K tile {_fit_block(k, block_k)} must be even (K={k})")
    sw, corr = _expert_epilogue(w_scale, col_sums, act_scale, act_zp, e, n)
    if assert_inner:
        for i in range(e):
            check_inner(x[i], w_packed[i], block_k, p_inner)
    if reference or not x.is_cuda:
        return w4a8_expert_matmul_plain(x, w_packed, sw, corr, out_dtype)
    out, w4a8_expert_matmul.last_plan = _launch(
        "w4a8_expert_matmul", x, (w_packed,), sw.contiguous(), corr.contiguous(), out_dtype,
        rows_per_k=2)
    w4a8_expert_matmul.launches += 1
    return out


#: B1e launches since the last reset, and the plan of the last launch
w4a8_expert_matmul.launches = 0
w4a8_expert_matmul.last_plan = None


def w4a8_sparse_expert_matmul(
    x: torch.Tensor,  # (E, M, K) activation codes
    w_packed: torch.Tensor,  # (E, K//4, N) int8 packed 2:4 codes
    w_meta: torch.Tensor,  # (E, K//4, N) int8 in-group positions
    w_scale: torch.Tensor,
    col_sums: torch.Tensor,
    act_scale: torch.Tensor,
    act_zp: torch.Tensor,
    *,
    block_k: int = 128,
    p_inner: int = 16,
    assert_inner: bool = False,
    out_dtype=torch.float32,
    reference: bool = False,
) -> torch.Tensor:
    """B4 over an expert axis (B4e): :func:`w4a8_expert_matmul` on
    2:4-compressed stacks, bit-equal to E calls of
    :func:`w4a8_sparse_decode_matmul`; one launch for all E
    (``w4a8_sparse_expert_matmul.launches``)."""
    _check_expert_args("w4a8_sparse_expert_matmul", x, (w_packed, w_meta), act_scale, act_zp,
                       out_dtype, 4)
    e, _, k = x.shape
    n = w_packed.shape[-1]
    if _fit_block(k, block_k) % 4:
        raise ValueError(f"K tile {_fit_block(k, block_k)} must be a multiple of 4 for "
                         f"2:4 codes (K={k})")
    sw, corr = _expert_epilogue(w_scale, col_sums, act_scale, act_zp, e, n)
    if assert_inner:
        for i in range(e):
            check_inner(x[i], w_packed[i], block_k, p_inner, meta=w_meta[i])
    if reference or not x.is_cuda:
        return w4a8_sparse_expert_matmul_plain(x, w_packed, w_meta, sw, corr, out_dtype)
    out, w4a8_sparse_expert_matmul.last_plan = _launch(
        "w4a8_sparse_expert_matmul", x, (w_packed, w_meta), sw.contiguous(), corr.contiguous(),
        out_dtype, rows_per_k=4)
    w4a8_sparse_expert_matmul.launches += 1
    return out


#: B4e launches since the last reset, and the plan of the last launch
w4a8_sparse_expert_matmul.launches = 0
w4a8_sparse_expert_matmul.last_plan = None


__all__ = [
    "check_inner",
    "compress_2to4",
    "datapath_kernel_args",
    "exact_int_matmul",
    "pack_int4",
    "unpack_int4",
    "unpack_sparse24",
    "w4a8_decode_matmul",
    "w4a8_expert_matmul",
    "w4a8_expert_matmul_plain",
    "expert_tier",
    "w4a8_expert_plan",
    "w4a8_matmul",
    "w4a8_matmul_kernel",
    "w4a8_matmul_plain",
    "w4a8_sparse_decode_matmul",
    "w4a8_sparse_expert_matmul",
    "w4a8_sparse_expert_matmul_plain",
    "w4a8_sparse_matmul",
    "w4a8_sparse_matmul_kernel",
    "w4a8_sparse_matmul_plain",
]
