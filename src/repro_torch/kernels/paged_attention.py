"""Block-table decode attention over a paged KV cache (port of
``repro/kernels/paged_attention.py``).

The serving engine stores KV state in pages of ``block_size`` tokens drawn
from one pool per layer; a per-sequence block table maps logical position
``p`` to physical page ``table[b, p // block_size]``. Entries ``>= nb`` are
free-slot sentinels, clamped on reads (and masked anyway).

* :func:`paged_attention_reference`: gather the sequence's pages into a
  dense view and run the dense decode-attention math in the inputs' dtype
  (the oracle; int8 pools dequantize per page and run the same float math).
* :func:`paged_attention_plain`: the plain version of kernel B2, the same
  gather math in f32 (the kernel's working precision), cast to q's dtype.
* :func:`paged_attention_int8_plain`: the plain version of kernel B3, the
  reference's ``_quant_kernel`` body page by page: per-head q codes, integer
  QK^T and PV dots, probability codes and the f32 online-softmax drain.
* :func:`paged_decode_attention`: the entry point. CUDA tensors launch the
  hand-written kernels of ``csrc/paged_attention.cu`` (B2 for float pages,
  B3 for int8 pages with scales); CPU tensors take the plain versions. It
  checks ``attn_spec`` against the pool as the reference does.

``paged_decode_attention.launches`` and ``.int8_launches`` count calls of
B2 and B3 (one CUDA launch each; each call splits its rows' pages over
blocks, ``split_plan``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.quant.spec import AttnDatapathSpec, validate_attn_datapath

_FLOAT_DTYPES = (torch.bfloat16, torch.float32)
#: query heads per kv head the kernels take (registers per thread)
MAX_GROUP = 16
#: shared memory one Hopper block may opt into (bytes)
SMEM_LIMIT = 232_448
#: width of the band around a rounding boundary that counts as a near-tie
TIE_EPS = 1e-3
#: blocks per SM the kernels' split plan fills (B2's block at smollm-360m's
#: shapes holds 75 KB of shared memory: three fit on an H100 SM)
BLOCKS_PER_SM = 3


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device: CUDA turns division by
    a host scalar into a multiply by its reciprocal, which the kernels and
    the reference do not. The divisor is filled in on the device (no
    host-to-device copy, so a CUDA graph may capture the division)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(_div(scores, cap))


# ---------------------------------------------------------------------------
# int8 KV page quantization (per-page, per-kv-head symmetric scales)
# ---------------------------------------------------------------------------
def quantize_kv_pages(pages: torch.Tensor, kv_bits: int = 8):
    """(..., block_size, nkv, hd) float -> (codes int8, scales (..., nkv)
    f32): one symmetric scale per page and kv head, shared by every position
    and head-dim lane of the page."""
    qmax = 2 ** (kv_bits - 1) - 1
    xf = pages.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=(-3, -1))
    scales = torch.clamp(_div(amax, qmax), min=1e-8)
    codes = torch.clamp(torch.round(xf / scales[..., None, :, None]), -qmax, qmax)
    return codes.to(torch.int8), scales


def quantize_kv_pages_static(pages: torch.Tensor, scales: torch.Tensor):
    """Quantize float KV pages under calibrated static per-kv-head scales
    (``scales`` broadcastable to the pages' (..., nkv) page-scale shape; see
    :mod:`repro_torch.quant.observe.kv`). No per-page max reduction runs:
    the scale is a constant, codes hard-clip at the int8 container limit,
    and the returned scales are the broadcast stamp, so pool readers are
    unchanged. Plain tensor code, as in the reference."""
    qmax = 127
    xf = pages.to(torch.float32)
    stamp = torch.broadcast_to(scales.to(torch.float32), (*pages.shape[:-3], pages.shape[-2]))
    codes = torch.clamp(torch.round(xf / stamp[..., None, :, None]), -qmax, qmax)
    return codes.to(torch.int8), stamp


def dequantize_kv_pages(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_pages`, always f32."""
    return codes.to(torch.float32) * scales[..., None, :, None]


def _gather(pages, tab, scales=None):
    """(B, P*bs, nkv, hd) dense view of the pages ``tab`` (B, P) names."""
    B = tab.shape[0]
    _, _, nkv, hd = pages.shape
    if scales is not None:
        return dequantize_kv_pages(pages[tab], scales[tab]).reshape(B, -1, nkv, hd)
    return pages[tab].reshape(B, -1, nkv, hd)


def paged_attention_reference(q, k_pages, v_pages, block_table, seq_lens, *,
                              softcap=None, k_scales=None, v_scales=None):
    """Gather-based paged decode attention, in the inputs' dtype.

    q: (B, nh, hd); k/v_pages: (nb, bs, nkv, hd); block_table: (B, P) int32
    (entries >= nb are sentinels); seq_lens: (B,) int32, attend over
    positions < seq_lens[b]. With ``k_scales``/``v_scales`` (nb, nkv) the
    pages are int8 codes and dequantize per page to f32."""
    B, nh, hd = q.shape
    nb, _, nkv, _ = k_pages.shape
    g = nh // nkv
    tab = torch.clamp(block_table.long(), max=nb - 1)
    k = _gather(k_pages, tab, k_scales)
    v = _gather(v_pages, tab, v_scales)
    qg = q.reshape(B, nkv, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(k.dtype), k).to(torch.float32)
    s = _softcap(_div(s, math.sqrt(hd)), softcap)
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    return out.reshape(B, nh, hd).to(q.dtype)


def paged_attention_plain(q, k_pages, v_pages, block_table, seq_lens, *, softcap=None):
    """Plain version of kernel B2: the gather reference in f32 (the
    kernel's working precision), cast to q's dtype."""
    out = paged_attention_reference(q.to(torch.float32), k_pages.to(torch.float32),
                                    v_pages.to(torch.float32), block_table, seq_lens,
                                    softcap=softcap)
    return out.to(q.dtype)


def _near_tie(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Values within ``eps`` of a round-half boundary."""
    return torch.abs(torch.abs(x - torch.floor(x)) - 0.5) < eps


def int8_q_codes(q, spec: AttnDatapathSpec, nkv: int):
    """B3's per-head symmetric q quantization: codes (B, nkv, g, hd) as
    float64, scales (B, nkv, g, 1) f32, and the unrounded q / scale."""
    B, nh, hd = q.shape
    qf = q.to(torch.float32)
    q_scale = torch.clamp(_div(torch.amax(torch.abs(qf), dim=-1, keepdim=True), spec.q_qmax),
                          min=1e-8)
    qv = qf / q_scale
    q_codes = torch.clamp(torch.round(qv), -spec.q_qmax, spec.q_qmax)
    g = nh // nkv
    return q_codes.reshape(B, nkv, g, hd).to(torch.float64), q_scale.reshape(B, nkv, g, 1), qv


def int8_page_scores(qc, qs, k_codes, k_scales, page, valid, softcap=None):
    """One page of B3's scores: the exact integer QK^T (B, nkv, g, bs) and
    the finished f32 scores, ``s_int * q_scale * k_scale / sqrt(hd)``,
    softcapped, -inf where ``valid`` (B, bs) is False."""
    hd = k_codes.shape[-1]
    s_int = torch.einsum("bkgd,bskd->bkgs", qc, k_codes[page].to(torch.float64))
    s = s_int.to(torch.float32) * qs * k_scales[page][:, :, None, None]
    s = _softcap(_div(s, math.sqrt(hd)), softcap)
    return s_int, s.masked_fill(~valid[:, None, None, :], -math.inf)


def int8_page_step(s, m, prob_qmax):
    """One page of B3's recurrence from the running maximum ``m``: the new
    maximum, p * prob_qmax before rounding, the probability codes and the
    correction exp(m - m_safe) (0 while m is -inf)."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p_scaled = torch.exp(s - m_safe[..., None]) * prob_qmax
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, torch.full_like(m, -math.inf)))
    return m_new, p_scaled, torch.round(p_scaled), corr


def paged_attention_int8_plain(q, k_codes, v_codes, block_table, seq_lens, k_scales,
                               v_scales, *, softcap=None, spec: AttnDatapathSpec | None = None,
                               watermarks: torch.Tensor | None = None,
                               return_ties: bool = False, tie_eps: float = TIE_EPS,
                               prob_codes: list | None = None):
    """Plain version of kernel B3, page by page in the order of the
    reference's ``_quant_kernel``. Integer dots are exact (float64 products
    of integer codes on any device). ``watermarks`` (2,) int32, when given,
    is raised to the largest |QK^T| (valid positions) and |PV| seen.
    ``return_ties`` also returns a (B, nh) mask of the rows where a q code or
    a probability code lay within ``tie_eps`` of a rounding boundary: there
    another exp or division of equal accuracy may round the other way, so
    agreement with such rows is tie-limited. ``prob_codes``, a list, receives
    each page's probability codes (B, nkv, g, bs) in table order."""
    B, nh, hd = q.shape
    nb, bs, nkv, _ = k_codes.shape
    g = nh // nkv
    spec = spec or AttnDatapathSpec.for_cache(hd, bs)
    dev = q.device
    qc, qs, qv = int8_q_codes(q, spec, nkv)
    ties = _near_tie(qv, tie_eps).any(dim=-1).reshape(B, nkv, g)
    tab = torch.clamp(block_table.long(), max=nb - 1)
    lens = seq_lens.to(torch.int64)
    n_pages = min(block_table.shape[1], -(-int(lens.max()) // bs)) if B else 0
    m = torch.full((B, nkv, g), -math.inf, device=dev)
    l = torch.zeros((B, nkv, g), device=dev)
    acc = torch.zeros((B, nkv, g, hd), device=dev)
    wm_qk = wm_pv = 0
    for j in range(n_pages):
        page = tab[:, j]
        valid = (j * bs + torch.arange(bs, device=dev))[None, :] < lens[:, None]  # (B, bs)
        s_int, s = int8_page_scores(qc, qs, k_codes, k_scales, page, valid, softcap)
        if watermarks is not None:
            wm_qk = max(wm_qk, int(torch.where(valid[:, None, None, :], s_int.abs(), 0).max()))
        m, p_scaled, p_codes, corr = int8_page_step(s, m, spec.prob_qmax)
        if return_ties:
            ties |= (_near_tie(p_scaled, tie_eps) & valid[:, None, None, :]).any(dim=-1)
        if prob_codes is not None:
            prob_codes.append(p_codes)
        pv_int = torch.einsum("bkgs,bskd->bkgd", p_codes.to(torch.float64),
                              v_codes[page].to(torch.float64))
        if watermarks is not None:
            wm_pv = max(wm_pv, int(pv_int.abs().max()))
        pv = pv_int.to(torch.float32) * _div(v_scales[page], spec.prob_qmax)[:, :, None, None]
        l = l * corr + torch.sum(_div(p_codes, spec.prob_qmax), dim=-1)
        acc = acc * corr[..., None] + pv
    out = (acc / torch.clamp(l[..., None], min=1e-20)).reshape(B, nh, hd).to(q.dtype)
    if watermarks is not None:
        watermarks[0] = max(int(watermarks[0]), wm_qk)
        watermarks[1] = max(int(watermarks[1]), wm_pv)
    return (out, ties.reshape(B, nh)) if return_ties else out


# ---------------------------------------------------------------------------
# The CUDA kernels (B2, B3)
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library (built with nvcc at first use)."""
    from ._build import load_library

    lib = load_library("paged_attention")
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_attention_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_workspace_bytes.restype = ctypes.c_size_t
    lib.paged_attention_sync_ints.argtypes = [ctypes.c_int] * 2
    lib.paged_attention_sync_ints.restype = ctypes.c_size_t
    lib.paged_attention_flag_words.argtypes = [ctypes.c_int] * 4
    lib.paged_attention_flag_words.restype = ctypes.c_size_t
    return lib


def split_plan(batch: int, nkv: int, n_cols: int, n_sm: int) -> int:
    """Splits S of each row's pages for the grid (nkv, batch, S): as many as
    fill BLOCKS_PER_SM blocks on each of ``n_sm`` SMs in one wave, at least
    1 and at most the table's width ``n_cols``. A function of shapes alone:
    each row divides its own ceil(len / bs) pages over the S splits on the
    device, so the plan never reads ``seq_lens`` (a host read would
    synchronize)."""
    return max(1, min(n_cols, BLOCKS_PER_SM * n_sm // max(1, batch * nkv)))


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class _SyncBuffers:
    """Per (device, stream): the kernels' synchronization buffers, zeroed
    once here and never by a launch. ``counters`` (int32): per (slot, kv
    head) a done counter and a ticket, which every call's last block resets
    to 0. ``flags`` (B3, 64-bit): per split and head the split's published
    maximum (nonzero once published), which the row's last block resets to 0
    as well. No launch depends on a value from the host, so a launch may be
    captured in a CUDA graph and replayed. Launches on one stream run one
    after another, in a graph as outside one, so they share the buffers.
    Outgrown buffers are kept (``retired``): a graph captured earlier still
    points at them."""

    def __init__(self):
        self.counters = self.flags = None
        self.retired = []

    def next(self, device, n_counters: int, n_flags: int):
        if self.counters is None or self.counters.numel() < n_counters:
            self.retired.append(self.counters)
            self.counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32, device=device)
        if self.flags is None or self.flags.numel() < n_flags:
            self.retired.append(self.flags)
            self.flags = torch.zeros(max(n_flags, 1024), dtype=torch.int64, device=device)
        return self.counters, self.flags


_SYNC: dict[tuple[int, int], _SyncBuffers] = {}


def _check_kernel_args(q, k_pages, v_pages, block_table, seq_lens, extra=()):
    if not q.is_cuda:
        raise ValueError(f"paged attention kernels take CUDA tensors, got {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    B, nh, hd = q.shape
    _, _, nkv, hd_p = k_pages.shape
    if hd_p != hd or nh % nkv:
        raise ValueError(f"paged attention: q {tuple(q.shape)} does not match pages "
                         f"{tuple(k_pages.shape)}")
    if nh // nkv > MAX_GROUP:
        raise ValueError(f"paged attention kernels take at most {MAX_GROUP} query heads "
                         f"per kv head, got {nh // nkv}")
    if q.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"paged attention: q must be bfloat16 or float32, got {q.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged attention: block_table and seq_lens must be int32")
    if block_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError(f"paged attention: table {tuple(block_table.shape)}, lens "
                         f"{tuple(seq_lens.shape)} for batch {B}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("seq_lens", seq_lens), *extra):
        if t.device != q.device:
            raise ValueError(f"paged attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous")


def _launch(q, k_pages, v_pages, k_scales, v_scales, block_table, seq_lens, wm, softcap):
    B, nh, hd = q.shape
    nb, bs, nkv, _ = k_pages.shape
    g = nh // nkv
    n_cols = block_table.shape[1]
    quantized = k_scales is not None
    lib = _library()
    n_splits = split_plan(B, nkv, n_cols, _sm_count(q.device.index))
    smem = lib.paged_attention_smem_bytes(g, hd, bs, k_pages.element_size(), int(quantized),
                                          n_cols, n_splits)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged attention: one block needs {smem} B of shared memory "
                         f"(g {g}, hd {hd}, bs {bs}) > Hopper's {SMEM_LIMIT} B")
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = torch.empty(lib.paged_attention_workspace_bytes(B, nkv, g, hd, n_splits) // 4,
                     dtype=torch.float32, device=q.device)
    counters, flags = _SYNC.setdefault((q.device.index, stream), _SyncBuffers()).next(
        q.device, lib.paged_attention_sync_ints(B, nkv),
        lib.paged_attention_flag_words(B, nkv, g, n_splits))
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        wm.data_ptr() if wm is not None else None, ws.data_ptr(), counters.data_ptr(),
        flags.data_ptr(), B, nb, bs, nkv, g, hd, n_cols, n_splits, int(q.dtype == torch.bfloat16),
        int(quantized), math.sqrt(hd), 0.0 if softcap is None else float(softcap),
        int(softcap is not None), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA error {err}")
    return out


def paged_attention_kernel(q, k_pages, v_pages, block_table, seq_lens, *, softcap=None):
    """Launch kernel B2 (float pages of q's dtype) on CUDA tensors."""
    _check_kernel_args(q, k_pages, v_pages, block_table, seq_lens)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention: pages {k_pages.dtype} must be q's {q.dtype}")
    out = _launch(q, k_pages, v_pages, None, None, block_table, seq_lens, None, softcap)
    paged_decode_attention.launches += 1
    return out


def paged_attention_int8_kernel(q, k_codes, v_codes, block_table, seq_lens, k_scales,
                                v_scales, *, softcap=None, watermarks=None):
    """Launch kernel B3 (int8 pages, f32 scales (nb, nkv)) on CUDA tensors.
    ``watermarks``, a (2,) int32 CUDA tensor, receives the largest |QK^T|
    and |PV| by atomicMax (no host read here)."""
    extra = [("k_scales", k_scales), ("v_scales", v_scales)]
    if watermarks is not None:
        extra.append(("watermarks", watermarks))
    _check_kernel_args(q, k_codes, v_codes, block_table, seq_lens, extra)
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError(f"paged attention int8: pages must be int8, got {k_codes.dtype}")
    nb, _, nkv, _ = k_codes.shape
    for t in (k_scales, v_scales):
        if t.dtype != torch.float32 or t.shape != (nb, nkv):
            raise TypeError(f"paged attention int8: scales must be f32 ({nb}, {nkv}), got "
                            f"{t.dtype} {tuple(t.shape)}")
    if watermarks is not None and (watermarks.dtype != torch.int32
                                   or watermarks.shape != (2,)):
        raise TypeError("paged attention int8: watermarks must be a (2,) int32 tensor")
    out = _launch(q, k_codes, v_codes, k_scales, v_scales, block_table, seq_lens,
                  watermarks, softcap)
    paged_decode_attention.int8_launches += 1
    return out


def check_bounds(watermarks, spec: AttnDatapathSpec) -> tuple[int, int]:
    """Compare the QK^T and PV watermarks with the record's registers:
    |QK^T| <= 2^(P_qk-1)-1 and |PV| <= 2^(P_pv-1)-1. Reads two ints to the
    host; raises OverflowError otherwise. Returns the watermarks."""
    qk, pv = (int(v) for v in watermarks.tolist())
    for name, value, p_bits in (("QK^T", qk, spec.p_qk), ("PV", pv, spec.p_pv)):
        limit = 2 ** (p_bits - 1) - 1
        if value > limit:
            raise OverflowError(f"{name} accumulator overflow: {value} > {limit} "
                                f"(P={p_bits}, {spec.describe()})")
    return qk, pv


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens, *, k_scales=None,
                           v_scales=None, attn_spec: AttnDatapathSpec | None = None,
                           softcap: float | None = None, assert_bounds: bool = False,
                           watermarks: torch.Tensor | None = None):
    """Paged decode attention; the contract of :func:`paged_attention_reference`.

    ``k_scales``/``v_scales`` select the int8 body (B3), whose registers an
    :class:`~repro_torch.quant.spec.AttnDatapathSpec` derived from the pool
    layout certifies; ``attn_spec`` is a request checked against it (a float
    pool given a request raises :class:`DatapathMismatchError`).
    ``assert_bounds`` checks the B3 watermarks against P_qk and P_pv (one
    host read); ``watermarks`` (2,) int32 accumulates them across calls
    without a host read. CUDA tensors launch the kernel; CPU tensors run the
    plain version. Never falls back."""
    B, nh, hd = q.shape
    nb, bs, nkv, _ = k_pages.shape
    if nh % nkv:
        raise ValueError(f"paged attention: {nh} heads over {nkv} kv heads")
    quantized = k_scales is not None
    if not quantized:
        if attn_spec is not None:
            validate_attn_datapath(None, attn_spec)
        if q.is_cuda:
            return paged_attention_kernel(q, k_pages, v_pages, block_table, seq_lens,
                                          softcap=softcap)
        return paged_attention_plain(q, k_pages, v_pages, block_table, seq_lens,
                                     softcap=softcap)
    derived = AttnDatapathSpec.for_cache(hd, bs, kv_bits=8 * k_pages.element_size())
    if attn_spec is not None:
        derived.require_matches(attn_spec, context="paged_decode_attention")
    wm = watermarks
    if assert_bounds and wm is None:
        wm = torch.zeros(2, dtype=torch.int32, device=q.device)
    if q.is_cuda:
        out = paged_attention_int8_kernel(q, k_pages, v_pages, block_table, seq_lens,
                                          k_scales, v_scales, softcap=softcap, watermarks=wm)
    else:
        out = paged_attention_int8_plain(q, k_pages, v_pages, block_table, seq_lens,
                                         k_scales, v_scales, softcap=softcap, spec=derived,
                                         watermarks=wm)
    if assert_bounds:
        check_bounds(wm, derived)
    return out


#: kernel calls since the last reset (the main-path proof of chip_smoke):
#: B2 (float pages) and B3 (int8 pages)
paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0


__all__ = [
    "check_bounds",
    "dequantize_kv_pages",
    "int8_page_scores",
    "int8_page_step",
    "int8_q_codes",
    "paged_attention_int8_kernel",
    "paged_attention_int8_plain",
    "paged_attention_kernel",
    "paged_attention_plain",
    "paged_attention_reference",
    "paged_decode_attention",
    "quantize_kv_pages",
    "quantize_kv_pages_static",
    "split_plan",
]
