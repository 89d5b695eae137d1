"""GPFQ panel solver (port of ``repro/kernels/gpfq_solve.py``, kernel B5).

GPFQ is sequential in K: each row's code depends on the error of every
earlier row through the running error matrix U. :func:`gpfq_solve` runs
the greedy loop of ``repro/core/gpfq.py::_gpfq_loop`` with the AXE
constraints: the hand-written CUDA kernel (``csrc/gpfq_solve.cu``,
replacing the Pallas ``_kernel`` at ``repro/kernels/gpfq_solve.py:33``) for
CUDA tensors, its plain version :func:`gpfq_solve_plain` for CPU tensors.
``gpfq_solve.launches`` counts kernel launches (one per solve).

Unlike the reference wrapper, this one takes the (K,) tile-id vector as an
input, so a caller that permutes rows (``act_order``) passes the permuted
ids, and masks a ragged last channel panel instead of requiring
``C % block_c == 0``. ``mode`` selects the constraint:

    "plain" — GPFQ without AXE (no soft threshold, no clip, no bookkeeping)
    "split" — AXE, per-sign budgets (unsigned activations)
    "joint" — AXE, joint l1 budget (signed activations)
    "soft"  — AXE with the soft threshold only (``strict=False``)
"""

from __future__ import annotations

import ctypes
import functools

import torch

MODES = {"plain": 0, "split": 1, "joint": 2, "soft": 3}
ROUNDINGS = ("nearest", "zero")


def panel_layout(d: int, force_global_u: bool = False) -> tuple[int, bool]:
    """(channels per block, U in global memory?) that the kernel's launcher
    chooses for a D-deep U on the current card: the widest of 32 and 16
    channels whose U panel fits the block's opt-in shared memory, else 32
    channels with U in global memory. Needs the built kernel library."""
    bc, global_u = ctypes.c_int(), ctypes.c_int()
    err = _library().gpfq_solve_layout(d, int(force_global_u), ctypes.byref(bc),
                                       ctypes.byref(global_u))
    if err != 0:
        raise ValueError(f"gpfq_solve kernel: no panel layout for rows of depth D={d} "
                         f"(CUDA error {err})")
    return bc.value, bool(global_u.value)


def row_terms(xg: torch.Tensor, xh: torch.Tensor):
    """(hg, hn): <h_k, g_k> and max(|h_k|^2, 1e-20) per row, formed in
    PyTorch for both the kernel and its plain version."""
    hn = torch.clamp(torch.sum(xh * xh, dim=1), min=1e-20)
    hg = torch.sum(xh * xg, dim=1)
    return hg, hn


def _check(w, xg, xh, lam, tid, mode, rounding):
    k, c = w.shape
    if xg.dim() != 2 or xg.shape[0] != k or xh.shape != xg.shape:
        raise ValueError(f"gpfq_solve: w {tuple(w.shape)}, xg {tuple(xg.shape)}, "
                         f"xh {tuple(xh.shape)}")
    if lam.dim() != 2 or lam.shape[1] != c:
        raise ValueError(f"gpfq_solve: lam {tuple(lam.shape)} for C={c}")
    if tid.shape != (k,):
        raise ValueError(f"gpfq_solve: tile ids {tuple(tid.shape)} for K={k}")
    if mode not in MODES:
        raise ValueError(f"gpfq_solve: mode {mode!r} not in {sorted(MODES)}")
    if rounding not in ROUNDINGS:
        raise ValueError(f"gpfq_solve: rounding {rounding!r} not in {ROUNDINGS}")


def gpfq_solve_plain(w, xg, xh, hg, hn, lam, tid, a: float, b: float, *, qmax: float,
                     mode: str = "split", rounding: str = "nearest", return_v: bool = False):
    """The kernel's plain version: the per-row loop of ``_gpfq_loop`` in
    PyTorch, on the kernel's arguments. Returns (Q (K, C), U (D, C), pos,
    neg), plus V (K, C) — every code's value before rounding (after Pi and
    Psi) — when ``return_v``. One host read (the tile ids)."""
    _check(w, xg, xh, lam, tid, mode, rounding)
    k, c = w.shape
    n_tiles = lam.shape[0]
    f32 = dict(dtype=torch.float32, device=w.device)
    u = torch.zeros((xg.shape[1], c), **f32)
    q_all = torch.empty((k, c), **f32)
    pos = torch.zeros((n_tiles, c), **f32)
    neg = torch.zeros((n_tiles, c), **f32)
    v_all = torch.empty((k, c), **f32) if return_v else None
    tids = tid.tolist()
    if tids and (min(tids) < 0 or max(tids) >= n_tiles):  # lam is indexed by them
        raise ValueError(f"gpfq_solve: tile ids outside [0, {n_tiles})")
    for i in range(k):
        v = w[i] * (hg[i] / hn[i]) + (xh[i] @ u) / hn[i]
        t = tids[i]
        if mode != "plain":
            v = torch.sign(v) * torch.relu(torch.abs(v) - lam[t])
            if mode == "split":
                lo = torch.clamp(a - neg[t], max=0.0)
                hi = torch.clamp(b - pos[t], min=0.0)
                v = torch.minimum(torch.maximum(v, lo), hi)
            elif mode == "joint":
                rem = torch.clamp(b - (pos[t] - neg[t]), min=0.0)
                v = torch.minimum(torch.maximum(v, -rem), rem)
        if return_v:
            v_all[i] = v
        q = torch.round(v) if rounding == "nearest" else torch.trunc(v)
        q = torch.clamp(q, -qmax, qmax)
        if mode != "plain":
            pos[t] += torch.clamp(q, min=0.0)
            neg[t] += torch.clamp(q, max=0.0)
        u += torch.outer(xg[i], w[i])
        u -= torch.outer(xh[i], q)
        q_all[i] = q
    out = (q_all, u, pos, neg)
    return out + (v_all,) if return_v else out


def gpfq_solve_kernel(w, xg, xh, hg, hn, lam, tid, a: float, b: float, *, qmax: float,
                      mode: str = "split", rounding: str = "nearest",
                      force_global_u: bool = False):
    """Launch the CUDA kernel on CUDA tensors (the arguments of
    :func:`gpfq_solve_plain`). Checks device, dtype, shape and contiguity
    and raises on what the kernel does not take; raises if the launch
    returns a CUDA error. It never waits for the card: a tile id outside
    [0, n_tiles) traps on the device, and the error surfaces at the next
    synchronisation. ``force_global_u`` keeps U in global memory even
    where the panel fits shared memory (to test that variant)."""
    _check(w, xg, xh, lam, tid, mode, rounding)
    if not w.is_cuda:
        raise ValueError(f"gpfq_solve_kernel takes CUDA tensors, got {w.device}")
    for name, t in (("w", w), ("xg", xg), ("xh", xh), ("hg", hg), ("hn", hn), ("lam", lam),
                    ("tid", tid)):
        if t.device != w.device:
            raise ValueError(f"gpfq_solve: {name} on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"gpfq_solve: {name} must be contiguous")
        want = torch.int32 if name == "tid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"gpfq_solve: {name} must be {want}, got {t.dtype}")
    k, c = w.shape
    d = xg.shape[1]
    if hg.shape != (k,) or hn.shape != (k,):
        raise ValueError("gpfq_solve: hg and hn must be (K,)")
    n_tiles = lam.shape[0]
    f32 = dict(dtype=torch.float32, device=w.device)
    q = torch.empty((k, c), **f32)
    u = torch.empty((d, c), **f32)
    pos = torch.empty((n_tiles, c), **f32)
    neg = torch.empty((n_tiles, c), **f32)
    err = _library().gpfq_solve_launch(
        w.data_ptr(), xg.data_ptr(), xh.data_ptr(), hg.data_ptr(), hn.data_ptr(),
        lam.data_ptr(), tid.data_ptr(), q.data_ptr(), u.data_ptr(), pos.data_ptr(),
        neg.data_ptr(), k, d, c, n_tiles, a, b, qmax, MODES[mode], int(rounding == "zero"),
        int(force_global_u), torch.cuda.current_stream(w.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gpfq_solve kernel launch failed: CUDA error {err}")
    gpfq_solve.launches += 1
    return q, u, pos, neg


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library (built with nvcc at first use)."""
    from ._build import load_library

    lib = load_library("gpfq_solve")
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.gpfq_solve_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gpfq_solve_launch.restype = ctypes.c_int
    lib.gpfq_solve_layout.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.gpfq_solve_layout.restype = ctypes.c_int
    return lib


def gpfq_solve(
    w_int: torch.Tensor,  # (K, C) integer-domain weights, rows in solve order
    xg: torch.Tensor,  # (K, D) rows of G H^-1 (or analog samples)
    xh: torch.Tensor,  # (K, D) rows of H (or quantized samples)
    lam: torch.Tensor,  # (n_tiles, C) soft thresholds
    tile_ids: torch.Tensor,  # (K,) int tile id of each row
    a: float,
    b: float,
    *,
    w_bits: int = 4,
    mode: str = "split",
    rounding: str = "nearest",
):
    """One GPFQ solve: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors. Returns (Q, U, pos, neg). Never falls back."""
    qmax = float(2 ** (w_bits - 1) - 1)
    w_int = w_int.to(torch.float32).contiguous()
    xg = xg.to(torch.float32).contiguous()
    xh = xh.to(torch.float32).contiguous()
    lam = lam.to(torch.float32).contiguous()
    tid = tile_ids.to(device=w_int.device, dtype=torch.int32).contiguous()
    hg, hn = row_terms(xg, xh)
    if not w_int.is_cuda:
        return gpfq_solve_plain(w_int, xg, xh, hg, hn, lam, tid, a, b, qmax=qmax, mode=mode,
                                rounding=rounding)
    return gpfq_solve_kernel(w_int, xg, xh, hg, hn, lam, tid, a, b, qmax=qmax, mode=mode,
                             rounding=rounding)


#: kernel launches since the last reset (the main-path proof of chip_smoke)
gpfq_solve.launches = 0


def tie_limited_agreement(q_a: torch.Tensor, q_b: torch.Tensor, v: torch.Tensor,
                          rounding: str = "nearest", eps: float = 1e-3):
    """Hold two GPFQ solves of the same inputs to each other where float
    reduction order can change them: per channel, the codes must be equal
    before the first row whose pre-rounding value ``v`` (of solve ``b``, in
    solve order) lies within ``eps`` of a rounding boundary (a half-integer
    for round-to-nearest, a nonzero integer for round-to-zero). Past that
    row the error feedback may follow another path.

    Returns (ok, share of equal codes, number of channels cut by a tie)."""
    if rounding == "nearest":
        near = torch.abs(v - torch.floor(v) - 0.5) < eps
    else:
        r = torch.round(v)
        near = (torch.abs(v - r) < eps) & (r != 0)
    k = v.shape[0]
    rows = torch.arange(k, device=v.device)[:, None].expand_as(v)
    first = torch.where(near, rows, torch.full_like(rows, k)).amin(dim=0)  # (C,)
    before = rows < first[None, :]
    ok = bool(torch.equal(q_a[before], q_b[before]))
    share = float((q_a == q_b).to(torch.float64).mean())
    return ok, share, int((first < k).sum())


__all__ = [
    "MODES",
    "gpfq_solve",
    "gpfq_solve_kernel",
    "gpfq_solve_plain",
    "panel_layout",
    "row_terms",
    "tie_limited_agreement",
]
