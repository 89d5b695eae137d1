"""Overflow-avoidance certification (port of ``repro/core/overflow.py``).

Given integer-domain codes Q (K, C), an activation alphabet A_N and an
accumulation datapath (monolithic P, or multi-stage (T, P_I, P_O)), compute
the exact worst case of every (tile-)partial dot product over all x in
A_N^K (Eq. 6) and compare it with the accumulator range: an analytic
certificate. :func:`simulate_accumulation` evaluates real integer
accumulations exactly (numpy int64) and reports the bit watermark.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .alphabet import Alphabet, accumulator_range, outer_accumulator_bits
from .ep_init import tiled


@dataclass
class CertReport:
    ok: bool
    p_bits: int  # inner accumulator target
    p_outer: int  # outer accumulator (== p_bits when monolithic)
    tile: int | None
    worst_hi: float  # max over channels/tiles of the worst-case partial sum
    worst_lo: float
    headroom_bits: float  # log2 margin below the limit (>= 0 iff ok)
    outer_hi: float
    outer_lo: float
    outer_ok: bool
    k: int | None = None  # reduction depth the certificate was computed for
    sparsity: str | None = None

    def __bool__(self) -> bool:
        return self.ok and self.outer_ok


@dataclass
class StackedCertReport:
    """Per-expert certificates of an expert-stacked (E, K, C) weight."""

    reports: tuple[CertReport, ...]

    def __bool__(self) -> bool:
        return all(bool(r) for r in self.reports)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.reports)

    @property
    def headroom_bits(self) -> float:
        return min(r.headroom_bits for r in self.reports)

    @property
    def p_bits(self) -> int:
        return self.reports[0].p_bits

    @property
    def tile(self) -> int | None:
        return self.reports[0].tile

    @property
    def k(self) -> int | None:
        return self.reports[0].k

    @property
    def sparsity(self) -> str | None:
        return self.reports[0].sparsity


def tile_signed_sums(q_int: torch.Tensor, tile: int | None):
    """Per (channel, tile) sums of the positive / negative codes of ``q_int``
    (K, C): (pos, neg), each (C, n_tiles). Integer sums, exact in f32."""
    t = tile or q_int.shape[0]
    q_ct = tiled(q_int.T, t)  # (C, n_tiles, T)
    return torch.sum(torch.clamp(q_ct, min=0.0), dim=-1), torch.sum(torch.clamp(q_ct, max=0.0),
                                                                       dim=-1)


def certify(q_int: torch.Tensor, act: Alphabet, p_bits: int, tile: int | None = None,
            sparsity: str | None = None) -> CertReport:
    """Analytic overflow certificate for ``q_int`` (K, C): every (channel,
    tile) partial fits ``p_bits`` (= P_I) and, tiled, the total fits P_O of
    Eq. 22. Reads a few scalars to the host.

    ``sparsity="2:4"`` checks (loudly) that the codes keep the pattern and
    records it: the Eq. 6 worst cases already see the masked zeros, and the
    pattern halves the depth of every later Eq. 22 re-derivation."""
    k = q_int.shape[0]
    if sparsity is not None:
        from .sparsity import check_2to4, validate_sparsity

        validate_sparsity(sparsity)
        check_2to4(q_int)
    pos, neg = tile_signed_sums(q_int, tile)  # (C, n_tiles)
    hi = act.nu * pos + act.mu * neg  # worst-case max per tile (Eq. 6/7)
    lo = act.mu * pos + act.nu * neg  # worst-case min per tile (Eq. 6/8)

    lo_lim, hi_lim = accumulator_range(p_bits)
    worst_hi = float(torch.max(hi))
    worst_lo = float(torch.min(lo))
    inner_ok = worst_hi <= hi_lim and worst_lo >= lo_lim

    if tile is None or tile >= k:
        p_outer = p_bits
        outer_hi, outer_lo, outer_ok = worst_hi, worst_lo, inner_ok
    else:
        p_outer = outer_accumulator_bits(p_bits, k, tile, sparsity=sparsity)
        o_lo_lim, o_hi_lim = accumulator_range(p_outer)
        outer_hi = float(torch.max(torch.sum(hi, dim=-1)))
        outer_lo = float(torch.min(torch.sum(lo, dim=-1)))
        outer_ok = outer_hi <= o_hi_lim and outer_lo >= o_lo_lim

    # an all-zero site clamps to peak 1.0, so headroom stays finite
    peak = max(worst_hi, -worst_lo, 1.0)
    headroom = float(np.log2(hi_lim) - np.log2(peak)) if peak > 0 else float("inf")
    return CertReport(ok=inner_ok, p_bits=p_bits, p_outer=p_outer, tile=tile,
                      worst_hi=worst_hi, worst_lo=worst_lo, headroom_bits=headroom,
                      outer_hi=outer_hi, outer_lo=outer_lo, outer_ok=outer_ok,
                      k=k, sparsity=sparsity)


def certify_stacked(q_int: torch.Tensor, act: Alphabet, p_bits: int,
                    tile: int | None = None, sparsity: str | None = None) -> StackedCertReport:
    """Per-expert certificates for stacked (E, K, C) codes."""
    return StackedCertReport(reports=tuple(
        certify(q_int[e], act, p_bits, tile, sparsity=sparsity) for e in range(q_int.shape[0])))


def min_feasible_p_bits(report: CertReport | StackedCertReport, k: int | None = None,
                        margin_bits: float = 0.0) -> int:
    """Smallest inner accumulator width the already-certified codes fit
    (re-deriving P_O of Eq. 22 at each candidate when tiled). Never more
    than the certified ``p_bits``; raises ValueError when ``margin_bits``
    inflates the peaks past the certified register."""
    if isinstance(report, StackedCertReport):
        return max(min_feasible_p_bits(r, k, margin_bits) for r in report.reports)
    grow = 2.0**margin_bits
    hi, lo = report.worst_hi * grow, report.worst_lo * grow
    o_hi, o_lo = report.outer_hi * grow, report.outer_lo * grow
    tile = report.tile
    depth = k if k is not None else report.k
    for p in range(2, report.p_bits + 1):
        lo_lim, hi_lim = accumulator_range(p)
        if hi > hi_lim or lo < lo_lim:
            continue
        if tile is not None and depth is not None and tile < depth:
            po = outer_accumulator_bits(p, depth, tile, sparsity=report.sparsity)
            o_lo_lim, o_hi_lim = accumulator_range(po)
            if o_hi > o_hi_lim or o_lo < o_lo_lim:
                continue
        return p
    raise ValueError(
        f"no feasible accumulator floor: margin_bits={margin_bits} inflates the "
        f"recorded worst-case peaks (hi={hi:.6g}, lo={lo:.6g}) past the certified "
        f"P_I={report.p_bits} register itself")


def _int64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.int64)


def simulate_accumulation(q_int, x_int, tile: int | None = None) -> dict:
    """Integer dot products of codes ``q_int`` (K, C) and activation codes
    ``x_int`` (D, K), exactly in numpy int64 on the host: per-tile partial
    and total extrema and the bit widths they use."""
    q, x = _int64(q_int), _int64(x_int)
    k = q.shape[0]
    t = tile or k
    n_tiles = (k + t - 1) // t
    pad = n_tiles * t - k
    if pad:
        q = np.pad(q, [(0, pad), (0, 0)])
        x = np.pad(x, [(0, 0), (0, pad)])
    q_t = q.T.reshape(q.shape[1], n_tiles, t)  # (C, n_tiles, T)
    x_t = x.reshape(x.shape[0], n_tiles, t)  # (D, n_tiles, T)
    partials = np.einsum("dnt,cnt->dcn", x_t, q_t)  # (D, C, n_tiles)
    totals = np.sum(partials, axis=-1)
    p_hi, p_lo, t_hi, t_lo = partials.max(), partials.min(), totals.max(), totals.min()

    def bits_needed(hi, lo):
        return int(np.ceil(np.log2(max(int(hi), -int(lo), 1) + 1))) + 1

    return {
        "partial_hi": int(p_hi),
        "partial_lo": int(p_lo),
        "total_hi": int(t_hi),
        "total_lo": int(t_lo),
        "inner_bits_used": bits_needed(p_hi, p_lo),
        "outer_bits_used": bits_needed(t_hi, t_lo),
    }


def worst_case_inputs(q_int: torch.Tensor, act: Alphabet):
    """The maximizing / minimizing activation vectors (u, v), each (C, K),
    of Eq. 6: u[c] . q[:, c] attains the analytic worst-case maximum."""
    qt = q_int.T
    nu = torch.full_like(qt, float(act.nu))
    mu = torch.full_like(qt, float(act.mu))
    return torch.where(qt >= 0, nu, mu), torch.where(qt >= 0, mu, nu)
