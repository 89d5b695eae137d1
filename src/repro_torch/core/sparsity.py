"""2:4 semi-structured sparsity masks (port of ``repro/core/sparsity.py``).

A 2:4 pattern keeps at most 2 nonzero weights in every contiguous group of
4 along the reduction axis K. The accumulator certificate only sees the
surviving codes, so the pattern halves the effective reduction depth
(:func:`repro_torch.core.alphabet.effective_depth`).

The mask keeps the top-2 magnitudes per (group of 4, channel), ranked on
the integer-domain target so it commutes with the per-channel positive
scale. Ties go to the lower in-group index (stable argsort), as in the
reference, so all-equal groups keep slots 0 and 1.
"""

from __future__ import annotations

import numpy as np
import torch

from .alphabet import SPARSITY_2_4, effective_depth

GROUP = 4  # in-group population of the N:M pattern (N=2, M=4)
KEEP = 2


def validate_sparsity(sparsity: str | None) -> None:
    """Raise unless ``sparsity`` names a supported pattern (or is None)."""
    if sparsity is not None and sparsity != SPARSITY_2_4:
        raise ValueError(f"unknown sparsity pattern {sparsity!r}")


def mask_2to4(w: torch.Tensor) -> torch.Tensor:
    """Top-2-magnitude 2:4 mask for ``w`` with K on axis -2: (..., K, C).

    Returns a {0, 1} tensor of ``w``'s dtype; requires ``K % 4 == 0``.
    """
    k = w.shape[-2]
    if k % GROUP:
        raise ValueError(f"2:4 sparsity needs K % 4 == 0, got K={k}")
    lead = w.shape[:-2]
    g = torch.abs(w).reshape(*lead, k // GROUP, GROUP, w.shape[-1])
    # rank[i] = how many in-group slots beat slot i (stable: ties -> index)
    order = torch.argsort(-g, dim=-2, stable=True)
    rank = torch.argsort(order, dim=-2, stable=True)
    return (rank < KEEP).to(w.dtype).reshape(w.shape)


def apply_mask(w: torch.Tensor, sparsity: str | None) -> torch.Tensor:
    """Magnitude-mask ``w`` (K on axis -2) to the requested pattern."""
    validate_sparsity(sparsity)
    if sparsity is None:
        return w
    return w * mask_2to4(w)


def is_2to4(q) -> bool:
    """True iff every group of 4 along axis -2 has at most 2 nonzeros."""
    q = q if isinstance(q, torch.Tensor) else torch.from_numpy(np.array(q))
    k = q.shape[-2]
    if k % GROUP:
        return False
    g = q.reshape(*q.shape[:-2], k // GROUP, GROUP, q.shape[-1])
    return bool(((g != 0).sum(dim=-2) <= KEEP).all())


def check_2to4(q, what: str = "codes") -> None:
    """Loud host-side validation that ``q`` satisfies the 2:4 pattern."""
    k = q.shape[-2]
    if k % GROUP:
        raise ValueError(f"{what} claim 2:4 sparsity but K={k} is not a multiple of 4")
    if not is_2to4(q):
        raise ValueError(f"{what} claim 2:4 sparsity but a group of 4 has > 2 nonzeros")


__all__ = [
    "GROUP",
    "KEEP",
    "SPARSITY_2_4",
    "apply_mask",
    "check_2to4",
    "effective_depth",
    "is_2to4",
    "mask_2to4",
    "validate_sparsity",
]
