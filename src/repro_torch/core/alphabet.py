"""Quantization alphabets and accumulator-bound arithmetic (port of
``repro/core/alphabet.py``; paper Eqs. 3, 4, 17, 21, 22).

Pure Python: exact integer-domain math on scalars, shared by the solvers
(``gpfq.py``, ``optq.py``) and the certificate (``overflow.py``).

Conventions (paper §2): a signed M-bit sign-magnitude weight alphabet
``{-(2^(M-1)-1), ..., 2^(M-1)-1}``; activations unsigned asymmetric
``{0, ..., 2^N-1}`` or signed symmetric; the accumulator is certified
against the symmetric range ``[-(2^(P-1)-1), 2^(P-1)-1]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

#: the 2:4 sparse paths arrive with a later slice of the port
SLICE_2TO4 = "2:4 sparsity arrives with the 2:4 slice of the port"


@dataclass(frozen=True)
class Alphabet:
    """A fixed b-bit integer alphabet [qmin, qmax]."""

    bits: int
    signed: bool
    symmetric: bool = True  # only meaningful for signed alphabets

    @property
    def qmin(self) -> int:
        if not self.signed:
            return 0
        if self.symmetric:
            return -(2 ** (self.bits - 1) - 1)
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        if not self.signed:
            return 2**self.bits - 1
        return 2 ** (self.bits - 1) - 1

    @property
    def mu(self) -> int:
        """Paper's mu: smallest representable value."""
        return self.qmin

    @property
    def nu(self) -> int:
        """Paper's nu: largest representable value."""
        return self.qmax

    @property
    def span(self) -> int:
        return self.qmax - self.qmin

    def __post_init__(self) -> None:
        if self.bits < 1 or self.bits > 32:
            raise ValueError(f"unsupported bit width {self.bits}")


def weight_alphabet(bits: int) -> Alphabet:
    """Signed symmetric (sign-magnitude) weight alphabet A_M."""
    return Alphabet(bits=bits, signed=True, symmetric=True)


def act_alphabet(bits: int, signed: bool = False) -> Alphabet:
    """Activation alphabet A_N. Default: unsigned asymmetric."""
    return Alphabet(bits=bits, signed=signed, symmetric=True)


def accumulator_range(p_bits: int) -> tuple[int, int]:
    """Symmetric representation range of a signed P-bit accumulator."""
    m = 2 ** (p_bits - 1) - 1
    return -m, m


def effective_depth(k: int, sparsity: str | None) -> int:
    """Nonzero addends in a ``k``-deep reduction: ``k`` for dense codes.
    The 2:4 pattern raises until its slice of the port."""
    if sparsity is None:
        return k
    raise NotImplementedError(f"sparsity={sparsity!r}: {SLICE_2TO4}")


def min_accumulator_bits(k: int, n_bits: int, m_bits: int, signed_input: bool,
                         sparsity: str | None = None) -> int:
    """P* = ceil(log2(2^(log2(K) + N + M - 1 - 1_signed) + 1) + 1)   (Eq. 3)."""
    if k < 1:
        raise ValueError("dot-product depth must be >= 1")
    k = effective_depth(k, sparsity)
    exponent = math.log2(k) + n_bits + m_bits - 1 - (1 if signed_input else 0)
    return int(math.ceil(math.log2(2**exponent + 1) + 1))


def l1_budget_zero_centered(p_bits: int, act: Alphabet) -> float:
    """||q||_1 <= (2^P - 2) / (2^N - 1)   (Eq. 4), in integer units."""
    return (2.0**p_bits - 2.0) / float(act.span)


@dataclass(frozen=True)
class Budgets:
    """Strict budgets: ``mode == "split"`` (unsigned activations) bounds the
    running positive sum by B and the negative sum by A independently
    (Eqs. 17/19/20); ``mode == "joint"`` (signed activations) bounds the
    running l1 norm by B."""

    A: float  # lower budget (<= 0)
    B: float  # upper budget (>= 0)
    mode: str  # "split" | "joint"


def strict_budgets(p_bits: int, act: Alphabet, rounding_slack: float) -> Budgets:
    """-A = B = (2^(P-1) - 1)/nu - max(Delta)   (Eq. 21); ``rounding_slack``
    is max(Delta): 0.5 for round-to-nearest, 0.0 for round-to-zero."""
    b = (2.0 ** (p_bits - 1) - 1.0) / float(act.nu) - rounding_slack
    if b < 0:
        raise ValueError(f"accumulator P={p_bits} too small for N={act.bits}-bit activations")
    return Budgets(A=-b, B=b, mode="joint" if act.signed else "split")


def outer_accumulator_bits(p_inner: int, k: int, tile: int,
                           sparsity: str | None = None) -> int:
    """P_O = ceil(P_I + log2(K) - log2(T))   (Eq. 22)."""
    k = effective_depth(k, sparsity)
    tile = effective_depth(tile, sparsity)
    if k < tile:
        tile = k
    return int(math.ceil(p_inner + math.log2(k) - math.log2(tile)))


def num_tiles(k: int, tile: int) -> int:
    return (k + tile - 1) // tile


def worst_case_dot_bounds(pos_sum: float, neg_sum: float,
                          act: Alphabet) -> tuple[float, float]:
    """Worst-case (min, max) of x.q over x in A_N^K given the positive sum
    ``pos_sum`` >= 0 and the negative sum ``neg_sum`` <= 0 of q (Eq. 6)."""
    hi = act.nu * pos_sum + act.mu * neg_sum
    lo = act.mu * pos_sum + act.nu * neg_sum
    return lo, hi
