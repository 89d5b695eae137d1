"""Quantization alphabets (port of the alphabet part of
``repro/core/alphabet.py``; the accumulator-bound algebra arrives with the
calibration slice).

Signed M-bit sign-magnitude weight alphabet
``{-(2^(M-1)-1), ..., 2^(M-1)-1}``; activation alphabet unsigned asymmetric
``{0, ..., 2^N-1}`` or signed symmetric.
"""

from __future__ import annotations

from dataclasses import dataclass


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
