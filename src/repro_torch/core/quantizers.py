"""Uniform quantizers on tensors (port of ``repro/core/quantizers.py``;
paper Eq. 1, §C.1).

Two domains: the real domain (float weights and activations) and the
integer domain (elements of an :class:`~repro_torch.core.alphabet.Alphabet`,
float-carried). The solvers and the accumulator bookkeeping run in the
integer domain: weights are divided by their per-channel scale first, so the
budgets of Eq. 21 are exact integer-unit quantities.

Divisions by a scale take the scale as a tensor on the operand's device:
CUDA turns division by a host scalar into a multiply by its reciprocal,
which rounds differently from the reference's true division.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .alphabet import Alphabet

ROUND_NEAREST = "nearest"
ROUND_ZERO = "zero"

ROUNDING_SLACK = {ROUND_NEAREST: 0.5, ROUND_ZERO: 0.0}


def round_fn(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == ROUND_NEAREST:
        return torch.round(x)  # half to even, as jnp.rint
    if mode == ROUND_ZERO:
        return torch.trunc(x)
    raise ValueError(f"unknown rounding mode {mode!r}")


def quantize_int(x: torch.Tensor, alphabet: Alphabet,
                 rounding: str = ROUND_NEAREST) -> torch.Tensor:
    """Integer-domain quantizer: round then clip to the alphabet (float carrier)."""
    return torch.clamp(round_fn(x, rounding), alphabet.qmin, alphabet.qmax)


def weight_scales(w: torch.Tensor, alphabet: Alphabet, axis: int = 0,
                  eps: float = 1e-12) -> torch.Tensor:
    """s = max|w| / (2^(M-1)-1) per output channel; ``w`` is (K, C) with the
    reduction over ``axis`` (default 0 = input dim), kept as a size-1 dim."""
    absmax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    return torch.clamp(absmax / float(alphabet.qmax), min=eps)


def to_int_domain(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w / scale


def from_int_domain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q * scale


def quantize_weights_rtn(w: torch.Tensor, alphabet: Alphabet,
                         rounding: str = ROUND_NEAREST):
    """Direct (non-greedy) weight quantization: (q_int, scale)."""
    scale = weight_scales(w, alphabet)
    return quantize_int(to_int_domain(w, scale), alphabet, rounding), scale


@dataclass(frozen=True)
class ActQuantParams:
    """Per-tensor activation quantizer: x_int = clip(round(x/s) + z)."""

    scale: float
    zero_point: int
    bits: int
    signed: bool = False

    @property
    def alphabet(self) -> Alphabet:
        return Alphabet(bits=self.bits, signed=self.signed, symmetric=True)


def calibrate_act_quant(lo: float, hi: float, alphabet: Alphabet) -> ActQuantParams:
    """(scale, zero_point) from a calibrated real range [lo, hi]; zero is
    always exactly representable."""
    lo = min(float(lo), 0.0)
    hi = max(float(hi), 0.0)
    span = max(hi - lo, 1e-12)
    if alphabet.signed:
        scale = max(abs(lo), abs(hi)) / float(alphabet.qmax)
        return ActQuantParams(scale=max(scale, 1e-12), zero_point=0,
                              bits=alphabet.bits, signed=True)
    scale = span / float(alphabet.span)
    zero_point = max(0, min(alphabet.qmax, int(round(-lo / scale))))
    return ActQuantParams(scale=scale, zero_point=zero_point,
                          bits=alphabet.bits, signed=False)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_act(x: torch.Tensor, p: ActQuantParams) -> torch.Tensor:
    """Real -> integer activation codes (float carrier)."""
    alpha = p.alphabet
    q = torch.round(x / _scalar(p.scale, x)) + float(p.zero_point)
    return torch.clamp(q, alpha.qmin, alpha.qmax)


def dequantize_act(xq: torch.Tensor, p: ActQuantParams) -> torch.Tensor:
    return (xq - float(p.zero_point)) * _scalar(p.scale, xq)


def fake_quantize_act(x: torch.Tensor, p: ActQuantParams) -> torch.Tensor:
    """Quantize-dequantize (simulated integer activation path)."""
    return dequantize_act(quantize_act(x, p), p)
