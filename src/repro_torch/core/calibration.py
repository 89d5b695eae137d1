"""Streaming calibration statistics (port of ``repro/core/calibration.py``;
paper App. B's memory argument).

:class:`LayerStats` accumulates the square-matrix sufficient statistics of
one linear layer a batch at a time, on the device of its inputs:

    h_raw = sum_b Xq_b^T Xq_b        g_raw = sum_b X_b^T Xq_b

plus the input mean (bias correction) and an :class:`ActObserver`
(percentile activation range, per-dim abs-max). Memory is O(K^2) whatever
the number of samples. Batches are (n, K) row-major activations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .alphabet import Alphabet
from .quantizers import ActQuantParams, calibrate_act_quant


@dataclass
class ActObserver:
    """Per-tensor activation range observer (running mean of per-batch
    percentiles, Brevitas-style) plus per-dim abs-max.

    :meth:`update` runs on the host in numpy float64, exactly as the
    reference does (``np.percentile``): each site input is copied to the
    host once, by design, so the calibrated range is the reference's to the
    last bit. It is not a fallback of a device path."""

    k: int
    percentile: float = 99.0
    n_batches: int = 0
    lo_sum: float = 0.0
    hi_sum: float = 0.0
    min_seen: float = float("inf")
    max_seen: float = -float("inf")
    dim_absmax: np.ndarray = field(default=None)  # (K,)

    def __post_init__(self):
        if self.dim_absmax is None:
            self.dim_absmax = np.zeros((self.k,), np.float64)

    def update(self, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().to(torch.float64).cpu().numpy()
        x = np.asarray(x, np.float64).reshape(-1, self.k)
        lo, hi = np.percentile(x, [100.0 - self.percentile, self.percentile])
        self.lo_sum += float(lo)
        self.hi_sum += float(hi)
        self.n_batches += 1
        self.min_seen = min(self.min_seen, float(x.min()))
        self.max_seen = max(self.max_seen, float(x.max()))
        np.maximum(self.dim_absmax, np.abs(x).max(axis=0), out=self.dim_absmax)

    @property
    def lo(self) -> float:
        return self.lo_sum / max(self.n_batches, 1)

    @property
    def hi(self) -> float:
        return self.hi_sum / max(self.n_batches, 1)

    def act_quant(self, alphabet: Alphabet) -> ActQuantParams:
        return calibrate_act_quant(self.lo, self.hi, alphabet)

    def snapshot(self) -> dict:
        """Plain-data summary of everything this observer saw."""
        seen = self.n_batches > 0
        return {
            "k": self.k,
            "percentile": self.percentile,
            "n_batches": self.n_batches,
            "lo": self.lo,
            "hi": self.hi,
            "min_seen": self.min_seen if seen else 0.0,
            "max_seen": self.max_seen if seen else 0.0,
            "absmax": float(self.dim_absmax.max()) if seen else 0.0,
        }


@dataclass
class LayerStats:
    """Streaming sufficient statistics for one linear layer (input dim K),
    as f32 tensors on ``device``."""

    k: int
    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cpu"
    n_samples: int = 0
    h_raw: torch.Tensor = None  # (K, K) sum Xq^T Xq
    g_raw: torch.Tensor = None  # (K, K) sum X^T Xq
    x_sum: torch.Tensor = None  # (K,)   sum of analog inputs
    observer: ActObserver = None

    def __post_init__(self):
        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        if self.h_raw is None:
            self.h_raw = zeros(self.k, self.k)
        if self.g_raw is None:
            self.g_raw = zeros(self.k, self.k)
        if self.x_sum is None:
            self.x_sum = zeros(self.k)
        if self.observer is None:
            self.observer = ActObserver(k=self.k)

    def update(self, x: torch.Tensor, xq: torch.Tensor | None = None) -> None:
        """Accumulate one batch: ``x`` (n, K) analog inputs, ``xq`` their
        quantized-network counterparts (default ``x``)."""
        x = x.reshape(-1, self.k).to(self.dtype)
        xq = x if xq is None else xq.reshape(-1, self.k).to(self.dtype)
        self.h_raw = self.h_raw + xq.T @ xq
        self.g_raw = self.g_raw + x.T @ xq
        self.x_sum = self.x_sum + torch.sum(x, dim=0)
        self.n_samples += x.shape[0]
        self.observer.update(x)

    @property
    def x_mean(self) -> torch.Tensor:
        return self.x_sum / max(self.n_samples, 1)

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.k, dtype=self.dtype, device=self.h_raw.device)

    def optq_hessian(self, damp_frac: float = 0.01) -> torch.Tensor:
        """2 Xq Xq^T + eta I (Algorithm 2's proxy)."""
        h = 2.0 * self.h_raw
        eta = damp_frac * torch.mean(torch.diag(h)) + 1e-12
        return h + eta * self._eye()

    def gpfq_stats(self, eta: float = 1e-6):
        """(H, G) of Theorem B.1 with H = (h_raw + eta*mean_diag*I)^(1/2)."""
        damp = eta * torch.mean(torch.diag(self.h_raw)) + 1e-12
        evals, evecs = torch.linalg.eigh(self.h_raw + damp * self._eye())
        h_half = (evecs * torch.sqrt(torch.clamp(evals, min=0.0))) @ evecs.T
        return h_half, self.g_raw

    def memory_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (2 * self.k * self.k + self.k) * itemsize
