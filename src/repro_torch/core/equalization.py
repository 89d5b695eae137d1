"""Graph equalization (SmoothQuant) and bias correction (port of
``repro/core/equalization.py``; paper §C.1).

Functionally invariant rewrites of the float network: for a linear with a
foldable preceding scale, ``(x / s) @ (diag(s) W) == x @ W``; bias
correction absorbs the expected quantization error E[x]^T (W - W_q) into
the bias.
"""

from __future__ import annotations

import torch


def smoothquant_scales(act_absmax: torch.Tensor, weight_absmax: torch.Tensor,
                       alpha: float = 0.5, eps: float = 1e-5) -> torch.Tensor:
    """s_j = max|X_j|^alpha / max|W_j.|^(1-alpha), clipped to [eps, 1/eps]."""
    a = torch.clamp(torch.as_tensor(act_absmax), min=eps)
    w = torch.clamp(torch.as_tensor(weight_absmax), min=eps)
    s = torch.pow(a, alpha) / torch.pow(w, 1.0 - alpha)
    return torch.clamp(s, eps, 1.0 / eps)


def equalize_linear(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Scale the rows (input dims) of ``w`` (K, C) by ``s`` (K,)."""
    return w * s[:, None]


def equalize_norm_weight(norm_w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fold 1/s into the preceding norm's elementwise weight."""
    return norm_w / s


def equalize_norm_bias(norm_b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return norm_b / s


def bias_correction(x_mean: torch.Tensor, w: torch.Tensor, w_q: torch.Tensor,
                    bias: torch.Tensor | None) -> torch.Tensor:
    """b' = b + E[x]^T (W - W_q): the corrected (C,) bias."""
    delta = x_mean @ (w - w_q)
    return delta if bias is None else bias + delta
