"""Euclidean l1-ball projection, the Lagrangian threshold lambda (Eqs.
15-16) and the EP-init baseline (port of ``repro/core/ep_init.py``).

For w in R^K and radius Z (Duchi et al., 2008):
``v*_i = sign(w_i) * max(|w_i| - lambda, 0)`` with
``lambda = (sum_{i<=rho} mu_i - Z) / rho``, mu = sort(|w|, desc) and rho
the number of non-zeros of v*. Channel and tile axes lead; the reduction
axis is the last one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .alphabet import Alphabet
from .quantizers import ROUND_ZERO, quantize_int


def soft_threshold(x: torch.Tensor, lam) -> torch.Tensor:
    """Pi_lambda(x) = sign(x) * relu(|x| - lambda)."""
    return torch.sign(x) * torch.relu(torch.abs(x) - lam)


def l1_projection_threshold(w: torch.Tensor, radius) -> torch.Tensor:
    """Lagrangian lambda (shape ``w.shape[:-1]``, >= 0) of the projection of
    ``w`` (..., K) onto the l1 ball of ``radius``; 0 iff ||w||_1 <= radius."""
    radius = torch.broadcast_to(torch.as_tensor(radius, dtype=w.dtype, device=w.device),
                                w.shape[:-1])
    k = w.shape[-1]
    mu = torch.sort(torch.abs(w), dim=-1, descending=True).values
    cssv = torch.cumsum(mu, dim=-1) - radius[..., None]
    idx = torch.arange(1, k + 1, dtype=w.dtype, device=w.device)
    rho = torch.sum(mu * idx > cssv, dim=-1)  # rho = max{j : mu_j > (cumsum_j - Z)/j}
    rho_safe = torch.clamp(rho, min=1)
    gathered = torch.gather(cssv, -1, (rho_safe - 1)[..., None])[..., 0]
    lam = gathered / rho_safe.to(w.dtype)
    inside = torch.sum(torch.abs(w), dim=-1) <= radius
    return torch.where(inside, torch.zeros_like(lam), torch.clamp(lam, min=0.0))


def project_l1_ball(w: torch.Tensor, radius) -> torch.Tensor:
    """Euclidean projection of ``w`` (..., K) onto the l1 ball of ``radius``."""
    return soft_threshold(w, l1_projection_threshold(w, radius)[..., None])


def ep_init(w_int: torch.Tensor, radius, alphabet: Alphabet) -> torch.Tensor:
    """EP-init baseline (A2Q+ applied post-training, paper §2.3): project
    each row of ``w_int`` (..., K) onto the l1 ball and round toward zero,
    so ||q||_1 <= ||v||_1 <= radius. No error correction."""
    return quantize_int(project_l1_ball(w_int, radius), alphabet, rounding=ROUND_ZERO)


def tiled(w_int: torch.Tensor, tile: int) -> torch.Tensor:
    """(..., K) -> (..., n_tiles, T), zero-padding K to a tile multiple (zeros
    carry no l1 mass and add nothing to a dot product)."""
    k = w_int.shape[-1]
    n_tiles = (k + tile - 1) // tile
    pad = n_tiles * tile - k
    if pad:
        w_int = F.pad(w_int, (0, pad))
    return w_int.reshape(*w_int.shape[:-1], n_tiles, tile)


def untiled(w_tiles: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`tiled`: flatten tiles and strip the padding."""
    return w_tiles.reshape(*w_tiles.shape[:-2], -1)[..., :k]
