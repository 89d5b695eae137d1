"""GPFQ with accumulator-aware extensions (port of ``repro/core/gpfq.py``;
paper §3.2, Algorithm 1) and the memory-efficient square-matrix form
(Theorem B.1).

All greedy state runs in the integer weight domain: real weights are
divided by their per-channel scale first, so the l1 budgets of Eq. 21 and
the soft threshold of Eq. 16 are exact integer-unit quantities.

Shapes follow Algorithm 1: W (K, C) rows = input dims, X (K, D) samples of
the analog network, Xq (K, D) of the quantized network. The
memory-efficient path replaces (X, Xq) by (G H^-1, H) with
H = (Xq Xq^T + eta I)^(1/2) and G = X Xq^T, both (K, K).

The greedy loop is kernel B5: :func:`_gpfq_loop` hands every dense solve to
:func:`repro_torch.kernels.gpfq_solve.gpfq_solve`, which launches the CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.kernels.gpfq_solve import gpfq_solve

from .alphabet import Alphabet, Budgets, l1_budget_zero_centered, strict_budgets
from .ep_init import l1_projection_threshold, soft_threshold, tiled
from .quantizers import (
    ROUND_NEAREST,
    ROUNDING_SLACK,
    quantize_int,
    to_int_domain,
    weight_scales,
)
from .sparsity import mask_2to4, validate_sparsity


@dataclass(frozen=True)
class AxeConfig:
    """Accumulator-aware extension knobs (paper §3.3). ``p_bits`` is the
    inner accumulator width when ``tile`` is set, the monolithic one
    otherwise; ``soft``/``strict`` toggle the two constraints."""

    p_bits: int
    tile: int | None = None
    soft: bool = True
    strict: bool = True
    z_multiplier: float = 1.0


@dataclass
class GreedyResult:
    q_int: torch.Tensor  # (K, C) integer-domain codes (float carrier)
    scale: torch.Tensor  # (1, C) per-channel scale
    w_alphabet: Alphabet
    act_alphabet: Alphabet | None = None
    axe: AxeConfig | None = None
    aux: dict = field(default_factory=dict)

    @property
    def w_q(self) -> torch.Tensor:
        """Dequantized real-domain weights."""
        return self.q_int * self.scale


def make_axe_state(w_int: torch.Tensor, axe: AxeConfig | None,
                   act_alphabet: Alphabet | None, rounding: str, k: int):
    """(lambda, budgets, tile ids) for the greedy loop, or None without AXE:
    ``lam`` (n_tiles, C) soft thresholds, scalars ``A``/``B`` (Eq. 21),
    ``mode``, ``strict``, ``tile_ids`` (K,) and zero ``pos``/``neg``."""
    if axe is None:
        return None
    if act_alphabet is None:
        raise ValueError("AXE requires quantized activations (paper §3.3)")
    K, C = w_int.shape
    tile = axe.tile or k
    n_tiles = (k + tile - 1) // tile
    tile_ids = torch.arange(K, device=w_int.device) // tile
    budgets: Budgets = strict_budgets(axe.p_bits, act_alphabet, ROUNDING_SLACK[rounding])
    if axe.soft:
        z = axe.z_multiplier * l1_budget_zero_centered(axe.p_bits, act_alphabet)
        lam = l1_projection_threshold(tiled(w_int.T, tile), z).T  # (n_tiles, C)
    else:
        lam = torch.zeros((n_tiles, C), dtype=w_int.dtype, device=w_int.device)
    zeros = torch.zeros((n_tiles, C), dtype=w_int.dtype, device=w_int.device)
    return {
        "lam": lam,
        "A": budgets.A,
        "B": budgets.B,
        "mode": budgets.mode,
        "strict": axe.strict,
        "tile_ids": tile_ids,
        "pos": zeros,
        "neg": zeros.clone(),
    }


def constrained_value(v, t: int, lam, A, B, pos, neg, *, strict: bool, mode: str):
    """Pi_lambda then Psi_{a,b} for one row (Eq. 18): the value the
    quantizer rounds. ``pos``/``neg`` (n_tiles, C) are the committed sums;
    the clip interval always contains 0, so a spent budget never forces a
    nonzero code."""
    v = soft_threshold(v, lam[t])
    if strict:
        pos_t, neg_t = pos[t], neg[t]
        if mode == "split":
            lo = torch.clamp(A - neg_t, max=0.0)
            hi = torch.clamp(B - pos_t, min=0.0)
        else:  # joint l1 budget (signed activations)
            rem = torch.clamp(B - (pos_t - neg_t), min=0.0)
            lo, hi = -rem, rem
        v = torch.minimum(torch.maximum(v, lo), hi)
    return v


def constrain_row(v, t: int, lam, A, B, pos, neg, *, strict: bool, mode: str,
                  alphabet: Alphabet, rounding: str):
    """:func:`constrained_value`, then Q, plus the budget bookkeeping of
    Eqs. 19-20 (``pos``/``neg`` updated in place). Returns (q_row, pos,
    neg). The OPTQ loop calls it; the GPFQ loop runs the same steps inside
    kernel B5 and its plain version."""
    v = constrained_value(v, t, lam, A, B, pos, neg, strict=strict, mode=mode)
    q = quantize_int(v, alphabet, rounding)
    pos[t] += torch.clamp(q, min=0.0)
    neg[t] += torch.clamp(q, max=0.0)
    return q, pos, neg


def _gpfq_loop(w_int, xg, xh, state, *, w_bits: int, w_signed: bool, rounding: str,
               mask=None):
    """The greedy loop on rows already in solve order (``state`` as from
    :func:`make_axe_state`, tile ids permuted alike, or None; ``mask`` the
    (K, C) 2:4 support permuted alike, or None): kernel B5. Returns (Q, U,
    pos, neg)."""
    if not w_signed:
        raise ValueError("GPFQ codes use the signed symmetric weight alphabet")
    C = w_int.shape[1]
    if state is None:
        lam = torch.zeros((1, C), dtype=torch.float32, device=w_int.device)
        tile_ids = torch.zeros((w_int.shape[0],), dtype=torch.int32, device=w_int.device)
        return gpfq_solve(w_int, xg, xh, lam, tile_ids, 0.0, 0.0, w_bits=w_bits, mode="plain",
                          rounding=rounding, mask=mask)
    mode = state["mode"] if state["strict"] else "soft"
    return gpfq_solve(w_int, xg, xh, state["lam"], state["tile_ids"], state["A"], state["B"],
                      w_bits=w_bits, mode=mode, rounding=rounding, mask=mask)


def _prepare(w, w_alphabet):
    scale = weight_scales(w, w_alphabet)  # (1, C)
    return to_int_domain(w, scale), scale


def act_order_permutation(xh: torch.Tensor) -> torch.Tensor:
    """Rows in descending diagonal of the Hessian proxy 2 Xq Xq^T (row norms
    of Xq); stable, as ``jnp.argsort``."""
    return torch.argsort(-torch.sum(xh * xh, dim=1), stable=True)


def _run(w, xg, xh, w_alphabet: Alphabet, act_alphabet: Alphabet | None,
         axe: AxeConfig | None, rounding: str, act_order: bool, sparsity: str | None = None):
    validate_sparsity(sparsity)
    w_int, scale = _prepare(w, w_alphabet)
    K = w.shape[0]
    state = make_axe_state(w_int, axe, act_alphabet, rounding, K)
    # the 2:4 mask ranks the integer-domain target in the original K order,
    # so the pattern survives the act_order permutation of the solve
    mask = mask_2to4(w_int) if sparsity is not None else None
    order = act_order_permutation(xh) if act_order else torch.arange(K, device=w.device)
    inv_order = torch.argsort(order)
    if state is not None:
        state = dict(state, tile_ids=state["tile_ids"][order])
    q_perm, U, pos, neg = _gpfq_loop(w_int[order], xg[order], xh[order], state,
                                     w_bits=w_alphabet.bits, w_signed=w_alphabet.signed,
                                     rounding=rounding,
                                     mask=None if mask is None else mask[order])
    aux = {"residual_norm": torch.linalg.norm(U), "pos": pos, "neg": neg}
    return GreedyResult(q_int=q_perm[inv_order], scale=scale, w_alphabet=w_alphabet,
                        act_alphabet=act_alphabet, axe=axe, aux=aux)


def gpfq(w, x, xq, w_alphabet: Alphabet, act_alphabet: Alphabet | None = None,
         axe: AxeConfig | None = None, rounding: str = ROUND_NEAREST,
         act_order: bool = False, sparsity: str | None = None) -> GreedyResult:
    """Standard GPFQ (Algorithm 1). ``x``/``xq``: (K, D) sample rows."""
    if w.shape[0] != x.shape[0] or x.shape != xq.shape:
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, x {tuple(x.shape)}, "
                         f"xq {tuple(xq.shape)}")
    return _run(w, x, xq, w_alphabet, act_alphabet, axe, rounding, act_order, sparsity)


def me_stats(x: torch.Tensor, xq: torch.Tensor, eta: float = 1e-6):
    """(H, G) of Theorem B.1 from samples: H = (Xq Xq^T +
    eta*mean_diag*I)^(1/2), G = X Xq^T."""
    hh = xq @ xq.T
    damp = eta * torch.mean(torch.diag(hh)) + 1e-12
    hh = hh + damp * torch.eye(hh.shape[0], dtype=hh.dtype, device=hh.device)
    evals, evecs = torch.linalg.eigh(hh)
    h_half = (evecs * torch.sqrt(torch.clamp(evals, min=0.0))) @ evecs.T
    return h_half, x @ xq.T


def gh_inverse(h_half: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """G H^-1 as (H^-1 G^T)^T (H symmetric PSD)."""
    return torch.linalg.solve(h_half, g.T).T


def gpfq_memory_efficient(w, h_half, g, w_alphabet: Alphabet,
                          act_alphabet: Alphabet | None = None, axe: AxeConfig | None = None,
                          rounding: str = ROUND_NEAREST, act_order: bool = False,
                          sparsity: str | None = None) -> GreedyResult:
    """Memory-efficient GPFQ (Theorem B.1): GPFQ(W, G H^-1, H)."""
    k = w.shape[0]
    if h_half.shape != (k, k) or g.shape != (k, k):
        raise ValueError("h_half and g must be (K, K)")
    return _run(w, gh_inverse(h_half, g), h_half, w_alphabet, act_alphabet, axe, rounding,
                act_order, sparsity)


__all__ = [
    "AxeConfig",
    "GreedyResult",
    "act_order_permutation",
    "constrain_row",
    "constrained_value",
    "gh_inverse",
    "gpfq",
    "gpfq_memory_efficient",
    "make_axe_state",
    "me_stats",
]
