"""OPTQ / GPTQ with accumulator-aware extensions (port of
``repro/core/optq.py``; paper Algorithm 2).

Same conventions as :mod:`repro_torch.core.gpfq`: W is (K, C), the loop runs
in the integer weight domain and the AXE constraints apply per row before
quantization, with the error propagated through the inverse-Hessian
Cholesky factor. Plain PyTorch on either device: the reference has no
Pallas kernel for OPTQ (its loop is a ``lax.fori_loop``).
"""

from __future__ import annotations

import torch

from .alphabet import Alphabet
from .sparsity import mask_2to4, validate_sparsity
from .gpfq import (
    AxeConfig,
    GreedyResult,
    constrain_row,
    constrained_value,
    make_axe_state,
)
from .quantizers import ROUND_NEAREST, quantize_int, to_int_domain, weight_scales


def hessian_proxy(xq: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """H = 2 Xq Xq^T + eta I with eta = damp_frac * mean(diag)."""
    h = 2.0 * (xq @ xq.T)
    eta = damp_frac * torch.mean(torch.diag(h)) + 1e-12
    return h + eta * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)


def inverse_cholesky(h: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R with H^-1 = R^T R."""
    h_inv = torch.linalg.inv(h)
    h_inv = 0.5 * (h_inv + h_inv.T)  # symmetrize against numerical drift
    return torch.linalg.cholesky(h_inv).T


def _optq_loop(w_int, hinv_u, state, *, w_bits: int, rounding: str, return_v: bool = False,
               mask=None):
    """OPTQ's row loop on rows in solve order. Returns (Q, pos, neg), plus
    the pre-rounding values V (K, C) when ``return_v``. ``w_int`` is updated
    in place (the caller passes a permuted copy). ``mask`` (K, C) {0, 1}, in
    solve order, makes row i target ``w_i * m_i``; the error keeps the
    unmasked ``w_i``, so the pruned weight flows into later rows."""
    K, C = w_int.shape
    alphabet = Alphabet(bits=w_bits, signed=True, symmetric=True)
    f32 = dict(dtype=w_int.dtype, device=w_int.device)
    Q = torch.empty((K, C), **f32)
    V = torch.empty((K, C), **f32) if return_v else None
    if state is None:
        pos, neg = torch.zeros((1, C), **f32), torch.zeros((1, C), **f32)
    else:
        pos, neg = state["pos"].clone(), state["neg"].clone()
        tids = state["tile_ids"].tolist()
    col = torch.arange(K, device=w_int.device)
    for i in range(K):
        w_i = w_int[i].clone()
        target = w_i if mask is None else w_i * mask[i]
        if state is None:
            q = quantize_int(target, alphabet, rounding)
            if return_v:
                V[i] = target
        else:
            args = (target, tids[i], state["lam"], state["A"], state["B"])
            mode = dict(strict=state["strict"], mode=state["mode"])
            if return_v:  # the value constrain_row rounds, before it commits
                V[i] = constrained_value(*args, pos, neg, **mode)
            q, pos, neg = constrain_row(*args, pos, neg, **mode, alphabet=alphabet,
                                        rounding=rounding)
        err = (w_i - q) / hinv_u[i, i]
        # propagate to the rows not yet quantized (j > i) only
        row = torch.where(col > i, hinv_u[i, :], torch.zeros_like(hinv_u[i, :]))
        w_int -= torch.outer(row, err)
        Q[i] = q
    return (Q, pos, neg, V) if return_v else (Q, pos, neg)


def optq_setup(w, hessian, w_alphabet, act_alphabet, axe, rounding, act_order,
               sparsity: str | None = None):
    """(w_int permuted, scale, state with permuted tile ids, inverse-Cholesky
    factor of the permuted H, inv_order, permuted 2:4 mask or None):
    everything the loop needs. The mask ranks the unpermuted ``w_int``."""
    K = w.shape[0]
    scale = weight_scales(w, w_alphabet)
    w_int = to_int_domain(w, scale)
    state = make_axe_state(w_int, axe, act_alphabet, rounding, K)
    mask = mask_2to4(w_int) if sparsity is not None else None
    order = (torch.argsort(-torch.diag(hessian), stable=True) if act_order
             else torch.arange(K, device=w.device))
    if state is not None:
        state = dict(state, tile_ids=state["tile_ids"][order])
    hinv_u = inverse_cholesky(hessian[order][:, order])
    return (w_int[order].clone(), scale, state, hinv_u, torch.argsort(order),
            None if mask is None else mask[order])


def optq(w, hessian, w_alphabet: Alphabet, act_alphabet: Alphabet | None = None,
         axe: AxeConfig | None = None, rounding: str = ROUND_NEAREST, act_order: bool = True,
         sparsity: str | None = None) -> GreedyResult:
    """OPTQ with optional AXE constraints (Algorithm 2). ``hessian``: the
    damped (K, K) proxy; ``act_order`` quantizes rows in descending diag(H);
    ``sparsity="2:4"`` fixes a magnitude mask before the solve."""
    K = w.shape[0]
    if hessian.shape != (K, K):
        raise ValueError(f"hessian must be ({K}, {K}), got {tuple(hessian.shape)}")
    validate_sparsity(sparsity)
    w_perm, scale, state, hinv_u, inv_order, mask = optq_setup(
        w, hessian, w_alphabet, act_alphabet, axe, rounding, act_order, sparsity)
    q_perm, pos, neg = _optq_loop(w_perm, hinv_u, state, w_bits=w_alphabet.bits,
                                  rounding=rounding, mask=mask)
    return GreedyResult(q_int=q_perm[inv_order], scale=scale, w_alphabet=w_alphabet,
                        act_alphabet=act_alphabet, axe=axe, aux={"pos": pos, "neg": neg})


__all__ = ["hessian_proxy", "inverse_cholesky", "optq"]
