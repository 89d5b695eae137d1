"""Mixture-of-Experts FFN with GShard-style grouped dispatch (port of
``repro/models/moe.py``): top-k routing, capacity-bounded per group, einsum
dispatch and combine, the Switch load-balance auxiliary loss.

Tokens are cut into G groups of g; in each group every expert takes at most
C tokens, earlier tokens first (token-major: a batched decode step's rows
compete in slot order, idle slots included). The experts' weights are
stacked (E, K, C): a float :class:`~repro_torch.models.layers.Linear` or a
stacked :class:`~repro_torch.models.layers.PackedLinear`, whose W4A8 path
runs all E experts of a site in one launch of the expert-axis kernel
(:func:`~repro_torch.kernels.w4a8_mm.w4a8_expert_matmul`), as the
reference's ``jax.vmap(packed_linear)`` runs one batched Pallas call.

Under a mesh (:func:`~repro_torch.runtime.sharding.shard_model`) the
stacked sites hold a rank's experts (expert parallelism, the ``expert``
axis where it shards E) and, inside them, the columns and rows of tensor
parallelism (wg/wu N-sharded, wd K-sharded); see :func:`moe`.

Every shape here is static and nothing reads the host, so a decode step
with MoE blocks is captured as a CUDA graph like a dense one. The routing
follows the reference where torch differs from JAX:

  * the router logits are ``x @ router`` in the activation dtype, then
    cast to f32, as the reference computes them;
  * top-k is a stable descending sort cut to k, so on ties the lower
    expert index comes first, as ``jax.lax.top_k`` puts it;
  * one-hots are built by comparison: a queue position past the capacity
    gives a zero row, as ``jax.nn.one_hot`` gives, where ``F.one_hot``
    would raise (and read the host on CUDA).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.runtime.collectives import relayout

from .config import ModelConfig
from .layers import pmm


class MoE(nn.Module):
    """The MoE FFN's modules: ``router`` (a float :class:`Linear` of (d, E))
    and the expert-stacked sites ``wg``/``wu``/``wd`` (SwiGLU) or
    ``wi``/``wd`` (GELU), each of (E, K, C)."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, mod in modules.items():
            setattr(self, name, mod)


def expert_capacity(cfg: ModelConfig, group: int) -> int:
    mo = cfg.moe
    c = int(math.ceil(group * mo.top_k * mo.capacity_factor / mo.n_experts))
    return max(4, min(c, group))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over the last axis by comparison: zeros where ``idx`` is
    outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _dispatch_combine(gates_topv, gates_topi, e: int, c: int):
    """(G, g, E, C) dispatch (0/1) and combine (gate-weighted) arrays from
    the (G, g, k) top-k gates and experts. Token-major priority: earlier
    tokens in the group win capacity slots; assignments past the capacity
    are dropped with their gate mass."""
    G, g, k = gates_topi.shape
    onehot = _one_hot(gates_topi, e, torch.int32)  # (G, g, k, E)
    flat = onehot.reshape(G, g * k, e)
    pos = torch.cumsum(flat, dim=1) - flat  # rank within the expert's queue
    keep = (pos < c) & (flat > 0)
    pos = pos.reshape(G, g, k, e)
    keep = keep.reshape(G, g, k, e)
    pos_oh = _one_hot(pos, c, gates_topv.dtype) * keep[..., None].to(gates_topv.dtype)
    combine = torch.einsum("gsk,gskec->gsec", gates_topv, pos_oh)
    dispatch = (combine > 0).to(gates_topv.dtype)
    return dispatch, combine


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties broken
    toward the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


_split = threading.local()


@contextmanager
def split_routing(rows: int, row0: int):
    """Route a rank's rows ``[row0, row0 + B)`` of a batch of ``rows`` rows
    as the whole batch routes them: the group size and capacity come from
    the whole batch's token count, and a rank whose rows would cut a group
    raises. Inside, :func:`moe` gives a zero loss and appends each block's
    (top-1 expert counts (E,), summed router probabilities (E,)) over this
    rank's tokens to the list yielded, from which the caller forms the
    whole batch's load-balance loss
    (:func:`~repro_torch.models.transformer.loss_fn` with ``split``)."""
    stats: list = []
    prev = getattr(_split, "active", None)
    _split.active = (rows, row0, stats)
    try:
        yield stats
    finally:
        _split.active = prev


def current_split():
    """This thread's split routing (:func:`split_routing`), or None."""
    return getattr(_split, "active", None)


@contextmanager
def replay_split(active):
    """Route as the split ``active`` (:func:`current_split`'s, or None)
    routes, for a rerun of a computation that ran under it (a checkpoint's
    recompute, on whatever thread autograd runs it): the same group size
    and capacity, the statistics discarded, since the first run appended
    them."""
    prev = getattr(_split, "active", None)
    _split.active = None if active is None else (active[0], active[1], [])
    try:
        yield
    finally:
        _split.active = prev


def route(router_w, x, cfg: ModelConfig):
    """Group tokens and build the routing tensors (shared by the model and
    the PTQ adapter, which must route identically).

    x: (B, S, d). Returns (xf (G, g, d), dispatch, combine, gates, topi, c)."""
    mo = cfg.moe
    B, S, d = x.shape
    n_tok = B * S
    active = getattr(_split, "active", None)
    total, first = (n_tok, 0) if active is None else (active[0] * S, active[1] * S)
    g = min(mo.group_size, total)
    if total % g:
        g = math.gcd(total, g)
    if first % g or n_tok % g:
        raise ValueError(f"this rank's tokens [{first}, {first + n_tok}) of the batch's {total} "
                         f"cut a routing group of {g} tokens: the rows a rank holds must be "
                         f"whole groups")
    G = n_tok // g
    c = expert_capacity(cfg, g)
    xf = x.reshape(G, g, d)
    dt = torch.promote_types(xf.dtype, router_w.dtype)
    logits = (xf.to(dt) @ router_w.to(dt)).to(torch.float32)  # (G, g, E)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, mo.top_k)
    topv = topv / torch.clamp(torch.sum(topv, dim=-1, keepdim=True), min=1e-9)
    dispatch, combine = _dispatch_combine(topv.to(x.dtype), topi, mo.n_experts, c)
    return xf, dispatch, combine, gates, topi, c


def expert_matmul(p: MoE, name: str, xe, have=(), want=()):
    """The stacked site ``name`` on the dispatched tokens: xe (E, G, C, K)
    -> (E, G, C, N). The site sees its experts' rows as (E, G*C, K), as the
    reference's vmapped ``packed_linear`` does; a packed site adds its
    stacked bias (E, 1, N) on every backend. Under a mesh ``xe`` holds the
    site's experts, its last dim in layout ``have``, and the output's last
    dim is relaid to ``want`` (:func:`~repro_torch.models.layers.pmm`)."""
    E, G, C, D = xe.shape
    return pmm(p, name, xe.reshape(E, G * C, D), have, want).reshape(E, G, C, -1)


def moe(p: MoE, x, cfg: ModelConfig, *, aux: bool = True):
    """x: (B, S, d) -> (y (B, S, d), the Switch load-balance loss (0-d f32,
    None with ``aux=False``: decode steps skip it)).

    Under a mesh the tokens are replicated, so routing runs whole on every
    rank. A rank dispatches to its experts ``[e_lo, e_hi)`` alone (each
    dispatched row has one token or none: exact in any order), runs the
    three sites on them (the hidden layer in wd's K layout), gathers ``ye``
    over the expert axes and combines over all E, as the one-device model
    does: a token's top-k expert terms are summed in the one-device order,
    so the output is the one-device output bit for bit."""
    mo = cfg.moe
    B, S, d = x.shape
    xf, dispatch, combine, gates, topi, _ = route(p.router.w, x, cfg)
    sh = getattr(p.wd, "_shard", None)
    mid = ()
    if sh is not None:  # this rank's experts; the hidden layer in wd's K layout
        lo, hi = sh.experts(mo.n_experts)
        dispatch, mid = dispatch[:, :, lo:hi], sh.k
    xe = torch.einsum("gsec,gsd->egcd", dispatch, xf)
    if cfg.act == "swiglu":
        h = F.silu(expert_matmul(p, "wg", xe, want=mid)) * expert_matmul(p, "wu", xe, want=mid)
    else:
        h = F.gelu(expert_matmul(p, "wi", xe, want=mid),
                   approximate="tanh")  # jax.nn.gelu default
    ye = expert_matmul(p, "wd", h, have=mid)
    if sh is not None:  # every expert's output, gathered over the expert axes
        ye = relayout(ye, 0, sh.e, (), sh.mesh)
    dt = torch.promote_types(combine.dtype, ye.dtype)
    y = torch.einsum("gsec,egcd->gsd", combine.to(dt), ye.to(dt))
    loss = None
    active = getattr(_split, "active", None)
    if aux and active is not None:  # the caller forms the whole batch's loss
        top1 = _one_hot(topi[..., 0], mo.n_experts, torch.float32)
        active[2].append((torch.sum(top1, dim=(0, 1)), torch.sum(gates, dim=(0, 1))))
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
    elif aux:
        density = torch.mean(_one_hot(topi[..., 0], mo.n_experts, torch.float32), dim=(0, 1))
        router_prob = torch.mean(gates, dim=(0, 1))
        loss = mo.n_experts * torch.sum(density * router_prob)
    return y.reshape(B, S, d).to(x.dtype), loss


__all__ = ["MoE", "current_split", "expert_capacity", "expert_matmul", "moe", "replay_split",
           "route", "split_routing", "top_k"]
