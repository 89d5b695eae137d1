"""xLSTM blocks (Beck et al., arXiv:2405.04517), port of
``repro/models/xlstm.py``: mLSTM (matrix memory, exponential gating) and
sLSTM (scalar memory, real recurrence).

mLSTM has no nonlinearity across time in its state update: prefill runs the
chunkwise-parallel form (intra-chunk attention-like products, inter-chunk
recurrent state, all in stabilized log space), decode the exact recurrence,
which is also the test oracle. sLSTM's recurrence is nonlinear (h feeds back
through the gates), so its prefill is a loop over the sequence's steps.

States are f32 and the log-space stabilizers start at ``NEG`` = -1e30, a
finite stand-in for -inf: ``exp(-m)`` is then inf, which the mLSTM
denominator's ``max(|q.n|, exp(-m))`` relies on. Decode updates the states
in place (a captured decode step reads them at fixed addresses).

:class:`MLSTM` holds the sites ``up``, ``wq``, ``wk``, ``wv`` and ``down``
and the float leaves ``conv_w``, ``conv_b``, ``wi``, ``wf``, ``f_bias``,
``skip`` and ``norm_w``; :class:`SLSTM` the sites ``w_in``, ``up`` and
``down`` and the float leaves ``r``, ``b`` and ``norm_w``.

Under a mesh (``_shard``, a :class:`~repro_torch.runtime.sharding.
MixerShard`) an mLSTM rank runs its heads: the fused ``up`` is gathered
(so xin is whole, as ``wv`` and the gates take it), the conv runs on the
rank's channels and its output is gathered for ``wq``/``wk`` (K whole),
``wq``/``wk``/``wv`` N-shard onto the heads, the input gate's columns
are the rank's ``wi`` shard, the C/n/m states are held per head, and
``down`` is K-sharded over the merged heads. The input gate's product and
the cell (with the merge's per-head RMS) run at every head's shape, the
heads other ranks hold as zeros (:func:`_head_span`): cuBLAS picks a
kernel by the product's shape, a narrower one parts from one device's in
the last bit, and the exponential gating carries such a parting far (a
half-ulp change of one gate moves xlstm-350m's logits by several units),
so every value a rank keeps is one device's, bit for bit. An sLSTM rank
holds a last-dim shard of ``r``: a step gathers the recurrent term before
the gates, and its h/c/n/m states are whole on every rank; ``w_in`` is
gathered, and the block FFN runs as the MLP does (``up`` N-, ``down``
K-sharded).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.runtime.collectives import relayout, shard_range

from .config import ModelConfig
from .layers import Linear, normal_weight, pmm, torch_dtype
from .ssm import _causal_conv, _float_leaf


def _to(p, x, have, want):
    """``x``'s last dim relaid from ``have`` to ``want`` under the mixer's
    mesh (``x`` itself without one)."""
    sh = getattr(p, "_shard", None)
    return x if sh is None else relayout(x, -1, have, want, sh.mesh)


def _axes(p, name: str) -> tuple:
    sh = getattr(p, "_shard", None)
    return () if sh is None else getattr(sh, name)


def _head_span(p, name: str, n_heads: int):
    """(lo, hi, H): the rank's heads of ``n_heads`` over the mixer's
    ``name`` axes, or None where it holds them all (no mesh, or no
    split)."""
    sh = getattr(p, "_shard", None)
    if sh is None or sh.mesh.axes_size(getattr(sh, name)) == 1:
        return None
    return (*shard_range(n_heads, sh.mesh, getattr(sh, name)), n_heads)


def _pad_heads(t, span, dim: int, value: float = 0.0):
    """``t`` with its heads (dim ``dim``, the span's [lo, hi)) padded to
    all H with ``value``."""
    lo, hi, n = span
    return F.pad(t, [0, 0] * (t.dim() - 1 - dim % t.dim()) + [lo, n - hi], value=value)


def _cut_heads(t, span, dim: int):
    """The span's heads of ``t`` (all H heads on dim ``dim``)."""
    lo, hi, _ = span
    return t.narrow(dim, lo, hi - lo)

NEG = -1e30  # finite stand-in for -inf in log-space stabilizers


# ===========================================================================
# mLSTM
# ===========================================================================
class MLSTM(nn.Module):
    """An mLSTM mixer: five sites and the float gate, conv and norm leaves."""

    FLOAT_LEAVES = ("conv_w", "conv_b", "wi", "wf", "f_bias", "skip", "norm_w")

    def __init__(self, up, wq, wk, wv, down, conv_w, conv_b, wi, wf, f_bias, skip, norm_w):
        super().__init__()
        self.up, self.wq, self.wk, self.wv, self.down = up, wq, wk, wv, down
        for name, t in (("conv_w", conv_w), ("conv_b", conv_b), ("wi", wi), ("wf", wf),
                        ("f_bias", f_bias), ("skip", skip), ("norm_w", norm_w)):
            setattr(self, name, _float_leaf(t))


def init_mlstm(cfg: ModelConfig, gen, device) -> MLSTM:
    x = cfg.xlstm
    d = cfg.d_model
    d_in = x.mlstm_expand * d
    h = x.mlstm_heads
    dt = torch_dtype(cfg.param_dtype)
    normal = partial(normal_weight, gen=gen, dtype=dt, device=device)
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_in)
    up = normal((d, 2 * d_in), s)
    conv_w = normal((4, d_in), 0.1)
    wq, wk, wv = (normal((d_in, d_in), si) for _ in range(3))
    wi, wf = normal((d_in, h), si), normal((d_in, h), si)
    down = normal((d_in, d), si)
    return MLSTM(Linear(up), Linear(wq), Linear(wk), Linear(wv), Linear(down), conv_w,
                 torch.zeros(d_in, dtype=dt, device=device), wi, wf,
                 torch.full((h,), 3.0, dtype=dt, device=device),  # forget gates open at init
                 torch.ones(d_in, dtype=dt, device=device),
                 torch.ones(d_in, dtype=dt, device=device))


def _mlstm_qkvgates(p: MLSTM, xin, cfg: ModelConfig, conv_state=None):
    """The pre-cell computation. xin: (B, S, d_in). Returns q, k, v (B, H,
    S, dh), the f32 gate pre-activations ig, fg (B, H, S), the conv output
    xc and the conv's new state. Under a mesh q, k, v and the gates hold
    the rank's heads, the conv and its state its channels, and xc is
    whole."""
    h = cfg.xlstm.mlstm_heads
    B, S, d_in = xin.shape
    dh = d_in // h
    ch, heads = _axes(p, "ch"), _axes(p, "heads")
    xc, conv_state = _causal_conv(_to(p, xin, (), ch), p.conv_w, p.conv_b, conv_state)
    xc = _to(p, F.silu(xc), ch, ())
    q = pmm(p, "wq", xc, want=heads).reshape(B, S, -1, dh).transpose(1, 2)
    k = pmm(p, "wk", xc, want=heads).reshape(B, S, -1, dh).transpose(1, 2)
    v = pmm(p, "wv", xin, want=heads).reshape(B, S, -1, dh).transpose(1, 2)
    q = q * (dh ** -0.5)
    span = _head_span(p, "wi", h)
    if span is None:
        ig = xin @ p.wi
    else:  # at all H columns' shape, the others' zero
        ig = _cut_heads(xin @ _pad_heads(p.wi, span, 1), span, -1)
    ig = _to(p, ig, _axes(p, "wi"), heads).transpose(1, 2).to(torch.float32)  # (B, H, S)
    fg = _to(p, xin @ p.wf + p.f_bias, (), heads).transpose(1, 2).to(torch.float32)
    return q, k, v, ig, fg, xc, conv_state


def _mlstm_step(qt, kt, vt, it, lft, C, n, m):
    """One exact recurrence step on f32 (B, H, ...) slices; C and n are
    updated in place. Returns (h (B, H, dh), m_new)."""
    m_new = torch.maximum(lft + m, it)
    fp = torch.exp(lft + m - m_new)
    ip = torch.exp(it - m_new)
    C.mul_(fp[..., None, None]).add_(ip[..., None, None] * (kt[..., :, None] * vt[..., None, :]))
    n.mul_(fp[..., None]).add_(ip[..., None] * kt)
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    qn = torch.einsum("bhd,bhd->bh", qt, n)
    den = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    return num / den[..., None], m_new


def mlstm_cell_recurrent(q, k, v, ig, fg):
    """The exact recurrence (test oracle and decode's building block).
    q/k/v: (B, H, S, dh); ig/fg: (B, H, S). Returns h: (B, H, S, dh) f32."""
    B, H, S, dh = q.shape
    dev = q.device
    lf = F.logsigmoid(fg)
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    hs = []
    for t in range(S):
        h, m = _mlstm_step(qf[:, :, t], kf[:, :, t], vf[:, :, t], ig[:, :, t], lf[:, :, t],
                           C, n, m)
        hs.append(h)
    return torch.stack(hs, dim=2)


def mlstm_cell_chunkwise(q, k, v, ig, fg, chunk: int = 64, return_state: bool = False):
    """Chunkwise-parallel mLSTM (stabilized), the prefill path; matches
    :func:`mlstm_cell_recurrent` to f32 tolerance. ``return_state`` also
    returns the end-of-sequence (C, n, m) carry. A ragged tail pads with
    i-gate = NEG (no input) and f-gate = +30 (log-sigmoid ~ 0, no decay),
    so padded steps leave the carried state untouched."""
    B, H, S0, dh = q.shape
    dev = q.device
    L = min(chunk, S0)
    pad = (-S0) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, pad), value=NEG)
        fg = F.pad(fg, (0, pad), value=30.0)
    S = S0 + pad
    nc = S // L
    lf = F.logsigmoid(fg)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    hs = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, ic, lfc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], ig[:, :, sl], lf[:, :, sl]
        b = torch.cumsum(lfc, dim=-1)  # (B, H, L) inclusive log-decay
        s_cm = torch.cummax(ic - b, dim=-1).values
        m_t = b + torch.maximum(m[..., None], s_cm)  # (B, H, L)
        # inter-chunk contribution from the carried state
        inter_scale = torch.exp(b + m[..., None] - m_t)
        h_inter = torch.einsum("bhld,bhde->bhle", qc, C) * inter_scale[..., None]
        n_inter = n[:, :, None, :] * inter_scale[..., None]
        # intra-chunk attention-like term
        logd = ic[:, :, None, :] + b[:, :, :, None] - b[:, :, None, :] - m_t[..., None]
        dmat = torch.where(tril, torch.exp(logd), torch.zeros((), device=dev))
        smat = torch.einsum("bhtd,bhjd->bhtj", qc, kc) * dmat
        h_intra = torch.einsum("bhtj,bhjd->bhtd", smat, vc)
        n_intra = torch.einsum("bhtj,bhjd->bhtd", dmat, kc)
        n_vec = n_inter + n_intra
        qn = torch.einsum("bhld,bhld->bhl", qc, n_vec)
        den = torch.maximum(torch.abs(qn), torch.exp(-m_t))
        hs.append((h_inter + h_intra) / den[..., None])
        # carry to the next chunk
        g = b[..., -1]  # total chunk decay
        m_next = g + torch.maximum(m, s_cm[..., -1])
        w_c = torch.exp(ic + g[..., None] - b - m_next[..., None])  # (B, H, L)
        decay = torch.exp(g + m - m_next)
        # the weighted sum of k v^T over the chunk as one product (a
        # three-operand einsum may form the (L, dh, dh) outer products)
        C = C * decay[..., None, None] + torch.einsum("bhld,bhle->bhde", w_c[..., None] * kc, vc)
        n = n * decay[..., None] + torch.einsum("bhl,bhld->bhd", w_c, kc)
        m = m_next
    out = torch.cat(hs, dim=2)[:, :, :S0]
    if return_state:
        return out, (C, n, m)
    return out


def _mlstm_merge(norm_w, skip, h_cell, xc, z, span=None):
    """Head merge, per-head RMS norm, learnable conv skip and z gate: all
    between the cell and the down projection (the PTQ adapter taps the down
    projection on its output). ``span``: ``h_cell`` holds all H heads, and
    the merge keeps the span's (the others', zero, only shape the RMS's
    reduction as one device's)."""
    h = h_cell.transpose(1, 2)  # (B, S, H, dh)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    if span is not None:
        h, var = _cut_heads(h, span, 2), _cut_heads(var, span, 2)
    B, S, H, dh = h.shape
    h = h * torch.rsqrt(var + 1e-6)
    h = h.reshape(B, S, H * dh).to(z.dtype) * norm_w
    h = h + skip * xc
    return h * F.silu(z)


def _mlstm_out(p: MLSTM, h_cell, xc, z, span=None):
    """The merge and ``down``: under a mesh on the rank's heads (its
    channels of ``norm_w``, ``skip``, xc and z; ``h_cell`` at all H heads
    where ``span`` splits them), ``down`` K-sharded."""
    heads = _axes(p, "heads")
    merged = _mlstm_merge(_to(p, p.norm_w, (), heads), _to(p, p.skip, _axes(p, "ch"), heads),
                          h_cell, _to(p, xc, (), heads), _to(p, z, (), heads), span)
    return pmm(p, "down", merged, have=heads)


def mlstm(p: MLSTM, x, cfg: ModelConfig, return_state: bool = False):
    """Prefill mLSTM block. x: (B, S, d_model). ``return_state`` also
    returns the decode state {"conv", "C", "n", "m"}."""
    xz = pmm(p, "up", x)
    xin, z = torch.chunk(xz, 2, dim=-1)
    q, k, v, ig, fg, xc, _ = _mlstm_qkvgates(p, xin, cfg)
    span = _head_span(p, "heads", cfg.xlstm.mlstm_heads)
    if span is not None:  # the cell at all H heads' shape, the others' zero
        q, k, v, ig, fg = (_pad_heads(t, span, 1) for t in (q, k, v, ig, fg))
    cell = mlstm_cell_chunkwise(q, k, v, ig, fg, cfg.xlstm.chunk, return_state=return_state)
    h_cell, state = cell if return_state else (cell, None)
    y = _mlstm_out(p, h_cell, xc, z, span)
    if not return_state:
        return y
    C, n, m = state if span is None else (_cut_heads(t, span, 1).contiguous() for t in state)
    S0 = x.shape[1]
    tail = _to(p, xin, (), _axes(p, "ch"))[:, max(S0 - 3, 0):, :]
    if S0 < 3:
        tail = F.pad(tail, (0, 0, 3 - S0, 0))
    return y, {"conv": tail.to(torch_dtype(cfg.act_dtype)), "C": C, "n": n, "m": m}


def mlstm_decode(p: MLSTM, x, cfg: ModelConfig, conv_state, C, n, m):
    """Single-token step. States: conv (B, 3, d_in), C (B, H, dh, dh) f32,
    n (B, H, dh) f32, m (B, H) f32, all updated in place. Returns (y,
    conv_state, C, n, m)."""
    xz = pmm(p, "up", x)
    xin, z = torch.chunk(xz, 2, dim=-1)
    q, k, v, ig, fg, xc, new_conv = _mlstm_qkvgates(p, xin, cfg, conv_state)
    conv_state.copy_(new_conv)
    qt, kt, vt = (t[:, :, 0].to(torch.float32) for t in (q, k, v))
    it, lft = ig[:, :, 0], F.logsigmoid(fg[:, :, 0])
    span = _head_span(p, "heads", cfg.xlstm.mlstm_heads)
    if span is None:
        h, m_new = _mlstm_step(qt, kt, vt, it, lft, C, n, m)
    else:  # the step at all H heads' shape, the others' zero; the rank's written back
        Cp, n_p = _pad_heads(C, span, 1), _pad_heads(n, span, 1)
        h, m_new = _mlstm_step(*(_pad_heads(t, span, 1) for t in (qt, kt, vt, it, lft)), Cp,
                               n_p, _pad_heads(m, span, 1, NEG))
        C.copy_(_cut_heads(Cp, span, 1))
        n.copy_(_cut_heads(n_p, span, 1))
        m_new = _cut_heads(m_new, span, 1)
    m.copy_(m_new)
    y = _mlstm_out(p, h[:, :, None, :], xc, z, span)
    return y, conv_state, C, n, m


def mlstm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    x = cfg.xlstm
    d_in = x.mlstm_expand * cfg.d_model
    h = x.mlstm_heads
    dh = d_in // h
    return {
        "conv": ((batch, 3, d_in), torch_dtype(cfg.act_dtype)),
        "C": ((batch, h, dh, dh), torch.float32),
        "n": ((batch, h, dh), torch.float32),
        "m": ((batch, h), torch.float32),
    }


# ===========================================================================
# sLSTM
# ===========================================================================
class SLSTM(nn.Module):
    """An sLSTM mixer: the z/i/f/o input projection ``w_in``, the block
    FFN's ``up``/``down``, and the float recurrent matrices ``r``, gate bias
    ``b`` and head-norm weight ``norm_w``."""

    FLOAT_LEAVES = ("r", "b", "norm_w")

    def __init__(self, w_in, up, down, r, b, norm_w):
        super().__init__()
        self.w_in, self.up, self.down = w_in, up, down
        self.r, self.b, self.norm_w = _float_leaf(r), _float_leaf(b), _float_leaf(norm_w)


def init_slstm(cfg: ModelConfig, gen, device) -> SLSTM:
    x = cfg.xlstm
    d = cfg.d_model
    h = x.slstm_heads
    dh = d // h
    f = int(d * x.slstm_proj_factor)
    dt = torch_dtype(cfg.param_dtype)
    normal = partial(normal_weight, gen=gen, dtype=dt, device=device)
    s, sh = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dh)
    w_in = normal((d, 4 * d), s)  # z, i, f, o
    r = normal((4, h, dh, dh), sh)
    up = normal((d, f), s)
    down = normal((f, d), 1.0 / math.sqrt(f))
    b = torch.cat([torch.zeros(2 * d, device=device), torch.full((d,), 3.0, device=device),
                   torch.zeros(d, device=device)]).to(dt)
    return SLSTM(Linear(w_in), Linear(up), Linear(down), r, b,
                 torch.ones(d, dtype=dt, device=device))


def _slstm_step(r, xt_proj, state, cfg: ModelConfig, sh=None):
    """One recurrence step. xt_proj: (B, 4d) input projection; ``state``
    (h, c, n, m), each (B, d) f32. Returns the new state. ``sh`` (a
    mixer's mesh layout): ``r`` holds the rank's last-dim shard, and the
    recurrent term is gathered before the gates."""
    h_heads = cfg.xlstm.slstm_heads
    d = cfg.d_model
    dh = d // h_heads
    h_prev, c, n, m = state
    B = h_prev.shape[0]
    hh = h_prev.reshape(B, h_heads, dh).to(torch.float32)
    rec = torch.einsum("bhd,ghde->gbhe", hh, r.to(torch.float32))
    if sh is not None:
        rec = relayout(rec, -1, sh.rec, (), sh.mesh)
    rec = rec.reshape(4, B, d)
    pre = xt_proj.to(torch.float32).reshape(B, 4, d).transpose(0, 1) + rec
    zt = torch.tanh(pre[0])
    it, ft, ot = pre[1], pre[2], pre[3]
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    h_new = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-12)
    return h_new, c, n, m_new


def slstm_scan(r, proj, cfg: ModelConfig, sh=None):
    """The sequential sLSTM recurrence over precomputed input projections.
    proj: (B, S, 4d). Returns (h (B, S, d) f32, final (h, c, n, m)); ``sh``
    as :func:`_slstm_step` takes it."""
    B, S, _ = proj.shape
    d = cfg.d_model
    z0 = torch.zeros((B, d), dtype=torch.float32, device=proj.device)
    state = (z0, z0, z0, torch.full((B, d), NEG, dtype=torch.float32, device=proj.device))
    hs = []
    for t in range(S):
        state = _slstm_step(r, proj[:, t], state, cfg, sh)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


def slstm_headnorm(norm_w, h, cfg: ModelConfig):
    """Head-wise RMS norm and elementwise weight ahead of the block FFN."""
    B, S, d = h.shape
    hheads = h.reshape(B, S, cfg.xlstm.slstm_heads, -1)
    var = torch.mean(torch.square(hheads.to(torch.float32)), dim=-1, keepdim=True)
    hn = (hheads * torch.rsqrt(var + 1e-6).to(h.dtype)).reshape(B, S, d)
    return hn * norm_w


def _slstm_ffn(p: SLSTM, hn):
    sh = getattr(p.down, "_shard", None)
    mid = () if sh is None else sh.k  # the hidden layer in down's K layout
    return pmm(p, "down", F.gelu(pmm(p, "up", hn, want=mid), approximate="tanh"), have=mid)


def slstm(p: SLSTM, x, cfg: ModelConfig, return_state: bool = False):
    """Prefill sLSTM block, a sequential scan (no parallel form). x: (B, S,
    d_model). ``return_state`` also returns {"h", "c", "n", "m"}."""
    proj = pmm(p, "w_in", x) + p.b  # (B, S, 4d)
    hs, final = slstm_scan(p.r, proj, cfg, getattr(p, "_shard", None))
    h = hs.to(x.dtype)
    y = _slstm_ffn(p, slstm_headnorm(p.norm_w, h, cfg))
    if not return_state:
        return y
    hf, cf, nf, mf = final
    return y, {"h": hf, "c": cf, "n": nf, "m": mf}


def slstm_decode(p: SLSTM, x, cfg: ModelConfig, h, c, n, m):
    """Single-token step. x: (B, 1, d_model); states (B, d) f32, updated in
    place. Returns (y, h, c, n, m)."""
    B = x.shape[0]
    d = cfg.d_model
    proj = (pmm(p, "w_in", x[:, 0]) + p.b).to(torch.float32)
    new = _slstm_step(p.r, proj, (h, c, n, m), cfg, getattr(p, "_shard", None))
    for dst, src in zip((h, c, n, m), new):
        dst.copy_(src)
    hheads = h.reshape(B, 1, cfg.xlstm.slstm_heads, -1)
    var = torch.mean(torch.square(hheads), dim=-1, keepdim=True)
    hn = (hheads * torch.rsqrt(var + 1e-6)).reshape(B, 1, d).to(x.dtype)
    y = _slstm_ffn(p, hn * p.norm_w)
    return y, h, c, n, m


def slstm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    d = cfg.d_model
    return {name: ((batch, d), torch.float32) for name in ("h", "c", "n", "m")}
