"""Mamba-1 selective SSM block (Gu & Dao, arXiv:2312.00752), port of
``repro/models/ssm.py``.

Prefill runs the chunked selective scan: within a chunk the recurrence
``h_t = Abar_t h_{t-1} + Bbar_t x_t`` runs as a log-depth doubling scan
(the counterpart of the reference's ``lax.associative_scan``), across
chunks a Python loop carries the (B, d_in, d_state) f32 state, so peak
memory is O(chunk) in the scan's own terms. Decode is the exact
single-step recurrence, and writes the conv and SSM states in place (a
captured decode step reads them at fixed addresses).

:class:`Mamba` holds the four quantizable sites (``in_proj``, ``x_proj``,
``dt_proj``, ``out_proj``: :class:`~repro_torch.models.layers.Linear` or
:class:`~repro_torch.models.layers.PackedLinear`) and the float leaves
``conv_w``, ``conv_b``, ``dt_bias``, ``A_log`` and ``D``, with the
reference's (K, N) layouts.

Under a mesh (``_shard``, a :class:`~repro_torch.runtime.sharding.
MixerShard`) a rank holds the channels ``ch`` of d_in: its slices of
``conv_w``, ``conv_b``, ``A_log``, ``D`` and ``dt_bias``, and of the
scan and its states, which are local per channel. The fused ``in_proj``
(N = 2 d_in, N-sharded) is gathered and each half cut to the rank's
channels (a contiguous N shard would give one rank all of xin and another
all of z); ``x_proj`` is K-sharded (its integer accumulators summed
exactly), ``dt_proj`` N-sharded onto the channels, ``out_proj``
K-sharded.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.runtime.collectives import relayout

from .config import ModelConfig
from .layers import Linear, normal_weight, pmm, torch_dtype


def _float_leaf(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Mamba(nn.Module):
    """A Mamba mixer: four sites and the float state parameters."""

    #: the component's float leaves that are not sites (kept as tensors)
    FLOAT_LEAVES = ("conv_w", "conv_b", "dt_bias", "A_log", "D")

    def __init__(self, in_proj, x_proj, dt_proj, out_proj, conv_w, conv_b, dt_bias, A_log, D):
        super().__init__()
        self.in_proj, self.x_proj, self.dt_proj, self.out_proj = in_proj, x_proj, dt_proj, out_proj
        self.conv_w, self.conv_b = _float_leaf(conv_w), _float_leaf(conv_b)
        self.dt_bias, self.A_log, self.D = _float_leaf(dt_bias), _float_leaf(A_log), _float_leaf(D)


def init_mamba(cfg: ModelConfig, gen, device) -> Mamba:
    """A Mamba mixer with the reference's shapes and distributions, drawn
    from ``gen``: Gaussian weights scaled by 1/sqrt(fan_in) (conv by 0.1),
    S4D-real A (``A_log = log(1..N)``) and ``dt_bias`` the inverse softplus
    of a dt drawn log-uniform in [1e-3, 1e-1]."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dtr = cfg.dt_rank
    dt = torch_dtype(cfg.param_dtype)
    normal = partial(normal_weight, gen=gen, dtype=dt, device=device)
    sc, sci = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_in)
    in_proj = normal((d, 2 * d_in), sc)
    conv_w = normal((s.d_conv, d_in), 0.1)
    x_proj = normal((d_in, dtr + 2 * s.d_state), sci)
    dt_proj = normal((dtr, d_in), 1.0 / math.sqrt(dtr))
    out_proj = normal((d_in, d), sci)
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=device)[None, :].repeat(d_in, 1)
    dt_min, dt_max = 1e-3, 1e-1
    u = torch.rand((d_in,), generator=gen, dtype=torch.float32, device=device)
    dt_init = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt_bias = dt_init + torch.log1p(-torch.exp(-dt_init))  # inverse softplus
    return Mamba(
        Linear(in_proj), Linear(x_proj), Linear(dt_proj), Linear(out_proj),
        conv_w, torch.zeros(d_in, dtype=dt, device=device), dt_bias.to(dt),
        torch.log(a).to(dt), torch.ones(d_in, dtype=dt, device=device))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, S, d_in); w: (K, d_in).

    ``state``: (B, K-1, d_in) trailing inputs from the previous segment
    (decode); returns (y, new_state)."""
    ksz = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], ksz - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(ksz)) + b
    new_state = xp[:, -(ksz - 1):, :] if ksz > 1 else state
    return y, new_state


def split_halves(p, xz):
    """The fused projection's output (..., 2 d_in) -> (xin, z), each in the
    mixer's channel layout: halves of the whole row, or under a mesh the
    rank's channels of each half (``xz`` then arrives whole)."""
    a, b = torch.chunk(xz, 2, dim=-1)
    sh = getattr(p, "_shard", None)
    if sh is None:
        return a, b
    return relayout(a, -1, (), sh.ch, sh.mesh), relayout(b, -1, (), sh.ch, sh.mesh)


def _channels(p) -> tuple:
    sh = getattr(p, "_shard", None)
    return () if sh is None else sh.ch


def _ssm_params(p, x, cfg: ModelConfig):
    """Input-dependent (dt, B, C) and the fixed A. x: (B, S, d_in), in the
    mixer's channel layout (dt too)."""
    s = cfg.ssm
    dtr = cfg.dt_rank
    ch = _channels(p)
    proj = pmm(p, "x_proj", x, have=ch)  # (B, S, dtr + 2N)
    dt_r, b_ssm, c_ssm = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(pmm(p, "dt_proj", dt_r, want=ch) + p.dt_bias)  # (B, S, d_in)
    a = -torch.exp(p.A_log.to(torch.float32))  # (d_in, N)
    return dt, b_ssm, c_ssm, a


def _scan_chunk(h0, abar, bu):
    """First-order recurrence within a chunk, ``h_t = abar_t * h_{t-1} +
    bu_t`` from ``h0``, as a log-depth doubling scan over the chunk's L
    steps (each round composes every element with the one ``d`` before
    it). abar/bu: (B, L, d_in, N). Returns (B, L, d_in, N)."""
    a, b = abar, bu
    L = a.shape[1]
    d = 1
    while d < L:
        a_tail, b_tail = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_tail * b[:, :-d] + b_tail], dim=1)
        a = torch.cat([a[:, :d], a_tail * a[:, :-d]], dim=1)
        d *= 2
    return a * h0[:, None] + b


def selective_scan(xin, dt, b_ssm, c_ssm, a, d_param, d_state: int, chunk: int = 256,
                   return_state: bool = False):
    """Chunked selective-SSM core: (xin, dt, B, C) -> y (B, S, d_in) f32.

    Pure-tensor signature, so the PTQ adapter runs the same scan on its
    paired calibration streams. ``return_state`` also returns the
    end-of-sequence (B, d_in, N) state. A ragged tail pads with abar = 1,
    bu = 0, which keeps the state exactly."""
    B, S, d_in = xin.shape
    dtf = dt.to(torch.float32)
    abar = torch.exp(dtf[..., None] * a)  # (B, S, d_in, N)
    bu = (dtf * xin.to(torch.float32))[..., None] * b_ssm.to(torch.float32)[:, :, None, :]
    S0 = S
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        abar = F.pad(abar, (0, 0, 0, 0, 0, pad), value=1.0)
        bu = F.pad(bu, (0, 0, 0, 0, 0, pad))
        S = S + pad
    h = torch.zeros((B, d_in, d_state), dtype=torch.float32, device=xin.device)
    hs = []
    for c in range(S // L):
        h_c = _scan_chunk(h, abar[:, c * L:(c + 1) * L], bu[:, c * L:(c + 1) * L])
        h = h_c[:, -1]
        hs.append(h_c)
    hs = torch.cat(hs, dim=1)[:, :S0]
    y = torch.einsum("bsdn,bsn->bsd", hs, c_ssm.to(torch.float32))
    y = y + d_param.to(torch.float32) * xin.to(torch.float32)
    if return_state:
        return y, h
    return y


def mamba(p: Mamba, x, cfg: ModelConfig, chunk: int = 256, return_state: bool = False):
    """Prefill forward. x: (B, S, d_model) -> (B, S, d_model).

    ``return_state``: also return the decode-ready end-of-sequence state
    {"conv", "ssm"} (the chunkwise-parallel prefill)."""
    B, S0, _ = x.shape
    s = cfg.ssm
    xin_raw, z = split_halves(p, pmm(p, "in_proj", x))
    xin, _ = _causal_conv(xin_raw, p.conv_w, p.conv_b)
    xin = F.silu(xin)
    dt, b_ssm, c_ssm, a = _ssm_params(p, xin, cfg)
    y, h_last = selective_scan(xin, dt, b_ssm, c_ssm, a, p.D, s.d_state, chunk=chunk,
                               return_state=True)
    y = y.to(x.dtype) * F.silu(z)
    out = pmm(p, "out_proj", y, have=_channels(p))
    if not return_state:
        return out
    ksz = p.conv_w.shape[0]
    tail = xin_raw[:, max(S0 - (ksz - 1), 0):S0, :]
    pad_needed = max(ksz - 1 - S0, 0)
    if pad_needed:
        tail = F.pad(tail, (0, 0, pad_needed, 0))
    return out, {"conv": tail.to(torch_dtype(cfg.act_dtype)), "ssm": h_last}


def mamba_decode(p: Mamba, x, cfg: ModelConfig, conv_state, ssm_state):
    """Exact single-token step. x: (B, 1, d_model); conv_state (B, d_conv-1,
    d_in) in the act dtype, ssm_state (B, d_in, N) f32. The states are
    updated in place (the reference returns new ones); returns (y,
    conv_state, ssm_state). Under a mesh the states hold the rank's
    channels."""
    xin, z = split_halves(p, pmm(p, "in_proj", x))
    xin, new_conv = _causal_conv(xin, p.conv_w, p.conv_b, conv_state)
    conv_state.copy_(new_conv)
    xin = F.silu(xin)
    dt, b_ssm, c_ssm, a = _ssm_params(p, xin, cfg)
    dtf = dt[:, 0].to(torch.float32)  # (B, d_in)
    abar = torch.exp(dtf[..., None] * a)  # (B, d_in, N)
    bu = (dtf * xin[:, 0].to(torch.float32))[..., None] * b_ssm[:, 0].to(torch.float32)[:, None, :]
    ssm_state.mul_(abar).add_(bu)
    y = torch.einsum("bdn,bn->bd", ssm_state, c_ssm[:, 0].to(torch.float32))
    y = y + p.D.to(torch.float32) * xin[:, 0].to(torch.float32)
    y = y.to(x.dtype)[:, None, :] * F.silu(z)
    return pmm(p, "out_proj", y, have=_channels(p)), conv_state, ssm_state


def mamba_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of one layer's decode state."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {
        "conv": ((batch, s.d_conv - 1, d_in), torch_dtype(cfg.act_dtype)),
        "ssm": ((batch, d_in, s.d_state), torch.float32),
    }
