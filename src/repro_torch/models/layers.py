"""Core layers (port of ``repro/models/layers.py``, dense serving path):
norms, RoPE, GQA attention (full, online-softmax chunked, decode, paged
decode), the SwiGLU/GELU MLP, embedding and LM head, the packed-weight
matmul dispatch that routes every quantized site onto the W4A8 datapath,
and the serving observer's taps on it (``attach_observer``,
``site_scope``).

Under a mesh (:func:`~repro_torch.runtime.sharding.shard_model`) a site,
an attention layer and the embedding carry their layouts (``_shard``) and
hold this rank's slice; the functions here then run on local shards: a
site's input is relaid to its weight's K layout, a K-sharded site sums its
ranks' partial products (a packed site its integer accumulators) over the
K axes, and its output carries its N layout
(:func:`pmm`'s ``have``/``want``); attention runs on the rank's heads; the
embedding looks up its rows and sums, the head gathers the vocab. Without
``_shard`` every function is the single-device one, op for op.

Parameters are ``nn.Module``s: :class:`Linear` (a float (K, N) weight),
:class:`PackedLinear` (a packed-int4 serving site) and the component
containers :class:`Norm`, :class:`Attention`, :class:`MLP`,
:class:`Embedding`. Weights keep the reference's (K, N) layout, so
``x @ w`` reads the same in both packages. Layouts of activations are the
reference's too: (B, S, d) and (B, S, H, hd).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.alphabet import act_alphabet
from repro_torch.kernels.ops import quantize_activations
from repro_torch.kernels.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
)
from repro_torch.kernels.w4a8_mm import (
    _expert_epilogue,
    datapath_kernel_args,
    unpack_int4,
    unpack_sparse24,
    w4a8_decode_matmul,
    w4a8_expert_matmul,
    w4a8_sparse_decode_matmul,
    w4a8_sparse_expert_matmul,
)
from repro_torch.quant.spec import (
    AttnDatapathSpec,
    DatapathMismatchError,
    DatapathSpec,
    validate_attn_datapath,
)
from repro_torch.runtime.collectives import (
    all_reduce_max,
    all_reduce_sum,
    gather_dim,
    relayout,
    shard_range,
)

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_weight(shape, std, gen, dtype, device) -> torch.Tensor:
    """A Gaussian weight of ``std`` drawn in f32 from ``gen``, cast to ``dtype``
    (the random init of every model of the port)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Packed-weight matmul dispatch (the W4A8 serving datapath)
# ---------------------------------------------------------------------------
# Backends:
#   kernel    — dynamic or static activation quantization, then the W4A8
#               GEMM wrapper: the hand-written CUDA kernel for CUDA tensors,
#               its exact-integer plain version for CPU tensors (the
#               default);
#   reference — the same dataflow with the plain version on any device
#               (the counterpart of the reference's "interpret" backend);
#   dequant   — unpack int4 to the scale dtype, then a dense matmul.
_PACKED_BACKENDS = ("kernel", "reference", "dequant")
_packed_state = threading.local()


def packed_backend() -> str:
    """The active packed-matmul backend ("kernel" unless overridden)."""
    return getattr(_packed_state, "override", None) or "kernel"


@contextmanager
def use_packed_backend(mode: str):
    """Select the packed-matmul backend for the enclosed calls."""
    if mode not in _PACKED_BACKENDS:
        raise ValueError(f"packed backend {mode!r} not in {_PACKED_BACKENDS}")
    prev = getattr(_packed_state, "override", None)
    _packed_state.override = mode
    try:
        yield
    finally:
        _packed_state.override = prev


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None, stacked: bool) -> torch.Tensor:
    """``y`` plus a site's corrected bias: (N,) for a plain site, one row of
    N an expert, (E, 1, N), for an expert-stacked one."""
    if bias is None:
        return y
    return y + (bias.reshape(bias.shape[0], 1, -1) if stacked else bias.reshape(-1)).to(y.dtype)


class Linear(nn.Module):
    """A float site: ``x @ w`` with ``w`` (K, N), or expert-stacked (E, K, N)
    taking (E, M, K) rows, plus the corrected bias when the site is a
    high-precision leaf of a calibrated artifact."""

    def __init__(self, w: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = getattr(self, "_shard", None)
        if sh is None:
            return _add_bias(x @ self.w, self.bias, self.w.dim() == 3)
        if sh.k:  # K-sharded: f32 partial products, summed, rounded once
            y = all_reduce_sum(x.to(torch.float32) @ self.w.to(torch.float32), sh.mesh,
                               sh.k).to(x.dtype)
        else:
            y = x @ self.w
        bias = None if self.bias is None else relayout(self.bias, -1, sh.bias, sh.n, sh.mesh)
        return _add_bias(y, bias, self.w.dim() == 3)


class PackedLinear(nn.Module):
    """A packed-int4 serving site (the reference's packed leaf dict).

    Buffers: ``packed`` (K//2, N) int8 (for a 2:4 site, (K//4, N) kept
    codes beside ``meta`` (K//4, N) int8 in-group positions, as
    :func:`~repro_torch.kernels.w4a8_mm.compress_2to4` stores them),
    ``scale`` (1, N) per-channel weight scales, ``col_sums`` (1, N) int32
    pack-time code sums (None on legacy artifacts until
    :func:`~repro_torch.quant.serve_packed.ensure_col_sums`),
    ``spec_arr`` the persistable spec twin, and optional ``act_scale`` /
    ``act_zp`` (0-d f32, a calibrated static activation quantizer) and
    ``bias`` (N,). ``spec`` is the site's
    :class:`~repro_torch.quant.spec.DatapathSpec`.

    An expert-stacked site (an MoE FFN's) carries a leading E on every
    buffer: ``packed`` (E, K//2, N), ``scale`` and ``col_sums`` (E, 1, N),
    ``spec_arr`` (E, L), ``act_scale``/``act_zp`` (E,), one quantizer an
    expert, and ``bias`` (E, 1, N)."""

    def __init__(self, packed, scale, col_sums=None, spec=None, spec_arr=None,
                 act_scale=None, act_zp=None, bias=None, meta=None):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("meta", meta)
        self.register_buffer("scale", scale)
        self.register_buffer("col_sums", col_sums)
        self.register_buffer("spec_arr", spec_arr)
        self.register_buffer("act_scale", act_scale)
        self.register_buffer("act_zp", act_zp)
        self.register_buffer("bias", bias)
        self.spec = spec

    @property
    def stacked(self) -> bool:
        return self.packed.dim() == 3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return packed_linear(x, self)


def site_codes(leaf: PackedLinear) -> torch.Tensor:
    """The (K, N) int8 codes of a packed site, dense-with-zeros for 2:4."""
    if leaf.meta is not None:
        return unpack_sparse24(leaf.packed, leaf.meta)
    return unpack_int4(leaf.packed)


def dequant_weight(leaf: PackedLinear) -> torch.Tensor:
    """Dequantized (K, N) weight of a packed site, in the scale's dtype."""
    return site_codes(leaf).to(leaf.scale.dtype) * leaf.scale


def _static_act_raw(x2, leaf: PackedLinear, act_scale=None, act_zp=None):
    """``rint(x / scale) + zp`` under the site's calibrated static quantizer
    (``act_scale``/``act_zp`` where given: an expert shard's entries),
    before the clip (f32), with the scale and zero point."""
    shape = (-1, 1, 1) if leaf.stacked else ()  # one quantizer an expert
    scale = (leaf.act_scale if act_scale is None else act_scale).to(torch.float32).reshape(shape)
    zp = (leaf.act_zp if act_zp is None else act_zp).to(torch.float32).reshape(shape)
    return torch.round(x2.to(torch.float32) / scale) + zp, scale, zp


def _static_act_codes(x2, leaf: PackedLinear, spec: DatapathSpec, act_scale=None,
                      act_zp=None):
    """Activation codes from the site's calibrated static quantizer: pure
    elementwise ops, codes in the certificate's alphabet."""
    raw, scale, zp = _static_act_raw(x2, leaf, act_scale, act_zp)
    alpha = act_alphabet(spec.act_bits, signed=spec.act_signed)
    codes = torch.clamp(raw, alpha.qmin, alpha.qmax)
    return codes.to(torch.int8 if spec.act_signed else torch.uint8), scale, zp


def packed_linear(x, leaf: PackedLinear, *, spec: DatapathSpec | None = None,
                  assert_inner: bool = False):
    """x: (..., K) through a packed site -> (..., N) in ``x``'s dtype; an
    expert-stacked site takes (E, M, K) and gives (E, M, N), all experts in
    one launch of the expert-axis kernel, each quantizing its own rows.

    The accumulation datapath (T, P_I) and the activation quantizer come
    from the site's embedded spec; ``spec`` is a request, and one that
    disagrees raises :class:`DatapathMismatchError`. Static activation
    quantizers run when the site ships them; otherwise the dynamic
    per-tensor quantizer runs.

    A sharded site (``leaf._shard``, its input already in the K layout)
    runs on its local codes, and its output holds this rank's N columns;
    a stacked one takes its experts' rows, (E_local, M, K), and cuts its
    replicated per-expert static quantizer to them. A K-sharded one takes
    the dynamic quantizer's range over every rank's part of the row (of
    each expert's rows when stacked), so its codes are the unsharded codes,
    has the kernel return its integer accumulator alone (``s_w * s_a`` =
    1, correction 0: the epilogue gives ``float(acc)``; one and zero an
    expert when stacked), sums those over the K axes and applies the
    unsharded epilogue ``(acc - zp * col_sums) * s_w * s_a`` in the
    kernel's order (per expert when stacked), then the bias: the output is
    the unsharded site's bit for bit while every partial and their sum stay
    below 2^24 in magnitude (a certified site's do where K / T * 2^(P_I -
    1) < 2^24)."""
    embedded = leaf.spec
    if spec is not None and embedded is not None:
        embedded.require_matches(spec, context="packed_linear")
    resolved = embedded if embedded is not None else (spec or DatapathSpec())
    # a 2:4 site carries meta: spec and layout must agree, or the codes
    # would be expanded wrongly
    if (resolved.sparsity is not None) != (leaf.meta is not None):
        raise DatapathMismatchError(
            "packed_linear: datapath field 'sparsity' disagrees with the leaf "
            f"layout (spec sparsity={resolved.sparsity!r}, leaf "
            f"{'carries' if leaf.meta is not None else 'lacks'} a 2:4 metadata leaf)")

    backend = packed_backend()
    stacked = leaf.stacked
    if backend == "dequant":
        w = dequant_weight(leaf)
        dt = torch.promote_types(x.dtype, w.dtype)
        return _add_bias(x.to(dt) @ w.to(dt), leaf.bias, stacked)

    if stacked:  # (E, M, K) rows: each expert quantizes its own
        x2 = x
    else:
        *lead, k = x.shape
        x2 = x.reshape(-1, k)
    sh = getattr(leaf, "_shard", None)
    k_sharded = sh is not None and bool(sh.k)
    if resolved.static_act and leaf.act_scale is not None:
        shard_q = {}
        if stacked and sh is not None:  # the replicated quantizer, cut to the rank's experts
            shard_q = {n: relayout(getattr(leaf, n), 0, (), sh.e, sh.mesh)
                       for n in ("act_scale", "act_zp")}
        codes, act_scale, act_zp = _static_act_codes(x2, leaf, resolved, **shard_q)
    else:
        codes, act_scale, act_zp = quantize_activations(
            x2, per_expert=stacked,
            range_reduce=(lambda r: all_reduce_max(r, sh.mesh, sh.k)) if k_sharded else None)
    col_sums = leaf.col_sums
    if col_sums is None:  # legacy artifact without the pack-time term
        col_sums = site_codes(leaf).to(torch.int32).sum(dim=-2)
    scale, bias = leaf.scale, leaf.bias
    if sh is not None:
        col_sums = relayout(col_sums, -1, sh.col_sums, sh.n, sh.mesh)
        scale = relayout(scale, -1, sh.scale, sh.n, sh.mesh)
        bias = None if bias is None else relayout(bias, -1, sh.bias, sh.n, sh.mesh)
    if leaf.meta is not None:
        weights = (leaf.packed, leaf.meta)
        matmul = w4a8_sparse_expert_matmul if stacked else w4a8_sparse_decode_matmul
    else:
        weights = (leaf.packed,)
        matmul = w4a8_expert_matmul if stacked else w4a8_decode_matmul
    kernel_args = (scale.to(torch.float32), col_sums, act_scale, act_zp)
    if k_sharded:  # the accumulator alone: s_w * s_a = 1, correction 0 (per expert when stacked)
        one, zero = ((torch.ones_like(act_scale), torch.zeros_like(act_zp)) if stacked
                     else (1.0, 0.0))
        kernel_args = (torch.ones_like(kernel_args[0]), col_sums, one, zero)
    y = matmul(
        codes,
        *weights,
        *kernel_args,  # scale (1, N), or (E, 1, N): the wrappers take either
        **datapath_kernel_args(resolved),
        assert_inner=assert_inner,
        out_dtype=torch.float32 if k_sharded else x.dtype,
        reference=(backend == "reference"),
    )
    if k_sharded:
        acc = all_reduce_sum(y, sh.mesh, sh.k)
        if stacked:
            sw, corr = _expert_epilogue(scale, col_sums, act_scale, act_zp, acc.shape[0],
                                        acc.shape[-1])
            sw, corr = sw[:, None], corr[:, None]  # (E, 1, N): one row an expert
        else:
            corr = col_sums.reshape(-1).to(torch.float32) * act_zp
            sw = scale.reshape(-1).to(torch.float32) * act_scale
        y = ((acc - corr) * sw).to(x.dtype)
    if not stacked:
        y = y.reshape(*lead, y.shape[-1])
    return _add_bias(y, bias, stacked)


def pmm(p: nn.Module, name: str, x, have=(), want=()):
    """``x @ p.<name>`` through whichever site module sits there: the seam
    every quantizable-site matmul goes through, and where the serving
    observer taps a packed site's input. On a sharded site ``x``'s last
    dim is in layout ``have`` and is relaid to the weight's K layout, and
    the output is relaid from the weight's N layout to ``want``
    (replicated by default); unsharded sites ignore both."""
    site = getattr(p, name)
    obs = active_observer()
    if obs is not None and isinstance(site, PackedLinear) and not site.stacked:
        scope = getattr(_observe_state, "scope", None)
        if scope is not None:
            _record_site_observation(obs, f"{scope}.{name}", x, site)
    sh = getattr(site, "_shard", None)
    if sh is None:
        return site(x)
    y = site(relayout(x, -1, have, sh.k, sh.mesh))
    return relayout(y, -1, sh.n, want, sh.mesh)


# ---------------------------------------------------------------------------
# Serving-side observation (saturation counters)
# ---------------------------------------------------------------------------
# The observer seam: when an observer is attached (attach_observer) AND a
# site scope is active (site_scope: the paged decode step sets one per
# pattern slot), pmm taps each packed, non-stacked site's input and writes
# its static-quantizer clip count and activation-code extrema into the
# observer's device counter block, in place (the reference reports them
# through jax.debug.callback; a captured CUDA graph cannot call the host).
# With no observer attached (the default) the checks are Python None tests
# and the step is op for op the plain one: asserted by
# PagedEngine.assert_observation_transparent. Prefill and admit programs
# set no scope, so they stay unobserved while observing. MoE expert stacks
# are never tapped: the reference's experts bypass pmm.
_observe_state = threading.local()


def active_observer():
    """The attached observer (a
    :class:`~repro_torch.quant.observe.SaturationCounters` with a device
    block), or None."""
    return getattr(_observe_state, "observer", None)


@contextmanager
def attach_observer(obs):
    """Attach a serving observer for the enclosed calls."""
    prev = getattr(_observe_state, "observer", None)
    _observe_state.observer = obs
    try:
        yield
    finally:
        _observe_state.observer = prev


@contextmanager
def site_scope(label: str):
    """Name the current component ("slot0/mixer") so packed sites report
    under slot-granular labels matching the mixed-precision plan's keys."""
    prev = getattr(_observe_state, "scope", None)
    _observe_state.scope = label
    try:
        yield
    finally:
        _observe_state.scope = prev


def tapping() -> bool:
    """True while a tap's ops are being dispatched (how a program recorder
    tells the taps' ops from the step's own)."""
    return getattr(_observe_state, "tapping", False)


def _record_site_observation(obs, label: str, x, leaf: PackedLinear) -> None:
    """One site's observation, written into ``obs``'s device block: the
    static quantizer's clip count (values of ``rint(x/scale) + zp`` below
    qmin or above qmax, the reference's comparison: a NaN is not counted)
    and the extrema of its clipped
    codes, or, for the dynamic quantizer, the extrema of
    ``quantize_activations``' codes and no clip. ``clip_total`` counts
    every row, idle ones included, as the reference does. Reads ``x``
    only: what the site's matmul receives is untouched."""
    _observe_state.tapping = True
    try:
        spec = leaf.spec if leaf.spec is not None else DatapathSpec()
        x2 = x.reshape(-1, x.shape[-1])
        if spec.static_act and leaf.act_scale is not None:
            raw, _, _ = _static_act_raw(x2, leaf)
            alpha = act_alphabet(spec.act_bits, signed=spec.act_signed)
            codes = torch.clamp(raw, alpha.qmin, alpha.qmax)
            n_clip = torch.sum((raw < alpha.qmin) | (raw > alpha.qmax))
        else:
            codes, _, _ = quantize_activations(x2)
            n_clip = None
        lo, hi = torch.aminmax(codes)
        obs.write(label, x2.numel(), n_clip, lo, hi)
    finally:
        _observe_state.tapping = False


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)


def norm(p: Norm, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf * scale * p.w.to(torch.float32)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p.w.to(torch.float32) + p.b.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """The attention mixer's four sites (``Linear`` or ``PackedLinear``)."""

    def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module, wo: nn.Module):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def _qkv(p: Attention, x, cfg: ModelConfig, positions):
    """RoPE'd q, k, v of (B, S, heads, hd): all heads, or under a mesh this
    rank's q heads and kv heads (the sites' outputs relaid to whole heads
    before RoPE)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    sh = getattr(p, "_shard", None)
    q_axes, kv_axes = (sh.q, sh.kv) if sh is not None else ((), ())
    q = pmm(p, "wq", x, want=q_axes).reshape(B, S, -1, hd)
    k = pmm(p, "wk", x, want=kv_axes).reshape(B, S, -1, hd)
    v = pmm(p, "wv", x, want=kv_axes).reshape(B, S, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_groups(p: Attention, q, k, v):
    """Under a mesh: ``q`` (..., this rank's q heads, hd) padded with zero
    heads to whole groups over the kv heads it reads, and ``k``/``v`` (or
    pools, heads on dim -2) cut to those kv heads, so grouped attention runs
    unchanged; :func:`_unpad_heads` takes the rank's heads back out."""
    sh = getattr(p, "_shard", None)
    if sh is None:
        return q, k, v
    if any(sh.pad):
        q = F.pad(q, (0, 0, *sh.pad))
    return q, _kv_cut(sh, k), _kv_cut(sh, v)


def _kv_cut(sh, t):
    """``t``'s kv heads (dim -2) cut to those the rank's q heads read."""
    a, b = sh.need_lo - sh.kv_lo, sh.need_hi - sh.kv_lo
    return t if (a, b) == (0, t.shape[-2]) else t.narrow(-2, a, b - a)


def _unpad_heads(p: Attention, out):
    sh = getattr(p, "_shard", None)
    if sh is None or not any(sh.pad):
        return out
    return out.narrow(-2, sh.pad[0], sh.q_hi - sh.q_lo)


def _heads_out(p: Attention, out, B: int, S: int):
    """Attention output (B, S, heads, hd) -> the ``wo`` input (B, S, heads *
    hd) and its layout."""
    sh = getattr(p, "_shard", None)
    return out.reshape(B, S, -1), (() if sh is None else sh.q)


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _full_causal_attention(q, k, v, cfg: ModelConfig):
    """Materialized causal attention; ``k``/``v`` may carry T >= S
    positions, query row i sitting at absolute position (T - S) + i."""
    B, S, nh, hd = q.shape
    T = k.shape[1]
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = _softcap(scores / math.sqrt(hd), cfg.attn_logit_softcap)
    kpos = torch.arange(T, device=q.device)
    causal = kpos[None, :] <= (torch.arange(S, device=q.device) + (T - S))[:, None]
    scores = scores.masked_fill(~causal, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, S, nh, hd)


def _chunked_causal_attention(q, k, v, cfg: ModelConfig):
    """Online-softmax attention over KV chunks of ``cfg.attn_chunk``: peak
    memory O(S * chunk) instead of O(S^2). A Python loop over chunks takes
    the place of the reference's ``lax.scan``."""
    B, S0, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    chunk = cfg.attn_chunk
    pad = (-S0) % chunk
    if pad:  # ragged tail: the causal mask keeps padded KV unattended
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    S = S0 + pad
    qg = q.reshape(B, S, nkv, g, hd)
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, nkv, g, S), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nkv, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nkv, g, S, hd), dtype=torch.float32, device=q.device)
    for idx in range(S // chunk):
        kc = k[:, idx * chunk:(idx + 1) * chunk]
        vc = v[:, idx * chunk:(idx + 1) * chunk]
        kv_pos = idx * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).to(torch.float32)
        s = _softcap(s / math.sqrt(hd), cfg.attn_logit_softcap)
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # fully-masked rows (future chunks) keep m finite
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     torch.full_like(m, -math.inf)))
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(q.dtype), vc).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, nh, hd)
    return out[:, :S0].to(q.dtype)


def attention(p: Attention, x, cfg: ModelConfig, positions, prefix_kv=None):
    """Prefill attention. Returns (y, (k, v)), k/v for the cache.

    ``prefix_kv``: optional ``(prefix_k, prefix_v)`` of shape (B, L, nkv,
    hd), the RoPE'd KV of a cached prompt prefix (the prefix cache's suffix
    prefill). Queries then attend over ``concat(prefix, suffix)`` with the
    rectangular causal mask, and ``positions`` carry the absolute offsets
    ``L + i``; the returned (k, v) stay suffix-only."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    k_all, v_all = k, v
    if prefix_kv is not None:
        pk, pv = prefix_kv
        k_all = torch.cat([pk.to(k.dtype), k], dim=1)
        v_all = torch.cat([pv.to(v.dtype), v], dim=1)
    qa, ka, va = _local_groups(p, q, k_all, v_all)
    if prefix_kv is None and S > cfg.attn_chunk_threshold:
        out = _chunked_causal_attention(qa, ka, va, cfg)
    else:
        out = _full_causal_attention(qa, ka, va, cfg)
    out, have = _heads_out(p, _unpad_heads(p, out), B, S)
    y = pmm(p, "wo", out, have=have)
    return y, (k, v)


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------
#   auto      — paged_decode_attention: kernels B2/B3 on CUDA tensors, their
#               plain versions on CPU tensors (the default);
#   reference — the gather reference on any device (the card's comparisons);
#   kernel    — the kernels, and CPU tensors raise.
_PAGED_ATTN_IMPLS = ("auto", "reference", "kernel")


def resolve_paged_attn_impl(impl: str = "auto", device=None) -> str:
    """Check a paged decode-attention implementation name; ``kernel`` on a
    device other than CUDA raises (the kernels have no CPU mode)."""
    if impl not in _PAGED_ATTN_IMPLS:
        raise ValueError(f"paged attn impl {impl!r} not in {_PAGED_ATTN_IMPLS}")
    if impl == "kernel" and device is not None and torch.device(device).type != "cuda":
        raise ValueError("paged attn impl 'kernel' needs CUDA tensors; use 'auto' "
                         "(the plain version on the CPU) or 'reference'")
    return impl


def _append_kv_page_quant(pages, scales, page, off, x, kv_bits: int = 8):
    """Quantize-on-append into an int8 page pool with per-(page, kv-head)
    scales, in place. ``x`` (B, nkv, hd) is the new token's K or V, landing
    at ``(page[b], off[b])``. The page scale grows monotonically: when the
    token's magnitude exceeds it, the page's codes rescale (one extra
    rounding of at most half a step); a write at ``off == 0`` is a page's
    first token, so a stale scale resets. Idle rows carry the sentinel page
    ``nb``, the pool's write sink."""
    qmax = 2 ** (kv_bits - 1) - 1
    bs = pages.shape[1]
    old = torch.where((off == 0)[:, None], torch.zeros_like(scales[page]), scales[page])
    tok = torch.amax(torch.abs(x.to(torch.float32)), dim=-1) / torch.full(
        (), float(qmax), device=x.device)  # (B, nkv); a true division on CUDA too
    new = torch.clamp(torch.maximum(old, tok), min=1e-8)
    codes = torch.round(pages[page].to(torch.float32) * (old / new)[:, None, :, None])
    tok_codes = torch.round(x.to(torch.float32) / new[..., None])  # (B, nkv, hd)
    sel = (torch.arange(bs, device=pages.device)[None, :] == off[:, None])[..., None, None]
    codes = torch.clamp(torch.where(sel, tok_codes[:, None], codes), -qmax, qmax)
    pages[page] = codes.to(pages.dtype)
    scales[page] = new


def _append_kv_page_static(pages, scales, page, off, x, scale_static):
    """Append into an int8 page pool under calibrated static per-kv-head
    scales (``scale_static`` (nkv,) f32; see
    :mod:`repro_torch.quant.observe.kv`), in place. The requantize-on-append
    of :func:`_append_kv_page_quant` is gone: no scale growth, no rescale of
    a page's codes, every code rounded once. The page's scale row is stamped
    with the static value, so pool readers (B3 included) read it as they
    read a dynamic one. Codes hard-clip at the int8 container limit. Idle
    rows carry the sentinel page ``nb``, the pool's write sink."""
    qmax = 127  # the int8 container (a demoted head's alphabet is coarser by its scale)
    tok_codes = torch.clamp(torch.round(x.to(torch.float32) / scale_static[None, :, None]),
                            -qmax, qmax)  # (B, nkv, hd)
    pages[page, off] = tok_codes.to(pages.dtype)
    scales[page] = scale_static[None, :].expand(x.shape[0], x.shape[1])


def paged_attention_decode(p: Attention, x, cfg: ModelConfig, pool: dict, block_table,
                           seq_lens, active, *, impl: str = "auto", attn_spec=None,
                           assert_bounds: bool = False, watermarks=None,
                           static_kv_scales=None):
    """Single-token decode against one layer's paged KV pool.

    x: (B, 1, d), B the engine's slot count. ``pool`` holds ``k_pages`` /
    ``v_pages`` of (nb + 1, bs, nkv, hd) in the act dtype, or int8 codes
    with ``k_scales``/``v_scales`` (nb + 1, nkv) f32; page ``nb`` is a write
    sink for idle slots (the reference drops their scatter; attention never
    reads the sink). ``block_table`` (B, P) int32 maps logical pages to pool
    pages (entries ``>= nb`` are sentinels); ``seq_lens`` (B,) int32 is each
    slot's length: the new token's KV lands at position ``seq_lens[b]`` and
    attention covers positions ``<= seq_lens[b]``. ``active`` (B,) bool
    routes idle slots' writes to the sink, so they never corrupt a live
    page; their outputs are garbage the engine discards. ``attn_spec`` is a
    request checked against the pool's record on every impl.
    ``assert_bounds``/``watermarks`` go to the int8 kernel (B3).
    ``static_kv_scales``, ``{"k": (nkv,), "v": (nkv,)}`` f32 from a
    mixed-precision plan, makes an int8 pool's appends take
    :func:`_append_kv_page_static` (no requantize-on-append); a float pool
    given them raises.

    The pool is updated in place (the reference returns a new one).
    Under a mesh the pool holds this rank's kv heads and ``static_kv_scales``
    their rows; attention runs on the rank's q heads.

    Returns (y, pool)."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, seq_lens[:, None])  # per-slot RoPE positions
    k_pages, v_pages = pool["k_pages"], pool["v_pages"]
    quantized = "k_scales" in pool
    nb, bs = k_pages.shape[0] - 1, k_pages.shape[1]
    if attn_spec is not None:
        derived = (AttnDatapathSpec.for_cache(cfg.head_dim, bs,
                                              kv_bits=8 * k_pages.element_size())
                   if quantized else None)
        validate_attn_datapath(derived, attn_spec)
    lens = seq_lens.long()
    col = torch.clamp(lens // bs, max=block_table.shape[1] - 1)
    page = torch.where(active, block_table[torch.arange(B, device=x.device), col].long(),
                       torch.full_like(lens, nb))
    off = lens % bs
    if static_kv_scales is not None and not quantized:
        raise ValueError("static KV scales need an int8 page pool (a float pool carries "
                         "no scale leaves)")
    if quantized:
        if static_kv_scales is not None:
            _append_kv_page_static(k_pages, pool["k_scales"], page, off, k[:, 0],
                                   static_kv_scales["k"])
            _append_kv_page_static(v_pages, pool["v_scales"], page, off, v[:, 0],
                                   static_kv_scales["v"])
        else:
            _append_kv_page_quant(k_pages, pool["k_scales"], page, off, k[:, 0])
            _append_kv_page_quant(v_pages, pool["v_scales"], page, off, v[:, 0])
        scale_kw = {"k_scales": pool["k_scales"][:nb], "v_scales": pool["v_scales"][:nb]}
    else:
        k_pages[page, off] = k[:, 0].to(k_pages.dtype)
        v_pages[page, off] = v[:, 0].to(v_pages.dtype)
        scale_kw = {}
    lens_now = seq_lens + 1  # attend over positions < lens_now (self included)
    q0, kp, vp = _local_groups(p, q[:, 0], k_pages[:nb], v_pages[:nb])
    sh = getattr(p, "_shard", None)
    if scale_kw and sh is not None:
        scale_kw = {n: _kv_cut(sh, t[..., None])[..., 0] for n, t in scale_kw.items()}
    q0, softcap = q0.contiguous(), cfg.attn_logit_softcap
    if impl == "reference":
        out = paged_attention_reference(q0, kp, vp, block_table, lens_now,
                                        softcap=softcap, **scale_kw)
    else:
        resolve_paged_attn_impl(impl, q0.device)
        out = paged_decode_attention(q0, kp, vp, block_table, lens_now,
                                     softcap=softcap, attn_spec=attn_spec,
                                     assert_bounds=assert_bounds, watermarks=watermarks,
                                     **scale_kw)
    out, have = _heads_out(p, _unpad_heads(p, out)[:, None], B, 1)
    y = pmm(p, "wo", out, have=have)
    return y, pool


def decode_position(index, device) -> torch.Tensor:
    """The decode position as a 0-d int32 tensor on ``device``: a tensor is
    taken as it is (the captured decode step passes its device position),
    a Python int is filled in on the device (no host-to-device copy)."""
    if torch.is_tensor(index):
        return index
    return torch.full((), index, dtype=torch.int32, device=device)


def attention_decode(p: Attention, x, cfg: ModelConfig, cache_k, cache_v, index):
    """Single-token decode against (B, S_max, nkv, hd) caches. ``index``,
    the current position, is a 0-d int32 tensor on the caches' device (the
    reference's traced index) or a Python int: RoPE, the cache write and
    the mask read it on the device, so one captured step serves every
    position. The new K/V are written into the caches in place (the
    reference returns updated copies); returns (y, cache_k, cache_v)."""
    B, S1, _ = x.shape  # S1 == 1
    index = decode_position(index, x.device)
    q, k, v = _qkv(p, x, cfg, index.reshape(1, 1).expand(B, S1))
    at = index.reshape(1).long()
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = nh // nkv
    qg = q.reshape(B, nkv, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k).to(torch.float32)
    s = _softcap(s / math.sqrt(hd), cfg.attn_logit_softcap)
    valid = torch.arange(cache_k.shape[1], device=x.device) <= index
    s = s.masked_fill(~valid, -math.inf)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cache_v)
    y = pmm(p, "wo", out.reshape(B, 1, nh * hd))
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """The FFN's sites: ``wg``/``wu``/``wd`` (SwiGLU) or ``wi``/``wd`` (GELU)."""

    def __init__(self, **sites: nn.Module):
        super().__init__()
        for name, site in sites.items():
            setattr(self, name, site)


def mlp(p: MLP, x, cfg: ModelConfig):
    sh = getattr(p.wd, "_shard", None)
    mid = () if sh is None else sh.k  # the hidden layer in wd's K layout
    if cfg.act == "swiglu":
        h = F.silu(pmm(p, "wg", x, want=mid)) * pmm(p, "wu", x, want=mid)
    else:
        h = F.gelu(pmm(p, "wi", x, want=mid), approximate="tanh")  # jax.nn.gelu default
    return pmm(p, "wd", h, have=mid)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
class Embedding(nn.Module):
    """Token embedding (V_padded, d) and, unless tied, the LM head (V_padded, d)."""

    def __init__(self, embed: torch.Tensor, head: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.head = None if head is None else nn.Parameter(head, requires_grad=False)


def embed(p: Embedding, tokens, cfg: ModelConfig):
    sh = getattr(p, "_shard", None)
    if sh is None:
        return p.embed[tokens]
    # vocab rows sharded: look up the ids in this rank's range, zero
    # elsewhere, and sum over the vocab axes (one rank holds each row: exact)
    lo, hi = shard_range(cfg.vocab_padded, sh.mesh, sh.rows)
    ids = tokens - lo
    inside = (ids >= 0) & (ids < hi - lo)
    x = p.embed[torch.clamp(ids, 0, hi - lo - 1)].masked_fill(~inside[..., None], 0)
    x = all_reduce_sum(x, sh.mesh, sh.rows, exact=True)
    return relayout(x, -1, sh.cols, (), sh.mesh)


def lm_logits(p: Embedding, x, cfg: ModelConfig):
    head = p.head if p.head is not None else p.embed
    sh = getattr(p, "_shard", None)
    if sh is None:
        logits = x @ head.t()
    else:
        # vocab-sharded head: local logits over this rank's d columns
        # (summed over them), then gathered over the vocab, so every rank
        # samples from the same full row
        rows, cols = (sh.head_rows, sh.head_cols) if p.head is not None else (sh.rows, sh.cols)
        logits = relayout(x, -1, (), cols, sh.mesh) @ head.t()
        if cols:
            logits = all_reduce_sum(logits.to(torch.float32), sh.mesh, cols).to(x.dtype)
        logits = gather_dim(logits, -1, sh.mesh, rows)
    if cfg.vocab_padded != cfg.vocab:
        # mask pad rows so softmax/logsumexp are exact over the real vocab
        pad_mask = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad_mask, torch.finfo(logits.dtype).min)
    return logits
