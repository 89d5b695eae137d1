"""Core layers (port of ``repro/models/layers.py``, dense serving path):
norms, RoPE, GQA attention (full, online-softmax chunked, decode), the
SwiGLU/GELU MLP, embedding and LM head, and the packed-weight matmul
dispatch that routes every quantized site onto the W4A8 datapath.

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
from repro_torch.kernels.w4a8_mm import (
    datapath_kernel_args,
    unpack_int4,
    w4a8_decode_matmul,
)
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


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


class Linear(nn.Module):
    """A float site: ``x @ w`` with ``w`` (K, N), plus the corrected bias
    when the site is a high-precision leaf of a calibrated artifact."""

    def __init__(self, w: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        if self.bias is not None:
            y = y + self.bias.reshape(-1).to(y.dtype)
        return y


class PackedLinear(nn.Module):
    """A packed-int4 serving site (the reference's packed leaf dict).

    Buffers: ``packed`` (K//2, N) int8, ``scale`` (1, N) per-channel weight
    scales, ``col_sums`` (1, N) int32 pack-time code sums (None on legacy
    artifacts until :func:`~repro_torch.quant.serve_packed.ensure_col_sums`),
    ``spec_arr`` the persistable spec twin, and optional ``act_scale`` /
    ``act_zp`` (0-d f32, a calibrated static activation quantizer) and
    ``bias`` (N,). ``spec`` is the site's
    :class:`~repro_torch.quant.spec.DatapathSpec`."""

    def __init__(self, packed, scale, col_sums=None, spec=None, spec_arr=None,
                 act_scale=None, act_zp=None, bias=None):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)
        self.register_buffer("col_sums", col_sums)
        self.register_buffer("spec_arr", spec_arr)
        self.register_buffer("act_scale", act_scale)
        self.register_buffer("act_zp", act_zp)
        self.register_buffer("bias", bias)
        self.spec = spec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return packed_linear(x, self)


def dequant_weight(leaf: PackedLinear) -> torch.Tensor:
    """Dequantized (K, N) weight of a packed site, in the scale's dtype."""
    return unpack_int4(leaf.packed).to(leaf.scale.dtype) * leaf.scale


def _static_act_codes(x2, leaf: PackedLinear, spec: DatapathSpec):
    """Activation codes from the site's calibrated static quantizer: pure
    elementwise ops, codes in the certificate's alphabet."""
    scale = leaf.act_scale.to(torch.float32).reshape(())
    zp = leaf.act_zp.to(torch.float32).reshape(())
    alpha = act_alphabet(spec.act_bits, signed=spec.act_signed)
    codes = torch.clamp(torch.round(x2.to(torch.float32) / scale) + zp,
                        alpha.qmin, alpha.qmax)
    return codes.to(torch.int8 if spec.act_signed else torch.uint8), scale, zp


def packed_linear(x, leaf: PackedLinear, *, spec: DatapathSpec | None = None,
                  assert_inner: bool = False):
    """x: (..., K) through a packed site -> (..., N) in ``x``'s dtype.

    The accumulation datapath (T, P_I) and the activation quantizer come
    from the site's embedded spec; ``spec`` is a request, and one that
    disagrees raises :class:`DatapathMismatchError`. Static activation
    quantizers run when the site ships them; otherwise the dynamic
    per-tensor quantizer runs."""
    embedded = leaf.spec
    if spec is not None and embedded is not None:
        embedded.require_matches(spec, context="packed_linear")
    resolved = embedded if embedded is not None else (spec or DatapathSpec())
    if resolved.sparsity is not None:
        raise DatapathMismatchError(
            f"packed_linear: sparsity={resolved.sparsity!r} sites are served "
            f"by the 2:4 slice of the port, not yet ported")

    backend = packed_backend()
    if backend == "dequant":
        w = dequant_weight(leaf)
        dt = torch.promote_types(x.dtype, w.dtype)
        y = x.to(dt) @ w.to(dt)
        if leaf.bias is not None:
            y = y + leaf.bias.reshape(-1).to(y.dtype)
        return y

    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if resolved.static_act and leaf.act_scale is not None:
        codes, act_scale, act_zp = _static_act_codes(x2, leaf, resolved)
    else:
        codes, act_scale, act_zp = quantize_activations(x2)
    col_sums = leaf.col_sums
    if col_sums is None:  # legacy artifact without the pack-time term
        col_sums = unpack_int4(leaf.packed).to(torch.int32).sum(dim=-2)
    y = w4a8_decode_matmul(
        codes,
        leaf.packed,
        leaf.scale.reshape(-1).to(torch.float32),
        col_sums.reshape(-1),
        act_scale,
        act_zp,
        **datapath_kernel_args(resolved),
        assert_inner=assert_inner,
        out_dtype=x.dtype,
        reference=(backend == "reference"),
    )
    y = y.reshape(*lead, y.shape[-1])
    if leaf.bias is not None:
        y = y + leaf.bias.reshape(-1).to(y.dtype)
    return y


def pmm(p: nn.Module, name: str, x):
    """``x @ p.<name>`` through whichever site module sits there: the seam
    every quantizable-site matmul goes through."""
    return getattr(p, name)(x)


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
    B, S, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = pmm(p, "wq", x).reshape(B, S, nh, hd)
    k = pmm(p, "wk", x).reshape(B, S, nkv, hd)
    v = pmm(p, "wv", x).reshape(B, S, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def attention(p: Attention, x, cfg: ModelConfig, positions):
    """Prefill attention. Returns (y, (k, v)), k/v for the cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if S > cfg.attn_chunk_threshold:
        out = _chunked_causal_attention(q, k, v, cfg)
    else:
        out = _full_causal_attention(q, k, v, cfg)
    y = pmm(p, "wo", out.reshape(B, S, cfg.n_heads * cfg.head_dim))
    return y, (k, v)


def attention_decode(p: Attention, x, cfg: ModelConfig, cache_k, cache_v, index: int):
    """Single-token decode against (B, S_max, nkv, hd) caches. ``index`` is
    the current position. The new K/V are written into the caches in place
    (the reference returns updated copies); returns (y, cache_k, cache_v)."""
    B, S1, _ = x.shape  # S1 == 1
    positions = torch.full((B, S1), index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    cache_k[:, index:index + 1] = k.to(cache_k.dtype)
    cache_v[:, index:index + 1] = v.to(cache_v.dtype)
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
    if cfg.act == "swiglu":
        h = F.silu(pmm(p, "wg", x)) * pmm(p, "wu", x)
    else:
        h = F.gelu(pmm(p, "wi", x), approximate="tanh")  # jax.nn.gelu default
    return pmm(p, "wd", h)


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
    return p.embed[tokens]


def lm_logits(p: Embedding, x, cfg: ModelConfig):
    head = p.head if p.head is not None else p.embed
    logits = x @ head.t()
    if cfg.vocab_padded != cfg.vocab:
        # mask pad rows so softmax/logsumexp are exact over the real vocab
        pad_mask = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad_mask, torch.finfo(logits.dtype).min)
    return logits
