"""Dense transformer adapters: GQA attention mixer + (SwiGLU | GELU) MLP
(port of ``repro/quant/families/dense.py``).

High precision (§C.1): RoPE, attention scores and softmax, the SwiGLU/GELU
nonlinearities, norms, embedding and LM head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _full_causal_attention, apply_rope

from .base import BlockAdapter, Pair, SiteSpec, TapContext, TapFn, both


def attn_mix(q, k, v, cfg: ModelConfig, positions):
    """Float attention mixing of projected (B, S, heads*hd) q/k/v: RoPE,
    causal softmax attention (the model's own functions)."""
    B, S, _ = q.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = apply_rope(q.reshape(B, S, nh, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, nkv, hd), positions, cfg.rope_theta)
    out = _full_causal_attention(q, k, v.reshape(B, S, nkv, hd), cfg)
    return out.reshape(B, S, nh * hd)


def _row_absmax(p: dict, names) -> torch.Tensor:
    return torch.amax(torch.abs(torch.cat([p[n] for n in names], dim=1)), dim=1)


def _scale_rows(p: dict, names, s_eq) -> dict:
    p = dict(p)
    for name in names:
        p[name] = p[name] * s_eq[:, None]
    return p


class AttentionAdapter(BlockAdapter):
    kind = "mixer"
    name = "attn"

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        d, hd = cfg.d_model, cfg.head_dim
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        return (
            SiteSpec("wq", ("wq",), d, nh * hd),
            SiteSpec("wk", ("wk",), d, nkv * hd),
            SiteSpec("wv", ("wv",), d, nkv * hd),
            SiteSpec("wo", ("wo",), nh * hd, d, use_bias=True),
        )

    def input_weight_absmax(self, p, cfg: ModelConfig):
        return _row_absmax(p, ("wq", "wk", "wv"))

    def scale_input_weights(self, p, s_eq, cfg: ModelConfig):
        return _scale_rows(p, ("wq", "wk", "wv"), s_eq)

    def forward_with_taps(self, p, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        q, k, v = tap("wq", x), tap("wk", x), tap("wv", x)
        mix = both(lambda qs, ks, vs: attn_mix(qs, ks, vs, ctx.cfg, ctx.positions), q, k, v)
        return tap("wo", mix)


class MLPAdapter(BlockAdapter):
    kind = "ffn"
    name = "mlp"

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        d, f = cfg.d_model, cfg.d_ff
        if cfg.act == "swiglu":
            return (
                SiteSpec("wg", ("wg",), d, f),
                SiteSpec("wu", ("wu",), d, f),
                SiteSpec("wd", ("wd",), f, d, use_bias=True),
            )
        return (
            SiteSpec("wi", ("wi",), d, f),
            SiteSpec("wd", ("wd",), f, d, use_bias=True),
        )

    @staticmethod
    def _inputs(cfg: ModelConfig):
        return ("wg", "wu") if cfg.act == "swiglu" else ("wi",)

    def input_weight_absmax(self, p, cfg: ModelConfig):
        return _row_absmax(p, self._inputs(cfg))

    def scale_input_weights(self, p, s_eq, cfg: ModelConfig):
        return _scale_rows(p, self._inputs(cfg), s_eq)

    def forward_with_taps(self, p, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        if ctx.cfg.act == "swiglu":
            mid = both(lambda gs, us: F.silu(gs) * us, tap("wg", x), tap("wu", x))
        else:
            mid = both(lambda h: F.gelu(h, approximate="tanh"), tap("wi", x))
        return tap("wd", mid)
