"""Dense transformer adapters: GQA attention mixer + (SwiGLU | GELU) MLP
(port of ``repro/quant/families/dense.py``, site enumeration)."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from .base import BlockAdapter, SiteSpec


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
