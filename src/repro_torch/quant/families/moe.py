"""MoE FFN adapter: GShard-style top-k routed experts with expert-stacked
(E, K, C) weights (port of ``repro/quant/families/moe.py``).

The quantizable sites are the stacked expert matrices: AXE applies per
expert slice, since each expert runs an ordinary K-deep reduction, and
:func:`~repro_torch.core.axe.quantize_linear` solves a stack one expert at
a time with a certificate an expert.

High precision (§C.1): the router's logits, softmax and top-k, and the
dispatch/combine einsums (0/1 and gate-weighted mixing, not reductions over
quantized weights).

The statistics of the expert up-projections come from the pre-dispatch
tokens (the normed block input): every expert takes a capacity-selected
subset of those rows, so the shared (K, K) statistics stay O(K^2) whatever
the expert count. Lockstep calibration routes on the quantized stream (what
the deployed network routes on) and applies the same dispatch to the analog
stream, so the (X, Xq) rows stay paired.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import route

from .base import BlockAdapter, Pair, SiteSpec, TapContext, TapFn, both


class MoEAdapter(BlockAdapter):
    kind = "ffn"
    name = "moe"

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        mo = cfg.moe
        d, f, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
        if cfg.act == "swiglu":
            return (
                SiteSpec("wg", ("wg",), d, f, stacked=e),
                SiteSpec("wu", ("wu",), d, f, stacked=e),
                SiteSpec("wd", ("wd",), f, d, stacked=e, use_bias=True),
            )
        return (
            SiteSpec("wi", ("wi",), d, f, stacked=e),
            SiteSpec("wd", ("wd",), f, d, stacked=e, use_bias=True),
        )

    @staticmethod
    def _inputs(cfg: ModelConfig):
        return ("wg", "wu") if cfg.act == "swiglu" else ("wi",)

    def input_weight_absmax(self, p, cfg: ModelConfig):
        cat = torch.cat([p[n] for n in self._inputs(cfg)], dim=2)  # (E, d, sum f)
        return torch.amax(torch.abs(cat), dim=(0, 2))

    def scale_input_weights(self, p, s_eq, cfg: ModelConfig):
        p = dict(p)
        for name in self._inputs(cfg):
            p[name] = p[name] * s_eq[None, :, None]
        # the router consumes the normed input too: scaling it keeps the
        # float function, and so the routing, unchanged
        p["router"] = p["router"] * s_eq[:, None]
        return p

    def forward_with_taps(self, p, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        cfg = ctx.cfg
        B, S, d = x[1].shape
        e = cfg.moe.n_experts
        # route on the quantized stream with the model's own routing, then
        # apply the same dispatch to both streams
        xf_q, dispatch, combine, _, _, c = route(p["router"], x[1], cfg)
        G, g, _ = xf_q.shape
        xf = (xf_q, xf_q) if x[0] is x[1] else (x[0].reshape(G, g, d), xf_q)
        xe = both(lambda t: torch.einsum("gsec,gsd->egcd", dispatch, t).reshape(e, G * c, d),
                  xf)
        if cfg.act == "swiglu":
            hg = tap("wg", xe, stats_from=x)
            hu = tap("wu", xe, stats_from=x)
            mid = both(lambda a, b: F.silu(a) * b, hg, hu)
        else:
            mid = both(lambda h: F.gelu(h, approximate="tanh"), tap("wi", xe, stats_from=x))
        ye = tap("wd", mid)  # (E, G*c, d)

        def comb(ys):
            y = torch.einsum("gsec,egcd->gsd", combine, ys.reshape(e, G, c, d))
            return y.reshape(B, S, d).to(x[1].dtype)

        return both(comb, ye)
