"""xLSTM adapters: mLSTM (matrix-memory) and sLSTM (scalar-memory) mixers
(port of ``repro/quant/families/xlstm.py``).

mLSTM quantizable sites: ``up`` (d, 2*d_in), ``wq``/``wk``/``wv``
(d_in, d_in) and ``down`` (d_in, d, corrected bias at runtime). The i/f
gate projections ``wi``/``wf`` (d_in, n_heads) stay in high precision: they
feed the exponential gating's log-space stabilizers.

sLSTM quantizable sites: ``w_in`` (d, 4d, the z/i/f/o input projection),
``up`` and ``down`` of the block FFN. The block-diagonal recurrent matrices
``r`` stay in high precision, inside the nonlinear recurrence.

The cells (chunkwise-parallel mLSTM, the sLSTM scan) are the model's own
functions (:mod:`repro_torch.models.xlstm`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import _causal_conv
from repro_torch.models.xlstm import (
    _mlstm_merge,
    mlstm_cell_chunkwise,
    slstm_headnorm,
    slstm_scan,
)

from .base import BlockAdapter, Pair, SiteSpec, TapContext, TapFn, both


class MLSTMAdapter(BlockAdapter):
    kind = "mixer"
    name = "mlstm"

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        d = cfg.d_model
        d_in = cfg.xlstm.mlstm_expand * d
        return (
            SiteSpec("up", ("up",), d, 2 * d_in),
            SiteSpec("wq", ("wq",), d_in, d_in),
            SiteSpec("wk", ("wk",), d_in, d_in),
            SiteSpec("wv", ("wv",), d_in, d_in),
            SiteSpec("down", ("down",), d_in, d, use_bias=True),
        )

    def input_weight_absmax(self, p, cfg: ModelConfig):
        return torch.amax(torch.abs(p["up"]), dim=1)

    def scale_input_weights(self, p, s_eq, cfg: ModelConfig):
        p = dict(p)
        p["up"] = p["up"] * s_eq[:, None]
        return p

    def forward_with_taps(self, p, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        cfg = ctx.cfg
        xl = cfg.xlstm
        d_in = xl.mlstm_expand * cfg.d_model
        heads = xl.mlstm_heads
        dh = d_in // heads

        xz = tap("up", x)
        xin = both(lambda t: t[..., :d_in], xz)
        z = both(lambda t: t[..., d_in:], xz)
        xc = both(lambda t: F.silu(_causal_conv(t, p["conv_w"], p["conv_b"])[0]), xin)
        q = tap("wq", xc)
        k = tap("wk", xc)
        v = tap("wv", xin)

        def cell_merge(qs, ks, vs, xcs, xins, zs):
            B, S, _ = qs.shape
            qh = qs.reshape(B, S, heads, dh).transpose(1, 2) * (dh ** -0.5)
            kh = ks.reshape(B, S, heads, dh).transpose(1, 2)
            vh = vs.reshape(B, S, heads, dh).transpose(1, 2)
            ig = (xins @ p["wi"]).transpose(1, 2).to(torch.float32)
            fg = (xins @ p["wf"] + p["f_bias"]).transpose(1, 2).to(torch.float32)
            h_cell = mlstm_cell_chunkwise(qh, kh, vh, ig, fg, xl.chunk)
            return _mlstm_merge(p["norm_w"], p["skip"], h_cell, xcs, zs)

        merged = both(cell_merge, q, k, v, xc, xin, z)
        return tap("down", merged)


class SLSTMAdapter(BlockAdapter):
    kind = "mixer"
    name = "slstm"

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        d = cfg.d_model
        f = int(d * cfg.xlstm.slstm_proj_factor)
        return (
            SiteSpec("w_in", ("w_in",), d, 4 * d),
            SiteSpec("up", ("up",), d, f),
            SiteSpec("down", ("down",), f, d, use_bias=True),
        )

    def input_weight_absmax(self, p, cfg: ModelConfig):
        return torch.amax(torch.abs(p["w_in"]), dim=1)

    def scale_input_weights(self, p, s_eq, cfg: ModelConfig):
        p = dict(p)
        p["w_in"] = p["w_in"] * s_eq[:, None]
        return p

    def forward_with_taps(self, p, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        cfg = ctx.cfg
        proj = both(lambda t: t + p["b"], tap("w_in", x))
        h = both(lambda pr: slstm_scan(p["r"], pr, cfg)[0].to(x[1].dtype), proj)
        hn = both(lambda hs: slstm_headnorm(p["norm_w"], hs, cfg), h)
        mid = both(lambda t: F.gelu(t, approximate="tanh"), tap("up", hn))
        return tap("down", mid)
