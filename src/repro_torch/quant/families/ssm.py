"""Mamba-1 selective-SSM mixer adapter (port of
``repro/quant/families/ssm.py``).

Quantizable sites, the four dense projections around the scan:

  * ``in_proj``  (d_model, 2*d_in): the x/z up-projection
  * ``x_proj``   (d_in, dt_rank + 2N): input-dependent (dt, B, C) heads
  * ``dt_proj``  (dt_rank, d_in): the low-rank dt expansion
  * ``out_proj`` (d_in, d_model): output projection (carries the corrected
    bias at runtime, like the dense family's ``wo``)

High precision (the paper's §C.1 exclusions): the depthwise causal conv,
the SiLU gates, softplus(dt), the A/D state parameters and the selective
scan itself (a data-dependent recurrence, not a static-weight reduction).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import _causal_conv, selective_scan

from .base import BlockAdapter, Pair, SiteSpec, TapContext, TapFn, both


class MambaAdapter(BlockAdapter):
    kind = "mixer"
    name = "mamba"

    def enumerate_sites(self, cfg: ModelConfig) -> tuple[SiteSpec, ...]:
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        dtr = cfg.dt_rank
        return (
            SiteSpec("in_proj", ("in_proj",), d, 2 * d_in),
            SiteSpec("x_proj", ("x_proj",), d_in, dtr + 2 * s.d_state),
            SiteSpec("dt_proj", ("dt_proj",), dtr, d_in),
            SiteSpec("out_proj", ("out_proj",), d_in, d, use_bias=True),
        )

    def input_weight_absmax(self, p, cfg: ModelConfig):
        return torch.amax(torch.abs(p["in_proj"]), dim=1)

    def scale_input_weights(self, p, s_eq, cfg: ModelConfig):
        p = dict(p)
        p["in_proj"] = p["in_proj"] * s_eq[:, None]
        return p

    def forward_with_taps(self, p, x: Pair, ctx: TapContext, tap: TapFn) -> Pair:
        cfg = ctx.cfg
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        dtr = cfg.dt_rank

        xz = tap("in_proj", x)
        xin_raw = both(lambda t: t[..., :d_in], xz)
        z = both(lambda t: t[..., d_in:], xz)
        xin = both(lambda t: F.silu(_causal_conv(t, p["conv_w"], p["conv_b"])[0]), xin_raw)

        proj = tap("x_proj", xin)
        dt_r = both(lambda t: t[..., :dtr], proj)
        b_ssm = both(lambda t: t[..., dtr:dtr + s.d_state], proj)
        c_ssm = both(lambda t: t[..., dtr + s.d_state:], proj)
        dt = both(lambda t: F.softplus(t + p["dt_bias"]), tap("dt_proj", dt_r))

        a = -torch.exp(p["A_log"].to(torch.float32))
        y = both(lambda xi, d_, b_, c_: selective_scan(xi, d_, b_, c_, a, p["D"], s.d_state),
                 xin, dt, b_ssm, c_ssm)
        gated = both(lambda ys, zs: ys.to(zs.dtype) * F.silu(zs), y, z)
        return tap("out_proj", gated)
