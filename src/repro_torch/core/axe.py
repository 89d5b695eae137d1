"""AXE orchestration: quantize one linear layer end to end (port of
``repro/core/axe.py``; paper §3.3).

Given a layer's float weights and its streamed calibration statistics,
produce integer codes that minimize the layer's reconstruction error (GPFQ
or OPTQ) and provably never overflow the requested accumulation datapath
(monolithic P bits, or multi-stage (T, P_I) tiles). The result bundles
codes, per-channel scales, the activation quantizer, the corrected bias,
the certificate and the serving :class:`~repro_torch.quant.spec.DatapathSpec`.

Calibration takes float32 weights, as the reference does (its solvers fail
on bfloat16 weights); other dtypes raise ``TypeError``. Expert-stacked
(E, K, C) weights (an MoE FFN's sites) are solved one expert at a time
with the shared statistics, the reference's ``vmap`` over the stack: E
solves (E launches of the GPFQ kernel on CUDA tensors), a certificate an
expert and the bias correction as the stack's (E, 1, C) bias.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from .alphabet import (
    Alphabet,
    act_alphabet,
    min_accumulator_bits,
    outer_accumulator_bits,
    strict_budgets,
    weight_alphabet,
)
from .calibration import LayerStats
from .ep_init import ep_init, tiled, untiled
from .equalization import bias_correction
from .gpfq import AxeConfig, GreedyResult, gpfq_memory_efficient
from .optq import optq
from .overflow import CertReport, StackedCertReport, certify, certify_stacked
from .quantizers import (
    ROUND_NEAREST,
    ActQuantParams,
    fake_quantize_act,
    quantize_weights_rtn,
    to_int_domain,
    weight_scales,
)
from .sparsity import mask_2to4, validate_sparsity

GPFQ = "gpfq"
OPTQ = "optq"
RTN = "rtn"  # direct round-to-nearest baseline
EPINIT = "ep_init"  # projection + round-to-zero baseline (A2Q+ post hoc)


@dataclass(frozen=True)
class PTQConfig:
    """One knob object for the whole PTQ recipe; defaults follow the
    paper's LLM setting (W4A8, GPFQ, T=128 tiles into a 16-bit inner
    accumulator, round-to-nearest, soft + strict constraints, unsigned
    activations with 99th-percentile ranges)."""

    w_bits: int = 4
    act_bits: int = 8
    act_signed: bool = False
    algorithm: str = GPFQ
    constrain: bool = True
    p_bits: int = 16
    tile: int | None = 128
    sparsity: str | None = None
    rounding: str = ROUND_NEAREST
    soft: bool = True
    strict: bool = True
    z_multiplier: float = 1.0
    act_order: bool = True
    act_percentile: float = 99.0
    damp_frac: float = 0.01  # OPTQ hessian damping
    gpfq_eta: float = 1e-6  # GPFQ sqrt damping

    @property
    def w_alphabet(self) -> Alphabet:
        return weight_alphabet(self.w_bits)

    @property
    def act_alphabet(self) -> Alphabet:
        return act_alphabet(self.act_bits, signed=self.act_signed)

    @property
    def axe(self) -> AxeConfig | None:
        if not self.constrain:
            return None
        return AxeConfig(p_bits=self.p_bits, tile=self.tile, soft=self.soft,
                         strict=self.strict, z_multiplier=self.z_multiplier)

    def naive_p_star(self, k: int) -> int:
        """Eq. 3 bound for this (M, N) pair."""
        return min_accumulator_bits(k, self.act_bits, self.w_bits, self.act_signed,
                                    sparsity=self.sparsity)

    def outer_bits(self, k: int) -> int:
        if not self.constrain:
            return 32
        if self.tile is None:
            return self.p_bits
        return outer_accumulator_bits(self.p_bits, k, self.tile, sparsity=self.sparsity)

    def to_datapath_spec(self, k: int, act: ActQuantParams | None = None):
        """The per-site serving datapath this recipe certifies for a K-deep
        site (P_O from Eq. 22), with the calibrated static activation
        quantizer when ``act`` is given."""
        from repro_torch.quant.spec import DatapathSpec

        spec = DatapathSpec(
            w_bits=self.w_bits,
            act_bits=self.act_bits,
            act_signed=self.act_signed,
            tile=self.tile if self.constrain else None,
            p_inner=self.p_bits if self.constrain else 32,
            p_outer=self.outer_bits(k),
            sparsity=self.sparsity,
        )
        if act is not None:
            spec = spec.with_act(act.scale, act.zero_point)
        return spec


@dataclass
class QuantizedLinear:
    """Deployable artifact for one linear layer."""

    q_int: torch.Tensor  # (K, C) integer codes, (E, K, C) for an expert stack
    scale: torch.Tensor  # (1, C), or (E, 1, C)
    act: ActQuantParams
    bias: torch.Tensor | None  # (C,) corrected bias, or (E, 1, C)
    cert: CertReport | StackedCertReport | None
    cfg: PTQConfig
    spec: object | None = None  # the certified serving DatapathSpec
    aux: dict = field(default_factory=dict)

    @property
    def stacked(self) -> bool:
        return self.q_int.dim() == 3

    @property
    def w_q(self) -> torch.Tensor:
        return self.q_int * self.scale

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Simulated-quantized forward (fake-quant activations, real matmul)."""
        y = fake_quantize_act(x, self.act) @ self.w_q
        if self.bias is not None:
            y = y + self.bias
        return y


def _make_solver(stats: LayerStats, cfg: PTQConfig, k: int):
    """solve((K, C) w) -> GreedyResult, with the stats-derived quantities
    (eigendecomposition / Hessian) computed once."""
    validate_sparsity(cfg.sparsity)
    if cfg.algorithm == GPFQ:
        h_half, g = stats.gpfq_stats(cfg.gpfq_eta)

        def solve(w):
            return gpfq_memory_efficient(w, h_half, g, cfg.w_alphabet, cfg.act_alphabet,
                                         axe=cfg.axe, rounding=cfg.rounding,
                                         act_order=cfg.act_order, sparsity=cfg.sparsity)
    elif cfg.algorithm == OPTQ:
        hess = stats.optq_hessian(cfg.damp_frac)

        def solve(w):
            return optq(w, hess, cfg.w_alphabet, cfg.act_alphabet, axe=cfg.axe,
                        rounding=cfg.rounding, act_order=cfg.act_order,
                        sparsity=cfg.sparsity)
    elif cfg.algorithm == RTN:

        def solve(w):
            q_int, scale = quantize_weights_rtn(w, cfg.w_alphabet, cfg.rounding)
            if cfg.sparsity is not None:  # mask, then round: no error feedback
                q_int = q_int * mask_2to4(q_int)
            return GreedyResult(q_int=q_int, scale=scale, w_alphabet=cfg.w_alphabet)
    elif cfg.algorithm == EPINIT:
        axe = cfg.axe or AxeConfig(p_bits=cfg.p_bits, tile=cfg.tile)
        budgets = strict_budgets(axe.p_bits, cfg.act_alphabet, 0.0)
        t = axe.tile or k

        def solve(w):
            scale = weight_scales(w, cfg.w_alphabet)
            w_int = to_int_domain(w, scale)
            if cfg.sparsity is not None:  # l1 projection and RTZ keep zeros at zero
                w_int = w_int * mask_2to4(w_int)
            # each tile row onto the l1 ball of the strict radius; RTZ keeps
            # it valid after rounding (A2Q+ / §2.3)
            q_ct = ep_init(tiled(w_int.T, t), budgets.B, cfg.w_alphabet)
            return GreedyResult(q_int=untiled(q_ct, k).T, scale=scale,
                                w_alphabet=cfg.w_alphabet)
    else:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
    return solve


def check_weight(w: torch.Tensor) -> None:
    """Raise on weights calibration does not take: any shape but (K, C) or
    an (E, K, C) expert stack, and any dtype but float32."""
    if w.dim() not in (2, 3):
        raise ValueError(f"calibration takes (K, C) or (E, K, C) weights, got {tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise TypeError(
            f"calibration takes float32 weights, got {w.dtype}: the reference's "
            f"solvers fail on them too (repro/core/gpfq.py mixes bfloat16 weights "
            f"with its float32 state); calibrate from a float32 copy of the model")


def quantize_linear(w: torch.Tensor, stats: LayerStats, cfg: PTQConfig,
                    bias: torch.Tensor | None = None) -> QuantizedLinear:
    """Quantize one (K, C) float32 linear layer from its streamed statistics,
    or an (E, K, C) expert stack: each expert solved on its own with the
    shared statistics (exactly quantizing each slice alone), a certificate
    an expert, and the corrected bias (E, 1, C); a stack takes no input
    bias."""
    check_weight(w)
    k = w.shape[-2]
    if stats.k != k:
        raise ValueError(f"stats built for K={stats.k}, weights have K={k}")
    act_params = stats.observer.act_quant(cfg.act_alphabet)
    dp_spec = cfg.to_datapath_spec(k, act_params)
    solve = _make_solver(stats, cfg, k)
    want_cert = cfg.constrain or cfg.algorithm == EPINIT
    if w.dim() == 3:  # expert stack
        if bias is not None:
            raise ValueError("stacked quantization does not take an input bias")
        results = [solve(we) for we in w]
        q_int = torch.stack([r.q_int for r in results])
        scale = torch.stack([r.scale for r in results])
        delta = torch.einsum("k,ekc->ec", stats.x_mean.to(w.dtype), w - q_int * scale)
        cert = (certify_stacked(q_int, cfg.act_alphabet, cfg.p_bits, cfg.tile,
                                sparsity=cfg.sparsity) if want_cert else None)
        return QuantizedLinear(q_int=q_int, scale=scale, act=act_params,
                               bias=delta[:, None, :], cert=cert, cfg=cfg, spec=dp_spec)
    res = solve(w)
    new_bias = bias_correction(stats.x_mean, w, res.w_q, bias)
    cert = (certify(res.q_int, cfg.act_alphabet, cfg.p_bits, cfg.tile, sparsity=cfg.sparsity)
            if want_cert else None)
    return QuantizedLinear(q_int=res.q_int, scale=res.scale, act=act_params, bias=new_bias,
                           cert=cert, cfg=cfg, spec=dp_spec, aux=res.aux)


def sweep_config(cfg: PTQConfig, **updates) -> PTQConfig:
    """Replace fields on a frozen config (Pareto sweeps)."""
    return replace(cfg, **updates)


__all__ = [
    "EPINIT",
    "GPFQ",
    "OPTQ",
    "RTN",
    "PTQConfig",
    "QuantizedLinear",
    "check_weight",
    "quantize_linear",
    "sweep_config",
]
