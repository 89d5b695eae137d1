"""End-to-end AXE PTQ pipeline for decoder LMs (port of
``repro/quant/pipeline.py``; paper §4 recipe):

  float model -> [SmoothQuant equalization] -> layer-by-layer calibration
  with lockstep analog/quantized propagation (GPFQ's "first l-1 layers
  quantized" setup, Eq. 9) -> AXE-GPFQ / AXE-OPTQ per linear site -> bias
  correction -> overflow certificate -> quantized model.

It walks the port's :class:`~repro_torch.models.transformer.Transformer`
blocks; each component is handled by its registered adapter
(:mod:`repro_torch.quant.families`), whose tap-forward routes every
quantizable matmul through the pipeline. The model is not modified:
equalization works on copies of the norm and site weights. Embedding and LM
head stay high precision (§C.1). :func:`quantized_forward` is the
simulated-integer forward (fake-quant activations and dequantized weights,
in f32); the packed W4A8 path is :mod:`repro_torch.quant.serve_packed`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.axe import PTQConfig, QuantizedLinear, quantize_linear, sweep_config
from repro_torch.core.calibration import LayerStats
from repro_torch.core.equalization import smoothquant_scales
from repro_torch.core.quantizers import fake_quantize_act
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import embed, lm_logits, norm

from .families import SiteSpec, TapContext, check_supported, get_adapter
from .spec import DatapathMismatchError


@dataclass
class QuantizedComponent:
    """One quantized block component (mixer or ffn): ``params`` keeps its
    high-precision weights (quantized sites set to None), ``linears`` maps
    site name -> :class:`~repro_torch.core.axe.QuantizedLinear`, ``specs``
    site name -> :class:`SiteSpec`."""

    adapter: str
    kind: str
    params: dict
    linears: dict[str, QuantizedLinear]
    specs: dict[str, SiteSpec]


@dataclass
class QuantizedBlock:
    """One decoder layer: its quantized components plus the float norms
    ({"w", optional "b"} tensors, equalization folded in)."""

    spec: LayerSpec
    norm1: dict | None = None
    norm2: dict | None = None
    mixer: QuantizedComponent | None = None
    ffn: QuantizedComponent | None = None

    def quantized_linears(self) -> Iterator[tuple[str, QuantizedLinear]]:
        """Yield ("mixer.wq"-style qualified name, QuantizedLinear)."""
        for comp_name in ("mixer", "ffn"):
            comp = getattr(self, comp_name)
            if comp is not None:
                for name, ql in comp.linears.items():
                    yield f"{comp_name}.{name}", ql


@dataclass
class QuantizedModel:
    cfg: ModelConfig
    ptq: PTQConfig
    embedding: object  # the float model's Embedding module (high precision)
    final_norm: object  # its final Norm module
    blocks: list[QuantizedBlock] = field(default_factory=list)

    def quantized_linears(self) -> Iterator[tuple[str, QuantizedLinear]]:
        """Yield ("layer3/ffn.wd", QuantizedLinear) over the whole model."""
        for i, b in enumerate(self.blocks):
            for name, ql in b.quantized_linears():
                yield f"layer{i}/{name}", ql

    def datapath_specs(self) -> dict:
        """{"layer3/ffn.wd": DatapathSpec}: the per-site serving datapaths
        this model was certified for (static act quantizers included)."""
        return {name: ql.spec for name, ql in self.quantized_linears()}

    @property
    def certified(self) -> bool:
        return all(ql.cert is None or bool(ql.cert) for _, ql in self.quantized_linears())

    def cert_summary(self) -> dict:
        """Aggregate certificate report; a model with no certificate reports
        ``ok: False`` (absence of a certificate is not a guarantee), and
        ``min_headroom_site`` names the binding site."""
        worst = worst_site = None
        n = 0
        for name, ql in self.quantized_linears():
            if ql.cert is not None:
                h = ql.cert.headroom_bits
                if worst is None or h < worst:
                    worst, worst_site = h, name
                n += 1
        return {
            "n_certified": n,
            "min_headroom_bits": worst,
            "min_headroom_site": worst_site,
            "ok": n > 0 and self.certified,
        }


def _flat(x):
    return x.reshape(-1, x.shape[-1])


def _norm_dict(module) -> dict:
    out = {"w": module.w.detach()}
    if module.b is not None:
        out["b"] = module.b.detach()
    return out


def _norm(nrm: dict, x, kind: str):
    return norm(SimpleNamespace(w=nrm["w"], b=nrm.get("b")), x, kind)


def _apply_quantized(ql: QuantizedLinear, x, use_bias: bool):
    """Simulated-integer site: fake-quant activations, matmul against the
    dequantized weight, optional corrected bias."""
    y = fake_quantize_act(x, ql.act) @ ql.w_q
    if use_bias and ql.bias is not None:
        y = y + ql.bias
    return y


def _site_ptq(ptq: PTQConfig, site: SiteSpec, override) -> PTQConfig:
    """Per-site PTQConfig: a plan entry wins, then the site's own datapath,
    then the model-wide config. A >= 32-bit inner register means the
    unconstrained solver."""
    dp = override if override is not None else site.datapath
    if dp is None:
        return ptq
    constrained = dp.p_inner is not None and dp.p_inner < 32
    return sweep_config(
        ptq,
        w_bits=dp.w_bits,
        act_bits=dp.act_bits,
        act_signed=dp.act_signed,
        p_bits=dp.p_inner if constrained else ptq.p_bits,
        tile=dp.tile if constrained else ptq.tile,
        constrain=constrained,
        sparsity=dp.sparsity if site.k % 4 == 0 else None,
    )


def _calibrate_component(adapter, p: dict, nrm: dict, x_a, x_q, cfg, ptq, positions,
                         equalize: bool, plan=None, site_prefix: str = ""):
    """Norm -> optional SmoothQuant fold -> tapped dual-stream forward.
    Returns ((y_a, y_q), QuantizedComponent, updated norm dict)."""
    h_a = _norm(nrm, x_a, cfg.norm)
    h_q = _norm(nrm, x_q, cfg.norm)
    if equalize:
        w_absmax = adapter.input_weight_absmax(p, cfg)
        if w_absmax is not None:
            s_eq = smoothquant_scales(torch.amax(torch.abs(_flat(h_q)), dim=0), w_absmax)
            nrm = {k: v / s_eq for k, v in nrm.items()}
            h_a = _norm(nrm, x_a, cfg.norm)
            h_q = _norm(nrm, x_q, cfg.norm)
            p = adapter.scale_input_weights(p, s_eq, cfg)

    specs = {s.name: s for s in adapter.enumerate_sites(cfg)}
    linears: dict[str, QuantizedLinear] = {}
    # stats shared by sites fed the same activation pair (wq/wk/wv), keyed
    # by identity so the O(K^2) accumulation runs once per distinct input
    stats_cache: list[tuple[torch.Tensor, torch.Tensor, LayerStats]] = []

    def tap(name, xp, stats_from=None):
        spec = specs[name]
        sa, sq = stats_from if stats_from is not None else xp
        stats = next((cs for ca, cq, cs in stats_cache
                      if ca is sa and cq is sq and cs.k == spec.k), None)
        if stats is None:
            stats = LayerStats(k=spec.k, device=sa.device)
            stats.update(_flat(sa), _flat(sq))
            stats_cache.append((sa, sq, stats))
        w = p[name]
        override = plan.get(site_prefix + name) if plan else None
        ql = quantize_linear(w, stats, _site_ptq(ptq, spec, override))
        ql.aux["observer"] = stats.observer
        linears[name] = ql
        x_a_in, x_q_in = xp
        return (x_a_in @ w, _apply_quantized(ql, x_q_in, spec.use_bias))

    ctx = TapContext(cfg=cfg, positions=positions)
    y_a, y_q = adapter.forward_with_taps(p, (h_a, h_q), ctx, tap)
    params = {k: (None if k in specs else v) for k, v in p.items()}
    comp = QuantizedComponent(adapter=adapter.name, kind=adapter.kind, params=params,
                              linears=linears, specs=specs)
    return (y_a, y_q), comp, nrm


def _component_params(module, adapter, cfg) -> dict:
    """The component's float site weights as a dict keyed by site name."""
    return {s.name: getattr(module, s.path[-1]).w.detach() for s in adapter.enumerate_sites(cfg)}


def _tokens(batches, device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([np.asarray(b["tokens"]) for b in batches], axis=0),
                           dtype=torch.long, device=device)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


@torch.inference_mode()
def calibrate_and_quantize(model, cfg: ModelConfig, batches: list[dict], ptq: PTQConfig,
                           equalize: bool = True, plan=None, *,
                           device="cuda") -> QuantizedModel:
    """Run the full PTQ pipeline on ``model`` (a float32
    :class:`~repro_torch.models.transformer.Transformer` on ``device``).
    ``batches``: list of {"tokens": (B, S)}. ``plan``: optional slot-granular
    overrides {"slot{s}/{mixer|ffn}.{site}": DatapathSpec}; a key naming no
    site raises :class:`~repro_torch.quant.spec.DatapathMismatchError`."""
    dev = resolve_device(device)
    check_supported(cfg)
    if model.embedding.embed.device.type != dev.type:
        raise ValueError(f"model lies on {model.embedding.embed.device}, calibration "
                         f"runs on {dev}")
    tokens = _tokens(batches, dev)
    positions = _positions(tokens)
    x_a = embed(model.embedding, tokens, cfg)  # analog activations
    x_q = x_a  # quantized-network activations (lockstep)
    qm = QuantizedModel(cfg=cfg, ptq=ptq, embedding=model.embedding,
                        final_norm=model.final_norm)
    for layer, blk in enumerate(model.layers):
        slot = layer % cfg.period
        block = QuantizedBlock(spec=blk.spec)
        for kind, nname, fam in (("mixer", "norm1", blk.spec.mixer),
                                 ("ffn", "norm2", blk.spec.ffn)):
            if fam == "none":
                continue
            adapter = get_adapter(kind, fam)
            (y_a, y_q), comp, nrm = _calibrate_component(
                adapter, _component_params(getattr(blk, kind), adapter, cfg),
                _norm_dict(getattr(blk, nname)), x_a, x_q, cfg, ptq, positions, equalize,
                plan=plan, site_prefix=f"slot{slot}/{kind}.")
            x_a = x_a + y_a
            x_q = x_q + y_q
            setattr(block, nname, nrm)
            setattr(block, kind, comp)
        qm.blocks.append(block)
    if plan:
        known = {f"slot{i % cfg.period}/{name}"
                 for i, b in enumerate(qm.blocks) for name, _ in b.quantized_linears()}
        unknown = sorted(k for k in plan if k not in known)
        if unknown:
            raise DatapathMismatchError(
                f"mixed-precision plan names unknown sites {unknown}; "
                f"model enumerates {sorted(known)}")
    return qm


def _quantized_component_forward(comp: QuantizedComponent, h, cfg, positions):
    """Single-stream simulated-integer component forward through the same
    adapter code, taps resolving to the stored artifacts."""
    adapter = get_adapter(comp.kind, comp.adapter)

    def tap(name, xp, stats_from=None):
        y = _apply_quantized(comp.linears[name], xp[1], comp.specs[name].use_bias)
        return (y, y)

    ctx = TapContext(cfg=cfg, positions=positions)
    return adapter.forward_with_taps(comp.params, (h, h), ctx, tap)[1]


@torch.inference_mode()
def quantized_forward(qm: QuantizedModel, batch: dict) -> torch.Tensor:
    """Simulated-integer forward of the quantized model -> logits."""
    cfg = qm.cfg
    tokens = _tokens([batch], qm.embedding.embed.device)
    positions = _positions(tokens)
    x = embed(qm.embedding, tokens, cfg)
    for b in qm.blocks:
        if b.mixer is not None:
            x = x + _quantized_component_forward(b.mixer, _norm(b.norm1, x, cfg.norm), cfg,
                                                 positions)
        if b.ffn is not None:
            x = x + _quantized_component_forward(b.ffn, _norm(b.norm2, x, cfg.norm), cfg,
                                                 positions)
    return lm_logits(qm.embedding, norm(qm.final_norm, x, cfg.norm), cfg)


def quantized_ppl(qm: QuantizedModel, batches: list[dict]) -> float:
    """Perplexity of the quantized model over eval batches."""
    tot, n = 0.0, 0
    for b in batches:
        pred = quantized_forward(qm, b).to(torch.float32)[:, :-1]
        labels = _tokens([b], pred.device)[:, 1:]
        logz = torch.logsumexp(pred, dim=-1)
        gold = torch.gather(pred, -1, labels[..., None])[..., 0]
        tot += float(torch.sum(logz - gold))
        n += labels.numel()
    return math.exp(tot / n)


@torch.inference_mode()
def float_ppl(model, cfg: ModelConfig, batches: list[dict]) -> float:
    """Perplexity of the float model over eval batches."""
    from repro_torch.models.transformer import loss_fn

    tot, n = 0.0, 0
    for b in batches:
        tokens = _tokens([b], model.embedding.embed.device)
        _, m = loss_fn(model, {"tokens": tokens})
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        tot += float(m["ce"]) * count
        n += count
    return math.exp(tot / n)


__all__ = [
    "QuantizedBlock",
    "QuantizedComponent",
    "QuantizedModel",
    "calibrate_and_quantize",
    "float_ppl",
    "quantized_forward",
    "quantized_ppl",
]
