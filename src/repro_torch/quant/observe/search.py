"""Headroom-driven mixed-precision search and certificate-exact re-spec
(port of ``repro/quant/observe/search.py``).

The certificate's worst-case partial sums are properties of the integer
codes alone (:func:`~repro_torch.core.overflow.min_feasible_p_bits`): any
smaller inner register that still holds them is certified for the *same*
codes, with no re-solve and no accuracy change. So:

* **P_I tightening** is free in proxy loss. :func:`apply_plan` re-specs an
  already-quantized model (same codes, tighter registers, re-issued
  certificates): a strictly tighter global accumulator budget at
  *bit-identical* perplexity.
* **w_bits and sparsity moves** change the codes and need a
  re-calibration (``calibrate_and_quantize(plan=...)``); the search emits
  them only when asked (``promote_w8``, ``sparsify``) and
  :func:`apply_plan` refuses them.

Objective: minimize proxy loss subject to ``sum_i P_I(i) * repeats(i) <=
acc_budget_bits``. With P-only moves the proxy loss is constant, so every
site starts at its certificate floor and the remaining budget goes back one
bit at a time to the site with the least projected headroom.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.alphabet import accumulator_range, effective_depth, outer_accumulator_bits
from repro_torch.core.axe import QuantizedLinear, sweep_config
from repro_torch.core.overflow import certify, certify_stacked
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec

from .records import MixedPrecisionPlan, ObserverReport, SiteObservation


def _projected_headroom(obs: SiteObservation, p: int) -> float:
    """The certificate headroom this site would report at inner width
    ``p`` (exact: headroom is measured against log2 of the register
    limit)."""
    if obs.headroom_bits is None:
        return float("inf")
    _, hi_now = accumulator_range(obs.p_inner)
    _, hi_new = accumulator_range(p)
    return obs.headroom_bits - (math.log2(hi_now) - math.log2(hi_new))


def plan_accumulator_bits(plan: MixedPrecisionPlan, report: ObserverReport) -> int:
    """The global accumulator budget of ``plan`` over ``report``'s sites:
    inner register widths summed across physical instances (sites the plan
    does not name keep their observed width)."""
    total = 0
    for s in report:
        spec = plan.get(s.name)
        total += (spec.p_inner if spec is not None else s.p_inner) * s.n_repeats
    return total


def search_plan(report: ObserverReport, *, acc_budget_bits: int | None = None,
                margin_bits: int = 0, promote_w8: int = 0,
                sparsify: int = 0) -> MixedPrecisionPlan:
    """Assign per-site ``(w_bits, P_I)`` to meet a global accumulator
    budget at minimum proxy loss.

    ``acc_budget_bits``: the target for ``sum P_I * repeats`` (None = the
    certificate-exact floor). A budget below the floor plus margin raises
    ``ValueError``. ``margin_bits``: whole bits added to every site's floor
    before spending. ``promote_w8``: the N most binding sites (least
    headroom) go to ``w_bits=8`` with a 32-bit register, out of the integer
    budget. ``sparsify``: the N eligible sites with the most headroom
    (certified, ``K % 4 == 0``, ``w_bits <= 4``, dense, not promoted) are
    marked 2:4; they leave this search's P_I tightening. Both moves change
    codes: the plan must go through ``calibrate_and_quantize(plan=...)``.

    Every selection tie-breaks on the site name, so equal-headroom reports
    give the same plan in any insertion order."""
    candidates = sorted((s for s in report if s.headroom_bits is not None),
                        key=lambda s: (s.headroom_bits, s.name))
    promoted = candidates[: max(promote_w8, 0)]
    promoted_names = {s.name for s in promoted}
    sparsify_eligible = sorted(
        (s for s in candidates
         if s.name not in promoted_names and s.k % 4 == 0 and s.spec is not None
         and s.spec.w_bits <= 4 and s.spec.sparsity is None),
        key=lambda s: (-s.headroom_bits, s.name))
    sparsified = sparsify_eligible[: max(sparsify, 0)]
    sparsified_names = {s.name for s in sparsified}
    movable = [s for s in report if s.headroom_bits is not None
               and s.name not in promoted_names and s.name not in sparsified_names]

    floors = {s.name: min(s.p_floor + margin_bits, s.p_inner) for s in movable}
    floor_total = sum(floors[s.name] * s.n_repeats for s in movable)
    uniform_total = sum(s.p_inner * s.n_repeats for s in movable)
    budget = floor_total if acc_budget_bits is None else acc_budget_bits
    if budget < floor_total:
        raise ValueError(
            f"accumulator budget {budget} is below the certificate-exact floor "
            f"{floor_total} (+{margin_bits}b margin); tightening further requires "
            f"re-quantizing codes (try promote_w8 or a smaller w_bits sweep)")

    assigned = dict(floors)
    # hand slack back one bit at a time to the binding site
    slack = min(budget, uniform_total) - floor_total
    while slack > 0:
        grantable = [s for s in movable
                     if assigned[s.name] < s.p_inner and s.n_repeats <= slack]
        if not grantable:
            break
        worst = min(grantable,
                    key=lambda s: (_projected_headroom(s, assigned[s.name]), s.name))
        assigned[worst.name] += 1
        slack -= worst.n_repeats

    sites: dict[str, DatapathSpec] = {}
    for s in movable:
        p = assigned[s.name]
        if p == s.p_inner:
            continue  # nothing to change: the site keeps its spec
        sites[s.name] = dataclasses.replace(
            s.spec, p_inner=p, p_outer=_outer_bits(p, s.k, s.spec.tile, s.spec.sparsity))
    for s in sparsified:
        sites[s.name] = dataclasses.replace(s.spec, sparsity="2:4")
    for s in promoted:
        sites[s.name] = dataclasses.replace(
            s.spec, w_bits=8, tile=None, p_inner=32, p_outer=32, static_act=False,
            act_scale=None, act_zp=0)

    searched_total = sum(
        (sites[s.name].p_inner if s.name in sites else s.p_inner) * s.n_repeats
        for s in movable)
    return MixedPrecisionPlan(
        sites=sites,
        meta={
            "objective": "min proxy loss s.t. sum(P_I * repeats) <= budget",
            "acc_budget_bits": budget,
            "uniform_bits": uniform_total,
            "floor_bits": floor_total,
            "searched_bits": searched_total,
            "margin_bits": margin_bits,
            "binding_site": report.binding_site(),
            "promoted_w8": sorted(promoted_names),
            "sparsified": sorted(sparsified_names),
        })


def _outer_bits(p_inner: int, k: int, tile: int | None, sparsity: str | None = None) -> int:
    if tile is None or effective_depth(tile, sparsity) >= effective_depth(k, sparsity):
        return p_inner
    return outer_accumulator_bits(p_inner, k, tile, sparsity=sparsity)


def apply_plan(qm, plan: MixedPrecisionPlan):
    """Certificate-exact re-spec: ``qm``'s codes served under the plan's
    tighter registers.

    Returns a new :class:`~repro_torch.quant.pipeline.QuantizedModel`
    sharing ``qm``'s tensors (same codes, scales and activation quantizers,
    so its forward and perplexity are bit-identical) with per-site specs and
    configs replaced and certificates re-issued at the new width. An entry
    the codes do not fit raises ``ValueError``; an entry changing anything
    but ``(p_inner, p_outer)``, or a key naming no site, raises
    :class:`~repro_torch.quant.spec.DatapathMismatchError`."""
    from repro_torch.quant.pipeline import QuantizedBlock, QuantizedModel

    period = qm.cfg.period
    consumed = set()
    new_blocks = []
    for i, b in enumerate(qm.blocks):
        nb = QuantizedBlock(spec=b.spec, norm1=b.norm1, norm2=b.norm2)
        for comp_name in ("mixer", "ffn"):
            comp = getattr(b, comp_name)
            if comp is None:
                continue
            new_linears = {}
            for name, ql in comp.linears.items():
                key = f"slot{i % period}/{comp_name}.{name}"
                spec = plan.get(key)
                if spec is not None:
                    consumed.add(key)
                    ql = _respec_linear(ql, spec, context=key)
                new_linears[name] = ql
            setattr(nb, comp_name, dataclasses.replace(comp, linears=new_linears))
        new_blocks.append(nb)

    unknown = sorted(set(plan) - consumed)
    if unknown:
        raise DatapathMismatchError(
            f"plan names unknown sites {unknown}; model enumerates {sorted(consumed)}")
    return QuantizedModel(cfg=qm.cfg, ptq=qm.ptq, embedding=qm.embedding,
                          final_norm=qm.final_norm, blocks=new_blocks)


def _respec_linear(ql: QuantizedLinear, spec: DatapathSpec, context: str) -> QuantizedLinear:
    old = ql.spec
    if old is not None:
        same_codes = ((old.w_bits, old.act_bits, old.act_signed, old.tile, old.sparsity)
                      == (spec.w_bits, spec.act_bits, spec.act_signed, spec.tile,
                          spec.sparsity))
        if not same_codes:
            raise DatapathMismatchError(
                f"plan entry for {context} changes the code alphabet "
                f"({old.describe()} -> {spec.describe()}); re-specing only covers "
                f"(P_I, P_O) — run calibrate_and_quantize(plan=...) for "
                f"w/act/tile/sparsity moves")
    cfg = sweep_config(ql.cfg, p_bits=spec.p_inner, constrain=spec.p_inner < 32)
    do_cert = certify_stacked if ql.stacked else certify
    cert = do_cert(ql.q_int, cfg.act_alphabet, spec.p_inner, spec.tile, sparsity=spec.sparsity)
    if not bool(cert):
        raise ValueError(
            f"plan entry for {context} requests P_I={spec.p_inner} but the site's codes "
            f"do not fit (certificate failed); the plan was not derived from this "
            f"model's observations")
    new_spec = dataclasses.replace(old if old is not None else spec,
                                   p_inner=spec.p_inner, p_outer=spec.p_outer)
    return dataclasses.replace(ql, cert=cert, cfg=cfg, spec=new_spec)


__all__ = ["apply_plan", "plan_accumulator_bits", "search_plan"]
