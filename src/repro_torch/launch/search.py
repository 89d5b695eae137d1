"""Mixed-precision search launcher: calibrate -> observe -> search ->
export (port of ``repro/launch/search.py``).

    PYTHONPATH=src python -m repro_torch.launch.search --arch tiny-lm-xs \
        --p-bits 20 --tile 64 --kv-static --out /tmp/mixed --device cpu

1. **Calibrate** a uniform AXE baseline at the conservative ``--p-bits``
   register (the slack the search reclaims lives here).
2. **Observe**: join each site's overflow certificate with its calibration
   activation observer (:func:`repro_torch.quant.observe.collect_observations`).
3. **Search**: per-site ``(w_bits, P_I)`` under a global accumulator budget
   (:func:`repro_torch.quant.observe.search_plan`). P_I-only tightening is
   certificate-exact: same codes, smaller registers, re-issued
   certificates, bit-identical perplexity. ``--promote-w8 N`` and
   ``--sparsify N`` are code-changing moves and re-calibrate with the plan
   (``--sparsify`` through the masked solve).
4. **KV** (``--kv-static``): static per-(repeat, kv-head) page scales from
   prefill ranges on the serving model, per-head bit demotion folded in.
5. **Export** the v2 artifact plus ``plan.json``, served by
   ``repro_torch.launch.serve --artifact DIR/quantized --plan DIR/plan.json``
   (or by the reference's launcher).

Weights are a seeded random init of the architecture's widths; the JSON
report is the reference launcher's. Calibration takes float32 weights:
``--float32`` calibrates an f32 copy of a bfloat16 configuration
(smollm-360m as published). ``--device`` defaults to ``cuda``.
``--ckpt-dir DIR`` searches the trained ``params`` of the newest checkpoint
under DIR, and raises when there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.axe import PTQConfig
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import restore_params_
from repro_torch.models.transformer import init_model
from repro_torch.quant.observe import (
    apply_plan,
    collect_observations,
    observe_kv_ranges,
    plan_accumulator_bits,
    search_kv_bits,
    search_plan,
)
from repro_torch.quant.pipeline import calibrate_and_quantize, quantized_ppl
from repro_torch.quant.serve_packed import (
    export_quantized_artifact,
    serving_params_from_quantized,
)

#: plan.meta fields of the uniform base spec: enough to rebuild the
#: DatapathSpec identity (key()) of unplanned sites at serve time
BASE_SPEC_FIELDS = ("w_bits", "act_bits", "act_signed", "tile", "p_inner", "static_act")


def f32_config(cfg):
    """An f32 copy of ``cfg`` (parameters and activations), the form
    calibration takes."""
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="search the trained params of the newest checkpoint here")
    ap.add_argument("--algorithm", default="gpfq", choices=("gpfq", "optq", "rtn", "ep_init"))
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--act-bits", type=int, default=8)
    ap.add_argument("--p-bits", type=int, default=20,
                    help="uniform baseline inner register (conservative on purpose: "
                         "per-site slack below it is what the search reclaims)")
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--acc-budget-bits", type=int, default=None,
                    help="global sum(P_I * repeats) budget; default = the certificate "
                         "floor + margins (tightest feasible)")
    ap.add_argument("--margin-bits", type=int, default=0,
                    help="operating margin added to every site's certificate floor "
                         "before distributing slack")
    ap.add_argument("--sparsify", type=int, default=0,
                    help="mark the N most-headroomed eligible sites for 2:4 "
                         "semi-structured sparsity (code-changing move: forces a "
                         "mask-aware re-calibration)")
    ap.add_argument("--promote-w8", type=int, default=0,
                    help="promote the N most register-binding sites to 8-bit weights "
                         "(changes codes: re-calibrates)")
    ap.add_argument("--kv-static", action="store_true",
                    help="calibrate static per-(repeat, kv-head) KV page scales (drops "
                         "requantize-on-append at serving)")
    ap.add_argument("--kv-bits", type=int, default=8)
    ap.add_argument("--kv-low-bits", type=int, default=None,
                    help="demote low-range kv heads to this many bits (folded into the "
                         "static scale)")
    ap.add_argument("--kv-low-frac", type=float, default=0.25)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--calib-batch-size", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--float32", action="store_true",
                    help="calibrate an f32 copy of the configuration (bfloat16 weights "
                         "cannot calibrate)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    except KeyError as e:
        raise SystemExit(f"--arch {args.arch} is not yet ported: {e}") from None
    if args.float32:
        cfg = f32_config(cfg)
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.calib_batch_size, seed=args.seed))
    model = init_model(cfg, args.seed, device=device)
    if args.ckpt_dir and restore_params_(model, args.ckpt_dir) is None:
        raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
    ptq = PTQConfig(w_bits=args.w_bits, act_bits=args.act_bits, p_bits=args.p_bits,
                    tile=args.tile, algorithm=args.algorithm, constrain=True)
    calib = [data.batch(10_000 + i) for i in range(args.calib_batches)]
    evalb = list(data.eval_batches(args.eval_batches))

    # 1. uniform baseline
    qm = calibrate_and_quantize(model, cfg, calib, ptq, device=device)
    cert_u = qm.cert_summary()
    ppl_u = quantized_ppl(qm, evalb)

    # 2-3. observe + search
    report = collect_observations(qm)
    plan = search_plan(report, acc_budget_bits=args.acc_budget_bits,
                       margin_bits=args.margin_bits, promote_w8=args.promote_w8,
                       sparsify=args.sparsify)
    base = dataclasses.replace(ptq.to_datapath_spec(cfg.d_model), static_act=True)
    plan.meta["base_spec"] = {k: getattr(base, k) for k in BASE_SPEC_FIELDS}

    if args.promote_w8 or args.sparsify:
        # w_bits / sparsity moves change the codes: a fresh constrained
        # solve driven by the plan, not a re-spec of the existing codes
        qm2 = calibrate_and_quantize(model, cfg, calib, ptq, plan=plan, device=device)
    else:
        # P_I only: certificate-exact re-spec, bit-identical outputs
        qm2 = apply_plan(qm, plan)
    cert_s = qm2.cert_summary()
    ppl_s = quantized_ppl(qm2, evalb)

    # 4. calibrated static KV scales, observed on the serving model (the
    # equalization-folded datapath prefill runs)
    if args.kv_static:
        ranges = observe_kv_ranges(serving_params_from_quantized(qm2), cfg, calib)
        plan.kv = search_kv_bits(ranges, kv_bits=args.kv_bits, low_bits=args.kv_low_bits,
                                 low_frac=args.kv_low_frac)

    searched_bits = plan_accumulator_bits(plan, report)
    report_out = {
        "arch": cfg.name,
        "uniform": {"p_bits": args.p_bits, "accumulator_bits": report.accumulator_bits(),
                    "ppl": ppl_u, "cert": cert_u},
        "searched": {
            "accumulator_bits": searched_bits,
            "ppl": ppl_s,
            "cert": cert_s,
            "plan_sites": {k: v.p_inner for k, v in plan.sites.items()},
            "promoted_w8": plan.meta.get("promoted_w8", []),
            "sparsified": plan.meta.get("sparsified", []),
            "kv_static": bool(plan.kv),
        },
        "savings_rate": report.accumulator_bits() / max(searched_bits, 1),
        "observe": report.summary(),
    }
    print(json.dumps(report_out, indent=2, default=float))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        artifact, meta = export_quantized_artifact(qm2)
        save_pytree(artifact, os.path.join(args.out, "quantized"), {**meta, "plan": "plan.json"})
        plan.save(os.path.join(args.out, "plan.json"))
        print(f"[search] artifact v{meta['artifact_version']} ({len(artifact)} leaves) + "
              f"plan.json -> {args.out}")
    return report_out


if __name__ == "__main__":
    main()
