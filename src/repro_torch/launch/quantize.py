"""PTQ launcher: float model -> calibration -> AXE quantization -> certified
v2 artifact (port of ``repro/launch/quantize.py``).

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch tiny-lm-l --out /tmp/q

Weights are a seeded random init of the architecture's widths, and the
calibration batches come from the port's ``TokenBatcher``. Calibration
takes float32 weights, as the reference's solvers do: a bfloat16
configuration (smollm-360m as published) raises ``TypeError``. The JSON report
is the reference launcher's; ``--out DIR`` writes ``DIR/quantized``, which
``repro_torch.launch.serve --artifact`` and ``repro.launch.serve
--artifact`` both load. ``--device`` defaults to ``cuda``. ``--ckpt-dir``,
``--sparsity 2:4`` and non-dense architectures are not yet ported and
refuse.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.axe import PTQConfig
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.models.transformer import init_model
from repro_torch.quant.pipeline import calibrate_and_quantize, float_ppl, quantized_ppl
from repro_torch.quant.serve_packed import export_quantized_artifact


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="not yet ported (checkpoint restore arrives with training)")
    ap.add_argument("--algorithm", default="gpfq", choices=("gpfq", "optq", "rtn", "ep_init"))
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--act-bits", type=int, default=8)
    ap.add_argument("--p-bits", type=int, default=16)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--no-constrain", action="store_true",
                    help="unconstrained Base algorithm (Table 1)")
    ap.add_argument("--sparsity", default=None, choices=("2:4",),
                    help="not yet ported (the 2:4 slice)")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--calib-batch-size", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        raise SystemExit("--ckpt-dir is not yet ported: checkpoint restore arrives with "
                         "the training slice of the port")
    if args.sparsity is not None:
        raise SystemExit("--sparsity 2:4 is not yet ported: it arrives with the 2:4 slice")

    device = resolve_device(args.device)
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    except KeyError as e:
        raise SystemExit(f"--arch {args.arch} is not yet ported: {e}") from None
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.calib_batch_size, seed=args.seed))
    model = init_model(cfg, args.seed, device=device)
    ptq = PTQConfig(w_bits=args.w_bits, act_bits=args.act_bits, p_bits=args.p_bits,
                    tile=args.tile, algorithm=args.algorithm,
                    constrain=not args.no_constrain, sparsity=args.sparsity)
    calib = [data.batch(10_000 + i) for i in range(args.calib_batches)]
    evalb = list(data.eval_batches(args.eval_batches))

    qm = calibrate_and_quantize(model, cfg, calib, ptq, device=device)
    report = {
        "arch": cfg.name,
        "ptq": {k: getattr(ptq, k) for k in
                ("w_bits", "act_bits", "p_bits", "tile", "algorithm", "constrain")},
        "cert": qm.cert_summary(),
        "float_ppl": float_ppl(model, cfg, evalb),
        "quant_ppl": quantized_ppl(qm, evalb),
        "naive_p_star_K_dmodel": ptq.naive_p_star(cfg.d_model),
        "outer_bits_K_dmodel": ptq.outer_bits(cfg.d_model),
        # exported artifacts carry the calibrated static act quantizers
        "datapath": replace(ptq.to_datapath_spec(cfg.d_model), static_act=True).describe(),
    }
    print(json.dumps(report, indent=2, default=float))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        artifact, meta = export_quantized_artifact(qm)
        save_pytree(artifact, os.path.join(args.out, "quantized"), {**meta, **report})
        print(f"[quantize] artifact v{meta['artifact_version']} "
              f"({len(artifact)} leaves) -> {args.out}/quantized")
    return report


if __name__ == "__main__":
    main()
