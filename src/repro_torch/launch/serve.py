"""Serving launcher, fixed-slot engine (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --packed --batch 4 --prompt-len 64 --max-new 16

Weights are a seeded random init of the architecture's published widths.
``--packed`` packs them to the int4 serving artifact (RTN, dynamic
activation quantization); ``--artifact DIR`` instead loads a calibrated AXE
artifact written by the JAX package's ``repro.launch.quantize --out``.
``--packed-backend`` picks the packed-matmul backend: ``kernel`` (the W4A8
CUDA kernel on the card), ``reference`` (its exact-integer plain version)
or ``dequant``. ``--device`` defaults to ``cuda``. The paged engine's flags
are accepted and refused until the paged slice of the port lands.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.models.transformer import init_model
from repro_torch.quant.serve_packed import (
    load_flat_artifact,
    pack_decode_params,
    packed_params_from_artifact,
)
from repro_torch.quant.spec import tree_datapath_fingerprint
from repro_torch.serving import GenerationEngine, SamplerConfig

#: flags of the reference launcher that belong to slices not ported yet
_UNPORTED = {
    "--paged": "the paged engine", "--block-size": "the paged engine",
    "--max-concurrency": "the paged engine", "--num-blocks": "the paged engine",
    "--kv-dtype": "int8 KV pages", "--kv-hbm-mb": "the paged engine",
    "--prefix-cache": "the paged engine", "--admit-window": "the paged engine",
    "--admit-batch": "the paged engine", "--prefill-chunk": "the paged engine",
    "--watermark": "the paged engine", "--plan": "mixed-precision plans",
    "--mesh": "multi-device serving", "--observe": "serving observers",
    "--ckpt-dir": "checkpoint restore of trained params",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--packed", action="store_true",
                    help="serve from the packed-int4 W4A8 artifact (RTN)")
    ap.add_argument("--artifact", type=str, default=None,
                    help="directory of a calibrated AXE artifact (v2)")
    ap.add_argument("--packed-backend", type=str, default="kernel",
                    choices=("kernel", "reference", "dequant"))
    ap.add_argument("--host-loop", action="store_true",
                    help="per-token host loop instead of the device loop")
    ap.add_argument("--device", type=str, default="cuda")
    for flag, what in _UNPORTED.items():
        ap.add_argument(flag, nargs="*", default=None,
                        help=f"not yet ported ({what})")
    args = ap.parse_args(argv)
    for flag in _UNPORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not yet ported: {_UNPORTED[flag]} "
                             f"arrives with a later slice of the port")

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = init_model(cfg, args.seed, device=device)
    if args.artifact:
        flat, meta = load_flat_artifact(args.artifact)
        model = packed_params_from_artifact(flat, model, cfg, meta=meta)
        print(f"[serve] loaded artifact v{meta.get('artifact_version')} "
              f"datapath={tree_datapath_fingerprint(model)} "
              f"({meta.get('datapath', '?')})")
    elif args.packed:
        model = pack_decode_params(model, cfg)
        print("[serve] packed int4 serving params (RTN fallback, dynamic act)")

    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                                   global_batch=args.batch, seed=args.seed))
    prompts = np.asarray(data.batch(0)["tokens"])
    engine = GenerationEngine(
        model, cfg, SamplerConfig(temperature=args.temperature, seed=args.seed),
        device=device, backend=args.packed_backend)
    gen = engine.generate_host_loop if args.host_loop else engine.generate
    gen(prompts, args.max_new)  # warm-up outside the timed region (kernel build)
    t0 = time.perf_counter()
    out = gen(prompts, args.max_new)  # returns host numpy: the device is done
    dt = time.perf_counter() - t0
    n_new = out.shape[1] - prompts.shape[1]
    loop = "host-loop" if args.host_loop else "device-loop"
    print(f"[serve] device={device} batch={args.batch} new_tokens={n_new} {loop} "
          f"{dt:.4f}s  {args.batch * n_new / dt:.1f} tok/s")
    print("[serve] sample:", out[0, -min(16, out.shape[1]):].tolist())
    return out


if __name__ == "__main__":
    main()
