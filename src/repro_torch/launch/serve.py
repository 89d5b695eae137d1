"""Serving launcher, fixed-slot engine (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --packed --batch 4 --prompt-len 64 --max-new 16

Weights are a seeded random init of the architecture's published widths.
``--packed`` packs them to the int4 serving artifact (RTN, dynamic
activation quantization); ``--artifact DIR`` instead loads a calibrated AXE
artifact written by the JAX package's ``repro.launch.quantize --out``.
``--packed-backend`` picks the packed-matmul backend: ``kernel`` (the W4A8
CUDA kernel on the card), ``reference`` (its exact-integer plain version)
or ``dequant``. ``--device`` defaults to ``cuda``.

``generate`` runs the prefill and then replays the bucket's decode step,
captured once as a CUDA graph (the same static-buffer step runs eagerly
on the CPU); ``--host-loop`` runs the eager per-token reference loop
instead.

``--paged`` serves through the paged continuous-batching engine
(``--block-size``, ``--max-concurrency``, ``--num-blocks`` or
``--kv-hbm-mb``, ``--kv-dtype act|int8``, ``--prefix-cache``), whose decode
chunks replay the engine's one captured step and whose decode attention
runs the paged attention kernels (B2 float pages, B3 int8)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --packed --paged --block-size 8 --kv-dtype int8 --device cpu

``--admit-window``, ``--admit-batch``, ``--prefill-chunk`` and
``--watermark LOW HIGH`` set the paged engine's scheduler policy (any
non-default one runs the throughput loop: batched admission, chunked
prefill, watermark growth and preemption)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --packed --paged --admit-batch 2 --prefill-chunk 16 \
        --block-size 8 --device cpu

``--plan DIR/plan.json`` (written by ``repro_torch.launch.search --out
DIR``, or by the reference's) validates the artifact's per-site datapaths
against the plan and prints ``[serve] plan validated: ...``; with
``--paged --kv-dtype int8`` the plan's calibrated static KV page scales go
to the engine (no requantize-on-append)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-lm-xs \
        --artifact /tmp/mixed/quantized --plan /tmp/mixed/plan.json \
        --paged --block-size 8 --kv-dtype int8 --device cpu

``--float32`` serves an f32 copy of the configuration (the form a
calibrated bfloat16 architecture was calibrated in).

``--observe`` (with ``--paged``) attaches the serving saturation
counters; after the timed run the launcher asserts the observer
transparent, prints the binding watermark and the JSON report::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --packed --paged --block-size 8 --kv-dtype int8 --observe --device cpu

The recurrent families serve through both engines (``--arch tiny-ssm``,
``tiny-xlstm``, ``tiny-hybrid``, ``xlstm-350m``, ``jamba-1.5-large-398b
--smoke``): their per-sequence state is a dense lane a slot, stepped in
place by the captured decode step; the paged engine's policy gates refuse
the prefix cache and batched or chunked admission on such patterns.

``--ckpt-dir DIR`` restores the trained ``params`` of the newest
checkpoint under DIR (written by either package's ``launch.train``) over
the seeded init, as the reference does, before ``--packed`` packs them or
``--artifact`` loads its sites over them (the artifact carries no
embedding).

``--mesh dp,tp`` (with ``--paged``) serves the paged engine
tensor-parallel over a (data, model) mesh of ``torch.distributed`` ranks,
one process a device: kv-head-sharded pools, replicated admin leaves, the
reference attention on each rank's heads; ``dp * tp`` must equal the world
size, ``auto`` spreads every rank over ``data``. Rank ``r`` runs on
``cuda:{LOCAL_RANK}`` over NCCL (the decode step captured with its
collectives inside), or on the CPU over gloo. Only rank 0 prints the timing
and ``sample:`` lines, which carry the tokens of the one-device run::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch smollm-360m \
        --packed --paged --block-size 64 --mesh 1,2

MoE and recurrent patterns serve on a mesh too (``tiny-moe``, ``tiny-ssm``,
``tiny-xlstm``, ``tiny-hybrid`` on CPU ranks; ``granite-moe-3b-a800m`` and
``xlstm-350m`` on cards): each rank prints the experts of a stacked site it
holds and the recurrent state MiB it holds beside the one-device figure.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import restore_params_
from repro_torch.models.transformer import init_model
from repro_torch.quant.serve_packed import (
    load_flat_artifact,
    pack_decode_params,
    packed_params_from_artifact,
)
from repro_torch.quant.spec import DatapathSpec, tree_datapath_fingerprint, validate_datapath
from repro_torch.serving import (
    GenerationEngine,
    PagedConfig,
    PagedEngine,
    SamplerConfig,
    SchedulerPolicy,
)
from repro_torch.serving.scheduler import blocks_for_budget, kv_pool_bytes

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
                    help="eager per-token host loop instead of the captured decode step")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV continuous-batching engine")
    ap.add_argument("--block-size", type=int, default=64,
                    help="KV page size in tokens (--paged)")
    ap.add_argument("--max-concurrency", type=int, default=8,
                    help="engine slots for continuous batching (--paged)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV page-pool size (--paged); default fits "
                         "--max-concurrency full-length sequences")
    ap.add_argument("--kv-dtype", type=str, default="act", choices=("act", "int8"),
                    help="KV page element type (--paged): act keeps the model's "
                         "act_dtype; int8 stores quantized pages + per-page scales")
    ap.add_argument("--kv-hbm-mb", type=float, default=None,
                    help="size the page pool to a memory budget (MB) instead of "
                         "--num-blocks")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt blocks across requests (--paged)")
    ap.add_argument("--admit-window", type=int, default=1,
                    help="queued requests one admission pass may examine (--paged)")
    ap.add_argument("--admit-batch", type=int, default=1,
                    help="max cold arrivals co-admitted through one padded "
                         "multi-row prefill (--paged)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill long prompts in page-aligned chunks of at most "
                         "this many tokens, between decode chunks (--paged; a "
                         "multiple of --block-size)")
    ap.add_argument("--watermark", type=int, nargs=2, default=None,
                    metavar=("LOW", "HIGH"),
                    help="free-page watermarks (--paged): admit against a LOW-page "
                         "reserve, grow pages on demand and preempt on exhaustion; "
                         "after a preemption fresh arrivals wait for HIGH free pages")
    ap.add_argument("--plan", type=str, default=None,
                    help="mixed-precision plan.json (repro_torch.launch.search --out): "
                         "validates the artifact's per-site datapaths against the plan "
                         "and, with --paged --kv-dtype int8, gives the engine the plan's "
                         "calibrated static KV page scales")
    ap.add_argument("--float32", action="store_true",
                    help="an f32 copy of the configuration (as calibration takes it)")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="restore the trained params of the newest checkpoint here")
    ap.add_argument("--observe", action="store_true",
                    help="attach serving saturation counters (--paged): static-quantizer "
                         "clip counts and per-site / per-head accumulator watermarks, "
                         "reported after generation; the decode step gains only the taps "
                         "(structurally asserted)")
    ap.add_argument("--mesh", type=str, default=None, metavar="DP,TP",
                    help="serve tensor-parallel over a (data, model) mesh of torch.distributed "
                         "ranks (--paged): 'dp,tp' whose product equals the world size, or "
                         "'auto' for every rank data-parallel")
    args = ap.parse_args(argv)
    if args.mesh is not None and not args.paged:
        raise SystemExit("--mesh applies to the paged engine only (add --paged)")

    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import parse_mesh_spec

        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        mesh = parse_mesh_spec(args.mesh, device=device)
        print(f"[serve] mesh: {mesh.shape} over {mesh.size} ranks ({mesh.backend}), this rank "
              f"{mesh.rank} at {mesh.coords} on {device}")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.float32:
        from repro_torch.launch.search import f32_config

        cfg = f32_config(cfg)
    model = init_model(cfg, args.seed, device=device)
    if args.ckpt_dir:
        step = restore_params_(model, args.ckpt_dir)
        if step is not None:
            print(f"[serve] restored step {step}")
    if args.artifact:
        flat, meta = load_flat_artifact(args.artifact)
        model = packed_params_from_artifact(flat, model, cfg, meta=meta)
        print(f"[serve] loaded artifact v{meta.get('artifact_version')} "
              f"datapath={tree_datapath_fingerprint(model)} "
              f"({meta.get('datapath', '?')})")
    elif args.packed:
        model = pack_decode_params(model, cfg)
        print("[serve] packed int4 serving params (RTN fallback, dynamic act)")

    plan = _validated_plan(args, model, cfg) if args.plan else None

    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                                   global_batch=args.batch, seed=args.seed))
    prompts = np.asarray(data.batch(0)["tokens"])
    sampler = SamplerConfig(temperature=args.temperature, seed=args.seed)
    if not args.paged and (args.kv_dtype != "act" or args.kv_hbm_mb is not None
                           or args.prefix_cache):
        raise SystemExit("--kv-dtype/--kv-hbm-mb/--prefix-cache apply to the "
                         "paged engine only (add --paged)")
    if not args.paged and (args.admit_window != 1 or args.admit_batch != 1
                           or args.prefill_chunk is not None or args.watermark is not None):
        raise SystemExit("--admit-window/--admit-batch/--prefill-chunk/--watermark apply "
                         "to the paged engine only (add --paged)")
    if args.observe and not args.paged:
        raise SystemExit("--observe applies to the paged engine only (add --paged)")
    if args.paged:
        if args.host_loop:
            raise SystemExit("--host-loop applies to the fixed-slot engine only")
        engine = _paged_engine(args, model, cfg, sampler, device,
                               kv_scales=plan.kv if plan is not None else None, mesh=mesh)
        gen = engine.generate
    else:
        engine = GenerationEngine(model, cfg, sampler, device=device,
                                  backend=args.packed_backend)
        gen = engine.generate_host_loop if args.host_loop else engine.generate
    gen(prompts, args.max_new)  # warm-up outside the timed region (kernel build)
    t0 = time.perf_counter()
    out = gen(prompts, args.max_new)  # returns host numpy: the device is done
    dt = time.perf_counter() - t0
    n_new = out.shape[1] - prompts.shape[1]
    loop = "paged" if args.paged else ("host-loop" if args.host_loop else "device-loop")
    if mesh is None or mesh.rank == 0:
        print(f"[serve] device={device} batch={args.batch} new_tokens={n_new} {loop} "
              f"{dt:.4f}s  {args.batch * n_new / dt:.1f} tok/s")
        print("[serve] sample:", out[0, -min(16, out.shape[1]):].tolist())
    if args.observe:
        _print_observation(engine)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


def _print_observation(engine: PagedEngine) -> None:
    """The reference's observation lines: the transparency check, the
    binding watermark (least observed headroom) and the JSON report."""
    engine.assert_observation_transparent()
    rep = engine.saturation_report()
    worst = None
    for name, sec in rep["sites"].items():
        h = sec.get("headroom_bits_observed")
        if h is not None and (worst is None or h < worst[1]):
            worst = (name, h)
    print(f"[serve] observed {len(rep['sites'])} sites; binding watermark: "
          f"{worst[0] if worst else '-'}"
          f"{f' ({worst[1]:.2f} headroom bits)' if worst else ''}")
    print("[serve] saturation report:", json.dumps(rep, indent=2, default=float))


def _validated_plan(args, model, cfg):
    """Load ``--plan`` and check every packed site of the loaded artifact
    against it (its entry, else the uniform base spec in its meta); prints
    the reference's ``[serve] plan validated`` line, with the packed sites
    checked (every layer's) and the slot-granular sites they fold into."""
    from repro_torch.quant.observe import MixedPrecisionPlan
    from repro_torch.quant.serve_packed import plan_expected_specs

    if not args.artifact:
        raise SystemExit("--plan validates a calibrated artifact's per-site datapaths "
                         "(add --artifact DIR)")
    plan = MixedPrecisionPlan.load(args.plan)
    base_d = plan.meta.get("base_spec")
    if base_d is None:
        raise SystemExit(f"{args.plan} carries no base_spec meta — re-export with "
                         f"repro_torch.launch.search")
    expected = plan_expected_specs(cfg, plan, DatapathSpec(**base_d))
    n = validate_datapath(model, expected)
    print(f"[serve] plan validated: {n} per-site datapaths match ({len(expected)} slot "
          f"sites, {len(plan.sites)} searched, kv={'static' if plan.kv else 'dynamic'})")
    return plan


def _paged_engine(args, model, cfg, sampler, device, kv_scales=None, mesh=None) -> PagedEngine:
    """The paged engine the flags describe; prints the reference's
    ``[serve] paged engine: ...`` line (pool MB, policy, attention
    datapath)."""
    pages_per_seq = -(-(args.prompt_len + args.max_new - 1) // args.block_size)
    if args.kv_hbm_mb is not None and args.num_blocks is not None:
        raise SystemExit("--num-blocks and --kv-hbm-mb both size the page pool — "
                         "pass one, not both")
    if args.kv_hbm_mb is not None:
        num_blocks = blocks_for_budget(int(args.kv_hbm_mb * 2**20), cfg, args.block_size,
                                       args.kv_dtype)
        if num_blocks < pages_per_seq:
            raise SystemExit(f"--kv-hbm-mb {args.kv_hbm_mb} affords {num_blocks} pages "
                             f"< the {pages_per_seq} one request needs")
    else:
        num_blocks = args.num_blocks or args.max_concurrency * pages_per_seq
    try:
        policy = SchedulerPolicy(
            admit_window=args.admit_window, batch_max=args.admit_batch,
            prefill_chunk=args.prefill_chunk,
            watermark=tuple(args.watermark) if args.watermark else None)
    except ValueError as e:
        raise SystemExit(f"scheduler policy: {e}") from None
    try:
        engine = PagedEngine(
            model, cfg,
            PagedConfig(block_size=args.block_size, num_blocks=num_blocks,
                        max_concurrency=args.max_concurrency, kv_dtype=args.kv_dtype,
                        prefix_cache=args.prefix_cache, sched=policy,
                        # a mesh runs the reference attention on each rank's heads
                        attn_impl="auto" if mesh is None else "reference"),
            sampler, device=device, backend=args.packed_backend, kv_scales=kv_scales,
            observe=args.observe, mesh=mesh)
    except ValueError as e:
        raise SystemExit(f"paged engine: {e}") from None
    pool_mb = kv_pool_bytes(cfg, num_blocks, args.block_size, args.kv_dtype) / 2**20
    attn_dp = (f" attn_datapath=[{engine.attn_spec.describe()}]"
               if engine.attn_spec else "")
    pc = " prefix_cache=on" if args.prefix_cache else ""
    pc += " kv_scales=static" if engine._kv_scales_seq is not None else ""
    pol = ("" if policy.is_legacy else
           f" policy=(window={policy.admit_window} batch={policy.batch_max} "
           f"chunk={policy.prefill_chunk} watermark={policy.watermark})")
    print(f"[serve] paged engine: block_size={args.block_size} num_blocks={num_blocks} "
          f"slots={args.max_concurrency} kv_dtype={args.kv_dtype} "
          f"pool={pool_mb:.2f}MB{pc}{pol}{attn_dp}"
          f"{f' decode_step={engine.step_mode}' if mesh is not None else ''}")
    if mesh is not None:
        _print_mesh_holdings(engine, cfg)
    return engine


def _print_mesh_holdings(engine: PagedEngine, cfg) -> None:
    """What this rank holds of the expert stacks and the recurrent lanes."""
    for block in engine.model.layers:
        sh = getattr(getattr(block.ffn, "wd", None), "_shard", None)
        if block.spec.ffn == "moe" and sh is not None:
            lo, hi = sh.experts(cfg.moe.n_experts)
            print(f"[serve] experts: {hi - lo} of {cfg.moe.n_experts} a stacked site on this "
                  f"rank ({lo}..{hi - 1}), wd K over {list(sh.k)}")
            break
    if engine.state_bytes_one_device:
        print(f"[serve] recurrent state: {engine.state_bytes / 2**20:.3f} MiB on this rank "
              f"against {engine.state_bytes_one_device / 2**20:.3f} MiB on one device "
              f"({engine.paged.max_concurrency} slots)")


if __name__ == "__main__":
    main()
