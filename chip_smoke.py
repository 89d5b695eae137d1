#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, runs its kernels right and
serves.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is printed as a
result unless every phase passed):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. the W4A8 kernel (``w4a8_matmul``) against its plain version on the card
   at the main path's shapes — M in {4, 256} x (K, N) in {(960, 960),
   (960, 320), (960, 2560), (2560, 960)}, uint8 and int8 activation codes,
   bf16 output, plus a ragged M=3, N=100 case — all bit-equal; the P_I
   certificate check on an l1-budgeted weight; per shape the kernel's time,
   the plain version's, the ``torch._int_mm`` yardstick's and the
   byte/operation bound;
3. the slice: smollm-360m at full width (32 layers, d_model 960, bf16,
   seeded random init), RTN-packed, greedy ``GenerationEngine.generate`` of
   batch 4 x prompt 64 + 16 new tokens. The kernel's launch counter must
   rise by 7 sites x 32 layers x 16 forwards = 3584 over that run, and the
   same generate on the ``reference`` backend must give identical tokens.

4. the GPFQ panel solver (``gpfq_solve``, kernel B5) against its plain
   version on the card at the (K, C) shapes of one smollm-360m layer —
   (960, 960), (960, 320), (960, 2560), (2560, 960) — with H and G H^-1 from
   2048 seeded samples X and a distinct perturbed copy Xq = X + 0.05 noise
   (as in calibration, where the quantized stream differs from the float
   one, so G H^-1 != H and <h_k, g_k> != |h_k|^2: a kernel that mixed up the
   two matrices would fail), the AXE state of P_I = 16, T = 128 and 8-bit
   unsigned activations, the act_order permutation and permuted tile ids;
   plus (960, 320) in round-to-zero, in joint mode (signed activations) and
   without AXE, and (8192, 64) (128 row blocks, one U tile of channels).
   Each case holds tie-limited agreement (codes equal in every channel up
   to the first row whose pre-rounding value lies within 1e-3 of a rounding
   boundary), pos/neg equal to the tile sums of the kernel's own codes
   exactly, the certificate of the kernel's codes, a second run
   bit-identical to the first (Q, U, pos, neg), and U equal to
   Xg^T W - Xh^T Q recomputed in float64 from the kernel's own codes
   (rtol 1e-4); it prints the block plan (64-row blocks, 2 + 2 x K/64
   kernels), the device kernels one solve launched (counted by the C
   launcher, held to the plan), the time of the per-panel kernel it
   replaced (commit fbec649) beside the kernel's, and for the split cases
   a profiler view of one solve (its kernels by name, held to the plan,
   and their span);
5. the calibration slice: smollm-360m at full width in float32 (the
   reference's solvers take float32 weights), ``calibrate_and_quantize``
   with the default ``PTQConfig`` on 4 x 4 x 128 tokens — exactly 224 B5
   launches (7 sites x 32 layers) and 224 certified sites; its wall time;
   a second, instrumented calibration for the breakdown of that time (B5's
   share and its sum per layer) — then the
   exported v2 artifact, written with ``save_pytree`` and loaded back,
   served greedy (batch 4 x prompt 64 + 16 new, B1 with float32 output and
   the calibrated static activation quantizers): exactly 3584 B1 launches
   and tokens identical to the ``reference`` backend;
6. the paged decode-attention kernels (B2 ``paged_decode_attention`` on
   float pages, B3 on int8 pages) against their plain versions on the card
   over the reference sweep's shapes (hd 16, 7 and 11, bs 8/16/128, ragged,
   exact and +-1 lengths, odd heads, softcap) and smollm-360m's (nh 15,
   nkv 5, hd 64, bs 64, 4 slots of 1/63/64/65 and 80/2048 tokens), f32 and
   bf16: B2 within 1e-5 (f32) or one bf16 ulp; B3 within 5e-2 everywhere
   and within 1e-4 (f32) or one bf16 ulp on rows with no q or probability
   code within 1e-3 of a rounding boundary, watermarks equal to the plain
   version's, and the full-magnitude case reaching qk_worst_abs and
   pv_worst_abs exactly; idle slots (length 0) give 0. The cases include
   rows across the kernels' split boundaries in PagedEngine's 512-page
   table (1 token beside 2048, idle slots, k * S * bs +- 1 tokens for the
   card's split count S). One B2 and one B3 call run under
   ``torch.cuda.set_sync_debug_mode("error")`` (the wrapper reads no
   length on the host). Each is timed at smollm-360m decode (4 slots x 80
   and x 2048 tokens, 1 x 2048, 16 x 512, bf16, 512-page table) beside its
   split count, its byte bound, its plain version,
   ``scaled_dot_product_attention`` on K/V gathered beforehand (the
   yardstick; the port never calls it) and the first kernels' time;
7. the paged slice: smollm-360m at full width, bf16, RTN-packed, through
   ``PagedEngine`` (block 64, 64 pages, 4 slots, chunks of 8, attention
   ``auto``): (a) 4 x prompt 64 + 16 new against ``GenerationEngine``,
   tokens identical or tie-limited; (b) 12 requests of seeded lengths
   (prompts 8-300, 4-32 new) admitted mid-flight into 4 slots, float then
   int8 KV (with the B3 watermark check): B2/B3 launches exactly 32 per
   decode step, B1 launches 224 per forward, every page back on the free
   list, equal allocator digests; (c) the prefix cache: six requests over a
   shared 128-token prefix and one fully cached prompt, warm streams
   against a cold engine's (identical or tie-limited), the cached admit
   adding 0 to every kernel counter. It prints decode-step time, tokens/s,
   admit time, peak memory and a profiler breakdown of one decode chunk.

8. the 2:4 kernels: B4 (``w4a8_sparse_matmul``) at phase 2's shapes,
   uint8 and int8 codes, bit-equal to its plain version and to B1 on the
   expanded codes, the P_I check on an l1-budgeted 2:4 weight, and per
   shape its time beside B1's, the plain version's, ``torch._int_mm`` on
   the expanded int8 codes and ``torch.sparse.to_sparse_semi_structured``
   int8 x int8 (or the library's refusal); B5 with a 2:4 mask at one
   layer's shapes (tie-limited agreement, exact pos/neg, zeros where the
   mask is 0, U consistent with its own codes, the sparse certificate)
   timed masked and unmasked; B6
   (``quant_rmsnorm``) driven once through ``ops.norm_and_quantize`` at
   (256, 960), (512, 1024) and (1024, 4096), then held to its plain version
   in f32 and bf16 (exact, or one code on under 1% of elements) and timed
   beside ``F.rms_norm``;
9. the 2:4 slice: the float32 smollm-360m calibrated with
   ``PTQConfig(sparsity="2:4")`` (exactly 224 masked B5 launches, 224 sites
   certified at sparsity 2:4, each site's register floor beside phase 5's
   dense one), its artifact saved, loaded and served greedy (batch 4 x
   prompt 64 + 16 new): exactly 3584 B4 launches and 0 B1, tokens identical
   to the ``reference`` backend; then the bf16 model RTN-packed with
   ``DatapathSpec(sparsity="2:4")`` through ``PagedEngine`` over phase 7's
   12-request trace: B4 launches 224 per forward, 0 B1, every page back on
   the free list. It prints decode-step time, tokens/s, peak memory and
   ``packed_weight_bytes`` dense vs 2:4.

Before driving a path, every launch counter is set to 0, and the counts are
read just after it. Phase 3 ends with a ``torch.profiler`` breakdown of one
decode step (the device's busy share and the kernel's part of it). The line
before the last is a JSON object describing each kernel; the last line is
the device JSON ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15  # dense int8 tensor-core peak, H100 SXM

F32_OPS_PER_S = 67e12  # non-tensor float32 peak, H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM

SHAPES_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
#: the 7 packed sites of one smollm-360m layer, as (K, N): wq, wk, wv, wo, wg, wu, wd
LAYER_SITES = [(960, 960), (960, 320), (960, 320), (960, 960),
               (960, 2560), (960, 2560), (2560, 960)]
BATCH, PROMPT, MAX_NEW = 4, 64, 16
#: phase 4: (K, C, mode, rounding); the first four are one layer's shapes
GPFQ_CASES = [(k, c, "split", "nearest") for k, c in SHAPES_KN] + [
    (960, 320, "split", "zero"), (960, 320, "joint", "nearest"),
    (960, 320, "plain", "nearest"), (8192, 64, "split", "nearest")]
GPFQ_SAMPLES = 2048
#: the per-panel B5 that the blocked one replaced (one block per channel
#: panel) on the same cases, for the [gpfq] lines only (ms; chip_smoke.py
#: phase 4 at commit fbec649, NVIDIA H100 80GB HBM3, 700.00 W)
GPFQ_PANEL_MS = {(960, 960, "split", "nearest"): 6.9895, (960, 320, "split", "nearest"): 7.0172,
                (960, 2560, "split", "nearest"): 6.9624, (2560, 960, "split", "nearest"): 26.0790,
                (960, 320, "split", "zero"): 6.9972, (960, 320, "joint", "nearest"): 6.9997,
                (960, 320, "plain", "nearest"): 6.9432, (8192, 64, "split", "nearest"): 1729.6852}
CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ, EVAL_BATCHES = 4, 4, 128, 2
#: phase 6: (B, nkv, g, hd, bs, P, lengths or a sweep mode, softcap); P is
#: the table's width. The last four cross the kernels' split boundaries in
#: PagedEngine's 512-page table: a 1-token row beside a 2048-token one,
#: idle slots (length 0, sentinel rows), and k * S * bs +- 1 tokens for the
#: card's split count S (one page per split, then one more)
PAGED_CASES = (
    [(4, 2, 2, 16, bs, 2 if bs == 128 else 3, mode, None)
     for bs in (8, 16, 128) for mode in ("ragged", "exact", "exact+-1")]
    + [(3, 1, 3, 7, 8, 3, "ragged", None), (2, 3, 1, 16, 8, 2, "ragged", None),
       (3, 1, 5, 11, 16, 2, "ragged", None), (3, 2, 2, 16, 8, 4, "ragged", 10.0),
       (4, 5, 3, 64, 64, 33, (1, 63, 64, 65), None),
       (4, 5, 3, 64, 64, 33, (80, 2048, 80, 2048), None),
       (2, 5, 3, 64, 64, 512, (1, 2048), None),
       (4, 5, 3, 64, 64, 512, (0, 80, 0, 2048), None),
       (4, 5, 3, 64, 64, 512, "split+-1", None),
       (16, 5, 3, 64, 64, 512, "split+-1", None)])
#: smollm-360m decode attention: 15 query heads over 5 kv heads, hd 64
SMOLLM_NKV, SMOLLM_G, SMOLLM_HD = 5, 3, 64
#: timed (slots, tokens), in PagedEngine's 512-page table (max_seq_len / bs)
PAGED_TIMED = ((4, 80), (4, 2048), (1, 2048), (16, 512))
PAGED_TABLE = 512
#: the first kernels' times at the same shapes (ms; chip_smoke.py phase 6 at
#: commit aa35be4, NVIDIA H100 80GB HBM3, 700.00 W)
PAGED_FIRST_MS = {("float", 4, 80): 0.06840, ("float", 4, 2048): 1.13171,
                  ("int8", 4, 80): 0.07446, ("int8", 4, 2048): 1.24144}
#: phase 7: the paged engine's configuration
PAGED_BLOCK, PAGED_BLOCKS, PAGED_SLOTS, PAGED_CHUNK = 64, 64, 4, 8
TRACE_REQUESTS, PREFIX_LEN = 12, 128
#: the largest logit difference between two runs of one model that the
#: tie-limited comparison accepts as numerical noise (logits here are
#: about unit variance)
TIE_BAND_CAP = 2.0


def reset_counts():
    """Set every kernel's launch counter to 0."""
    from repro_torch.kernels.gpfq_solve import gpfq_solve
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant_rmsnorm import quant_rmsnorm
    from repro_torch.kernels.w4a8_mm import w4a8_matmul, w4a8_sparse_matmul

    w4a8_matmul.launches = 0
    w4a8_sparse_matmul.launches = 0
    gpfq_solve.launches = 0
    gpfq_solve.masked_launches = 0
    gpfq_solve.device_kernels = 0
    paged_decode_attention.launches = 0
    paged_decode_attention.int8_launches = 0
    quant_rmsnorm.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.gpfq_solve import gpfq_solve
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant_rmsnorm import quant_rmsnorm
    from repro_torch.kernels.w4a8_mm import w4a8_matmul, w4a8_sparse_matmul

    return {"w4a8_matmul": w4a8_matmul.launches,
            "w4a8_sparse_matmul": w4a8_sparse_matmul.launches,
            "gpfq_solve": gpfq_solve.launches,
            "gpfq_solve_masked": gpfq_solve.masked_launches,
            "gpfq_solve_device_kernels": gpfq_solve.device_kernels,
            "paged_decode_attention": paged_decode_attention.launches,
            "paged_decode_attention_int8": paged_decode_attention.int8_launches,
            "quant_rmsnorm": quant_rmsnorm.launches}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one call: inputs read once (codes, packed weight, the
    two f32 epilogue vectors), the bf16 output written once, against the
    int8 operations at the tensor-core peak."""
    nbytes = m * k + k * n // 2 + 2 * 4 * n + 2 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * n * k / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 30, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs by CUDA events, with
    the L2 cache flushed before each run (a decode step finds each layer's
    weights cold: 157 MB of packed codes do not fit the 50 MB L2). A
    device-side sleep before the start event keeps the card busy while the
    host enqueues ``fn``, so the interval holds device time, not the host's
    launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of device time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_peak(torch) -> None:
    """Start a peak-memory window: collect the garbage of earlier phases
    first (engines and closures form reference cycles that only the cyclic
    collector frees), so the peak counts what the measured run holds."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def wall_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize: the time a
    caller waits, host overhead included (eager PyTorch enqueues each op
    from Python)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def decode_step_ms(torch, model, prompts, out) -> float:
    """Host-clock time of one fixed-slot decode step (ending in a
    synchronize) after a prefill of ``prompts``, through the kernels."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import use_packed_backend

    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode(), use_packed_backend("kernel"):
        _, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        return wall_ms(torch, lambda: T.decode_step(model, step_tok, caches, PROMPT), reps=10)


def phase_card(torch):
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[card] nvidia-smi: {smi}")
    print(f"[card] torch.cuda.get_device_name(): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} kernel source(s) built in "
          f"{time.perf_counter() - t0:.3f} s: {sorted(logs)}")
    for name, log in logs.items():
        usage = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                        if "Used" in line and "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
        print(f"[build] {name}: {'; '.join(usage)}; {'; '.join(spills)}")
    check(bool(logs), "no kernel source was built")
    return smi


def phase_kernel(torch):
    from repro_torch.kernels.w4a8_mm import (
        check_inner,
        pack_int4,
        unpack_int4,
        w4a8_matmul,
        w4a8_matmul_kernel,
        w4a8_matmul_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [(m, k, n) for m in (4, 256) for k, n in SHAPES_KN] + [(3, 960, 100)]
    rows, max_err = [], 0.0
    for m, k, n in cases:
        q = torch.randint(-8, 8, (k, n), generator=gen, device=dev)
        wp = pack_int4(q)
        col_sums = q.sum(0).to(torch.int32)
        scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 1e-3
        act_scale = torch.tensor(0.0213, device=dev)
        row = {"M": m, "K": k, "N": n}
        for act in ("uint8", "int8"):
            lo, hi = (0, 256) if act == "uint8" else (-128, 128)
            x = torch.randint(lo, hi, (m, k), generator=gen, device=dev).to(getattr(torch, act))
            zp = torch.tensor(131.0 if act == "uint8" else 0.0, device=dev)

            def kern():
                return w4a8_matmul(x, wp, scale, act_scale, zp, col_sums=col_sums,
                                   out_dtype=torch.bfloat16)

            def plain():
                return w4a8_matmul(x, wp, scale, act_scale, zp, col_sums=col_sums,
                                   out_dtype=torch.bfloat16, reference=True)

            y, r = kern(), plain()
            torch.cuda.synchronize()
            err = (y.float() - r.float()).abs().max().item()
            max_err = max(max_err, err)
            check(torch.equal(y, r), f"kernel != plain at M={m} K={k} N={n} {act}")
            row[f"bit_equal_{act}"] = True
            if act == "uint8":
                # the kernel and its plain version alone, on the formed
                # epilogue vectors (the wrapper's two small vector ops apart)
                sw = scale * act_scale
                corr = col_sums.to(torch.float32) * zp
                row["ms"] = time_ms(torch, lambda: w4a8_matmul_kernel(
                    x, wp, sw, corr, torch.bfloat16), flush=flush)
                row["plain_ms"] = time_ms(torch, lambda: w4a8_matmul_plain(
                    x, wp, sw, corr, torch.bfloat16), flush=flush)
                row["library_ms"] = None
                if k % 8 == 0 and n % 8 == 0:
                    # yardstick: cuBLASLt int8 GEMM on pre-unpacked weights,
                    # activations shifted by -128 (128 * col_sums folds back
                    # into the correction); it needs M > 16, so rows pad to 32
                    mp = max(m, 32)
                    xs = torch.zeros((mp, k), dtype=torch.int8, device=dev)
                    xs[:m] = (x.to(torch.int16) - 128).to(torch.int8)
                    w8 = unpack_int4(wp).contiguous()
                    acc = torch._int_mm(xs, w8)[:m] + 128 * col_sums
                    exact = x.to(torch.float64) @ q.to(torch.float64)
                    check(torch.equal(acc.to(torch.float64), exact),
                          "the _int_mm yardstick disagrees with the exact product")
                    row["library_ms"] = time_ms(torch, lambda: torch._int_mm(xs, w8),
                                                flush=flush)
        row["bound_ms"], row["bound_by"] = bound_ms(m, k, n)
        rows.append(row)
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        print(f"[w4a8] M={m:4d} K={k:5d} N={n:5d} bit-equal(u8,s8) "
              f"kernel {row['ms']:.5f} ms  plain {row['plain_ms']:.5f} ms  "
              f"_int_mm {lib} ms  bound {row['bound_ms']:.5f} ms ({row['bound_by']})")

    # the P_I certificate on an l1-budgeted weight: every certified 64-wide
    # tile (K=960 is not a multiple of T=128) keeps sum|q| <= 128 per
    # column, so |partial| <= 255 * 128 < 2^15 - 1
    k, n = 960, 960
    q = torch.randint(-7, 8, (k, n), generator=gen, device=dev)
    tiles = q.reshape(k // 64, 64, n)
    keep = torch.cumsum(tiles.abs(), dim=1) <= 128
    q = (tiles * keep).reshape(k, n)
    x = torch.randint(0, 256, (256, k), generator=gen, device=dev).to(torch.uint8)
    y = w4a8_matmul(x, pack_int4(q), torch.ones(n, device=dev), 0.01, 131.0,
                    block_k=128, p_inner=16, assert_inner=True, out_dtype=torch.bfloat16)
    watermark = check_inner(x, pack_int4(q), 128, 16)
    check(bool(torch.isfinite(y.float()).all()), "non-finite output")
    full = pack_int4(torch.full((k, n), -8, device=dev))
    raised = False
    try:
        check_inner(x, full, 128, 16)
    except OverflowError:
        raised = True
    check(raised, "an unbudgeted weight passed the P_I=16 check")
    print(f"[w4a8] assert_inner: l1-budgeted weight passes P_I=16 "
          f"(watermark {watermark} <= {2 ** 15 - 1}); an unbudgeted one raises")
    return rows, max_err


def phase_slice(torch):
    import torch.profiler
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import use_packed_backend
    from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes
    from repro_torch.serving import GenerationEngine, SamplerConfig

    cfg = get_config("smollm-360m")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                      global_batch=BATCH, seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(model, cfg, SamplerConfig(temperature=0.0), device="cuda")
    engine.generate(prompts, MAX_NEW)  # warm-up (allocator, cuBLAS handles)
    reset_peak(torch)

    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)  # ends in a host read: the device is done
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["w4a8_matmul"]
    check(counts["gpfq_solve"] == 0, f"serving launched gpfq_solve: {counts}")

    peak = torch.cuda.max_memory_allocated()
    expected = 7 * cfg.n_layers * MAX_NEW
    check(launches == expected, f"{launches} w4a8 launches, expected {expected}")
    check(out.shape == (BATCH, PROMPT + MAX_NEW), f"output shape {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    ref_out = GenerationEngine(model, cfg, SamplerConfig(temperature=0.0), device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
    check((out == ref_out).all(), "kernel and reference backends disagree on tokens")

    # per-phase times, and the packed path against the dequant one
    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode(), use_packed_backend("kernel"):
        logits, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        prefill_ms = wall_ms(torch, lambda: T.prefill(model, {"tokens": tokens},
                                                      PROMPT + MAX_NEW), reps=5)
        decode_ms = wall_ms(torch, lambda: T.decode_step(model, step_tok, caches, PROMPT),
                            reps=10)
        check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
        with use_packed_backend("dequant"):
            dq, _ = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        a = logits[..., :cfg.vocab].float().flatten()
        b = dq[..., :cfg.vocab].float().flatten()
        corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        check(corr > 0.99, f"kernel vs dequant prefill logits correlation {corr}")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            T.decode_step(model, step_tok, caches, PROMPT)
            torch.cuda.synchronize()
        events = prof.key_averages()
        print(events.table(sort_by="self_cuda_time_total", row_limit=12))
        # device kernels only (the CPU ops' device columns repeat them); one
        # stream, so their sum is the time the card was busy
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        w4a8_ms = sum(e.self_device_time_total for e in kernels
                      if "w4a8_kernel" in e.key) / 1e3
        check(w4a8_ms > 0, "the profiler saw no w4a8 kernel in a decode step")
        print(f"[profile] one decode step: device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / decode_ms:.1f}% of the {decode_ms:.3f} ms step), "
              f"w4a8 kernels {w4a8_ms:.3f} ms")

    head_bytes = cfg.vocab_padded * cfg.d_model * 2
    step_bytes = packed_weight_bytes(cfg)["packed_code_bytes"] + head_bytes
    print(f"[slice] smollm-360m full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"bf16), batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new, greedy")
    print(f"[slice] w4a8 launches in one generate: {launches} (= 7 x {cfg.n_layers} x "
          f"{MAX_NEW}); tokens identical to the reference backend")
    print(f"[slice] generate wall {wall:.4f} s, {BATCH * MAX_NEW / wall:.1f} tok/s; "
          f"prefill {prefill_ms:.3f} ms, decode step {decode_ms:.3f} ms (host clock)")
    print(f"[slice] decode-step byte bound: {step_bytes / 1e6:.1f} MB (packed codes + bf16 "
          f"head) = {1e3 * step_bytes / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
    print(f"[slice] peak memory allocated {peak / 2**20:.1f} MiB; kernel-vs-dequant "
          f"prefill logits correlation {corr:.5f}")
    print(f"[slice] sample tokens: {out[0, PROMPT:].tolist()}")
    return launches


def gpfq_bound_ms(k: int, d: int, c: int) -> tuple[float, str]:
    """Least time for one solve: the operations (a multiply-add of the
    reduction and two multiplies and adds of the update per U entry per
    step, 6*K*D*C) at the float32 peak, against the bytes of w, xg, xh, the
    row terms, lambda and the tile ids read once and Q, U, pos, neg
    written once."""
    n_tiles = -(-k // 128)
    nbytes = 4 * (2 * k * c + 2 * k * d + 3 * k + 3 * n_tiles * c + d * c)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 6 * k * d * c / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gpfq_case_inputs(torch, k: int, c: int, mode: str, rounding: str, gen):
    """One B5 call as calibration makes it, on the card: H and G H^-1 from
    seeded samples X and a distinct perturbed copy Xq (so the two matrices
    differ, as they do in calibration), w normal*0.02 in the integer domain,
    the AXE state of P_I = 16, T = 128 (unless ``mode`` is "plain"), rows and
    tile ids in the act_order permutation."""
    from repro_torch.core import gpfq as G
    from repro_torch.core.alphabet import act_alphabet, weight_alphabet
    from repro_torch.kernels.gpfq_solve import row_terms

    dev = torch.device("cuda")
    x = torch.randn((k, GPFQ_SAMPLES), generator=gen, device=dev)
    xq = x + 0.05 * torch.randn((k, GPFQ_SAMPLES), generator=gen, device=dev)
    h_half, g = G.me_stats(x, xq)
    w = torch.randn((k, c), generator=gen, device=dev) * 0.02
    w_int, _ = G._prepare(w, weight_alphabet(4))
    act = act_alphabet(8, signed=(mode == "joint"))
    axe = None if mode == "plain" else G.AxeConfig(p_bits=16, tile=128)
    state = G.make_axe_state(w_int, axe, act, rounding, k)
    order = G.act_order_permutation(h_half)
    xg = G.gh_inverse(h_half, g)[order].contiguous()
    xh = h_half[order].contiguous()
    hg, hn = row_terms(xg, xh)
    if state is None:
        lam = torch.zeros((1, c), device=dev)
        tid = torch.zeros((k,), dtype=torch.int32, device=dev)
        a = b = 0.0
    else:
        lam, a, b = state["lam"].contiguous(), state["A"], state["B"]
        tid = state["tile_ids"][order].to(torch.int32).contiguous()
    args = (w_int[order].contiguous(), xg, xh, hg, hn, lam, tid, a, b)
    return args, act, order, axe


def u_consistent(torch, args, q, u) -> bool:
    """U equal to Xg^T W - Xh^T Q recomputed in float64 from the solve's own
    codes: rtol 1e-4, and an atol of 1e-4 of the largest sum of the terms'
    magnitudes (an entry that cancels to near 0 keeps f32 rounding of its
    terms)."""
    w, xg, xh = (a.double() for a in args[:3])
    qd = q.double()
    ref = xg.T @ w - xh.T @ qd
    scale = float((xg.abs().T @ w.abs() + xh.abs().T @ qd.abs()).max())
    return bool(torch.allclose(u.double(), ref, rtol=1e-4, atol=1e-4 * scale))


def gpfq_profile(torch, fn, plan: dict) -> dict:
    """One solve under torch.profiler, run after a warm-up solve and a
    short device sleep (``spin_kernel``) in the same trace, so the trace is
    open before the solve starts: the card's kernels for the solve (those
    that start after the sleep) by name, held to the plan (one Gram
    product, one sum of its parts, a recurrence and an update per row
    block), and the span from the first one's start to the last one's
    end."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.start for e in evs if "spin_kernel" in e.name]
    check(len(marks) == 1, f"the profiler saw {len(marks)} device sleeps, not 1")
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if "gpfq_" in e.name and e.time_range.start > marks[0])
    names = {n: sum(f"gpfq_{n}_kernel" in e[2] for e in evs)
             for n in ("gram", "gram_sum", "rows", "update")}
    want = {"gram": 1, "gram_sum": 1, "rows": plan["blocks"], "update": plan["blocks"]}
    check(names == want, f"the profiler saw gpfq_solve kernels {names}, the plan has {want}")
    return {"kernels": len(evs), "by_name": names,
            "span_ms": (evs[-1][1] - evs[0][0]) / 1e3}


def phase_gpfq(torch):
    from repro_torch.core.overflow import certify
    from repro_torch.kernels.gpfq_solve import (
        block_plan,
        gpfq_solve,
        gpfq_solve_kernel,
        gpfq_solve_plain,
        tie_limited_agreement,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows, max_err = [], 0.0
    for k, c, mode, rounding in GPFQ_CASES:
        plan = block_plan(k, k, c)
        check(plan["rows"] == 64 and plan["kernels"] == 2 + 2 * -(-k // 64),
              f"gpfq_solve plan K={k} C={c}: {plan}")
        args, act, order, axe = gpfq_case_inputs(torch, k, c, mode, rounding, gen)
        kw = dict(qmax=7.0, mode=mode, rounding=rounding)
        before = gpfq_solve.device_kernels
        q, u, pos, neg = gpfq_solve_kernel(*args, **kw)
        kernels = gpfq_solve.device_kernels - before
        check(kernels == plan["kernels"], f"gpfq_solve K={k} C={c}: {kernels} kernels "
                                          f"launched, plan {plan['kernels']}")
        again = gpfq_solve_kernel(*args, **kw)
        pq, pu, ppos, pneg, v = gpfq_solve_plain(*args, **kw, return_v=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((q, u, pos, neg), again)),
              f"gpfq_solve K={k} C={c}: two runs differ")
        del again
        ok, share, cut = tie_limited_agreement(pq, q, v, rounding, 1e-3)
        check(ok, f"gpfq_solve K={k} C={c} {mode}/{rounding}: codes differ before the first "
                  f"tie (share equal {share:.5f})")
        check(u_consistent(torch, args, q, u),
              f"gpfq_solve K={k} C={c}: U is not Xg^T W - Xh^T Q of its own codes")
        max_err = max(max_err, (q - pq).abs().max().item())
        tid, n_tiles = args[6], args[5].shape[0]
        if mode == "plain":
            check(not pos.any() and not neg.any(), "plain GPFQ kept budget state")
        else:
            sums_p = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(),
                                                                      q.clamp(min=0))
            sums_n = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(),
                                                                      q.clamp(max=0))
            check(torch.equal(sums_p, pos) and torch.equal(sums_n, neg),
                  f"gpfq_solve K={k} C={c}: pos/neg are not the tile sums of its codes")
        cert = None
        if axe is not None:
            rep = certify(q[torch.argsort(order)], act, 16, 128)
            check(bool(rep), f"gpfq_solve K={k} C={c} {mode}: certificate fails: {rep}")
            cert = rep.headroom_bits
        ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw), reps=5, flush=flush)
        plain_ms = wall_ms(torch, lambda: gpfq_solve_plain(*args, **kw), reps=2)
        bms, by = gpfq_bound_ms(k, k, c)
        rows.append({"K": k, "C": c, "mode": mode, "rounding": rounding,
                     "row_blocks": plan["blocks"], "kernels_per_solve": kernels,
                     "share_equal": share, "channels_cut_by_tie": cut,
                     "headroom_bits": cert, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
        print(f"[gpfq] K={k:5d} C={c:5d} {mode:5s} {rounding:7s} {plan['blocks']} blocks of "
              f"{plan['rows']} rows, {kernels} kernels a solve: tie-limited agreement ok, "
              f"{share:.5f} of codes equal ({cut} channels cut by a tie), pos/neg exact, "
              f"two runs bit-identical, U consistent, "
              f"headroom {cert if cert is None else round(cert, 4)} bits; kernel {ms:.4f} ms "
              f"(per-panel kernel: {GPFQ_PANEL_MS[(k, c, mode, rounding)]:.4f} ms)  "
              f"plain {plain_ms:.1f} ms  bound {bms:.4f} ms ({by})")
        if (mode, rounding) == ("split", "nearest"):
            prof = gpfq_profile(torch, lambda: gpfq_solve_kernel(*args, **kw), plan)
            rows[-1]["profile"] = prof
            print(f"[gpfq-profile] K={k:5d} C={c:5d}: {prof['kernels']} kernels on the card "
                  f"{prof['by_name']}, as planned; span {prof['span_ms']:.4f} ms")
    layer = {(r["K"], r["C"]): r["ms"] for r in rows
             if (r["mode"], r["rounding"]) == ("split", "nearest")}
    print(f"[gpfq] one smollm-360m layer's 7 sites: {sum(layer[kn] for kn in LAYER_SITES):.4f} "
          f"ms (per-panel kernel: "
          f"{sum(GPFQ_PANEL_MS[(*kn, 'split', 'nearest')] for kn in LAYER_SITES):.4f} ms)")
    return rows, max_err


def phase_calibration(torch):
    import tempfile
    from dataclasses import replace

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core import gpfq as G
    from repro_torch.core.axe import PTQConfig
    from repro_torch.core.calibration import ActObserver, LayerStats
    from repro_torch.core.overflow import min_feasible_p_bits
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.kernels import gpfq_solve as B5
    from repro_torch.models import transformer as T
    from repro_torch.quant.pipeline import calibrate_and_quantize, float_ppl, quantized_ppl
    from repro_torch.quant.serve_packed import (
        export_quantized_artifact,
        load_flat_artifact,
        packed_params_from_artifact,
    )
    from repro_torch.serving import GenerationEngine, SamplerConfig

    # the reference's solvers take float32 weights: an f32 copy of the config
    cfg = replace(get_config("smollm-360m"), param_dtype="float32", act_dtype="float32")
    model = T.init_model(cfg, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    evalb = list(data.eval_batches(EVAL_BATCHES))

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    # where the time goes, from a second calibration: events around each B5
    # launch; host clock (ending in a synchronize, which the first run does
    # not have) around the eigendecomposition, the solve for G H^-1 and the
    # host-side percentile observer
    spent = {"eigh": 0.0, "solve": 0.0, "observer": 0.0}
    b5_events = []
    originals = (B5.gpfq_solve_kernel, LayerStats.gpfq_stats, G.gh_inverse,
                 ActObserver.update)

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    def b5_timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = originals[0](*a, **kw)
        end.record()
        b5_events.append((start, end))
        return out

    B5.gpfq_solve_kernel = b5_timed
    LayerStats.gpfq_stats = timed("eigh", originals[1])
    G.gh_inverse = timed("solve", originals[2])
    ActObserver.update = timed("observer", originals[3])
    try:
        t0 = time.perf_counter()
        calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cuda")
        torch.cuda.synchronize()
        wall_i = time.perf_counter() - t0
    finally:
        (B5.gpfq_solve_kernel, LayerStats.gpfq_stats, G.gh_inverse,
         ActObserver.update) = originals
    b5_s = sum(s.elapsed_time(e) for s, e in b5_events) / 1e3
    sites = 7 * cfg.n_layers
    check(counts["gpfq_solve"] == sites,
          f"{counts['gpfq_solve']} gpfq_solve launches in calibration, expected {sites}")
    check(counts["w4a8_matmul"] == 0, f"calibration launched w4a8_matmul: {counts}")
    summary = qm.cert_summary()
    check(summary["ok"] and summary["n_certified"] == sites, f"certificates: {summary}")
    ppl_f, ppl_q = float_ppl(model, cfg, evalb), quantized_ppl(qm, evalb)
    check(math.isfinite(ppl_f) and math.isfinite(ppl_q), f"perplexities {ppl_f} {ppl_q}")
    print(f"[calib] smollm-360m full width in float32 ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), GPFQ W4A8 P_I=16 T=128 act_order SmoothQuant, "
          f"{CALIB_BATCHES} x {CALIB_BATCH} x {CALIB_SEQ} tokens")
    print(f"[calib] gpfq_solve launches {counts['gpfq_solve']} (= 7 x {cfg.n_layers}); "
          f"certified {summary['n_certified']} sites, min headroom "
          f"{summary['min_headroom_bits']:.4f} bits at {summary['min_headroom_site']}")
    print(f"[calib] wall {wall:.3f} s; the instrumented second run {wall_i:.3f} s: B5 "
          f"{b5_s:.3f} s ({100 * b5_s / wall_i:.1f}%), eigh {spent['eigh']:.3f} s "
          f"({100 * spent['eigh'] / wall_i:.1f}%), solve {spent['solve']:.3f} s "
          f"({100 * spent['solve'] / wall_i:.1f}%), host observer {spent['observer']:.3f} s "
          f"({100 * spent['observer'] / wall_i:.1f}%)")
    print(f"[calib] B5 per layer {1e3 * b5_s / cfg.n_layers:.3f} ms (7 solves, summed over "
          f"the instrumented run's {len(b5_events)} solves / {cfg.n_layers} layers)")
    print(f"[calib] float ppl {ppl_f:.4f}, quantized ppl {ppl_q:.4f} on {EVAL_BATCHES} eval "
          f"batches (random weights)")

    artifact, meta = export_quantized_artifact(qm)
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(artifact, os.path.join(tmp, "quantized"), meta)
        flat, meta2 = load_flat_artifact(os.path.join(tmp, "quantized"))
    served = packed_params_from_artifact(flat, model, cfg, meta=meta2)
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                      global_batch=BATCH, seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(served, cfg, SamplerConfig(temperature=0.0), device="cuda")
    engine.generate(prompts, MAX_NEW)  # warm-up
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    gen_s = time.perf_counter() - t0
    serve_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = 7 * cfg.n_layers * MAX_NEW
    check(serve_counts["w4a8_matmul"] == expected,
          f"{serve_counts['w4a8_matmul']} w4a8 launches serving the artifact, expected "
          f"{expected}")
    check(serve_counts["gpfq_solve"] == 0, f"serving launched gpfq_solve: {serve_counts}")
    ref_out = GenerationEngine(served, cfg, SamplerConfig(temperature=0.0), device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
    check((out == ref_out).all(), "kernel and reference backends disagree on the artifact")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    step_ms = decode_step_ms(torch, served, prompts, out)
    print(f"[calib] artifact: {len(artifact)} leaves, {meta['datapath']}; served greedy batch "
          f"{BATCH} x prompt {PROMPT} + {MAX_NEW} new (float32, static activation "
          f"quantizers): {serve_counts['w4a8_matmul']} w4a8 launches, tokens identical to the "
          f"reference backend, {BATCH * MAX_NEW / gen_s:.1f} tok/s (wall {gen_s:.4f} s), "
          f"decode step {step_ms:.3f} ms (host clock), peak memory {peak / 2**20:.1f} MiB")
    floors = {name: min_feasible_p_bits(ql.cert) for name, ql in qm.quantized_linears()}
    return {"launches": counts["gpfq_solve"], "wall_s": wall, "instrumented_wall_s": wall_i,
            "b5_s": b5_s, **spent,
            "serve_launches": serve_counts["w4a8_matmul"], "floors": floors,
            "serve": {"gen_s": gen_s, "tok_s": BATCH * MAX_NEW / gen_s, "step_ms": step_ms,
                      "peak_mib": peak / 2**20}}


# ---------------------------------------------------------------------------
# Phase 6: the paged decode-attention kernels (B2, B3)
# ---------------------------------------------------------------------------
def paged_case(torch, rng, B, nkv, g, hd, bs, P, lens, dtype):
    """One paged-attention call on the card: distinct pages per row, the
    sentinel nb past each row's pages in a table P wide, a pool of the pages
    the lengths need and 4 more; ``lens`` a tuple or a sweep mode of the
    reference's tests (ragged, exact, exact+-1) or "split+-1" (k * S * bs
    +- 1 tokens, k = 1, 2, for the card's split count S)."""
    import numpy as np
    from repro_torch.kernels import paged_attention as PA

    full = P * bs
    if lens == "ragged":
        lens = rng.integers(1, full + 1, size=B)
    elif lens == "exact":
        lens = [((i % P) + 1) * bs for i in range(B)]
    elif lens == "exact+-1":
        lens = [max(1, bs - 1), bs + 1, full, max(1, full - 1)][:B]
    elif lens == "split+-1":
        S = PA.split_plan(B, nkv, P, PA._sm_count(0))
        lens = [k * S * bs + d for k in (1, 2) for d in (-1, 1)] * (B // 4)
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // bs) for n in lens]
    nb = sum(need) + 4
    tab = np.full((B, P), nb, np.int32)
    perm, o = rng.permutation(nb), 0
    for b in range(B):
        tab[b, :need[b]] = perm[o:o + need[b]]
        o += need[b]
    dev = torch.device("cuda")

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    q = normal(B, nkv * g, hd).to(dtype)
    kp, vp = normal(nb, bs, nkv, hd), normal(nb, bs, nkv, hd)
    return q, kp, vp, torch.from_numpy(tab).to(dev), torch.from_numpy(lens).to(dev)


def bf16_ulp_ok(torch, a, b) -> bool:
    """|a - b| within one bf16 ulp of the larger magnitude, or 1e-5 (an
    output near 0 moves by more than its bf16 ulp when the f32 sums are
    taken in another order)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(min=1e-5)
    return bool(((a - b).abs() <= ulp).all())


def paged_bound_ms(torch, q, k_pages, lens, quantized) -> tuple[float, str]:
    """Least time for one call: q, the K/V pages the lengths need (and
    their scales), the table entries and lengths read once, the output
    written once, against 4*nh*len*hd operations at the peak for the
    pages' type."""
    B, nh, hd = q.shape
    _, bs, nkv, _ = k_pages.shape
    pages = int(sum(-(-int(n) // bs) for n in lens.tolist()))
    page_bytes = bs * nkv * hd * k_pages.element_size() + (4 * nkv if quantized else 0)
    nbytes = 2 * q.numel() * q.element_size() + 2 * pages * page_bytes + 4 * (pages + B)
    ops = 4 * nh * hd * int(lens.sum())
    peak = INT8_OPS_PER_S if quantized else (BF16_OPS_PER_S if q.dtype == torch.bfloat16
                                             else F32_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(torch, q, k_pages, v_pages, tab, lens, k_scales=None, v_scales=None):
    """``scaled_dot_product_attention`` on K/V gathered beforehand into
    dense (B, nkv, S, hd) form (dequantized for int8 pages), with the
    length mask and GQA: one library call computing the same function."""
    import torch.nn.functional as F

    B, nh, hd = q.shape
    nb, bs, nkv, _ = k_pages.shape
    idx = tab.clamp(max=nb - 1).long()

    def dense(pages, scales):
        x = pages[idx]
        if scales is not None:
            x = x.float() * scales[idx][:, :, None, :, None]
        return x.reshape(B, -1, nkv, hd).transpose(1, 2).to(q.dtype).contiguous()

    k, v = dense(k_pages, k_scales), dense(v_pages, v_scales)
    mask = (torch.arange(k.shape[2], device=q.device)[None, :] < lens[:, None])[:, None, None]
    q4 = q[:, :, None, :]

    def call():
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)

    return call, lambda: call()[:, :, 0]


def phase_paged_kernels(torch):
    import numpy as np
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.quant.spec import AttnDatapathSpec

    rng = np.random.default_rng(0)
    err = {"float": 0.0, "int8": 0.0}
    n_cases = n_ties = 0
    for B, nkv, g, hd, bs, P, lens, cap in PAGED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tab, ln = paged_case(torch, rng, B, nkv, g, hd, bs, P, lens, dtype)
            kp, vp = kp.to(dtype), vp.to(dtype)
            case = (B, nkv, g, hd, bs, P, tuple(ln.tolist()), cap)
            live = ln > 0  # an idle slot: the kernels give 0, the plain B2 softmax NaN
            out = PA.paged_attention_kernel(q, kp, vp, tab, ln, softcap=cap)
            ref = PA.paged_attention_plain(q, kp, vp, tab, ln, softcap=cap)
            torch.cuda.synchronize()
            e = (out[live].float() - ref[live].float()).abs().max().item()
            err["float"] = max(err["float"], e)
            ok = (torch.allclose(out[live], ref[live], rtol=1e-5, atol=1e-5)
                  if dtype == torch.float32 else bf16_ulp_ok(torch, out[live], ref[live]))
            check(ok and not out[~live].any(), f"B2 != plain at {case} {dtype}: {e}")
            (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
            wm = torch.zeros(2, dtype=torch.int32, device="cuda")
            out = PA.paged_attention_int8_kernel(q, kc, vc, tab, ln, ks, vs, softcap=cap,
                                                 watermarks=wm)
            wm_ref = torch.zeros(2, dtype=torch.int32)
            ref, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, ln, ks, vs, softcap=cap,
                                                      watermarks=wm_ref, return_ties=True,
                                                      tie_eps=1e-4)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err["int8"] = max(err["int8"], diff.max().item())
            clean = ~ties
            n_ties += int(ties.sum())
            check(diff.max().item() <= 5e-2 and bool(clean.any()) and not out[~live].any(),
                  f"B3 != plain at {case} {dtype}: {diff.max().item()}")
            ok = (diff[clean].max().item() <= 1e-4 if dtype == torch.float32
                  else bf16_ulp_ok(torch, out[clean], ref[clean]))
            check(ok, f"B3 != plain off the ties at {case} {dtype}")
            check(wm.cpu().tolist() == wm_ref.tolist(), f"B3 watermarks {wm.tolist()} != "
                                                        f"plain {wm_ref.tolist()} at {case}")
            PA.check_bounds(wm, AttnDatapathSpec.for_cache(hd, bs))
            n_cases += 1
    print(f"[paged] B2 and B3 against their plain versions: {n_cases} cases x (f32, bf16) "
          f"agree (B2 max |err| {err['float']:.3g}; B3 max |err| {err['int8']:.3g}, "
          f"{n_ties} near-tie rows within 5e-2, the others within 1e-4 / one bf16 ulp; "
          f"watermarks equal; idle slots 0)")

    # the full-magnitude case: every q and k code 127, v codes 127, full pages
    spec = AttnDatapathSpec.for_cache(SMOLLM_HD, PAGED_BLOCK)
    codes = torch.full((8, PAGED_BLOCK, SMOLLM_NKV, SMOLLM_HD), 127, dtype=torch.int8,
                       device="cuda")
    scales = torch.full((8, SMOLLM_NKV), 0.01, device="cuda")
    q = torch.full((2, SMOLLM_NKV * SMOLLM_G, SMOLLM_HD), 0.75, device="cuda",
                   dtype=torch.bfloat16)
    tab = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    lens = torch.tensor([4 * PAGED_BLOCK, 2 * PAGED_BLOCK], dtype=torch.int32, device="cuda")
    wm = torch.zeros(2, dtype=torch.int32, device="cuda")
    PA.paged_decode_attention(q, codes, codes, tab, lens, k_scales=scales, v_scales=scales,
                              attn_spec=spec, assert_bounds=True, watermarks=wm)
    reached = PA.check_bounds(wm, spec)
    check(reached == (spec.qk_worst_abs(), spec.pv_worst_abs()),
          f"full-magnitude watermarks {reached}")
    print(f"[paged] full magnitude: watermarks {reached} = (qk_worst_abs, pv_worst_abs) within "
          f"P_qk={spec.p_qk}, P_pv={spec.p_pv} ({spec.describe()})")

    # the wrapper reads no length on the host: one B2 and one B3 call under
    # the sync debug mode "error"
    q, kp, vp, tab, ln = paged_case(torch, rng, 2, SMOLLM_NKV, SMOLLM_G, SMOLLM_HD, PAGED_BLOCK,
                                    PAGED_TABLE, (1, 2048), torch.bfloat16)
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        PA.paged_decode_attention(q, kp, vp, tab, ln)
        PA.paged_decode_attention(q, kc, vc, tab, ln, k_scales=ks, v_scales=vs, watermarks=wm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[paged] one B2 and one B3 call under torch.cuda.set_sync_debug_mode('error'): "
          "no synchronization")

    # times at smollm-360m decode, bf16 q (and bf16 pages for B2), in
    # PagedEngine's 512-page table; the plain version and the SDPA yardstick
    # take the table cut to the pages the lengths need (the same function)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {"float": [], "int8": []}
    for slots, n in PAGED_TIMED:
        q, kp, vp, tab, ln = paged_case(torch, rng, slots, SMOLLM_NKV, SMOLLM_G, SMOLLM_HD,
                                        PAGED_BLOCK, PAGED_TABLE, (n,) * slots, torch.bfloat16)
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
        cut = tab[:, :-(-n // PAGED_BLOCK)].contiguous()
        splits = PA.split_plan(slots, SMOLLM_NKV, PAGED_TABLE, PA._sm_count(0))
        for kind, pages, scale_args in (("float", (kp, vp), ()), ("int8", (kc, vc), (ks, vs))):
            if kind == "float":
                def kern():
                    return PA.paged_attention_kernel(q, *pages, tab, ln)

                def plain():
                    return PA.paged_attention_plain(q, *pages, cut, ln)
            else:
                def kern():
                    return PA.paged_attention_int8_kernel(q, *pages, tab, ln, *scale_args)

                def plain():
                    return PA.paged_attention_int8_plain(q, *pages, cut, ln, *scale_args)
            lib_call, lib_out = sdpa_yardstick(torch, q, *pages, cut, ln, *scale_args)
            scale_kw = dict(zip(("k_scales", "v_scales"), scale_args))
            oracle = PA.paged_attention_reference(q, *pages, cut, ln, **scale_kw)
            lib_err = (lib_out().float() - oracle.float()).abs().max().item()
            check(lib_err < 5e-2, f"the SDPA yardstick disagrees ({kind}, {n}): {lib_err}")
            bms, by = paged_bound_ms(torch, q, pages[0], ln, kind == "int8")
            row = {"slots": slots, "tokens": n, "nh": SMOLLM_NKV * SMOLLM_G,
                   "nkv": SMOLLM_NKV, "hd": SMOLLM_HD, "bs": PAGED_BLOCK, "dtype": "bfloat16",
                   "table_cols": PAGED_TABLE, "splits": splits,
                   "ms": time_ms(torch, kern, flush=flush),
                   "plain_ms": time_ms(torch, plain, reps=10, flush=flush),
                   "library_ms": time_ms(torch, lib_call, flush=flush),
                   "bound_ms": bms, "bound_by": by}
            rows[kind].append(row)
            # printed for the reader only: not measured in this run, so it
            # stays out of the kernels record
            first = PAGED_FIRST_MS.get((kind, slots, n))
            print(f"[paged] {'B2' if kind == 'float' else 'B3'} {slots} slots x {n} tokens, "
                  f"{splits} splits: kernel {row['ms']:.5f} ms  bound {bms:.5f} ms ({by})  "
                  f"plain {row['plain_ms']:.5f} ms  sdpa {row['library_ms']:.5f} ms  first "
                  f"kernel (PR 14) {'n/a' if first is None else f'{first:.5f} ms'}")
    return rows, err


# ---------------------------------------------------------------------------
# Phase 7: the paged slice on smollm-360m
# ---------------------------------------------------------------------------
class LogitRecorder:
    """Records every row the paged engine samples, keyed (uid, step)."""

    def __init__(self):
        self.rows = {}

    def __enter__(self):
        from repro_torch.serving import paged_engine as PE

        self._orig = PE.sample_rows

        def spy(logits, temperature, seed, uids, steps):
            host = logits.float().cpu()
            for i, key in enumerate(zip(uids.tolist(), steps.tolist())):
                self.rows.setdefault(key, host[i])
            return self._orig(logits, temperature, seed, uids, steps)

        PE.sample_rows = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import paged_engine as PE

        PE.sample_rows = self._orig


def tie_limited(streams, vocab: int) -> dict:
    """Compare pairs of greedy streams that should be equal: ``streams`` is
    a list of (new tokens a, new tokens b, logits of a by step, logits of b
    by step). The tie band is twice the largest logit difference between
    the two runs over every step where their streams still agree (the same
    prefix); a pair may part only at a step whose top-1/top-2 gap in run b
    lies within the band, and the band must stay within TIE_BAND_CAP."""
    import torch

    deltas, partings, agree, total = [], [], 0, 0
    for a, b, la, lb in streams:
        n = len(b)
        first = next((t for t in range(n) if a[t] != b[t]), None)
        upto = n if first is None else first
        agree += upto
        total += n
        for t in range(upto):
            deltas.append((la[t][:vocab] - lb[t][:vocab]).abs().max().item())
        if first is not None:
            top2 = torch.topk(lb[first][:vocab], 2).values
            partings.append((first, (top2[0] - top2[1]).item()))
    check(bool(deltas), "no agreeing step to measure the tie band on")
    band = 2 * max(deltas)
    check(band <= TIE_BAND_CAP, f"tie band {band:.4f} above {TIE_BAND_CAP}: the runs differ "
                                f"by more than numerical noise")
    for t, gap in partings:
        check(gap <= band, f"streams part at step {t} where the top-2 gap {gap:.4f} exceeds "
                           f"the tie band {band:.4f}")
    return {"agree": agree, "total": total, "band": band, "partings": partings}


def fixed_slot_run(torch, model, prompts, max_new):
    """Greedy fixed-slot generation as ``GenerationEngine.generate`` runs
    it (prefill, then decode steps), with every step's logits."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import use_packed_backend

    with torch.inference_mode(), use_packed_backend("kernel"):
        p = torch.as_tensor(prompts, device="cuda")
        B, s0 = p.shape
        logits, caches = T.prefill(model, {"tokens": p}, s0 + max_new)
        steps = [logits[:, -1].float().cpu()]
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks = [nxt]
        for t in range(1, max_new):
            logits, caches = T.decode_step(model, nxt[:, None], caches, s0 + t - 1)
            steps.append(logits[:, -1].float().cpu())
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            toks.append(nxt)
    return torch.stack(toks, dim=1).cpu().numpy(), steps


def serve_timed(torch, engine, reqs):
    """``engine.serve`` with the host clock read after every program (each
    ends in a host read: the device is done): admit and decode-chunk times."""
    spent = {"admit": 0.0, "chunk": 0.0}
    last = {"t": None, "admits": 0, "chunks": 0}

    def programs(e):
        return e.admits + e.suffix_admits + e.cached_admits, e.chunks

    def probe(e, sched):
        now = time.perf_counter()
        admits, chunks = programs(e)
        if admits != last["admits"]:
            spent["admit"] += now - last["t"]
        elif chunks != last["chunks"]:
            spent["chunk"] += now - last["t"]
        last.update(t=now, admits=admits, chunks=chunks)

    torch.cuda.synchronize()
    last["admits"], last["chunks"] = programs(engine)
    t0 = last["t"] = time.perf_counter()
    out = engine.serve(reqs, _probe=probe)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, spent


def trace_specs(cfg):
    """Phase 7's trace: TRACE_REQUESTS (uid, prompt, max_new) of seeded
    lengths (prompts 8-300, 4-32 new), and the generator it leaves."""
    import numpy as np

    rng = np.random.default_rng(0)
    specs = [(uid, rng.integers(0, cfg.vocab, size=int(rng.integers(8, 301))),
              int(rng.integers(4, 33))) for uid in range(TRACE_REQUESTS)]
    return specs, rng


def phase_paged_slice(torch):
    import numpy as np
    import torch.profiler
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )
    from repro_torch.serving.scheduler import kv_pool_bytes

    cfg = get_config("smollm-360m")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    greedy = SamplerConfig(temperature=0.0)
    sites = 7 * cfg.n_layers

    def engine(kv_dtype="act", **kw):
        return PagedEngine(model, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, attn_impl="auto", kv_dtype=kv_dtype, **kw), greedy,
            device="cuda", **({"assert_bounds": True} if kv_dtype == "int8" else {}))

    # (a) equal-length batch against the fixed-slot engine
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]
    engine().generate(prompts, MAX_NEW)  # warm-up (allocator, cuBLAS handles)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng_a = engine()
    out = eng_a.generate(prompts, MAX_NEW)
    wall_a = time.perf_counter() - t0
    counts = read_counts()
    check(counts["paged_decode_attention"] == cfg.n_layers * eng_a.decode_steps,
          f"B2 launches {counts} for {eng_a.decode_steps} decode steps")
    check(counts["w4a8_matmul"] == sites * (eng_a.decode_steps + eng_a.admits),
          f"B1 launches {counts}")
    fixed = GenerationEngine(model, cfg, greedy, device="cuda").generate(prompts, MAX_NEW)
    fixed_toks, fixed_logits = fixed_slot_run(torch, model, prompts, MAX_NEW)
    check((fixed_toks == fixed[:, PROMPT:]).all(), "the recorded fixed-slot run differs "
                                                   "from GenerationEngine.generate")
    with LogitRecorder() as rec:
        again = engine().generate(prompts, MAX_NEW)
    check((again == out).all(), "two paged runs differ")
    cmp_a = tie_limited([(out[b, PROMPT:], fixed_toks[b],
                          [rec.rows[(b, t)] for t in range(MAX_NEW)],
                          [fixed_logits[t][b] for t in range(MAX_NEW)])
                         for b in range(BATCH)], cfg.vocab)
    print(f"[paged-slice] (a) {BATCH} x prompt {PROMPT} + {MAX_NEW} new: {cmp_a['agree']} of "
          f"{cmp_a['total']} tokens agree with GenerationEngine (partings {cmp_a['partings']}, "
          f"tie band {cmp_a['band']:.4f}); B2 launches {counts['paged_decode_attention']} = "
          f"{cfg.n_layers} x {eng_a.decode_steps} steps; {BATCH * MAX_NEW / wall_a:.1f} tok/s")

    # (b) mid-flight admission, float then int8 KV
    specs, rng = trace_specs(cfg)

    def trace():
        return [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]

    runs = {}
    for kv in ("act", "int8"):
        eng = engine(kv)
        reset_peak(torch)
        reset_counts()
        res, wall, spent = serve_timed(torch, eng, trace())
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        key = "paged_decode_attention" if kv == "act" else "paged_decode_attention_int8"
        other = "paged_decode_attention_int8" if kv == "act" else "paged_decode_attention"
        check(counts[key] == cfg.n_layers * eng.decode_steps and counts[other] == 0,
              f"{kv}: attention launches {counts} for {eng.decode_steps} decode steps")
        forwards = eng.decode_steps + eng.admits + eng.suffix_admits
        check(counts["w4a8_matmul"] == sites * forwards, f"{kv}: B1 launches {counts} for "
                                                         f"{forwards} forwards")
        for u, p, n in specs:
            check(res[u].size == p.size + n, f"{kv}: request {u} incomplete")
        pool = eng.pool_state
        check(pool.free_top == 0 and not pool.page_rc.any()
              and int(eng.cache["free_top"]) == 0 and not eng.cache["page_refcounts"].any(),
              f"{kv}: pages not all back on the free list")
        n_new = sum(n for _, _, n in specs)
        runs[kv] = {"res": res, "digest": pool.digest(), "counts": counts, "wall": wall,
                    "steps": eng.decode_steps, "admits": eng.admits, "spent": spent,
                    "peak": peak, "tok_s": n_new / wall,
                    "step_ms": 1e3 * spent["chunk"] / eng.decode_steps,
                    "admit_ms": 1e3 * spent["admit"] / eng.admits,
                    "pool_mib": kv_pool_bytes(cfg, PAGED_BLOCKS, PAGED_BLOCK, kv) / 2**20,
                    "watermarks": getattr(eng, "watermark_values", None)}
        print(f"[paged-slice] (b) {kv} KV: {TRACE_REQUESTS} requests, {eng.decode_steps} decode "
              f"steps in {eng.chunks} chunks, {eng.admits} admits; launches {counts}; "
              f"decode step {runs[kv]['step_ms']:.3f} ms, admit {runs[kv]['admit_ms']:.3f} ms "
              f"(host clock), {runs[kv]['tok_s']:.1f} tok/s, wall {wall:.3f} s; pool "
              f"{runs[kv]['pool_mib']:.2f} MiB; peak memory {peak / 2**20:.1f} MiB")
    check(runs["act"]["digest"] == runs["int8"]["digest"], "float and int8 allocator digests differ")
    spec = engine("int8").attn_spec
    qk, pv = runs["int8"]["watermarks"]
    check(qk <= 2 ** (spec.p_qk - 1) - 1 and pv <= 2 ** (spec.p_pv - 1) - 1 and spec.p_qk == 21
          and spec.p_pv == 22, f"B3 watermarks {qk}, {pv} against {spec.describe()}")
    same = sum(int((runs["act"]["res"][u][p.size:] == runs["int8"]["res"][u][p.size:]).sum())
               for u, p, _ in specs)
    total = sum(n for _, _, n in specs)
    print(f"[paged-slice] (b) equal digests {runs['act']['digest']}; B3 watermarks |QK^T| {qk} "
          f"<= {2 ** (spec.p_qk - 1) - 1}, |PV| {pv} <= {2 ** (spec.p_pv - 1) - 1} "
          f"({spec.describe()}); int8 agrees with float on {same} of {total} tokens "
          f"({same / total:.4f})")

    # (c) the prefix cache: warm streams against a cold engine's
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN)
    pspecs = [(100 + i, np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                              size=int(rng.integers(1, 41)))]),
               8) for i in range(6)] + [(106, prefix.copy(), 8)]
    preqs = [Request(uid=u, prompt=p, max_new=n) for u, p, n in pspecs]
    warm_eng = engine(prefix_cache=True)
    cached_counts = []
    orig = warm_eng._admit_cached

    def admit_cached(adm):
        before = read_counts()
        orig(adm)
        torch.cuda.synchronize()
        cached_counts.append({k: v - before[k] for k, v in read_counts().items()})

    warm_eng._admit_cached = admit_cached
    with LogitRecorder() as warm_rec:
        warm = warm_eng.serve(preqs)
    with LogitRecorder() as cold_rec:
        cold = engine().serve(preqs)
    check(len(cached_counts) == 1 and not any(cached_counts[0].values()),
          f"cached admit launches {cached_counts}")
    check(warm_eng.suffix_admits == 5 and warm_eng.cached_admits == 1,
          f"admits {warm_eng.admits}/{warm_eng.suffix_admits}/{warm_eng.cached_admits}")
    cmp_c = tie_limited([(warm[u][p.size:], cold[u][p.size:],
                          [warm_rec.rows[(u, t)] for t in range(n)],
                          [cold_rec.rows[(u, t)] for t in range(n)]) for u, p, n in pspecs],
                        cfg.vocab)
    print(f"[paged-slice] (c) prefix cache: 1 cold, {warm_eng.suffix_admits} suffix and "
          f"{warm_eng.cached_admits} cached admits (the cached one launched nothing: "
          f"{cached_counts[0]}); hit rate {warm_eng.prefix_cache.stats()['hit_rate']:.3f}; "
          f"{cmp_c['agree']} of {cmp_c['total']} tokens agree with a cold engine (partings "
          f"{cmp_c['partings']}, tie band {cmp_c['band']:.4f})")

    # one decode chunk under the profiler
    prof_eng = engine()
    orig_chunk = prof_eng._chunk
    chunk = {}

    def profiled(k):
        if chunk:
            return orig_chunk(k)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            buf = orig_chunk(k)
            chunk["wall_ms"] = 1e3 * (time.perf_counter() - t)
        chunk["k"], chunk["prof"] = k, prof
        return buf

    prof_eng._chunk = profiled
    prof_eng.generate(prompts, PAGED_CHUNK + 1)
    events = chunk["prof"].key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=12))
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    b2 = sum(e.self_device_time_total for e in kernels if "paged_attn_float" in e.key) / 1e3
    b2_calls = sum(e.count for e in kernels if "paged_attn_float" in e.key)
    b1 = sum(e.self_device_time_total for e in kernels if "w4a8_kernel" in e.key) / 1e3
    check(b2 > 0 and b1 > 0, "the profiler saw no B2 or B1 kernel in a decode chunk")
    print(f"[profile] one decode chunk of {chunk['k']} steps, {PAGED_SLOTS} slots: "
          f"{chunk['wall_ms']:.3f} ms on the host clock, device busy {busy:.3f} ms "
          f"({100 * busy / chunk['wall_ms']:.1f}%), B2 {b2:.3f} ms in {b2_calls} launches "
          f"({1e3 * b2 / max(b2_calls, 1):.3f} us a launch), B1 {b1:.3f} ms")
    return {"a": cmp_a, "runs": runs, "c": cmp_c,
            "profile": {"chunk_wall_ms": chunk["wall_ms"], "busy_ms": busy, "b2_ms": b2,
                        "b2_launches": b2_calls, "b1_ms": b1, "steps": chunk["k"]}}


# ---------------------------------------------------------------------------
# Phase 8: the 2:4 kernels (B4, masked B5) and the fused RMSNorm quantizer (B6)
# ---------------------------------------------------------------------------
def sparse_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one B4 call: codes, packed kept codes and meta (K/4
    bytes each per column) and the two f32 epilogue vectors read once, the
    bf16 output written once, against the products the kept codes need
    (half of K) at the int8 tensor-core peak."""
    nbytes = m * k + 2 * (k // 4) * n + 2 * 4 * n + 2 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * n * (k // 2) / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_bound_ms(m: int, d: int, in_bytes: int) -> tuple[float, str]:
    """Least time for one B6 call: x and gamma read once, the uint8 codes
    written once, against about 8 float32 operations an element."""
    nbytes = m * d * in_bytes + 4 * d + 8 + m * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 8 * m * d / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def semi_structured_yardstick(torch, w8, xs, exact):
    """``torch.sparse.to_sparse_semi_structured`` int8 x int8 on the expanded
    codes (2:4 along K, so the transposed (N, K) weight is compressed), the
    activations as a column-major operand: ``torch.mm``, else the int32
    output of ``torch._cslt_sparse_mm`` on the same compressed weight.
    Returns (call, its name) for the first whose product passes the
    caller's ``exact`` check, else (None, why not)."""
    why = []
    try:
        from torch.sparse import to_sparse_semi_structured

        ws = to_sparse_semi_structured(w8.t().contiguous())
    except Exception as e:  # the library's refusal is the record, not a failure
        return None, (str(e).strip().splitlines() or [type(e).__name__])[0][:160]
    xb = xs.t()
    calls = [("mm", lambda: torch.mm(ws, xb))]
    if hasattr(torch, "_cslt_sparse_mm") and getattr(ws, "packed", None) is not None:
        calls.append(("_cslt_sparse_mm int32", lambda: torch._cslt_sparse_mm(
            ws.packed, xb, out_dtype=torch.int32)))
    for name, call in calls:
        try:
            out = call()
            prod = out.t() if out.shape[0] == w8.shape[1] else out
            if exact(prod):
                return call, name
            why.append(f"{name}: {out.dtype} output disagrees with the exact product")
        except Exception as e:
            why.append(f"{name}: " + (str(e).strip().splitlines() or [type(e).__name__])[0])
    return None, "; ".join(why)[:240]


def phase_sparse_kernels(torch, gpfq_rows):
    from repro_torch.core.alphabet import act_alphabet
    from repro_torch.core.overflow import certify
    from repro_torch.core.sparsity import is_2to4, mask_2to4
    from repro_torch.kernels import quant_rmsnorm as B6
    from repro_torch.kernels.gpfq_solve import (
        gpfq_solve_kernel,
        gpfq_solve_plain,
        tie_limited_agreement,
    )
    from repro_torch.kernels.ops import norm_and_quantize
    from repro_torch.kernels.w4a8_mm import (
        check_inner,
        compress_2to4,
        pack_int4,
        unpack_sparse24,
        w4a8_matmul,
        w4a8_matmul_kernel,
        w4a8_sparse_matmul,
        w4a8_sparse_matmul_kernel,
        w4a8_sparse_matmul_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    # B4 at phase 2's shapes: bit-equal to its plain version and to B1 on
    # the expanded codes
    b4_rows, b4_err = [], 0.0
    cases = [(m, k, n) for m in (4, 256) for k, n in SHAPES_KN] + [(3, 960, 100)]
    for m, k, n in cases:
        q = torch.randint(-8, 8, (k, n), generator=gen, device=dev)
        q = q * mask_2to4(q.float()).to(q.dtype)
        packed, meta = compress_2to4(q)
        check(torch.equal(unpack_sparse24(packed, meta), q.to(torch.int8)),
              f"2:4 compression does not round-trip at K={k} N={n}")
        dense = pack_int4(q)
        col_sums = q.sum(0).to(torch.int32)
        scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 1e-3
        act_scale = torch.tensor(0.0213, device=dev)
        row = {"M": m, "K": k, "N": n}
        for act in ("uint8", "int8"):
            lo, hi = (0, 256) if act == "uint8" else (-128, 128)
            x = torch.randint(lo, hi, (m, k), generator=gen, device=dev).to(getattr(torch, act))
            zp = torch.tensor(131.0 if act == "uint8" else 0.0, device=dev)
            kw = dict(col_sums=col_sums, out_dtype=torch.bfloat16)
            y = w4a8_sparse_matmul(x, packed, meta, scale, act_scale, zp, **kw)
            r = w4a8_sparse_matmul(x, packed, meta, scale, act_scale, zp, reference=True, **kw)
            b1 = w4a8_matmul(x, dense, scale, act_scale, zp, **kw)
            torch.cuda.synchronize()
            b4_err = max(b4_err, (y.float() - r.float()).abs().max().item())
            check(torch.equal(y, r), f"B4 != plain at M={m} K={k} N={n} {act}")
            check(torch.equal(y, b1), f"B4 != B1 on the expanded codes at M={m} K={k} N={n} "
                                      f"{act}")
            if act == "uint8":
                sw = scale * act_scale
                corr = col_sums.to(torch.float32) * zp
                row["ms"] = time_ms(torch, lambda: w4a8_sparse_matmul_kernel(
                    x, packed, meta, sw, corr, torch.bfloat16), flush=flush)
                row["b1_ms"] = time_ms(torch, lambda: w4a8_matmul_kernel(
                    x, dense, sw, corr, torch.bfloat16), flush=flush)
                row["plain_ms"] = time_ms(torch, lambda: w4a8_sparse_matmul_plain(
                    x, packed, meta, sw, corr, torch.bfloat16), flush=flush)
                row["library_ms"] = row["semi_structured_ms"] = None
                if k % 8 == 0 and n % 8 == 0:
                    mp = max(m, 32)  # _int_mm needs M > 16
                    xs = torch.zeros((mp, k), dtype=torch.int8, device=dev)
                    xs[:m] = (x.to(torch.int16) - 128).to(torch.int8)
                    w8 = q.to(torch.int8).contiguous()
                    exact = x.to(torch.float64) @ q.to(torch.float64)
                    acc = torch._int_mm(xs, w8)[:m] + 128 * col_sums
                    check(torch.equal(acc.to(torch.float64), exact),
                          "the _int_mm yardstick disagrees with the exact product")
                    row["library_ms"] = time_ms(torch, lambda: torch._int_mm(xs, w8),
                                                flush=flush)
                    call, why = semi_structured_yardstick(
                        torch, w8, xs, lambda p: torch.equal(
                            (p[:m].to(torch.int64) + 128 * col_sums).to(torch.float64), exact))
                    row["semi_structured_ms"] = (f"n/a: {why}" if call is None
                                                 else time_ms(torch, call, flush=flush))
                    row["semi_structured_call"] = why
        row["bound_ms"], row["bound_by"] = sparse_bound_ms(m, k, n)
        b4_rows.append(row)
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        ss = row["semi_structured_ms"]
        ss = ss if ss is None or isinstance(ss, str) else (
            f"{ss:.5f} ms ({row['semi_structured_call']})")
        print(f"[b4] M={m:4d} K={k:5d} N={n:5d} bit-equal to plain and B1 (u8,s8) "
              f"kernel {row['ms']:.5f} ms  B1 {row['b1_ms']:.5f} ms  plain "
              f"{row['plain_ms']:.5f} ms  _int_mm {lib} ms  semi-structured {ss}  bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")

    # the P_I check over the certified tiles of the expanded codes, on an
    # l1-budgeted 2:4 weight
    k, n = 960, 960
    q = torch.randint(-7, 8, (k, n), generator=gen, device=dev)
    q = q * mask_2to4(q.float()).to(q.dtype)
    tiles = q.reshape(k // 64, 64, n)
    q = (tiles * (torch.cumsum(tiles.abs(), dim=1) <= 128)).reshape(k, n)
    check(is_2to4(q), "the budgeted weight lost its 2:4 pattern")
    packed, meta = compress_2to4(q)
    x = torch.randint(0, 256, (256, k), generator=gen, device=dev).to(torch.uint8)
    y = w4a8_sparse_matmul(x, packed, meta, torch.ones(n, device=dev), 0.01, 131.0,
                           col_sums=q.sum(0).to(torch.int32), block_k=128, p_inner=16,
                           assert_inner=True, out_dtype=torch.bfloat16)
    watermark = check_inner(x, packed, 128, 16, meta=meta)
    check(bool(torch.isfinite(y.float()).all()), "non-finite B4 output")
    full = torch.full((k, n), -8, device=dev)
    fp, fm = compress_2to4(full * mask_2to4(full.float()).to(full.dtype))
    raised = False
    try:
        check_inner(x, fp, 128, 15, meta=fm)
    except OverflowError:
        raised = True
    check(raised, "an unbudgeted 2:4 weight passed the P_I=15 check")
    print(f"[b4] assert_inner: an l1-budgeted 2:4 weight passes P_I=16 (watermark {watermark} "
          f"<= {2 ** 15 - 1}); an unbudgeted one raises at P_I=15")

    # B5 with a mask at one layer's shapes, split mode
    by_shape = {(r["K"], r["C"]): r for r in gpfq_rows
                if (r["mode"], r["rounding"]) == ("split", "nearest")}
    b5_rows, b5_err = [], 0.0
    for k, c in SHAPES_KN:
        args, act, order, axe = gpfq_case_inputs(torch, k, c, "split", "nearest", gen)
        inv = torch.argsort(order)
        mask = mask_2to4(args[0][inv])[order].to(torch.uint8).contiguous()
        kw = dict(qmax=7.0, mode="split", rounding="nearest")
        q, u, pos, neg = gpfq_solve_kernel(*args, **kw, mask=mask)
        pq, _, _, _, v = gpfq_solve_plain(*args, **kw, mask=mask, return_v=True)
        torch.cuda.synchronize()
        ok, share, cut = tie_limited_agreement(pq, q, v, "nearest", 1e-3)
        check(ok, f"masked gpfq_solve K={k} C={c}: codes differ before the first tie "
                  f"(share equal {share:.5f})")
        b5_err = max(b5_err, (q - pq).abs().max().item())
        check(not q[mask == 0].any(), f"masked gpfq_solve K={k} C={c}: a pruned code is "
                                      f"nonzero")
        check(u_consistent(torch, args, q, u),
              f"masked gpfq_solve K={k} C={c}: U is not Xg^T W - Xh^T Q of its own codes")
        tid, n_tiles = args[6], args[5].shape[0]
        sums_p = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(), q.clamp(min=0))
        sums_n = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(), q.clamp(max=0))
        check(torch.equal(sums_p, pos) and torch.equal(sums_n, neg),
              f"masked gpfq_solve K={k} C={c}: pos/neg are not the tile sums of its codes")
        rep = certify(q[inv], act, 16, 128, sparsity="2:4")
        check(bool(rep), f"masked gpfq_solve K={k} C={c}: sparse certificate fails: {rep}")
        ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw, mask=mask), reps=5,
                     flush=flush)
        dense_ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw), reps=5, flush=flush)
        plain_ms = wall_ms(torch, lambda: gpfq_solve_plain(*args, **kw, mask=mask), reps=2)
        bms, by = gpfq_bound_ms(k, k, c)
        bms += 1e3 * k * c / HBM_BYTES_PER_S  # the mask's bytes (never the binding term)
        b5_rows.append({"K": k, "C": c, "share_equal": share, "channels_cut_by_tie": cut,
                        "headroom_bits": rep.headroom_bits, "ms": ms, "unmasked_ms": dense_ms,
                        "phase4_ms": by_shape[(k, c)]["ms"], "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "library_ms": None})
        print(f"[b5-mask] K={k:5d} C={c:5d} split nearest: tie-limited agreement ok, "
              f"{share:.5f} of codes equal ({cut} channels cut by a tie), zeros where the mask "
              f"is 0, pos/neg exact, sparse certificate headroom {rep.headroom_bits:.4f} bits; "
              f"masked {ms:.4f} ms  unmasked {dense_ms:.4f} ms (phase 4 "
              f"{by_shape[(k, c)]['ms']:.4f} ms)  plain {plain_ms:.1f} ms  bound {bms:.4f} ms "
              f"({by})")

    # B6 through ops.norm_and_quantize, its entry point: the counts of one
    # driven run, then the kernel against its plain version
    shapes = [(256, 960), (512, 1024), (1024, 4096)]
    inputs = {}
    for m, d in shapes:
        x = torch.randn((m, d), generator=gen, device=dev) * 2
        g = torch.randn((d,), generator=gen, device=dev) * 0.1 + 1.0
        inputs[(m, d)] = (x, g)
    torch.cuda.synchronize()
    reset_counts()
    for x, g in inputs.values():
        norm_and_quantize(x, g, 0.02, 128, block_m=256)
    torch.cuda.synchronize()
    b6_launches = read_counts()["quant_rmsnorm"]
    check(b6_launches == len(shapes), f"{b6_launches} quant_rmsnorm launches through "
                                      f"norm_and_quantize, expected {len(shapes)}")
    b6_rows, b6_err = [], 0
    for (m, d), (x, g) in inputs.items():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype).contiguous()
            qp = B6.quantizer_pair(0.02, 128, dev)
            kw = dict(eps=1e-6, qmax=255.0)
            y = B6.quant_rmsnorm_kernel(xd, g, qp, **kw)
            r = B6.quant_rmsnorm_plain(xd, g, qp, **kw)
            torch.cuda.synchronize()
            diff = (y.to(torch.int32) - r.to(torch.int32)).abs()
            off = float((diff > 0).float().mean())
            b6_err = max(b6_err, int(diff.max()))
            check(int(diff.max()) <= 1 and off < 0.01,
                  f"B6 != plain at ({m}, {d}) {dtype}: max {int(diff.max())} code(s), "
                  f"{off:.4f} of elements off")
            bms, by = rmsnorm_bound_ms(m, d, xd.element_size())
            row = {"M": m, "D": d, "dtype": str(dtype).split(".")[-1], "codes_off": off,
                   "ms": time_ms(torch, lambda: B6.quant_rmsnorm_kernel(xd, g, qp, **kw),
                                 flush=flush),
                   "plain_ms": time_ms(torch, lambda: B6.quant_rmsnorm_plain(xd, g, qp, **kw),
                                       flush=flush),
                   "rms_norm_ms": time_ms(torch, lambda: torch.nn.functional.rms_norm(
                       xd, (d,), g.to(dtype), 1e-6), flush=flush),
                   "library_ms": None, "bound_ms": bms, "bound_by": by}
            b6_rows.append(row)
            print(f"[b6] ({m}, {d}) {row['dtype']}: within one code of plain on {off:.5f} of "
                  f"elements; kernel {row['ms']:.5f} ms  plain {row['plain_ms']:.5f} ms  "
                  f"F.rms_norm alone {row['rms_norm_ms']:.5f} ms  bound {bms:.5f} ms ({by})")
    return {"b4": (b4_rows, b4_err), "b5": (b5_rows, b5_err),
            "b6": (b6_rows, b6_err, b6_launches)}


# ---------------------------------------------------------------------------
# Phase 9: the 2:4 slice on smollm-360m
# ---------------------------------------------------------------------------
def phase_sparse_slice(torch, dense_calib, paged):
    import tempfile
    from dataclasses import replace

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.axe import PTQConfig
    from repro_torch.core.overflow import min_feasible_p_bits
    from repro_torch.core.sparsity import is_2to4
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.quant.pipeline import calibrate_and_quantize
    from repro_torch.quant.serve_packed import (
        export_quantized_artifact,
        load_flat_artifact,
        pack_decode_params,
        packed_params_from_artifact,
        packed_weight_bytes,
    )
    from repro_torch.quant.spec import DatapathSpec
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )

    greedy = SamplerConfig(temperature=0.0)
    # (a) 2:4 calibration of the float32 copy, phase 5's batches
    cfg = replace(get_config("smollm-360m"), param_dtype="float32", act_dtype="float32")
    sites = 7 * cfg.n_layers
    model = T.init_model(cfg, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(sparsity="2:4"), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calib_counts = read_counts()
    check(calib_counts["gpfq_solve"] == sites and calib_counts["gpfq_solve_masked"] == sites,
          f"2:4 calibration launches {calib_counts}, expected {sites} masked gpfq_solve")
    check(calib_counts["w4a8_matmul"] == 0 and calib_counts["w4a8_sparse_matmul"] == 0,
          f"calibration launched a GEMM kernel: {calib_counts}")
    summary = qm.cert_summary()
    check(summary["ok"] and summary["n_certified"] == sites, f"certificates: {summary}")
    floors, fell = {}, 0
    for name, ql in qm.quantized_linears():
        check(ql.cert.sparsity == "2:4" and is_2to4(ql.q_int), f"{name} is not certified 2:4")
        floors[name] = min_feasible_p_bits(ql.cert)
        fell += floors[name] < dense_calib["floors"][name]
    print(f"[sparse-calib] smollm-360m full width in float32, GPFQ W4A8 P_I=16 T=128 "
          f"sparsity=2:4, {CALIB_BATCHES} x {CALIB_BATCH} x {CALIB_SEQ} tokens: "
          f"{calib_counts['gpfq_solve_masked']} masked gpfq_solve launches (= 7 x {cfg.n_layers}); "
          f"certified {summary['n_certified']} sites at sparsity=2:4, min headroom "
          f"{summary['min_headroom_bits']:.4f} bits at {summary['min_headroom_site']}; wall "
          f"{wall:.3f} s (dense, phase 5: {dense_calib['wall_s']:.3f} s)")
    print("[sparse-calib] min_feasible_p_bits per site, 2:4 / dense: " + ", ".join(
        f"{n.replace('layer', 'L')} {floors[n]}/{dense_calib['floors'][n]}" for n in floors))
    print(f"[sparse-calib] the register floor fell at {fell} of {sites} sites")

    # (b) the exported 2:4 artifact, saved, loaded and served through B4
    artifact, meta = export_quantized_artifact(qm)
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(artifact, os.path.join(tmp, "quantized"), meta)
        flat, meta2 = load_flat_artifact(os.path.join(tmp, "quantized"))
    served = packed_params_from_artifact(flat, model, cfg, meta=meta2)
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                      global_batch=BATCH, seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(served, cfg, greedy, device="cuda")
    engine.generate(prompts, MAX_NEW)  # warm-up
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    gen_s = time.perf_counter() - t0
    serve_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = sites * MAX_NEW
    check(serve_counts["w4a8_sparse_matmul"] == expected and serve_counts["w4a8_matmul"] == 0,
          f"serving the 2:4 artifact: launches {serve_counts}, expected {expected} B4 and 0 B1")
    ref_out = GenerationEngine(served, cfg, greedy, device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
    check((out == ref_out).all(), "kernel and reference backends disagree on the 2:4 artifact")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    step_ms = decode_step_ms(torch, served, prompts, out)
    fixed = {"gen_s": gen_s, "tok_s": BATCH * MAX_NEW / gen_s, "step_ms": step_ms,
             "peak_mib": peak / 2**20}
    print(f"[sparse-serve] artifact: {len(artifact)} leaves, {meta['datapath']}; served greedy "
          f"batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new (float32, static activation "
          f"quantizers): {serve_counts['w4a8_sparse_matmul']} B4 launches (= 7 x "
          f"{cfg.n_layers} x {MAX_NEW}), {serve_counts['w4a8_matmul']} B1; tokens identical to "
          f"the reference backend; {fixed['tok_s']:.1f} tok/s (wall {gen_s:.4f} s), decode "
          f"step {step_ms:.3f} ms (host clock), peak memory {fixed['peak_mib']:.1f} MiB; "
          f"dense artifact (phase 5): {dense_calib['serve']['tok_s']:.1f} tok/s, decode step "
          f"{dense_calib['serve']['step_ms']:.3f} ms, peak {dense_calib['serve']['peak_mib']:.1f}"
          f" MiB")
    del model, served, engine, qm
    torch.cuda.empty_cache()

    # (c) RTN 2:4 packing of the bf16 model, served through the paged
    # engine over phase 7's trace
    cfg = get_config("smollm-360m")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"), cfg,
                               DatapathSpec(sparsity="2:4"))
    eng = PagedEngine(model, cfg, PagedConfig(
        block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
        chunk_max=PAGED_CHUNK, attn_impl="auto"), greedy, device="cuda")
    specs, _ = trace_specs(cfg)
    reset_peak(torch)
    reset_counts()
    res, wall_t, spent = serve_timed(torch, eng, [Request(uid=u, prompt=p, max_new=n)
                                                  for u, p, n in specs])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    forwards = eng.decode_steps + eng.admits + eng.suffix_admits
    check(counts["w4a8_sparse_matmul"] == sites * forwards and counts["w4a8_matmul"] == 0,
          f"paged 2:4 trace: launches {counts} for {forwards} forwards")
    check(counts["paged_decode_attention"] == cfg.n_layers * eng.decode_steps,
          f"paged 2:4 trace: B2 launches {counts} for {eng.decode_steps} decode steps")
    for u, p, n in specs:
        check(res[u].size == p.size + n, f"2:4 trace: request {u} incomplete")
    pool = eng.pool_state
    check(pool.free_top == 0 and not pool.page_rc.any()
          and int(eng.cache["free_top"]) == 0 and not eng.cache["page_refcounts"].any(),
          "2:4 trace: pages not all back on the free list")
    n_new = sum(n for _, _, n in specs)
    dense_run = paged["runs"]["act"]
    trace = {"decode_steps": eng.decode_steps, "forwards": forwards,
             "launches": counts["w4a8_sparse_matmul"], "wall_s": wall_t,
             "tok_s": n_new / wall_t, "step_ms": 1e3 * spent["chunk"] / eng.decode_steps,
             "admit_ms": 1e3 * spent["admit"] / eng.admits, "peak_mib": peak / 2**20}
    print(f"[sparse-paged] RTN 2:4 bf16 through PagedEngine, {TRACE_REQUESTS} requests: "
          f"{counts['w4a8_sparse_matmul']} B4 launches = {sites} x {forwards} forwards, "
          f"{counts['w4a8_matmul']} B1; every page back on the free list; decode step "
          f"{trace['step_ms']:.3f} ms, admit {trace['admit_ms']:.3f} ms (host clock), "
          f"{trace['tok_s']:.1f} tok/s, wall {wall_t:.3f} s, peak memory "
          f"{trace['peak_mib']:.1f} MiB; dense (phase 7, float KV): decode step "
          f"{dense_run['step_ms']:.3f} ms, {dense_run['tok_s']:.1f} tok/s, peak "
          f"{dense_run['peak'] / 2**20:.1f} MiB")
    nbytes = {s: packed_weight_bytes(cfg, sparsity=s) for s in (None, "2:4")}
    print(f"[sparse-paged] packed_weight_bytes dense vs 2:4: codes "
          f"{nbytes[None]['packed_code_bytes']} vs {nbytes['2:4']['packed_code_bytes']} + meta "
          f"{nbytes['2:4']['meta_bytes']}; total {nbytes[None]['packed_bytes']} vs "
          f"{nbytes['2:4']['packed_bytes']} bytes")
    return {"calib_launches": calib_counts["gpfq_solve_masked"], "calib_wall_s": wall,
            "floors_fell": fell, "fixed": fixed, "serve_launches":
            serve_counts["w4a8_sparse_matmul"], "trace": trace, "bytes": nbytes}


def paged_record(name, rows, err, launches, source_line) -> dict:
    """One record for a paged-attention kernel: times at smollm-360m decode,
    4 slots x 80 tokens (the slice's lengths); the other timed shapes beside."""
    main = rows[0]
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": f"src/repro/kernels/paged_attention.py:{source_line}",
        "launches": launches,
        "max_abs_err": err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "timed_as": f"one call at smollm-360m decode: {main['slots']} slots x {main['tokens']} "
                    f"tokens in a {main['table_cols']}-page table ({main['splits']} splits), "
                    f"nh 15 / nkv 5, hd 64, bs 64, bf16 q, cold L2; the library call is "
                    f"scaled_dot_product_attention on K/V gathered beforehand; every timed "
                    f"shape in shapes",
        "shapes": rows,
    }


def gpfq_record(rows, max_err, launches, masked_rows, masked_err, masked_launches):
    """One record for gpfq_solve: times summed over the 7 site shapes of one
    smollm-360m layer (split budgets, round-to-nearest); per-case rows beside;
    the masked solve of the 2:4 slice (phases 8, 9) as its own sub-record."""
    by_shape = {(r["K"], r["C"]): r for r in rows
                if (r["mode"], r["rounding"]) == ("split", "nearest")}
    layer = [by_shape[kn] for kn in LAYER_SITES]
    masked_by = {(r["K"], r["C"]): r for r in masked_rows}
    masked = [masked_by[kn] for kn in LAYER_SITES]
    return {
        "name": "gpfq_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gpfq_solve.cu",
        "replaces": "src/repro/kernels/gpfq_solve.py:33",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in layer)
        else "bytes",
        "library_ms": None,
        "timed_as": "sum over the 7 sites of one smollm-360m layer, K x C as calibration "
                    "solves them; no single PyTorch call computes this solve",
        "shapes": rows,
        "masked": {
            "launches": masked_launches,
            "max_abs_err": masked_err,
            "ms": sum(r["ms"] for r in masked),
            "unmasked_ms": sum(r["unmasked_ms"] for r in masked),
            "plain_ms": sum(r["plain_ms"] for r in masked),
            "bound_ms": sum(r["bound_ms"] for r in masked),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in masked)
            else "bytes",
            "library_ms": None,
            "timed_as": "the 2:4 solve with its (K, C) uint8 mask, summed over one layer's "
                        "7 sites; unmasked_ms times the same inputs without the mask",
            "shapes": masked_rows,
        },
    }


def sparse_kernel_record(rows, max_err, launches):
    """One record for w4a8_sparse_matmul (B4): times summed over the 7 site
    shapes of one layer at decode (M = 4), B1's times on the expanded codes
    beside; per-shape rows beside."""
    by_shape = {(r["K"], r["N"]): r for r in rows if r["M"] == BATCH}
    layer = [by_shape[kn] for kn in LAYER_SITES]
    return {
        "name": "w4a8_sparse_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w4a8_mm.cu",
        "replaces": "src/repro/kernels/w4a8_mm.py:311",
        "pallas_call": "src/repro/kernels/w4a8_mm.py:410",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer) else "operations",
        "library_ms": sum(r["library_ms"] for r in layer),
        "b1_ms": sum(r["b1_ms"] for r in layer),
        "timed_as": "sum over the 7 packed 2:4 sites of one layer at decode, M=4, cold L2; "
                    "the library call is torch._int_mm on the expanded int8 codes; b1_ms is "
                    "the dense kernel on the same codes",
        "shapes": rows,
    }


def rmsnorm_record(rows, max_err, launches):
    """One record for quant_rmsnorm (B6): the (256, 960) float32 call (one
    smollm-360m prefill of 4 x 64 tokens); every shape and type beside."""
    main = rows[0]
    return {
        "name": "quant_rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_rmsnorm.cu",
        "replaces": "src/repro/kernels/quant_rmsnorm.py:22",
        "pallas_call": "src/repro/kernels/quant_rmsnorm.py:51",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "rms_norm_ms": main["rms_norm_ms"],
        "timed_as": f"one call at ({main['M']}, {main['D']}) {main['dtype']}, cold L2, through "
                    f"ops.norm_and_quantize's kernel; no single PyTorch call computes it "
                    f"(rms_norm_ms: F.rms_norm alone, for scale); launches: one run of "
                    f"norm_and_quantize at the 3 shapes, the only entry point that reaches it",
        "shapes": rows,
    }


def kernel_record(rows, max_err, launches):
    """One record for w4a8_matmul: times summed over the 7 site shapes of
    one layer at decode (M = batch = 4), the main path's most frequent
    call (15 of 16 forwards); per-shape rows beside."""
    by_shape = {(r["K"], r["N"]): r for r in rows if r["M"] == BATCH}
    layer = [by_shape[kn] for kn in LAYER_SITES]
    return {
        "name": "w4a8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w4a8_mm.cu",
        "replaces": "src/repro/kernels/w4a8_mm.py:140",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer) else "operations",
        "library_ms": sum(r["library_ms"] for r in layer),
        "timed_as": "sum over the 7 packed sites of one layer at decode, M=4, cold L2",
        "shapes": rows,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__} — run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    phase_card(torch)
    rows, max_err = phase_kernel(torch)
    launches = phase_slice(torch)
    gpfq_rows, gpfq_err = phase_gpfq(torch)
    calib = phase_calibration(torch)
    paged_rows, paged_err = phase_paged_kernels(torch)
    paged = phase_paged_slice(torch)
    sparse_k = phase_sparse_kernels(torch, gpfq_rows)
    sparse = phase_sparse_slice(torch, calib, paged)
    print(json.dumps({"kernels": [
        kernel_record(rows, max_err, launches),
        paged_record("paged_decode_attention", paged_rows["float"], paged_err["float"],
                     paged["runs"]["act"]["counts"]["paged_decode_attention"], 189),
        paged_record("paged_decode_attention_int8", paged_rows["int8"], paged_err["int8"],
                     paged["runs"]["int8"]["counts"]["paged_decode_attention_int8"], 226),
        sparse_kernel_record(*sparse_k["b4"], sparse["serve_launches"]),
        gpfq_record(gpfq_rows, gpfq_err, calib["launches"], *sparse_k["b5"],
                    sparse["calib_launches"]),
        rmsnorm_record(*sparse_k["b6"])]}))
    # one card: every phase runs on cuda:0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
