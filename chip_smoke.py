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
   without AXE, and (8192, 64), whose U lives in global memory. Each case
   holds tie-limited agreement (codes equal in every channel up to the
   first row whose pre-rounding value lies within 1e-3 of a rounding
   boundary), pos/neg equal to the tile sums of the kernel's own codes
   exactly, and the certificate of the kernel's codes;
5. the calibration slice: smollm-360m at full width in float32 (the
   reference's solvers take float32 weights), ``calibrate_and_quantize``
   with the default ``PTQConfig`` on 4 x 4 x 128 tokens — exactly 224 B5
   launches (7 sites x 32 layers) and 224 certified sites; its wall time;
   a second, instrumented calibration for the breakdown of that time — then the
   exported v2 artifact, written with ``save_pytree`` and loaded back,
   served greedy (batch 4 x prompt 64 + 16 new, B1 with float32 output and
   the calibrated static activation quantizers): exactly 3584 B1 launches
   and tokens identical to the ``reference`` backend.

Before driving a path, every launch counter is set to 0, and the counts are
read just after it. Phase 3 ends with a ``torch.profiler`` breakdown of one
decode step (the device's busy share and the kernel's part of it). The line
before the last is a JSON object describing each kernel; the last line is
the device JSON ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ, EVAL_BATCHES = 4, 4, 128, 2


def reset_counts():
    """Set every kernel's launch counter to 0."""
    from repro_torch.kernels.gpfq_solve import gpfq_solve
    from repro_torch.kernels.w4a8_mm import w4a8_matmul

    w4a8_matmul.launches = 0
    gpfq_solve.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.gpfq_solve import gpfq_solve
    from repro_torch.kernels.w4a8_mm import w4a8_matmul

    return {"w4a8_matmul": w4a8_matmul.launches, "gpfq_solve": gpfq_solve.launches}


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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


def phase_gpfq(torch):
    from repro_torch.core.overflow import certify
    from repro_torch.kernels.gpfq_solve import (
        gpfq_solve_kernel,
        gpfq_solve_plain,
        panel_layout,
        tie_limited_agreement,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    layouts = {d: panel_layout(d) for d in (960, 2560, 8192)}
    check(layouts == {960: (32, False), 2560: (16, False), 8192: (32, True)},
          f"gpfq_solve panel layouts {layouts}")
    check(panel_layout(960, force_global_u=True) == (32, True), "forced global U layout")
    rows, max_err = [], 0.0
    for k, c, mode, rounding in GPFQ_CASES:
        args, act, order, axe = gpfq_case_inputs(torch, k, c, mode, rounding, gen)
        kw = dict(qmax=7.0, mode=mode, rounding=rounding)
        q, u, pos, neg = gpfq_solve_kernel(*args, **kw)
        pq, pu, ppos, pneg, v = gpfq_solve_plain(*args, **kw, return_v=True)
        torch.cuda.synchronize()
        ok, share, cut = tie_limited_agreement(pq, q, v, rounding, 1e-3)
        check(ok, f"gpfq_solve K={k} C={c} {mode}/{rounding}: codes differ before the first "
                  f"tie (share equal {share:.5f})")
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
        bc, global_u = panel_layout(k)
        ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw), reps=5, flush=flush)
        plain_ms = wall_ms(torch, lambda: gpfq_solve_plain(*args, **kw), reps=2)
        bms, by = gpfq_bound_ms(k, k, c)
        rows.append({"K": k, "C": c, "mode": mode, "rounding": rounding, "bc": bc,
                     "global_u": global_u, "share_equal": share, "channels_cut_by_tie": cut,
                     "headroom_bits": cert, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
        print(f"[gpfq] K={k:5d} C={c:5d} {mode:5s} {rounding:7s} bc={bc} "
              f"U in {'global' if global_u else 'shared'} memory: tie-limited agreement ok, "
              f"{share:.5f} of codes equal ({cut} channels cut by a tie), pos/neg exact, "
              f"headroom {cert if cert is None else round(cert, 4)} bits; kernel {ms:.4f} ms  "
              f"plain {plain_ms:.1f} ms  bound {bms:.4f} ms ({by})")
    return rows, max_err


def phase_calibration(torch):
    import tempfile
    from dataclasses import replace

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core import gpfq as G
    from repro_torch.core.axe import PTQConfig
    from repro_torch.core.calibration import ActObserver, LayerStats
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    print(f"[calib] artifact: {len(artifact)} leaves, {meta['datapath']}; served greedy batch "
          f"{BATCH} x prompt {PROMPT} + {MAX_NEW} new (float32, static activation "
          f"quantizers): {serve_counts['w4a8_matmul']} w4a8 launches, tokens identical to the "
          f"reference backend, {BATCH * MAX_NEW / gen_s:.1f} tok/s, peak memory "
          f"{peak / 2**20:.1f} MiB")
    return {"launches": counts["gpfq_solve"], "wall_s": wall, "instrumented_wall_s": wall_i,
            "b5_s": b5_s, **spent,
            "serve_launches": serve_counts["w4a8_matmul"]}


def gpfq_record(rows, max_err, launches):
    """One record for gpfq_solve: times summed over the 7 site shapes of one
    smollm-360m layer (split budgets, round-to-nearest); per-case rows beside."""
    by_shape = {(r["K"], r["C"]): r for r in rows
                if (r["mode"], r["rounding"]) == ("split", "nearest")}
    layer = [by_shape[kn] for kn in LAYER_SITES]
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
    print(json.dumps({"kernels": [kernel_record(rows, max_err, launches),
                                  gpfq_record(gpfq_rows, gpfq_err, calib["launches"])]}))
    # one card: every phase runs on cuda:0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
