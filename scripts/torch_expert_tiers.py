#!/usr/bin/env python3
"""Time the expert-axis W4A8 kernels B1e and B4e on the card, tier by tier:
the wrapper's plan (``w4a8_expert_plan``; B1e's again with a warm L2 and
with a clean cold one, flushed by a read, so that no dirty line of the
flush is written back during the launch), then, unless ``--no-variants``,
up to DECODE_MAX_M rows an expert the decode tier with its K split over
1-4 chunks and rings of 1 to DECODE_RING stages, and the tile tier
(``w4a8_plan`` over the experts' row tiles), on the same inputs, at
granite-moe-3b-a800m's expert sites (E = 40), beside one bf16
``torch.bmm`` on the dequantized stack and one copy of the packed stack
(each byte read once and written once). Cold L2 (flushed by a write),
CUDA events (the median of 30 launches, ``chip_smoke.time_ms``). Every
launch is first held bit-equal to the plain version.

    python3 scripts/torch_expert_tiers.py [--m 1,4,8,9,16,17,64,80] [--no-variants]

Needs one NVIDIA GPU; prints one line a (M, site, kernel) and exits 2
without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SITES = [(1536, 512), (512, 1536)]
E = 40


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_expert_tiers: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import expert_bound_ms, time_ms
    from repro_torch.core.sparsity import mask_2to4
    from repro_torch.kernels import _build
    from repro_torch.kernels import w4a8_mm as W

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", default="1,4,8,9,16,17,32,64,80")
    ap.add_argument("--no-variants", action="store_true",
                    help="time the wrapper's plan only")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[tiers] card: {smi}")
    logs = _build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "w4a8_expert_decode" in line or ("Used" in line and name == "w4a8_mm"):
                print(f"[tiers] ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    lib = W._library()
    n_sm = W._sm_count(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run(x, ws, sw, corr, out, plan):
        """One launch of ``plan``'s tier on the expert entry points."""
        e, m, k = x.shape
        n = ws[0].shape[-1]
        if plan.tier == "decode":
            err = lib.w4a8_expert_decode_launch(
                x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr() if len(ws) > 1 else None,
                sw.data_ptr(), corr.data_ptr(), out.data_ptr(), e, m, n, k, 0, 1, plan.vec,
                plan.ck, plan.ring, *plan.grid, stream())
        else:
            name = ("w4a8_sparse_expert_matmul_launch" if len(ws) > 1
                    else "w4a8_expert_matmul_launch")
            err = getattr(lib, name)(x.data_ptr(), *(w.data_ptr() for w in ws), sw.data_ptr(),
                                     corr.data_ptr(), out.data_ptr(), e, m, n, k, 0, 1, plan.vec,
                                     plan.ck, *plan.grid, stream())
        assert err == 0, err

    for m in (int(v) for v in args.m.split(",")):
        for k, n in SITES:
            q = torch.randint(-8, 8, (E, k, n), generator=gen, device=dev).to(torch.int8)
            qs = q * mask_2to4(q)
            wp, (sp, meta) = W.pack_int4(q), W.compress_2to4(qs)
            col, scol = q.sum(1).to(torch.int32), qs.sum(1).to(torch.int32)
            scale = torch.rand((E, n), generator=gen, device=dev) * 0.05 + 1e-3
            act_scale = torch.rand(E, generator=gen, device=dev) * 0.05 + 0.01
            zp = torch.randint(0, 256, (E,), generator=gen, device=dev).float()
            x = torch.randint(0, 256, (E, m, k), generator=gen, device=dev).to(torch.uint8)
            sw, corr = W._expert_epilogue(scale, col, act_scale, zp, E, n)
            _, scorr = W._expert_epilogue(scale, scol, act_scale, zp, E, n)
            ref = {False: W.w4a8_expert_matmul_plain(x, wp, sw, corr, torch.bfloat16),
                   True: W.w4a8_sparse_expert_matmul_plain(x, sp, meta, sw, scorr,
                                                           torch.bfloat16)}
            bound, _ = expert_bound_ms(E, m, k, n)
            w8 = W.unpack_int4(wp)
            xb = x.to(torch.bfloat16)
            wb = (w8.to(torch.bfloat16) * scale[:, None, :].to(torch.bfloat16)).contiguous()
            bmm = time_ms(torch, lambda: torch.bmm(xb, wb), flush=flush)
            row = f"M={m:3d} K={k:5d} N={n:5d}"
            copy = torch.empty_like(wp)
            copy_ms = time_ms(torch, lambda: copy.copy_(wp), flush=flush)
            print(f"[tiers] {row} one copy of the {wp.numel()} packed weight bytes "
                  f"{1e3 * copy_ms:.2f} us")
            for sparse in (False, True):
                ws, c = ((sp, meta), scorr) if sparse else ((wp,), corr)
                who = "B4e" if sparse else "B1e"
                plan = W.w4a8_expert_plan(m, n, k, E, True, n_sm)
                got, _ = W._launch("w4a8_sparse_expert_matmul" if sparse else
                                   "w4a8_expert_matmul", x, ws, sw, c, torch.bfloat16,
                                   4 if sparse else 2)
                assert torch.equal(got, ref[sparse]), f"{who} {row} != plain"
                ms = time_ms(torch, lambda: W._launch(
                    "w4a8_sparse_expert_matmul" if sparse else "w4a8_expert_matmul", x, ws,
                    sw, c, torch.bfloat16, 4 if sparse else 2), flush=flush)
                print(f"[tiers] {row} {who} wrapper ({plan.tier}, grid {plan.grid}, ck "
                      f"{plan.ck}, ring {plan.ring}) {1e3 * ms:.2f} us  bmm {1e3 * bmm:.2f} us  "
                      f"bound {1e3 * bound:.2f} us")
                if not sparse:
                    def b1e():
                        return W._launch("w4a8_expert_matmul", x, ws, sw, c, torch.bfloat16, 2)
                    warm = time_ms(torch, b1e)
                    clean = time_ms(torch, b1e, flush=flush, clean=True)
                    print(f"[tiers] {row} {who} wrapper, warm L2 (no flush): "
                          f"{1e3 * warm:.2f} us; clean cold L2 (flushed by a read): "
                          f"{1e3 * clean:.2f} us")
                if args.no_variants:
                    continue
                # the decode tier at other K splits and rings, then the tile tier
                variants = []
                if m <= W.DECODE_MAX_M:
                    steps = -(-k // W.DECODE_STAGE_K)
                    cols = -(-n // W.DECODE_COLS)
                    for chunks in (1, 2, 3, 4):
                        stages = -(-steps // chunks)
                        ck = W.DECODE_STAGE_K * stages
                        variants += [W.W4A8Plan(plan.vec, ck, (cols, E, -(-k // ck)), "decode",
                                                ring)
                                     for ring in range(1, min(W.DECODE_RING, stages) + 1)]
                variants.append(W.w4a8_plan(m, n, k, True, n_sm, E))
                for plan_t in dict.fromkeys(variants):
                    out = torch.empty((E, m, n), dtype=torch.bfloat16, device=dev)
                    run(x, ws, sw, c, out, plan_t)
                    torch.cuda.synchronize()
                    assert torch.equal(out, ref[sparse]), f"{who} {plan_t} {row} != plain"
                    ms_t = time_ms(torch, lambda: run(x, ws, sw, c, out, plan_t), flush=flush)
                    print(f"[tiers] {row} {who} {plan_t.tier} tier, grid {plan_t.grid}, ck "
                          f"{plan_t.ck}, ring {plan_t.ring}: {1e3 * ms_t:.2f} us")
    print("[tiers] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
