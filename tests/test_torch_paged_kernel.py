"""The paged decode-attention kernels (``csrc/paged_attention.cu``: B2 for
float pages, B3 for int8 pages) against their plain versions,
``paged_attention_plain`` and ``paged_attention_int8_plain``. This file
imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_kernel.py

Tests marked ``cuda`` skip without a card (the kernels have no CPU
interpret mode). Tolerances: B2 in f32 within 1e-5 (the kernel reduces in
another order), in bf16 within one bf16 ulp of the output or 1e-5 (an
output near 0 moves by more than its bf16 ulp when f32 sums are taken in
another order). B3 within 5e-2 everywhere (the JAX sweep's bound: one
probability code that rounds the other way moves an output by about
|v|max / 255), and within 1e-4 (f32) or the bf16 bound on every row where
no q code and no probability code lay within 1e-4 of a rounding boundary:
kernel and plain version form each score with the same f32 operations, so
only an exp of another implementation could move a code, by a few ulps;
the watermarks equal the plain version's exactly.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.quant.spec import AttnDatapathSpec

#: (B, nkv, g, hd, bs, P): the reference sweep's shapes, odd heads and dims
#: (hd 7 and 11), and smollm-360m's (nh 15, nkv 5, hd 64, bs 64)
SHAPES = [(1, 1, 1, 8, 4, 2), (3, 2, 2, 16, 8, 4), (4, 2, 1, 32, 16, 3), (2, 4, 4, 8, 8, 2),
          (4, 2, 2, 16, 128, 2), (3, 1, 3, 7, 8, 3), (2, 3, 1, 16, 8, 2), (3, 1, 5, 11, 16, 2),
          (6, 5, 3, 64, 64, 33)]
SMOLLM_LENS = [1, 63, 64, 65, 80, 2048]


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def random_case(rng, B, nkv, g, hd, bs, P, lens=None, extra_blocks=4):
    """Distinct pages per row, ragged lengths, sentinel (nb) tail entries;
    numpy arrays: q, k/v pages, table, lens."""
    nb = B * P + extra_blocks
    q = rng.normal(size=(B, nkv * g, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    tab = np.full((B, P), nb, np.int32)
    perm = rng.permutation(nb)
    if lens is None:
        lens = rng.integers(1, P * bs + 1, size=B)
    lens = np.asarray(lens, np.int32)
    o = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tab[b, :n] = perm[o:o + n]
        o += n
    return q, kp, vp, tab, lens


def to_dev(arrays, device, dtype=None):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        out.append(t.to(dtype) if dtype is not None and t.is_floating_point() else t)
    return out


def assert_bf16_ulp(a, b):
    """|a - b| within one bf16 ulp of the larger magnitude, or 1e-5."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(min=1e-5)
    assert bool(((a - b).abs() <= ulp).all()), float((a - b).abs().max())


def quantized(kp, vp):
    (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
    return kc, vc, ks, vs


def assert_int8_agrees(out, ref, ties):
    """B3 tolerance: 5e-2 everywhere; on the rows without a near-tie 1e-4
    in f32 and the bf16 bound in bf16."""
    diff = (out.float() - ref.float()).abs()
    assert float(diff.max()) <= 5e-2
    clean = ~ties
    assert bool(clean.any()), "every row is a near-tie: nothing held tightly"
    if out.dtype == torch.bfloat16:
        assert_bf16_ulp(out[clean], ref[clean])
    else:
        assert float(diff[clean].max()) <= 1e-4, float(diff[clean].max())


def shape_lens(rng, B, bs, P):
    if (bs, P) == (64, 33):
        return [SMOLLM_LENS[i % len(SMOLLM_LENS)] for i in range(B)]
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_float_kernel_matches_plain(cuda_device, shape, dtype):
    rng = np.random.default_rng(0)
    B, nkv, g, hd, bs, P = shape
    case = random_case(rng, *shape, lens=shape_lens(rng, B, bs, P))
    q, kp, vp, tab, lens = to_dev(case, cuda_device, dtype)
    for softcap in (None, 10.0):
        out = PA.paged_attention_kernel(q, kp, vp, tab, lens, softcap=softcap)
        ref = PA.paged_attention_plain(q, kp, vp, tab, lens, softcap=softcap)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        else:
            assert_bf16_ulp(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_kernel_matches_plain(cuda_device, shape, dtype):
    rng = np.random.default_rng(1)
    B, nkv, g, hd, bs, P = shape
    q, kp, vp, tab, lens = to_dev(random_case(rng, *shape, lens=shape_lens(rng, B, bs, P)),
                                  cuda_device)
    q = q.to(dtype)
    kc, vc, ks, vs = quantized(kp, vp)
    for softcap in (None, 10.0):
        wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        out = PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs, softcap=softcap,
                                             watermarks=wm)
        wm_ref = torch.zeros(2, dtype=torch.int32)
        ref, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs,
                                                  softcap=softcap, watermarks=wm_ref,
                                                  return_ties=True, tie_eps=1e-4)
        torch.cuda.synchronize()
        assert_int8_agrees(out, ref, ties)
        assert wm.cpu().tolist() == wm_ref.tolist()
        spec = AttnDatapathSpec.for_cache(hd, bs)
        qk, pv = PA.check_bounds(wm, spec)
        assert qk <= spec.qk_worst_abs() and pv <= spec.pv_worst_abs()


@pytest.mark.cuda
def test_int8_full_magnitude_reaches_the_worst_case(cuda_device):
    """All q and k codes 127 with one sign, all v codes 127, full pages:
    every score ties, every probability code is 255, and the watermarks
    reach qk_worst_abs and pv_worst_abs exactly, inside P_qk and P_pv."""
    for hd, bs in ((64, 64), (16, 8), (128, 128)):
        spec = AttnDatapathSpec.for_cache(hd, bs)
        B, nkv, g, P = 2, 5, 3, 3
        nb = B * P
        q = torch.full((B, nkv * g, hd), 0.75, device=cuda_device)
        codes = torch.full((nb, bs, nkv, hd), 127, dtype=torch.int8, device=cuda_device)
        scales = torch.full((nb, nkv), 0.01, device=cuda_device)
        tab = torch.arange(nb, dtype=torch.int32, device=cuda_device).reshape(B, P)
        lens = torch.tensor([P * bs, 2 * bs], dtype=torch.int32, device=cuda_device)
        out = PA.paged_decode_attention(q, codes, codes, tab, lens, k_scales=scales,
                                        v_scales=scales, attn_spec=spec, assert_bounds=True)
        wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        PA.paged_attention_int8_kernel(q, codes, codes, tab, lens, scales, scales,
                                       watermarks=wm)
        assert PA.check_bounds(wm, spec) == (spec.qk_worst_abs(), spec.pv_worst_abs())
        torch.testing.assert_close(out, torch.full_like(out, 1.27), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches(cuda_device):
    rng = np.random.default_rng(2)
    q, kp, vp, tab, lens = to_dev(random_case(rng, 2, 2, 2, 16, 8, 2), cuda_device)
    kc, vc, ks, vs = quantized(kp, vp)
    before = (PA.paged_decode_attention.launches, PA.paged_decode_attention.int8_launches)
    PA.paged_decode_attention(q, kp, vp, tab, lens)
    PA.paged_decode_attention(q, kc, vc, tab, lens, k_scales=ks, v_scales=vs)
    PA.paged_attention_plain(q, kp, vp, tab, lens)
    assert (PA.paged_decode_attention.launches - before[0],
            PA.paged_decode_attention.int8_launches - before[1]) == (1, 1)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the entry point runs the plain versions and launches
    nothing; the kernel entries refuse CPU tensors."""
    rng = np.random.default_rng(3)
    q, kp, vp, tab, lens = to_dev(random_case(rng, 3, 2, 2, 16, 8, 3), "cpu")
    kc, vc, ks, vs = quantized(kp, vp)
    before = (PA.paged_decode_attention.launches, PA.paged_decode_attention.int8_launches)
    out = PA.paged_decode_attention(q, kp, vp, tab, lens, softcap=5.0)
    torch.testing.assert_close(out, PA.paged_attention_plain(q, kp, vp, tab, lens, softcap=5.0),
                               rtol=0, atol=0)
    out8 = PA.paged_decode_attention(q, kc, vc, tab, lens, k_scales=ks, v_scales=vs)
    torch.testing.assert_close(out8, PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs),
                               rtol=0, atol=0)
    assert (PA.paged_decode_attention.launches,
            PA.paged_decode_attention.int8_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.paged_attention_kernel(q, kp, vp, tab, lens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs)


def test_plain_int8_walks_only_the_needed_pages():
    """Pages past a row's length are no-ops of the recurrence: a table whose
    tail entries point at pages full of extreme codes gives the same output
    and watermarks as one whose tail holds sentinels."""
    rng = np.random.default_rng(4)
    B, nkv, g, hd, bs, P = 3, 1, 3, 7, 8, 4
    q, kp, vp, tab, lens = to_dev(random_case(rng, B, nkv, g, hd, bs, P, lens=[5, 9, 17]),
                                  "cpu")
    kc, vc, ks, vs = quantized(kp, vp)
    nb = kc.shape[0]
    spare = min(set(range(nb)) - set(tab.flatten().tolist()))
    wm_a, wm_b = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    a = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs, watermarks=wm_a)
    tab_b = torch.where(tab == nb, spare, tab).to(torch.int32)
    kc[spare], vc[spare] = 127, -127
    b = PA.paged_attention_int8_plain(q, kc, vc, tab_b, lens, ks, vs, watermarks=wm_b)
    assert torch.equal(a, b)
    assert wm_a[0] == wm_b[0]


def test_attn_spec_checks_on_the_entry_point():
    from repro_torch.quant.spec import DatapathMismatchError

    rng = np.random.default_rng(5)
    q, kp, vp, tab, lens = to_dev(random_case(rng, 2, 2, 2, 16, 8, 2), "cpu")
    kc, vc, ks, vs = quantized(kp, vp)
    good, bad = AttnDatapathSpec.for_cache(16, 8), AttnDatapathSpec.for_cache(16, 16)
    PA.paged_decode_attention(q, kc, vc, tab, lens, k_scales=ks, v_scales=vs, attn_spec=good)
    with pytest.raises(DatapathMismatchError, match="attention datapath"):
        PA.paged_decode_attention(q, kc, vc, tab, lens, k_scales=ks, v_scales=vs,
                                  attn_spec=bad)
    with pytest.raises(DatapathMismatchError, match="float KV"):
        PA.paged_decode_attention(q, kp, vp, tab, lens, attn_spec=good)
    assert math.isfinite(float(PA.paged_decode_attention(q, kp, vp, tab, lens).sum()))
