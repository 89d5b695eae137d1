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


# ---------------------------------------------------------------------------
# The split of each row's pages over blocks
# ---------------------------------------------------------------------------
#: smollm-360m decode in PagedEngine's 512-page table: rows beside each other
#: across split boundaries; "boundaries" takes k * S pages * bs +- 1 tokens
#: for the card's split count S (one page per split, then a second one)
SPLIT_CASES = {"1-beside-2048": (1, 2048), "idle-slots": (0, 80, 0, 2048),
               "boundaries": None}


def split_case(device, name, seed):
    rng = np.random.default_rng(seed)
    lens = SPLIT_CASES[name]
    if lens is None:
        S = PA.split_plan(4, 5, 512, PA._sm_count(device.index))
        lens = (S * 64 - 1, S * 64 + 1, 2 * S * 64 - 1, 2 * S * 64 + 1)
    B = len(lens)
    P = max(-(-n // 64) for n in lens)
    q, kp, vp, tab, lens = random_case(rng, B, 5, 3, 64, 64, P, lens=lens)
    wide = np.full((B, 512), kp.shape[0], np.int32)
    wide[:, :P] = np.where(tab < kp.shape[0], tab, kp.shape[0])
    return to_dev((q, kp, vp, wide, lens), device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_float_kernel_across_split_boundaries(cuda_device, name, dtype):
    q, kp, vp, tab, lens = split_case(cuda_device, name, 6)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    out = PA.paged_attention_kernel(q, kp, vp, tab, lens)
    ref = PA.paged_attention_plain(q, kp, vp, tab, lens)
    torch.cuda.synchronize()
    live = lens > 0  # the plain softmax of an idle row is NaN; the kernel gives 0
    assert not out[~live].any()
    if dtype == torch.float32:
        torch.testing.assert_close(out[live], ref[live], rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_ulp(out[live], ref[live])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_int8_kernel_across_split_boundaries(cuda_device, name, dtype):
    q, kp, vp, tab, lens = split_case(cuda_device, name, 7)
    q = q.to(dtype)
    kc, vc, ks, vs = quantized(kp, vp)
    wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    out = PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs, watermarks=wm)
    wm_ref = torch.zeros(2, dtype=torch.int32)
    ref, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs, watermarks=wm_ref,
                                              return_ties=True, tie_eps=1e-4)
    torch.cuda.synchronize()
    assert not out[lens == 0].any()
    assert_int8_agrees(out, ref, ties)
    assert wm.cpu().tolist() == wm_ref.tolist()


@pytest.mark.cuda
def test_kernels_do_not_synchronize(cuda_device):
    """The wrapper reads no length on the host: a call under the sync debug
    mode "error" raises nothing."""
    q, kp, vp, tab, lens = split_case(cuda_device, "1-beside-2048", 8)
    kc, vc, ks, vs = quantized(kp, vp)
    wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        PA.paged_decode_attention(q, kp, vp, tab, lens)
        PA.paged_decode_attention(q, kc, vc, tab, lens, k_scales=ks, v_scales=vs, watermarks=wm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels_leave_their_counters_clean_across_shapes(cuda_device):
    """Calls of other shapes in turn (batch, kv heads, table width, so other
    split counts) keep agreeing with the plain versions: each call leaves
    its per-(slot, kv head) counters and B3's flags at 0."""
    rng = np.random.default_rng(10)
    for shape, lens in [((4, 5, 3, 64, 64, 33), [80, 2048, 1, 700]),
                        ((1, 2, 2, 16, 8, 9), [70]), ((3, 1, 3, 7, 8, 3), [19, 4, 3]),
                        ((4, 5, 3, 64, 64, 33), [2048, 5, 640, 0])] * 2:
        q, kp, vp, tab, lens = to_dev(random_case(rng, *shape, lens=lens), cuda_device)
        kc, vc, ks, vs = quantized(kp, vp)
        live = lens > 0
        out = PA.paged_attention_kernel(q, kp, vp, tab, lens)
        ref = PA.paged_attention_plain(q, kp, vp, tab, lens)
        out8 = PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs)
        ref8, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs,
                                                   return_ties=True, tie_eps=1e-4)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[live], ref[live], rtol=1e-5, atol=1e-5)
        assert_int8_agrees(out8, ref8, ties)
        for buffers in PA._SYNC.values():
            assert not buffers.counters.any() and not buffers.flags.any()


@pytest.mark.cuda
def test_kernels_replay_in_a_cuda_graph(cuda_device):
    """A B2 and a B3 call captured in one CUDA graph and replayed on new
    inputs in place agree with the plain versions at every replay: no
    launch depends on a value from the host (B3's flags are reset on the
    device, not told apart by a host counter)."""
    rng = np.random.default_rng(12)
    shape, lens = (4, 5, 3, 64, 64, 33), [80, 2048, 1, 700]
    q, kp, vp, tab, lens = to_dev(random_case(rng, *shape, lens=lens), cuda_device)
    kc, vc, ks, vs = quantized(kp, vp)
    wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up: build, buffers, shared-memory opt-in
        PA.paged_attention_kernel(q, kp, vp, tab, lens)
        PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs, watermarks=wm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_attention_kernel(q, kp, vp, tab, lens)
        out8 = PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs, watermarks=wm)
    for _ in range(3):
        q.copy_(torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)))
        wm.zero_()
        graph.replay()
        ref = PA.paged_attention_plain(q, kp, vp, tab, lens)
        wm_ref = torch.zeros(2, dtype=torch.int32)
        ref8, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs,
                                                   watermarks=wm_ref, return_ties=True,
                                                   tie_eps=1e-4)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        assert_int8_agrees(out8, ref8, ties)
        assert wm.cpu().tolist() == wm_ref.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one-split", "wide-table"])
def test_kernels_walk_many_chunks(cuda_device, monkeypatch, case):
    """Rows longer than one chunk of their split: one split per row (the
    plan forced to S = 1), so a block walks its pages chunk after chunk; and
    rows past the 512 table columns a block reads ahead (bs 8, 4200 tokens
    in a 600-column table)."""
    rng = np.random.default_rng(11)
    if case == "one-split":
        monkeypatch.setattr(PA, "BLOCKS_PER_SM", 0)
        shape, lens = (2, 5, 3, 64, 64, 33), [2048, 700]
    else:
        shape, lens = (2, 1, 2, 16, 8, 600), [4200, 9]
    q, kp, vp, tab, lens = to_dev(random_case(rng, *shape, lens=lens), cuda_device)
    kc, vc, ks, vs = quantized(kp, vp)
    out = PA.paged_attention_kernel(q, kp, vp, tab, lens)
    ref = PA.paged_attention_plain(q, kp, vp, tab, lens)
    wm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    out8 = PA.paged_attention_int8_kernel(q, kc, vc, tab, lens, ks, vs, watermarks=wm)
    wm_ref = torch.zeros(2, dtype=torch.int32)
    ref8, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs, watermarks=wm_ref,
                                               return_ties=True, tie_eps=1e-4)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert_int8_agrees(out8, ref8, ties)
    assert wm.cpu().tolist() == wm_ref.tolist()


@pytest.mark.parametrize("shape, splits", [
    ((4, 5, 512, 132), 19), ((4, 5, 32, 132), 19),  # 4 x 2048 of smollm-360m: 32 pages
    ((1, 5, 512, 132), 79), ((16, 5, 512, 132), 4), ((64, 5, 512, 132), 1),
    ((4, 5, 2, 132), 2), ((1, 1, 1, 132), 1),       # capped by the table's width
    ((100, 5, 512, 132), 1), ((4, 5, 512, 1), 1)])  # more rows than 3 blocks an SM
def test_split_plan_is_a_function_of_shapes(shape, splits):
    """The split count on an H100 (132 SMs) and beside it: three blocks an
    SM over batch * nkv rows, at least 1 and never wider than the table; 4
    slots x 2048 tokens of smollm-360m split alike inside PagedEngine's
    512-page table and inside a table just as wide as its 32 pages."""
    assert PA.BLOCKS_PER_SM == 3
    assert PA.split_plan(*shape) == splits


def split_int8_model(q, kc, vc, tab, lens, ks, vs, n_splits, softcap=None, local_max=False):
    """The kernels' B3 split algebra in plain PyTorch, row by row: split s
    takes pages [s * per, (s + 1) * per) of the row's ceil(len / bs), per =
    ceil(n / S); pass 1 finds each split's maximum of the finished scores;
    pass 2 runs the recurrence over the split's pages from the maximum of
    the splits before it (``local_max`` starts every split from -inf
    instead, the naive split); the combine rescales each split by
    exp(m_s - M). Returns the output, the probability codes by (row, page)
    and the watermarks."""
    B, nh, hd = q.shape
    nb, bs, nkv, _ = kc.shape
    spec = AttnDatapathSpec.for_cache(hd, bs)
    qc, qs, _ = PA.int8_q_codes(q, spec, nkv)
    page_tab = torch.clamp(tab.long(), max=nb - 1)
    out, codes, wm = torch.zeros(B, nh, hd), {}, [0, 0]
    for b in range(B):
        n = min(tab.shape[1], -(-int(lens[b]) // bs))
        per = -(-n // n_splits) if n else 0
        splits = [range(min(n, s * per), min(n, (s + 1) * per)) for s in range(n_splits)]

        def scores(j, b=b):
            valid = (j * bs + torch.arange(bs))[None, :] < lens[b:b + 1].long()[:, None]
            s_int, s = PA.int8_page_scores(qc[b:b + 1], qs[b:b + 1], kc, ks, page_tab[b:b + 1, j],
                                           valid, softcap)
            return s_int, s, valid

        split_max = []
        for pages in splits:  # pass 1
            m = torch.full((1, nkv, nh // nkv), -math.inf)
            for j in pages:
                s_int, s, valid = scores(j)
                wm[0] = max(wm[0], int(torch.where(valid[:, None, None, :], s_int.abs(), 0).max()))
                m = torch.maximum(m, torch.amax(s, dim=-1))
            split_max.append(m)
        parts = []
        for i, pages in enumerate(splits):  # pass 2
            m = torch.full((1, nkv, nh // nkv), -math.inf)
            if not local_max:
                for prev in split_max[:i]:
                    m = torch.maximum(m, prev)
            l, acc = torch.zeros_like(m), torch.zeros(1, nkv, nh // nkv, hd)
            for j in pages:
                _, s, _ = scores(j)
                m, _, p_codes, corr = PA.int8_page_step(s, m, spec.prob_qmax)
                codes[(b, j)] = p_codes[0]
                page = page_tab[b:b + 1, j]
                pv_int = torch.einsum("bkgs,bskd->bkgd", p_codes.double(), vc[page].double())
                wm[1] = max(wm[1], int(pv_int.abs().max()))
                pv = pv_int.float() * PA._div(vs[page], spec.prob_qmax)[:, :, None, None]
                l = l * corr + torch.sum(PA._div(p_codes, spec.prob_qmax), dim=-1)
                acc = acc * corr[..., None] + pv
            parts.append((m if pages else torch.full_like(m, -math.inf), l, acc))
        top = torch.full((1, nkv, nh // nkv), -math.inf)
        for m, _, _ in parts:
            top = torch.maximum(top, m)
        num, den = torch.zeros(1, nkv, nh // nkv, hd), torch.zeros_like(top)
        for m, l, acc in parts:
            w = torch.where(torch.isfinite(m), torch.exp(m - top), torch.zeros_like(m))
            num, den = num + acc * w[..., None], den + l * w
        out[b] = (num / torch.clamp(den[..., None], min=1e-20)).reshape(nh, hd)
    return out.to(q.dtype), codes, wm


@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
def test_int8_split_algebra_keeps_codes_and_watermarks(n_splits):
    """The split algebra that kernel B3 runs (prefix maximum of the earlier
    splits, the recurrence within a split, the combine) gives probability
    codes and watermarks identical to the unsplit plain version and outputs
    within 1e-5; a naive split from each split's own maximum changes codes."""
    rng = np.random.default_rng(9)
    q, kp, vp, tab, lens = to_dev(random_case(rng, 4, 2, 3, 16, 8, 12,
                                              lens=[0, 1, 41, 96]), "cpu")
    kp[:, :, :, :] *= torch.linspace(0.2, 3.0, kp.shape[0])[:, None, None, None]  # maxima move
    kc, vc, ks, vs = quantized(kp, vp)
    codes_ref, wm_ref = [], torch.zeros(2, dtype=torch.int32)
    ref = PA.paged_attention_int8_plain(q, kc, vc, tab, lens, ks, vs, watermarks=wm_ref,
                                        prob_codes=codes_ref)
    out, codes, wm = split_int8_model(q, kc, vc, tab, lens, ks, vs, n_splits)
    assert wm == wm_ref.tolist()
    assert codes and all(torch.equal(c, codes_ref[j][b]) for (b, j), c in codes.items())
    assert len(codes) == sum(-(-int(n) // 8) for n in lens)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    if n_splits > 1:
        _, naive, _ = split_int8_model(q, kc, vc, tab, lens, ks, vs, n_splits, local_max=True)
        assert any(not torch.equal(c, codes_ref[j][b]) for (b, j), c in naive.items())
