"""B1 and B4 over an expert axis (B1e, B4e) of ``csrc/w4a8_mm.cu``: their
plan, their plain versions and the kernels on the card. This file imports
no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_kernel.py

On the CPU: ``w4a8_plan`` with E experts gives each expert the row tiles
of one problem and counts all E's tiles when it splits K (granite's decode
sites need no split); the plain versions are E calls of B1's and B4's,
each expert with its own scales and activation quantizer, and the
per-expert dynamic quantizer equals the per-tensor one on each slice, an
all-zero expert taking the 1e-8 scale floor.

Tests marked ``cuda`` skip without a card (the kernels have no CPU
interpret mode). On the card B1e and B4e are bit-equal to their plain
versions and to E launches of B1/B4 on the slices, at E in {8, 40},
granite-moe-3b-a800m's expert shapes, unsigned and signed codes, a ragged
N and an expert with all-zero input, with one launch a call.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import mask_2to4
from repro_torch.kernels import w4a8_mm as W
from repro_torch.kernels.ops import quantize_activations

#: (K, N) of granite-moe-3b-a800m's expert sites: wg/wu (1536, 512), wd (512, 1536)
GRANITE_EXPERT_SITES = [(1536, 512), (512, 1536)]


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _operands(rng, e, m, k, n, signed, device="cpu", zero_expert=None):
    """Codes (E, M, K), dense and 2:4 int4 stacks, per-expert scales,
    col_sums and activation quantizers."""
    lo, hi = (-128, 128) if signed else (0, 256)
    x = rng.integers(lo, hi, size=(e, m, k)).astype(np.int8 if signed else np.uint8)
    if zero_expert is not None:
        x[zero_expert] = 0
    q = torch.from_numpy(rng.integers(-8, 8, size=(e, k, n)).astype(np.int8))
    qs = q * mask_2to4(q)
    packed, meta = W.compress_2to4(qs)

    def t(a):
        return (a if torch.is_tensor(a) else torch.from_numpy(np.array(a))).to(device)

    return {
        "x": t(x), "dense": t(W.pack_int4(q)), "packed": t(packed), "meta": t(meta),
        "sdense": t(W.pack_int4(qs)),
        "scale": t(rng.uniform(0.005, 0.02, size=(e, n)).astype(np.float32)),
        "col": t(q.sum(1).to(torch.int32)), "scol": t(qs.sum(1).to(torch.int32)),
        "act_scale": t(rng.uniform(0.01, 0.05, size=(e,)).astype(np.float32)),
        "act_zp": t((np.zeros(e) if signed else rng.integers(0, 256, size=e)).astype(
            np.float32)),
    }


def _calls(o, out_dtype, **kw):
    """B1e, B4e and B1e on the expanded 2:4 codes."""
    args = (o["scale"], o["col"], o["act_scale"], o["act_zp"])
    sargs = (o["scale"], o["scol"], o["act_scale"], o["act_zp"])
    return (W.w4a8_expert_matmul(o["x"], o["dense"], *args, out_dtype=out_dtype, **kw),
            W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sargs,
                                        out_dtype=out_dtype, **kw),
            W.w4a8_expert_matmul(o["x"], o["sdense"], *sargs, out_dtype=out_dtype, **kw))


def _per_expert_b1_b4(o, out_dtype, reference):
    """E calls of B1 and of B4 on the slices."""
    kw = dict(out_dtype=out_dtype, reference=reference)
    e = o["x"].shape[0]
    b1 = torch.stack([W.w4a8_decode_matmul(o["x"][i], o["dense"][i], o["scale"][i],
                                           o["col"][i], o["act_scale"][i], o["act_zp"][i],
                                           **kw) for i in range(e)])
    b4 = torch.stack([W.w4a8_sparse_decode_matmul(o["x"][i], o["packed"][i], o["meta"][i],
                                                  o["scale"][i], o["scol"][i],
                                                  o["act_scale"][i], o["act_zp"][i], **kw)
                      for i in range(e)])
    return b1, b4


# ---------------------------------------------------------------------------
# The plan and the plain versions (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("experts", [1, 3, 8, 40])
@pytest.mark.parametrize("m", [1, 4, 64, 65, 80])
def test_expert_plan_is_the_one_problem_plan_per_expert(experts, m):
    """The expert plan's grid rows are E times one problem's row tiles, its
    columns and load width are one problem's, and its K split counts the
    tiles of all E (so it never splits more than one problem's plan)."""
    for k, n in [*GRANITE_EXPERT_SITES, (960, 60)]:
        one = W.w4a8_plan(m, n, k)
        plan = W.w4a8_plan(m, n, k, experts=experts)
        assert plan.grid[0] == one.grid[0] and plan.vec == one.vec
        assert plan.grid[1] == experts * one.grid[1]
        assert plan.grid[2] <= one.grid[2] and plan.ck >= one.ck
        if experts == 1:
            assert plan == one
        assert plan.grid[2] <= W.MAX_CHUNKS and plan.ck % W.STAGE_K == 0


@pytest.mark.parametrize("k,n", GRANITE_EXPERT_SITES)
def test_expert_plan_fills_the_card_without_a_split_at_granite_decode(k, n):
    """At decode (M = 4) granite's 40 experts give 320 (wg, wu) or 960 (wd)
    tiles, more than two an SM: no K split and no cluster."""
    plan = W.w4a8_plan(4, n, k, experts=40)
    assert plan.grid == (n // W.TILE_N, 40, 1) and plan.ck >= k
    assert plan.blocks >= 2 * W.H100_SMS


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("e,m,k,n", [(3, 5, 64, 20), (4, 1, 128, 32), (2, 17, 256, 48)])
def test_expert_plain_is_e_calls_of_b1_and_b4(e, m, k, n, signed):
    rng = np.random.default_rng(e * 100 + m)
    o = _operands(rng, e, m, k, n, signed, zero_expert=0)
    for out in (torch.float32, torch.bfloat16):
        b1e, b4e, b1e_expanded = _calls(o, out)
        b1, b4 = _per_expert_b1_b4(o, out, reference=False)
        assert b1e.shape == (e, m, n) and b1e.dtype == out
        assert torch.equal(b1e, b1) and torch.equal(b4e, b4)
        assert torch.equal(b4e, b1e_expanded)


def test_expert_wrappers_check_their_arguments():
    o = _operands(np.random.default_rng(0), 2, 3, 64, 16, False)
    args = (o["scale"], o["col"], o["act_scale"], o["act_zp"])
    with pytest.raises(ValueError, match="E, M, K"):
        W.w4a8_expert_matmul(o["x"][0], o["dense"], *args)
    with pytest.raises(ValueError, match="does not match"):
        W.w4a8_expert_matmul(o["x"][:, :, :32], o["dense"], *args)
    with pytest.raises(ValueError, match="one entry an expert"):
        W.w4a8_expert_matmul(o["x"], o["dense"], o["scale"], o["col"], o["act_scale"][:1],
                             o["act_zp"])
    with pytest.raises(TypeError, match="uint8 or int8"):
        W.w4a8_expert_matmul(o["x"].to(torch.int32), o["dense"], *args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W._launch("w4a8_expert_matmul", o["x"], (o["dense"],), o["scale"], o["scale"],
                  torch.float32, 2)


def test_plain_versions_launch_nothing():
    o = _operands(np.random.default_rng(1), 2, 4, 64, 16, False)
    before = (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches,
              W.w4a8_matmul.launches, W.w4a8_sparse_matmul.launches)
    _calls(o, torch.float32)
    assert (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches,
            W.w4a8_matmul.launches, W.w4a8_sparse_matmul.launches) == before


def test_per_expert_quantizer_is_the_per_tensor_one_on_each_slice():
    """Each expert quantizes its own (M, K) slice, capacity rows of zeros
    included; an expert that got no token has scale 1e-8 and zero point 0,
    bit for bit what the per-tensor quantizer gives an all-zero input."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0.0, 1.0, size=(4, 6, 32)).astype(np.float32))
    x[1] = 0.0
    x[2, 3:] = 0.0  # capacity rows left at zero
    x[3] = x[3].abs() + 0.5  # all positive: lo clamps to 0
    codes, scale, zp = quantize_activations(x, per_expert=True)
    assert codes.shape == x.shape and scale.shape == zp.shape == (4,)
    for e in range(4):
        c1, s1, z1 = quantize_activations(x[e])
        assert torch.equal(codes[e], c1)
        assert torch.equal(scale[e], s1) and torch.equal(zp[e], z1)
    assert scale[1].item() == np.float32(1e-8) and zp[1].item() == 0.0
    assert not codes[1].any()


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------
def _check_on_card(o, out):
    before = (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches)
    b1e, b4e, b1e_expanded = _calls(o, out)
    torch.cuda.synchronize()
    assert (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches) == (
        before[0] + 2, before[1] + 1)
    p1e, p4e, _ = _calls(o, out, reference=True)
    b1, b4 = _per_expert_b1_b4(o, out, reference=False)
    torch.cuda.synchronize()
    assert torch.equal(b1e, p1e), "B1e != plain"
    assert torch.equal(b4e, p4e), "B4e != plain"
    assert torch.equal(b1e, b1), "B1e != E launches of B1"
    assert torch.equal(b4e, b4), "B4e != E launches of B4"
    assert torch.equal(b4e, b1e_expanded), "B4e != B1e on the expanded codes"


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k,n", GRANITE_EXPERT_SITES)
@pytest.mark.parametrize("m", [1, 4, 64, 80])
@pytest.mark.parametrize("e", [8, 40])
def test_cuda_expert_kernels_bit_equal_to_plain(e, m, k, n, signed, cuda_device):
    rng = np.random.default_rng(e + m + k)
    o = _operands(rng, e, m, k, n, signed, cuda_device, zero_expert=e // 2)
    for out in (torch.float32, torch.bfloat16):
        _check_on_card(o, out)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 70])
def test_cuda_expert_kernels_ragged(m, cuda_device):
    """A ragged N (4-byte loads) and ragged M."""
    o = _operands(np.random.default_rng(m), 5, m, 192, 60, False, cuda_device)
    assert W.w4a8_plan(m, 60, 192, experts=5).vec == 4
    _check_on_card(o, torch.bfloat16)
