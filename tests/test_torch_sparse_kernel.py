"""The CUDA kernels of the 2:4 slice against their plain versions: the
sparse W4A8 GEMM (B4, ``csrc/w4a8_mm.cu``'s 2:4 entry point), the masked
GPFQ panel solve (B5 with a mask, ``csrc/gpfq_solve.cu``), and the plain
fused RMSNorm quantizer (B6) against the ``*_ref`` oracle; B6's kernel is
held to its plain version in ``tests/test_torch_quant_rmsnorm_kernel.py``.
This file imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sparse_kernel.py

Tests marked ``cuda`` skip without a card (the kernels have no CPU
interpret mode). Tolerances: B4 bit-equal to its plain version and to B1
on the expanded codes (integer sums are exact in any order; the epilogue
rounds each operation on its own); masked B5 in tie-limited agreement with
exact budget state and zeros exactly where the mask is 0; plain B6 exact
or within one code of the oracle on under 1% of elements (the oracle
divides by act_scale). The unmarked tests hold the plain versions to each
other on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gpfq as G
from repro_torch.core.alphabet import act_alphabet
from repro_torch.core.overflow import certify
from repro_torch.core.sparsity import is_2to4, mask_2to4
from repro_torch.kernels import gpfq_solve as B5
from repro_torch.kernels import quant_rmsnorm as B6
from repro_torch.kernels import w4a8_mm as W

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

EPS = 1e-3


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _sparse_operands(rng, m, k, n, signed, device="cpu"):
    """Full-range 2:4 int4 codes (-8 included) and full-range 8-bit codes."""
    q = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
    q = q * mask_2to4(_t(q)).numpy()
    lo, hi, dt = (-128, 128, np.int8) if signed else (0, 256, np.uint8)
    x = rng.integers(lo, hi, size=(m, k)).astype(dt)
    scale = rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32)
    packed, meta = W.compress_2to4(_t(q))
    return (_t(x, device), packed.to(device), meta.to(device), _t(scale, device),
            _t(q).to(torch.int32).sum(dim=0).to(device), q)


@pytest.mark.parametrize("signed", [False, True])
def test_sparse_plain_equals_dense_plain(signed, rng):
    x, packed, meta, scale, col, q = _sparse_operands(rng, 7, 128, 24, signed)
    dense = W.pack_int4(_t(q))
    for out in (torch.float32, torch.bfloat16):
        ys = W.w4a8_sparse_matmul(x, packed, meta, scale, 0.02, 131.0, col_sums=col,
                                  out_dtype=out)
        yd = W.w4a8_matmul(x, dense, scale, 0.02, 131.0, col_sums=col, out_dtype=out)
        assert torch.equal(ys, yd)


def test_masked_plain_solve_is_2to4_and_certified(rng):
    k, c = 64, 24
    w = _t((rng.normal(size=(k, c)) * 3).astype(np.float32))
    x = _t(rng.standard_normal((k, 2 * k)).astype(np.float32))
    h, g = G.me_stats(x, x + 0.05 * _t(rng.standard_normal((k, 2 * k)).astype(np.float32)))
    xg, xh = G.gh_inverse(h, g).contiguous(), h.contiguous()
    m = mask_2to4(w).to(torch.uint8)
    lam = torch.zeros(4, c)
    tid = (torch.arange(k) // 16).to(torch.int32)
    q, _, _, _ = B5.gpfq_solve(w, xg, xh, lam, tid, -7.53, 7.53, mask=m)
    assert is_2to4(q) and not q[m == 0].any()
    assert certify(q, act_alphabet(8), 12, 16, sparsity="2:4").ok


def test_quant_rmsnorm_plain_within_one_code_of_ref(rng):
    from repro_torch.kernels.ref import quant_rmsnorm_ref

    x = _t((rng.normal(size=(256, 960)) * 2).astype(np.float32))
    g = _t((rng.normal(size=(960,)) * 0.1 + 1.0).astype(np.float32))
    a = B6.quant_rmsnorm(x, g, 0.02, 128)
    b = quant_rmsnorm_ref(x, g, 0.02, 128)
    diff = (a.to(torch.int32) - b.to(torch.int32)).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("m,k,n", [(4, 960, 960), (256, 2560, 960), (3, 960, 100),
                                   (1, 64, 8), (9, 128, 64)])
def test_sparse_kernel_bit_equal_to_plain_and_b1(m, k, n, signed, cuda_device, rng):
    x, packed, meta, scale, col, q = _sparse_operands(rng, m, k, n, signed, cuda_device)
    dense = W.pack_int4(_t(q)).to(cuda_device)
    for out in (torch.float32, torch.bfloat16):
        before = W.w4a8_sparse_matmul.launches
        y = W.w4a8_sparse_matmul(x, packed, meta, scale, 0.02, 131.0, col_sums=col,
                                 out_dtype=out)
        r = W.w4a8_sparse_matmul(x, packed, meta, scale, 0.02, 131.0, col_sums=col,
                                 out_dtype=out, reference=True)
        b1 = W.w4a8_matmul(x, dense, scale, 0.02, 131.0, col_sums=col, out_dtype=out)
        torch.cuda.synchronize()
        assert W.w4a8_sparse_matmul.launches == before + 1
        assert torch.equal(y, r) and torch.equal(y, b1)


@pytest.mark.cuda
def test_sparse_kernel_adds_equal_positions(cuda_device, rng):
    """A hand-made meta with both positions equal: the kernel sums the two
    codes per byte, as unpack_sparse24 does."""
    k, n = 64, 16
    vals = rng.integers(-8, 8, size=(k // 2, n)).astype(np.int8)
    packed = W.pack_int4(_t(vals)).to(cuda_device)
    meta = _t(rng.integers(0, 4, size=(k // 4, n)) * 5).to(torch.int8).to(cuda_device)
    x = _t(rng.integers(0, 256, size=(5, k)).astype(np.uint8), cuda_device)
    col = W.unpack_sparse24(packed, meta).to(torch.int32).sum(dim=0)
    scale = torch.ones(n, device=cuda_device)
    y = W.w4a8_sparse_matmul(x, packed, meta, scale, 1.0, 0.0, col_sums=col)
    r = W.w4a8_sparse_matmul(x, packed, meta, scale, 1.0, 0.0, col_sums=col, reference=True)
    torch.cuda.synchronize()
    assert torch.equal(y, r)


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,mode", [(192, 200, "split"), (192, 64, "joint"),
                                      (960, 96, "split")])
def test_masked_b5_matches_plain_on_the_card(k, c, mode, cuda_device, rng):
    w = _t((rng.normal(size=(k, c)) * 3).astype(np.float32), cuda_device)
    x = _t(rng.standard_normal((k, k)).astype(np.float32), cuda_device)
    xq = x + 0.05 * _t(rng.standard_normal((k, k)).astype(np.float32), cuda_device)
    h, g = G.me_stats(x, xq)
    xg, xh = G.gh_inverse(h, g).contiguous(), h.contiguous()
    m = mask_2to4(w).to(torch.uint8)
    n_tiles = -(-k // 64)
    lam = _t(rng.uniform(0, 0.3, size=(n_tiles, c)).astype(np.float32), cuda_device)
    tid = (torch.arange(k, device=cuda_device) // 64).to(torch.int32)
    hg, hn = B5.row_terms(xg, xh)
    q, _, pos, neg = B5.gpfq_solve_kernel(w, xg, xh, hg, hn, lam, tid, -7.53, 7.53, qmax=7.0,
                                          mode=mode, mask=m)
    pq, _, _, _, v = B5.gpfq_solve_plain(w, xg, xh, hg, hn, lam, tid, -7.53, 7.53, qmax=7.0,
                                         mode=mode, return_v=True, mask=m)
    torch.cuda.synchronize()
    ok, share, _ = B5.tie_limited_agreement(pq, q, v, "nearest", EPS)
    assert ok, share
    assert not q[m == 0].any() and is_2to4(q)
    onehot = torch.nn.functional.one_hot(tid.long(), n_tiles).to(torch.float32)
    assert torch.equal(onehot.T @ torch.clamp(q, min=0), pos)
    assert torch.equal(onehot.T @ torch.clamp(q, max=0), neg)
