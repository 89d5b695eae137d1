"""The GPFQ panel solver's CUDA kernels (B5, ``csrc/gpfq_solve.cu``) against
its plain version, ``repro_torch.kernels.gpfq_solve.gpfq_solve_plain``, and
the blocked algebra those kernels run, as a PyTorch model on the CPU.
This file imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpfq_kernel.py

The tests marked ``cuda`` skip without a card (the kernel has no CPU
interpret mode). Codes are held by tie-limited agreement (equal in every
channel up to the first row whose value before rounding lies within 1e-3
of a rounding boundary: the kernel reduces h_k . U in another order), the
budget state exactly. The statistics come from samples X and a distinct
perturbed copy Xq, as in calibration, so G H^-1 differs from H; an
unmarked test shows that these inputs catch a solve that mixes the two up,
and another that they catch a blocked solve that drops the correction of
a row by the earlier rows of its own block.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import gpfq as G
from repro_torch.kernels import gpfq_solve as B5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

EPS = 1e-3


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernel itself (it has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU interpret mode")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a)).to(device)


def _stats(rng, k, d, device="cpu"):
    """(G H^-1, H) from samples X and a distinct perturbed copy Xq."""
    x = rng.standard_normal((k, d)).astype(np.float32)
    xq = (x + 0.05 * rng.standard_normal((k, d))).astype(np.float32)
    h, g = G.me_stats(_t(x, device), _t(xq, device))
    return G.gh_inverse(h, g).contiguous(), h.contiguous()


def _own_sums_exact(q, pos, neg, tid):
    """The budget state equals the tile sums of the solve's own codes."""
    n_tiles = pos.shape[0]
    onehot = torch.nn.functional.one_hot(tid.long(), n_tiles).to(torch.float32)  # (K, T)
    assert torch.equal(onehot.T @ torch.clamp(q, min=0), pos)
    assert torch.equal(onehot.T @ torch.clamp(q, max=0), neg)


#: a solver that mixes up G H^-1 and H, as arguments of the plain version
MIXUPS = {
    "swapped": lambda xg, xh, hg, hn: (xh, xg, hg, hn),
    "h_in_the_gw_term": lambda xg, xh, hg, hn: (xh, xh, hg, hn),
    "no_hg_factor": lambda xg, xh, hg, hn: (xg, xh, hn, hn),
}


@pytest.mark.parametrize("mixup", sorted(MIXUPS))
def test_parity_inputs_catch_mixed_up_matrices(mixup, rng):
    """The inputs the kernel is held on tell G H^-1 from H: a solve that
    mixes them up fails the tie-limited check."""
    k, c = 128, 64
    w = _t((rng.normal(size=(k, c)) * 3).astype(np.float32))
    xg, xh = _stats(rng, k, 4 * k)
    lam = _t(rng.uniform(0, 0.3, size=(k // 32, c)).astype(np.float32))
    tid = (torch.arange(k) // 32).to(torch.int32)
    hg, hn = B5.row_terms(xg, xh)
    kw = dict(qmax=7.0, mode="split")
    q, _, _, _, v = B5.gpfq_solve_plain(w, xg, xh, hg, hn, lam, tid, -7.53, 7.53, **kw,
                                        return_v=True)
    bad = B5.gpfq_solve_plain(w, *MIXUPS[mixup](xg, xh, hg, hn), lam, tid, -7.53, 7.53, **kw)[0]
    ok, share, _ = B5.tie_limited_agreement(q, bad, v, "nearest", EPS)
    assert not ok, (mixup, share)


def _mask_2to4(w):
    """A 2:4 support along K in solve order: the two largest |w| of every
    group of 4 rows; a ragged tail of rows is kept."""
    k, c = w.shape
    keep = np.ones((k, c), dtype=np.uint8)
    groups = np.abs(w[: k - k % 4]).reshape(-1, 4, c)
    order = np.argsort(groups, axis=1, kind="stable")[:, :2]  # the two smallest
    np.put_along_axis(keep[: k - k % 4].reshape(-1, 4, c), order, 0, axis=1)
    return keep


def _case(rng, k, c, mode, masked, device="cpu", d=None, tile=32):
    """Kernel arguments for one solve: statistics from X and a distinct Xq,
    integer-domain weights, soft thresholds and permuted tile ids (one tile
    for plain GPFQ), and a 2:4 mask when ``masked``."""
    w_np = (rng.normal(size=(k, c)) * 3).astype(np.float32)
    w = _t(w_np, device)
    xg, xh = _stats(rng, k, d or k, device)
    n_tiles = -(-k // tile) if mode != "plain" else 1
    lam = _t(rng.uniform(0, 0.3, size=(n_tiles, c)).astype(np.float32), device)
    tid = _t((np.arange(k) // tile % n_tiles)[rng.permutation(k)].astype(np.int32), device)
    hg, hn = B5.row_terms(xg, xh)
    mask = _t(_mask_2to4(w_np), device) if masked else None
    return (w, xg, xh, hg, hn, lam, tid, -7.53, 7.53), mask


def blocked_model(w, xg, xh, hg, hn, lam, tid, a, b, *, qmax, mode, rounding, rows,
                  mask=None, intra=True):
    """The kernel's blocked algebra in PyTorch, blocks of ``rows`` rows: (1)
    the block's projection Xh_blk U_s plus the strictly lower h.g Gram block
    times W_blk; (2) per row in order, v from the running value, the
    constraints, and (``intra``) the correction of the later rows of the
    block by -(h_i . h_j) q_j; (3) U += Xg_blk^T W_blk - Xh_blk^T Q_blk.
    Returns (Q, U, pos, neg)."""
    k, c = w.shape
    u = torch.zeros((xg.shape[1], c))
    q_all = torch.empty((k, c))
    pos = torch.zeros((lam.shape[0], c))
    neg = torch.zeros((lam.shape[0], c))
    tids = tid.tolist()
    for s in range(0, k, rows):
        e = min(s + rows, k)
        h_b, g_b, w_b = xh[s:e], xg[s:e], w[s:e]
        r = h_b @ u + torch.tril(h_b @ g_b.T, -1) @ w_b
        l_hh = torch.tril(h_b @ h_b.T, -1)
        for i in range(e - s):
            kk = s + i
            v = w[kk] * (hg[kk] / hn[kk]) + r[i] / hn[kk]
            if mask is not None:
                v = v * mask[kk].to(torch.float32)
            q, _ = B5.constrain_codes(v, tids[kk], lam, a, b, pos, neg, qmax=qmax, mode=mode,
                                      rounding=rounding)
            q_all[kk] = q
            if intra:
                r[i + 1:] -= l_hh[i + 1:, i, None] * q[None, :]
        u = u + g_b.T @ w_b - h_b.T @ q_all[s:e]
    return q_all, u, pos, neg


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "2:4"])
@pytest.mark.parametrize("rounding", ["nearest", "zero"])
@pytest.mark.parametrize("mode", ["plain", "split", "joint", "soft"])
@pytest.mark.parametrize("rows", [1, 3, 16, 64, 150])
def test_blocked_algebra_matches_plain(rows, mode, rounding, masked, rng):
    """The blocked solve of the kernels, at any block size (K = 150 is ragged
    for every size but 1, 3 and 150), gives the plain version's codes up to
    near-ties, budget state that sums its own codes exactly, zeros where the
    mask prunes and, where every code agrees, the same U."""
    k, c = 150, 40
    args, mask = _case(rng, k, c, mode, masked)
    kw = dict(qmax=7.0, mode=mode, rounding=rounding)
    pq, pu, _, _, v = B5.gpfq_solve_plain(*args, **kw, mask=mask, return_v=True)
    q, u, pos, neg = blocked_model(*args, **kw, rows=rows, mask=mask)
    ok, share, _ = B5.tie_limited_agreement(pq, q, v, rounding, EPS)
    assert ok, share
    if mode != "plain":
        _own_sums_exact(q, pos, neg, args[6])
    else:
        assert not pos.any() and not neg.any()
    if masked:
        assert not q[mask == 0].any()
    if share == 1.0:
        torch.testing.assert_close(u, pu, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("rows", [3, 16, 64])
def test_blocked_algebra_needs_the_intra_block_correction(rows, rng):
    """The same model without the -(h_i . h_j) q_j correction inside a block
    fails the tie-limited check: the CPU model can see a dropped term."""
    args, _ = _case(rng, 150, 40, "split", False)
    kw = dict(qmax=7.0, mode="split", rounding="nearest")
    pq, _, _, _, v = B5.gpfq_solve_plain(*args, **kw, return_v=True)
    q = blocked_model(*args, **kw, rows=rows, intra=False)[0]
    ok, share, _ = B5.tie_limited_agreement(pq, q, v, "nearest", EPS)
    assert not ok, share


#: (K, C, mode, rounding, masked): the per-panel kernel's cases, then K
#: across the 64-row block boundary, narrow C, a masked solve and a deep one
CARD_CASES = [
    (192, 200, "split", "nearest", False), (192, 72, "joint", "nearest", False),
    (192, 64, "split", "zero", False), (192, 64, "plain", "nearest", False),
    (192, 64, "soft", "nearest", False),
    (63, 40, "split", "nearest", False), (64, 40, "split", "nearest", False),
    (65, 40, "split", "nearest", False), (129, 40, "joint", "nearest", False),
    (192, 1, "split", "nearest", False), (192, 17, "split", "zero", False),
    (192, 64, "joint", "nearest", False), (150, 96, "split", "nearest", True),
    (8192, 64, "split", "nearest", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,mode,rounding,masked", CARD_CASES)
def test_kernel_matches_plain_on_the_card(k, c, mode, rounding, masked, cuda_device, rng):
    args, mask = _case(rng, k, c, mode, masked, cuda_device, tile=64)
    before = (B5.gpfq_solve.launches, B5.gpfq_solve.device_kernels)  # kernels: counted in C
    q, u, pos, neg = B5.gpfq_solve_kernel(*args, qmax=7.0, mode=mode, rounding=rounding,
                                          mask=mask)
    torch.cuda.synchronize()
    assert B5.gpfq_solve.launches == before[0] + 1
    assert B5.gpfq_solve.device_kernels == before[1] + B5.block_plan(k, k, c)["kernels"]
    pq, pu, ppos, pneg, v = B5.gpfq_solve_plain(*args, qmax=7.0, mode=mode, rounding=rounding,
                                                mask=mask, return_v=True)
    ok, share, _ = B5.tie_limited_agreement(pq, q, v, rounding, EPS)
    assert ok, share
    tid = args[6]
    if mode != "plain":
        _own_sums_exact(q, pos, neg, tid)
    else:
        assert not pos.any() and not neg.any()
    if masked:
        assert not q[mask == 0].any()
    if share == 1.0:
        torch.testing.assert_close(u, pu, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,c", [(1, 1, 1), (63, 63, 17), (64, 64, 64), (65, 960, 1),
                                   (960, 960, 320), (2560, 2560, 960), (2561, 2624, 7),
                                   (8192, 8192, 64)])
def test_kernel_block_plan_on_the_card(k, d, c, cuda_device):
    """The launcher's plan: 64-row blocks; 64 x 64 U tiles, one projection
    partial a D tile; 8-channel recurrence CTAs; two Gram launches (the
    product, the sum of its at most 8 D parts, each a whole number of
    32-column chunks) plus two launches a block; workspaces for every
    part's Gram pairs and their sums and for every D tile's partial. An
    empty solve has no plan."""
    plan = B5.block_plan(k, d, c)
    nb = -(-k // 64)
    assert plan["rows"] == 64
    assert plan["blocks"] == nb and (nb - 1) * 64 < k <= nb * 64
    assert plan["d_tiles"] * 64 >= d > (plan["d_tiles"] - 1) * 64
    assert plan["c_tiles"] * 64 >= c > (plan["c_tiles"] - 1) * 64
    assert plan["chain_ctas"] * 8 >= c > (plan["chain_ctas"] - 1) * 8
    assert plan["kernels"] == 2 + 2 * nb
    splits, span = plan["gram_splits"], plan["gram_span"]
    assert 1 <= splits <= 8 and span % 32 == 0
    assert d <= splits * span < d + 32 + 32 * splits  # the parts cover D, none wider than needed
    assert plan["gram_floats"] == (splits + 1) * nb * 2 * 64 * 64
    assert plan["part_floats"] == plan["d_tiles"] * 64 * c
    with pytest.raises(ValueError):
        B5.block_plan(0, d, c)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "2:4"])
def test_kernel_is_deterministic_and_u_consistent_on_the_card(masked, cuda_device, rng):
    """Two runs give bit-identical Q, U, pos and neg (split-D partials are
    summed in a fixed order), and U equals Xg^T W - Xh^T Q recomputed in
    float64 from the kernel's own codes."""
    args, mask = _case(rng, 960, 320, "split", masked, cuda_device, tile=128)
    kw = dict(qmax=7.0, mode="split", rounding="nearest", mask=mask)
    first = B5.gpfq_solve_kernel(*args, **kw)
    second = B5.gpfq_solve_kernel(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    w, xg, xh = args[0], args[1], args[2]
    q, u = first[0], first[1]
    ref = xg.double().T @ w.double() - xh.double().T @ q.double()
    scale = (xg.double().abs().T @ w.double().abs() + xh.double().abs().T @ q.double().abs())
    torch.testing.assert_close(u.double(), ref, rtol=1e-4, atol=float(1e-4 * scale.max()))


@pytest.mark.cuda
def test_kernel_takes_no_host_sync_on_the_card(cuda_device, rng):
    """The wrapper enqueues the whole solve without a host synchronisation
    (no value read back, no host-side plan of the data)."""
    args, mask = _case(rng, 200, 96, "split", True, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = B5.gpfq_solve_kernel(*args, qmax=7.0, mode="split", mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out[1]).all()


TRAP_SCRIPT = """
import torch
from repro_torch.kernels import gpfq_solve as B5
k, c = 96, 40
w = torch.ones((k, c), device="cuda")
x = torch.eye(k, device="cuda")
lam = torch.zeros((2, c), device="cuda")
tid = torch.zeros((k,), dtype=torch.int32, device="cuda")
tid[70] = 2
hg, hn = B5.row_terms(x, x)
try:
    B5.gpfq_solve_kernel(w, x, x, hg, hn, lam, tid, -7.0, 7.0, qmax=7.0)
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("TRAPPED", type(exc).__name__)
else:
    print("NO TRAP")
"""


@pytest.mark.cuda
def test_kernel_traps_on_a_bad_tile_id_on_the_card(cuda_device):
    """A tile id outside [0, n_tiles) in the second row block traps on the
    device; the error surfaces at the synchronisation. Run in a child
    process: a trap leaves the CUDA context unusable."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", TRAP_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=300)
    assert "TRAPPED" in out.stdout, (out.stdout, out.stderr[-2000:])
