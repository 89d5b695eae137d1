"""The GPFQ panel solver's CUDA kernel (B5, ``csrc/gpfq_solve.cu``) against
its plain version, ``repro_torch.kernels.gpfq_solve.gpfq_solve_plain``.
This file imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpfq_kernel.py

The tests marked ``cuda`` skip without a card (the kernel has no CPU
interpret mode). Codes are held by tie-limited agreement (equal in every
channel up to the first row whose value before rounding lies within 1e-3
of a rounding boundary: the kernel reduces h_k . U in another order), the
budget state exactly. The statistics come from samples X and a distinct
perturbed copy Xq, as in calibration, so G H^-1 differs from H; the
unmarked test shows that these inputs catch a solve that mixes the two up.
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,mode,rounding,force_global", [
    (192, 200, "split", "nearest", False), (192, 72, "joint", "nearest", True),
    (192, 64, "split", "zero", False), (192, 64, "plain", "nearest", False),
    (192, 64, "soft", "nearest", True),
])
def test_kernel_matches_plain_on_the_card(k, c, mode, rounding, force_global, cuda_device, rng):
    w = _t((rng.normal(size=(k, c)) * 3).astype(np.float32), cuda_device)
    xg, xh = _stats(rng, k, k, cuda_device)
    n_tiles = 3 if mode != "plain" else 1
    lam = _t(rng.uniform(0, 0.3, size=(n_tiles, c)).astype(np.float32), cuda_device)
    tid = (torch.arange(k, device=cuda_device) // 64 % n_tiles)[torch.randperm(k)].to(torch.int32)
    hg, hn = B5.row_terms(xg, xh)
    before = B5.gpfq_solve.launches
    q, u, pos, neg = B5.gpfq_solve_kernel(w, xg, xh, hg, hn, lam, tid, -7.53, 7.53, qmax=7.0,
                                          mode=mode, rounding=rounding,
                                          force_global_u=force_global)
    torch.cuda.synchronize()
    assert B5.gpfq_solve.launches == before + 1
    pq, pu, ppos, pneg, v = B5.gpfq_solve_plain(w, xg, xh, hg, hn, lam, tid, -7.53, 7.53,
                                                qmax=7.0, mode=mode, rounding=rounding,
                                                return_v=True)
    ok, share, _ = B5.tie_limited_agreement(pq, q, v, rounding, EPS)
    assert ok, share
    if mode != "plain":
        _own_sums_exact(q, pos, neg, tid)
    if share == 1.0:
        torch.testing.assert_close(u, pu, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_kernel_panel_layouts_on_the_card(cuda_device):
    """The launcher's panel layouts at smollm-360m's and phi-4-mini's depths."""
    assert B5.panel_layout(960) == (32, False)
    assert B5.panel_layout(2560) == (16, False)
    assert B5.panel_layout(8192) == (32, True)
    assert B5.panel_layout(960, force_global_u=True) == (32, True)
