"""B1 and B4 (and their expert forms) at a ragged N, N % 4 != 0: the sLSTM
FFN's ``up`` site has N = int(d * 4/3), 1365 on xlstm-350m and 85 on
tiny-xlstm, whose int4 rows of N bytes start at any byte. This file
imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ragged_kernel.py

On the CPU: the plan takes the ragged kernel (load width 1) exactly where
N % 4 != 0, its grid covering every row, column and K row; the expert
axis sends a ragged N to its tile tier; and the numpy model of the
kernel's fragments and K split gives the exact product at ragged N.

Tests marked ``cuda`` skip without a card. On the card the kernels launch
(their counters rise) and are bit-equal to their plain versions at (M, N,
K) = (4, 1365, 1024), (64, 1365, 1024), (256, 1365, 1024), (4, 85, 64)
and at N = 1, 2, 3, 5 across decode and prefill M, at a 1-byte offset of
the weights, in a CUDA graph, and B1e/B4e over 5 experts at ragged N.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import w4a8_mm as W
from test_torch_moe_kernel import _check_on_card
from test_torch_moe_kernel import _operands as _expert_operands
from test_torch_w4a8_kernel import _check_b1_b4, _codes, _operands, _t, _weights, split_k_model

#: the issue's shapes: xlstm-350m's sLSTM ``up`` at decode and prefill M,
#: tiny-xlstm's, and the narrowest N
RAGGED = [(4, 1024, 1365), (64, 1024, 1365), (256, 1024, 1365), (4, 64, 85), (4, 1024, 1),
          (1, 64, 2), (7, 128, 3), (300, 256, 5), (17, 960, 99)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_ragged_plan_takes_the_byte_loader(m, k, n):
    plan = W.w4a8_plan(m, n, k)
    assert plan.vec == 1
    assert plan.grid[0] == -(-n // W.TILE_N) and plan.grid[1] == -(-m // W.TILE_M)
    assert plan.grid[2] * plan.ck >= k and plan.grid[2] <= W.MAX_CHUNKS
    # aligned shapes keep their plans
    assert W.w4a8_plan(m, 1024, k).vec == 16 and W.w4a8_plan(m, 1364, k).vec == 4


@pytest.mark.parametrize("m", [1, 4, 48, 64, 80, 200])
def test_expert_axis_sends_a_ragged_n_to_the_tile_tier(m):
    assert W.expert_tier(m, 85, 8) == "tile"
    plan = W.w4a8_expert_plan(m, 85, 64, 8)
    assert plan.tier == "tile" and plan.vec == 1
    assert W.w4a8_expert_plan(m, 84, 64, 8).vec == 4


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 1365), (4, 64, 85), (70, 256, 5), (3, 128, 1)])
def test_split_k_model_is_the_exact_product_at_ragged_n(m, k, n, sparse, rng):
    """The kernel's fragments and its cluster's K-split sums, at the ragged
    plan: a last column tile with 1-63 live columns, a vector cut at N."""
    q, x = _codes(rng, m, k, n, False, sparse)
    wbytes, meta = _weights(q, sparse)
    plan = W.w4a8_plan(m, n, k)
    got = split_k_model(x, wbytes, meta, False, plan)
    np.testing.assert_array_equal(got, W.exact_int_matmul(_t(x), _t(q)).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_cuda_ragged_bit_equal_to_plain(m, k, n, signed, rng, cuda_device):
    """B1 and B4 launch (counters rise) and equal their plain versions; B4
    equals B1 on the expanded codes."""
    o = _operands(rng, m, k, n, signed, cuda_device)
    for out in (torch.float32, torch.bfloat16):
        _check_b1_b4(o, out)
    assert W.w4a8_matmul.last_plan.vec == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_cuda_ragged_at_a_byte_offset(m, rng, cuda_device):
    """Weights one byte into their buffers (no alignment at all)."""
    o = _operands(rng, m, 1024, 1365, False, cuda_device)
    for key in ("dense", "packed", "meta", "sdense"):
        t = o[key]
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        o[key] = buf[1:].view(t.shape)
        o[key].copy_(t)
    _check_b1_b4(o, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_ragged_replays_in_a_cuda_graph(rng, cuda_device):
    o = _operands(rng, 4, 1024, 1365, False, cuda_device)
    args = (o["x"], o["dense"], o["scale"], 0.02, 131.0)
    want = W.w4a8_matmul(*args, col_sums=o["col"], reference=True)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        W.w4a8_matmul(*args, col_sums=o["col"])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        y = W.w4a8_matmul(*args, col_sums=o["col"])
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 64, 70])
def test_cuda_expert_kernels_at_ragged_n(m, cuda_device):
    """B1e and B4e at N = 85 on the tile tier: bit-equal to their plain
    versions, to E launches of B1/B4, and B4e to B1e on expanded codes."""
    o = _expert_operands(np.random.default_rng(m), 5, m, 64, 85, False, cuda_device)
    _check_on_card(o, torch.bfloat16)
