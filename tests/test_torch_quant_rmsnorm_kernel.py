"""The fused RMSNorm quantizer B6 of ``csrc/quant_rmsnorm.cu``: its plan,
the plain model of its summation order, and the kernel on the card. This
file imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_quant_rmsnorm_kernel.py

On the CPU: ``rmsnorm_plan`` gives every vector of a row to exactly one
(thread, slot) for every layout it can pick; the model's sum of squares is
a literal run of the kernel's loops (per-thread partials, the xor shuffle
lane by lane, the warps in order), and the model is within one code of the
plain version on under 1% of elements for every layout of D 1 to 16384 and
for staged rows past it.

Tests marked ``cuda`` skip without a card (the kernel has no CPU interpret
mode). On the card the kernel is bit-equal to ``quant_rmsnorm_model`` (the
same operations, each rounded on its own, in the same order) and within
one code of the plain version on under 1% of elements (``torch.sum`` adds
in another order), at the registry's widths and past them, ragged D, rows
at an offset, 4 and 8 bits, device-scalar quantizers, two runs, a CUDA
graph replay, the sync-debug mode and a profiler count of one kernel a
call.
"""


import numpy as np
import pytest
import torch

from repro_torch.kernels import quant_rmsnorm as B6
from repro_torch.kernels.ops import norm_and_quantize
from test_torch_trace import complete_trace, traced_kernels

EPS = 1e-6
#: every width of the JAX registry (src/repro/configs/*.py), ragged ones,
#: and staged rows past the register tier
WIDTHS = [1, 31, 100, 960, 1536, 2560, 3072, 6144, 8192, 16384, 32768, 65536]


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernel itself (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _inputs(rng, m, d, dtype, device="cpu"):
    x = _t((rng.normal(size=(m, d)) * 2).astype(np.float32), device).to(dtype)
    g = _t((rng.normal(size=(d,)) * 0.1 + 1.0).astype(np.float32), device)
    return x, g


def _within_one_code(a, b):
    diff = (a.to(torch.int32) - b.to(torch.int32)).abs()
    off = float((diff > 0).float().mean())
    assert int(diff.max()) <= 1 and off < 0.01, (int(diff.max()), off)


def _layouts():
    """(bf16, aligned, D) at both ends of every layout (vec, threads,
    slots, block) that the plan picks for D in 1..16384."""
    cases = {}
    for bf16 in (False, True):
        for aligned in (True, False):
            v = (8 if bf16 else 4) if aligned else 1
            for t in (32, 64, 128, 256, 512, 1024):
                for need in range(1, 17):
                    for nvec in ((need - 1) * t + 1, need * t):
                        d = nvec * v
                        p = B6.rmsnorm_plan(d, bf16, aligned)
                        if d > 16384 or p.threads != t or -(-nvec // t) != need:
                            continue
                        key = (bf16, p.vec, p.threads, p.per_thread, p.block)
                        lo, hi = cases.get(key, (d, d))
                        cases[key] = (min(lo, d), max(hi, d))
    out = set()
    for (bf16, vec, *_), ds in cases.items():
        out.update((bf16, vec > 1, d) for d in ds)
    return sorted(out)


LAYOUTS = _layouts()
#: staged rows: the whole row in shared memory, and part of it re-read
STAGED = [(False, True, 32768), (False, True, 65536), (True, True, 65536),
          (True, False, 40000), (False, False, 16385)]


# ---------------------------------------------------------------------------
# The plan and the model, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16,aligned,d", LAYOUTS + STAGED)
def test_plan_gives_each_vector_one_slot(bf16, aligned, d):
    p = B6.rmsnorm_plan(d, bf16, aligned)
    assert p.threads & (p.threads - 1) == 0 and 32 <= p.threads <= B6.MAX_THREADS
    assert p.block in (256, 512, 1024) and p.block % p.threads == 0
    assert p.smem_bytes <= B6.SMEM_BYTES
    assert d % p.vec == 0 and p.vec in ((8 if bf16 else 4) if aligned else 1, 1)
    nvec = d // p.vec
    owned = np.zeros(nvec, dtype=np.int64)
    for k in range(p.per_thread):
        j = np.arange(p.threads) + k * p.threads
        np.add.at(owned, j[j < nvec], 1)
    assert (owned == 1).all()
    if p.staged:
        assert p.threads == p.block == B6.MAX_THREADS and 0 < p.held <= nvec
        assert d > 16384 or not aligned
    else:
        assert p.per_thread <= (B6.MAX_VECTORS if p.vec > 1 else B6.MAX_SCALARS)
        if p.vec > 1:  # no slot idle in every thread
            assert (p.per_thread - 1) * p.threads < nvec


def test_plan_is_cached_and_follows_alignment():
    assert B6.rmsnorm_plan(960, False) is B6.rmsnorm_plan(960, False)
    assert B6.rmsnorm_plan(960, False).vec == 4 and B6.rmsnorm_plan(960, True).vec == 8
    assert B6.rmsnorm_plan(960, False, aligned=False).vec == 1
    assert B6.rmsnorm_plan(100, True).vec == 1  # 200-byte rows: odd rows off 16 bytes
    assert not B6.rmsnorm_plan(16384, False).staged  # the registry's widest row
    assert B6.rmsnorm_plan(16384, False).threads == 1024


def _kernel_sum_by_loops(row, plan):
    """One row's sum of squares as the kernel's threads compute it, in
    numpy float32 scalars: each thread over its slots and elements, the xor
    shuffle lane by lane, then the warps in index order."""
    f32 = np.float32
    t_n, v = plan.threads, plan.vec
    nvec = len(row) // v
    part = []
    for t in range(t_n):
        ss = f32(0)
        for k in range(plan.per_thread):
            j = t + k * t_n
            for e in range(v):
                x = f32(row[j * v + e]) if j < nvec else f32(0)
                ss = f32(ss + f32(x * x))
        part.append(ss)
    warps = []
    for w in range(t_n // 32):
        lanes = part[32 * w:32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            lanes = [f32(lanes[i] + lanes[i ^ off]) for i in range(32)]
        assert len({float(s) for s in lanes}) == 1  # every lane holds the sum
        warps.append(lanes[0])
    total = warps[0]
    for s in warps[1:]:
        total = f32(total + s)
    return total


@pytest.mark.parametrize("bf16,aligned,d", [(False, True, 100), (False, True, 960),
                                            (True, True, 1000), (False, False, 999),
                                            (False, True, 3072), (True, True, 65536)])
def test_model_sum_is_the_kernels_loops(bf16, aligned, d, rng):
    x, _ = _inputs(rng, 3, d, torch.bfloat16 if bf16 else torch.float32)
    plan = B6.rmsnorm_plan(d, bf16, aligned)
    xf = x.to(torch.float32)
    sums = B6.sum_squares_in_kernel_order(xf, plan)
    for i in range(3):
        assert np.float32(sums[i, 0].item()) == _kernel_sum_by_loops(xf[i].numpy(), plan)


def test_model_order_matters(rng):
    """Two plans of one width sum in other orders: some row's sum differs,
    so bit-equality with the model pins the kernel's order."""
    x, _ = _inputs(rng, 64, 960, torch.float32)
    a = B6.sum_squares_in_kernel_order(x, B6.rmsnorm_plan(960, False))
    b = B6.sum_squares_in_kernel_order(x, B6.rmsnorm_plan(960, False, aligned=False))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("bf16,aligned,d", LAYOUTS + STAGED)
def test_model_within_one_code_of_plain(bf16, aligned, d, rng):
    m = max(4, 16384 // d)
    x, g = _inputs(rng, m, d, torch.bfloat16 if bf16 else torch.float32)
    qp = B6.quantizer_pair(0.02, 128, "cpu")
    plan = B6.rmsnorm_plan(d, bf16, aligned)
    model = B6.quant_rmsnorm_model(x, g, qp, plan, eps=EPS, qmax=255.0)
    _within_one_code(model, B6.quant_rmsnorm_plain(x, g, qp, eps=EPS, qmax=255.0))


def test_quantizer_arguments_formed_in_f32():
    """Python numbers become f32 values formed on the host as the reference's
    wrapper forms them; CPU tensors are read as numbers."""
    for scale, zp in ((0.02, 128), (0.0213, 131.0), (0.1 / 3, 7)):
        sp, zpp, inv, z, _ = B6._quantizer_args(scale, zp, torch.device("cuda"))
        assert sp is None and zpp is None
        assert np.float32(inv) == np.float32(1.0) / np.float32(scale)
        assert np.float32(z) == np.float32(zp)
        assert inv == float(B6.quantizer_pair(scale, zp, "cpu")[0])
    sp, _, inv, _, _ = B6._quantizer_args(torch.tensor(0.5), torch.tensor(3.0),
                                          torch.device("cuda"))
    assert sp is None and inv == 2.0


# ---------------------------------------------------------------------------
# The kernel, on the card
# ---------------------------------------------------------------------------
def _check(x, g, act_scale=0.02, act_zp=128, qmax=255.0):
    """One kernel call held bit-equal to the model under the plan it
    launched with and within one code of the plain version."""
    before = B6.quant_rmsnorm.launches
    y = B6.quant_rmsnorm_kernel(x, g, act_scale, act_zp, eps=EPS, qmax=qmax)
    qp = B6.quantizer_pair(act_scale, act_zp, x.device)
    plan = B6.rmsnorm_plan(x.shape[1], x.dtype == torch.bfloat16, x.data_ptr() % 16 == 0)
    model = B6.quant_rmsnorm_model(x, g, qp, plan, eps=EPS, qmax=qmax)
    plain = B6.quant_rmsnorm_plain(x, g, qp, eps=EPS, qmax=qmax)
    torch.cuda.synchronize()
    assert B6.quant_rmsnorm.launches == before + 1 and B6.quant_rmsnorm.last_plan == plan
    assert torch.equal(y, model), f"{int((y != model).sum())} codes differ from the model"
    _within_one_code(y, plain)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(256, 960), (512, 1024), (1024, 4096), (256, 100)])
def test_quant_rmsnorm_kernel_matches_plain(m, d, dtype, cuda_device, rng):
    x = _t((rng.normal(size=(m, d)) * 2).astype(np.float32), cuda_device).to(dtype)
    g = _t((rng.normal(size=(d,)) * 0.1 + 1.0).astype(np.float32), cuda_device)
    before = B6.quant_rmsnorm.launches
    y = B6.quant_rmsnorm(x, g, 0.02, 128)
    qp = B6.quantizer_pair(0.02, 128, cuda_device)
    r = B6.quant_rmsnorm_plain(x, g, qp, eps=1e-6, qmax=255.0)
    torch.cuda.synchronize()
    assert B6.quant_rmsnorm.launches == before + 1
    diff = (y.to(torch.int32) - r.to(torch.int32)).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_bit_equal_to_model(d, dtype, m, cuda_device, rng):
    _check(*_inputs(rng, m, d, dtype, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [960, 4096, 16384, 32768])
def test_kernel_on_a_view_at_an_offset(d, dtype, offset, cuda_device, rng):
    """x an offset view into a larger buffer: off 16 bytes the kernel takes
    single-element loads; 4 f32 in (16 bytes) it keeps its vectors."""
    m = 5
    x, g = _inputs(rng, m, d, dtype, cuda_device)
    buf = torch.empty(m * d + offset, dtype=dtype, device=cuda_device)
    view = buf[offset:].view(m, d)
    view.copy_(x)
    aligned = view.data_ptr() % 16 == 0
    assert aligned == (dtype == torch.float32 and offset == 4)
    _check(view, g)
    assert B6.quant_rmsnorm.last_plan.vec == (4 if aligned else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bits(bits, dtype, cuda_device, rng):
    x, g = _inputs(rng, 64, 960, dtype, cuda_device)
    y = _check(x, g, 0.05 if bits == 4 else 0.02, 7 if bits == 4 else 128, float(2**bits - 1))
    assert int(y.max()) <= 2**bits - 1
    z = B6.quant_rmsnorm(x, g, 0.05 if bits == 4 else 0.02, 7 if bits == 4 else 128,
                         block_m=64, bits=bits)
    assert torch.equal(y, z)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [960, 16384, 65536])
def test_two_runs_bit_identical(d, cuda_device, rng):
    x, g = _inputs(rng, 300, d, torch.float32, cuda_device)
    a = B6.quant_rmsnorm_kernel(x, g, 0.02, 128, eps=EPS, qmax=255.0)
    b = B6.quant_rmsnorm_kernel(x, g, 0.02, 128, eps=EPS, qmax=255.0)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,zp", [(0.02, 128.0), (0.0213, 131.0), (0.1 / 3, 7.0)])
def test_device_scalar_quantizers_bit_equal_to_quantizer_pair(scale, zp, cuda_device, rng):
    """A 0-d float32 act_scale / act_zp on the card goes as a pointer and the
    kernel forms 1 / act_scale: the codes equal the model's on
    quantizer_pair's f32 reciprocal, and the Python-number call's."""
    x, g = _inputs(rng, 64, 3072, torch.bfloat16, cuda_device)
    s = torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    z = torch.tensor(zp, dtype=torch.float32, device=cuda_device)
    y = _check(x, g, s, z)
    assert torch.equal(y, B6.quant_rmsnorm_kernel(x, g, scale, zp, eps=EPS, qmax=255.0))


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph(cuda_device, rng):
    """One call captured with device-scalar quantizers, replayed on new x and
    a new act_scale copied into the captured buffers: equal to the model
    each time, so the launch keeps no value from the host."""
    m, d = 257, 16384
    x, g = _inputs(rng, m, d, torch.float32, cuda_device)
    s = torch.tensor(0.02, device=cuda_device)
    z = torch.tensor(128.0, device=cuda_device)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):  # build and load before the capture
        B6.quant_rmsnorm_kernel(x, g, s, z, eps=EPS, qmax=255.0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        y = B6.quant_rmsnorm_kernel(x, g, s, z, eps=EPS, qmax=255.0)
    plan = B6.rmsnorm_plan(d, False)
    for scale in (0.03, 0.011, 0.02):
        x.copy_(_inputs(rng, m, d, torch.float32, cuda_device)[0])
        s.fill_(scale)
        graph.replay()
        qp = B6.quantizer_pair(s, z, cuda_device)
        model = B6.quant_rmsnorm_model(x, g, qp, plan, eps=EPS, qmax=255.0)
        torch.cuda.synchronize()
        assert torch.equal(y, model)


@pytest.mark.cuda
def test_kernel_never_synchronizes(cuda_device, rng):
    x, g = _inputs(rng, 256, 960, torch.bfloat16, cuda_device)
    s = torch.tensor(0.02, device=cuda_device)
    z = torch.tensor(128.0, device=cuda_device)
    B6.quant_rmsnorm(x, g, 0.02, 128)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = B6.quant_rmsnorm(x, g, 0.02, 128)
        b = B6.quant_rmsnorm(x, g, s, z)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_norm_and_quantize_one_kernel_a_call(cuda_device, rng):
    """The profiler sees exactly one device kernel a norm_and_quantize call,
    by name, with Python-number and with device-scalar quantizers, in the
    register tier and staged."""
    cases = [(_inputs(rng, m, d, dt, cuda_device), m) for m, d, dt in
             [(4, 960, torch.float32), (256, 16384, torch.bfloat16), (8, 65536, torch.float32)]]
    s = torch.tensor(0.02, device=cuda_device)
    z = torch.tensor(128.0, device=cuda_device)
    for (x, g), m in cases:
        norm_and_quantize(x, g, 0.02, 128, block_m=m)
    torch.cuda.synchronize()

    def calls():
        for (x, g), m in cases:
            norm_and_quantize(x, g, 0.02, 128, block_m=m)
            norm_and_quantize(x, g, s, z, block_m=m)

    events = traced_kernels(complete_trace(calls).key_averages())
    assert sum(e.count for e in events if "quant_rmsnorm_" in e.key) == 2 * len(cases)
    assert sum(e.count for e in events) == 2 * len(cases), [e.key for e in events]
