"""Card tests of the captured decode programs: ``GenerationEngine.generate``
and the paged decode chunk replay one captured step (a CUDA graph) through
the W4A8 kernel (B1) and the paged attention kernels (B2, B3). Replays give
the eager loop's tokens, the launch counters count what each replay
launches, a decode without ``eos_id`` makes no host sync between the
prefill and the final read, and the profiler sees a replay's kernels by
name. This file imports no JAX (the card's machine has none); the CPU
parity of the same programs is ``tests/test_torch_decode_program.py``.

Run on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_decode_graph.py``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.w4a8_mm import w4a8_matmul
from repro_torch.models import transformer as T
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.serving import GenerationEngine, PagedConfig, PagedEngine, Request, SamplerConfig
from repro_torch.serving.engine import MAX_BUCKETS
from repro_torch.serving.graphs import count_kernels, graph_contents
from test_torch_trace import complete_trace, traced_kernels

GREEDY = SamplerConfig(temperature=0.0)
PAGED = dict(block_size=8, num_blocks=24, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda_device):
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    return pack_decode_params(T.init_model(cfg, 0, device=cuda_device))


def _prompts(b=3, s=8, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(np.int32)


def _sites(model) -> int:
    return 7 * model.cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_captured_generate_equals_eager(model, sampled):
    """The capturing call, a replaying call and a fresh engine give the
    eager host loop's tokens, greedy and sampled with an EOS."""
    prompts = _prompts()
    sampler = GREEDY
    if sampled:
        eos = int(GenerationEngine(model, sampler=GREEDY).generate(prompts, 12)[0, 10])
        sampler = SamplerConfig(temperature=1.0, eos_id=eos, seed=3)
    eng = GenerationEngine(model, sampler=sampler)
    first = eng.generate(prompts, 12)
    (bucket,) = eng._buckets.values()
    assert bucket.program.graph is not None and eng.gen_traces == 1
    np.testing.assert_array_equal(first, eng.generate_host_loop(prompts, 12))
    np.testing.assert_array_equal(eng.generate(prompts, 12), first)
    np.testing.assert_array_equal(GenerationEngine(model, sampler=sampler).generate(
        prompts, 12), first)


@pytest.mark.cuda
def test_counters_count_every_replay(model):
    """B1's counter rises by 7 sites x layers a forward, for the capturing
    call (prefill, the real warm-up step, replays) and a replaying one."""
    prompts, max_new = _prompts(), 10
    eng = GenerationEngine(model, sampler=GREEDY)
    for call in range(2):
        before = w4a8_matmul.launches
        eng.generate(prompts, max_new)
        assert w4a8_matmul.launches - before == _sites(model) * max_new
    (bucket,) = eng._buckets.values()
    assert bucket.program.rise[0] == _sites(model)
    assert bucket.program.rise == count_kernels(graph_contents(bucket.program.graph)[1])
    assert bucket.program.replays == (max_new - 2) + (max_new - 1)


@pytest.mark.cuda
def test_evicted_bucket_frees_its_graph_and_caches(model):
    """A bucket pushed out by MAX_BUCKETS newer ones resets its graph (whose
    pool goes back to the allocator) and its caches are freed at once, with
    no garbage collection."""
    prompts = _prompts()
    eng = GenerationEngine(model, sampler=GREEDY)
    eng.generate(prompts, 8)
    (bucket,) = eng._buckets.values()
    program, cache = bucket.program, weakref.ref(bucket.caches[0]["k"])
    del bucket
    gc.disable()
    try:
        for n in range(MAX_BUCKETS):
            eng.generate(prompts[:2], 4 + n)
        assert cache() is None
    finally:
        gc.enable()
    assert program.graph is None and len(eng._buckets) == MAX_BUCKETS


@pytest.mark.cuda
def test_no_host_sync_between_prefill_and_final_read(model):
    """Without eos_id, a generate's decode (every replay) runs under
    ``set_sync_debug_mode("error")``: no host sync until the token read."""
    prompts = _prompts()
    eng = GenerationEngine(model, sampler=GREEDY)
    want = eng.generate(prompts, 12)  # captures the bucket's step
    decode = eng._decode

    def guarded(bucket, n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(bucket, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng._decode = guarded
    np.testing.assert_array_equal(eng.generate(prompts, 12), want)


@pytest.mark.cuda
def test_profiler_sees_a_replay_kernel_by_kernel(model):
    """One replay's trace is complete with the graph's device nodes, and
    holds 7 x layers w4a8 kernels by name."""
    prompts = _prompts()
    eng = GenerationEngine(model, sampler=GREEDY)
    eng.generate(prompts, 8)
    (bucket,) = eng._buckets.values()
    with torch.inference_mode():
        eng._start(bucket, torch.as_tensor(prompts, device="cuda"))
        prof = complete_trace(lambda: bucket.program.run(1),
                              graph_ops=bucket.program.device_ops)
    seen = sum(e.count for e in traced_kernels(prof.key_averages())
               if "w4a8_kernel" in e.key)
    assert seen == _sites(model)
    assert bucket.program.device_ops > seen


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_paged_replay_equals_eager_chunk(model, kv_dtype):
    """A mid-flight trace through the captured step and through the eager
    loop of the same step: equal streams, allocator digests and B3
    watermarks; B2/B3 launch once a layer a step, B1 7 x layers a forward."""
    rng = np.random.default_rng(2)
    specs = [(u, rng.integers(0, 128, size=int(rng.integers(3, 20))), int(rng.integers(2, 12)))
             for u in range(6)]
    runs = []
    for eager in (False, True):
        eng = PagedEngine(model, None, PagedConfig(**{**PAGED, "kv_dtype": kv_dtype}), GREEDY,
                          assert_bounds=kv_dtype == "int8")
        if eager:
            chunk = eng._chunk
            eng._chunk = lambda k: chunk(k, eager=True)
        attn = "launches" if kv_dtype == "act" else "int8_launches"
        b1, b2 = w4a8_matmul.launches, getattr(paged_decode_attention, attn)
        out = eng.serve([Request(uid=u, prompt=p, max_new=n) for u, p, n in specs])
        assert getattr(paged_decode_attention, attn) - b2 == model.cfg.n_layers * eng.decode_steps
        forwards = eng.decode_steps + eng.admits + eng.suffix_admits
        assert w4a8_matmul.launches - b1 == _sites(model) * forwards
        assert eng.pool_state.free_top == 0 and int(eng.cache["free_top"]) == 0
        runs.append((out, eng.pool_state.digest(), getattr(eng, "watermark_values", None)))
    (a, da, wa), (b, db, wb) = runs
    assert set(a) == set(b) and da == db and wa == wb
    for u in a:
        np.testing.assert_array_equal(a[u], b[u])


@pytest.mark.cuda
def test_assert_inner_is_refused_under_capture(cuda_device):
    """``assert_inner`` reads a scalar to the host: inside a capture it
    raises instead of breaking the graph."""
    from repro_torch.kernels.w4a8_mm import pack_int4

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 256, size=(4, 64)).astype(np.uint8), device=cuda_device)
    w = pack_int4(torch.as_tensor(rng.integers(-7, 8, size=(64, 32)).astype(np.int8),
                                  device=cuda_device))
    scale = torch.ones(32, device=cuda_device)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        w4a8_matmul(x, w, scale, 0.1, 3.0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="captured CUDA graph"):
        with torch.cuda.graph(graph, stream=stream):
            w4a8_matmul(x, w, scale, 0.1, 3.0, assert_inner=True)
    torch.cuda.synchronize()
