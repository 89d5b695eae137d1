"""Card tests of the serving observers inside the captured decode step:
the taps of ``PagedEngine(observe=True)`` write the engine's device
counter block from within the CUDA graph that every chunk replays. A
replayed observing step counts what eager observing steps count, the fold
zeroes the block in place at the address the graph writes, the capture's
check (kernels counted by name equal the counters' rise) holds with the
taps inside, and the transparency check passes on the graph's kernel
nodes. This file imports no JAX (the card's machine has none); the CPU
parity with the reference is ``tests/test_torch_saturation.py``.

Run on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_observe_graph.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.w4a8_mm import w4a8_matmul
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear
from repro_torch.quant.observe import SaturationCounters
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.serving import PagedConfig, PagedEngine, Request, SamplerConfig
from repro_torch.serving.graphs import count_kernels

PAGED = dict(block_size=8, num_blocks=24, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)


@pytest.fixture
def cuda_device():
    """The card: CUDA graphs and the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda_device):
    """smollm-360m's smoke cut to 2 layers, RTN-packed, every site given a
    static activation quantizer narrow enough that decode traffic clips."""
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    model = pack_decode_params(T.init_model(cfg, 0, device=cuda_device))
    for block in model.layers:
        for comp in (block.mixer, block.ffn):
            for site in comp.children():
                if isinstance(site, PackedLinear):
                    site.spec = dataclasses.replace(site.spec, static_act=True)
                    site.act_scale = torch.tensor(0.004, device=cuda_device)
                    site.act_zp = torch.tensor(128.0, device=cuda_device)
    return model


def _engine(model, **kw):
    return PagedEngine(model, None, PagedConfig(**PAGED, kv_dtype="int8"),
                       SamplerConfig(temperature=0.0), device="cuda", **kw)


def _reqs(seed=0):
    prompts = np.random.default_rng(seed).integers(0, 128, size=(3, 8)).astype(np.int32)
    return [Request(uid=u, prompt=p, max_new=n) for u, (p, n) in enumerate(zip(prompts,
                                                                               (9, 6, 11)))]


@pytest.mark.cuda
def test_replayed_observing_step_counts_as_eager_steps(model):
    """Chunks replaying the captured observing step give the eager
    observing steps' streams and, folded, the same counter rows: calls,
    clips and code extrema, exactly."""
    replayed, eager = _engine(model, observe=True), _engine(model, observe=True)
    eager._chunk = lambda k: PagedEngine._chunk(eager, k, eager=True)
    got, want = replayed.serve(_reqs()), eager.serve(_reqs())
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert replayed._program.graph is not None and eager._program.graph is None
    assert replayed.decode_steps == eager.decode_steps
    rep, ref = replayed.saturation_report(), eager.saturation_report()
    assert rep == ref
    for sec in rep["sites"].values():
        assert sec["n_calls"] == model.cfg.n_layers * replayed.decode_steps
        assert 0 < sec["clip_count"] <= sec["clip_total"]


@pytest.mark.cuda
def test_fold_zeroes_the_block_in_place(model):
    """The block the graph writes is the one the engine made: after a
    serve's fold it sits zeroed at the same address, and a second serve's
    replays count into it again, twice the first serve's totals."""
    eng = _engine(model, observe=True)
    block = eng.observer.block
    ptr = block.buf.data_ptr()
    eng.serve(_reqs())
    first = eng.saturation_report()["sites"]
    assert eng.observer.block is block and block.buf.data_ptr() == ptr
    assert torch.equal(block.buf, block._empty)
    eng.serve(_reqs())
    assert eng.chunk_traces == 1
    for label, sec in eng.saturation_report()["sites"].items():
        assert sec["n_calls"] == 2 * first[label]["n_calls"]
        assert sec["clip_count"] == 2 * first[label]["clip_count"]


@pytest.mark.cuda
def test_capture_check_holds_with_the_taps_inside(model):
    """The observing step's capture counts its kernels by name equal to the
    wrappers' rise (the capture raises otherwise): B1 7 a layer, B3 1 a
    layer, as the plain step's; a replay adds exactly that; the replays
    make no host sync; the transparency check passes on the graph's kernel
    nodes, and a throwaway observing program launches the same kernels."""
    plain, eng = _engine(model), _engine(model, observe=True)
    plain.serve(_reqs())
    eng.serve(_reqs())
    n_layers = model.cfg.n_layers
    rise = dict(zip(("b1", "b3"), (eng._program.rise[0], eng._program.rise[5])))
    assert rise == {"b1": 7 * n_layers, "b3": n_layers}
    assert eng._program.rise == plain._program.rise == count_kernels(eng._program.names)
    assert eng._program.device_ops > plain._program.device_ops
    b1, b3 = w4a8_matmul.launches, paged_decode_attention.int8_launches
    eng._buf.zero_()
    eng._col.zero_()  # a chunk's start: the replays write token columns 0-2
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._program.run(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (w4a8_matmul.launches - b1, paged_decode_attention.int8_launches - b3) == (
        3 * rise["b1"], 3 * rise["b3"])
    eng.assert_observation_transparent()
    probe = SaturationCounters()
    tapped = eng.decode_step_program(probe)
    assert count_kernels(tapped.nodes) == count_kernels(plain.decode_step_program().nodes)
    assert tapped.device_ops == eng._program.device_ops
