"""Port parity of the paged engine's throughput loop (any non-default
``SchedulerPolicy``: windowed and batched admission, chunked prefill,
watermark growth and preemption): the reference's throughput tests
(tests/test_paged_engine.py ``test_throughput_*``) run on the port, with
the reference's throughput engine served live on the same numpy inputs.
Greedy tokens must be identical to the reference's and to the port's FIFO
engine, the allocator digests equal, every page back on the free list and
the pool invariants true after every transition. A packed rung (RTN in
both packages) must equal the reference's throughput engine.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.models.layers import use_packed_backend as j_backend
from repro.models.transformer import init_model as j_init_model
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.serving import Request as JRequest
from repro.serving import SchedulerPolicy as JPolicy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.serving import Request, SchedulerPolicy
from test_torch_paged_engine import (
    _assert_pool_invariants,
    _assert_same,
    _jpaged,
    _pair,
    _paged,
    _train_briefly,
)

THROUGHPUT = dict(admit_window=4, batch_max=3, prefill_chunk=16)


@pytest.fixture(scope="module")
def rung():
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    return _pair(j_init_model(jax.random.key(0), jcfg))


@pytest.fixture(scope="module")
def trained_rung():
    return _pair(_train_briefly(j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)))


def _specs(rng, rows):
    return [(u, rng.integers(0, 128, size=s0).astype(np.int32), n, p)
            for u, (s0, n, p) in enumerate(rows)]


def _reqs(mod, specs):
    return [mod(uid=u, prompt=p.copy(), max_new=n, priority=pr) for u, p, n, pr in specs]


def _three_ways(jcfg, jparams, model, specs, fifo_kw, thr_kw, policy, backend=None):
    """The same trace through the reference's throughput engine, the
    port's FIFO engine and the port's throughput engine (probed after
    every transition). Returns (reference, FIFO, throughput results, the
    two throughput engines)."""
    jeng = _jpaged(jcfg, jparams, **thr_kw, sched=JPolicy(**policy))
    if backend is None:
        want = jeng.serve(_reqs(JRequest, specs))
    else:
        with j_backend(backend):
            want = jeng.serve(_reqs(JRequest, specs))
    fifo = _paged(model, **fifo_kw).serve(_reqs(Request, specs))
    eng = _paged(model, **thr_kw, sched=SchedulerPolicy(**policy))
    got = eng.serve(_reqs(Request, specs), _probe=_assert_pool_invariants)
    _assert_same(got, want)
    assert eng.pool_state.digest() == jeng.pool_state.digest()
    held = 0 if eng.prefix_cache is None else len(eng.prefix_cache.nodes)  # cached pages stay
    assert eng.pool_state.free_top == held and int(eng.cache["free_top"]) == held
    assert int(eng.cache["page_refcounts"].sum()) == held
    assert eng.chunk_traces == 1
    return want, fifo, got, jeng, eng


def test_throughput_policy_matches_reference_and_fifo(rung):
    """Windowed batched admission, stub admits and chunked prefill between
    decode chunks: streams identical to the reference's throughput engine
    and to FIFO, and each new program ran."""
    jcfg, cfg, jparams, model = rung
    specs = _specs(np.random.default_rng(7), [(8, 6, 0), (8, 4, 1), (24, 6, 0), (8, 5, 0),
                                              (16, 4, 1), (8, 3, 0)])
    kw = dict(max_concurrency=4, num_blocks=24, max_pages_per_seq=4)
    _, fifo, got, jeng, eng = _three_ways(jcfg, jparams, model, specs, kw, kw, THROUGHPUT)
    _assert_same(got, fifo)
    assert jeng.batch_traces >= 1 and jeng.stub_traces >= 1 and jeng.prefill_chunk_traces >= 1
    assert eng.batch_admits >= 1 and eng.stub_admits >= 1 and eng.prefill_chunks >= 1
    assert eng.admits + eng.batch_admits >= 2


@pytest.mark.parametrize("kv_dtype,weights", [("act", "rung"), ("int8", "trained_rung")])
def test_throughput_preemption_matches_reference_and_fifo(request, kv_dtype, weights):
    """Watermark admission over-commits a 6-page pool; decode growth
    preempts the lowest-priority youngest request, which restarts from
    step 0: streams identical to the reference's and to an uninterrupted
    FIFO run, float and int8 pages alike. The int8 case runs on the trained
    rung, as the port's other int8 goldens: on the random one a top-2 gap
    of 0.0036 at the last step of this trace lies inside the int8 page
    noise between the packages, FIFO alone included."""
    jcfg, cfg, jparams, model = request.getfixturevalue(weights)
    specs = _specs(np.random.default_rng(9), [(8, 24, 0), (8, 24, 1), (8, 24, 1)])
    fifo_kw = dict(max_concurrency=3, num_blocks=16, max_pages_per_seq=4, kv_dtype=kv_dtype)
    thr_kw = dict(max_concurrency=3, num_blocks=6, max_pages_per_seq=4, kv_dtype=kv_dtype)
    _, fifo, got, jeng, eng = _three_ways(jcfg, jparams, model, specs, fifo_kw, thr_kw,
                                          dict(admit_window=2, watermark=(1, 4)))
    _assert_same(got, fifo)
    assert eng.preemptions == jeng.preemptions >= 1, "pool pressure never preempted"
    assert eng.grows >= 1 and eng.releases >= 3 + eng.preemptions


def test_throughput_prefix_cache_identity(trained_rung):
    """Cache hits keep their B=1 programs (suffix, fully cached) beside
    batched and chunked admits; the long cold prompt's cache insert waits
    for its final chunk: streams identical to the reference's and to a
    cold FIFO engine."""
    jcfg, cfg, jparams, model = trained_rung
    rng = np.random.default_rng(11)
    system = rng.integers(0, 128, size=16).astype(np.int32)

    def mk(uid, tail, n, p=0):
        prompt = np.concatenate([system, rng.integers(0, 128, size=tail).astype(np.int32)])
        return uid, prompt, n, p

    specs = [mk(0, 8, 6), mk(1, 8, 4), mk(2, 0, 4),
             (3, rng.integers(0, 128, size=24).astype(np.int32), 5, 0), mk(4, 4, 4, p=1)]
    fifo_kw = dict(max_concurrency=3, num_blocks=24, max_pages_per_seq=4)
    thr_kw = dict(fifo_kw, prefix_cache=True)
    _, fifo, got, jeng, eng = _three_ways(jcfg, jparams, model, specs, fifo_kw, thr_kw,
                                          THROUGHPUT)
    _assert_same(got, fifo)
    assert eng.suffix_admits + eng.cached_admits >= 1 and eng.prefill_chunks >= 1
    assert eng.stub_admits >= 1
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()


def test_throughput_packed_matches_reference(rung):
    """The rung RTN-packed in both packages: the batched admit's padded
    prefill and the chunks quantize their activations per tensor, as the
    reference does, and the streams equal the reference's throughput
    engine (its Pallas kernel in interpret mode; B1's plain version here)."""
    jcfg, cfg, jparams, model = rung
    specs = _specs(np.random.default_rng(7), [(8, 4, 0), (12, 3, 0), (24, 4, 0), (5, 3, 0)])
    kw = dict(max_concurrency=3, num_blocks=16, max_pages_per_seq=4)
    _, _, _, jeng, eng = _three_ways(jcfg, j_pack(jparams, jcfg), pack_decode_params(model),
                                     specs, kw, kw, THROUGHPUT, backend="interpret")
    assert eng.batch_admits >= 1 and eng.prefill_chunks >= 1


def test_throughput_policy_gates(rung):
    """Chunks must scatter whole pages and the high watermark must be
    reachable; batched or chunked admission and the prefix cache refuse a
    pattern that is not attention-only and MoE-free, here on built engines
    (tiny-hybrid: Mamba + MLP and attention + MoE; tiny-xlstm), which the
    FIFO policy serves."""
    _, cfg, _, model = rung
    with pytest.raises(ValueError, match="multiple of"):
        _paged(model, sched=SchedulerPolicy(prefill_chunk=12))
    with pytest.raises(ValueError, match="admission could never resume"):
        _paged(model, num_blocks=4, sched=SchedulerPolicy(watermark=(1, 8)))
    hybrid = T.init_model(get_config("tiny-hybrid"), device="cpu")
    xlstm = T.init_model(get_config("tiny-xlstm"), device="cpu")
    moe = T.init_model(get_config("tiny-moe"), device="cpu")
    with pytest.raises(ValueError, match="MoE-free"):
        _paged(moe, sched=SchedulerPolicy(batch_max=2))
    for recurrent in (hybrid, xlstm):
        with pytest.raises(ValueError, match="attention-only"):
            _paged(recurrent, sched=SchedulerPolicy(prefill_chunk=8))
        with pytest.raises(ValueError, match="attention-only"):
            _paged(recurrent, sched=SchedulerPolicy(batch_max=2))
        with pytest.raises(ValueError, match="attention-only"):
            _paged(recurrent, prefix_cache=True)
        assert _paged(recurrent).generate(np.zeros((1, 8), np.int32), 2).shape == (1, 10)
    _paged(moe, sched=SchedulerPolicy(admit_window=2))


def test_serve_launcher_throughput_flags(capsys):
    """The four policy flags reach the paged engine and its line; without
    ``--paged``, or with a bad policy, the launcher exits."""
    out = serve.main(["--arch", "smollm-360m", "--smoke", "--packed", "--paged",
                      "--admit-batch", "2", "--prefill-chunk", "16", "--block-size", "8",
                      "--batch", "2", "--prompt-len", "24", "--max-new", "4", "--device", "cpu"])
    assert out.shape == (2, 28)
    line = next(ln for ln in capsys.readouterr().out.splitlines() if "paged engine:" in ln)
    assert "policy=(window=1 batch=2 chunk=16 watermark=None)" in line
    with pytest.raises(SystemExit, match="paged engine only"):
        serve.main(["--arch", "smollm-360m", "--smoke", "--admit-batch", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="scheduler policy"):
        serve.main(["--arch", "smollm-360m", "--smoke", "--paged", "--watermark", "4", "1",
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="multiple of"):
        serve.main(["--arch", "smollm-360m", "--smoke", "--paged", "--block-size", "8",
                    "--prefill-chunk", "12", "--device", "cpu"])
