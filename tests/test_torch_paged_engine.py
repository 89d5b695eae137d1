"""Port parity of the paged continuous-batching engine: the port's
``PagedEngine`` (plain versions of the attention kernels on the CPU)
against the reference's ``PagedEngine`` (gather attention) and the port's
fixed-slot ``GenerationEngine`` on the same traces: greedy tokens
identical and ``PoolState.digest()`` equal. The int8-KV and prefix-cache
goldens run on the reference's briefly trained rung (its greedy gaps dwarf
the int8 page noise), carried across with ``params_from_numpy``. The
cached admit is checked free of matmuls in torch terms, and sampled
streams for independence from co-batched traffic.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke as j_get_smoke
from repro.models.transformer import init_model as j_init_model
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro_torch.configs import get_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.launch.mesh import make_mesh
from repro_torch.kernels.w4a8_mm import w4a8_matmul
from repro_torch.quant.spec import AttnDatapathSpec, DatapathMismatchError
from repro_torch.serving import (
    GenerationEngine,
    PagedConfig,
    PagedEngine,
    Request,
    SamplerConfig,
    SchedulerPolicy,
    ServeMetrics,
)

GREEDY = SamplerConfig(temperature=0.0)
BASE = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)


def _train_briefly(cfg, steps=250, lr=2e-3):
    """The reference engine tests' trained rung (tests/test_paged_engine.py)."""
    from repro.data import DataConfig, TokenBatcher
    from repro.optim import OptimizerConfig
    from repro.runtime.steps import TrainRunConfig, init_train_state, make_train_step

    run = TrainRunConfig(optimizer=OptimizerConfig(lr=lr, warmup_steps=10, total_steps=steps))
    state = init_train_state(jax.random.key(0), cfg, run)
    step = jax.jit(make_train_step(cfg, run), donate_argnums=(0,))
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=7))
    for i in range(steps):
        state, _ = step(state, jax.tree.map(jnp.asarray, data.batch(i)))
    return state["params"]


def _pair(jparams):
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                 device="cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    prompts = np.random.default_rng(0).integers(0, 128, size=(3, 8)).astype(np.int32)
    return (*_pair(j_init_model(jax.random.key(0), jcfg)), prompts)


@pytest.fixture(scope="module")
def trained():
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    return _pair(_train_briefly(jcfg))


def _paged(model, sampler=GREEDY, attn_datapath=None, **kw):
    return PagedEngine(model, None, PagedConfig(**{**BASE, **kw}), sampler,
                       attn_datapath=attn_datapath, device="cpu")


def _jpaged(jcfg, jparams, sampler=JSampler(temperature=0.0), **kw):
    return JPagedEngine(jparams, jcfg, JPagedConfig(**{**BASE, "attn_impl": "ref", **kw}),
                        sampler)


def _reqs(mod, specs):
    return [mod(uid=u, prompt=np.asarray(p, np.int32), max_new=n) for u, p, n in specs]


def _assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def _assert_pool_invariants(eng, sched):
    """The cache's allocator leaves mirror the host PoolState; live rows,
    cached pages and the free stack partition the pool, counted with
    refcounts; idle rows never hold a live page they could write."""
    nb = eng.paged.num_blocks
    table = eng.cache["block_table"].numpy()
    top = int(eng.cache["free_top"])
    rc = np.zeros(nb, np.int64)
    for slot, a in sched.active.items():
        row = table[slot][:a.n_pages]
        assert ((0 <= row) & (row < nb)).all() and len(set(row.tolist())) == row.size
        np.testing.assert_array_equal(np.sort(row), np.sort(a.row))
        np.add.at(rc, row, 1)
    if eng.prefix_cache is not None:
        for node in eng.prefix_cache.nodes.values():
            rc[node.page] += 1
    np.testing.assert_array_equal(eng.cache["page_refcounts"].numpy(), rc)
    np.testing.assert_array_equal(eng.pool_state.page_rc, rc)
    free = eng.cache["free_list"].numpy()[top:].tolist()
    assert len(set(free)) == len(free) and set(free) == set(np.flatnonzero(rc == 0).tolist())
    assert top == eng.pool_state.free_top == int((rc > 0).sum())
    np.testing.assert_array_equal(eng.cache["free_list"].numpy(), eng.pool_state.free_list)
    active = eng.cache["active"].numpy()
    assert set(np.flatnonzero(active).tolist()) <= set(sched.active)


def _serve_checked(eng, reqs, late_reqs=()):
    late = list(late_reqs)

    def inject(sched, chunk_idx):
        if late:
            sched.submit(late.pop())

    return eng.serve(reqs, _probe=_assert_pool_invariants, _late=inject)


def _jax_serve(eng, reqs, late_reqs=()):
    late = list(late_reqs)

    def inject(sched, chunk_idx):
        if late:
            sched.submit(late.pop())

    return eng.serve(reqs, _late=inject)


# ---------------------------------------------------------------------------
# Greedy goldens, float KV
# ---------------------------------------------------------------------------
def test_greedy_matches_reference_and_fixed_slot(setup):
    jcfg, cfg, jparams, model, prompts = setup
    jeng = _jpaged(jcfg, jparams)
    want = jeng.generate(prompts, 8)
    eng = _paged(model)
    out = eng.generate(prompts, 8)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        out, GenerationEngine(model, sampler=GREEDY, device="cpu").generate(prompts, 8))
    assert eng.pool_state.digest() == jeng.pool_state.digest()
    assert (eng.admits, eng.releases) == (3, 3) and eng.decode_steps == 7


def test_mid_flight_admission_and_stall(setup):
    """Two slots for three requests (uid 2 admits into freed pages), and a
    pool too small for two requests at once (admission stalls): tokens and
    the allocator equal the reference's."""
    jcfg, cfg, jparams, model, _ = setup
    rng = np.random.default_rng(1)
    specs = [(0, rng.integers(0, 128, size=8), 8), (1, rng.integers(0, 128, size=4), 12),
             (2, rng.integers(0, 128, size=12), 4)]
    for kw in (dict(max_concurrency=2, num_blocks=8, max_pages_per_seq=2, chunk_max=3),
               dict(max_concurrency=3, num_blocks=3, max_pages_per_seq=2, chunk_max=4)):
        jeng = _jpaged(jcfg, jparams, **kw)
        want = jeng.serve(_reqs(JRequest, specs))
        eng = _paged(model, **kw)
        _assert_same(_serve_checked(eng, _reqs(Request, specs)), want)
        assert eng.pool_state.digest() == jeng.pool_state.digest()
        assert eng.pool_state.free_top == 0 and int(eng.cache["free_top"]) == 0
        assert eng.chunk_traces == 1 < eng.chunks  # one decode-step program
        for uid, prompt, n in specs:  # each alone in the fixed-slot engine
            alone = GenerationEngine(model, sampler=GREEDY, device="cpu").generate(
                np.asarray(prompt, np.int32)[None], n)[0]
            np.testing.assert_array_equal(want[uid], alone)


@pytest.mark.parametrize("max_new", [8, 9, 10])
def test_sequence_filling_last_block_exactly(setup, max_new):
    """S0 = 8, block 8: max_new 9 fills exactly two pages; 8 and 10 bracket."""
    jcfg, cfg, jparams, model, prompts = setup
    kw = dict(max_concurrency=1)
    want = _jpaged(jcfg, jparams, **kw).generate(prompts[:1], max_new)
    np.testing.assert_array_equal(_paged(model, **kw).generate(prompts[:1], max_new), want)


def test_free_list_reuse_after_early_eos(setup):
    jcfg, cfg, jparams, model, prompts = setup
    probe = GenerationEngine(model, sampler=GREEDY, device="cpu").generate(prompts, 8)
    eos = int(probe[0, prompts.shape[1] + 2])
    rng = np.random.default_rng(3)
    specs = [(0, prompts[0], 8), (1, rng.integers(0, 128, size=8), 8)]
    kw = dict(max_concurrency=1, num_blocks=2, max_pages_per_seq=2)
    jeng = _jpaged(jcfg, jparams, JSampler(temperature=0.0, eos_id=eos), **kw)
    want = jeng.serve(_reqs(JRequest, specs))
    eng = _paged(model, SamplerConfig(temperature=0.0, eos_id=eos), **kw)
    got = _serve_checked(eng, _reqs(Request, specs))
    _assert_same(got, want)
    assert got[0][-1] == eos and got[0].size < prompts.shape[1] + 8
    assert eng.pool_state.digest() == jeng.pool_state.digest()


def test_duplicate_inflight_uid_refused(setup):
    _, _, _, model, _ = setup
    eng = _paged(model)
    prompt = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="already in flight"):
        eng.serve([Request(uid=7, prompt=prompt, max_new=2),
                   Request(uid=7, prompt=prompt, max_new=2)])
    eng.serve([Request(uid=7, prompt=prompt, max_new=2)])
    assert eng.serve([Request(uid=7, prompt=prompt, max_new=2)])[7].size == 10


@pytest.mark.parametrize("seed,kv_dtype", [(0, "act"), (1, "int8"), (2, "act")])
def test_randomized_trace_matches_reference(setup, seed, kv_dtype):
    """Random lengths around page boundaries into a 4-page pool (stalls and
    reuse), late arrivals injected after decode chunks: the pool invariants
    hold after every transition and tokens and digest equal the reference's."""
    jcfg, cfg, jparams, model, _ = setup
    r = random.Random(seed)
    specs = [(uid, r.choices(range(cfg.vocab), k=r.choice([3, 8, 9])), r.choice([1, 4, 8]))
             for uid in range(5)]
    kw = dict(max_concurrency=2, num_blocks=4, max_pages_per_seq=3, chunk_max=3,
              kv_dtype=kv_dtype)
    jeng = _jpaged(jcfg, jparams, **kw)
    jreqs = _reqs(JRequest, specs)
    want = _jax_serve(jeng, jreqs[:3], jreqs[3:])
    eng = _paged(model, **kw)
    preqs = _reqs(Request, specs)
    got = _serve_checked(eng, preqs[:3], preqs[3:])
    _assert_same(got, want)
    assert eng.pool_state.digest() == jeng.pool_state.digest()
    assert eng.pool_state.free_top == 0
    for uid, prompt, n in specs:
        assert got[uid].size == len(prompt) + n


# ---------------------------------------------------------------------------
# int8 KV pages and the prefix cache, on the trained rung
# ---------------------------------------------------------------------------
def test_int8_greedy_matches_float_and_reference(trained):
    jcfg, cfg, jparams, model = trained
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8)).astype(np.int32)
    ref = _paged(model).generate(prompts, 8)
    eng = PagedEngine(model, None, PagedConfig(**BASE, kv_dtype="int8"), GREEDY,
                      device="cpu", assert_bounds=True)
    np.testing.assert_array_equal(eng.generate(prompts, 8), ref)
    qk, pv = eng.watermark_values
    assert 0 < qk <= 2 ** (eng.attn_spec.p_qk - 1) - 1 and 0 < pv <= 2 ** (eng.attn_spec.p_pv - 1) - 1
    np.testing.assert_array_equal(_jpaged(jcfg, jparams, kv_dtype="int8").generate(prompts, 8),
                                  ref)
    np.testing.assert_array_equal(
        _paged(model, kv_dtype="int8", attn_impl="reference").generate(prompts, 8), ref)


def _system_prompt_mix(vocab, seed=5):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=16)  # two blocks
    return [(0, np.concatenate([system, rng.integers(0, vocab, size=5)]), 6),
            (1, system.copy(), 6),  # fully cached
            (2, np.concatenate([system, rng.integers(0, vocab, size=3)]), 6),
            (3, rng.integers(0, vocab, size=12), 6)]  # unrelated: cold


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_prefix_cache_warm_vs_cold(trained, kv_dtype):
    """A shared-system-prompt mix through the prefix cache (cold insert,
    suffix prefill, fully cached with a CoW tail), served twice on the warm
    engine: tokens equal the cold engine's and the reference's warm engine,
    with the same allocator digest."""
    jcfg, cfg, jparams, model = trained
    specs = _system_prompt_mix(cfg.vocab)
    cold = _paged(model, kv_dtype=kv_dtype).serve(_reqs(Request, specs))
    jeng = _jpaged(jcfg, jparams, kv_dtype=kv_dtype, prefix_cache=True)
    eng = _paged(model, kv_dtype=kv_dtype, prefix_cache=True)
    for _ in range(2):
        want = jeng.serve(_reqs(JRequest, specs))
        got = _serve_checked(eng, _reqs(Request, specs))
        _assert_same(got, want)
        _assert_same(got, cold)
        assert eng.pool_state.digest() == jeng.pool_state.digest()
    assert eng.admits >= 1 and eng.suffix_admits >= 1 and eng.cached_admits >= 1
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_prefix_cache_eviction_recycles_shared_pages(trained, kv_dtype):
    """Three system prompts compete for a 6-page pool, so admissions evict
    cold cache entries and land on recycled shared pages, late arrivals
    included: tokens equal the cold engine's, digest the reference's."""
    jcfg, cfg, jparams, model = trained
    rng = np.random.default_rng(6)
    systems = [rng.integers(0, cfg.vocab, size=16) for _ in range(3)]
    specs = [(uid, np.concatenate([systems[uid % 3],
                                   rng.integers(0, cfg.vocab, size=int(rng.integers(0, 4)))]),
              int(rng.integers(1, 6))) for uid in range(7)]
    kw = dict(num_blocks=6, max_concurrency=2, max_pages_per_seq=3, chunk_max=3,
              kv_dtype=kv_dtype)
    cold = _paged(model, **kw).serve(_reqs(Request, specs))
    jeng = _jpaged(jcfg, jparams, prefix_cache=True, **kw)
    jreqs = _reqs(JRequest, specs)
    want = _jax_serve(jeng, jreqs[:4], jreqs[4:])
    eng = _paged(model, prefix_cache=True, **kw)
    evictions = []
    orig = eng.prefix_cache.evict
    eng.prefix_cache.evict = lambda plan: (evictions.append(len(plan)), orig(plan))[1]
    preqs = _reqs(Request, specs)
    got = _serve_checked(eng, preqs[:4], preqs[4:])
    _assert_same(got, want)
    _assert_same(got, cold)
    assert evictions, "pool pressure must evict cache entries"
    assert eng.pool_state.digest() == jeng.pool_state.digest()


class _MatmulCounter(TorchDispatchMode):
    """Counts the matrix products dispatched inside the mode."""

    OPS = {"mm", "addmm", "bmm", "baddbmm", "matmul", "mv", "dot", "linear", "_int_mm",
           "einsum"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.count += 1
        return func(*args, **(kwargs or {}))


class _NoModel:
    def __getattr__(self, name):
        raise AssertionError(f"the cached admit touched the model ({name})")


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_cached_admit_runs_no_matmul_and_takes_no_model(setup, kv_dtype):
    """Admitting a fully cached prompt runs no matrix product (counted by a
    TorchDispatchMode), reads nothing of the model and launches no kernel;
    a cold admit under the same counter does run matmuls."""
    _, _, _, model, _ = setup
    eng = _paged(model, prefix_cache=True, kv_dtype=kv_dtype)
    seen = {}

    def counted(name, fn, hide_model):
        def wrapper(adm):
            kept = eng.model
            if hide_model:
                eng.model = _NoModel()
            launches = (w4a8_matmul.launches, paged_decode_attention.launches,
                        paged_decode_attention.int8_launches)
            try:
                with _MatmulCounter() as mc:
                    out = fn(adm)
            finally:
                eng.model = kept
            after = (w4a8_matmul.launches, paged_decode_attention.launches,
                     paged_decode_attention.int8_launches)
            seen.setdefault(name, []).append((mc.count, after == launches))
            return out
        return wrapper

    eng._admit_cached = counted("cached", eng._admit_cached, True)
    eng._admit = counted("cold", eng._admit, False)
    prompt = np.random.default_rng(8).integers(0, 128, size=8).astype(np.int32)
    first = eng.serve([Request(uid=0, prompt=prompt, max_new=4)])
    second = eng.serve([Request(uid=1, prompt=prompt.copy(), max_new=4)])
    np.testing.assert_array_equal(first[0], second[1])
    assert seen["cached"] == [(0, True)]
    assert seen["cold"][0][0] > 0
    assert eng.cached_admits == 1 and eng.suffix_admits == 0


def test_sampled_stream_alone_equals_co_batched(setup):
    """A request's sampled tokens depend on (seed, uid, step) only."""
    _, _, _, model, prompts = setup
    samp = SamplerConfig(temperature=1.0, seed=7)
    alone = _paged(model, samp, max_concurrency=1).serve(
        [Request(uid=5, prompt=prompts[0], max_new=8)])
    batched = _paged(model, samp).serve(
        [Request(uid=5, prompt=prompts[0], max_new=8), Request(uid=9, prompt=prompts[1], max_new=6),
         Request(uid=11, prompt=prompts[2], max_new=3)])
    np.testing.assert_array_equal(alone[5], batched[5])
    other_seed = _paged(model, SamplerConfig(temperature=1.0, seed=8), max_concurrency=1).serve(
        [Request(uid=5, prompt=prompts[0], max_new=8)])
    assert not np.array_equal(alone[5], other_seed[5])


def test_arrivals_and_metrics_leave_streams_unchanged(setup):
    """Wall-clock arrivals change when work runs, not what any stream is;
    the metrics see every request's first token and its inter-token gaps."""
    _, _, _, model, prompts = setup
    specs = [(u, prompts[u], n) for u, n in enumerate((5, 3, 4))]
    want = _paged(model).serve(_reqs(Request, specs))
    metrics = ServeMetrics()
    got = _paged(model, max_concurrency=2).serve(_reqs(Request, specs),
                                                 arrivals=[0.0, 0.0, 0.02], metrics=metrics)
    _assert_same(got, want)
    summary = metrics.summary()
    assert summary["n_requests"] == 3 and summary["ttft_p50_us"] >= 0
    with pytest.raises(ValueError, match="arrivals"):
        _paged(model).serve(_reqs(Request, specs), arrivals=[0.0])


def test_datapath_requests_and_refusals(setup):
    _, cfg, _, model, _ = setup
    spec = AttnDatapathSpec.for_cache(cfg.head_dim, 8)
    eng = _paged(model, kv_dtype="int8", attn_datapath=spec)
    assert eng.attn_spec.matches(spec) and eng.attn_spec.certify()
    with pytest.raises(DatapathMismatchError, match="attention datapath"):
        _paged(model, kv_dtype="int8", attn_datapath=AttnDatapathSpec.for_cache(cfg.head_dim, 16))
    with pytest.raises(DatapathMismatchError, match="float KV"):
        _paged(model, attn_datapath=spec)
    with pytest.raises(ValueError, match="kv_dtype"):
        _paged(model, kv_dtype="fp8")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _paged(model, attn_impl="kernel")
    with pytest.raises(ValueError, match="multiple of"):
        _paged(model, sched=SchedulerPolicy(prefill_chunk=12))
    with pytest.raises(ValueError, match="admission could never resume"):
        _paged(model, num_blocks=4, sched=SchedulerPolicy(watermark=(1, 8)))
    # mesh serving is ported (tests/test_torch_mesh_serving.py); a mesh
    # refuses the paged attention kernels before it needs any process group
    with pytest.raises(ValueError, match="reference attention"):
        PagedEngine(model, None, PagedConfig(**{**BASE, "attn_impl": "kernel"}), device="cpu",
                    mesh=make_mesh((1, 2), abstract=True))
    # the serving observers are ported (tests/test_torch_saturation.py): the
    # counter block is made with the engine, one row per packed slot site
    observed = PagedEngine(model, None, PagedConfig(**BASE), device="cpu", observe=True)
    assert observed.datapath_fingerprint == _paged(model).datapath_fingerprint + "+obs"
    assert observed.observer.block.labels == ()  # float weights: no packed site
    # static KV page scales are ported (tests/test_torch_search.py); a float
    # pool refuses them, as in the reference
    scales = np.ones((cfg.repeats, cfg.n_kv_heads), np.float32).tolist()
    kv = {"kv_bits_default": 8, "slots": {"0": {"k_scale": scales, "v_scale": scales}}}
    with pytest.raises(ValueError, match="int8"):
        PagedEngine(model, None, PagedConfig(**BASE), device="cpu", kv_scales=kv)
