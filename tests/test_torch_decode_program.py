"""Port parity of the captured decode programs, on the CPU: the decode step
at a device position, the fixed-slot ``GenerationEngine.generate`` over its
per-bucket static buffers, and the paged decode chunk's one step per
engine, against the reference's jitted programs (``repro/serving/engine.py``
``_gen_impl``, ``repro/serving/paged_engine.py`` ``_chunk_impl``) and the
port's eager host loop. On the CPU the static-buffer step runs eagerly; on
the card it is captured once and replayed (``tests/test_torch_decode_graph.py``).

Float logits are held within atol 1e-4 (f32; XLA and PyTorch sum matmuls in
different orders, so a few ulps differ), as in ``tests/test_torch_model.py``;
the caches the same step writes with an int and with a device position are
bit-equal. Token streams are identical.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.serving import GenerationEngine as JEngine
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import SamplerConfig as JSampler
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.serving import GenerationEngine, PagedConfig, PagedEngine, Request, SamplerConfig
from repro_torch.serving.engine import EOS_CHECK_EVERY, MAX_BUCKETS

ARCH = "tiny-lm-xs"
GREEDY = SamplerConfig(temperature=0.0)
#: host reads and host-built tensors a captured step may not hold
HOST_OPS = ("_local_scalar_dense", "lift_fresh", "nonzero", "item")


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def xs():
    jcfg = j_get_config(ARCH)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(_numpy_tree(jparams), get_config(ARCH), device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, size=(3, 8)).astype(np.int32)
    return jcfg, jparams, model, prompts


@pytest.fixture(scope="module")
def paged_setup():
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    model = params_from_numpy(_numpy_tree(jparams), cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 128, size=(3, 8)).astype(np.int32)
    return jcfg, jparams, model, prompts


class _HostOps(TorchDispatchMode):
    """Records every op of :data:`HOST_OPS` dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in HOST_OPS:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# The decode step at a device position
# ---------------------------------------------------------------------------
@torch.inference_mode()
def test_decode_step_at_a_device_position_matches_reference(xs):
    """Three steps at positions S, S+1, S+2 given as 0-d int32 tensors:
    logits within atol 1e-4 of the reference's, caches equal to theirs
    within the same and bit-equal to the port's own steps at int positions."""
    jcfg, jparams, model, prompts = xs
    s0, steps = prompts.shape[1], 3
    jl, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(prompts)}, jcfg, s0 + steps)
    _, dev_caches = T.prefill(model, {"tokens": torch.from_numpy(prompts)}, s0 + steps)
    _, int_caches = T.prefill(model, {"tokens": torch.from_numpy(prompts)}, s0 + steps)
    rng = np.random.default_rng(4)
    for t in range(steps):
        tok = rng.integers(0, jcfg.vocab, size=(3, 1)).astype(np.int32)
        jd, jcache = JT.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(s0 + t), jcfg)
        pos = torch.tensor(s0 + t, dtype=torch.int32)
        d, dev_caches = T.decode_step(model, torch.from_numpy(tok), dev_caches, pos)
        di, int_caches = T.decode_step(model, torch.from_numpy(tok), int_caches, s0 + t)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4, rtol=0)
        assert torch.equal(d, di)
    for i, (c, ci) in enumerate(zip(dev_caches, int_caches)):
        r, s = divmod(i, jcfg.period)
        for name in ("k", "v"):
            assert torch.equal(c[name], ci[name])
            np.testing.assert_allclose(c[name].numpy(), np.asarray(jcache[s][name][r]),
                                       atol=1e-4, rtol=0)


@torch.inference_mode()
def test_decode_step_makes_no_host_read(xs):
    """The step at a device position reads nothing to the host and builds
    no tensor from host data, so a CUDA graph can hold it."""
    _, _, model, prompts = xs
    _, caches = T.prefill(model, {"tokens": torch.from_numpy(prompts)}, 12)
    pos = torch.tensor(8, dtype=torch.int32)
    tok = torch.from_numpy(prompts[:, :1])
    packed = pack_decode_params(model)
    with _HostOps() as ops:
        T.decode_step(model, tok, caches, pos)
        T.decode_step(packed, tok, caches, pos)
    assert ops.seen == []


# ---------------------------------------------------------------------------
# Fixed-slot generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True])
def test_generate_greedy_matches_reference_and_host_loop(xs, packed):
    jcfg, jparams, model, prompts = xs
    if packed:
        jparams, model = j_pack(jparams, jcfg), pack_decode_params(model)
    from repro.models.layers import use_packed_backend as j_backend

    with j_backend("interpret" if packed else "dequant"):
        want = JEngine(jparams, jcfg).generate(prompts, 6)
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    out = eng.generate(prompts, 6)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, eng.generate_host_loop(prompts, 6))
    np.testing.assert_array_equal(eng.generate(prompts, 6), out)  # the bucket reused


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_eos_early_exit_equals_host_loop_past_the_check_interval(xs, temperature):
    """A decode longer than EOS_CHECK_EVERY steps with an EOS some rows hit
    early: the all-done test on the device, read once per interval, gives
    the host loop's stream, EOS-padded past each row's first EOS."""
    _, _, model, prompts = xs
    max_new = 2 * EOS_CHECK_EVERY + 3
    probe = GenerationEngine(model, sampler=SamplerConfig(temperature=temperature, seed=5),
                             device="cpu").generate(prompts, max_new)
    eos = int(probe[0, prompts.shape[1] + 2])
    eng = GenerationEngine(model, sampler=SamplerConfig(temperature=temperature, eos_id=eos,
                                                        seed=5), device="cpu")
    out = eng.generate(prompts, max_new)
    np.testing.assert_array_equal(out, eng.generate_host_loop(prompts, max_new))
    assert (out[0, prompts.shape[1] + 2:] == eos).all()
    for row in out[:, prompts.shape[1]:]:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all()


def test_eos_all_done_stops_the_decode(xs):
    """When every row has hit EOS, the decode stops at the next check: at
    most EOS_CHECK_EVERY steps run past the last row's EOS."""
    _, _, model, prompts = xs
    max_new = 4 * EOS_CHECK_EVERY
    row = prompts[:1]
    probe = GenerationEngine(model, sampler=GREEDY, device="cpu").generate(row, max_new)
    eos = int(probe[0, row.shape[1] + 1])
    eng = GenerationEngine(model, sampler=SamplerConfig(eos_id=eos), device="cpu")
    out = eng.generate(row, max_new)
    np.testing.assert_array_equal(out, eng.generate_host_loop(row, max_new))
    (bucket,) = eng._buckets.values()
    assert bucket.pos_host - row.shape[1] == EOS_CHECK_EVERY


def test_sampled_generate_is_deterministic_across_calls_and_engines(xs):
    _, _, model, prompts = xs
    packed = pack_decode_params(model)

    def engine(seed):
        return GenerationEngine(packed, sampler=SamplerConfig(temperature=1.0, seed=seed),
                                device="cpu")

    eng = engine(7)
    a = eng.generate(prompts, 6)
    np.testing.assert_array_equal(eng.generate(prompts, 6), a)
    np.testing.assert_array_equal(engine(7).generate(prompts, 6), a)
    np.testing.assert_array_equal(eng.generate_host_loop(prompts, 6), a)
    assert not np.array_equal(engine(8).generate(prompts, 6), a)


def test_bucket_reuse_leaves_no_trace_in_the_tokens(xs):
    """A bucket built and filled by a longer prompt serves a shorter one
    (same B and max_len) with the tokens a fresh engine gives: stale KV past
    the new prompt stays masked."""
    _, _, model, prompts = xs
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    eng.generate(prompts, 6)
    short = prompts[:, :5]
    out = eng.generate(short, 9)
    assert eng.gen_traces == 1
    np.testing.assert_array_equal(
        out, GenerationEngine(model, sampler=GREEDY, device="cpu").generate(short, 9))
    np.testing.assert_array_equal(out, eng.generate_host_loop(short, 9))


def test_one_bucket_per_batch_and_max_len(xs):
    """``gen_traces`` as the reference's (tests/test_engine.py): one per
    (B, max_len) bucket."""
    _, _, model, prompts = xs
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    eng.generate(prompts, 4)
    eng.generate(prompts, 4)
    eng.generate(prompts, 4)
    assert eng.gen_traces == 1
    eng.generate(prompts, 6)
    assert eng.gen_traces == 2
    eng.generate(prompts[:2], 4)
    assert eng.gen_traces == 3


def test_generate_result_outlives_the_next_call(xs):
    """A generate's array is the caller's: the bucket's next generate, with
    another prompt, leaves it as it was, and gives the tokens a fresh
    engine gives that prompt."""
    _, _, model, prompts = xs
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    first = eng.generate(prompts, 6)
    kept = first.copy()
    other = prompts[::-1].copy()
    second = eng.generate(other, 6)
    assert eng.gen_traces == 1
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(
        second, GenerationEngine(model, sampler=GREEDY, device="cpu").generate(other, 6))
    assert not np.array_equal(second, first)


def test_engine_keeps_its_most_recent_buckets(xs):
    """An engine holds MAX_BUCKETS buckets, the most recently used: a new
    one frees the least recent one's step program, and a freed bucket used
    again is built anew (one more trace) with the same tokens."""
    _, _, model, prompts = xs
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    shapes = [(prompts, 4 + i) for i in range(MAX_BUCKETS)]
    outs = [eng.generate(p, n) for p, n in shapes]
    oldest = eng._buckets[(3, 8 + 4)]
    evicted = weakref.ref(eng._buckets[(3, 8 + 5)].caches[0]["k"])
    eng.generate(*shapes[0])  # the oldest is now the most recent
    assert eng.gen_traces == MAX_BUCKETS
    gc.disable()  # the freed bucket's caches go at once, with no collection
    try:
        eng.generate(prompts[:2], 4)
        assert evicted() is None
    finally:
        gc.enable()
    assert eng.gen_traces == MAX_BUCKETS + 1 and len(eng._buckets) == MAX_BUCKETS
    assert (3, 8 + 4) in eng._buckets and oldest.program.step is not None
    assert (3, 8 + 5) not in eng._buckets
    np.testing.assert_array_equal(eng.generate(*shapes[1]), outs[1])
    assert eng.gen_traces == MAX_BUCKETS + 2 and len(eng._buckets) == MAX_BUCKETS
    assert oldest.program.step is None and oldest.program.graph is None


@pytest.mark.parametrize("eos", [None, 3])
def test_generate_step_makes_no_host_read(xs, eos):
    """The bucket's step (decode, sample, EOS mask, token write, advance)
    reads nothing to the host; only the interval's all-done check does."""
    _, _, model, prompts = xs
    eng = GenerationEngine(pack_decode_params(model),
                           sampler=SamplerConfig(temperature=1.0, eos_id=eos), device="cpu")
    eng.generate(prompts, 4)
    (bucket,) = eng._buckets.values()
    with torch.inference_mode():
        eng._start(bucket, torch.from_numpy(prompts))
        with _HostOps() as ops:
            bucket.program.run(2)
    assert ops.seen == []


def test_decode_past_the_bucket_raises(xs):
    _, _, model, prompts = xs
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    eng.generate(prompts, 3)
    (bucket,) = eng._buckets.values()
    with pytest.raises(ValueError, match="overrun"):
        eng._decode(bucket, 1)


# ---------------------------------------------------------------------------
# The paged decode chunk
# ---------------------------------------------------------------------------
PAGED = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)


def test_paged_one_step_program_across_chunk_lengths(paged_setup):
    """``chunk_traces == 1`` across chunk lengths, as the reference's
    (tests/test_paged_engine.py), with streams and the allocator digest equal
    to the reference's on the same calls."""
    jcfg, jparams, model, prompts = paged_setup
    jeng = JPagedEngine(jparams, jcfg, JPagedConfig(**PAGED, attn_impl="ref"),
                        JSampler(temperature=0.0))
    eng = PagedEngine(model, None, PagedConfig(**PAGED), GREEDY, device="cpu")
    for p, n in ((prompts, 4), (prompts, 6), (prompts[:, :4], 4)):
        np.testing.assert_array_equal(eng.generate(p, n), jeng.generate(p, n))
        assert eng.chunk_traces == 1 == jeng.chunk_traces
        assert eng.pool_state.digest() == jeng.pool_state.digest()
    assert eng.chunks > 3


def test_paged_chunk_result_outlives_the_next_chunk(paged_setup):
    """A chunk's token array is the caller's: the next chunk, which zeroes
    and refills the engine's buffer, leaves it as it was."""
    _, _, model, prompts = paged_setup
    eng = PagedEngine(model, None, PagedConfig(**PAGED), GREEDY, device="cpu")
    sched = eng._make_scheduler()
    sched.submit(Request(uid=0, prompt=prompts[0], max_new=8))
    with torch.inference_mode():
        eng._do_admit(sched.try_admit())
        first = eng._chunk(2)
        kept = first.copy()
        second = eng._chunk(2)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(second[0, :2], first[0, :2])


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_paged_chunk_equals_eager_chunk(paged_setup, kv_dtype):
    """The program's chunk and the eager loop of the same step serve a trace
    to the same streams, buffer and allocator digest (equal on the CPU by
    construction; the card test holds replays to it)."""
    jcfg, jparams, model, _ = paged_setup
    rng = np.random.default_rng(2)
    specs = [(u, rng.integers(0, 128, size=int(rng.integers(3, 12))), int(rng.integers(2, 9)))
             for u in range(5)]
    runs = []
    for eager in (False, True):
        eng = PagedEngine(model, None, PagedConfig(**{**PAGED, "kv_dtype": kv_dtype}), GREEDY,
                          device="cpu")
        if eager:
            chunk = eng._chunk
            eng._chunk = lambda k: chunk(k, eager=True)
        runs.append((eng.serve([Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]),
                     eng.pool_state.digest(), eng.decode_steps))
    (a, da, sa), (b, db, sb) = runs
    assert set(a) == set(b) and da == db and sa == sb
    for u in a:
        np.testing.assert_array_equal(a[u], b[u])


def test_paged_step_makes_no_host_read(paged_setup):
    """The paged step (decode, per-row sampling, last_tok/steps updates,
    buffer write at the device column) reads nothing to the host. Float KV
    only: B3's plain version walks the pages in a host loop on CPU tensors;
    on the card B3 runs and the card tests hold its step to no sync."""
    _, _, model, prompts = paged_setup
    eng = PagedEngine(pack_decode_params(model), None, PagedConfig(**PAGED),
                      SamplerConfig(temperature=1.0), device="cpu")
    sched = eng._make_scheduler()
    sched.submit(Request(uid=0, prompt=prompts[0], max_new=8))
    with torch.inference_mode():
        eng._do_admit(sched.try_admit())
        eng._chunk(1)
        with _HostOps() as ops:
            eng._program.run(2)
    assert ops.seen == []


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_paged_serve_rebinds_no_leaf_the_step_reads(paged_setup, kv_dtype):
    """Admits (cold, suffix and fully cached), chunks and releases update
    the cache leaves, the token buffer, its column and the B3 watermarks in
    place: a step captured at the first chunk keeps reading the live
    tensors."""
    _, _, model, prompts = paged_setup
    eng = PagedEngine(model, None, PagedConfig(**{**PAGED, "kv_dtype": kv_dtype,
                                                  "prefix_cache": True}), GREEDY, device="cpu",
                      assert_bounds=kv_dtype == "int8")

    def leaves():
        pools = [t for pool in eng.cache["pools"] for t in pool.values()]
        named = [v for k, v in eng.cache.items() if k != "pools"]
        extra = [eng._buf, eng._col] + ([eng.watermarks] if eng.watermarks is not None else [])
        return [t.data_ptr() for t in pools + named + extra]

    before = leaves()
    shared = np.concatenate([prompts[0], prompts[1]])
    reqs = [Request(uid=0, prompt=shared, max_new=4),
            Request(uid=1, prompt=np.concatenate([shared, prompts[2][:3]]), max_new=3),
            Request(uid=2, prompt=shared.copy(), max_new=5)]
    eng.serve(reqs[:1])
    eng.serve(reqs[1:])
    assert eng.suffix_admits >= 1 and eng.cached_admits == 1 and eng.chunk_traces == 1
    assert leaves() == before
