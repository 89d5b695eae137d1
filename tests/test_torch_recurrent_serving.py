"""Port parity of the recurrent families' serving: ``tiny-ssm`` (Mamba),
``tiny-xlstm`` (mLSTM + sLSTM) and ``tiny-hybrid`` (Mamba + MLP, attention
+ MoE) through the fixed-slot and the FIFO paged engines, against the
reference's engines on weights carried across by
``repro_torch.interop.params_from_numpy``.

Greedy streams are held identical, float and RTN-packed (the reference's
Pallas kernel in interpret mode, B1's plain version here), and the paged
engine's ``PoolState.digest()`` equal to the reference's, with float and
int8 pages. The recurrent state lives in dense per-slot lanes that
admission overwrites in place and every decode step steps (idle slots
too). Ported from ``tests/test_paged_engine.py``: the int8 golden on the
briefly trained ``tiny-hybrid`` with mid-flight admission (:220), the
prefix-cache refusal (:490), hybrid paged equals per-request fixed slot
(:499) and the hybrid half of the policy gates (:608), on engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.models.layers import use_packed_backend as j_backend
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.serving import GenerationEngine as JEngine
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro_torch.configs import get_config
from repro_torch.interop import paged_cache_from_numpy, params_from_numpy
from repro_torch.launch import serve
from repro_torch.quant.serve_packed import pack_decode_params
from repro_torch.serving import (
    GenerationEngine,
    PagedConfig,
    PagedEngine,
    Request,
    SamplerConfig,
    SchedulerPolicy,
)

torch.set_float32_matmul_precision("highest")

GREEDY = SamplerConfig(temperature=0.0)
PAGED = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)
RUNGS = ["tiny-ssm", "tiny-xlstm", "tiny-hybrid"]


def _pair(arch, jparams=None):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if jparams is None:
        jparams = JT.init_model(jax.random.key(0), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                 device="cpu")


@pytest.fixture(scope="module", params=RUNGS)
def rung(request):
    return _pair(request.param)


def _prompts(cfg, seed=0, b=3, s=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _paged(model, **kw):
    return PagedEngine(model, None, PagedConfig(**{**PAGED, **kw}), GREEDY, device="cpu")


def _jpaged(jparams, jcfg, **kw):
    return JPagedEngine(jparams, jcfg, JPagedConfig(**{**PAGED, "attn_impl": "ref", **kw}),
                        JSampler(temperature=0.0))


def test_greedy_fixed_slot_matches_reference(rung):
    """Float and RTN-packed models through the fixed-slot engine (the
    captured step's static-buffer form on the CPU, and the host loop)
    against the reference engine."""
    jcfg, cfg, jparams, model = rung
    prompts = _prompts(cfg)
    with j_backend("dequant"):
        want = JEngine(jparams, jcfg).generate(prompts, 6)
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)
    np.testing.assert_array_equal(eng.generate_host_loop(prompts, 6), want)
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)  # the bucket's buffers again
    assert eng.gen_traces == 1
    with j_backend("interpret"):
        want = JEngine(j_pack(jparams, jcfg), jcfg).generate(prompts, 6)
    packed = GenerationEngine(pack_decode_params(model), sampler=GREEDY, device="cpu",
                              backend="reference")
    np.testing.assert_array_equal(packed.generate(prompts, 6), want)


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_greedy_paged_fifo_matches_reference(rung, kv_dtype):
    """Mid-flight admission (two slots, three requests, a prompt ending
    mid-page): a later request's state lands in a lane the first one
    stepped. Streams and the pool digest equal the reference's."""
    jcfg, cfg, jparams, model = rung
    rng = np.random.default_rng(9)
    specs = [(0, rng.integers(0, cfg.vocab, size=8), 6),
             (1, rng.integers(0, cfg.vocab, size=11), 5),
             (2, rng.integers(0, cfg.vocab, size=5), 7)]
    kw = dict(max_concurrency=2, kv_dtype=kv_dtype)
    jeng = _jpaged(jparams, jcfg, **kw)
    want = jeng.serve([JRequest(uid=u, prompt=np.asarray(p, np.int32), max_new=n)
                       for u, p, n in specs])
    eng = _paged(model, **kw)
    got = eng.serve([Request(uid=u, prompt=np.asarray(p, np.int32), max_new=n)
                     for u, p, n in specs])
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert eng.pool_state.digest() == jeng.pool_state.digest()
    assert eng.chunk_traces == 1 and eng.pool_state.free_top == 0


def test_paged_recurrent_lanes_match_reference(rung):
    """After a serve, the paged cache equals the reference's carried
    across by ``interop.paged_cache_from_numpy``: every recurrent lane
    (idle slots stepped too) within f32 tolerance, the allocator and
    per-slot leaves exactly."""
    jcfg, cfg, jparams, model = rung
    specs = [(0, _prompts(cfg, 3, 1, 9)[0], 5), (1, _prompts(cfg, 4, 1, 6)[0], 3)]
    jeng, eng = _jpaged(jparams, jcfg), _paged(model)
    jeng.serve([JRequest(uid=u, prompt=p, max_new=n) for u, p, n in specs])
    eng.serve([Request(uid=u, prompt=p, max_new=n) for u, p, n in specs])
    ref = paged_cache_from_numpy(jax.tree.map(np.asarray, jeng.cache), cfg, device="cpu")
    for key in ("block_table", "seq_lens", "active", "free_list", "free_top",
                "page_refcounts"):
        np.testing.assert_array_equal(eng.cache[key].numpy(), ref[key].numpy(), err_msg=key)
    for i, (pool, rpool) in enumerate(zip(eng.cache["pools"], ref["pools"])):
        if cfg.layer_spec(i).mixer == "attn":
            continue
        assert pool.keys() == rpool.keys()
        for name, lane in pool.items():
            np.testing.assert_allclose(lane.numpy(), rpool[name].numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=f"layer {i} {name}")


def test_greedy_paged_packed_matches_reference(rung):
    jcfg, cfg, jparams, model = rung
    prompts = _prompts(cfg, 5)
    with j_backend("interpret"):
        want = _jpaged(j_pack(jparams, jcfg), jcfg).generate(prompts, 5)
    eng = PagedEngine(pack_decode_params(model), None, PagedConfig(**PAGED), GREEDY,
                      backend="reference", device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5), want)


def _train_briefly(cfg, steps=250, lr=2e-3):
    """The reference's briefly trained rung (``tests/test_paged_engine.py``
    ``_train_briefly``)."""
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


def test_int8_kv_golden_greedy_matches_float_hybrid():
    """The reference's golden (tests/test_paged_engine.py:220) on its
    briefly trained tiny-hybrid: int8 attention pages beside dense Mamba
    lanes, three requests in two slots (uid 2 admits into pages and a lane
    freed mid-flight), token for token equal to float KV, and both equal
    to the reference's engines."""
    jcfg, cfg, jparams, model = _pair("tiny-hybrid", _train_briefly(j_get_config("tiny-hybrid")))
    rng = np.random.default_rng(1)
    specs = [(u, rng.integers(0, cfg.vocab, size=8).astype(np.int32), [8, 12, 4][u])
             for u in range(3)]
    kw = dict(max_concurrency=2, num_blocks=8, max_pages_per_seq=3, chunk_max=3)
    res_f = _paged(model, **kw).serve([Request(uid=u, prompt=p, max_new=n) for u, p, n in specs])
    res_q = _paged(model, kv_dtype="int8", **kw).serve(
        [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs])
    want_q = _jpaged(jparams, jcfg, kv_dtype="int8", **kw).serve(
        [JRequest(uid=u, prompt=p, max_new=n) for u, p, n in specs])
    for u, _, _ in specs:
        np.testing.assert_array_equal(res_q[u], res_f[u])
        np.testing.assert_array_equal(res_q[u], want_q[u])


def test_prefix_cache_requires_attention_only_pattern():
    """tests/test_paged_engine.py:490 on the port's engine: recurrent
    lanes cannot be shared, so prefix_cache=True refuses a hybrid."""
    _, _, _, model = _pair("tiny-hybrid")
    with pytest.raises(ValueError, match="attention-only"):
        _paged(model, prefix_cache=True)


def test_hybrid_family_paged_decode():
    """tests/test_paged_engine.py:499: the paged engine's streams equal
    per-request fixed-slot rollouts (a batched fixed-slot prefill lets rows
    compete for expert capacity; the paged admit prefills one request)."""
    _, cfg, _, model = _pair("tiny-hybrid")
    prompts = _prompts(cfg, 4, 2)
    out = _paged(model, max_concurrency=2, num_blocks=8, max_pages_per_seq=2).generate(prompts, 8)
    for b in range(2):
        want = GenerationEngine(model, sampler=GREEDY, device="cpu").generate(prompts[b:b + 1], 8)
        np.testing.assert_array_equal(out[b], want[0])


@pytest.mark.parametrize("policy", [SchedulerPolicy(prefill_chunk=8),
                                    SchedulerPolicy(batch_max=2)])
def test_throughput_policy_refuses_recurrent_on_an_engine(policy):
    """The hybrid half of tests/test_paged_engine.py:608 on engines: chunked
    or batched admission needs an attention-only pattern (it would step the
    recurrent state through pad tokens); FIFO serves."""
    for arch in ("tiny-hybrid", "tiny-xlstm"):
        _, cfg, _, model = _pair(arch)
        with pytest.raises(ValueError, match="attention-only"):
            _paged(model, sched=policy)
        assert _paged(model).generate(_prompts(cfg, 0, 1), 2).shape == (1, 10)


@pytest.mark.parametrize("arch", RUNGS)
def test_serve_launcher_recurrent_rungs(arch, capsys):
    """The launcher serves each rung RTN-packed, fixed slot and paged (float
    and int8 pages). The packed sites quantize activations per tensor, so a
    batched fixed-slot prefill and the paged engine's one-request admits
    may differ; an attention-free rung's int8 pool holds no page, so its
    two paged runs agree."""
    base = ["--arch", arch, "--packed", "--batch", "2", "--prompt-len", "8", "--max-new", "4",
            "--device", "cpu"]
    fixed = serve.main(base)
    paged = serve.main([*base, "--paged", "--block-size", "8"])
    paged8 = serve.main([*base, "--paged", "--block-size", "8", "--kv-dtype", "int8"])
    assert fixed.shape == paged.shape == paged8.shape == (2, 12)
    if arch != "tiny-hybrid":
        np.testing.assert_array_equal(paged8, paged)
    assert "tok/s" in capsys.readouterr().out
