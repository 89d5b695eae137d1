"""Port parity of the MoE family: routing, the MoE block, the model, packed
expert serving and both engines, against ``repro`` on weights carried
across by ``repro_torch.interop.params_from_numpy``.

Routing is discrete and held exactly on f32 rungs: the top-k experts and
the dispatch tensor equal the reference's; gates and combine weights agree
within 1e-6 (softmax sums in another order). Block outputs and logits are
held within the dense tests' atol 1e-4. The expert-axis W4A8 GEMM's int32
accumulators equal the reference's vmapped Pallas kernel (interpret mode)
exactly, and the per-expert dynamic quantizer its vmapped quantizer bit
for bit. Greedy streams of the fixed-slot and the FIFO paged engine (float
and int8 pages, the prefix cache) equal the reference's token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.kernels.ops import quantize_activations as j_quantize_activations
from repro.kernels.w4a8_mm import w4a8_decode_matmul as j_w4a8_decode
from repro.kernels.w4a8_mm import w4a8_sparse_decode_matmul as j_w4a8_sparse_decode
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.layers import use_packed_backend as j_backend
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.quant.spec import DatapathSpec as JSpec
from repro.serving import GenerationEngine as JEngine
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.sparsity import mask_2to4
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import w4a8_mm as W
from repro_torch.kernels.ops import quantize_activations
from repro_torch.launch import serve
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import Linear, PackedLinear, use_packed_backend
from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes
from repro_torch.quant.spec import DatapathSpec
from repro_torch.serving import (
    GenerationEngine,
    PagedConfig,
    PagedEngine,
    Request,
    SamplerConfig,
    SchedulerPolicy,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

GREEDY = SamplerConfig(temperature=0.0)
PAGED = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)
#: (arch, smoke) of the two MoE configs the port registers, at test size
RUNGS = [("tiny-moe", False), ("granite-moe-3b-a800m", True)]


def _cfgs(arch, smoke, **updates):
    jcfg = j_get_smoke(arch) if smoke else j_get_config(arch)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if updates:
        jcfg = jcfg.scaled(**updates)
        cfg = cfg.scaled(**updates)
    return jcfg, cfg


def _low_capacity(moe_cfg):
    """The reference's MoEConfig with a capacity factor low enough to drop."""
    return dataclasses.replace(moe_cfg, capacity_factor=0.5)


def _pair(jcfg, cfg, seed=0):
    jparams = JT.init_model(jax.random.key(seed), jcfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _n(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = _cfgs("tiny-moe", False)
    jparams, model = _pair(jcfg, cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8)).astype(np.int32)
    return jcfg, cfg, jparams, model, prompts


# ---------------------------------------------------------------------------
# Configs, routing, the block, the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,smoke", RUNGS)
def test_moe_configs_match_reference(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if smoke:  # the published config too
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))


@pytest.mark.parametrize("capacity", ["default", "low"])
@pytest.mark.parametrize("arch,smoke", RUNGS)
def test_route_matches_reference(arch, smoke, capacity):
    """Top-k experts and dispatch exact; gates and combine within 1e-6.
    Ties go to the lower expert index in both (a row of equal logits)."""
    jcfg, cfg = _cfgs(arch, smoke)
    if capacity == "low":
        jcfg = jcfg.scaled(moe=_low_capacity(jcfg.moe))
        cfg = cfg.scaled(moe=_low_capacity(cfg.moe))
    rng = np.random.default_rng(3)
    d, e = cfg.d_model, cfg.moe.n_experts
    x = rng.normal(0.0, 1.0, size=(2, 32, d)).astype(np.float32)
    x[0, 0] = 0.0  # equal logits: a tie over every expert
    w = (rng.normal(0.0, 1.0, size=(d, e)) / np.sqrt(d)).astype(np.float32)
    jout = JM.route(jnp.asarray(w), jnp.asarray(x), jcfg)
    out = M.route(torch.from_numpy(w), torch.from_numpy(x), cfg)
    for name, j, p in zip(("xf", "dispatch", "combine", "gates", "topi"), jout[:5], out[:5]):
        if name in ("dispatch", "topi", "xf"):
            np.testing.assert_array_equal(_n(p), np.asarray(j), err_msg=name)
        else:
            np.testing.assert_allclose(_n(p), np.asarray(j), rtol=0, atol=1e-6, err_msg=name)
    assert out[5] == jout[5]
    np.testing.assert_array_equal(_n(out[4])[0, 0], np.arange(cfg.moe.top_k))
    kept = float(out[1].sum())
    if capacity == "low":  # assignments past the capacity were dropped
        assert kept < x.shape[0] * x.shape[1] * cfg.moe.top_k
    assert M.expert_capacity(cfg, 72) == JM.expert_capacity(jcfg, 72)


@pytest.mark.parametrize("capacity", ["default", "low"])
@pytest.mark.parametrize("arch,smoke", RUNGS)
def test_moe_block_matches_reference(arch, smoke, capacity):
    jcfg, cfg = _cfgs(arch, smoke)
    if capacity == "low":
        jcfg = jcfg.scaled(moe=_low_capacity(jcfg.moe))
        cfg = cfg.scaled(moe=_low_capacity(cfg.moe))
    jparams, model = _pair(jcfg, cfg, seed=1)
    x = np.random.default_rng(4).normal(0.0, 1.0, size=(2, 20, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["ffn"])
    jy, jaux = JM.moe(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        y, aux = M.moe(model.layers[0].ffn, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_n(y), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert isinstance(model.layers[0].ffn, M.MoE)
    assert model.layers[0].ffn.wd.w.shape == (cfg.moe.n_experts, cfg.moe.d_ff_expert,
                                              cfg.d_model)


@pytest.mark.parametrize("arch,smoke", RUNGS)
@torch.inference_mode()
def test_forward_and_loss_match_reference(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    jparams, model = _pair(jcfg, cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    jlogits, jaux = JT.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    logits, aux = T.forward(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_n(logits), np.asarray(jlogits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jtotal, jm = JT.loss_fn(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    total, m = T.loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=0, atol=1e-4)
    assert float(m["aux"]) > 0.0


def test_init_model_builds_moe_blocks():
    cfg = get_smoke("granite-moe-3b-a800m")
    model = T.init_model(cfg, seed=3, device="cpu")
    ffn = model.layers[1].ffn
    e, f, d = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    assert isinstance(ffn, M.MoE) and ffn.router.w.shape == (d, e)
    assert ffn.wg.w.shape == ffn.wu.w.shape == (e, d, f) and ffn.wd.w.shape == (e, f, d)
    again = T.init_model(cfg, seed=3, device="cpu")
    assert torch.equal(again.layers[1].ffn.wd.w, ffn.wd.w)
    with torch.inference_mode():
        logits, aux = T.forward(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert logits.shape == (1, 4, cfg.vocab_padded) and torch.isfinite(aux)


# ---------------------------------------------------------------------------
# The expert-axis GEMM and quantizer against the reference's vmapped forms
# ---------------------------------------------------------------------------
def _j_vmapped(sparse):
    if sparse:
        def one(x, w, m, s, c, a, z):
            return j_w4a8_sparse_decode(x, w, m, s, c, a, z, interpret=True)
        return jax.vmap(one)

    def one_dense(x, w, s, c, a, z):
        return j_w4a8_decode(x, w, s, c, a, z, interpret=True)
    return jax.vmap(one_dense)


@pytest.mark.parametrize("sparse", [False, True])
def test_expert_matmul_accumulators_match_reference_vmapped_kernel(sparse):
    """Unit scales and a zero point of 0 make the output the int32
    accumulator: exact. Real per-expert scales and zero points: equal too."""
    rng = np.random.default_rng(6)
    e, m, k, n = 3, 5, 64, 16
    x = rng.integers(0, 256, size=(e, m, k)).astype(np.uint8)
    x[1] = 0  # an expert that got no token
    q = torch.from_numpy(rng.integers(-8, 8, size=(e, k, n)).astype(np.int8))
    if sparse:
        q = q * mask_2to4(q)
        weights = W.compress_2to4(q)
    else:
        weights = (W.pack_int4(q),)
    col = q.sum(1).to(torch.int32)
    for scale, act_scale, act_zp in (
            (np.ones((e, n), np.float32), np.ones(e, np.float32), np.zeros(e, np.float32)),
            (rng.uniform(0.005, 0.02, (e, n)).astype(np.float32),
             rng.uniform(0.01, 0.05, e).astype(np.float32),
             rng.integers(0, 256, e).astype(np.float32))):
        jy = _j_vmapped(sparse)(jnp.asarray(x), *(jnp.asarray(_n(w)) for w in weights),
                                jnp.asarray(scale), jnp.asarray(_n(col)), jnp.asarray(act_scale),
                                jnp.asarray(act_zp))
        fn = W.w4a8_sparse_expert_matmul if sparse else W.w4a8_expert_matmul
        y = fn(torch.from_numpy(x), *weights, torch.from_numpy(scale), col,
               torch.from_numpy(act_scale), torch.from_numpy(act_zp))
        np.testing.assert_array_equal(_n(y), np.asarray(jy))


def test_per_expert_quantizer_matches_reference_vmapped():
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 2.0, size=(4, 6, 32)).astype(np.float32)
    x[2] = 0.0  # no token: the 1e-8 floor
    x[0, 4:] = 0.0  # capacity rows at zero take part in the min and max
    jc, js, jz = jax.vmap(j_quantize_activations)(jnp.asarray(x))
    c, s, z = quantize_activations(torch.from_numpy(x), per_expert=True)
    np.testing.assert_array_equal(_n(c), np.asarray(jc))
    np.testing.assert_array_equal(_n(s), np.asarray(js))
    np.testing.assert_array_equal(_n(z), np.asarray(jz))
    assert _n(s)[2] == np.float32(1e-8)


# ---------------------------------------------------------------------------
# Packed MoE serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sparsity", [None, "2:4"])
def test_packed_moe_matches_reference(tiny, sparsity):
    """RTN packing of the stacked sites equals the reference's leaf for leaf
    (codes, bf16 scales, col_sums, the (E, L) spec twin); the packed model's
    logits under the plain-version backend match the reference's
    interpret-mode Pallas kernel, with the routing exact."""
    jcfg, cfg, jparams, model, _ = tiny
    spec = DatapathSpec(sparsity=sparsity)
    jpacked = j_pack(jparams, jcfg, JSpec(sparsity=sparsity))
    packed = pack_decode_params(model, cfg, spec)
    e = cfg.moe.n_experts
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        jffn = jpacked["layers"][s]["ffn"]
        for name in ("wg", "wu", "wd"):
            leaf = getattr(packed.layers[i].ffn, name)
            assert isinstance(leaf, PackedLinear) and leaf.stacked
            for key in ("packed", "scale", "col_sums", "spec_arr", "meta"):
                if key == "meta" and sparsity is None:
                    assert leaf.meta is None and "meta" not in jffn[name]
                    continue
                want = np.asarray(jffn[name][key])[r]
                got = _n(getattr(leaf, key).float() if key == "scale" else getattr(leaf, key))
                np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=key)
            assert leaf.packed.shape[0] == e and leaf.spec.sparsity == sparsity
        assert isinstance(packed.layers[i].ffn.router, Linear)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    with j_backend("interpret"):
        jlogits, _ = JT.forward(jpacked, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.inference_mode(), use_packed_backend("reference"):
        logits, _ = T.forward(packed, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_n(logits), np.asarray(jlogits), rtol=0, atol=1e-4)
    # the dequant backend's stacked einsum, block against block
    x = np.random.default_rng(9).normal(0.0, 1.0, size=(2, 12, cfg.d_model)).astype(np.float32)
    with j_backend("dequant"):
        jy, _ = JM.moe(jax.tree.map(lambda a: a[0], jpacked["layers"][0]["ffn"]),
                       jnp.asarray(x), jcfg)
    with torch.inference_mode(), use_packed_backend("dequant"):
        y, _ = M.moe(packed.layers[0].ffn, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_n(y), np.asarray(jy), rtol=0, atol=1e-5)


def test_packed_weight_bytes_counts_expert_stacks():
    cfg = get_config("granite-moe-3b-a800m")
    acct = packed_weight_bytes(cfg)
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    attn = d * cfg.n_heads * cfg.head_dim * 2 + d * cfg.n_kv_heads * cfg.head_dim * 2
    assert acct["weight_elems"] == cfg.n_layers * (attn + 3 * e * d * f)
    assert acct["packed_code_bytes"] == acct["weight_elems"] // 2


def _j_generate(jparams, jcfg, prompts, backend, n):
    with j_backend(backend):
        return JEngine(jparams, jcfg).generate(prompts, n)


def test_greedy_fixed_slot_matches_reference(tiny):
    """Float and RTN-packed models in the fixed-slot engine (the captured
    step's static-buffer form on the CPU) against the reference engine."""
    jcfg, cfg, jparams, model, prompts = tiny
    want = _j_generate(jparams, jcfg, prompts, "dequant", 6)
    eng = GenerationEngine(model, sampler=GREEDY, device="cpu")
    out = eng.generate(prompts, 6)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(eng.generate_host_loop(prompts, 6), want)
    jpacked = j_pack(jparams, jcfg)
    packed = pack_decode_params(model)
    want = _j_generate(jpacked, jcfg, prompts, "interpret", 6)
    np.testing.assert_array_equal(
        GenerationEngine(packed, sampler=GREEDY, device="cpu", backend="reference").generate(
            prompts, 6), want)


def _paged(model, **kw):
    return PagedEngine(model, None, PagedConfig(**{**PAGED, **kw}), GREEDY, device="cpu")


def _jpaged(jparams, jcfg, **kw):
    return JPagedEngine(jparams, jcfg, JPagedConfig(**{**PAGED, "attn_impl": "ref", **kw}),
                        JSampler(temperature=0.0))


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_greedy_paged_fifo_matches_reference(tiny, kv_dtype):
    """Mid-flight admission (two slots, three requests, a prompt ending
    mid-page) with float and int8 pages: tokens and the pool digest equal
    the reference's, and the float streams the fixed-slot engine's."""
    jcfg, cfg, jparams, model, _ = tiny
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
    if kv_dtype == "act":
        for uid, prompt, n in specs:
            alone = GenerationEngine(model, sampler=GREEDY, device="cpu").generate(
                np.asarray(prompt, np.int32)[None], n)[0]
            np.testing.assert_array_equal(got[uid], alone)


def test_greedy_paged_prefix_cache_matches_reference(tiny):
    """Two requests sharing a two-page prefix: the second admits its suffix
    against the cached pages, and a third is wholly cached; the mixer is
    attention, so the prefix cache serves MoE blocks."""
    jcfg, cfg, jparams, model, _ = tiny
    rng = np.random.default_rng(10)
    prefix = rng.integers(0, cfg.vocab, size=16)
    specs = [(0, prefix, 4), (1, np.concatenate([prefix, rng.integers(0, cfg.vocab, 5)]), 4),
             (2, prefix, 3)]
    kw = dict(max_concurrency=1, num_blocks=12, prefix_cache=True)
    jeng = _jpaged(jparams, jcfg, **kw)
    want = jeng.serve([JRequest(uid=u, prompt=np.asarray(p, np.int32), max_new=n)
                       for u, p, n in specs])
    eng = _paged(model, **kw)
    got = eng.serve([Request(uid=u, prompt=np.asarray(p, np.int32), max_new=n)
                     for u, p, n in specs])
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert eng.suffix_admits >= 1 and eng.cached_admits >= 1
    assert eng.pool_state.digest() == jeng.pool_state.digest()


def test_greedy_paged_packed_matches_reference(tiny):
    jcfg, cfg, jparams, model, prompts = tiny
    jpacked = j_pack(jparams, jcfg)
    with j_backend("interpret"):
        want = _jpaged(jpacked, jcfg).generate(prompts, 5)
    eng = PagedEngine(pack_decode_params(model), None, PagedConfig(**PAGED), GREEDY,
                      backend="reference", device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5), want)


def test_throughput_policy_refuses_moe_on_an_engine(tiny):
    """The reference's gate (tests/test_paged_engine.py:608) on an engine:
    batched or chunked admission needs a MoE-free pattern; FIFO serves."""
    jcfg, cfg, jparams, model, prompts = tiny
    for policy in (SchedulerPolicy(batch_max=2), SchedulerPolicy(prefill_chunk=8)):
        with pytest.raises(ValueError, match="MoE-free"):
            _paged(model, sched=policy)
        with pytest.raises(ValueError, match="MoE-free"):
            _jpaged(jparams, jcfg, sched=policy)
    smoke = get_smoke("granite-moe-3b-a800m").scaled(vocab=128)
    with pytest.raises(ValueError, match="MoE-free"):
        _paged(T.init_model(smoke, device="cpu"), sched=SchedulerPolicy(batch_max=2))
    assert _paged(model).generate(prompts[:1], 2).shape == (1, 10)


@pytest.mark.parametrize("argv", [
    ["--packed"],
    ["--packed", "--paged", "--block-size", "8", "--kv-dtype", "int8"],
    ["--packed", "--paged", "--block-size", "8", "--prefix-cache"],
])
def test_serve_launcher_granite_smoke(argv, capsys):
    out = serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "4", "--device", "cpu", *argv])
    assert out.shape == (2, 12)
    assert "tok/s" in capsys.readouterr().out
