"""Port parity of paged decode attention and the paged model functions:
``AttnDatapathSpec``, the KV page quantizers, the plain versions of kernels
B2 and B3 against the reference's Pallas kernel (interpret mode) and its
gather reference over the sweep of ``tests/test_paged_attention.py``, the
``assert_bounds`` watermarks, ``decode_step_paged`` (float and int8 pools,
the same cache carried in by ``paged_cache_from_numpy``) and the suffix
``prefill``.

Tolerances: the spec, codes and scales exact; float outputs 1e-5; the int8
body 1e-5 on every row where no q code and no probability code lies within
1e-3 of a rounding boundary (there another exp of equal accuracy may round
the other way), 5e-2 on the others, the JAX sweep's bound; logits 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.kernels import paged_attention as JPA
from repro.models import transformer as JT
from repro.quant import spec as JSPEC
from repro_torch.configs import get_smoke
from repro_torch.interop import paged_cache_from_numpy, params_from_numpy
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import transformer as T
from repro_torch.quant import spec as SPEC

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


# ---------------------------------------------------------------------------
# AttnDatapathSpec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", [7, 16, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 64, 128])
def test_attn_spec_matches_reference(hd, bs):
    j, p = JSPEC.AttnDatapathSpec.for_cache(hd, bs), SPEC.AttnDatapathSpec.for_cache(hd, bs)
    assert p.key() == j.key() and p.spec_hash() == j.spec_hash()
    assert p.describe() == j.describe() and p.certify() and j.certify()
    assert (p.qk_worst_abs(), p.pv_worst_abs()) == (j.qk_worst_abs(), j.pv_worst_abs())
    for bits in ((4, 8, 8), (8, 6, 4)):
        kw = dict(kv_bits=bits[0], q_bits=bits[1], prob_bits=bits[2])
        assert SPEC.AttnDatapathSpec.for_cache(hd, bs, **kw).key() == \
            JSPEC.AttnDatapathSpec.for_cache(hd, bs, **kw).key()
    # tight: one fewer bit overflows the worst case
    for reg in ("p_qk", "p_pv"):
        smaller = SPEC.AttnDatapathSpec(**{**p.__dict__, reg: getattr(p, reg) - 1})
        assert not smaller.certify()


def test_attn_datapath_validation_matches_reference():
    spec = SPEC.AttnDatapathSpec.for_cache(64, 64)
    assert (spec.p_qk, spec.p_pv) == (21, 22)
    SPEC.validate_attn_datapath(spec, SPEC.AttnDatapathSpec.for_cache(64, 64))
    with pytest.raises(SPEC.DatapathMismatchError, match="attention datapath"):
        SPEC.validate_attn_datapath(spec, SPEC.AttnDatapathSpec.for_cache(64, 128))
    with pytest.raises(SPEC.DatapathMismatchError, match="float KV"):
        SPEC.validate_attn_datapath(None, spec)
    for depth, a, b in ((1, 1, 1), (64, 127, 127), (300, 255, 127), (7, 3, 5)):
        assert SPEC.attn_accumulator_bits(depth, a, b) == JSPEC.attn_accumulator_bits(depth, a, b)


# ---------------------------------------------------------------------------
# KV page quantization
# ---------------------------------------------------------------------------
def test_quantize_kv_pages_matches_reference(rng):
    pages = (rng.normal(size=(5, 8, 3, 16)) * 4.0).astype(np.float32)
    pages[0] = 0.0
    jc, js = JPA.quantize_kv_pages(jnp.asarray(pages))
    pc, ps = PA.quantize_kv_pages(_t(pages))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(PA.dequantize_kv_pages(pc, ps).numpy(),
                                  np.asarray(JPA.dequantize_kv_pages(jc, js)))
    bf = jnp.asarray(pages, jnp.bfloat16)
    jc, js = JPA.quantize_kv_pages(bf)
    pc, ps = PA.quantize_kv_pages(_t(np.asarray(bf, np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# Plain B2 / B3 against the reference kernel (interpret) and gather oracle
# ---------------------------------------------------------------------------
def _random_case(rng, B, nkv, g, hd, bs, P, extra_blocks=4):
    """The reference sweep's cases: distinct pages per row, ragged lengths,
    sentinel tail entries (numpy)."""
    nb = B * P + extra_blocks
    q = rng.normal(size=(B, nkv * g, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    tab = np.full((B, P), nb, np.int32)
    perm = rng.permutation(nb)
    lens = rng.integers(1, P * bs + 1, size=B).astype(np.int32)
    o = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tab[b, :n] = perm[o:o + n]
        o += n
    return q, kp, vp, tab, lens


def _sweep_lens(rng, B, bs, P, mode):
    """Not-divisible, exact last block, and the +-1 brackets around it."""
    full = P * bs
    if mode == "ragged":
        lens = [(i * bs + 1 + int(rng.integers(0, bs - 1))) % full or 1 for i in range(B)]
        lens = [ln if ln % bs else ln - 1 or 1 for ln in lens]
    elif mode == "exact":
        lens = [((i % P) + 1) * bs for i in range(B)]
    else:
        lens = [max(1, bs - 1), bs + 1, full, max(1, full - 1)][:B]
    return np.asarray(lens, np.int32)


def _check_against_reference(q, kp, vp, tab, lens, kv, softcap=None):
    """Port plain version vs the reference kernel (interpret) and oracle."""
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tab, lens)]
    targs = [_t(a) for a in (q, kp, vp, tab, lens)]
    if kv == "float":
        ker = JPA.paged_decode_attention(*jargs, softcap=softcap, interpret=True)
        ref = JPA.paged_attention_reference(*jargs, softcap=softcap)
        out = PA.paged_decode_attention(*targs, softcap=softcap)
        np.testing.assert_allclose(out.numpy(), np.asarray(ker), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        oracle = PA.paged_attention_reference(*targs, softcap=softcap)
        np.testing.assert_allclose(oracle.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        return
    (jkc, jks), (jvc, jvs) = JPA.quantize_kv_pages(jargs[1]), JPA.quantize_kv_pages(jargs[2])
    kc, vc, ks, vs = (_t(np.asarray(a)) for a in (jkc, jvc, jks, jvs))
    ker = JPA.paged_decode_attention(jargs[0], jkc, jvc, jargs[3], jargs[4], k_scales=jks,
                                     v_scales=jvs, softcap=softcap, interpret=True,
                                     assert_bounds=True)
    wm = torch.zeros(2, dtype=torch.int32)
    out, ties = PA.paged_attention_int8_plain(targs[0], kc, vc, targs[3], targs[4], ks, vs,
                                              softcap=softcap, watermarks=wm, return_ties=True)
    diff = np.abs(out.numpy() - np.asarray(ker))
    assert diff.max() <= 5e-2
    clean = ~ties.numpy()
    assert clean.mean() >= 0.5
    assert diff[clean].max(initial=0.0) <= 1e-5, diff[clean].max()
    hd, bs = q.shape[-1], kp.shape[1]
    PA.check_bounds(wm, SPEC.AttnDatapathSpec.for_cache(hd, bs))
    # the gather oracle dequantizes and runs the float math, like the reference's
    oracle = PA.paged_attention_reference(targs[0], kc, vc, targs[3], targs[4], softcap=softcap,
                                          k_scales=ks, v_scales=vs)
    ref = JPA.paged_attention_reference(jargs[0], jkc, jvc, jargs[3], jargs[4], softcap=softcap,
                                        k_scales=jks, v_scales=jvs)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("B,nkv,g,hd,bs,P", [(1, 1, 1, 8, 4, 2), (3, 2, 2, 16, 8, 4),
                                             (4, 2, 1, 32, 16, 3), (2, 4, 4, 8, 8, 2)])
def test_plain_matches_reference_kernel(rng, kv, B, nkv, g, hd, bs, P):
    _check_against_reference(*_random_case(rng, B, nkv, g, hd, bs, P), kv)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_plain_matches_reference_softcap_and_page_boundaries(rng, kv):
    q, kp, vp, tab, _ = _random_case(rng, 3, 2, 2, 16, 8, 4)
    _check_against_reference(q, kp, vp, tab, np.asarray([8, 16, 1], np.int32), kv, softcap=10.0)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 128])
@pytest.mark.parametrize("mode", ["ragged", "exact", "exact±1"])
def test_plain_parity_sweep_block_sizes(rng, kv, bs, mode):
    B, nkv, g, hd, P = 4, 2, 2, 16, 2 if bs == 128 else 3
    q, kp, vp, tab, _ = _random_case(rng, B, nkv, g, hd, bs, P)
    _check_against_reference(q, kp, vp, tab, _sweep_lens(rng, B, bs, P, mode), kv)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("B,nkv,g,hd,bs,P", [(3, 1, 3, 7, 8, 3), (2, 3, 1, 16, 8, 2),
                                             (3, 1, 5, 11, 16, 2)])
def test_plain_parity_odd_heads(rng, kv, B, nkv, g, hd, bs, P):
    _check_against_reference(*_random_case(rng, B, nkv, g, hd, bs, P), kv)


def test_assert_bounds_reaches_the_worst_case_exactly():
    """All q and k codes 127 with one sign, v codes 127, full pages: the
    plain body's watermarks equal the reference record's qk_worst_abs and
    pv_worst_abs and stay inside P_qk and P_pv; the outputs equal the
    reference kernel's."""
    for hd, bs in ((16, 8), (64, 64)):
        jspec = JSPEC.AttnDatapathSpec.for_cache(hd, bs)
        B, nkv, g, P = 2, 2, 3, 2
        nb = B * P
        q = np.full((B, nkv * g, hd), 0.75, np.float32)
        codes = np.full((nb, bs, nkv, hd), 127, np.int8)
        scales = np.full((nb, nkv), 0.01, np.float32)
        tab = np.arange(nb, dtype=np.int32).reshape(B, P)
        lens = np.asarray([P * bs, bs], np.int32)
        wm = torch.zeros(2, dtype=torch.int32)
        out = PA.paged_decode_attention(_t(q), _t(codes), _t(codes), _t(tab), _t(lens),
                                        k_scales=_t(scales), v_scales=_t(scales),
                                        attn_spec=SPEC.AttnDatapathSpec.for_cache(hd, bs),
                                        assert_bounds=True, watermarks=wm)
        assert tuple(wm.tolist()) == (jspec.qk_worst_abs(), jspec.pv_worst_abs())
        assert jspec.qk_worst_abs() <= 2 ** (jspec.p_qk - 1) - 1
        assert jspec.pv_worst_abs() <= 2 ** (jspec.p_pv - 1) - 1
        ker = JPA.paged_decode_attention(*(jnp.asarray(a) for a in (q, codes, codes, tab, lens)),
                                         k_scales=jnp.asarray(scales),
                                         v_scales=jnp.asarray(scales), interpret=True,
                                         assert_bounds=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ker), rtol=1e-6, atol=1e-6)
        tight = SPEC.AttnDatapathSpec(**{**SPEC.AttnDatapathSpec.for_cache(hd, bs).__dict__,
                                         "p_pv": jspec.p_pv - 1})
        with pytest.raises(OverflowError, match="PV accumulator overflow"):
            PA.check_bounds(wm, tight)


# ---------------------------------------------------------------------------
# decode_step_paged and the suffix prefill
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_pair():
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, model


def _jax_paged_cache(jcfg, kv_dtype, rng):
    """A reference paged cache mid-flight: slot 0 at 13 tokens over pages
    [0, 1], slot 1 at 8 (its next write opens page 4 at offset 0, which
    resets an int8 scale), slot 2 idle with a stale row over slot 0's pages
    (an idle write there would corrupt slot 0)."""
    nb, bs, W = 10, 8, 4
    cache = JT.init_paged_cache(jcfg, 3, nb, bs, W,
                                kv_dtype="int8" if kv_dtype == "int8" else None)
    pools = []
    for pool in cache["pools"]:
        shape = pool["k_pages"].shape
        if kv_dtype == "int8":
            new = {k: jnp.asarray(rng.integers(-127, 128, size=shape), jnp.int8)
                   for k in ("k_pages", "v_pages")}
            sc = pool["k_scales"].shape
            new.update({k: jnp.asarray(rng.uniform(0.01, 0.05, size=sc), jnp.float32)
                        for k in ("k_scales", "v_scales")})
        else:
            new = {k: jnp.asarray(rng.normal(size=shape), jnp.float32)
                   for k in ("k_pages", "v_pages")}
        pools.append(new)
    table = np.full((3, W), nb, np.int32)
    table[0, :3], table[1, :3], table[2, :2] = [0, 1, 2], [3, 4, 5], [0, 1]
    cache = dict(cache, pools=tuple(pools), block_table=jnp.asarray(table),
                 seq_lens=jnp.asarray([13, 8, 5], jnp.int32),
                 active=jnp.asarray([True, True, False]))
    return cache


@pytest.mark.parametrize("kv_dtype,j_impl,impl", [("act", "ref", "auto"),
                                                  ("act", "interpret", "reference"),
                                                  ("int8", "ref", "reference"),
                                                  ("int8", "interpret", "auto")])
def test_decode_step_paged_matches_reference(model_pair, rng, kv_dtype, j_impl, impl):
    """The same cache in both packages, one decode step: logits 1e-4, float
    pools 1e-5, int8 codes equal up to a rounding tie (|diff| <= 1 and
    99% equal), scales rtol 1e-6; the idle slot writes nothing."""
    jcfg, cfg, jparams, model = model_pair
    jcache = _jax_paged_cache(jcfg, kv_dtype, rng)
    cache = paged_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg, device="cpu")
    tokens = rng.integers(0, 128, size=(3, 1)).astype(np.int32)
    jlogits, jnew = JT.decode_step_paged(jparams, jnp.asarray(tokens), jcache, jcfg,
                                         attn_impl=j_impl)
    with torch.inference_mode():
        logits, new = T.decode_step_paged(model, _t(tokens), cache, attn_impl=impl)
    np.testing.assert_allclose(logits[..., :cfg.vocab].numpy(),
                               np.asarray(jlogits)[..., :cfg.vocab], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(new["seq_lens"].numpy(), np.asarray(jnew["seq_lens"]))
    nb = jcache["pools"][0]["k_pages"].shape[1]
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        for name, leaf in new["pools"][i].items():
            got, want = leaf[:nb].numpy(), np.asarray(jnew["pools"][s][name][r])
            if leaf.dtype == torch.int8:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
            elif name.endswith("scales"):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_with_prefix_kv_matches_reference(model_pair, rng):
    """Suffix prefill over a cached prefix (``prefix_kv``, ``pos_offset``):
    logits and the suffix-only caches within 1e-4."""
    jcfg, cfg, jparams, model = model_pair
    L, S, max_len = 16, 5, 8
    prompt = rng.integers(0, 128, size=(1, L + S)).astype(np.int32)
    _, jdense = JT.prefill(jparams, {"tokens": jnp.asarray(prompt[:, :L])}, jcfg, L)
    jprefix = tuple({"k": d["k"], "v": d["v"]} for d in jdense)
    jlogits, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(prompt[:, L:])}, jcfg, max_len,
                                 prefix_kv=jprefix, pos_offset=L)
    prefix = [{"k": _t(np.asarray(jprefix[i % cfg.period]["k"][i // cfg.period])),
               "v": _t(np.asarray(jprefix[i % cfg.period]["v"][i // cfg.period]))}
              for i in range(cfg.n_layers)]
    with torch.inference_mode():
        logits, caches = T.prefill(model, {"tokens": _t(prompt[:, L:])}, max_len,
                                   prefix_kv=prefix, pos_offset=L)
        full, _ = T.prefill(model, {"tokens": _t(prompt)}, L + S)
    np.testing.assert_allclose(logits[..., :cfg.vocab].numpy(),
                               np.asarray(jlogits)[..., :cfg.vocab], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits[..., :cfg.vocab].numpy(),
                               full[:, L:, :cfg.vocab].numpy(), rtol=1e-4, atol=1e-4)
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        for name in ("k", "v"):
            np.testing.assert_allclose(caches[i][name].numpy(),
                                       np.asarray(jcache[s][name][r]), rtol=1e-4, atol=1e-4)


def test_init_paged_cache_layout(model_pair):
    jcfg, cfg, _, _ = model_pair
    for kv_dtype in (None, "int8"):
        j = JT.init_paged_cache(jcfg, 3, 10, 8, 4, kv_dtype=kv_dtype)
        p = T.init_paged_cache(cfg, 3, 10, 8, 4, kv_dtype=kv_dtype, device="cpu")
        assert len(p["pools"]) == cfg.n_layers
        for name, leaf in p["pools"][0].items():
            assert leaf.shape == (11, *j["pools"][0][name].shape[2:])  # + the sink page
            assert _np(leaf).dtype == np.asarray(j["pools"][0][name]).dtype
        for k in ("block_table", "seq_lens", "active", "free_list", "free_top",
                  "page_refcounts"):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))
    assert math.isfinite(float(p["pools"][0]["k_scales"].sum()))
