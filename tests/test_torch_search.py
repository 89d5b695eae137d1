"""Port parity of calibrated static KV page scales and the search
launchers: ``quantize_kv_pages_static``, ``_append_kv_page_static``,
``observe_kv_ranges`` / ``search_kv_bits``, the static-KV ``PagedEngine``
and ``decode_step_paged(kv_scales=)``, ``repro_torch.launch.search`` and
``repro_torch.launch.serve --plan``, against the reference
(``tests/test_observe.py:536``, ``:568``).

The engine goldens run on the reference's briefly trained rung, as the
port's other int8 goldens do (ROADMAP Queue C, "int8 pages near a tie").
The card tests of the same paths are ``tests/test_torch_kv_static_kernel.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.kernels.paged_attention import quantize_kv_pages_static as j_quantize_static
from repro.models.layers import _append_kv_page_static as j_append_static
from repro.quant import observe as J
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import SamplerConfig as JSampler
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import search as search_launcher
from repro_torch.launch import serve
from repro_torch.models.layers import Linear, PackedLinear, _append_kv_page_static
from repro_torch.quant import observe as P
from repro_torch.quant.serve_packed import (
    load_flat_artifact,
    pack_decode_params,
    packed_params_from_artifact,
    plan_expected_specs,
)
from repro_torch.quant.spec import DatapathSpec, validate_datapath
from repro_torch.models.transformer import init_model
from repro_torch.serving import PagedConfig, PagedEngine, Request, SamplerConfig
from test_torch_paged_engine import _train_briefly

GREEDY = SamplerConfig(temperature=0.0)
BASE = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)
#: the reference test's conservative uniform register (tests/test_observe.py)
P_UNIFORM = 20
SEARCH_ARGS = ["--arch", "tiny-lm-xs", "--p-bits", str(P_UNIFORM), "--tile", "64",
               "--calib-batches", "1", "--calib-batch-size", "2", "--seq", "32",
               "--eval-batches", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained():
    """The reference engine tests' trained rung, carried into the port; the
    static KV section each package derives from it."""
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    jparams = _train_briefly(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8)).astype(np.int32)
    batches = [{"tokens": prompts}]
    jranges = J.observe_kv_ranges(jparams, jcfg, [{"tokens": jnp.asarray(prompts)}])
    ranges = P.observe_kv_ranges(model, cfg, batches)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, model=model, prompts=prompts,
                jranges=jranges, ranges=ranges)


def _paged(model, **kw):
    engine_kw = {k: kw.pop(k) for k in ("kv_scales", "assert_bounds") if k in kw}
    return PagedEngine(model, None, PagedConfig(**{**BASE, **kw}), GREEDY, device="cpu",
                       **engine_kw)


def _jpaged(jcfg, jparams, **kw):
    engine_kw = {k: kw.pop(k) for k in ("kv_scales",) if k in kw}
    return JPagedEngine(jparams, jcfg, JPagedConfig(**{**BASE, "attn_impl": "ref", **kw}),
                        JSampler(temperature=0.0), **engine_kw)


# ---------------------------------------------------------------------------
# Static quantization: install and append
# ---------------------------------------------------------------------------
def test_quantize_kv_pages_static_matches_reference():
    """Codes bit-equal to the reference's on the same pages and scales,
    drift past the calibrated range hard-clipped at +-127, the stamp the
    broadcast scale; no per-page max enters."""
    rng = np.random.default_rng(0)
    pages = (rng.standard_normal((5, 8, 3, 16)) * 2).astype(np.float32)
    scales = np.asarray([0.01, 0.02, 0.005], np.float32)  # far below the range: clips
    codes, stamp = PA.quantize_kv_pages_static(torch.from_numpy(pages),
                                               torch.from_numpy(scales)[None, :])
    jcodes, jstamp = j_quantize_static(jnp.asarray(pages), jnp.asarray(scales)[None, :])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(stamp.numpy(), np.asarray(jstamp))
    assert codes.dtype == torch.int8 and stamp.shape == (5, 3)
    assert int(codes.abs().max()) == 127
    # a calibrated scale: the codes are the rounded quotients exactly
    fit = np.abs(pages).max(axis=(0, 1, 3)) / 127
    codes, _ = PA.quantize_kv_pages_static(torch.from_numpy(pages), torch.from_numpy(fit)[None])
    jcodes, _ = j_quantize_static(jnp.asarray(pages), jnp.asarray(fit)[None])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


def test_append_kv_page_static_matches_reference():
    """One decode append under static scales: the pool's codes and scale
    rows bit-equal to the reference's (the idle row writes the port's sink
    page, the reference drops it); no existing code is rescaled."""
    rng = np.random.default_rng(1)
    nb, bs, nkv, hd = 6, 8, 2, 16
    pages = rng.integers(-127, 128, size=(nb, bs, nkv, hd)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(nb, nkv)).astype(np.float32)
    x = (rng.standard_normal((3, nkv, hd)) * 3).astype(np.float32)
    page = np.asarray([2, 4, nb], np.int32)  # the last row idle
    off = np.asarray([0, 5, 3], np.int32)
    static = np.asarray([0.02, 0.03], np.float32)
    jp, js = j_append_static(jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(page),
                             jnp.asarray(off), jnp.asarray(x), jnp.asarray(static))
    tp = torch.from_numpy(np.concatenate([pages, np.zeros_like(pages[:1])]))
    ts = torch.from_numpy(np.concatenate([scales, np.zeros_like(scales[:1])]))
    _append_kv_page_static(tp, ts, torch.from_numpy(page).long(), torch.from_numpy(off).long(),
                           torch.from_numpy(x), torch.from_numpy(static))
    np.testing.assert_array_equal(tp[:nb].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts[:nb].numpy(), np.asarray(js))
    keep = np.ones((nb, bs), bool)
    keep[2, 0] = keep[4, 5] = False
    np.testing.assert_array_equal(tp[:nb].numpy()[keep], pages[keep])  # no rescale


# ---------------------------------------------------------------------------
# Observed ranges and the KV section
# ---------------------------------------------------------------------------
def test_observe_kv_ranges_and_search_kv_bits_match_reference(trained):
    """observe_kv_ranges within f32 tolerance of the reference's on the same
    weights and tokens; search_kv_bits identical on the same ranges, with
    and without per-head demotion."""
    c = trained
    assert c["ranges"]["slots"].keys() == c["jranges"]["slots"].keys() == {0}
    for slot, rec in c["ranges"]["slots"].items():
        for key in ("k_absmax", "v_absmax"):
            want = np.asarray(c["jranges"]["slots"][slot][key])
            assert rec[key].shape == want.shape == (c["cfg"].repeats, c["cfg"].n_kv_heads)
            np.testing.assert_allclose(rec[key], want, rtol=1e-5)
    wide = {"slots": {0: {"k_absmax": np.asarray([[4.0, 0.5, 2.0], [1.0, 0.1, 0.2]]),
                          "v_absmax": np.asarray([[0.0, 3.0, 0.7], [2.0, 2.0, 0.4]])}}}
    for ranges in (c["jranges"], wide):
        for kw in ({}, {"low_bits": 4, "low_frac": 0.25}):
            assert P.search_kv_bits(ranges, **kw) == J.search_kv_bits(ranges, **kw)
    kv = P.search_kv_bits(wide, kv_bits=8, low_bits=4)
    assert kv["slots"]["0"]["k_bits"] == [[8, 4, 8], [8, 4, 4]]
    assert kv["slots"]["0"]["v_scale"][0][0] == 1e-8  # an empty head keeps the floor


# ---------------------------------------------------------------------------
# The static-KV paged engine
# ---------------------------------------------------------------------------
def test_static_kv_engine_matches_reference(trained):
    """Greedy streams of the static-KV engine equal the reference's on the
    trained rung; the fingerprint gains ``+kv-static``; the install path
    runs no per-page max (``quantize_kv_pages`` is never called) and
    stamps every written page's scale row with the static value; B3's
    watermarks stay inside P_qk / P_pv."""
    c = trained
    kv = J.search_kv_bits(c["jranges"], kv_bits=8, low_bits=4, low_frac=0.25)
    want = _jpaged(c["jcfg"], c["jparams"], kv_dtype="int8", kv_scales=kv).generate(
        c["prompts"], 8)
    eng = _paged(c["model"], kv_dtype="int8", kv_scales=kv, assert_bounds=True)
    assert eng.datapath_fingerprint.endswith("+kv-static")
    orig = PA.quantize_kv_pages
    from repro_torch.serving import paged_engine as PE

    def refuse(*a, **kw):
        raise AssertionError("the static engine ran the dynamic per-page max")

    PE.quantize_kv_pages = refuse
    try:
        got = eng.generate(c["prompts"], 8)
    finally:
        PE.quantize_kv_pages = orig
    np.testing.assert_array_equal(got, want)
    qk, pv = eng.watermark_values
    assert 0 < qk <= 2 ** (eng.attn_spec.p_qk - 1) - 1
    assert 0 < pv <= 2 ** (eng.attn_spec.p_pv - 1) - 1
    pool = eng.cache["pools"][0]
    stamp = np.asarray(kv["slots"]["0"]["k_scale"][0], np.float32)
    written = pool["k_scales"][:BASE["num_blocks"]].numpy()
    used = written.any(axis=1)
    assert used.any() and (written[used] == stamp).all()


def test_static_kv_plan_roundtrip_and_refusals(trained, tmp_path):
    """The plan's kv section drives the packed engine; its JSON round trip
    gives the same streams bit for bit (and the materialized tensors the
    same); float pools and non-attention slots refuse, and the serving
    observers ride on static pages (fingerprint ``+obs+kv-static``, the
    reference's order)."""
    c = trained
    pmodel = pack_decode_params(c["model"])
    kv = P.search_kv_bits(P.observe_kv_ranges(pmodel, c["cfg"], [{"tokens": c["prompts"]}]),
                          kv_bits=8, low_bits=4, low_frac=0.25)
    out_a = _paged(pmodel, kv_dtype="int8", kv_scales=kv).generate(c["prompts"], 8)
    P.MixedPrecisionPlan(sites={}, kv=kv).save(str(tmp_path / "plan.json"))
    kv_back = P.MixedPrecisionPlan.load(str(tmp_path / "plan.json")).kv
    assert kv_back == kv
    out_b = _paged(pmodel, kv_dtype="int8", kv_scales=kv_back).generate(c["prompts"], 8)
    out_c = _paged(pmodel, kv_dtype="int8",
                   kv_scales=P.plan_kv_scales(kv_back, device="cpu")).generate(c["prompts"], 8)
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_array_equal(out_a, out_c)
    with pytest.raises(ValueError, match="int8"):
        _paged(pmodel, kv_scales=kv)
    bad = {"slots": {"99": kv["slots"]["0"]}, "kv_bits_default": 8}
    with pytest.raises(ValueError, match="not an attention slot"):
        _paged(pmodel, kv_dtype="int8", kv_scales=bad)
    observed = PagedEngine(pmodel, None, PagedConfig(**BASE, kv_dtype="int8"), GREEDY,
                           device="cpu", observe=True, kv_scales=kv)
    assert observed.datapath_fingerprint.endswith("+obs+kv-static")
    np.testing.assert_array_equal(observed.generate(c["prompts"], 8), out_a)
    assert P.plan_kv_scales(None) is None


def test_static_kv_prefix_cache_and_throughput_programs(trained):
    """Every install program takes the static path: suffix and fully
    cached admits (prefix cache) and batched admits and prefill chunks (the
    throughput loop) give the FIFO engine's streams, all under the same
    static scales."""
    from repro_torch.serving import SchedulerPolicy

    c = trained
    kv = J.search_kv_bits(c["jranges"])
    rng = np.random.default_rng(5)
    system = rng.integers(0, c["cfg"].vocab, size=16)
    specs = [(0, np.concatenate([system, rng.integers(0, c["cfg"].vocab, size=5)]), 6),
             (1, system.copy(), 6), (2, rng.integers(0, c["cfg"].vocab, size=20), 6)]

    def reqs():
        return [Request(uid=u, prompt=p.astype(np.int32), max_new=n) for u, p, n in specs]

    want = _paged(c["model"], kv_dtype="int8", kv_scales=kv).serve(reqs())
    runs = {"prefix": dict(prefix_cache=True),
            "throughput": dict(sched=SchedulerPolicy(admit_window=3, batch_max=2,
                                                     prefill_chunk=8))}
    for name, kw in runs.items():
        eng = _paged(c["model"], kv_dtype="int8", kv_scales=kv, **kw)
        got = eng.serve(reqs())
        for u, _, _ in specs:
            np.testing.assert_array_equal(got[u], want[u], err_msg=name)
    assert eng.batch_admits + eng.prefill_chunks > 0


def test_decode_step_paged_kv_scales_match_reference(trained):
    """decode_step_paged(kv_scales=) on the same cache and tokens, both
    through the gather attention: logits within 1e-5 of the reference's,
    pool codes and scale rows equal."""
    from repro.models.transformer import decode_step_paged as j_step
    from repro.models.transformer import init_paged_cache as j_init_cache
    from repro_torch.interop import paged_cache_from_numpy
    from repro_torch.models.transformer import decode_step_paged

    c = trained
    jcfg, cfg = c["jcfg"], c["cfg"]
    kv = P.plan_kv_scales(J.search_kv_bits(c["jranges"]), device="cpu")
    jkv = J.plan_kv_scales(J.search_kv_bits(c["jranges"]))
    jcache = j_init_cache(jcfg, 3, 16, 8, 4, kv_dtype="int8")
    rng = np.random.default_rng(3)
    jcache = dict(jcache, block_table=jnp.asarray([[0, 1, 16, 16], [2, 16, 16, 16],
                                                   [16, 16, 16, 16]], jnp.int32),
                  seq_lens=jnp.asarray([9, 3, 0], jnp.int32),
                  active=jnp.asarray([True, True, False]))
    tokens = rng.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
    seq = tuple({"k": jkv[i]["k"], "v": jkv[i]["v"]} if i in jkv else {}
                for i in range(len(jcfg.pattern)))
    cache = paged_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg, device="cpu")
    jl, jnew = j_step(c["jparams"], jnp.asarray(tokens), jcache, jcfg, kv_scales=seq)
    pseq = tuple(kv.get(i, {}) for i in range(len(cfg.pattern)))
    with torch.inference_mode():
        logits, new = decode_step_paged(c["model"], torch.from_numpy(tokens), cache,
                                        attn_impl="reference", kv_scales=pseq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for i in range(cfg.n_layers):
        r, s = divmod(i, cfg.period)
        for leaf in ("k_pages", "v_pages", "k_scales", "v_scales"):
            np.testing.assert_array_equal(new["pools"][i][leaf][:16].numpy(),
                                          np.asarray(jnew["pools"][s][leaf][r]),
                                          err_msg=f"layer {i} {leaf}")
    np.testing.assert_array_equal(new["seq_lens"].numpy(), np.asarray(jnew["seq_lens"]))


# ---------------------------------------------------------------------------
# Launchers: search -> export -> serve with the plan
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    out = tmp_path_factory.mktemp("search") / "mixed"
    rep = search_launcher.main([*SEARCH_ARGS, "--kv-static", "--out", str(out)])
    return rep, out


def test_search_launcher_end_to_end(searched):
    """The reference test's gates: a strictly tighter budget at bit-identical
    perplexity, certified, static KV; the plan (loadable by the reference
    too) validates the exported artifact, 7 slot sites."""
    from repro.quant.observe import MixedPrecisionPlan as JPlan

    rep, out = searched
    assert rep["savings_rate"] > 1.0
    assert rep["searched"]["ppl"] == rep["uniform"]["ppl"]  # P_I-only plan
    assert rep["searched"]["cert"]["ok"] and rep["searched"]["kv_static"]
    plan = P.MixedPrecisionPlan.load(str(out / "plan.json"))
    assert plan.kv is not None and plan.meta["base_spec"]["p_inner"] == P_UNIFORM
    assert JPlan.load(str(out / "plan.json")).kv == plan.kv
    cfg = get_config("tiny-lm-xs")
    flat, meta = load_flat_artifact(str(out / "quantized"))
    assert meta["plan"] == "plan.json"
    pp = packed_params_from_artifact(flat, init_model(cfg, 0, device="cpu"), cfg, meta=meta)
    expected = plan_expected_specs(cfg, plan, DatapathSpec(**plan.meta["base_spec"]))
    assert len(expected) == 7
    assert validate_datapath(pp, expected) == 7 * cfg.n_layers


def test_serve_launcher_with_plan(searched, capsys):
    """``serve.py --plan``: every packed site validated, the static scales
    reach the int8 paged engine, also observed (``--observe``); the
    refusals of the reference launcher."""
    _, out = searched
    args = ["--arch", "tiny-lm-xs", "--artifact", str(out / "quantized"), "--plan",
            str(out / "plan.json"), "--batch", "2", "--prompt-len", "8", "--max-new", "4",
            "--device", "cpu"]
    paged = serve.main([*args, "--paged", "--block-size", "8", "--kv-dtype", "int8"])
    printed = capsys.readouterr().out
    assert "[serve] plan validated: 28 per-site datapaths match (7 slot sites" in printed
    assert "kv=static" in printed and "kv_scales=static" in printed
    fixed = serve.main(args)
    assert paged.shape == fixed.shape == (2, 12)
    with pytest.raises(SystemExit, match="paged engine: static kv_scales need"):
        serve.main([*args, "--paged", "--block-size", "8"])
    with pytest.raises(SystemExit, match="add --artifact"):
        serve.main(["--arch", "tiny-lm-xs", "--plan", str(out / "plan.json"), "--device",
                    "cpu"])
    serve.main([*args, "--paged", "--block-size", "8", "--kv-dtype", "int8", "--observe"])
    printed = capsys.readouterr().out
    assert "kv_scales=static" in printed
    assert "[serve] observed 7 sites; binding watermark: slot0/" in printed
    # --ckpt-dir restores a checkpoint; a directory without one raises, as
    # in the reference
    with pytest.raises(SystemExit, match="no checkpoint under"):
        search_launcher.main([*SEARCH_ARGS, "--ckpt-dir", str(out / "empty")])


def test_search_launcher_code_changing_moves(tmp_path):
    """``--sparsify 1 --promote-w8 1``: the masked re-calibration certifies
    every int4 site (the sparsified one at 2:4), the promoted site exports
    as w8 and serves as a float Linear, the sparsified one packed 2:4."""
    out = tmp_path / "moves"
    rep = search_launcher.main([*SEARCH_ARGS, "--sparsify", "1", "--promote-w8", "1",
                                "--out", str(out)])
    cfg = get_config("tiny-lm-xs")
    assert rep["searched"]["cert"]["ok"]
    assert rep["searched"]["cert"]["n_certified"] == 6 * cfg.n_layers
    [promoted], [sparse] = rep["searched"]["promoted_w8"], rep["searched"]["sparsified"]
    assert promoted != sparse
    plan = P.MixedPrecisionPlan.load(str(out / "plan.json"))
    flat, meta = load_flat_artifact(str(out / "quantized"))
    pp = packed_params_from_artifact(flat, init_model(cfg, 0, device="cpu"), cfg, meta=meta)
    expected = plan_expected_specs(cfg, plan, DatapathSpec(**plan.meta["base_spec"]))
    assert promoted not in expected and expected[sparse].sparsity == "2:4"
    assert validate_datapath(pp, expected) == 6 * cfg.n_layers
    for i, block in enumerate(pp.layers):
        pc, pn = promoted.split("/")[1].split(".")
        sc, sn = sparse.split("/")[1].split(".")
        assert isinstance(getattr(getattr(block, pc), pn), Linear)
        site = getattr(getattr(block, sc), sn)
        assert isinstance(site, PackedLinear) and site.meta is not None
    specs = {DatapathSpec.from_array(flat[f"layer0/{promoted.split('/')[1]}/spec"]).w_bits}
    assert specs == {8}


def test_search_launcher_defaults_to_the_card():
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        search_launcher.main([a for a in SEARCH_ARGS if a not in ("--device", "cpu")])
    cfg = get_config("smollm-360m")
    f32 = search_launcher.f32_config(cfg)
    assert (cfg.param_dtype, f32.param_dtype, f32.act_dtype) == ("bfloat16", "float32", "float32")
    assert dataclasses.replace(f32, param_dtype=cfg.param_dtype, act_dtype=cfg.act_dtype) == cfg
