"""Port parity of MoE calibration: the stacked (E, K, C) path of
``quantize_linear``, the MoE adapter's lockstep tap-forward, whole-model
calibration of ``tiny-moe`` (dense and 2:4), the v2 artifact with expert
stacks and routers crossing both packages, and ``launch/quantize.py
--arch tiny-moe``.

Stacked solves are held per expert as the dense solves are held in
``tests/test_torch_gpfq.py``: codes in tie-limited agreement with the
reference (equal up to each channel's first near-tie row), scales exact,
certificates exact per expert (the port's codes certified by both
packages), the corrected (E, 1, C) bias within f32 tolerance where the
codes agree. Whole-model calibration is held to the reference's own
rounding noise, as ``tests/test_torch_calibration.py`` holds the dense
rung: the yardstick is the reference calibrating its weights one ulp
larger and one ulp smaller. Code agreement must be within 0.05 of the
worse one-ulp run's overall and within 0.1 per site; the quantized
perplexity must lie inside the reference's three runs' range widened by
that range on each side (on tiny-moe the exact run sits 1.2-1.5% from its
own one-ulp runs, more than the dense rung's 1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as j_get_config
from repro.core import PTQConfig as JPTQConfig
from repro.core.axe import quantize_linear as j_quantize_linear
from repro.core.overflow import certify_stacked as j_certify_stacked
from repro.models import transformer as JT
from repro.models.layers import use_packed_backend as j_backend
from repro.quant import calibrate_and_quantize as j_calibrate
from repro.quant.families import get_adapter as j_get_adapter
from repro.quant.families.base import TapContext as JTapContext
from repro.quant.pipeline import quantized_ppl as j_quantized_ppl
from repro.quant.serve_packed import export_quantized_artifact as j_export
from repro.quant.serve_packed import load_flat_artifact as j_load
from repro.quant.serve_packed import packed_params_from_artifact as j_from_artifact
from repro.serving import GenerationEngine as JEngine
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core import gpfq as G
from repro_torch.core.axe import PTQConfig, quantize_linear
from repro_torch.core.overflow import StackedCertReport, certify
from repro_torch.core.sparsity import is_2to4
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.gpfq_solve import gpfq_solve
from repro_torch.launch import quantize as quantize_launcher
from repro_torch.launch import serve
from repro_torch.models.layers import PackedLinear
from repro_torch.models.moe import MoE
from repro_torch.quant.families import TapContext, get_adapter
from repro_torch.quant.pipeline import calibrate_and_quantize, quantized_ppl
from repro_torch.quant.serve_packed import (
    export_quantized_artifact,
    load_flat_artifact,
    packed_params_from_artifact,
    serving_params_from_quantized,
)
from repro_torch.serving import GenerationEngine, SamplerConfig
from test_torch_gpfq import _gpfq_trace, _stats_pair, _tie_ok

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ARCH = "tiny-moe"
MAX_NEW = 6


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# quantize_linear on expert stacks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algorithm", ["gpfq", "optq", "rtn", "ep_init"])
def test_stacked_quantize_linear_matches_reference(algorithm, rng):
    e, k, c = 3, 80, 24  # T = 32: a ragged last tile of 16
    s, js = _stats_pair(rng, k)
    w = (rng.standard_normal((e, k, c)) / np.sqrt(k)).astype(np.float32)
    cfg = PTQConfig(algorithm=algorithm, p_bits=12, tile=32)
    jcfg = JPTQConfig(algorithm=algorithm, p_bits=12, tile=32)
    before = gpfq_solve.launches
    ql = quantize_linear(torch.from_numpy(w), s, cfg)
    jql = j_quantize_linear(jnp.asarray(w), js, jcfg)
    assert gpfq_solve.launches == before  # CPU tensors: the plain version
    assert ql.stacked and ql.q_int.shape == (e, k, c) and ql.bias.shape == (e, 1, c)
    np.testing.assert_array_equal(_n(ql.scale), np.asarray(jql.scale))
    assert vars(ql.act) == vars(jql.act)
    np.testing.assert_array_equal(ql.spec.to_array(), jql.spec.to_array())
    jq = np.asarray(jql.q_int)
    if algorithm in ("rtn", "ep_init"):
        np.testing.assert_array_equal(_n(ql.q_int), jq)
    elif algorithm == "gpfq":  # each expert's solve, tie-limited
        h, g = s.gpfq_stats(cfg.gpfq_eta)
        for i in range(e):
            order, q, v = _gpfq_trace(torch.from_numpy(w[i]), G.gh_inverse(h, g), h,
                                      cfg.act_alphabet, cfg.axe, "nearest", True)
            assert torch.equal(ql.q_int[i][order], q)
            _tie_ok(jq[i][_n(order)], q, v)
    same = (_n(ql.q_int) == jq).all(axis=1)  # (E, C): columns with equal codes
    assert same.mean() >= 0.5
    np.testing.assert_allclose(_n(ql.bias)[:, 0][same], np.asarray(jql.bias)[:, 0][same],
                               rtol=1e-4, atol=1e-5)
    # certificates exact per expert: the port's codes certified by both
    assert isinstance(ql.cert, StackedCertReport) and len(ql.cert.reports) == e
    jcert = j_certify_stacked(jnp.asarray(_n(ql.q_int)), jcfg.act_alphabet, 12, 32)
    assert [vars(r) for r in ql.cert.reports] == [vars(r) for r in jcert.reports]
    if algorithm in ("rtn", "ep_init"):  # the same codes: the same certificates
        assert [vars(r) for r in ql.cert.reports] == [vars(r) for r in jql.cert.reports]
    if algorithm != "rtn":  # RTN ignores the budgets
        assert ql.cert.ok and jql.cert.ok


def test_stacked_quantize_linear_is_each_slice_alone(rng):
    """The stack is exactly E independent quantizations of its slices with
    the shared statistics: codes, scales, certificates and the corrected
    bias (bias correction of each slice alone)."""
    e, k, c = 4, 64, 16
    s, _ = _stats_pair(rng, k)
    w = torch.from_numpy((rng.standard_normal((e, k, c)) / np.sqrt(k)).astype(np.float32))
    for sparsity in (None, "2:4"):
        cfg = PTQConfig(p_bits=12, tile=32, sparsity=sparsity)
        ql = quantize_linear(w, s, cfg)
        for i in range(e):
            one = quantize_linear(w[i], s, cfg)
            assert torch.equal(ql.q_int[i], one.q_int) and torch.equal(ql.scale[i], one.scale)
            assert vars(ql.cert.reports[i]) == vars(one.cert)
            torch.testing.assert_close(ql.bias[i, 0], one.bias, rtol=1e-5, atol=1e-6)
            assert vars(one.cert) == vars(certify(one.q_int, cfg.act_alphabet, 12, 32,
                                                  sparsity=sparsity))
        if sparsity:
            assert is_2to4(ql.q_int) and ql.cert.reports[0].sparsity == "2:4"
    with pytest.raises(ValueError, match="input bias"):
        quantize_linear(w, s, PTQConfig(), bias=torch.zeros(c))
    with pytest.raises(TypeError, match="float32"):
        quantize_linear(w.to(torch.bfloat16), s, PTQConfig())


# ---------------------------------------------------------------------------
# The MoE adapter's lockstep tap-forward
# ---------------------------------------------------------------------------
def test_moe_adapter_lockstep_statistics_match_reference():
    """Routing on the quantized stream, the same dispatch applied to both,
    up-projection statistics from the pre-dispatch tokens, the down
    projection's from the dispatched hidden rows: every tap sees the
    reference's inputs, and the block outputs agree."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    rng = np.random.default_rng(11)
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    p = {"router": rng.normal(0, 1 / np.sqrt(d), (d, e)),
         "wg": rng.normal(0, 1 / np.sqrt(d), (e, d, f)),
         "wu": rng.normal(0, 1 / np.sqrt(d), (e, d, f)),
         "wd": rng.normal(0, 1 / np.sqrt(f), (e, f, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xa = rng.normal(0, 1, (2, 16, d)).astype(np.float32)
    xq = (xa + 0.05 * rng.normal(0, 1, xa.shape)).astype(np.float32)

    def recorder(weights, matmul, seen):
        def tap(name, xp, stats_from=None):
            src = stats_from if stats_from is not None else xp
            seen.append((name, [_n(t) for t in xp], [_n(t) for t in src]))
            return tuple(matmul(t, weights[name]) for t in xp)
        return tap

    jseen, seen = [], []
    jy = j_get_adapter("ffn", "moe").forward_with_taps(
        {k: jnp.asarray(v) for k, v in p.items()}, (jnp.asarray(xa), jnp.asarray(xq)),
        JTapContext(cfg=jcfg), recorder({k: jnp.asarray(v) for k, v in p.items()},
                                        lambda t, w: t @ w, jseen))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y = get_adapter("ffn", "moe").forward_with_taps(
        tp, (torch.from_numpy(xa), torch.from_numpy(xq)), TapContext(cfg=cfg),
        recorder(tp, lambda t, w: t @ w, seen))
    assert [s[0] for s in seen] == [s[0] for s in jseen] == ["wg", "wu", "wd"]
    for (name, xs, srcs), (_, jxs, jsrcs) in zip(seen, jseen):
        for a, b in zip(xs + srcs, jxs + jsrcs):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
    assert seen[0][2][0].shape == (2, 16, d)  # wg's statistics: the pre-dispatch tokens
    for a, b in zip(y, jy):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=0, atol=1e-5)
    adapter = get_adapter("ffn", "moe")
    s_eq = torch.linspace(0.5, 2.0, d)
    scaled = adapter.scale_input_weights(tp, s_eq, cfg)
    jscaled = j_get_adapter("ffn", "moe").scale_input_weights(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(_n(s_eq)), jcfg)
    for k in p:
        np.testing.assert_allclose(_n(scaled[k]), np.asarray(jscaled[k]), rtol=1e-6)
    np.testing.assert_allclose(
        _n(adapter.input_weight_absmax(tp, cfg)),
        np.asarray(j_get_adapter("ffn", "moe").input_weight_absmax(
            {k: jnp.asarray(v) for k, v in p.items()}, jcfg)))


# ---------------------------------------------------------------------------
# Whole-model calibration of tiny-moe, dense and 2:4
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[None, "2:4"], ids=["dense", "2to4"])
def calibrated(request):
    """One calibration of tiny-moe in each package on the same weights and
    token batches (seq 64, 2 calibration + 2 eval batches of 2), and the
    reference on its weights one ulp larger and one ulp smaller."""
    sparsity = request.param
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0))
    calib = [data.batch(10_000 + i) for i in range(2)]
    evalb = list(data.eval_batches(2))
    jqm = j_calibrate(jparams, jcfg, calib, JPTQConfig(sparsity=sparsity))
    jqm_ulp = []
    for factor in (1 + 2**-23, 1 - 2**-24):
        jp = dict(jparams, layers=jax.tree.map(lambda a: a * np.float32(factor),
                                               jparams["layers"]))
        jqm_ulp.append(j_calibrate(jp, jcfg, calib, JPTQConfig(sparsity=sparsity)))
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(sparsity=sparsity), device="cpu")
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=3,
                                      seed=0)).batch(0)["tokens"]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, model=model, evalb=evalb, jqm=jqm,
                jqm_ulp=jqm_ulp, qm=qm, prompts=prompts, sparsity=sparsity)


def test_calibration_matches_reference(calibrated):
    c = calibrated
    qm, jqm, e = c["qm"], c["jqm"], c["cfg"].moe.n_experts
    summary, jsummary = qm.cert_summary(), jqm.cert_summary()
    assert summary["ok"] and jsummary["ok"]
    assert summary["n_certified"] == jsummary["n_certified"] == 7 * c["cfg"].n_layers
    specs, jspecs = qm.datapath_specs(), jqm.datapath_specs()
    assert specs.keys() == jspecs.keys()
    jlin = dict(jqm.quantized_linears())
    jlin_ulp = [dict(r.quantized_linears()) for r in c["jqm_ulp"]]
    equal = equal_ulp = total = 0
    for name, ql in qm.quantized_linears():
        sp, jsp = specs[name], jspecs[name]
        assert (sp.w_bits, sp.act_bits, sp.tile, sp.p_inner, sp.p_outer, sp.static_act,
                sp.sparsity) == (jsp.w_bits, jsp.act_bits, jsp.tile, jsp.p_inner,
                                 jsp.p_outer, jsp.static_act, jsp.sparsity)
        if ".w" in name and "ffn" in name:  # an expert stack: a certificate an expert
            assert ql.stacked and len(ql.cert.reports) == e and ql.bias.shape[:2] == (e, 1)
            assert all(r.ok for r in ql.cert.reports)
        assert ql.cert.ok and jlin[name].cert.ok
        if c["sparsity"]:
            assert is_2to4(ql.q_int) and is_2to4(np.asarray(jlin[name].q_int))
        q, jq = _n(ql.q_int), np.asarray(jlin[name].q_int)
        same = int((q == jq).sum())
        same_ulp = min(int((np.asarray(r[name].q_int) == jq).sum()) for r in jlin_ulp)
        equal, equal_ulp, total = equal + same, equal_ulp + same_ulp, total + q.size
        print(f"[codes] {name}: {same / q.size:.4f} equal to the reference; the reference "
              f"one ulp apart {same_ulp / q.size:.4f}")
        assert same >= same_ulp - 0.1 * q.size, name
    share, share_ulp = equal / total, equal_ulp / total
    print(f"[codes] overall {share:.4f}; the reference one ulp apart {share_ulp:.4f}")
    assert share >= share_ulp - 0.05
    # the first layer's attention sites see identical inputs: codes agree
    assert all((_n(qm_l.q_int) == np.asarray(jlin[n].q_int)).mean() >= 0.9
               for n, qm_l in qm.quantized_linears() if n.startswith("layer0/mixer"))
    ppl = quantized_ppl(qm, c["evalb"])
    jppls = [j_quantized_ppl(r, c["evalb"]) for r in (jqm, *c["jqm_ulp"])]
    spread = max(jppls) - min(jppls)
    print(f"[ppl] port {ppl:.4f}; reference {jppls[0]:.4f}, one ulp apart "
          f"{jppls[1]:.4f} / {jppls[2]:.4f}")
    assert min(jppls) - spread <= ppl <= max(jppls) + spread, (ppl, jppls)


def _jax_generate(params, cfg, prompts):
    with j_backend("interpret"):
        return JEngine(params, cfg).generate(prompts, MAX_NEW)


def _port_generate(model, prompts):
    return GenerationEngine(model, sampler=SamplerConfig(), device="cpu",
                            backend="reference").generate(prompts, MAX_NEW)


def test_artifact_crosses_both_ways(calibrated, tmp_path):
    """The port's export has the reference's keys, dtypes and shapes (expert
    stacks (E, K, C), routers under ``ffn.float/router``); each package
    loads either package's artifact and serves the same greedy tokens."""
    c = calibrated
    jcfg, cfg, prompts = c["jcfg"], c["cfg"], c["prompts"]
    artifact, meta = export_quantized_artifact(c["qm"])
    jartifact, jmeta = j_export(c["jqm"])
    assert artifact.keys() == jartifact.keys()
    assert "layer1/ffn.float/router" in artifact and artifact["layer0/ffn.wg/q"].ndim == 3
    for k in artifact:
        assert artifact[k].dtype == jartifact[k].dtype and artifact[k].shape == jartifact[k].shape
    assert meta == jmeta
    save_pytree(artifact, str(tmp_path / "port"), meta)
    j_save_pytree(jartifact, str(tmp_path / "ref"), jmeta)
    for src in ("port", "ref"):
        jflat, jm = j_load(str(tmp_path / src))
        flat, m = load_flat_artifact(str(tmp_path / src))
        jtree = j_from_artifact(jflat, c["jparams"], jcfg, meta=jm)
        served = packed_params_from_artifact(flat, c["model"], cfg, meta=m)
        ffn = served.layers[0].ffn
        assert isinstance(ffn, MoE) and isinstance(ffn.wd, PackedLinear) and ffn.wd.stacked
        assert ffn.wd.spec.static_act and ffn.wd.act_scale.shape == (cfg.moe.n_experts,)
        assert ffn.wd.bias.shape == (cfg.moe.n_experts, 1, cfg.d_model)
        assert (ffn.wd.meta is not None) == (c["sparsity"] is not None)
        np.testing.assert_array_equal(_n(ffn.router.w), flat["layer0/ffn.float/router"])
        jwd = jtree["layers"][0]["ffn"]["wd"]
        for key in ("spec_arr", "act_scale", "act_zp", "col_sums", "bias"):
            np.testing.assert_array_equal(_n(getattr(ffn.wd, key)), np.asarray(jwd[key])[0],
                                          err_msg=key)
        np.testing.assert_array_equal(_port_generate(served, prompts),
                                      _jax_generate(jtree, jcfg, prompts))
        if src == "port":
            direct = serving_params_from_quantized(c["qm"])
            np.testing.assert_array_equal(_port_generate(direct, prompts),
                                          _port_generate(served, prompts))


def test_quantize_launcher_tiny_moe_then_serve(tmp_path, capsys):
    """``launch/quantize.py --arch tiny-moe`` (the family the launcher used
    to refuse) exports a certified v2 artifact; both engines serve it."""
    report = quantize_launcher.main([
        "--arch", ARCH, "--device", "cpu", "--calib-batches", "1", "--calib-batch-size", "2",
        "--seq", "32", "--eval-batches", "1", "--out", str(tmp_path)])
    assert report["cert"]["ok"] and report["cert"]["n_certified"] == 14
    assert np.isfinite(report["quant_ppl"]) and np.isfinite(report["float_ppl"])
    argv = ["--arch", ARCH, "--artifact", str(tmp_path / "quantized"), "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    fixed = serve.main(argv)
    # the paged engine prefills each request alone, and expert capacity is
    # shared by a dispatch group's tokens: its streams may part from the
    # fixed slot's batched prefill, so only the prompts are held equal
    paged = serve.main(argv + ["--paged", "--block-size", "8", "--kv-dtype", "int8"])
    assert fixed.shape == paged.shape == (2, 12)
    np.testing.assert_array_equal(fixed[:, :8], paged[:, :8])
    assert "[quantize] artifact v2" in capsys.readouterr().out
