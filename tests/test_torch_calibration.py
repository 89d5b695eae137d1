"""Port parity of the calibration slice: ``repro_torch.quant.pipeline``
(AXE-GPFQ calibration of a whole model), the v2 artifact it exports and
``repro_torch.launch.quantize``, against ``repro`` on tiny-lm-xs with the
reference's weights carried over by ``params_from_numpy`` and the same
token batches.

Tolerances: certificates hold on both sides with equal datapaths. Codes
are held against the reference's own rounding noise: calibration amplifies
it (a near-tie code that flips changes the quantized stream, and with it
every later SmoothQuant scale, statistic and code), so the yardstick is
the reference's agreement with its own run on the same weights each made
one ulp larger. On tiny-lm-xs that reference-to-reference agreement is
about 0.68 overall, so a fixed 90% bound would test the noise, not the
port. The port's agreement with the reference is held to within 0.05 of
it overall and within 0.1 per site; every component whose upstream codes
(all sites calibrated before it) agree exactly is held to 90% code
agreement per site and, per site, to the reference's static activation
scale and weight scale within rtol 1e-4 and zero point within 1. The
quantized perplexity is within 1% of the reference's, computed live; the
float perplexity within 1e-4. Greedy tokens served from one artifact are
identical in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as j_get_config
from repro.core import PTQConfig as JPTQConfig
from repro.models import transformer as JT
from repro.models.layers import use_packed_backend as j_backend
from repro.quant import calibrate_and_quantize as j_calibrate
from repro.quant.pipeline import float_ppl as j_float_ppl
from repro.quant.pipeline import quantized_ppl as j_quantized_ppl
from repro.quant.serve_packed import export_quantized_artifact as j_export
from repro.quant.serve_packed import load_flat_artifact as j_load
from repro.quant.serve_packed import packed_params_from_artifact as j_from_artifact
from repro.serving import GenerationEngine as JEngine
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.axe import PTQConfig
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.gpfq_solve import gpfq_solve
from repro_torch.launch import quantize as quantize_launcher
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear
from repro_torch.quant.pipeline import (
    calibrate_and_quantize,
    float_ppl,
    quantized_forward,
    quantized_ppl,
)
from repro_torch.quant.serve_packed import (
    export_quantized_artifact,
    load_flat_artifact,
    packed_params_from_artifact,
    serving_params_from_quantized,
)
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec
from repro_torch.serving import GenerationEngine, SamplerConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ARCH = "tiny-lm-xs"
MAX_NEW = 6


@pytest.fixture(scope="module")
def calibrated():
    """One calibration of tiny-lm-xs in each package, on the same weights and
    token batches (seq 64, 2 calibration + 2 eval batches of 2)."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0))
    calib = [data.batch(10_000 + i) for i in range(2)]
    evalb = list(data.eval_batches(2))
    jqm = j_calibrate(jparams, jcfg, calib, JPTQConfig())
    # the yardstick of rounding noise: the reference on every layer weight
    # one ulp larger
    jparams_ulp = dict(jparams, layers=jax.tree.map(lambda a: a * np.float32(1 + 2**-23),
                                                    jparams["layers"]))
    jqm_ulp = j_calibrate(jparams_ulp, jcfg, calib, JPTQConfig())
    before = gpfq_solve.launches
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cpu")
    assert gpfq_solve.launches == before  # CPU tensors: the plain version
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=3,
                                      seed=0)).batch(0)["tokens"]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, model=model, calib=calib, evalb=evalb,
                jqm=jqm, jqm_ulp=jqm_ulp, qm=qm, prompts=prompts)


def test_pipeline_matches_reference(calibrated):
    c = calibrated
    qm, jqm = c["qm"], c["jqm"]
    summary, jsummary = qm.cert_summary(), jqm.cert_summary()
    assert summary["ok"] and jsummary["ok"]
    assert summary["n_certified"] == jsummary["n_certified"] == 7 * c["cfg"].n_layers
    specs, jspecs = qm.datapath_specs(), jqm.datapath_specs()
    assert specs.keys() == jspecs.keys()
    jlin, jlin_ulp = dict(jqm.quantized_linears()), dict(c["jqm_ulp"].quantized_linears())
    equal = equal_ulp = total = 0
    upstream_equal, held, comp = True, [], None
    for name, ql in qm.quantized_linears():
        sp, jsp = specs[name], jspecs[name]
        assert (sp.w_bits, sp.act_bits, sp.tile, sp.p_inner, sp.p_outer, sp.static_act) == (
            jsp.w_bits, jsp.act_bits, jsp.tile, jsp.p_inner, jsp.p_outer, jsp.static_act)
        assert ql.cert.ok and jlin[name].cert.ok
        if name.split(".")[0] != comp:  # a new component: are all earlier codes equal?
            comp, upstream_equal = name.split(".")[0], upstream_equal and equal == total
        q, jq = ql.q_int.numpy(), np.asarray(jlin[name].q_int)
        same, same_ulp = int((q == jq).sum()), int((np.asarray(jlin_ulp[name].q_int) == jq).sum())
        equal, equal_ulp, total = equal + same, equal_ulp + same_ulp, total + q.size
        print(f"[codes] {name}: {same / q.size:.4f} equal to the reference; the reference one "
              f"ulp apart {same_ulp / q.size:.4f}")
        assert same >= same_ulp - 0.1 * q.size, name
        if upstream_equal:
            held.append(name)
            assert same / q.size >= 0.9, name
            np.testing.assert_allclose(sp.act_scale, jsp.act_scale, rtol=1e-4)
            assert abs(sp.act_zp - jsp.act_zp) <= 1
            np.testing.assert_allclose(ql.scale.numpy(), np.asarray(jlin[name].scale),
                                       rtol=1e-4)
    share, share_ulp = equal / total, equal_ulp / total
    print(f"[codes] overall {share:.4f} equal to the reference; the reference one ulp apart "
          f"{share_ulp:.4f}; scales held at {held}")
    assert held[:4] == [f"layer0/mixer.{s}" for s in ("wq", "wk", "wv", "wo")]
    assert share >= share_ulp - 0.05
    ppl, jppl = quantized_ppl(qm, c["evalb"]), j_quantized_ppl(jqm, c["evalb"])
    jppl_ulp = j_quantized_ppl(c["jqm_ulp"], c["evalb"])
    fppl, jfppl = float_ppl(c["model"], c["cfg"], c["evalb"]), j_float_ppl(
        c["jparams"], c["jcfg"], c["evalb"])
    print(f"[ppl] quantized: port {ppl:.4f}, reference {jppl:.4f}, the reference one ulp "
          f"apart {jppl_ulp:.4f}; float: port {fppl:.4f}, reference {jfppl:.4f}")
    assert abs(ppl - jppl) <= 0.01 * jppl, (ppl, jppl)
    assert abs(fppl - jfppl) <= 1e-4 * jfppl, (fppl, jfppl)
    logits = quantized_forward(qm, c["evalb"][0])
    assert logits.shape == (2, 64, c["cfg"].vocab_padded) and torch.isfinite(logits).all()


def _jax_generate(params, cfg, prompts):
    with j_backend("interpret"):
        return JEngine(params, cfg).generate(prompts, MAX_NEW)


def _port_generate(model, prompts):
    return GenerationEngine(model, sampler=SamplerConfig(), device="cpu",
                            backend="reference").generate(prompts, MAX_NEW)


def test_artifact_crosses_both_ways(calibrated, tmp_path):
    c = calibrated
    jcfg, cfg, prompts = c["jcfg"], c["cfg"], c["prompts"]
    artifact, meta = export_quantized_artifact(c["qm"])
    jartifact, jmeta = j_export(c["jqm"])
    assert artifact.keys() == jartifact.keys()
    for k in artifact:
        assert artifact[k].dtype == jartifact[k].dtype and artifact[k].shape == jartifact[k].shape
    assert meta == jmeta

    save_pytree(artifact, str(tmp_path / "port"), meta)
    j_save_pytree(jartifact, str(tmp_path / "ref"), jmeta)
    for src in ("port", "ref"):
        jflat, jm = j_load(str(tmp_path / src))
        flat, m = load_flat_artifact(str(tmp_path / src))
        assert jm == m and jflat.keys() == flat.keys()
        for k in flat:
            np.testing.assert_array_equal(np.asarray(flat[k]), np.asarray(jflat[k]))
        jtree = j_from_artifact(jflat, c["jparams"], jcfg, meta=jm)
        served = packed_params_from_artifact(flat, c["model"], cfg, meta=m)
        wq = served.layers[0].mixer.wq
        assert isinstance(wq, PackedLinear) and wq.spec.static_act
        jspec = np.asarray(jtree["layers"][0]["mixer"]["wq"]["spec_arr"][0])
        np.testing.assert_array_equal(wq.spec_arr.numpy(), jspec)
        np.testing.assert_array_equal(_port_generate(served, prompts),
                                      _jax_generate(jtree, jcfg, prompts))
        if src == "port":
            direct = serving_params_from_quantized(c["qm"])
            np.testing.assert_array_equal(_port_generate(direct, prompts),
                                          _port_generate(served, prompts))


def test_plan_overrides_and_refusals(calibrated):
    c = calibrated
    cfg, model, calib = c["cfg"], c["model"], c["calib"][:1]
    wide = DatapathSpec(p_inner=20, tile=64)
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(algorithm="rtn"),
                                plan={"slot0/mixer.wq": wide}, device="cpu")
    spec = qm.datapath_specs()["layer0/mixer.wq"]
    assert (spec.p_inner, spec.tile) == (20, 64)
    assert qm.datapath_specs()["layer0/mixer.wk"].p_inner == 16
    with pytest.raises(DatapathMismatchError, match="unknown sites"):
        calibrate_and_quantize(model, cfg, calib, PTQConfig(algorithm="rtn"),
                               plan={"slot0/mixer.nope": wide}, device="cpu")
    bf16 = T.init_model(cfg.scaled(param_dtype="bfloat16", act_dtype="bfloat16"), 0,
                        device="cpu")
    with pytest.raises(TypeError, match="float32"):
        calibrate_and_quantize(bf16, bf16.cfg, calib, PTQConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="2:4 slice"):
        calibrate_and_quantize(model, cfg, calib, PTQConfig(sparsity="2:4"), device="cpu")


def test_calibration_defaults_to_the_card(calibrated):
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    c = calibrated
    with pytest.raises(RuntimeError, match="cuda"):
        calibrate_and_quantize(c["model"], c["cfg"], c["calib"], PTQConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        quantize_launcher.main(["--arch", ARCH])


def test_quantize_launcher_then_serve_cpu(tmp_path, capsys):
    report = quantize_launcher.main([
        "--arch", ARCH, "--device", "cpu", "--calib-batches", "1", "--calib-batch-size", "2",
        "--seq", "32", "--eval-batches", "1", "--out", str(tmp_path)])
    assert report["cert"]["ok"] and report["datapath"].startswith("W4A8u T=128 P_I=16")
    assert np.isfinite(report["quant_ppl"]) and np.isfinite(report["float_ppl"])
    out = serve.main(["--arch", ARCH, "--artifact", str(tmp_path / "quantized"), "--batch", "2",
                      "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    assert out.shape == (2, 12)
    printed = capsys.readouterr().out
    assert "[quantize] artifact v2" in printed and "tok/s" in printed
    for flag in (["--sparsity", "2:4"], ["--ckpt-dir", str(tmp_path)], ["--arch", "tiny-moe"]):
        argv = ["--arch", ARCH, "--device", "cpu"] + flag
        with pytest.raises(SystemExit, match="not yet ported"):
            quantize_launcher.main(argv)
