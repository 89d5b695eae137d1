"""Port parity of the recurrent families' calibration (the counterpart of
``tests/test_quant_families.py`` for ``tiny-ssm``, ``tiny-xlstm`` and
``tiny-hybrid``): the Mamba, mLSTM and sLSTM adapters' site tables, whole
model calibration through them, the v2 artifact crossing both packages,
and ``launch/quantize.py`` on these rungs.

Each rung is calibrated in both packages on the same weights
(``params_from_numpy``) and token batches (seq 64, 2 calibration + 2 eval
batches of 2). Integer quantities are held exactly: the site tables, every
site's accumulator budgets (W/A bits, T, P_I, P_O) and its certificate,
which is the reference's ``certify`` of the port's codes, field for field.
Codes are held to the reference's own rounding noise, as
``tests/test_torch_calibration.py`` holds the dense rung: the yardstick is
the reference calibrating its weights one ulp larger and one ulp smaller,
and the port's agreement must be within 0.05 of the worse one-ulp run's
overall and within 0.1 per site. The recurrences (the selective scan, the
mLSTM and sLSTM cells) run in f32 and differ by a few ulps between XLA and
PyTorch, so their sites' statistics already carry that noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as j_get_config
from repro.core import PTQConfig as JPTQConfig
from repro.core.overflow import certify as j_certify
from repro.models import transformer as JT
from repro.models.layers import use_packed_backend as j_backend
from repro.quant import calibrate_and_quantize as j_calibrate
from repro.quant.families import get_adapter as j_get_adapter
from repro.quant.serve_packed import export_quantized_artifact as j_export
from repro.quant.serve_packed import load_flat_artifact as j_load
from repro.quant.serve_packed import packed_params_from_artifact as j_from_artifact
from repro.serving import GenerationEngine as JEngine
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.axe import PTQConfig
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import params_from_numpy
from repro_torch.launch import quantize as quantize_launcher
from repro_torch.launch import serve
from repro_torch.models.layers import Linear, PackedLinear
from repro_torch.quant.families import get_adapter
from repro_torch.quant.pipeline import calibrate_and_quantize, quantized_ppl
from repro_torch.quant.serve_packed import (
    export_quantized_artifact,
    load_flat_artifact,
    packed_params_from_artifact,
    serving_params_from_quantized,
)
from repro_torch.serving import GenerationEngine, SamplerConfig

torch.set_float32_matmul_precision("highest")

RUNGS = ["tiny-ssm", "tiny-xlstm", "tiny-hybrid"]
MAX_NEW = 6


def _n(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _setup(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0))
    calib = [data.batch(10_000 + i) for i in range(2)]
    evalb = list(data.eval_batches(2))
    return jcfg, cfg, jparams, model, calib, evalb


@pytest.mark.parametrize("arch", RUNGS)
def test_site_tables_match_reference(arch):
    """Every pattern component's adapter enumerates the reference's sites:
    names, paths, depths, widths, stacks and bias flags."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for spec in cfg.pattern:
        for kind, name in (("mixer", spec.mixer), ("ffn", spec.ffn)):
            if name == "none":
                continue
            sites = get_adapter(kind, name).enumerate_sites(cfg)
            jsites = j_get_adapter(kind, name).enumerate_sites(jcfg)
            assert [(s.name, s.path, s.k, s.c, s.stacked, s.use_bias) for s in sites] == [
                (s.name, s.path, s.k, s.c, s.stacked, s.use_bias) for s in jsites]


@pytest.fixture(scope="module", params=RUNGS)
def calibrated(request):
    """One calibration of the rung in each package, and the reference's on
    its weights one ulp larger and one ulp smaller."""
    arch = request.param
    jcfg, cfg, jparams, model, calib, evalb = _setup(arch)
    jqm = j_calibrate(jparams, jcfg, calib, JPTQConfig())
    jqm_ulp = []
    for factor in (1 + 2**-23, 1 - 2**-24):
        jp = dict(jparams, layers=jax.tree.map(lambda a: a * np.float32(factor),
                                               jparams["layers"]))
        jqm_ulp.append(j_calibrate(jp, jcfg, calib, JPTQConfig()))
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cpu")
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=3,
                                      seed=0)).batch(0)["tokens"]
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, model=model, calib=calib,
                evalb=evalb, jqm=jqm, jqm_ulp=jqm_ulp, qm=qm, prompts=prompts)


def test_calibration_matches_reference(calibrated):
    c = calibrated
    qm, jqm, cfg = c["qm"], c["jqm"], c["cfg"]
    summary, jsummary = qm.cert_summary(), jqm.cert_summary()
    assert summary["ok"] and jsummary["ok"]
    assert summary["n_certified"] == jsummary["n_certified"] > 0
    assert summary["min_headroom_bits"] >= 0.0
    # the calibrated model carries exactly the enumerated sites
    for block in qm.blocks:
        for kind, comp in (("mixer", block.mixer), ("ffn", block.ffn)):
            if comp is None:
                continue
            sites = get_adapter(kind, comp.adapter).enumerate_sites(cfg)
            assert {s.name for s in sites} == set(comp.linears)
            for s in sites:
                want = (s.k, s.c) if s.stacked is None else (s.stacked, s.k, s.c)
                assert tuple(comp.linears[s.name].q_int.shape) == want, s.name
    specs, jspecs = qm.datapath_specs(), jqm.datapath_specs()
    assert specs.keys() == jspecs.keys()
    jlin = dict(jqm.quantized_linears())
    jlin_ulp = [dict(r.quantized_linears()) for r in c["jqm_ulp"]]
    equal = equal_ulp = total = 0
    for name, ql in qm.quantized_linears():
        sp, jsp = specs[name], jspecs[name]
        assert (sp.w_bits, sp.act_bits, sp.tile, sp.p_inner, sp.p_outer, sp.static_act) == (
            jsp.w_bits, jsp.act_bits, jsp.tile, jsp.p_inner, jsp.p_outer, jsp.static_act), name
        assert ql.cert.ok and jlin[name].cert.ok, name
        q = _n(ql.q_int)
        if not ql.stacked:  # the port's certificate is the reference's, field for field
            jcert = j_certify(jnp.asarray(q), ql.cfg.act_alphabet, ql.cfg.p_bits, ql.cfg.tile)
            assert vars(ql.cert) == vars(jcert), name
        jq = np.asarray(jlin[name].q_int)
        same = int((q == jq).sum())
        same_ulp = min(int((np.asarray(r[name].q_int) == jq).sum()) for r in jlin_ulp)
        equal, equal_ulp, total = equal + same, equal_ulp + same_ulp, total + q.size
        print(f"[codes] {name}: {same / q.size:.4f} equal to the reference; the reference "
              f"one ulp apart {same_ulp / q.size:.4f}")
        assert same >= same_ulp - 0.1 * q.size, name
    share, share_ulp = equal / total, equal_ulp / total
    print(f"[codes] overall {share:.4f}; the reference one ulp apart {share_ulp:.4f}")
    assert share >= share_ulp - 0.05
    assert np.isfinite(quantized_ppl(qm, c["evalb"]))


def test_cert_summary_unconstrained_pipeline_not_ok():
    """tests/test_quant_families.py:136 in the port: an unconstrained
    calibration of tiny-ssm issues no certificate, and the summary says so."""
    _, cfg, _, model, calib, _ = _setup("tiny-ssm")
    s = calibrate_and_quantize(model, cfg, calib, PTQConfig(constrain=False),
                               device="cpu").cert_summary()
    assert s == {"n_certified": 0, "min_headroom_bits": None, "min_headroom_site": None,
                 "ok": False}


@pytest.mark.parametrize("arch", ["tiny-xlstm", "tiny-hybrid"])
def test_equalization_toggle(arch):
    """tests/test_quant_families.py:146 on the recurrent rungs: without the
    SmoothQuant fold the model still certifies, with the reference's site
    count, and its perplexity is finite."""
    jcfg, cfg, jparams, model, calib, evalb = _setup(arch)
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(), equalize=False, device="cpu")
    jqm = j_calibrate(jparams, jcfg, calib, JPTQConfig(), equalize=False)
    assert qm.certified and qm.cert_summary()["ok"]
    assert qm.cert_summary()["n_certified"] == jqm.cert_summary()["n_certified"]
    # no fold: the norms are the float model's
    for block, fblock in zip(qm.blocks, model.layers):
        torch.testing.assert_close(block.norm1["w"], fblock.norm1.w, rtol=0, atol=0)
    assert np.isfinite(quantized_ppl(qm, evalb))


def _jax_generate(params, cfg, prompts):
    with j_backend("interpret"):
        return JEngine(params, cfg).generate(prompts, MAX_NEW)


def _port_generate(model, prompts):
    return GenerationEngine(model, sampler=SamplerConfig(), device="cpu",
                            backend="reference").generate(prompts, MAX_NEW)


def test_artifact_crosses_both_ways(calibrated, tmp_path):
    """The port's export has the reference's keys, dtypes, shapes and meta;
    each package loads either package's artifact strictly and serves the
    same greedy tokens. A site of odd depth (sLSTM ``down``, K = 85) has no
    int4 container and serves as a float ``Linear`` (dequantized weight and
    corrected bias) in both packages."""
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
        jtree = j_from_artifact(jflat, c["jparams"], jcfg, meta=jm, strict=True)
        served = packed_params_from_artifact(flat, c["model"], cfg, meta=m, strict=True)
        for i, block in enumerate(served.layers):
            r, s = divmod(i, cfg.period)
            if block.spec.mixer == "slstm":
                assert isinstance(block.mixer.down, Linear)  # K = 85: float
                jdown = jtree["layers"][s]["mixer"]["down"]
                assert "packed" not in jdown and "w" in jdown
                np.testing.assert_allclose(_n(block.mixer.down.w), np.asarray(jdown["w"])[r],
                                           rtol=1e-6, atol=1e-7)
                assert isinstance(block.mixer.up, PackedLinear)  # N = 85: packed
            if block.spec.mixer in ("mamba", "mlstm"):
                assert all(isinstance(getattr(block.mixer, n), PackedLinear)
                           for n in ("in_proj", "out_proj") if hasattr(block.mixer, n))
        np.testing.assert_array_equal(_port_generate(served, prompts),
                                      _jax_generate(jtree, jcfg, prompts))
        if src == "port":
            direct = serving_params_from_quantized(c["qm"])
            np.testing.assert_array_equal(_port_generate(direct, prompts),
                                          _port_generate(served, prompts))


def test_quantize_launcher_recurrent_then_serve(tmp_path, capsys):
    """``launch/quantize.py --arch tiny-xlstm`` (a family the launcher used
    to refuse) exports a certified v2 artifact; both engines serve it."""
    report = quantize_launcher.main([
        "--arch", "tiny-xlstm", "--device", "cpu", "--calib-batches", "1",
        "--calib-batch-size", "2", "--seq", "32", "--eval-batches", "1", "--out", str(tmp_path)])
    n_sites = 5 + 3  # an mLSTM block's and an sLSTM block's
    assert report["cert"]["ok"] and report["cert"]["n_certified"] == n_sites
    assert np.isfinite(report["quant_ppl"]) and np.isfinite(report["float_ppl"])
    argv = ["--arch", "tiny-xlstm", "--artifact", str(tmp_path / "quantized"), "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    fixed = serve.main(argv)
    paged = serve.main(argv + ["--paged", "--block-size", "8"])
    assert fixed.shape == paged.shape == (2, 12)
    np.testing.assert_array_equal(fixed[:, :8], paged[:, :8])
    assert "[quantize] artifact v2" in capsys.readouterr().out


def test_recurrent_configs_match_reference():
    from repro.configs import get_smoke as j_get_smoke
    from repro_torch.configs import get_smoke

    for arch in RUNGS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    for arch in ("xlstm-350m", "jamba-1.5-large-398b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
        assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(j_get_smoke(arch))
