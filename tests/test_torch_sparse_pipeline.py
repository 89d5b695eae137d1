"""Port parity of the 2:4 slice end to end, on tiny-lm-xs in float32 on the
CPU: ``calibrate_and_quantize(PTQConfig(sparsity="2:4"))`` against the
reference's, the exported artifact (``meta`` leaves) in both packages, the
JAX sparse artifact carried into the port by ``interop``, greedy serving
on the fixed-slot and the paged engine, and the launchers.

Tolerances, as ``tests/test_torch_calibration.py`` sets them for the dense
pipeline: codes are held to the reference's agreement with its own runs on
weights one ulp larger and one ulp smaller (calibration amplifies near-tie
flips through every later statistic; the worse of the two runs is the
yardstick, since one run alone may happen to cross no tie before a site):
within 0.05 of it overall and 0.1 per site. The quantized perplexity is
held to the same yardstick: within the larger distance of the two one-ulp
runs' perplexities from the reference's. (A fixed 1% bound, as the dense
test uses, lies below that noise here: the reference's own one-ulp runs
land 1.4% and 4.1% from it on this rung.) Certificates, the 2:4 pattern
and the register floors are exact properties of each side's own codes.
Greedy tokens served from one artifact are identical.
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
from repro.quant.pipeline import quantized_ppl as j_quantized_ppl
from repro.quant.serve_packed import export_quantized_artifact as j_export
from repro.quant.serve_packed import load_flat_artifact as j_load
from repro.quant.serve_packed import packed_params_from_artifact as j_from_artifact
from repro.serving import GenerationEngine as JEngine
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.axe import PTQConfig
from repro_torch.core.overflow import min_feasible_p_bits
from repro_torch.core.sparsity import is_2to4
from repro_torch.data import DataConfig, TokenBatcher
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.gpfq_solve import gpfq_solve
from repro_torch.kernels.w4a8_mm import w4a8_matmul, w4a8_sparse_matmul
from repro_torch.launch import quantize as quantize_launcher
from repro_torch.launch import serve
from repro_torch.models.layers import PackedLinear
from repro_torch.quant.pipeline import calibrate_and_quantize, quantized_ppl
from repro_torch.quant.serve_packed import (
    export_quantized_artifact,
    load_flat_artifact,
    packed_params_from_artifact,
    serving_params_from_quantized,
)
from repro_torch.serving import GenerationEngine, PagedConfig, PagedEngine, SamplerConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ARCH = "tiny-lm-xs"
MAX_NEW = 6
SPARSE = dict(sparsity="2:4")


@pytest.fixture(scope="module")
def calibrated():
    """The sparse calibration of tiny-lm-xs in each package on the same
    weights and batches (seq 64, 2 calibration + 2 eval batches of 2), the
    reference's one-ulp yardsticks, and the port's dense run."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0))
    calib = [data.batch(10_000 + i) for i in range(2)]
    evalb = list(data.eval_batches(2))
    jqm = j_calibrate(jparams, jcfg, calib, JPTQConfig(**SPARSE))
    jqm_ulp = []
    for factor in (1 + 2**-23, 1 - 2**-24):  # one ulp up, one ulp down
        jp = dict(jparams, layers=jax.tree.map(lambda a, f=factor: a * np.float32(f),
                                               jparams["layers"]))
        jqm_ulp.append(j_calibrate(jp, jcfg, calib, JPTQConfig(**SPARSE)))
    before = gpfq_solve.launches
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(**SPARSE), device="cpu")
    assert gpfq_solve.launches == before  # CPU tensors: the plain version
    qm_dense = calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cpu")
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=3,
                                      seed=0)).batch(0)["tokens"]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, model=model, evalb=evalb, jqm=jqm,
                jqm_ulp=jqm_ulp, qm=qm, qm_dense=qm_dense, prompts=prompts)


def test_sparse_pipeline_matches_reference(calibrated):
    c = calibrated
    qm, jqm = c["qm"], c["jqm"]
    summary, jsummary = qm.cert_summary(), jqm.cert_summary()
    assert summary["ok"] and jsummary["ok"]
    assert summary["n_certified"] == jsummary["n_certified"] == 7 * c["cfg"].n_layers
    specs, jspecs = qm.datapath_specs(), jqm.datapath_specs()
    jlin = dict(jqm.quantized_linears())
    jlin_ulp = [dict(r.quantized_linears()) for r in c["jqm_ulp"]]
    dense = dict(c["qm_dense"].quantized_linears())
    equal = equal_ulp = total = fell = 0
    for name, ql in qm.quantized_linears():
        np.testing.assert_array_equal(specs[name].to_array()[[0, 1, 2, 3, 4, 5, 6, 10]],
                                      jspecs[name].to_array()[[0, 1, 2, 3, 4, 5, 6, 10]])
        assert specs[name].sparsity == "2:4"
        assert ql.cert.ok and ql.cert.sparsity == jlin[name].cert.sparsity == "2:4"
        assert is_2to4(ql.q_int) and is_2to4(np.asarray(jlin[name].q_int))
        floor, floor_dense = min_feasible_p_bits(ql.cert), min_feasible_p_bits(dense[name].cert)
        assert floor <= floor_dense, (name, floor, floor_dense)
        fell += floor < floor_dense
        q, jq = ql.q_int.numpy(), np.asarray(jlin[name].q_int)
        same = int((q == jq).sum())
        same_ulp = min(int((np.asarray(r[name].q_int) == jq).sum()) for r in jlin_ulp)
        equal, equal_ulp, total = equal + same, equal_ulp + same_ulp, total + q.size
        assert same >= same_ulp - 0.1 * q.size, name
    share, share_ulp = equal / total, equal_ulp / total
    print(f"[codes] overall {share:.4f} equal to the reference; the reference one ulp apart "
          f"{share_ulp:.4f} (worse run per site); {fell} sparse floors below dense")
    assert share >= share_ulp - 0.05
    ppl, jppl = quantized_ppl(qm, c["evalb"]), j_quantized_ppl(jqm, c["evalb"])
    jppl_ulp = [j_quantized_ppl(r, c["evalb"]) for r in c["jqm_ulp"]]
    print(f"[ppl] 2:4 quantized: port {ppl:.4f}, reference {jppl:.4f}, the reference one ulp "
          f"apart {jppl_ulp[0]:.4f} / {jppl_ulp[1]:.4f}")
    assert abs(ppl - jppl) <= max(abs(p - jppl) for p in jppl_ulp), (ppl, jppl, jppl_ulp)


def _jax_generate(params, cfg, prompts):
    with j_backend("interpret"):
        return JEngine(params, cfg).generate(prompts, MAX_NEW)


def _port_generate(model, prompts):
    return GenerationEngine(model, sampler=SamplerConfig(), device="cpu").generate(prompts,
                                                                                   MAX_NEW)


def _paged_generate(model, prompts):
    eng = PagedEngine(model, None, PagedConfig(block_size=8, num_blocks=16, max_concurrency=3),
                      SamplerConfig(temperature=0.0), device="cpu")
    out = eng.generate(prompts, MAX_NEW)
    assert eng.pool_state.free_top == 0  # every page back on the free list
    return out


def test_sparse_artifact_crosses_both_ways_and_serves(calibrated, tmp_path):
    c = calibrated
    jcfg, cfg, prompts = c["jcfg"], c["cfg"], c["prompts"]
    artifact, meta = export_quantized_artifact(c["qm"])
    jartifact, jmeta = j_export(c["jqm"])
    assert artifact.keys() == jartifact.keys()
    for k in artifact:
        assert artifact[k].dtype == jartifact[k].dtype and artifact[k].shape == jartifact[k].shape
    assert meta == jmeta and meta["datapath"].endswith("sparsity=2:4")
    save_pytree(artifact, str(tmp_path / "port"), meta)
    j_save_pytree(jartifact, str(tmp_path / "ref"), jmeta)
    for src in ("port", "ref"):
        jflat, jm = j_load(str(tmp_path / src))
        flat, m = load_flat_artifact(str(tmp_path / src))
        assert jm == m and jflat.keys() == flat.keys()
        jtree = j_from_artifact(jflat, c["jparams"], jcfg, meta=jm)
        served = packed_params_from_artifact(flat, c["model"], cfg, meta=m)
        wq, jwq = served.layers[0].mixer.wq, jtree["layers"][0]["mixer"]["wq"]
        assert isinstance(wq, PackedLinear) and wq.meta is not None
        np.testing.assert_array_equal(wq.packed.numpy(), np.asarray(jwq["packed"][0]))
        np.testing.assert_array_equal(wq.meta.numpy(), np.asarray(jwq["meta"][0]))
        want = _jax_generate(jtree, jcfg, prompts)
        before = (w4a8_matmul.launches, w4a8_sparse_matmul.launches)
        np.testing.assert_array_equal(_port_generate(served, prompts), want)
        np.testing.assert_array_equal(_paged_generate(served, prompts), want)
        assert (w4a8_matmul.launches, w4a8_sparse_matmul.launches) == before  # plain on CPU
        # the reference's own sparse serving tree, carried across by interop
        carried = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg, device="cpu")
        assert carried.layers[0].mixer.wq.meta is not None
        np.testing.assert_array_equal(_port_generate(carried, prompts), want)
        if src == "port":
            direct = serving_params_from_quantized(c["qm"])
            np.testing.assert_array_equal(_port_generate(direct, prompts), want)


def test_sparse_quantize_launcher_then_serve_cpu(tmp_path, capsys):
    report = quantize_launcher.main([
        "--arch", ARCH, "--device", "cpu", "--sparsity", "2:4", "--calib-batches", "1",
        "--calib-batch-size", "2", "--seq", "32", "--eval-batches", "1", "--out", str(tmp_path)])
    assert report["cert"]["ok"] and report["datapath"].endswith("sparsity=2:4")
    assert np.isfinite(report["quant_ppl"])
    args = ["--arch", ARCH, "--artifact", str(tmp_path / "quantized"), "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    fixed = serve.main(args)
    paged = serve.main(args + ["--paged", "--block-size", "8"])
    assert fixed.shape == paged.shape == (2, 12)
    np.testing.assert_array_equal(fixed, paged)
    printed = capsys.readouterr().out
    assert "sparsity=2:4" in printed and "[serve] paged engine" in printed
