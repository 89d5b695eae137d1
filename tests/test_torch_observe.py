"""Port parity of the mixed-precision search (``repro_torch.quant.observe``
records and search, ``plan_expected_specs``) against the reference
(``repro.quant.observe``), mirroring ``tests/test_observe.py`` on
tiny-lm-xs.

Calibration agrees between the packages only tie-limited (ROADMAP Queue C,
"Calibration noise"), so a search over two independent calibrations cannot
be compared exactly. The reference's calibrated ``QuantizedModel`` is
carried into the port instead (``interop.quantized_model_from_numpy``:
codes, scales, specs, biases, certificates and observer state), and both
packages observe, search and re-spec the *same* integer codes: integers
(floors, repeats, plans, accumulator bits, certificates) must match
exactly, floats within the reference tests' tolerances.

``test_two_site_overrides_roundtrip_hybrid`` (``tests/test_observe.py:432``)
runs on the hybrid rung (Mamba + MLP, attention + MoE), the reference's
calibration carried into the port. ``test_observer_structurally_transparent`` and
``test_observed_serving_bit_identical_with_report`` (``:487``, ``:502``)
are mirrored in ``tests/test_torch_saturation.py``, with the serving
observers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as j_get_config
from repro.core import PTQConfig as JPTQConfig
from repro.core import min_feasible_p_bits as j_min_feasible_p_bits
from repro.data import DataConfig, TokenBatcher
from repro.models.layers import use_packed_backend as j_backend
from repro.models.transformer import init_model as j_init_model
from repro.quant import calibrate_and_quantize as j_calibrate
from repro.quant import observe as J
from repro.quant.observe.records import ObserverReport as JObserverReport
from repro.quant.observe.records import SiteObservation as JSiteObservation
from repro.quant.pipeline import quantized_ppl as j_quantized_ppl
from repro.quant.serve_packed import export_quantized_artifact as j_export
from repro.quant.serve_packed import load_flat_artifact as j_load
from repro.quant.serve_packed import packed_params_from_artifact as j_from_artifact
from repro.quant.serve_packed import plan_expected_specs as j_plan_expected_specs
from repro.quant.spec import DatapathSpec as JDatapathSpec
from repro.quant.spec import validate_datapath as j_validate_datapath
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import SamplerConfig as JSampler
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.alphabet import outer_accumulator_bits
from repro_torch.core.axe import PTQConfig
from repro_torch.core.overflow import certify, min_feasible_p_bits
from repro_torch.interop import params_from_numpy, quantized_model_from_numpy
from repro_torch.models.layers import Linear, PackedLinear
from repro_torch.quant import observe as P
from repro_torch.quant.observe.records import ObserverReport, SiteObservation
from repro_torch.quant.pipeline import calibrate_and_quantize, quantized_ppl
from repro_torch.quant.serve_packed import (
    export_quantized_artifact,
    load_flat_artifact,
    packed_params_from_artifact,
    plan_expected_specs,
    serving_params_from_quantized,
)
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec, validate_datapath
from repro_torch.serving import PagedConfig, PagedEngine, SamplerConfig

torch.set_float32_matmul_precision("highest")

ARCH = "tiny-lm-xs"
#: the reference test's conservative uniform register (tests/test_observe.py)
P_UNIFORM = 20
#: the certificate's fields, compared one by one
CERT_FIELDS = ("ok", "p_bits", "p_outer", "tile", "worst_hi", "worst_lo", "headroom_bits",
               "outer_hi", "outer_lo", "outer_ok", "k", "sparsity")
SPEC_FIELDS = ("w_bits", "act_bits", "act_signed", "tile", "p_inner", "p_outer",
               "static_act", "act_scale", "act_zp", "version", "sparsity")


def _spec(s) -> dict:
    return None if s is None else {f: getattr(s, f) for f in SPEC_FIELDS}


def _plan_specs(plan) -> dict:
    return {k: _spec(v) for k, v in plan.items()}


@pytest.fixture(scope="module")
def calibrated():
    """The reference test's fixture (one uniform calibration at P_I = 20,
    T = 64), its search and re-spec in each package over the same codes."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jparams = j_init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2))
    calib = [data.batch(100 + i) for i in range(2)]
    evalb = list(data.eval_batches(2))
    jptq = JPTQConfig(w_bits=4, act_bits=8, p_bits=P_UNIFORM, tile=64, algorithm="gpfq",
                      constrain=True)
    jqm = j_calibrate(jparams, jcfg, calib, jptq)
    jreport = J.collect_observations(jqm)
    jplan = J.search_plan(jreport)
    jqm2 = J.apply_plan(jqm, jplan)
    qm = quantized_model_from_numpy(jqm, cfg, device="cpu")
    report = P.collect_observations(qm)
    plan = P.search_plan(report)
    qm2 = P.apply_plan(qm, plan)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, model=model, calib=calib, evalb=evalb,
                jqm=jqm, jreport=jreport, jplan=jplan, jqm2=jqm2, qm=qm, report=report,
                plan=plan, qm2=qm2)


# ---------------------------------------------------------------------------
# Observer records
# ---------------------------------------------------------------------------
def test_carried_model_is_the_reference_model(calibrated):
    """The carried model computes the reference's simulated-integer forward
    (perplexity within 1e-5) and holds its codes and certificates as they
    are."""
    c = calibrated
    jlin = dict(c["jqm"].quantized_linears())
    for name, ql in c["qm"].quantized_linears():
        np.testing.assert_array_equal(ql.q_int.numpy(), np.asarray(jlin[name].q_int))
        assert {f: getattr(ql.cert, f) for f in CERT_FIELDS} == {
            f: getattr(jlin[name].cert, f) for f in CERT_FIELDS}
    ppl, jppl = quantized_ppl(c["qm"], c["evalb"]), j_quantized_ppl(c["jqm"], c["evalb"])
    assert abs(ppl - jppl) <= 1e-5 * jppl, (ppl, jppl)


def test_report_matches_reference(calibrated):
    """collect_observations: per site the same floor, repeats, weights,
    depth, spec and headroom; activation snapshots within f32 tolerance;
    the same report totals and binding site."""
    c = calibrated
    report, jreport, cfg = c["report"], c["jreport"], c["cfg"]
    assert list(report.sites) == list(jreport.sites)
    assert len(report.sites) == 7  # one slot, 7 sites (wq wk wv wo wg wu wd)
    for name, s in report.sites.items():
        js = jreport.sites[name]
        assert (s.k, s.n_repeats, s.p_floor, s.n_weights) == (
            js.k, js.n_repeats, js.p_floor, js.n_weights), name
        assert s.n_repeats == cfg.n_layers
        assert s.headroom_bits == js.headroom_bits and s.headroom_bits > 0, name
        assert _spec(s.spec) == _spec(js.spec), name
        assert s.p_floor <= s.p_inner == P_UNIFORM and s.slack_bits == js.slack_bits
        assert s.act.keys() == js.act.keys()
        for key, v in s.act.items():
            np.testing.assert_allclose(v, js.act[key], rtol=1e-6, err_msg=f"{name} {key}")
        assert s.act["n_batches"] > 0 and s.act["lo"] <= s.act["hi"]
        assert s.act["min_seen"] <= s.act["max_seen"] and s.act["absmax"] >= 0
    assert report.summary() == jreport.summary()
    assert report.accumulator_bits() == 7 * cfg.n_layers * P_UNIFORM
    assert report.floor_accumulator_bits() < report.accumulator_bits()


def test_min_feasible_p_bits_certificate_exact(calibrated):
    """The floor is exact and the reference's: the codes certify at p* and
    fail at p* - 1, on every site."""
    c = calibrated
    jlin = dict(c["jqm"].quantized_linears())
    for name, ql in c["qm"].quantized_linears():
        k = int(ql.q_int.shape[-2])
        p_star = min_feasible_p_bits(ql.cert, k)
        assert p_star == j_min_feasible_p_bits(jlin[name].cert, k), name
        assert p_star <= ql.spec.p_inner
        assert bool(certify(ql.q_int, ql.cfg.act_alphabet, p_star, ql.spec.tile))
        assert not bool(certify(ql.q_int, ql.cfg.act_alphabet, p_star - 1, ql.spec.tile))


def test_cert_summary_names_binding_site(calibrated):
    c = calibrated
    s, js = c["qm"].cert_summary(), c["jqm"].cert_summary()
    assert s == js and s["ok"]


# ---------------------------------------------------------------------------
# Search: the reference's plan, bit for bit
# ---------------------------------------------------------------------------
def _mid_budget(plan):
    floor, uniform = plan.meta["floor_bits"], plan.meta["uniform_bits"]
    return floor + (uniform - floor) // 2


@pytest.mark.parametrize("case", ["default", "explicit_budget", "margin", "promote_w8",
                                  "sparsify", "promote_and_sparsify"])
def test_search_plan_matches_reference(calibrated, case):
    """search_plan: identical site -> (w_bits, P_I, P_O, sparsity, ...),
    accumulator bits and meta in every case of the reference tests."""
    c = calibrated
    kw = {"default": {}, "explicit_budget": {"acc_budget_bits": _mid_budget(c["jplan"])},
          "margin": {"margin_bits": 2}, "promote_w8": {"promote_w8": 1},
          "sparsify": {"sparsify": 2},
          "promote_and_sparsify": {"promote_w8": 1, "sparsify": 2}}[case]
    plan, jplan = P.search_plan(c["report"], **kw), J.search_plan(c["jreport"], **kw)
    assert _plan_specs(plan) == _plan_specs(jplan)
    assert plan.meta == jplan.meta
    bits = P.plan_accumulator_bits(plan, c["report"])
    assert bits == J.plan_accumulator_bits(jplan, c["jreport"])
    assert bits == plan.meta["searched_bits"] or kw.get("promote_w8") or kw.get("sparsify")
    if case == "default":
        assert bits < c["report"].accumulator_bits()
        for name, spec in plan.items():
            assert spec.p_inner >= c["report"].sites[name].p_floor
    if case == "explicit_budget":
        assert bits <= kw["acc_budget_bits"]
    if case == "margin":
        for s in c["report"]:
            p = plan.get(s.name)
            assert (p.p_inner if p is not None else s.p_inner) >= min(s.p_floor + 2, s.p_inner)
    if case == "promote_w8":
        [promoted] = plan.meta["promoted_w8"]
        assert promoted == c["report"].binding_site()
        assert (plan[promoted].w_bits, plan[promoted].p_inner) == (8, 32)
    if "sparsify" in case:
        for n in plan.meta["sparsified"]:
            assert plan[n].sparsity == "2:4" and plan[n].p_inner == P_UNIFORM


def test_search_refuses_budget_below_floor(calibrated):
    c = calibrated
    floor = c["plan"].meta["floor_bits"]
    for search, report in ((P.search_plan, c["report"]), (J.search_plan, c["jreport"])):
        with pytest.raises(ValueError, match="below the certificate-exact floor"):
            search(report, acc_budget_bits=floor - 1)


def _reports(spec_cls, obs_cls, report_cls, sites):
    """The same synthetic report in both packages, in both insertion orders."""
    def site(name, headroom, k=64, w_bits=4, sparsity=None):
        spec = dataclasses.replace(spec_cls(tile=16, p_inner=16, p_outer=18),
                                   w_bits=w_bits, sparsity=sparsity)
        return obs_cls(name=name, k=k, n_repeats=1, spec=spec, headroom_bits=headroom,
                       p_floor=13, n_weights=k * 8, act={})

    made = [site(*a, **kw) for a, kw in sites]
    return (report_cls(sites={s.name: s for s in made}),
            report_cls(sites={s.name: s for s in reversed(made)}))


EQUAL_HEADROOM = [((f"slot0/mixer.w{c}", 3.0), {}) for c in "qkvo"]


@pytest.mark.parametrize("kw", [{"promote_w8": 2}, {"sparsify": 2},
                                {"acc_budget_bits": 4 * 13 + 2}])
def test_search_order_deterministic_on_equal_headroom(kw):
    """Equal headroom tie-breaks on the site name in both packages: the same
    plan in any insertion order, and the reference's plan."""
    fwd, rev = _reports(DatapathSpec, SiteObservation, ObserverReport, EQUAL_HEADROOM)
    jfwd, _ = _reports(JDatapathSpec, JSiteObservation, JObserverReport, EQUAL_HEADROOM)
    p1, p2, jp = P.search_plan(fwd, **kw), P.search_plan(rev, **kw), J.search_plan(jfwd, **kw)
    assert _plan_specs(p1) == _plan_specs(p2) == _plan_specs(jp)
    assert p1.meta == jp.meta  # binding_site is the first minimum in insertion order
    assert p1.meta["promoted_w8"] == p2.meta["promoted_w8"]
    assert p1.meta["sparsified"] == p2.meta["sparsified"]
    expect = ["slot0/mixer.wk", "slot0/mixer.wo"]
    if "promote_w8" in kw:
        assert p1.meta["promoted_w8"] == expect
    if "sparsify" in kw:
        assert p1.meta["sparsified"] == expect


def test_sparsify_move_marks_most_headroomed_eligible_sites():
    """Eligible sites (K % 4 == 0, w <= 4, dense) by descending headroom,
    as the reference marks them."""
    sites = [(("slot0/mixer.wq", 5.0), {}), (("slot0/mixer.wk", 3.0), {}),
             (("slot0/mixer.wv", 4.0), {"k": 66}),
             (("slot0/ffn.wu", 6.0), {"sparsity": "2:4"}),
             (("slot0/ffn.wd", 7.0), {"w_bits": 8})]
    report, _ = _reports(DatapathSpec, SiteObservation, ObserverReport, sites)
    jreport, _ = _reports(JDatapathSpec, JSiteObservation, JObserverReport, sites)
    plan, jplan = P.search_plan(report, sparsify=2), J.search_plan(jreport, sparsify=2)
    assert plan.meta["sparsified"] == ["slot0/mixer.wk", "slot0/mixer.wq"]
    assert _plan_specs(plan) == _plan_specs(jplan) and plan.meta == jplan.meta
    for n in plan.meta["sparsified"]:
        assert plan[n].sparsity == "2:4" and plan[n].p_inner == 16


# ---------------------------------------------------------------------------
# Re-spec: certificates re-issued bit for bit
# ---------------------------------------------------------------------------
def test_apply_plan_reissues_reference_certificates(calibrated):
    """apply_plan: every site's re-issued certificate and spec equal the
    reference's field by field; the codes are shared, so the searched
    perplexity is bit-identical to the uniform one."""
    c = calibrated
    jlin = dict(c["jqm2"].quantized_linears())
    for name, ql in c["qm2"].quantized_linears():
        jql = jlin[name]
        assert {f: getattr(ql.cert, f) for f in CERT_FIELDS} == {
            f: getattr(jql.cert, f) for f in CERT_FIELDS}, name
        assert _spec(ql.spec) == _spec(jql.spec), name
        assert (ql.cfg.p_bits, ql.cfg.constrain) == (jql.cfg.p_bits, jql.cfg.constrain)
        assert ql.q_int is dict(c["qm"].quantized_linears())[name].q_int
    assert c["qm2"].cert_summary() == c["jqm2"].cert_summary()
    assert c["qm2"].cert_summary()["ok"]
    assert quantized_ppl(c["qm2"], c["evalb"]) == quantized_ppl(c["qm"], c["evalb"])


@pytest.mark.parametrize("what", ["unknown_site", "code_alphabet", "register_too_small"])
def test_apply_plan_refusals(calibrated, what):
    """The same refusals as the reference: a key naming no site, a w_bits
    move, and a register the codes do not fit."""
    c = calibrated
    results = []
    for pkg, qm, plan in ((P, c["qm"], c["plan"]), (J, c["jqm"], c["jplan"])):
        name, spec = sorted(plan.items())[0]
        if what == "unknown_site":
            bad, err, match = {"slot9/mixer.nope": spec}, DatapathMismatchError, "unknown sites"
        elif what == "code_alphabet":
            bad, err, match = ({name: dataclasses.replace(spec, w_bits=8)},
                               DatapathMismatchError, "code alphabet")
        else:
            bad, err, match = ({name: dataclasses.replace(spec, p_inner=spec.p_inner - 1)},
                               ValueError, "do not fit")
        with pytest.raises(ValueError, match=match) as info:
            pkg.apply_plan(qm, pkg.MixedPrecisionPlan(sites=bad))
        results.append(type(info.value).__name__)
        if err is DatapathMismatchError and pkg is P:
            assert isinstance(info.value, DatapathMismatchError)
    assert results[0] == results[1]


def test_plan_json_crosses_both_ways(tmp_path, calibrated):
    """plan.json written by either package loads in the other to an equal
    plan: sites, kv section and meta."""
    c = calibrated
    kv = {"kv_bits_default": 8, "slots": {"0": {"k_scale": [[0.5, 0.25]], "v_scale": [[1.0, 2.0]],
                                               "k_bits": [[8, 4]], "v_bits": [[8, 8]]}}}
    plan = P.MixedPrecisionPlan(sites=dict(c["plan"].sites), kv=kv, meta=dict(c["plan"].meta))
    jplan = J.MixedPrecisionPlan(sites=dict(c["jplan"].sites), kv=kv, meta=dict(c["jplan"].meta))
    plan.save(str(tmp_path / "port.json"))
    jplan.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    for path in ("port.json", "ref.json"):
        back = P.MixedPrecisionPlan.load(str(tmp_path / path))
        jback = J.MixedPrecisionPlan.load(str(tmp_path / path))
        assert _plan_specs(back) == _plan_specs(jback) == _plan_specs(jplan)
        for k in back:
            assert back[k] == plan[k]
        assert back.kv == jback.kv == kv and back.meta == jback.meta == plan.meta
    with pytest.raises(ValueError, match="plan_version"):
        P.MixedPrecisionPlan.from_json({"plan_version": 2})


def test_promote_w8_drives_recalibration(calibrated):
    """A w_bits move goes through the pipeline: the promoted site loses its
    certificate, every other site stays certified, and it serves as a
    float Linear outside plan_expected_specs' packed map."""
    c = calibrated
    cfg = c["cfg"]
    plan_p = P.search_plan(c["report"], promote_w8=1)
    [promoted] = plan_p.meta["promoted_w8"]
    with pytest.raises(DatapathMismatchError, match="code alphabet"):
        P.apply_plan(c["qm"], plan_p)
    ptq = PTQConfig(w_bits=4, act_bits=8, p_bits=P_UNIFORM, tile=64, algorithm="gpfq")
    qm3 = calibrate_and_quantize(c["model"], cfg, c["calib"], ptq, plan=plan_p, device="cpu")
    s = qm3.cert_summary()
    assert s["ok"] and s["n_certified"] == 6 * cfg.n_layers
    sp = serving_params_from_quantized(qm3)
    site = promoted.split("/")[1].split(".")
    assert isinstance(getattr(getattr(sp.layers[0], site[0]), site[1]), Linear)
    base = dataclasses.replace(qm3.ptq.to_datapath_spec(cfg.d_model), static_act=True)
    expected = plan_expected_specs(cfg, plan_p, base)
    assert promoted not in expected and len(expected) == 6
    assert validate_datapath(sp, expected) == 6 * cfg.n_layers
    with pytest.raises(DatapathMismatchError, match="unknown sites"):
        calibrate_and_quantize(c["model"], cfg, c["calib"], ptq, device="cpu",
                               plan=P.MixedPrecisionPlan(sites={"slot0/mixer.nope": base}))


# ---------------------------------------------------------------------------
# Mixed-precision artifacts: export, strict reload, per-site validation
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixed_artifact(tmp_path_factory, calibrated):
    """The reference test's heterogeneous artifact (the searched plan with
    its first site one bit above its floor), exported by each package from
    the same codes."""
    c = calibrated

    def bumped(pkg, plan, report):
        sites = dict(plan.sites)
        name = sorted(sites)[0]
        spec, k = sites[name], report.sites[name].k
        p_new = spec.p_inner + 1
        p_out = (p_new if spec.tile is None or spec.tile >= k
                 else outer_accumulator_bits(p_new, k, spec.tile))
        sites[name] = dataclasses.replace(spec, p_inner=p_new, p_outer=p_out)
        return pkg.MixedPrecisionPlan(sites=sites, meta=dict(plan.meta))

    plan_h, jplan_h = bumped(P, c["plan"], c["report"]), bumped(J, c["jplan"], c["jreport"])
    qm2h, jqm2h = P.apply_plan(c["qm"], plan_h), J.apply_plan(c["jqm"], jplan_h)
    root = tmp_path_factory.mktemp("mixed")
    artifact, meta = export_quantized_artifact(qm2h)
    save_pytree(artifact, str(root / "port"), meta)
    jartifact, jmeta = j_export(jqm2h)
    j_save_pytree(jartifact, str(root / "ref"), jmeta)
    return dict(root=root, plan_h=plan_h, jplan_h=jplan_h, qm2h=qm2h, artifact=artifact,
                meta=meta, jartifact=jartifact, jmeta=jmeta)


def test_mixed_artifact_equals_reference_export(mixed_artifact):
    m = mixed_artifact
    assert m["meta"] == m["jmeta"] and m["meta"]["mixed_precision"] is True
    assert m["artifact"].keys() == m["jartifact"].keys()
    for k, v in m["artifact"].items():
        np.testing.assert_array_equal(v, np.asarray(m["jartifact"][k]), err_msg=k)


@pytest.mark.parametrize("src", ["port", "ref"])
def test_mixed_artifact_and_plan_validate_both_ways(mixed_artifact, calibrated, src):
    """Either package's mixed artifact validates in both packages through
    plan_expected_specs / validate_datapath: 7 slot sites (the port counts
    each layer's packed site, 7 x n_layers; the reference each stacked
    leaf, 7)."""
    c, m = calibrated, mixed_artifact
    cfg, jcfg = c["cfg"], c["jcfg"]
    flat, meta = load_flat_artifact(str(m["root"] / src))
    jflat, jmeta = j_load(str(m["root"] / src))
    assert meta["mixed_precision"] is True and jmeta == meta
    pp = packed_params_from_artifact(flat, c["model"], cfg, meta=meta)
    jpp = j_from_artifact(jflat, c["jparams"], jcfg, meta=jmeta)
    base = dataclasses.replace(c["qm2"].ptq.to_datapath_spec(cfg.d_model), static_act=True)
    jbase = JDatapathSpec(**{f: getattr(base, f) for f in SPEC_FIELDS})
    expected = plan_expected_specs(cfg, m["plan_h"], base)
    jexpected = j_plan_expected_specs(jcfg, m["jplan_h"], jbase)
    assert {k: _spec(v) for k, v in expected.items()} == {
        k: _spec(v) for k, v in jexpected.items()}
    assert len(expected) == 7
    assert validate_datapath(pp, expected) == 7 * cfg.n_layers
    assert j_validate_datapath(jpp, jexpected) == 7
    assert sum(isinstance(mod, PackedLinear) for mod in pp.modules()) == 7 * cfg.n_layers


def test_mixed_artifact_serves_bit_identical(mixed_artifact, calibrated):
    """Disk -> engine greedy identity against the in-memory plan (the
    artifact carries everything; nothing is re-derived at load)."""
    c, m = calibrated, mixed_artifact
    cfg = c["cfg"]
    flat, meta = load_flat_artifact(str(m["root"] / "ref"))
    sp_mem = serving_params_from_quantized(m["qm2h"])
    sp_disk = packed_params_from_artifact(flat, c["model"], cfg, meta=meta)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)

    def paged(model):
        return PagedEngine(model, cfg, PagedConfig(block_size=8, num_blocks=16,
                                                   max_concurrency=3, max_pages_per_seq=4,
                                                   chunk_max=4, attn_impl="reference"),
                           SamplerConfig(temperature=0.0), device="cpu",
                           backend="reference").generate(prompts, 8)

    np.testing.assert_array_equal(paged(sp_mem), paged(sp_disk))


def test_partial_and_unknown_mixed_artifacts_rejected(mixed_artifact, calibrated):
    """A dropped repeat or site raises (mixed artifacts load strictly), as
    does an artifact site the model does not enumerate, a plan key naming
    no site, and a site map that is not total."""
    c, m = calibrated, mixed_artifact
    cfg = c["cfg"]
    flat, meta = load_flat_artifact(str(m["root"] / "ref"))
    partial = {k: v for k, v in flat.items() if not k.startswith("layer0/mixer.wq/")}
    with pytest.raises(DatapathMismatchError, match="does not cover"):
        packed_params_from_artifact(partial, c["model"], cfg, meta=meta, strict=False)
    dropped = {k: v for k, v in flat.items() if "/mixer.wq/" not in k}
    with pytest.raises(DatapathMismatchError, match="does not cover"):
        packed_params_from_artifact(dropped, c["model"], cfg, meta=meta)
    extra = dict(flat)
    extra["layer0/mixer.bogus/q"] = np.zeros((4, 4), np.int8)
    with pytest.raises(DatapathMismatchError, match="does not enumerate"):
        packed_params_from_artifact(extra, c["model"], cfg, meta=meta)

    base = dataclasses.replace(c["qm2"].ptq.to_datapath_spec(cfg.d_model), static_act=True)
    with pytest.raises(DatapathMismatchError, match="does not enumerate"):
        plan_expected_specs(cfg, P.MixedPrecisionPlan(sites={"slot0/ffn.nope": base}), base)
    sp = serving_params_from_quantized(c["qm2"])
    expected = plan_expected_specs(cfg, c["plan"], base)
    assert validate_datapath(sp, expected) == 7 * cfg.n_layers
    short = dict(expected)
    short.pop("slot0/mixer.wq")
    with pytest.raises(DatapathMismatchError, match="not named by"):
        validate_datapath(sp, short)
    with pytest.raises(DatapathMismatchError, match="no packed site"):
        validate_datapath(sp, {**expected, "slot0/mixer.ghost": base})
    with pytest.raises(DatapathMismatchError):
        validate_datapath(sp, {**expected, "slot0/mixer.wq": dataclasses.replace(
            expected["slot0/mixer.wq"], p_inner=12)})


def test_two_site_overrides_roundtrip_hybrid(tmp_path):
    """tests/test_observe.py:432 on the port: on tiny-hybrid (Mamba + MLP,
    attention + MoE; the reference's calibration carried across, so both
    packages plan the same codes), two sites with different per-site
    datapaths re-spec and certify, export the reference's mixed artifact
    exactly, and serve bit-identically from memory and from disk through
    the paged engine, as the reference's engine serves its own export."""
    jcfg, cfg = j_get_config("tiny-hybrid"), get_config("tiny-hybrid")
    jparams = j_init_model(jax.random.key(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2))
    jptq = JPTQConfig(w_bits=4, act_bits=8, p_bits=P_UNIFORM, tile=None, algorithm="gpfq",
                      constrain=True)
    jqm = j_calibrate(jparams, jcfg, [data.batch(0)], jptq)
    qm = quantized_model_from_numpy(jqm, cfg, device="cpu")

    def two_site_plan(pkg, report):
        a, b = [s for s in report if s.headroom_bits is not None][:2]
        return pkg.MixedPrecisionPlan(sites={
            a.name: dataclasses.replace(a.spec, p_inner=a.p_floor, p_outer=a.p_floor),
            b.name: dataclasses.replace(b.spec, p_inner=min(b.p_floor + 1, b.p_inner),
                                        p_outer=min(b.p_floor + 1, b.p_inner))})

    plan = two_site_plan(P, P.collect_observations(qm))
    jplan = two_site_plan(J, J.collect_observations(jqm))
    assert _plan_specs(plan) == _plan_specs(jplan)
    qm2, jqm2 = P.apply_plan(qm, plan), J.apply_plan(jqm, jplan)
    assert qm2.cert_summary()["ok"] and jqm2.cert_summary()["ok"]
    artifact, meta = export_quantized_artifact(qm2)
    jartifact, jmeta = j_export(jqm2)
    assert meta["mixed_precision"] is True and meta == jmeta
    assert artifact.keys() == jartifact.keys()
    for k in artifact:
        np.testing.assert_array_equal(artifact[k], np.asarray(jartifact[k]), err_msg=k)
    save_pytree(artifact, str(tmp_path / "port"), meta)
    j_save_pytree(jartifact, str(tmp_path / "ref"), jmeta)
    flat, meta2 = load_flat_artifact(str(tmp_path / "port"))
    sp_mem = serving_params_from_quantized(qm2)
    sp_disk = packed_params_from_artifact(flat, model, cfg, meta=meta2)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    paged = PagedConfig(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4,
                        chunk_max=4)

    def generate(m):
        return PagedEngine(m, cfg, paged, SamplerConfig(temperature=0.0), device="cpu",
                           backend="reference").generate(prompts, 8)

    out_mem = generate(sp_mem)
    np.testing.assert_array_equal(out_mem, generate(sp_disk))
    jflat, jm = j_load(str(tmp_path / "ref"))
    jtree = j_from_artifact(jflat, jparams, jcfg, meta=jm)
    with j_backend("interpret"):
        want = JPagedEngine(jtree, jcfg, JPagedConfig(block_size=8, num_blocks=16,
                                                      max_concurrency=3, max_pages_per_seq=4,
                                                      chunk_max=4, attn_impl="ref"),
                            JSampler(temperature=0.0)).generate(prompts, 8)
    np.testing.assert_array_equal(out_mem, want)
