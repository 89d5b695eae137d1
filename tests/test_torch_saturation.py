"""Port parity of the serving observers (``repro_torch.quant.observe.
saturation``, the tap seam in ``models/layers.py``, the slot scopes of
``decode_step_paged`` and ``PagedEngine(observe=True)``) against the
reference's, mirroring ``tests/test_observe.py:476-533`` on its
``packed_setup`` (smollm-360m smoke cut to 2 layers and a 128-token vocab,
RTN-packed, 3 prompts of 8 tokens).

* Counters fed the same numbers (``record``/``report``, the device block's
  fold), the accumulator watermark on the same packed codes (dense and 2:4)
  and the KV-head watermarks on the same int8 pool codes must be equal,
  bit for bit; the port's pools carry a garbage sink page the report must
  leave out.
* One tap on one ``x`` writes the device row the reference's ``record``
  receives, exactly.
* Whole engines on the same params and prompts (the port's attention
  ``reference`` impl beside the reference's ``ref``, so both decode the
  same float attention over int8 pages): the same labels, ``n_calls`` and
  ``clip_total`` exact, clip counts and code extrema exact or
  tie-limited (each difference explained by tap inputs within 1e-3 of a
  rounding boundary, the rule of the GPFQ kernel's checks). A static-act
  artifact (the reference's calibration carried in with
  ``interop.quantized_model_from_numpy``) makes clips occur.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.layers as PL
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import PTQConfig as JPTQConfig
from repro.models import transformer as JT
from repro.models.layers import _record_site_observation as j_record_site
from repro.models.layers import use_packed_backend as j_backend
from repro.quant import calibrate_and_quantize as j_calibrate
from repro.quant.observe import SaturationCounters as JCounters
from repro.quant.observe import saturation as JS
from repro.quant.serve_packed import pack_decode_params as j_pack
from repro.quant.serve_packed import serving_params_from_quantized as j_serving
from repro.quant.spec import AttnDatapathSpec as JAttnSpec
from repro.quant.spec import DatapathSpec as JDatapathSpec
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PagedEngine as JPagedEngine
from repro.serving import SamplerConfig as JSampler
from repro.serving import SchedulerPolicy as JPolicy
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.alphabet import act_alphabet
from repro_torch.interop import params_from_numpy, quantized_model_from_numpy, to_tensor
from repro_torch.launch import serve
from repro_torch.models.layers import PackedLinear
from repro_torch.quant.observe import SaturationCounters
from repro_torch.quant.observe import saturation as PS
from repro_torch.quant.serve_packed import serving_params_from_quantized
from repro_torch.quant.spec import AttnDatapathSpec, DatapathSpec
from repro_torch.serving import PagedConfig, PagedEngine, SamplerConfig, SchedulerPolicy

GREEDY = SamplerConfig(temperature=0.0)
BASE = dict(block_size=8, num_blocks=16, max_concurrency=3, max_pages_per_seq=4, chunk_max=4)
THROUGHPUT = dict(admit_window=2, batch_max=2)
#: the tie band: a tap input within this many code units of a rounding
#: boundary may round either way between the packages
TIE_EPS = 1e-3
LABELS = tuple(f"slot0/{k}" for k in ("ffn.wd", "ffn.wg", "ffn.wu", "mixer.wk", "mixer.wo",
                                      "mixer.wq", "mixer.wv"))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def packed_setup():
    """The reference test's fixture, the port's model carried from the
    reference's packed tree (the same codes)."""
    jcfg = j_get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    cfg = get_smoke("smollm-360m").scaled(n_layers=2, vocab=128)
    jparams = JT.init_model(jax.random.key(0), jcfg)
    jp = j_pack(jparams, jcfg)
    model = params_from_numpy(_numpy_tree(jp), cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 128, size=(3, 8)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jp=jp, model=model, prompts=prompts)


@pytest.fixture(scope="module")
def static_setup(packed_setup):
    """A calibrated static-act artifact (the pipeline's RTN solver, W4A8,
    its activation quantizers observed on one batch of 2 x 16 tokens): the
    reference's serving tree and the port's from the carried
    ``QuantizedModel``. Serving traffic outside the calibrated range
    clips."""
    c = packed_setup
    calib = [{"tokens": np.random.default_rng(7).integers(0, 128, size=(2, 16)).astype(
        np.int32)}]
    jqm = j_calibrate(c["jparams"], c["jcfg"], calib,
                      JPTQConfig(w_bits=4, act_bits=8, algorithm="rtn", constrain=False))
    model = serving_params_from_quantized(quantized_model_from_numpy(jqm, c["cfg"],
                                                                     device="cpu"))
    return dict(c, jp=j_serving(jqm), model=model)


def _paged(model, *, observe=False, sched=None, backend="kernel", **kw):
    extra = {} if sched is None else {"sched": SchedulerPolicy(**sched)}
    return PagedEngine(model, None, PagedConfig(**{**BASE, **kw}, **extra), GREEDY,
                       device="cpu", observe=observe, backend=backend)


def _jpaged(c, *, sched=None, **kw):
    extra = {} if sched is None else {"sched": JPolicy(**sched)}
    return JPagedEngine(c["jp"], c["jcfg"],
                        JPagedConfig(**{**BASE, "attn_impl": "ref", **kw}, **extra),
                        JSampler(temperature=0.0), observe=True)


# ---------------------------------------------------------------------------
# Counters fed the same numbers
# ---------------------------------------------------------------------------
def _records(seed: int):
    rng = np.random.default_rng(seed)
    return [(LABELS[int(rng.integers(len(LABELS)))], int(rng.integers(1, 3000)),
             int(rng.integers(0, 40)), float(rng.integers(0, 20)), float(rng.integers(200, 256)))
            for _ in range(40)]


def test_record_report_and_fold_match_reference(packed_setup):
    """``record`` then ``report`` in both packages, and the same calls
    written into the port's device block and folded: equal dicts, the
    watermark sections (params given) included."""
    c = packed_setup
    recs = _records(0)
    ref, port, dev = JCounters(), SaturationCounters(), SaturationCounters()
    dev.allocate(LABELS, "cpu")
    for label, n, clip, lo, hi in recs:
        ref.record(label, n, clip, lo, hi)
        port.record(label, n, clip, lo, hi)
        dev.write(label, n, torch.tensor(clip), torch.tensor(lo), torch.tensor(hi))
    dev.fold()
    want = ref.report()
    assert port.report() == want
    assert dev.report() == want
    assert set(want["sites"]) == set(LABELS)
    # the block is zeroed in place: a second fold adds nothing
    ptr = dev.block.buf.data_ptr()
    dev.fold()
    assert dev.report() == want and dev.block.buf.data_ptr() == ptr
    assert not dev.block.counts.any()
    assert dev.block.extrema[:, 0].eq(math.inf).all() and dev.block.extrema[:, 1].eq(
        -math.inf).all()
    # with the packed params: the watermark sections agree bit for bit
    with_wm = dev.report(params=c["model"])
    assert with_wm == ref.report(params=c["jp"])
    assert all("watermark_bits" in s for s in with_wm["sites"].values())
    dev.reset()
    assert dev.report() == {"sites": {}} and not dev.block.counts.any()


@pytest.mark.parametrize("sparsity", [None, "2:4"])
def test_leaf_watermark_matches_reference(packed_setup, sparsity):
    """The watermark on the same packed codes (all repeats of a slot site)
    and extrema, dense and 2:4 (the compressed codes, as the reference
    takes them): bit-equal."""
    c = packed_setup
    jp = c["jp"]
    model = c["model"]
    if sparsity is not None:
        jp = j_pack(c["jparams"], c["jcfg"], ptq=JDatapathSpec(sparsity="2:4"))
        model = params_from_numpy(_numpy_tree(jp), c["cfg"], device="cpu")
    for (lo, hi) in ((0.0, 255.0), (17.0, 203.0), (-128.0, 127.0)):
        for kind, name in (("mixer", "wq"), ("mixer", "wo"), ("ffn", "wd")):
            jleaf = jp["layers"][0][kind][name]
            leaves = PS._find_site_leaf(model, f"slot0/{kind}.{name}")
            assert len(leaves) == c["cfg"].n_layers
            assert (leaves[0].meta is not None) == (sparsity is not None)
            want = JS._leaf_watermark(jleaf, lo, hi)
            assert want and PS._leaf_watermark(leaves, lo, hi) == want


def test_kv_watermarks_match_reference_and_skip_the_sink_page():
    """Per-KV-head watermarks on the same int8 pool codes: the reference's
    stacked pools (two attention slots, two repeats) against the port's
    per-layer pools, each with an extra sink page of -128 codes (idle-row
    garbage) that must not enter the maxima; a float pool reports
    nothing."""
    rng = np.random.default_rng(3)
    R, period, nb, bs, nkv, hd = 2, 2, 5, 8, 3, 16
    jpools, pools = [], [None] * (R * period)
    for s in range(period):
        pool = {}
        for side in ("k", "v"):
            lim = int(rng.integers(40, 128))
            pool[f"{side}_pages"] = rng.integers(-lim, lim + 1, size=(R, nb, bs, nkv, hd)).astype(
                np.int8)
            pool[f"{side}_scales"] = rng.uniform(0.01, 0.1, size=(R, nb, nkv)).astype(np.float32)
        jpools.append(pool)
        for r in range(R):
            layer = {}
            for side in ("k", "v"):
                sink = np.full((1, bs, nkv, hd), -128, np.int8)
                layer[f"{side}_pages"] = torch.from_numpy(
                    np.concatenate([pool[f"{side}_pages"][r], sink]))
                layer[f"{side}_scales"] = torch.from_numpy(np.concatenate(
                    [pool[f"{side}_scales"][r], np.full((1, nkv), 9.0, np.float32)]))
            pools[r * period + s] = layer
    jspec, spec = JAttnSpec.for_cache(hd, bs), AttnDatapathSpec.for_cache(hd, bs)
    want = JS._kv_watermarks(tuple(jpools), jspec)
    got = PS._kv_watermarks(pools, spec, period)
    assert got == want and set(got) == {"slot0", "slot1"}
    assert all(h["k_code_max"] <= 127 for heads in got.values() for h in heads.values())
    floats = [{"k_pages": p["k_pages"].float(), "v_pages": p["v_pages"].float()} for p in pools]
    assert PS._kv_watermarks(floats, spec, period) == {}


# ---------------------------------------------------------------------------
# One tap on one x
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["static-unsigned", "static-signed", "dynamic"])
def test_tap_row_matches_reference_record(packed_setup, mode):
    """One tap on one ``x`` (from numpy, built to clip on both sides under
    the static quantizer): the port's device row equals what the
    reference's tap hands its ``record``, exactly."""
    c = packed_setup
    jleaf = {k: np.asarray(v)[0] for k, v in c["jp"]["layers"][0]["mixer"]["wq"].items()
             if k != "spec"}
    K = 2 * jleaf["packed"].shape[0]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 1, K)) * 2.0).astype(np.float32)
    signed = mode == "static-signed"
    scale, zp = (0.01, 0.0) if signed else (0.012, 120.0)
    leaf = PackedLinear(packed=to_tensor(jleaf["packed"], "cpu"),
                        scale=to_tensor(jleaf["scale"], "cpu"),
                        col_sums=to_tensor(jleaf["col_sums"], "cpu"))
    jspec = JDatapathSpec()
    if mode != "dynamic":
        jspec = JDatapathSpec(static_act=True, act_signed=signed)
        jleaf.update(act_scale=np.float32(scale), act_zp=np.float32(zp))
        leaf.spec = DatapathSpec(static_act=True, act_signed=signed)
        leaf.act_scale, leaf.act_zp = torch.tensor(scale), torch.tensor(zp)
    jleaf["spec"] = jspec
    label = "slot0/mixer.wq"
    ref = JCounters()
    j_record_site(ref, label, jnp.asarray(x), jax.tree.map(jnp.asarray, jleaf))
    jax.effects_barrier()
    obs = SaturationCounters()
    obs.allocate((label,), "cpu")
    PL._record_site_observation(obs, label, torch.from_numpy(x), leaf)
    got = obs.block.read()[label]
    want = ref.sites[label]
    assert got == (want.n_calls, want.clip_count, want.clip_total, want.code_min,
                   want.code_max)
    if mode == "dynamic":
        assert want.clip_count == 0 and (want.code_min, want.code_max) == (0.0, 255.0)
    else:
        alpha = act_alphabet(8, signed=signed)
        assert 0 < want.clip_count < x.size
        assert (want.code_min, want.code_max) == (alpha.qmin, alpha.qmax)


@pytest.mark.parametrize("signed", [False, True])
def test_tap_clip_count_with_nan_and_inf_matches_reference(packed_setup, signed):
    """A site input holding NaN, +inf and -inf beside finite values on both
    sides of the static range: the port's clip count equals the
    reference's, which compares ``raw < qmin | raw > qmax`` (false for
    NaN, true for each infinity)."""
    c = packed_setup
    jleaf = {k: np.asarray(v)[0] for k, v in c["jp"]["layers"][0]["mixer"]["wq"].items()
             if k != "spec"}
    K = 2 * jleaf["packed"].shape[0]
    x = (np.random.default_rng(12).standard_normal((3, 1, K)) * 2.0).astype(np.float32)
    x[0, 0, :5] = np.nan
    x[1, 0, 3:6] = np.inf
    x[2, 0, 7:9] = -np.inf
    scale, zp = (0.01, 0.0) if signed else (0.012, 120.0)
    jspec = JDatapathSpec(static_act=True, act_signed=signed)
    jleaf.update(act_scale=np.float32(scale), act_zp=np.float32(zp), spec=jspec)
    leaf = PackedLinear(packed=to_tensor(jleaf["packed"], "cpu"),
                        scale=to_tensor(jleaf["scale"], "cpu"),
                        col_sums=to_tensor(jleaf["col_sums"], "cpu"),
                        spec=DatapathSpec(static_act=True, act_signed=signed),
                        act_scale=torch.tensor(scale), act_zp=torch.tensor(zp))
    label = "slot0/mixer.wq"
    ref = JCounters()
    j_record_site(ref, label, jnp.asarray(x), jax.tree.map(jnp.asarray, jleaf))
    jax.effects_barrier()
    obs = SaturationCounters()
    obs.allocate((label,), "cpu")
    PL._record_site_observation(obs, label, torch.from_numpy(x), leaf)
    n_calls, clip_count, clip_total, _, _ = obs.block.read()[label]
    want = ref.sites[label]
    assert (n_calls, clip_count, clip_total) == (want.n_calls, want.clip_count,
                                                 want.clip_total)
    # every infinity clips, no NaN does, and finite values clip on both sides
    alpha = act_alphabet(8, signed=signed)
    raw = np.rint(x / np.float32(scale)) + np.float32(zp)
    assert clip_count == int(np.sum((raw < alpha.qmin) | (raw > alpha.qmax)))
    assert clip_count > 5 and np.sum(np.isnan(raw)) == 5


# ---------------------------------------------------------------------------
# Whole engines, reference against port
# ---------------------------------------------------------------------------
def _near_ties(xs, leaf) -> int:
    """Tap inputs within TIE_EPS code units of a rounding boundary under a
    site's static quantizer (none for the dynamic one)."""
    if leaf.act_scale is None:
        return 0
    q = np.concatenate([x.ravel() for x in xs]) / np.float32(leaf.act_scale)
    return int((np.abs(q - np.floor(q) - 0.5) < TIE_EPS).sum())


def _assert_tie_limited(got: dict, want: dict, xs: dict, model) -> None:
    """Per label: n_calls and clip_total exact; clip_count and the code
    extrema exact, or their difference explained by near-tie inputs."""
    assert set(got) == set(want)
    for label, w in want.items():
        g = got[label]
        assert (g["n_calls"], g["clip_total"]) == (w["n_calls"], w["clip_total"]), label
        keys = ("clip_count", "code_min", "code_max")
        if all(g[k] == w[k] for k in keys):
            continue
        ties = _near_ties(xs[label], PS._find_site_leaf(model, label)[0])
        assert abs(g["clip_count"] - w["clip_count"]) <= ties, (label, g, w, ties)
        for k in ("code_min", "code_max"):
            assert g[k] == w[k] or (abs(g[k] - w[k]) <= 1 and ties), (label, k, g, w)


@pytest.mark.parametrize("artifact, sched, backend", [
    ("rtn", None, "dequant"), ("static", None, "kernel"), ("static", THROUGHPUT, "dequant")],
    ids=["rtn-fifo", "static-fifo", "static-throughput"])
def test_observed_engines_match_reference(packed_setup, static_setup, monkeypatch, artifact,
                                          sched, backend):
    """The reference's observed engine and the port's on the same params
    and prompts, int8 pages, in the FIFO and the throughput loop, through
    the integer datapath (the port's CPU kernel path beside the
    reference's interpret backend) or both packages' dequant backend: the
    same labels, ``n_calls`` (7 sites x 2 layers x decode steps) and
    ``clip_total`` exact, clips and extrema exact or tie-limited, the
    KV-head watermarks equal; the static artifact clips at every site."""
    c = static_setup if artifact == "static" else packed_setup
    xs = collections.defaultdict(list)
    orig = PL._record_site_observation

    def spy(obs, label, x, leaf):
        xs[label].append(x.detach().float().numpy().copy())
        return orig(obs, label, x, leaf)

    monkeypatch.setattr(PL, "_record_site_observation", spy)
    je = _jpaged(c, sched=sched, kv_dtype="int8")
    with j_backend("interpret" if backend == "kernel" else backend):
        jout = je.generate(c["prompts"], 8)
    want = je.saturation_report()
    eng = _paged(c["model"], observe=True, sched=sched, backend=backend, kv_dtype="int8",
                 attn_impl="reference")
    out = eng.generate(c["prompts"], 8)
    got = eng.saturation_report()
    np.testing.assert_array_equal(out, jout)
    assert tuple(sorted(got["sites"])) == LABELS == eng.observer.block.labels
    steps = eng.decode_steps
    for label in LABELS:
        assert got["sites"][label]["n_calls"] == c["cfg"].n_layers * steps
    _assert_tie_limited(got["sites"], want["sites"], xs, eng.model)
    for label, sec in got["sites"].items():
        w = want["sites"][label]
        for k in ("watermark_hi", "watermark_lo", "p_inner"):
            assert sec[k] == w[k], (label, k)
        if artifact == "static":
            assert sec["clip_count"] > 0, label
    assert got["kv_heads"] == want["kv_heads"]


def test_moe_expert_stacks_are_unobserved():
    """tiny-moe, RTN-packed: neither package observes an expert stack (the
    reference's experts bypass ``pmm``), and the router is no packed site;
    both report the same labels."""
    jcfg, cfg = j_get_config("tiny-moe"), get_config("tiny-moe")
    jp = j_pack(JT.init_model(jax.random.key(0), jcfg), jcfg)
    model = params_from_numpy(_numpy_tree(jp), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    je = JPagedEngine(jp, jcfg, JPagedConfig(**{**BASE, "attn_impl": "ref"}),
                      JSampler(temperature=0.0), observe=True)
    with j_backend("dequant"):
        je.generate(prompts, 3)
    want = set(je.saturation_report()["sites"])
    eng = _paged(model, observe=True)
    eng.generate(prompts, 3)
    got = set(eng.saturation_report()["sites"])
    assert got == want == set(eng.observer.block.labels)
    moe_slots = {f"slot{s}/ffn" for s, spec in enumerate(cfg.pattern) if spec.ffn == "moe"}
    assert moe_slots and not any(label.split(".")[0] in moe_slots for label in got)
    assert all(".router" not in label for label in got)


# ---------------------------------------------------------------------------
# Transparency, bit identity, refusals and accumulation
# ---------------------------------------------------------------------------
def test_observer_structurally_transparent(packed_setup):
    """The reference's ``:487``: with no observer attached the decode step
    is the ``observe=False`` engine's, op for op, and writes no counter;
    with one attached its taps write the block, and without them it is
    the plain step. An observer leaking into the plain step is caught."""
    c = packed_setup
    plain = _paged(c["model"], kv_dtype="int8")
    observed = _paged(c["model"], kv_dtype="int8", observe=True)
    assert observed.datapath_fingerprint == plain.datapath_fingerprint + "+obs"
    bare = observed.decode_step_program()
    assert plain.decode_step_program().text == bare.text
    assert bare.taps() == 0
    assert not bare.writes(observed.observer.block.buf.untyped_storage().data_ptr())
    probe = SaturationCounters()
    tapped = observed.decode_step_program(observer=probe)
    assert tapped.taps() > 0 and tapped.writes(probe.block.buf.untyped_storage().data_ptr())
    assert tapped.untapped() == bare.untapped()
    # building the programs moved nothing of the engine's
    assert observed.decode_steps == 0 and not observed.observer.block.counts.any()
    assert not observed.cache["seq_lens"].any()
    observed.assert_observation_transparent()
    with PL.attach_observer(observed.observer), pytest.raises(AssertionError, match="plain"):
        observed.assert_observation_transparent()


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_observed_serving_bit_identical_with_report(packed_setup, kv_dtype):
    """The reference's ``:502``: observed generation is bit-identical to
    plain; the report resolves a watermark for every site against the
    exact register limit, and for int8 pools every KV head's within
    P_qk / P_pv; a plain engine refuses a report."""
    c = packed_setup
    plain = _paged(c["model"], kv_dtype=kv_dtype)
    observed = _paged(c["model"], kv_dtype=kv_dtype, observe=True)
    np.testing.assert_array_equal(observed.generate(c["prompts"], 8),
                                  plain.generate(c["prompts"], 8))
    observed.assert_observation_transparent()
    rep = observed.saturation_report()
    assert set(rep["sites"]) == set(LABELS)
    for site in rep["sites"].values():
        assert site["n_calls"] > 0 and site["clip_total"] > 0
        assert 0.0 <= site["clip_frac"] <= 1.0 and site["clip_count"] == 0  # dynamic
        assert site["watermark_bits"] > 0
        assert site["headroom_bits_observed"] == pytest.approx(
            site["p_inner"] - site["watermark_bits"], abs=1e-3)
    if kv_dtype == "act":
        assert "kv_heads" not in rep
    else:
        assert rep["kv_heads"]
        for slot in rep["kv_heads"].values():
            for head in slot.values():
                assert 0 < head["qk_watermark_bits"] <= head["p_qk"]
                assert 0 < head["pv_watermark_bits"] <= head["p_pv"]
    with pytest.raises(ValueError, match="observe"):
        plain.saturation_report()


def test_counts_accumulate_across_serves_and_reset(packed_setup):
    """Counts accumulate across ``serve()`` calls (one fold each) until the
    observer's ``reset()``, which zeroes the block in place."""
    c = packed_setup
    eng = _paged(c["model"], observe=True)
    eng.generate(c["prompts"], 4)
    first = eng.saturation_report()["sites"]
    steps = eng.decode_steps
    eng.generate(c["prompts"], 4)
    second = eng.saturation_report()["sites"]
    assert eng.decode_steps == 2 * steps
    for label, sec in second.items():
        assert sec["n_calls"] == 2 * first[label]["n_calls"]
        assert sec["clip_total"] == 2 * first[label]["clip_total"]
    ptr = eng.observer.block.buf.data_ptr()
    eng.observer.reset()
    assert eng.saturation_report()["sites"] == {}
    assert eng.observer.block.buf.data_ptr() == ptr


def test_serve_launcher_observe(capsys):
    """``--paged --observe`` prints the binding-watermark line and the JSON
    report; without ``--paged`` it exits with the reference's message."""
    args = ["--arch", "smollm-360m", "--smoke", "--packed", "--batch", "2", "--prompt-len",
            "8", "--max-new", "4", "--block-size", "8", "--device", "cpu"]
    out = serve.main([*args, "--paged", "--kv-dtype", "int8", "--observe"])
    printed = capsys.readouterr().out
    assert out.shape == (2, 12)
    assert "[serve] observed 7 sites; binding watermark: slot0/" in printed
    assert "[serve] saturation report:" in printed and '"kv_heads"' in printed
    with pytest.raises(SystemExit, match=r"--observe applies to the paged engine only"):
        serve.main([*args, "--observe"])
