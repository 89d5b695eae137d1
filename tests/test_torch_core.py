"""Port parity of the AXE core: the bound algebra, the certificate, the
quantizers, the calibration statistics, the l1 projection and the
equalization of ``repro_torch.core`` against ``repro.core``, on the same
numpy inputs.

Integer quantities (budgets, bit widths, certificates, codes) are exact.
Float statistics are held at rtol 1e-5: float32 matmuls and cumulative sums
reduce in another order in XLA and PyTorch. ``gpfq_stats`` goes through an
eigendecomposition whose LAPACK routines differ between the two packages,
so H^(1/2) is held at 1e-4 of its largest entry.
"""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as JA
from repro.core import calibration as JC
from repro.core import equalization as JQ
from repro.core import overflow as JO
from repro.core import quantizers as JZ
from repro.core import sparsity as JS
from repro_torch.core import alphabet as A
from repro_torch.core import calibration as C
from repro_torch.core import ep_init as E
from repro_torch.core import equalization as Q
from repro_torch.core import overflow as O
from repro_torch.core import quantizers as Z

# repro.core re-exports a function named ep_init over its submodule
JE = importlib.import_module("repro.core.ep_init")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


GRID = list(itertools.product((12, 16, 20), (4, 8), (3, 4), (64, 960, 2560), (64, 128, None),
                              (False, True)))


@pytest.mark.parametrize("signed", [False, True])
def test_bound_algebra_matches_reference(signed):
    for p, n, m, k, t, s in GRID:
        if s != signed:
            continue
        act, jact = A.act_alphabet(n, signed), JA.act_alphabet(n, signed)
        assert (act.qmin, act.qmax, act.mu, act.nu, act.span) == (
            jact.qmin, jact.qmax, jact.mu, jact.nu, jact.span)
        assert A.accumulator_range(p) == JA.accumulator_range(p)
        assert A.min_accumulator_bits(k, n, m, s) == JA.min_accumulator_bits(k, n, m, s)
        assert A.l1_budget_zero_centered(p, act) == JA.l1_budget_zero_centered(p, jact)
        for slack in (0.0, 0.5):
            assert vars(A.strict_budgets(p, act, slack)) == vars(JA.strict_budgets(p, jact, slack))
        if t is not None:
            assert A.outer_accumulator_bits(p, k, t) == JA.outer_accumulator_bits(p, k, t)
            assert A.num_tiles(k, t) == JA.num_tiles(k, t)
        assert A.effective_depth(k, None) == JA.effective_depth(k, None)
        assert A.worst_case_dot_bounds(37.0, -12.0, act) == JA.worst_case_dot_bounds(
            37.0, -12.0, jact)
    with pytest.raises(ValueError):
        A.strict_budgets(4, A.act_alphabet(8), 0.5)
    for k in (1, 63, 64, 960, 2560):
        for signed_in in (False, True):
            assert A.min_accumulator_bits(k, 8, 4, signed_in, sparsity="2:4") == (
                JA.min_accumulator_bits(k, 8, 4, signed_in, sparsity="2:4"))


def _codes(rng, k, c, lim=7):
    return rng.integers(-lim, lim + 1, size=(k, c)).astype(np.float32)


@pytest.mark.parametrize("k,c,tile,p,signed", [
    (64, 16, 16, 16, False), (96, 8, 64, 16, False), (50, 12, 16, 14, True),
    (64, 16, None, 20, False), (128, 4, 128, 16, False), (200, 10, 64, 12, False),
])
def test_certificate_matches_reference(k, c, tile, p, signed, rng):
    q = _codes(rng, k, c)
    act, jact = A.act_alphabet(8, signed), JA.act_alphabet(8, signed)
    pos, neg = O.tile_signed_sums(_t(q), tile)
    jpos, jneg = JO.tile_signed_sums(jnp.asarray(q), tile)
    np.testing.assert_array_equal(_n(pos), np.asarray(jpos))
    np.testing.assert_array_equal(_n(neg), np.asarray(jneg))
    rep, jrep = O.certify(_t(q), act, p, tile), JO.certify(jnp.asarray(q), jact, p, tile)
    assert vars(rep) == vars(jrep)
    assert bool(rep) == bool(jrep)
    for margin in (0.0, 0.5):
        try:
            want = JO.min_feasible_p_bits(jrep, k, margin)
        except ValueError:
            with pytest.raises(ValueError):
                O.min_feasible_p_bits(rep, k, margin)
        else:
            assert O.min_feasible_p_bits(rep, k, margin) == want
            assert O.min_feasible_p_bits(rep, None, margin) == JO.min_feasible_p_bits(
                jrep, None, margin)
    x = rng.integers(0, 256, size=(5, k)) if not signed else rng.integers(-127, 128, size=(5, k))
    assert O.simulate_accumulation(_t(q), x, tile) == JO.simulate_accumulation(
        jnp.asarray(q), x, tile)
    u, v = O.worst_case_inputs(_t(q), act)
    ju, jv = JO.worst_case_inputs(jnp.asarray(q), jact)
    np.testing.assert_array_equal(_n(u), np.asarray(ju))
    np.testing.assert_array_equal(_n(v), np.asarray(jv))
    stacked = O.certify_stacked(_t(np.stack([q, -q])), act, p, tile)
    jstacked = JO.certify_stacked(jnp.asarray(np.stack([q, -q])), jact, p, tile)
    assert [vars(r) for r in stacked.reports] == [vars(r) for r in jstacked.reports]
    assert stacked.headroom_bits == jstacked.headroom_bits and bool(stacked) == bool(jstacked)


def test_sparse_certificate_matches_reference(rng):
    q = _codes(rng, 64, 8)
    q24 = q * np.asarray(JS.mask_2to4(jnp.asarray(q)))
    act, jact = A.act_alphabet(8), JA.act_alphabet(8)
    rep = O.certify(_t(q24), act, 16, 16, sparsity="2:4")
    jrep = JO.certify(jnp.asarray(q24), jact, 16, 16, sparsity="2:4")
    assert vars(rep) == vars(jrep) and rep.sparsity == "2:4"
    assert O.min_feasible_p_bits(rep) == JO.min_feasible_p_bits(jrep)
    with pytest.raises(ValueError, match="2:4"):
        O.certify(_t(q), act, 16, 16, sparsity="2:4")


@pytest.mark.parametrize("signed", [False, True])
def test_activation_quantizer_matches_reference(signed, rng):
    x = (rng.standard_normal((40, 24)) * 3 + (0 if signed else 1.5)).astype(np.float32)
    alpha, jalpha = A.act_alphabet(8, signed), JA.act_alphabet(8, signed)
    obs, jobs = C.ActObserver(k=24), JC.ActObserver(k=24)
    for chunk in np.split(x, 4):
        obs.update(_t(chunk))
        jobs.update(jnp.asarray(chunk))
    assert obs.snapshot() == jobs.snapshot()
    np.testing.assert_array_equal(obs.dim_absmax, jobs.dim_absmax)
    p, jp = obs.act_quant(alpha), jobs.act_quant(jalpha)
    assert (p.zero_point, p.bits, p.signed) == (jp.zero_point, jp.bits, jp.signed)
    np.testing.assert_allclose(p.scale, jp.scale, rtol=1e-6)
    for lo, hi in ((-2.0, 5.0), (0.3, 0.9), (-4.0, -1.0), (0.0, 0.0)):
        a, b = Z.calibrate_act_quant(lo, hi, alpha), JZ.calibrate_act_quant(lo, hi, jalpha)
        assert vars(a) == vars(b)
    codes = Z.quantize_act(_t(x), p)
    np.testing.assert_array_equal(_n(codes), np.asarray(JZ.quantize_act(jnp.asarray(x), jp)))
    np.testing.assert_allclose(_n(Z.fake_quantize_act(_t(x), p)),
                               np.asarray(JZ.fake_quantize_act(jnp.asarray(x), jp)), rtol=1e-6)


def test_weight_quantizers_match_reference(rng):
    w = rng.standard_normal((48, 20)).astype(np.float32)
    for bits, rounding in ((4, "nearest"), (4, "zero"), (8, "nearest")):
        q, s = Z.quantize_weights_rtn(_t(w), A.weight_alphabet(bits), rounding)
        jq, js = JZ.quantize_weights_rtn(jnp.asarray(w), JA.weight_alphabet(bits), rounding)
        np.testing.assert_array_equal(_n(q), np.asarray(jq))
        np.testing.assert_array_equal(_n(s), np.asarray(js))
    assert Z.ROUNDING_SLACK == JZ.ROUNDING_SLACK


def test_layer_stats_match_reference(rng):
    k = 32
    stats, jstats = C.LayerStats(k=k), JC.LayerStats(k=k)
    for _ in range(3):
        x = rng.standard_normal((50, k)).astype(np.float32)
        xq = (x + rng.standard_normal((50, k)).astype(np.float32) * 0.05).astype(np.float32)
        stats.update(_t(x), _t(xq))
        jstats.update(jnp.asarray(x), jnp.asarray(xq))
    for name in ("h_raw", "g_raw", "x_mean"):
        np.testing.assert_allclose(_n(getattr(stats, name)), np.asarray(getattr(jstats, name)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_n(stats.optq_hessian()), np.asarray(jstats.optq_hessian()),
                               rtol=1e-5)
    h, g = stats.gpfq_stats()
    jh, jg = jstats.gpfq_stats()
    scale = float(np.abs(np.asarray(jh)).max())
    np.testing.assert_allclose(_n(h), np.asarray(jh), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(_n(g), np.asarray(jg), rtol=1e-5, atol=1e-5)
    assert stats.memory_bytes() == jstats.memory_bytes()
    assert stats.observer.snapshot() == jstats.observer.snapshot()


@pytest.mark.parametrize("radius", [0.5, 3.0, 40.0])
def test_l1_projection_matches_reference(radius, rng):
    w = (rng.standard_normal((6, 5, 32)) * 2).astype(np.float32)
    lam = E.l1_projection_threshold(_t(w), radius)
    jlam = JE.l1_projection_threshold(jnp.asarray(w), radius)
    np.testing.assert_allclose(_n(lam), np.asarray(jlam), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_n(E.project_l1_ball(_t(w), radius)),
                               np.asarray(JE.project_l1_ball(jnp.asarray(w), radius)),
                               rtol=1e-5, atol=1e-6)
    alpha, jalpha = A.weight_alphabet(4), JA.weight_alphabet(4)
    np.testing.assert_array_equal(_n(E.ep_init(_t(w), radius, alpha)),
                                  np.asarray(JE.ep_init(jnp.asarray(w), radius, jalpha)))


@pytest.mark.parametrize("k,tile", [(64, 16), (50, 16), (960, 128)])
def test_tiled_pads_as_reference(k, tile, rng):
    w = rng.standard_normal((3, k)).astype(np.float32)
    tiles = E.tiled(_t(w), tile)
    np.testing.assert_array_equal(_n(tiles), np.asarray(JE.tiled(jnp.asarray(w), tile)))
    np.testing.assert_array_equal(_n(E.untiled(tiles, k)), w)


def test_equalization_matches_reference(rng):
    a = np.abs(rng.standard_normal(16)).astype(np.float32) * 4
    w = np.abs(rng.standard_normal(16)).astype(np.float32)
    a[3] = 0.0
    s = Q.smoothquant_scales(_t(a), _t(w))
    js = JQ.smoothquant_scales(jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_allclose(_n(s), np.asarray(js), rtol=1e-6)
    wm = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_array_equal(_n(Q.equalize_linear(_t(wm), s)),
                                  np.asarray(JQ.equalize_linear(jnp.asarray(wm), jnp.asarray(
                                      _n(s)))))
    xm = rng.standard_normal(16).astype(np.float32)
    wq = np.round(wm * 4) / 4
    b = rng.standard_normal(8).astype(np.float32)
    for bias in (None, b):
        got = Q.bias_correction(_t(xm), _t(wm), _t(wq), None if bias is None else _t(bias))
        want = JQ.bias_correction(jnp.asarray(xm), jnp.asarray(wm), jnp.asarray(wq),
                                  None if bias is None else jnp.asarray(bias))
        np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-5, atol=1e-6)
