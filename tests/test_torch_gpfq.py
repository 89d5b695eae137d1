"""Port parity of the GPFQ panel solver (kernel B5) and the solvers built on
it: ``repro_torch.kernels.gpfq_solve`` and ``repro_torch.core.{gpfq,optq,
axe}`` against ``repro.kernels.gpfq_solve`` (Pallas, interpret mode),
``repro.kernels.ref.gpfq_solve_ref`` and ``repro.core``, on the same numpy
inputs.

Codes are held by tie-limited agreement: in every channel the codes must be
equal up to the first row (in solve order) whose value before rounding lies
within 1e-3 of a rounding boundary. The two packages reduce float32 sums of
up to K terms in different orders, so a value on a boundary may round
either way, and past it that channel's error feedback follows another path.
Scales, certificates and the port's budget bookkeeping are exact. The CUDA
kernel itself is held to its plain version by
``tests/test_torch_gpfq_kernel.py`` (which imports no JAX, so it runs on
the card) and by ``chip_smoke.py`` phase 4 at the full model's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as JA
from repro.core.axe import PTQConfig as JPTQConfig
from repro.core.axe import quantize_linear as j_quantize_linear
from repro.core.calibration import LayerStats as JLayerStats
from repro.core.gpfq import AxeConfig as JAxe
from repro.core.gpfq import _gpfq_loop as j_gpfq_loop
from repro.core.gpfq import gpfq as j_gpfq
from repro.core.gpfq import gpfq_memory_efficient as j_gpfq_me
from repro.core.gpfq import me_stats as j_me_stats
from repro.core.optq import optq as j_optq
from repro.kernels.ops import gpfq_quantize_panel as j_panel
from repro.kernels.ref import gpfq_solve_ref as j_solve_ref
from repro_torch.core import alphabet as A
from repro_torch.core import gpfq as G
from repro_torch.core import optq as OQ
from repro_torch.core.axe import PTQConfig, check_weight, quantize_linear
from repro_torch.core.calibration import ActObserver, LayerStats
from repro_torch.core.overflow import certify
from repro_torch.kernels import gpfq_solve as B5
from repro_torch.kernels.ops import gpfq_quantize_panel
from repro_torch.kernels.ref import gpfq_solve_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

EPS = 1e-3


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _stats(rng, k, d):
    """(G H^-1, H) from samples X and a distinct perturbed copy Xq, as in
    calibration (the quantized stream differs from the float one): the two
    matrices differ, so a solver that mixed them up would not agree."""
    xs = rng.standard_normal((k, d)).astype(np.float32)
    xq = (xs + 0.05 * rng.standard_normal((k, d))).astype(np.float32)
    h, g = j_me_stats(jnp.asarray(xs), jnp.asarray(xq))
    return np.asarray(jnp.linalg.solve(h, g.T).T), np.asarray(h)


def _plain_trace(w, xg, xh, lam, tid, a, b, *, mode, rounding="nearest", qmax=7.0):
    xg, xh = _t(xg), _t(xh)
    hg, hn = B5.row_terms(xg, xh)
    return B5.gpfq_solve_plain(_t(w), xg, xh, hg, hn, _t(lam), _t(tid).to(torch.int32), a, b,
                               qmax=qmax, mode=mode, rounding=rounding, return_v=True)


def _tie_ok(q_ref, q, v, rounding="nearest"):
    ok, share, cut = B5.tie_limited_agreement(_t(q_ref), q, v, rounding, EPS)
    assert ok, f"codes differ before the first tie (share equal {share:.4f}, {cut} cut)"
    return share


def _own_sums_exact(q, pos, neg, tid):
    """The kernel's budget state equals the tile sums of its own codes."""
    n_tiles = pos.shape[0]
    onehot = torch.nn.functional.one_hot(tid.long(), n_tiles).to(torch.float32)  # (K, T)
    assert torch.equal(onehot.T @ torch.clamp(q, min=0), pos)
    assert torch.equal(onehot.T @ torch.clamp(q, max=0), neg)


@pytest.mark.parametrize("k,c,tile,bc", [(32, 64, 16, 64), (64, 128, 32, 64)])
def test_panel_matches_pallas_kernel_and_ref(k, c, tile, bc, rng):
    """The shapes of tests/test_kernels.py: the port's panel call against the
    Pallas kernel (interpret mode) and the reference oracle."""
    w = (rng.normal(size=(k, c)) * 3).astype(np.float32)
    xg, xh = _stats(rng, k, 3 * k)
    lam = rng.uniform(0, 0.3, size=(k // tile, c)).astype(np.float32)
    qk = np.asarray(j_panel(jnp.asarray(w), jnp.asarray(xg), jnp.asarray(xh), jnp.asarray(lam),
                            12.0, w_bits=4, tile=tile, block_c=bc, interpret=True))
    qr = np.asarray(j_solve_ref(jnp.asarray(w), jnp.asarray(xg), jnp.asarray(xh), w_bits=4,
                                lam=jnp.asarray(lam), budget_b=12.0, tile=tile))
    q = gpfq_quantize_panel(_t(w), _t(xg), _t(xh), _t(lam), 12.0, w_bits=4, tile=tile)
    assert torch.equal(q, gpfq_solve_ref(_t(w), _t(xg), _t(xh), w_bits=4, lam=_t(lam),
                                         budget_b=12.0, tile=tile))
    tid = np.arange(k) // tile
    qt, _, pos, neg, v = _plain_trace(w, xg, xh, lam, tid, -12.0, 12.0, mode="split")
    assert torch.equal(q, qt)
    _tie_ok(qk, qt, v)
    _tie_ok(qr, qt, v)
    _own_sums_exact(qt, pos, neg, _t(tid))


def test_panel_budget_respected(rng):
    """test_gpfq_solve_budget_respected's inequalities on the port."""
    k, c, tile, b = 64, 64, 16, 6.0
    w = (rng.normal(size=(k, c)) * 5).astype(np.float32)
    xg, xh = _stats(rng, k, 128)
    q = _n(gpfq_quantize_panel(_t(w), _t(xg), _t(xh), torch.zeros(k // tile, c), b, w_bits=4,
                               tile=tile))
    qt = q.T.reshape(c, k // tile, tile)
    assert np.maximum(qt, 0).sum(-1).max() <= b + 0.5 + 1e-6
    assert np.minimum(qt, 0).sum(-1).min() >= -b - 0.5 - 1e-6


#: (name, K, C, tile, mode, rounding, permuted tile ids, lambda scale, B)
LOOP_CASES = [
    ("ragged_c", 64, 40, 16, "split", "nearest", False, 0.3, 7.53),
    ("ragged_tile", 48, 32, 32, "split", "nearest", False, 0.3, 7.53),
    ("permuted_tids", 64, 32, 16, "split", "nearest", True, 0.3, 7.53),
    ("round_zero", 64, 32, 16, "split", "zero", True, 0.3, 8.03),
    ("joint", 64, 32, 16, "joint", "nearest", True, 0.3, 7.53),
    ("lam0_binf", 64, 32, 16, "split", "nearest", False, 0.0, float("inf")),
    ("soft_only", 64, 32, 16, "soft", "nearest", True, 0.3, 7.53),
    ("no_axe", 64, 32, 16, "plain", "nearest", False, 0.0, 0.0),
]


@pytest.mark.parametrize("case", LOOP_CASES, ids=[c[0] for c in LOOP_CASES])
def test_plain_loop_matches_reference_loop(case, rng):
    """The kernel's plain version against the reference's _gpfq_loop on the
    cases the Pallas wrapper cannot take (ragged C, permuted tile ids)."""
    _, k, c, tile, mode, rounding, permute, lam_scale, b = case
    w = (rng.normal(size=(k, c)) * 3).astype(np.float32)
    xg, xh = _stats(rng, k, 2 * k)
    n_tiles = -(-k // tile) if mode != "plain" else 1
    lam = (rng.uniform(0, lam_scale, size=(n_tiles, c))).astype(np.float32)
    tid = np.arange(k) // tile if mode != "plain" else np.zeros(k, np.int64)
    if permute:
        tid = tid[rng.permutation(k)]
    a = -b
    jq, ju, jpos, jneg = j_gpfq_loop(
        jnp.asarray(w), jnp.asarray(xg), jnp.asarray(xh), jnp.asarray(lam),
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), jnp.asarray(tid),
        jnp.zeros((n_tiles, c), jnp.float32), jnp.zeros((n_tiles, c), jnp.float32),
        jnp.ones((1, c), jnp.float32), w_bits=4, w_signed=True, rounding=rounding,
        strict=mode in ("split", "joint"), mode="joint" if mode == "joint" else "split",
        has_axe=mode != "plain", has_mask=False)
    q, u, pos, neg, v = _plain_trace(w, xg, xh, lam, tid, a, b, mode=mode, rounding=rounding)
    share = _tie_ok(jq, q, v, rounding)
    if mode != "plain":
        _own_sums_exact(q, pos, neg, _t(tid))
    else:
        assert not pos.any() and not neg.any()
    if share == 1.0:
        np.testing.assert_array_equal(_n(pos), np.asarray(jpos))
        np.testing.assert_array_equal(_n(neg), np.asarray(jneg))
        np.testing.assert_allclose(_n(u), np.asarray(ju), rtol=1e-4, atol=1e-3)
    if mode == "split" and np.isfinite(b):
        assert pos.max() <= b + 0.5 and neg.min() >= -b - 0.5
    if mode == "joint":
        assert (pos - neg).max() <= b + 0.5


def test_wrapper_checks_and_routes_cpu_to_plain(rng):
    k, c = 16, 8
    w = _t(rng.normal(size=(k, c)).astype(np.float32))
    xg, xh = (_t(a) for a in _stats(rng, k, k))
    lam, tid = torch.zeros(1, c), torch.zeros(k, dtype=torch.int32)
    before = B5.gpfq_solve.launches
    B5.gpfq_solve(w, xg, xh, lam, tid, -3.0, 3.0)
    assert B5.gpfq_solve.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="mode"):
        B5.gpfq_solve(w, xg, xh, lam, tid, -3.0, 3.0, mode="strict")
    with pytest.raises(ValueError, match="tile ids"):
        B5.gpfq_solve(w, xg, xh, lam, tid[:-1], -3.0, 3.0)
    for bad in (tid + 1, tid - 1):  # lam has one tile: a negative id must not wrap
        with pytest.raises(ValueError, match="tile ids outside"):
            B5.gpfq_solve(w, xg, xh, lam, bad, -3.0, 3.0)
    with pytest.raises(ValueError, match="CUDA"):
        hg, hn = B5.row_terms(xg, xh)
        B5.gpfq_solve_kernel(w, xg, xh, hg, hn, lam, tid, -3.0, 3.0, qmax=7.0)


# ---------------------------------------------------------------------------
# Solvers fed the reference's own statistics
# ---------------------------------------------------------------------------
def _solver_inputs(rng, k=64, c=48, d=160):
    x = rng.standard_normal((k, d)).astype(np.float32)
    xq = (x + 0.05 * rng.standard_normal((k, d))).astype(np.float32)
    w = (rng.standard_normal((k, c)) / np.sqrt(k)).astype(np.float32)
    return w, x, xq


def _gpfq_trace(w, xg, xh, act_alpha, axe, rounding, act_order):
    """The port's GPFQ solve, step by step, with the pre-rounding values."""
    w_int, _ = G._prepare(w, A.weight_alphabet(4))
    K, C = w.shape
    state = G.make_axe_state(w_int, axe, act_alpha, rounding, K)
    order = G.act_order_permutation(xh) if act_order else torch.arange(K)
    if state is None:
        lam, tid, a, b, mode = torch.zeros(1, C), torch.zeros(K, dtype=torch.int32), 0., 0., "plain"
    else:
        lam, tid, a, b = state["lam"], state["tile_ids"][order], state["A"], state["B"]
        mode = state["mode"] if state["strict"] else "soft"
    hg, hn = B5.row_terms(xg[order], xh[order])
    q, _, _, _, v = B5.gpfq_solve_plain(w_int[order], xg[order].contiguous(),
                                        xh[order].contiguous(), hg, hn, lam,
                                        tid.to(torch.int32), a, b, qmax=7.0, mode=mode,
                                        rounding=rounding, return_v=True)
    return order, q, v


#: (act signed, AxeConfig kwargs or None, rounding, act_order)
SOLVER_CASES = [
    (False, dict(p_bits=12, tile=16), "nearest", True),
    (False, dict(p_bits=12, tile=16), "nearest", False),
    (True, dict(p_bits=12, tile=16), "nearest", True),
    (False, dict(p_bits=12, tile=16), "zero", True),
    (False, dict(p_bits=12, tile=16, strict=False), "nearest", True),
    (False, dict(p_bits=13, tile=None, soft=False), "nearest", True),
    (False, None, "nearest", True),
]


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_gpfq_memory_efficient_matches_reference(case, rng):
    signed, axe_kw, rounding, act_order = case
    w, x, xq = _solver_inputs(rng)
    h, g = (np.asarray(a) for a in j_me_stats(jnp.asarray(x), jnp.asarray(xq)))
    jact, act = JA.act_alphabet(8, signed), A.act_alphabet(8, signed)
    jaxe = None if axe_kw is None else JAxe(**axe_kw)
    axe = None if axe_kw is None else G.AxeConfig(**axe_kw)
    jr = j_gpfq_me(jnp.asarray(w), jnp.asarray(h), jnp.asarray(g), JA.weight_alphabet(4), jact,
                   axe=jaxe, rounding=rounding, act_order=act_order)
    r = G.gpfq_memory_efficient(_t(w), _t(h), _t(g), A.weight_alphabet(4), act, axe=axe,
                                rounding=rounding, act_order=act_order)
    np.testing.assert_array_equal(_n(r.scale), np.asarray(jr.scale))
    order, q, v = _gpfq_trace(_t(w), G.gh_inverse(_t(h), _t(g)), _t(h), act, axe, rounding,
                              act_order)
    if act_order:
        jorder = np.asarray(jnp.argsort(-jnp.sum(jnp.asarray(h) ** 2, axis=1)))
        np.testing.assert_array_equal(_n(order), jorder)
    assert torch.equal(r.q_int[order], q)
    _tie_ok(np.asarray(jr.q_int)[_n(order)], q, v, rounding)
    np.testing.assert_allclose(float(r.aux["residual_norm"]), float(jr.aux["residual_norm"]),
                               rtol=0.05)
    if axe is not None:
        for tile, p in ((axe.tile, axe.p_bits),):
            rep = certify(r.q_int, act, p, tile)
            jrep = certify(_t(np.asarray(jr.q_int)), act, p, tile)
            if axe.strict:
                assert rep.ok and jrep.ok
            assert (rep.p_bits, rep.p_outer, rep.tile) == (jrep.p_bits, jrep.p_outer, jrep.tile)


def test_standard_gpfq_matches_reference(rng):
    """GPFQ on raw samples (D != K): U is (D, C)."""
    w, x, xq = _solver_inputs(rng, k=32, c=24, d=72)
    jact, act = JA.act_alphabet(8), A.act_alphabet(8)
    jr = j_gpfq(jnp.asarray(w), jnp.asarray(x), jnp.asarray(xq), JA.weight_alphabet(4), jact,
                axe=JAxe(p_bits=12, tile=16), act_order=True)
    r = G.gpfq(_t(w), _t(x), _t(xq), A.weight_alphabet(4), act,
               axe=G.AxeConfig(p_bits=12, tile=16), act_order=True)
    order, q, v = _gpfq_trace(_t(w), _t(x), _t(xq), act, G.AxeConfig(p_bits=12, tile=16),
                              "nearest", True)
    assert torch.equal(r.q_int[order], q)
    _tie_ok(np.asarray(jr.q_int)[_n(order)], q, v)
    with pytest.raises(ValueError, match="shape mismatch"):
        G.gpfq(_t(w), _t(x), _t(xq[:, :-1]), A.weight_alphabet(4))
    with pytest.raises(NotImplementedError, match="2:4 slice"):
        G.gpfq(_t(w), _t(x), _t(xq), A.weight_alphabet(4), sparsity="2:4")


@pytest.mark.parametrize("act_order", [True, False])
@pytest.mark.parametrize("axe_kw", [dict(p_bits=12, tile=16), None])
def test_optq_matches_reference(act_order, axe_kw, rng):
    w, _, xq = _solver_inputs(rng)
    hess = np.asarray(2.0 * (jnp.asarray(xq) @ jnp.asarray(xq).T))
    hess = hess + 0.01 * np.mean(np.diag(hess)) * np.eye(hess.shape[0], dtype=np.float32)
    act = A.act_alphabet(8)
    axe = None if axe_kw is None else G.AxeConfig(**axe_kw)
    jr = j_optq(jnp.asarray(w), jnp.asarray(hess), JA.weight_alphabet(4), JA.act_alphabet(8),
                axe=None if axe_kw is None else JAxe(**axe_kw), act_order=act_order)
    r = OQ.optq(_t(w), _t(hess), A.weight_alphabet(4), act, axe=axe, act_order=act_order)
    np.testing.assert_array_equal(_n(r.scale), np.asarray(jr.scale))
    w_perm, _, state, hinv_u, inv_order = OQ.optq_setup(_t(w), _t(hess), A.weight_alphabet(4),
                                                        act, axe, "nearest", act_order)
    order = torch.argsort(inv_order)
    q, _, _, v = OQ._optq_loop(w_perm, hinv_u, state, w_bits=4, rounding="nearest",
                               return_v=True)
    assert torch.equal(r.q_int[order], q)
    _tie_ok(np.asarray(jr.q_int)[_n(order)], q, v)
    if axe is not None:
        assert certify(r.q_int, act, 12, 16).ok


def _stats_pair(rng, k, n=96):
    """The reference's LayerStats on numpy activations, and the port's
    LayerStats carrying the same numbers."""
    x = rng.standard_normal((n, k)).astype(np.float32) + 0.3
    xq = (x + 0.05 * rng.standard_normal((n, k))).astype(np.float32)
    js = JLayerStats(k=k)
    js.update(jnp.asarray(x), jnp.asarray(xq))
    obs = ActObserver(k=k)
    obs.update(x)
    s = LayerStats(k=k, n_samples=js.n_samples, h_raw=_t(js.h_raw), g_raw=_t(js.g_raw),
                   x_sum=_t(js.x_sum), observer=obs)
    return s, js


@pytest.mark.parametrize("algorithm,act_order", [
    ("gpfq", True), ("gpfq", False), ("optq", True), ("optq", False), ("rtn", True),
    ("ep_init", True),
])
def test_quantize_linear_matches_reference(algorithm, act_order, rng):
    k, c = 80, 24  # T = 32: a ragged last tile of 16
    s, js = _stats_pair(rng, k)
    w = (rng.standard_normal((k, c)) / np.sqrt(k)).astype(np.float32)
    bias = (0.01 * rng.standard_normal(c)).astype(np.float32)
    cfg = PTQConfig(algorithm=algorithm, p_bits=12, tile=32, act_order=act_order)
    jcfg = JPTQConfig(algorithm=algorithm, p_bits=12, tile=32, act_order=act_order)
    ql = quantize_linear(_t(w), s, cfg, bias=_t(bias))
    jql = j_quantize_linear(jnp.asarray(w), js, jcfg, bias=jnp.asarray(bias))
    np.testing.assert_array_equal(_n(ql.scale), np.asarray(jql.scale))
    assert vars(ql.act) == vars(jql.act)
    np.testing.assert_array_equal(ql.spec.to_array(), jql.spec.to_array())
    jq = np.asarray(jql.q_int)
    if algorithm in ("rtn", "ep_init"):
        np.testing.assert_array_equal(_n(ql.q_int), jq)
        same = np.ones(c, bool)
    else:
        if algorithm == "gpfq":
            h, g = s.gpfq_stats(cfg.gpfq_eta)
            order, q, v = _gpfq_trace(_t(w), G.gh_inverse(h, g), h, cfg.act_alphabet, cfg.axe,
                                      "nearest", act_order)
        else:
            w_perm, _, state, hinv_u, inv_order = OQ.optq_setup(
                _t(w), s.optq_hessian(cfg.damp_frac), cfg.w_alphabet, cfg.act_alphabet,
                cfg.axe, "nearest", act_order)
            order = torch.argsort(inv_order)
            q, _, _, v = OQ._optq_loop(w_perm, hinv_u, state, w_bits=4, rounding="nearest",
                                       return_v=True)
        assert torch.equal(ql.q_int[order], q)
        _tie_ok(jq[_n(order)], q, v)
        same = (_n(ql.q_int) == jq).all(axis=0)
    np.testing.assert_allclose(_n(ql.bias)[same], np.asarray(jql.bias)[same], rtol=1e-4,
                               atol=1e-5)
    if algorithm in ("rtn", "ep_init"):  # the same codes: the same certificate
        assert vars(ql.cert) == vars(jql.cert)
        return
    assert ql.cert.ok and jql.cert.ok
    assert (ql.cert.p_bits, ql.cert.p_outer, ql.cert.tile) == (
        jql.cert.p_bits, jql.cert.p_outer, jql.cert.tile)


def test_quantize_linear_refuses_what_the_reference_cannot_calibrate(rng):
    s, _ = _stats_pair(rng, 16, n=8)
    w = torch.randn(16, 8)
    with pytest.raises(TypeError, match="float32"):
        quantize_linear(w.to(torch.bfloat16), s, PTQConfig(tile=8))
    with pytest.raises(NotImplementedError, match="MoE slice"):
        check_weight(torch.zeros(2, 16, 8))
    with pytest.raises(NotImplementedError, match="2:4 slice"):
        quantize_linear(w, s, PTQConfig(tile=8, sparsity="2:4"))
    # the reference fails on bfloat16 weights as well
    js = JLayerStats(k=16)
    js.update(jnp.asarray(np.random.default_rng(0).standard_normal((8, 16)), jnp.float32))
    with pytest.raises(TypeError):
        j_quantize_linear(jnp.asarray(w.numpy(), jnp.bfloat16), js, JPTQConfig(tile=8))
