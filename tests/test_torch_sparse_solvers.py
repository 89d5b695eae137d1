"""Port parity of the 2:4 solvers and the sparse serving site: the
mask-aware GPFQ (through kernel B5's plain version with its mask), OPTQ,
RTN and EP-init of ``repro_torch.core``, the 2:4 packing of
``repro_torch.quant.serve_packed`` and the sparse ``packed_linear``
(kernel B4's plain version), against ``repro.core``, ``repro.quant`` and
``repro.models.layers`` (the Pallas sparse kernel in interpret mode), on
the same numpy inputs.

Tolerances. Codes of the greedy solvers are held by tie-limited agreement,
as in ``tests/test_torch_gpfq.py``: equal in every channel up to the first
row (in solve order) whose value before rounding lies within 1e-3 of a
rounding boundary; the statistics come from a distinct Xq. The port's own
budget state (``pos``/``neg``) equals the tile sums of its codes exactly,
and equals the reference's exactly where every code agrees. RTN and
EP-init codes, masks, scales, packed bytes, certificates and the GEMM
outputs are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import alphabet as JA
from repro.core.axe import PTQConfig as JPTQConfig
from repro.core.axe import quantize_linear as j_quantize_linear
from repro.core.gpfq import AxeConfig as JAxe
from repro.core.gpfq import gpfq as j_gpfq
from repro.core.gpfq import gpfq_memory_efficient as j_gpfq_me
from repro.core.gpfq import me_stats as j_me_stats
from repro.core.optq import optq as j_optq
from repro.kernels import w4a8_mm as JW
from repro.models.layers import packed_linear as j_packed_linear
from repro.models.layers import use_packed_backend as j_backend
from repro.quant import serve_packed as JSP
from repro.quant.spec import DatapathSpec as JDatapathSpec
from repro_torch.configs import get_config
from repro_torch.core import alphabet as A
from repro_torch.core import gpfq as G
from repro_torch.core import optq as OQ
from repro_torch.core.axe import PTQConfig, quantize_linear
from repro_torch.core.calibration import ActObserver, LayerStats
from repro_torch.core.overflow import certify, min_feasible_p_bits
from repro_torch.core.sparsity import is_2to4, mask_2to4
from repro_torch.kernels import gpfq_solve as B5
from repro_torch.kernels import w4a8_mm as W
from repro_torch.models.layers import PackedLinear, dequant_weight, packed_linear
from repro_torch.quant import serve_packed as SP
from repro_torch.quant.families import get_adapter
from repro_torch.quant.spec import DatapathMismatchError, DatapathSpec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

EPS = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tie_ok(q_ref, q, v, rounding="nearest"):
    ok, share, cut = B5.tie_limited_agreement(_t(q_ref), q, v, rounding, EPS)
    assert ok, f"codes differ before the first tie (share equal {share:.4f}, {cut} cut)"
    return share


def _solver_inputs(rng, k=64, c=48, d=160):
    x = rng.standard_normal((k, d)).astype(np.float32)
    xq = (x + 0.05 * rng.standard_normal((k, d))).astype(np.float32)
    w = (rng.standard_normal((k, c)) / np.sqrt(k)).astype(np.float32)
    return w, x, xq


def _gpfq_trace(w, xg, xh, act, axe, rounding, act_order):
    """The port's sparse GPFQ solve step by step: B5's plain version with
    the 2:4 mask of the integer-domain weights, permuted to solve order.
    Returns (order, Q, V, pos, neg, tile ids, mask) in solve order."""
    w_int, _ = G._prepare(w, A.weight_alphabet(4))
    K, C = w.shape
    state = G.make_axe_state(w_int, axe, act, rounding, K)
    mask = mask_2to4(w_int)
    order = G.act_order_permutation(xh) if act_order else torch.arange(K)
    if state is None:
        lam, tid, a, b, mode = torch.zeros(1, C), torch.zeros(K, dtype=torch.int32), 0., 0., "plain"
    else:
        lam, tid, a, b = state["lam"], state["tile_ids"][order], state["A"], state["B"]
        mode = state["mode"] if state["strict"] else "soft"
    hg, hn = B5.row_terms(xg[order], xh[order])
    q, _, pos, neg, v = B5.gpfq_solve_plain(
        w_int[order], xg[order].contiguous(), xh[order].contiguous(), hg, hn, lam,
        tid.to(torch.int32), a, b, qmax=7.0, mode=mode, rounding=rounding, return_v=True,
        mask=mask[order].to(torch.uint8))
    return order, q, v, pos, neg, tid, mask[order]


def _own_sums_exact(q, pos, neg, tid):
    n_tiles = pos.shape[0]
    onehot = torch.nn.functional.one_hot(tid.long(), n_tiles).to(torch.float32)
    assert torch.equal(onehot.T @ torch.clamp(q, min=0), pos)
    assert torch.equal(onehot.T @ torch.clamp(q, max=0), neg)


def _check_sparse_result(r, jr, order, q, v, pos, neg, tid, mask, act, axe, rounding):
    assert torch.equal(r.q_int[order], q)
    assert not q[mask == 0].any(), "a pruned position got a nonzero code"
    assert is_2to4(r.q_int) and is_2to4(np.asarray(jr.q_int))
    share = _tie_ok(np.asarray(jr.q_int)[_n(order)], q, v, rounding)
    if axe is None:
        return
    _own_sums_exact(q, pos, neg, tid)
    assert torch.equal(r.aux["pos"], pos) and torch.equal(r.aux["neg"], neg)
    if share == 1.0:
        np.testing.assert_array_equal(_n(pos), np.asarray(jr.aux["pos"]))
        np.testing.assert_array_equal(_n(neg), np.asarray(jr.aux["neg"]))
    rep = certify(r.q_int, act, axe.p_bits, axe.tile, sparsity="2:4")
    jrep = certify(_t(np.asarray(jr.q_int)), act, axe.p_bits, axe.tile, sparsity="2:4")
    if axe.strict:
        assert rep.ok and jrep.ok
    assert (rep.p_bits, rep.p_outer, rep.tile, rep.sparsity) == (
        jrep.p_bits, jrep.p_outer, jrep.tile, jrep.sparsity)


#: (act signed, AxeConfig kwargs or None, rounding, act_order)
SOLVER_CASES = [
    (False, dict(p_bits=12, tile=16), "nearest", True),
    (False, dict(p_bits=12, tile=16), "nearest", False),
    (True, dict(p_bits=12, tile=16), "nearest", True),
    (False, dict(p_bits=12, tile=16), "zero", True),
    (False, dict(p_bits=12, tile=16, strict=False), "nearest", True),
    (False, None, "nearest", True),
]


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_sparse_gpfq_memory_efficient_matches_reference(case, rng):
    signed, axe_kw, rounding, act_order = case
    w, x, xq = _solver_inputs(rng)
    h, g = (np.asarray(a) for a in j_me_stats(jnp.asarray(x), jnp.asarray(xq)))
    jact, act = JA.act_alphabet(8, signed), A.act_alphabet(8, signed)
    jaxe = None if axe_kw is None else JAxe(**axe_kw)
    axe = None if axe_kw is None else G.AxeConfig(**axe_kw)
    jr = j_gpfq_me(jnp.asarray(w), jnp.asarray(h), jnp.asarray(g), JA.weight_alphabet(4), jact,
                   axe=jaxe, rounding=rounding, act_order=act_order, sparsity="2:4")
    r = G.gpfq_memory_efficient(_t(w), _t(h), _t(g), A.weight_alphabet(4), act, axe=axe,
                                rounding=rounding, act_order=act_order, sparsity="2:4")
    np.testing.assert_array_equal(_n(r.scale), np.asarray(jr.scale))
    trace = _gpfq_trace(_t(w), G.gh_inverse(_t(h), _t(g)), _t(h), act, axe, rounding, act_order)
    _check_sparse_result(r, jr, *trace, act, axe, rounding)


def test_sparse_standard_gpfq_matches_reference(rng):
    """GPFQ on raw samples (D != K) with the mask."""
    w, x, xq = _solver_inputs(rng, k=32, c=24, d=72)
    jact, act = JA.act_alphabet(8), A.act_alphabet(8)
    axe = G.AxeConfig(p_bits=12, tile=16)
    jr = j_gpfq(jnp.asarray(w), jnp.asarray(x), jnp.asarray(xq), JA.weight_alphabet(4), jact,
                axe=JAxe(p_bits=12, tile=16), act_order=True, sparsity="2:4")
    r = G.gpfq(_t(w), _t(x), _t(xq), A.weight_alphabet(4), act, axe=axe, act_order=True,
               sparsity="2:4")
    trace = _gpfq_trace(_t(w), _t(x), _t(xq), act, axe, "nearest", True)
    _check_sparse_result(r, jr, *trace, act, axe, "nearest")


def test_masked_solve_keeps_unmasked_weight_in_u(rng):
    """B5's plain version with an all-ones mask is the dense solve, and with
    a mask it zeroes exactly the pruned codes while U still takes the full
    weight (the residual differs from a solve on pre-masked weights)."""
    k, c = 32, 16
    w = _t((rng.standard_normal((k, c)) * 3).astype(np.float32))
    x = _t(rng.standard_normal((k, 48)).astype(np.float32))
    xq = x + 0.05 * _t(rng.standard_normal((k, 48)).astype(np.float32))
    hg, hn = B5.row_terms(x, xq)
    lam, tid = torch.zeros(2, c), (torch.arange(k) // 16).to(torch.int32)
    args = (x, xq, hg, hn, lam, tid, -9.53, 9.53)
    dense = B5.gpfq_solve_plain(w, *args, qmax=7.0)
    ones = B5.gpfq_solve_plain(w, *args, qmax=7.0, mask=torch.ones(k, c, dtype=torch.uint8))
    for a, b in zip(dense, ones):
        assert torch.equal(a, b)
    m = mask_2to4(w).to(torch.uint8)
    q, u, _, _ = B5.gpfq_solve_plain(w, *args, qmax=7.0, mask=m)
    assert not q[m == 0].any() and is_2to4(q)
    _, u_pre, _, _ = B5.gpfq_solve_plain(w * m, *args, qmax=7.0, mask=m)
    assert not torch.equal(u, u_pre)
    with pytest.raises(ValueError, match="mask"):
        B5.gpfq_solve_plain(w, *args, qmax=7.0, mask=m[:-1])
    with pytest.raises(ValueError, match="mask"):
        B5.gpfq_solve_plain(w, *args, qmax=7.0, mask=m.to(torch.float32))


@pytest.mark.parametrize("act_order", [True, False])
@pytest.mark.parametrize("axe_kw", [dict(p_bits=12, tile=16), None])
def test_sparse_optq_matches_reference(act_order, axe_kw, rng):
    w, _, xq = _solver_inputs(rng)
    hess = np.asarray(2.0 * (jnp.asarray(xq) @ jnp.asarray(xq).T))
    hess = hess + 0.01 * np.mean(np.diag(hess)) * np.eye(hess.shape[0], dtype=np.float32)
    act = A.act_alphabet(8)
    axe = None if axe_kw is None else G.AxeConfig(**axe_kw)
    jr = j_optq(jnp.asarray(w), jnp.asarray(hess), JA.weight_alphabet(4), JA.act_alphabet(8),
                axe=None if axe_kw is None else JAxe(**axe_kw), act_order=act_order,
                sparsity="2:4")
    r = OQ.optq(_t(w), _t(hess), A.weight_alphabet(4), act, axe=axe, act_order=act_order,
                sparsity="2:4")
    np.testing.assert_array_equal(_n(r.scale), np.asarray(jr.scale))
    w_perm, _, state, hinv_u, inv_order, mask = OQ.optq_setup(
        _t(w), _t(hess), A.weight_alphabet(4), act, axe, "nearest", act_order, "2:4")
    order = torch.argsort(inv_order)
    q, pos, neg, v = OQ._optq_loop(w_perm, hinv_u, state, w_bits=4, rounding="nearest",
                                   return_v=True, mask=mask)
    assert torch.equal(r.q_int[order], q)
    assert not q[mask == 0].any() and is_2to4(r.q_int) and is_2to4(np.asarray(jr.q_int))
    _tie_ok(np.asarray(jr.q_int)[_n(order)], q, v)
    if axe is not None:
        _own_sums_exact(q, pos, neg, state["tile_ids"])
        assert certify(r.q_int, act, 12, 16, sparsity="2:4").ok


def _stats_pair(rng, k, n=96):
    x = rng.standard_normal((n, k)).astype(np.float32) + 0.3
    xq = (x + 0.05 * rng.standard_normal((n, k))).astype(np.float32)
    from repro.core.calibration import LayerStats as JLayerStats

    js = JLayerStats(k=k)
    js.update(jnp.asarray(x), jnp.asarray(xq))
    obs = ActObserver(k=k)
    obs.update(x)
    s = LayerStats(k=k, n_samples=js.n_samples, h_raw=_t(js.h_raw), g_raw=_t(js.g_raw),
                   x_sum=_t(js.x_sum), observer=obs)
    return s, js


@pytest.mark.parametrize("algorithm", ["gpfq", "optq", "rtn", "ep_init"])
def test_sparse_quantize_linear_matches_reference(algorithm, rng):
    """Every solver with sparsity="2:4" through quantize_linear: RTN and
    EP-init bit-equal to the reference (mask, then round / project), GPFQ
    and OPTQ certified at the 2:4 depth with floors no worse than dense
    (tests/test_sparsity.py:358)."""
    k, c = 64, 24
    s, js = _stats_pair(rng, k)
    w = (rng.standard_normal((k, c)) / np.sqrt(k) * 2).astype(np.float32)
    cfg = PTQConfig(algorithm=algorithm, p_bits=14, tile=16, sparsity="2:4")
    ql = quantize_linear(_t(w), s, cfg)
    jql = j_quantize_linear(jnp.asarray(w), js,
                            JPTQConfig(algorithm=algorithm, p_bits=14, tile=16, sparsity="2:4"))
    np.testing.assert_array_equal(_n(ql.scale), np.asarray(jql.scale))
    np.testing.assert_array_equal(ql.spec.to_array(), jql.spec.to_array())
    assert ql.spec.sparsity == "2:4" and is_2to4(ql.q_int)
    assert ql.cert.sparsity == jql.cert.sparsity == "2:4"
    if algorithm in ("rtn", "ep_init"):
        np.testing.assert_array_equal(_n(ql.q_int), np.asarray(jql.q_int))
        assert vars(ql.cert) == vars(jql.cert)
    if algorithm == "rtn":  # no budget: RTN codes need not fit P_I
        return
    assert ql.cert.ok and jql.cert.ok
    dense = quantize_linear(_t(w), s, PTQConfig(algorithm=algorithm, p_bits=14, tile=16))
    assert min_feasible_p_bits(ql.cert, k) <= min_feasible_p_bits(dense.cert, k)


# ---------------------------------------------------------------------------
# The sparse serving site
# ---------------------------------------------------------------------------
def _sparse_q(rng, k, n):
    q = rng.integers(-7, 8, size=(k, n)).astype(np.int8)
    return (q * np.asarray(mask_2to4(_t(q).float()), np.int8)).astype(np.int8)


def _port_leaves(q, scale, sd, ss):
    qt = _t(q)
    col = qt.to(torch.int32).sum(dim=0, keepdim=True)
    packed, meta = W.compress_2to4(qt)
    dense = PackedLinear(W.pack_int4(qt), _t(scale), col, sd,
                         torch.tensor(sd.to_array(), dtype=torch.float32))
    sparse = PackedLinear(packed, _t(scale), col, ss,
                          torch.tensor(ss.to_array(), dtype=torch.float32), meta=meta)
    return dense, sparse


def _jax_sparse_leaf(q, scale, ss):
    packed, meta = JW.compress_2to4(jnp.asarray(q))
    return {"packed": packed, "meta": meta, "scale": jnp.asarray(scale),
            "col_sums": jnp.sum(jnp.asarray(q, jnp.int32), axis=-2),
            "spec": ss, "spec_arr": jnp.asarray(ss.to_array(), jnp.float32)}


@pytest.mark.parametrize("m,k,n,t", [(4, 128, 64, 128), (130, 256, 128, 128), (8, 32, 16, 16)])
def test_sparse_packed_linear_bit_equal_to_reference_and_dense(m, k, n, t, rng):
    """B4's plain version through packed_linear: bit-equal to the reference's
    Pallas sparse kernel (interpret mode) and to the port's dense path on
    the dense-with-zeros codes, at tests/test_sparsity.py:294-296's shapes
    (ragged M = 130, several K tiles, T = 16)."""
    q = _sparse_q(rng, k, n)
    scale = (rng.random((1, n)) * 0.02 + 0.01).astype(np.float32)
    sd = DatapathSpec(tile=t, p_inner=16, p_outer=20)
    ss = DatapathSpec(tile=t, p_inner=16, p_outer=20, sparsity="2:4")
    dense, sparse = _port_leaves(q, scale, sd, ss)
    x = rng.standard_normal((m, k)).astype(np.float32)
    before = W.w4a8_sparse_matmul.launches
    ys = packed_linear(_t(x), sparse)
    yd = packed_linear(_t(x), dense)
    assert W.w4a8_sparse_matmul.launches == before  # CPU tensors: the plain version
    with j_backend("interpret"):
        jys = j_packed_linear(jnp.asarray(x), _jax_sparse_leaf(
            q, scale, JDatapathSpec(tile=t, p_inner=16, p_outer=20, sparsity="2:4")))
    np.testing.assert_array_equal(_n(ys), np.asarray(jys))
    assert torch.equal(ys, yd)
    assert torch.equal(dequant_weight(sparse), dequant_weight(dense))


def test_sparse_matmul_wrapper_and_inner_check(rng):
    """w4a8_sparse_matmul against w4a8_matmul on the expanded codes for both
    activation types and output dtypes; the P_I check runs over the
    certified tiles of the expanded codes; the wrapper refuses what the
    kernel does not take."""
    k, n, m = 64, 32, 5
    q = _sparse_q(rng, k, n)
    packed, meta = W.compress_2to4(_t(q))
    col = _t(q).to(torch.int32).sum(dim=0)
    scale = _t(rng.random(n).astype(np.float32))
    for lo, hi, dt in ((0, 256, np.uint8), (-128, 128, np.int8)):
        x = _t(rng.integers(lo, hi, size=(m, k)).astype(dt))
        for out in (torch.float32, torch.bfloat16):
            ys = W.w4a8_sparse_decode_matmul(x, packed, meta, scale, col, 0.01, 3.0,
                                             out_dtype=out, block_k=16)
            yd = W.w4a8_decode_matmul(x, W.pack_int4(_t(q)), scale, col, 0.01, 3.0,
                                      out_dtype=out, block_k=16)
            assert torch.equal(ys, yd)
    x = _t(rng.integers(0, 256, size=(m, k)).astype(np.uint8))
    wm = W.check_inner(x, packed, 16, 20, meta=meta)
    assert wm == W.check_inner(x, W.pack_int4(_t(q)), 16, 20)
    with pytest.raises(OverflowError, match="inner accumulator overflow"):
        W.w4a8_sparse_matmul(x, packed, meta, scale, 0.01, 3.0, col_sums=col, block_k=16,
                             p_inner=int(np.log2(wm)), assert_inner=True)
    with pytest.raises(ValueError, match="col_sums"):
        W.w4a8_sparse_matmul(x, packed, meta, scale, 0.01, 3.0, col_sums=None)
    with pytest.raises(ValueError, match="does not match"):
        W.w4a8_sparse_matmul(x[:, :-4], packed, meta, scale, 0.01, 3.0, col_sums=col)
    with pytest.raises(TypeError, match="int8"):
        W.w4a8_sparse_matmul(x, packed, meta.to(torch.uint8), scale, 0.01, 3.0, col_sums=col)
    with pytest.raises(ValueError, match="multiple of 4"):
        W.w4a8_sparse_matmul(x, packed, meta, scale, 0.01, 3.0, col_sums=col, block_k=6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W.w4a8_sparse_matmul_kernel(x, packed, meta, scale, scale)


def test_packed_linear_refuses_sparsity_layout_mismatch(rng):
    k, n = 32, 16
    q = _sparse_q(rng, k, n)
    scale = np.ones((1, n), np.float32)
    sd = DatapathSpec(tile=16, p_inner=16, p_outer=17)
    ss = DatapathSpec(tile=16, p_inner=16, p_outer=17, sparsity="2:4")
    dense, sparse = _port_leaves(q, scale, sd, ss)
    x = _t(rng.standard_normal((2, k)).astype(np.float32))
    dense.spec, sparse.spec = ss, sd  # each claims the other's layout
    for bad in (dense, sparse):
        with pytest.raises(DatapathMismatchError, match="sparsity"):
            packed_linear(x, bad)


def test_rtn_sparse_leaf_and_artifact_site_match_reference(rng):
    """serve_packed's RTN 2:4 leaf (mask, then compress; col_sums of the
    masked codes) equals the reference's byte for byte, and a calibrated
    site record claiming 2:4 with dense codes is refused."""
    k, n = 64, 24
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    ss, jss = DatapathSpec(sparsity="2:4"), JDatapathSpec(sparsity="2:4")
    leaf, jleaf = SP._pack_leaf(_t(w), ss), JSP._pack_leaf(jnp.asarray(w), jss)
    for name in ("packed", "meta", "col_sums"):
        np.testing.assert_array_equal(_n(getattr(leaf, name)), np.asarray(jleaf[name]))
    np.testing.assert_array_equal(_n(leaf.scale.float()),
                                  np.asarray(jleaf["scale"].astype(jnp.float32)))
    np.testing.assert_array_equal(_n(leaf.spec_arr), np.asarray(jleaf["spec_arr"]))
    assert leaf.spec.sparsity == "2:4" and is_2to4(W.unpack_sparse24(leaf.packed, leaf.meta))
    with pytest.raises(ValueError, match="K % 4"):
        SP._pack_leaf(_t(w[:-2]), ss)
    site = get_adapter("ffn", "mlp").enumerate_sites(get_config("tiny-lm-xs"))[0]
    q = rng.integers(1, 8, size=(site.k, site.c)).astype(np.float32)
    rec = {"q": q, "scale": np.ones((1, site.c), np.float32),
           "spec": DatapathSpec(sparsity="2:4")}
    with pytest.raises(DatapathMismatchError, match="not 2:4"):
        SP._site_rec_leaf(rec, site, "layer0/ffn.wg", "cpu")
    rec["q"] = q * _n(mask_2to4(_t(q)))
    served = SP._site_rec_leaf(rec, site, "layer0/ffn.wg", "cpu")
    assert served.meta is not None and served.meta.shape == (site.k // 4, site.c)


@pytest.mark.parametrize("arch", ["tiny-lm-xs", "smollm-360m"])
def test_packed_weight_bytes_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for sparsity in (None, "2:4"):
        for kw in (dict(), dict(scale_bytes_per=4, static_act=True, with_bias=True)):
            got = SP.packed_weight_bytes(cfg, sparsity=sparsity, **kw)
            assert got == JSP.packed_weight_bytes(jcfg, sparsity=sparsity, **kw)
    dense, sparse = (SP.packed_weight_bytes(cfg, sparsity=s) for s in (None, "2:4"))
    assert sparse["meta_bytes"] > 0 and dense["meta_bytes"] == 0
    assert sparse["packed_code_bytes"] + sparse["meta_bytes"] == dense["packed_code_bytes"]
