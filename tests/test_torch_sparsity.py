"""Port parity of the 2:4 sparsity primitives: ``repro_torch.core.sparsity``,
the 2:4 compression of ``repro_torch.kernels.w4a8_mm`` and the sparse bound
algebra and certificate of ``repro_torch.core.{alphabet,overflow}`` against
``repro.core.sparsity``, ``repro.kernels.w4a8_mm`` and
``repro.core.{alphabet,overflow}``, on the same numpy inputs.

Everything here is integer-valued or a {0, 1} mask, so every comparison is
exact: masks and their tie-breaking, ``packed``/``meta`` bytes, budgets,
bit widths, every certificate field and the register floors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as JA
from repro.core import overflow as JO
from repro.core import sparsity as JS
from repro.kernels import w4a8_mm as JW
from repro_torch.core import alphabet as A
from repro_torch.core import overflow as O
from repro_torch.core import sparsity as S
from repro_torch.kernels import w4a8_mm as W


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sparse_codes(rng, k, c, lim=7):
    q = rng.integers(-lim, lim + 1, size=(k, c)).astype(np.float32)
    return q * np.asarray(JS.mask_2to4(jnp.asarray(q)))


def _tie_groups(rng, k, c):
    """Codes whose groups of 4 are all equal, all zero, half equal or
    mixed in sign and magnitude: every tie the stable ranking must break."""
    q = rng.integers(-3, 4, size=(k, c)).astype(np.float32)
    q[:4] = 5.0  # all equal
    q[4:8] = 0.0  # all zero
    q[8:12] = np.array([[2.0], [-2.0], [2.0], [1.0]])  # equal magnitudes, mixed sign
    q[12:16] = np.array([[0.0], [0.0], [-1.0], [0.0]])  # fewer than 2 nonzeros
    return q


@pytest.mark.parametrize("k,c", [(16, 8), (64, 24), (128, 5)])
def test_mask_matches_reference_including_ties(k, c, rng):
    for w in (rng.standard_normal((k, c)).astype(np.float32), _tie_groups(rng, k, c),
              rng.integers(-2, 3, size=(3, k, c)).astype(np.float32)):
        m, jm = S.mask_2to4(_t(w)), JS.mask_2to4(jnp.asarray(w))
        np.testing.assert_array_equal(_n(m), np.asarray(jm))
        assert m.dtype == torch.float32
        np.testing.assert_array_equal(_n(S.apply_mask(_t(w), "2:4")),
                                      np.asarray(JS.apply_mask(jnp.asarray(w), "2:4")))
        assert S.is_2to4(_n(S.apply_mask(_t(w), "2:4")))
    q = _tie_groups(rng, k, c)
    m = _n(S.mask_2to4(_t(q)))
    slots01 = np.broadcast_to(np.array([[1.0], [1.0], [0.0], [0.0]], np.float32), (4, c))
    np.testing.assert_array_equal(m[:4], slots01)  # all-equal: slots 0, 1
    np.testing.assert_array_equal(m[4:8], slots01)  # all-zero: slots 0, 1
    assert torch.equal(S.apply_mask(_t(q), None), _t(q))


def test_mask_predicates_and_refusals(rng):
    q = _sparse_codes(rng, 32, 6)
    dense = rng.integers(1, 8, size=(32, 6)).astype(np.float32)
    for a in (q, dense, q[:30]):
        assert S.is_2to4(a) == JS.is_2to4(a) == S.is_2to4(_t(a))
    S.check_2to4(_t(q))
    with pytest.raises(ValueError, match="> 2 nonzeros"):
        S.check_2to4(_t(dense))
    with pytest.raises(ValueError, match="multiple of 4"):
        S.check_2to4(_t(q[:30]))
    with pytest.raises(ValueError, match="K % 4"):
        S.mask_2to4(_t(q[:30]))
    with pytest.raises(ValueError, match="unknown sparsity"):
        S.validate_sparsity("1:4")
    S.validate_sparsity(None)
    S.validate_sparsity("2:4")
    assert (S.GROUP, S.KEEP, S.SPARSITY_2_4) == (JS.GROUP, JS.KEEP, JS.SPARSITY_2_4)


@pytest.mark.parametrize("k,n", [(16, 8), (64, 32), (960, 20)])
def test_compress_bytes_match_reference_and_round_trip(k, n, rng):
    for q in (_sparse_codes(rng, k, n), _tie_groups(rng, k, n) * np.asarray(
            JS.mask_2to4(jnp.asarray(_tie_groups(rng, k, n)))),
            np.stack([_sparse_codes(rng, k, n), _sparse_codes(rng, k, n)])):
        packed, meta = W.compress_2to4(_t(q))
        jpacked, jmeta = JW.compress_2to4(jnp.asarray(q))
        assert packed.dtype == meta.dtype == torch.int8
        np.testing.assert_array_equal(_n(packed), np.asarray(jpacked))
        np.testing.assert_array_equal(_n(meta), np.asarray(jmeta))
        np.testing.assert_array_equal(_n(W.unpack_sparse24(packed, meta)), q.astype(np.int8))
        np.testing.assert_array_equal(_n(W.unpack_sparse24(packed, meta)),
                                      np.asarray(JW.unpack_sparse24(jpacked, jmeta)))
    with pytest.raises(ValueError, match="K % 4"):
        W.compress_2to4(_t(q[0, :-2]))


def test_unpack_adds_equal_positions_as_the_reference(rng):
    """A hand-made meta with both positions equal sums the two codes."""
    vals = rng.integers(-8, 8, size=(8, 6)).astype(np.int8)
    packed = W.pack_int4(_t(vals))  # (4, 6): one group of 4 K rows per byte row
    meta = _t(rng.integers(0, 4, size=(4, 6)) * 5).to(torch.int8)  # i0 == i1
    got = W.unpack_sparse24(packed, meta)
    want = JW.unpack_sparse24(jnp.asarray(_n(packed)), jnp.asarray(_n(meta)))
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    pairs = vals.reshape(4, 2, 6).astype(np.int32).sum(axis=1)
    np.testing.assert_array_equal(_n(got).reshape(4, 4, 6).sum(axis=1), pairs)


def test_sparse_bound_algebra_matches_reference():
    for k in (1, 2, 3, 4, 63, 64, 960, 2560):
        assert A.effective_depth(k, "2:4") == JA.effective_depth(k, "2:4")
        for n, m, signed in ((8, 4, False), (8, 4, True), (4, 3, False)):
            assert A.min_accumulator_bits(k, n, m, signed, sparsity="2:4") == (
                JA.min_accumulator_bits(k, n, m, signed, sparsity="2:4"))
        for p in (12, 16, 20):
            for t in (16, 64, 128):
                assert A.outer_accumulator_bits(p, k, t, sparsity="2:4") == (
                    JA.outer_accumulator_bits(p, k, t, sparsity="2:4"))
    assert A.SPARSITY_PATTERNS == JA.SPARSITY_PATTERNS
    with pytest.raises(ValueError, match="unknown sparsity"):
        A.effective_depth(64, "1:4")


@pytest.mark.parametrize("k,c,tile,p,signed", [
    (64, 16, 16, 16, False), (96, 8, 64, 16, False), (64, 16, None, 20, False),
    (128, 4, 32, 14, True), (200, 10, 64, 12, False),
])
def test_sparse_certificate_matches_reference(k, c, tile, p, signed, rng):
    q = _sparse_codes(rng, k, c)
    act, jact = A.act_alphabet(8, signed), JA.act_alphabet(8, signed)
    rep = O.certify(_t(q), act, p, tile, sparsity="2:4")
    jrep = JO.certify(jnp.asarray(q), jact, p, tile, sparsity="2:4")
    assert vars(rep) == vars(jrep) and rep.sparsity == "2:4"
    assert bool(rep) == bool(jrep)
    for margin in (0.0, 0.5):
        for depth in (k, None):
            _same_floor(rep, jrep, depth, margin)
    stacked = O.certify_stacked(_t(np.stack([q, -q])), act, p, tile, sparsity="2:4")
    jstacked = JO.certify_stacked(jnp.asarray(np.stack([q, -q])), jact, p, tile,
                                  sparsity="2:4")
    assert [vars(r) for r in stacked.reports] == [vars(r) for r in jstacked.reports]
    assert stacked.sparsity == "2:4"
    _same_floor(stacked, jstacked, k, 0.0)


def _same_floor(rep, jrep, depth, margin):
    """Equal register floors, or both refuse (peaks past the register)."""
    try:
        want = JO.min_feasible_p_bits(jrep, depth, margin)
    except ValueError:
        with pytest.raises(ValueError):
            O.min_feasible_p_bits(rep, depth, margin)
    else:
        assert O.min_feasible_p_bits(rep, depth, margin) == want


def test_certify_refuses_dense_codes_as_sparse(rng):
    act = A.act_alphabet(8)
    with pytest.raises(ValueError, match="2:4"):
        O.certify(torch.full((8, 2), 3.0), act, 16, None, sparsity="2:4")
    with pytest.raises(ValueError, match="2:4"):
        O.certify(_t(_sparse_codes(rng, 30, 2)[:30]), act, 16, None, sparsity="2:4")
    with pytest.raises(ValueError, match="unknown sparsity"):
        O.certify(_t(_sparse_codes(rng, 8, 2)), act, 16, None, sparsity="1:4")


def _floor_codes(k, c):
    dense = torch.full((k, c), 7.0)
    sparse = _t(np.tile([7.0, 7.0, 0.0, 0.0], k // 4)[:, None] * np.ones((1, c),
                                                                         np.float32))
    return dense, sparse


def test_sparse_floor_is_one_bit_below_dense():
    """tests/test_sparsity.py:165 on the port: equal-magnitude codes put the
    halved sums across a bit boundary (7*128*255 needs 19 bits, 7*64*255
    needs 18), analytically and in an exact int64 simulation."""
    k, c = 128, 4
    na = A.act_alphabet(8)
    dense, sparse = _floor_codes(k, c)
    assert S.is_2to4(sparse)
    cert_d = O.certify(dense, na, p_bits=32, tile=None)
    cert_s = O.certify(sparse, na, p_bits=32, tile=None, sparsity="2:4")
    floor_d, floor_s = O.min_feasible_p_bits(cert_d), O.min_feasible_p_bits(cert_s)
    jcert_s = JO.certify(jnp.asarray(_n(sparse)), JA.act_alphabet(8), p_bits=32, tile=None,
                         sparsity="2:4")
    assert vars(cert_s) == vars(jcert_s) and floor_s == JO.min_feasible_p_bits(jcert_s)
    for q, floor in ((dense, floor_d), (sparse, floor_s)):
        u, v = O.worst_case_inputs(q, na)
        sim = O.simulate_accumulation(q, torch.cat([u, v]))
        assert sim["inner_bits_used"] == floor
    assert floor_s == floor_d - 1


def test_sparse_tiled_floor_keeps_outer_gap():
    """tests/test_sparsity.py:195 on the port: under tiles the sparse floor
    is tighter too, P_O - P_I does not move (Eq. 22 halves depth and tile
    alike), and each floor's re-derived P_O holds the outer extrema."""
    k, c, t = 128, 4, 32
    na = A.act_alphabet(8)
    dense, sparse = _floor_codes(k, c)
    cert_d = O.certify(dense, na, p_bits=20, tile=t)
    cert_s = O.certify(sparse, na, p_bits=20, tile=t, sparsity="2:4")
    assert cert_d.p_outer - cert_d.p_bits == cert_s.p_outer - cert_s.p_bits
    floor_d, floor_s = O.min_feasible_p_bits(cert_d, k), O.min_feasible_p_bits(cert_s, k)
    assert floor_s < floor_d
    for cert, floor in ((cert_d, floor_d), (cert_s, floor_s)):
        po = A.outer_accumulator_bits(floor, k, t, sparsity=cert.sparsity)
        assert po == JA.outer_accumulator_bits(floor, k, t, sparsity=cert.sparsity)
        lo_o, hi_o = A.accumulator_range(po)
        assert cert.outer_hi <= hi_o and cert.outer_lo >= lo_o
