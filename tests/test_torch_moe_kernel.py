"""B1 and B4 over an expert axis (B1e, B4e) of ``csrc/w4a8_mm.cu``: their
tiered plan, a model of the decode tier, their plain versions and the
kernels on the card. This file imports no JAX, so it runs on the card as
well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_kernel.py

On the CPU: ``expert_tier`` picks the decode tier up to 48 rows an expert
and from 65 to 80, between them the tile tier while its tiles fit one
wave (else the decode tier), the tile tier above; the tile tier's plan
gives each expert the row tiles of one problem and counts all E's tiles
when it splits K; the decode tier's plan covers every column and K row
once in a cluster of at most 8 and within 227 KB of shared memory, pinned
at granite's sites and a ragged shape; a numpy model of the decode tier
(stage layout and swizzle, the transposed fragments, the split's sums)
gives the exact product and fails with a wrong layout; B4e's byte-permute
expansion equals the masked add for every meta byte; decode-tier kernel
names count as B1e or B4e; the plain versions are E calls of B1's and
B4's, each expert with its own scales and activation quantizer, and the
per-expert dynamic quantizer equals the per-tensor one on each slice, an
all-zero expert taking the 1e-8 scale floor.

Tests marked ``cuda`` skip without a card (the kernels have no CPU
interpret mode). On the card B1e and B4e are bit-equal to their plain
versions and to E launches of B1/B4 on the slices, at E in {8, 40},
granite-moe-3b-a800m's expert shapes, unsigned and signed codes, a ragged
N and an expert with all-zero input, with one launch a call; on each side
of every tier boundary at E in {1, 5, 40}; with a hand-made 2:4 meta of
every position pair (equal and descending ones too) in both tiers and
both widths of the decode tier; and replayed in a CUDA graph.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import mask_2to4
from repro_torch.kernels import w4a8_mm as W
from repro_torch.kernels.ops import quantize_activations
from repro_torch.serving.graphs import COUNTERS, count_kernels
from test_torch_w4a8_kernel import (
    U32,
    _codes,
    _t,
    _weights,
    byte_perm,
    bytes_of,
    lanes_words,
    quad_codes,
    sext_nibbles,
)

#: (K, N) of granite-moe-3b-a800m's expert sites: wg/wu (1536, 512), wd (512, 1536)
GRANITE_EXPERT_SITES = [(1536, 512), (512, 1536)]
#: (E, K, N) a rank runs of granite's expert sites on a mesh: 20 experts a
#: rank expert-parallel on (2, 1); on (1, 2) all 40, wg/wu N-sharded and
#: wd K-sharded (the accumulator-only form)
GRANITE_SHARD_SITES = [(20, 1536, 512), (20, 512, 1536), (40, 1536, 256), (40, 256, 1536)]


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _operands(rng, e, m, k, n, signed, device="cpu", zero_expert=None):
    """Codes (E, M, K), dense and 2:4 int4 stacks, per-expert scales,
    col_sums and activation quantizers."""
    lo, hi = (-128, 128) if signed else (0, 256)
    x = rng.integers(lo, hi, size=(e, m, k)).astype(np.int8 if signed else np.uint8)
    if zero_expert is not None:
        x[zero_expert] = 0
    q = torch.from_numpy(rng.integers(-8, 8, size=(e, k, n)).astype(np.int8))
    qs = q * mask_2to4(q)
    packed, meta = W.compress_2to4(qs)

    def t(a):
        return (a if torch.is_tensor(a) else torch.from_numpy(np.array(a))).to(device)

    return {
        "x": t(x), "dense": t(W.pack_int4(q)), "packed": t(packed), "meta": t(meta),
        "sdense": t(W.pack_int4(qs)),
        "scale": t(rng.uniform(0.005, 0.02, size=(e, n)).astype(np.float32)),
        "col": t(q.sum(1).to(torch.int32)), "scol": t(qs.sum(1).to(torch.int32)),
        "act_scale": t(rng.uniform(0.01, 0.05, size=(e,)).astype(np.float32)),
        "act_zp": t((np.zeros(e) if signed else rng.integers(0, 256, size=e)).astype(
            np.float32)),
    }


def _accumulator_args(o, col):
    """The arguments under which B1e/B4e return each expert's integer
    accumulator alone: w_scale ones, act_scale ones(E), act_zp zeros(E)."""
    return (torch.ones_like(o["scale"]), col, torch.ones_like(o["act_scale"]),
            torch.zeros_like(o["act_zp"]))


def _calls(o, out_dtype, **kw):
    """B1e, B4e and B1e on the expanded 2:4 codes."""
    args = (o["scale"], o["col"], o["act_scale"], o["act_zp"])
    sargs = (o["scale"], o["scol"], o["act_scale"], o["act_zp"])
    return (W.w4a8_expert_matmul(o["x"], o["dense"], *args, out_dtype=out_dtype, **kw),
            W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sargs,
                                        out_dtype=out_dtype, **kw),
            W.w4a8_expert_matmul(o["x"], o["sdense"], *sargs, out_dtype=out_dtype, **kw))


def _per_expert_b1_b4(o, out_dtype, reference):
    """E calls of B1 and of B4 on the slices."""
    kw = dict(out_dtype=out_dtype, reference=reference)
    e = o["x"].shape[0]
    b1 = torch.stack([W.w4a8_decode_matmul(o["x"][i], o["dense"][i], o["scale"][i],
                                           o["col"][i], o["act_scale"][i], o["act_zp"][i],
                                           **kw) for i in range(e)])
    b4 = torch.stack([W.w4a8_sparse_decode_matmul(o["x"][i], o["packed"][i], o["meta"][i],
                                                  o["scale"][i], o["scol"][i],
                                                  o["act_scale"][i], o["act_zp"][i], **kw)
                      for i in range(e)])
    return b1, b4


# ---------------------------------------------------------------------------
# The plan and the plain versions (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("experts", [1, 3, 8, 40])
@pytest.mark.parametrize("m", [1, 4, 64, 65, 80])
def test_expert_plan_is_the_one_problem_plan_per_expert(experts, m):
    """The tile tier's expert plan (``w4a8_plan`` with E experts, the plan
    of every call ``expert_tier`` gives the tile tier, here M = 64 at N =
    512 and 60): its
    grid rows are E times one problem's row tiles, its columns and load
    width are one problem's, and its K split counts the tiles of all E (so
    it never splits more than one problem's plan). In the decode tier the
    expert plan is one row of 128-column tiles an expert, one problem's
    load width."""
    for k, n in [*GRANITE_EXPERT_SITES, (960, 60)]:
        one = W.w4a8_plan(m, n, k)
        plan = W.w4a8_plan(m, n, k, experts=experts)
        assert plan.tier == "tile" and plan.grid[0] == one.grid[0] and plan.vec == one.vec
        assert plan.grid[1] == experts * one.grid[1]
        assert plan.grid[2] <= one.grid[2] and plan.ck >= one.ck
        if experts == 1:
            assert plan == one
        assert plan.grid[2] <= W.MAX_CHUNKS and plan.ck % W.STAGE_K == 0
        tiered = W.w4a8_expert_plan(m, n, k, experts)
        if W.expert_tier(m, n, experts) == "tile":
            assert tiered == plan
        else:
            assert tiered.tier == "decode" and tiered.vec == one.vec
            assert tiered.grid[:2] == (-(-n // W.DECODE_COLS), experts)


@pytest.mark.parametrize("k,n", GRANITE_EXPERT_SITES)
def test_expert_plan_fills_the_card_without_a_split_at_granite_decode(k, n):
    """At decode (M = 4) granite's 40 experts give 160 (wg, wu) or 480
    (wd) tiles of 128 columns in the decode tier. The wd tiles alone make
    DECODE_BLOCKS_PER_SM blocks an SM: no split; wg and wu split K in 3
    chunks (a cluster of 3), so both sites run 480 blocks of 4 stages
    through a ring of 2."""
    plan = W.w4a8_expert_plan(4, n, k, 40)
    chunks = 3 if k == 1536 else 1
    assert plan.tier == "decode" and plan.grid == (n // W.DECODE_COLS, 40, chunks)
    assert plan.ck == k // chunks == 4 * W.DECODE_STAGE_K and plan.ring == W.DECODE_RING == 2
    assert plan.blocks >= W.DECODE_BLOCKS_PER_SM * W.H100_SMS


#: (E, M, K, N) -> (grid, K rows a chunk, ring): granite's sites at
#: decode-tier M (16 rows and under: the narrow width; above: the wide
#: one), and ragged cases (4-byte loads, a K tail, chunks that end inside
#: a stage)
DECODE_PLANS = {
    **{(40, m, 1536, 512): ((4, 40, 3), 512, 2) for m in (1, 4, 8, 9, 16, 17, 48, 65, 80)},
    **{(40, m, 512, 1536): ((12, 40, 1), 512, 2) for m in (1, 4, 8, 9, 16, 17, 48, 64, 65, 80)},
    (5, 3, 192, 60): ((1, 5, 2), 128, 1),
    (1, 4, 1536, 512): ((4, 1, 6), 256, 2),
    (8, 4, 1536, 512): ((4, 8, 6), 256, 2),
    (40, 4, 4096, 512): ((4, 40, 3), 1408, 2),
}


@pytest.mark.parametrize("e,m,k,n", list(DECODE_PLANS))
def test_decode_plan_pins_grid_split_cluster_and_smem(e, m, k, n):
    """The decode tier's grid, K chunks and ring at granite's sites and
    ragged shapes; a cluster of at most 8 blocks, and shared memory within
    the H100's 227 KB for the plan and for the launcher's attribute (a
    ring of DECODE_RING, 80 tokens, the largest buffer of any cluster
    size)."""
    plan = W.w4a8_expert_plan(m, n, k, e)
    assert (plan.grid, plan.ck, plan.ring) == DECODE_PLANS[(e, m, k, n)]
    assert plan.tier == "decode" and plan.grid[2] <= W.MAX_CHUNKS
    assert plan.vec == (16 if n % 16 == 0 else 4)
    assert W.decode_smem_bytes(m, plan.ring, plan.grid[2]) <= W.SMEM_LIMIT
    assert _smem_attribute() <= W.SMEM_LIMIT


def _smem_attribute():
    """The decode launcher's shared-memory attribute of the wide width
    (``dec_smem_limit``: a ring of DECODE_RING, 80 tokens, the largest
    receive buffer of any cluster size); the narrow width's is larger."""
    return max(W.decode_smem_bytes(W.DECODE_MAX_M, W.DECODE_RING, c)
               for c in range(1, W.MAX_CHUNKS + 1))


@pytest.mark.parametrize("n_sm", [W.H100_SMS, 1])
@pytest.mark.parametrize("k,n,e", [(k, n, e) for k, n in [
    (1536, 512), (512, 1536), (192, 60), (4096, 20), (2560, 64), (96, 32), (4, 4)]
    for e in (1, 5, 40)] + [(k, n, e) for e, k, n in GRANITE_SHARD_SITES])
def test_decode_plan_covers_every_column_and_k_row_once(k, n, e, n_sm):
    """Block (x, e, z) owns columns 128x .. 128x+127 of expert e and K rows
    [z ck, (z + 1) ck), cut at K: every column and K row of every expert
    exactly once, in whole 128-row stages, for every decode-tier M; the
    ring as deep as the chunk, up to DECODE_RING; shared memory within the
    launcher's attribute."""
    for m in range(1, W.DECODE_MAX_M + 1):
        plan = W.w4a8_expert_plan(m, n, k, e, True, n_sm)
        if W.expert_tier(m, n, e, n_sm) == "tile":
            continue
        gx, gy, gz = plan.grid
        assert gy == e and plan.ck % W.DECODE_STAGE_K == 0 and gz <= W.MAX_CHUNKS
        cols = np.zeros(n, np.int64)
        for x in range(gx):
            cols[x * W.DECODE_COLS:(x + 1) * W.DECODE_COLS] += 1
        rows = np.zeros(k, np.int64)
        for z in range(gz):
            rows[z * plan.ck:(z + 1) * plan.ck] += 1
        assert (cols == 1).all() and (rows == 1).all()
        assert plan.ring == min(W.DECODE_RING, plan.ck // W.DECODE_STAGE_K)
        assert W.decode_smem_bytes(m, plan.ring, gz) <= _smem_attribute() <= W.SMEM_LIMIT


# ---------------------------------------------------------------------------
# A model of the decode tier's arithmetic on 32-bit words
# ---------------------------------------------------------------------------
def sel_entry(m):
    """The kernel's ``sel_entry``: the byte-permute selector of meta nibble m."""
    p0, p1 = m & 3, m >> 2
    return 0x80000000 if p0 == p1 else 0x4444 ^ (4 << (4 * p0)) ^ (5 << (4 * p1))


SEL_LUT = np.array([sel_entry(m) for m in range(16)], dtype=U32)


def quad_codes_lut(lo, hi):
    """``quad_codes_lut``: the selectors of the four columns' meta nibbles;
    a quad with equal positions in any column takes ``quad_codes<true>``."""
    sel = [SEL_LUT[((hi >> U32(8 * j)) & U32(0xF)).astype(np.int64)] for j in range(4)]
    flagged = ((sel[0] | sel[1] | sel[2] | sel[3]) & U32(0x80000000)) != 0
    slow = quad_codes(lo, hi, True)
    v0 = sext_nibbles(lo & U32(0x0F0F0F0F))
    v1 = sext_nibbles((lo >> U32(4)) & U32(0x0F0F0F0F))
    out = []
    for j in range(4):
        x = byte_perm(v0, v1, U32(j | ((4 + j) << 4)))
        out.append(np.where(flagged, slow[j], byte_perm(x, np.zeros_like(x), sel[j])))
    return out


def dec_slot(r):
    """The kernel's ``dec_slot``: where dense packed row r of a stage lives."""
    r16 = r & 15
    return (r & ~15) + 8 * (r16 >> 3) + 4 * (r16 & 1) + ((r16 & 7) >> 1)


def dec_swizzle(slot, byte):
    """The kernel's ``dec_swizzle``: byte ``byte`` of the row at ``slot``,
    its 16-byte chunk XORed with 2 (slot % 4)."""
    return slot * 128 + (((byte >> 4) ^ ((slot & 3) << 1)) << 4) + (byte & 15)


def mma_wx(a_regs, b_regs, x_signed):
    """mma.m16n8k32 with signed A (the weights) and B (the codes) signed or
    not, on the PTX ISA's fragment layout (see ``mma_m16n8k32``)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tid = lane // 4, lane % 4
        a = bytes_of(a_regs[lane], True).reshape(16)
        for i in range(16):
            row = gid if (i < 4 or 8 <= i < 12) else gid + 8
            A[row, 4 * tid + (i & 3) + (16 if i >= 8 else 0)] = a[i]
        b = bytes_of(b_regs[lane], x_signed).reshape(8)
        for i in range(8):
            B[4 * tid + (i & 3) + (16 if i >= 4 else 0), gid] = b[i]
    D = A @ B
    lane = np.arange(32)
    return np.stack([D[lane // 4 + (8 if i >= 2 else 0), 2 * (lane % 4) + (i & 1)]
                     for i in range(4)], -1)


def smem_words(img, offs):
    """The little-endian 32-bit words at byte offsets ``offs`` of ``img``."""
    b = np.stack([img[offs + i].astype(U32) for i in range(4)])
    return b[0] | (b[1] << U32(8)) | (b[2] << U32(16)) | (b[3] << U32(24))


def decode_tier_model(x, wbytes, meta, x_signed, plan, *, slot=dec_slot, store=dec_swizzle,
                      swap_tiles=False):
    """The decode tier's product of one expert's (M, K) codes and packed
    weights as the kernel forms it: per block (128 columns) and chunk, the
    chunk stage by stage through a stage image laid out as in shared memory
    (64 rows of 128 bytes, bytes placed by ``store``: dense rows at
    ``slot``, 2:4 packed rows then meta rows; x rows at a 144-byte pitch),
    read where the kernel reads: per k32 step lane (g, t) of warp c reads
    quads t and t + 4 of columns 32c + 4g .. +3 into the A registers of two
    m16 tiles, and token 8j + g's codes as B. With one chunk each vector
    (token, columns 32c + 4g ..) goes to the output; else vector token * 32
    + 8c + g goes to slot ``rank`` of its owner, each owner summing its
    slots."""
    m, k = x.shape
    n = wbytes.shape[1]
    sparse = meta is not None
    cols = W.DECODE_COLS
    gx, _, chunks = plan.grid
    nt = -(-m // 8)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    xb = x.astype(np.uint8)
    out = np.zeros((m, gx * cols), np.int64)
    written = np.zeros_like(out)
    for bx in range(gx):
        n0 = cols * bx
        wcols = np.zeros((wbytes.shape[0], cols), np.int8)
        wcols[:, :min(cols, n - n0)] = wbytes[:, n0:n0 + cols]
        mcols = np.zeros_like(wcols)
        if sparse:
            mcols[:, :min(cols, n - n0)] = meta[:, n0:n0 + cols]
        live, share = m * cols // 4, -(-m * cols // 4 // chunks)
        rx = np.zeros((chunks, chunks * share, 4), np.int64)
        for rank in range(chunks):
            k0 = min(k, rank * plan.ck)
            k1 = min(k, k0 + plan.ck)
            steps = -(-(k1 - k0) // 32)
            # warp, m16 tile, n8 tile, lane, register
            acc = np.zeros((cols // 32, 2, nt, 32, 4), np.int64)
            for s in range(-(-steps // 4)):
                kb = k0 + 128 * s
                img = np.zeros(64 * cols, np.uint8)
                for r in range(64):
                    if sparse:
                        pr, sl = kb // 4 + (r & 31), r
                        row = (wcols if r < 32 else mcols)[pr] if 4 * pr < k1 else None
                    else:
                        pr, sl = kb // 2 + r, slot(r)
                        row = wcols[pr] if 2 * pr < k1 else None
                    if row is not None:
                        img[[store(sl, c) for c in range(cols)]] = row.view(np.uint8)
                sx = np.zeros((8 * nt, 128), np.uint8)
                kn = min(128, k1 - kb)
                sx[:m, :kn] = xb[:, kb:kb + kn]
                for ks in range(min(4, steps - 4 * s)):
                    b = []
                    for j in range(nt):
                        tok = 8 * j + g
                        row = np.minimum(tok, 8 * nt - 1)
                        bj = np.stack([lanes_words(sx, row, 32 * ks + 4 * t),
                                       lanes_words(sx, row, 32 * ks + 4 * t + 16)], -1)
                        b.append(np.where((tok < m)[:, None], bj, U32(0)))
                    for c in range(cols // 32):
                        def word(r):  # the lane's word of group c's columns, row at slot r
                            return smem_words(img, dec_swizzle(r, 32 * c + 4 * g))
                        if sparse:
                            q = 8 * ks + t
                            w0 = quad_codes_lut(word(q), word(q + 32))
                            w1 = quad_codes_lut(word(q + 4), word(q + 36))
                        else:
                            q = 16 * ks + t
                            w0 = quad_codes(word(q), word(q + 4), False)
                            w1 = quad_codes(word(q + 8), word(q + 12), False)
                        a = [np.stack([w0[0], w0[1], w1[0], w1[1]], -1),
                             np.stack([w0[2], w0[3], w1[2], w1[3]], -1)]
                        if swap_tiles:
                            a = a[::-1]
                        for j in range(nt):
                            for i in range(2):
                                acc[c, i, j] += mma_wx(a[i], b[j], x_signed)
            for c, j, h in itertools.product(range(cols // 32), range(nt), range(2)):
                for ln in range(32):
                    tok = 8 * j + 2 * t[ln] + h
                    if tok >= m:
                        continue
                    vec = [acc[c, 0, j, ln, h], acc[c, 0, j, ln, 2 + h],
                           acc[c, 1, j, ln, h], acc[c, 1, j, ln, 2 + h]]
                    col = n0 + 32 * c + 4 * g[ln]
                    if chunks == 1:
                        if col < n:
                            out[tok, col:col + 4] = vec
                            written[tok, col:col + 4] += 1
                        continue
                    v = tok * (cols // 4) + 8 * c + g[ln]
                    own = v // share
                    rx[own, rank * share + v - own * share] = vec
        if chunks == 1:
            continue
        for own in range(chunks):
            for u in range(share):
                v = own * share + u
                col = n0 + 4 * (v % (cols // 4))
                if v < live and col < n:
                    out[v // (cols // 4), col:col + 4] = rx[own, u::share].sum(0)
                    written[v // (cols // 4), col:col + 4] += 1
    assert (written[:, :n] == 1).all()
    return out[:, :n]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("m,k,n,e,n_sm", [(4, 512, 256, 40, 132), (3, 192, 60, 5, 132),
                                          (16, 1024, 32, 1, 132), (9, 640, 160, 40, 132),
                                          (1, 1536, 32, 40, 132), (8, 2560, 36, 1, 1),
                                          (80, 384, 128, 40, 132), (17, 256, 64, 1, 132)])
def test_decode_tier_model_is_the_exact_product(m, k, n, e, n_sm, signed, sparse, rng):
    """The model of the decode tier gives the exact integer product: granite's
    wd shape at two column tiles, the ragged shape (a K tail, two chunks),
    1-8 chunks, one to ten token tiles (M = 9, 16, 17, 80) in both widths,
    a chunk of 20 stages (K = 2560, one block)."""
    q, x = _codes(rng, m, k, n, signed, sparse)
    wbytes, meta = _weights(q, sparse)
    plan = W.w4a8_expert_plan(m, n, k, e, True, n_sm)
    assert plan.tier == "decode"
    exact = W.exact_int_matmul(_t(x), _t(q)).numpy()
    np.testing.assert_array_equal(decode_tier_model(x, wbytes, meta, signed, plan), exact)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("fault", ["natural_row_order", "unswizzled", "tiles_swapped"])
def test_decode_tier_model_catches_a_wrong_layout(fault, sparse, rng):
    """The model is sharp: dense rows stored in their natural order, or any
    row stored unswizzled, while read at the kernel's places, or the two
    m16 tiles' columns swapped, give a wrong product (the row order does not
    touch the 2:4 layout)."""
    q, x = _codes(rng, 4, 256, 64, False, sparse)
    wbytes, meta = _weights(q, sparse)
    plan = W.w4a8_expert_plan(4, 64, 256, 40)
    kw = {"natural_row_order": {"slot": lambda r: r},
          "unswizzled": {"store": lambda sl, c: sl * 128 + c}}.get(fault, {"swap_tiles": True})
    got = decode_tier_model(x, wbytes, meta, False, plan, **kw)
    exact = W.exact_int_matmul(_t(x), _t(q)).numpy()
    assert np.array_equal(got, exact) == (fault == "natural_row_order" and sparse)


def test_lut_expansion_is_the_masked_add_for_every_meta():
    """B4e's byte-permute expansion gives ``quad_codes<true>``'s words (and so
    the reference's ``unpack_sparse24``) for every code pair and every meta
    byte, equal positions included (they take the masked add)."""
    vals = np.arange(-8, 8)
    a, b, meta = (v.reshape(-1) for v in np.meshgrid(vals, vals, np.arange(256),
                                                     indexing="ij"))
    nib = ((a & 0xF) | ((b & 0xF) << 4)).astype(np.uint8)
    pad = (-len(nib)) % 4
    nib = np.concatenate([nib, np.zeros(pad, np.uint8)]).reshape(-1, 4).astype(U32)
    mb = np.concatenate([meta, np.zeros(pad, np.int64)]).reshape(-1, 4).astype(U32)
    lo = nib[:, 0] | (nib[:, 1] << U32(8)) | (nib[:, 2] << U32(16)) | (nib[:, 3] << U32(24))
    hi = mb[:, 0] | (mb[:, 1] << U32(8)) | (mb[:, 2] << U32(16)) | (mb[:, 3] << U32(24))
    for fast, slow in zip(quad_codes_lut(lo, hi), quad_codes(lo, hi, True)):
        np.testing.assert_array_equal(fast, slow)
    assert sum(sel_entry(m) == 0x80000000 for m in range(16)) == 4


def test_decode_tier_kernels_are_counted_as_b1e_and_b4e():
    """A graph's decode-tier kernel nodes count for B1e (dense) or B4e (2:4)
    by the kernel's Sparse argument, whatever its load width, code type,
    token tiles and output type; B1 and B4 count none of them."""
    name = "_ZN12_GLOBAL__N_125w4a8_expert_decode_kernelILi{}ELb{}ELb{}ELi{}E{}EEvNS_7ProblemEi"
    nodes = [name.format(16, 0, 0, 1, "13__nv_bfloat16"), name.format(4, 1, 0, 2, "f"),
             name.format(16, 1, 1, 2, "13__nv_bfloat16")]
    counts = dict(zip((fn.__name__ for fn, _, _ in COUNTERS), count_kernels(nodes)))
    assert counts["w4a8_expert_matmul"] == 2 and counts["w4a8_sparse_expert_matmul"] == 1
    assert counts["w4a8_matmul"] == counts["w4a8_sparse_matmul"] == 0


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("e,m,k,n", [(3, 5, 64, 20), (4, 1, 128, 32), (2, 17, 256, 48)])
def test_expert_plain_is_e_calls_of_b1_and_b4(e, m, k, n, signed):
    rng = np.random.default_rng(e * 100 + m)
    o = _operands(rng, e, m, k, n, signed, zero_expert=0)
    for out in (torch.float32, torch.bfloat16):
        b1e, b4e, b1e_expanded = _calls(o, out)
        b1, b4 = _per_expert_b1_b4(o, out, reference=False)
        assert b1e.shape == (e, m, n) and b1e.dtype == out
        assert torch.equal(b1e, b1) and torch.equal(b4e, b4)
        assert torch.equal(b4e, b1e_expanded)


def test_expert_wrappers_check_their_arguments():
    o = _operands(np.random.default_rng(0), 2, 3, 64, 16, False)
    args = (o["scale"], o["col"], o["act_scale"], o["act_zp"])
    with pytest.raises(ValueError, match="E, M, K"):
        W.w4a8_expert_matmul(o["x"][0], o["dense"], *args)
    with pytest.raises(ValueError, match="does not match"):
        W.w4a8_expert_matmul(o["x"][:, :, :32], o["dense"], *args)
    with pytest.raises(ValueError, match="one entry an expert"):
        W.w4a8_expert_matmul(o["x"], o["dense"], o["scale"], o["col"], o["act_scale"][:1],
                             o["act_zp"])
    with pytest.raises(TypeError, match="uint8 or int8"):
        W.w4a8_expert_matmul(o["x"].to(torch.int32), o["dense"], *args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W._launch("w4a8_expert_matmul", o["x"], (o["dense"],), o["scale"], o["scale"],
                  torch.float32, 2)


def test_plain_versions_launch_nothing():
    o = _operands(np.random.default_rng(1), 2, 4, 64, 16, False)
    before = (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches,
              W.w4a8_matmul.launches, W.w4a8_sparse_matmul.launches)
    _calls(o, torch.float32)
    assert (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches,
            W.w4a8_matmul.launches, W.w4a8_sparse_matmul.launches) == before


@pytest.mark.parametrize("e,m,k,n", [(2, 5, 128, 64), (3, 4, 256, 48), (20, 1, 512, 16)])
def test_accumulate_form_sums_to_the_unsharded_site(e, m, k, n):
    """B1e/B4e in the accumulator-only form (a K-sharded stacked site's
    shard: ones and zeros an expert, f32 out): each expert's exact integer
    product; the two K halves' sums, with the per-expert epilogue applied
    after, are the unsharded call bit for bit, dense and 2:4."""
    rng = np.random.default_rng(e * 10 + m)
    o = _operands(rng, e, m, k, n, False, zero_expert=0)
    want_dense, want_sparse, _ = _calls(o, torch.bfloat16)
    q = W.unpack_int4(o["dense"])
    qs = W.unpack_sparse24(o["packed"], o["meta"])
    acc = W.w4a8_expert_matmul(o["x"], o["dense"], *_accumulator_args(o, o["col"]))
    exact = torch.stack([W.exact_int_matmul(o["x"][i], q[i]) for i in range(e)])
    assert acc.dtype == torch.float32 and torch.equal(acc, exact.to(torch.float32))
    h = k // 2
    for weights, codes, col, want, fn in (
            ((o["dense"],), q, o["col"], want_dense, W.w4a8_expert_matmul),
            ((o["packed"], o["meta"]), qs, o["scol"], want_sparse,
             W.w4a8_sparse_expert_matmul)):
        rows = 2 if len(weights) == 1 else 4  # K rows a stored row
        parts = [fn(o["x"][:, :, a:a + h].contiguous(),
                    *(w[:, a // rows:(a + h) // rows].contiguous() for w in weights),
                    *_accumulator_args(o, col)) for a in (0, h)]
        sw, corr = W._expert_epilogue(o["scale"], col, o["act_scale"], o["act_zp"], e, n)
        got = ((parts[0] + parts[1] - corr[:, None]) * sw[:, None]).to(torch.bfloat16)
        assert torch.equal(got, want)


@pytest.mark.parametrize("e,k,n", GRANITE_SHARD_SITES)
@pytest.mark.parametrize("m", [1, 4, 16, 64, 80, 256])
def test_expert_plan_takes_granite_shards(e, k, n, m):
    """Every (E_local, M, K, N) of granite's sites on a (2, 1) or (1, 2)
    mesh gets a plan the launcher takes: a tier, 16-byte loads, whole
    stages in the decode tier, a cluster of at most 8, shared memory within
    the H100's 227 KB."""
    plan = W.w4a8_expert_plan(m, n, k, e)
    assert plan.tier == W.expert_tier(m, n, e) and plan.vec == 16
    if plan.tier == "decode":
        gx, gy, gz = plan.grid
        assert gx * W.DECODE_COLS >= n and gy == e and gz * plan.ck >= k
        assert plan.ck % W.DECODE_STAGE_K == 0 and gz <= W.MAX_CHUNKS
        assert W.decode_smem_bytes(m, plan.ring, gz) <= W.SMEM_LIMIT
    else:
        assert plan.grid[2] <= W.MAX_CHUNKS


def test_per_expert_quantizer_is_the_per_tensor_one_on_each_slice():
    """Each expert quantizes its own (M, K) slice, capacity rows of zeros
    included; an expert that got no token has scale 1e-8 and zero point 0,
    bit for bit what the per-tensor quantizer gives an all-zero input."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0.0, 1.0, size=(4, 6, 32)).astype(np.float32))
    x[1] = 0.0
    x[2, 3:] = 0.0  # capacity rows left at zero
    x[3] = x[3].abs() + 0.5  # all positive: lo clamps to 0
    codes, scale, zp = quantize_activations(x, per_expert=True)
    assert codes.shape == x.shape and scale.shape == zp.shape == (4,)
    for e in range(4):
        c1, s1, z1 = quantize_activations(x[e])
        assert torch.equal(codes[e], c1)
        assert torch.equal(scale[e], s1) and torch.equal(zp[e], z1)
    assert scale[1].item() == np.float32(1e-8) and zp[1].item() == 0.0
    assert not codes[1].any()


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------
def _check_on_card(o, out):
    before = (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches)
    b1e, b4e, b1e_expanded = _calls(o, out)
    torch.cuda.synchronize()
    assert (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches) == (
        before[0] + 2, before[1] + 1)
    p1e, p4e, _ = _calls(o, out, reference=True)
    b1, b4 = _per_expert_b1_b4(o, out, reference=False)
    torch.cuda.synchronize()
    assert torch.equal(b1e, p1e), "B1e != plain"
    assert torch.equal(b4e, p4e), "B4e != plain"
    assert torch.equal(b1e, b1), "B1e != E launches of B1"
    assert torch.equal(b4e, b4), "B4e != E launches of B4"
    assert torch.equal(b4e, b1e_expanded), "B4e != B1e on the expanded codes"


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k,n", GRANITE_EXPERT_SITES)
@pytest.mark.parametrize("m", [1, 4, 64, 80])
@pytest.mark.parametrize("e", [8, 40])
def test_cuda_expert_kernels_bit_equal_to_plain(e, m, k, n, signed, cuda_device):
    rng = np.random.default_rng(e + m + k)
    o = _operands(rng, e, m, k, n, signed, cuda_device, zero_expert=e // 2)
    for out in (torch.float32, torch.bfloat16):
        _check_on_card(o, out)


@pytest.mark.cuda
@pytest.mark.parametrize("e,k,n", GRANITE_SHARD_SITES)
@pytest.mark.parametrize("m", [1, 4, 64])
def test_cuda_expert_kernels_on_granite_shards(e, k, n, m, cuda_device):
    """B1e and B4e at granite's expert shards, and their accumulator-only
    form (one launch each), bit-equal to the plain versions."""
    o = _operands(np.random.default_rng(e + m + n), e, m, k, n, False, cuda_device,
                  zero_expert=1)
    _check_on_card(o, torch.bfloat16)
    before = (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches)
    dense, sparse = _accumulator_args(o, o["col"]), _accumulator_args(o, o["scol"])
    acc = (W.w4a8_expert_matmul(o["x"], o["dense"], *dense),
           W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sparse))
    plain = (W.w4a8_expert_matmul(o["x"], o["dense"], *dense, reference=True),
             W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sparse,
                                         reference=True))
    torch.cuda.synchronize()
    assert (W.w4a8_expert_matmul.launches, W.w4a8_sparse_expert_matmul.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(acc[0], plain[0]) and torch.equal(acc[1], plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 70])
def test_cuda_expert_kernels_ragged(m, cuda_device):
    """A ragged N (4-byte loads) and ragged M."""
    o = _operands(np.random.default_rng(m), 5, m, 192, 60, False, cuda_device)
    assert W.w4a8_plan(m, 60, 192, experts=5).vec == 4
    _check_on_card(o, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 48, 49, 64, 65, 80, 81])
@pytest.mark.parametrize("e", [1, 5, 40])
def test_cuda_expert_tiers_bit_equal_at_the_boundary(e, m, signed, cuda_device):
    """Both tiers on both sides of each tier boundary (16 | 17: the decode
    tier's two widths; 48 | 49 and 64 | 65: the tile tier between where its
    tiles fit one wave; 80 | 81: the most the decode tier takes), at
    granite's sites, one all-zero expert where E > 1."""
    for k, n in GRANITE_EXPERT_SITES:
        assert W.w4a8_expert_plan(m, n, k, e).tier == W.expert_tier(m, n, e)
    for k, n in GRANITE_EXPERT_SITES:
        rng = np.random.default_rng(1000 * e + 10 * m + int(signed))
        o = _operands(rng, e, m, k, n, signed, cuda_device,
                      zero_expert=e // 2 if e > 1 else None)
        _check_on_card(o, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 17, 64, 80])
def test_cuda_b4e_adds_equal_positions(m, cuda_device, rng):
    """A hand-made meta of every position pair, both positions equal in
    some groups: B4e sums the two codes there and takes descending pairs,
    as the plain version does, in both tiers (64: the tile tier; 4, 17, 80:
    both widths of the decode tier)."""
    e, k, n = 3, 512, 64
    o = _operands(rng, e, m, k, n, False, cuda_device)
    meta = rng.integers(0, 16, size=(e, k // 4, n))
    meta[:, ::3] = rng.integers(0, 4, size=meta[:, ::3].shape) * 5  # p0 == p1
    o["meta"] = _t(meta.astype(np.int8), cuda_device)
    sargs = (o["scale"], o["scol"], o["act_scale"], o["act_zp"])
    y = W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sargs,
                                    out_dtype=torch.float32)
    r = W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sargs,
                                    out_dtype=torch.float32, reference=True)
    assert torch.equal(y, r)


@pytest.mark.cuda
def test_cuda_decode_tier_replays_in_a_graph(cuda_device):
    """B1e and B4e of the decode tier captured in a CUDA graph: a replay on
    new codes equals the eager call, and the graph's kernel nodes count one
    B1e and one B4e."""
    from repro_torch.serving.graphs import graph_contents

    o = _operands(np.random.default_rng(7), 40, 4, 1536, 512, False, cuda_device)
    args = (o["scale"], o["col"], o["act_scale"], o["act_zp"])
    sargs = (o["scale"], o["scol"], o["act_scale"], o["act_zp"])

    def calls():
        return (W.w4a8_expert_matmul(o["x"], o["dense"], *args, out_dtype=torch.bfloat16),
                W.w4a8_sparse_expert_matmul(o["x"], o["packed"], o["meta"], *sargs,
                                            out_dtype=torch.bfloat16))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls()  # loads the library and sets the kernels' attributes
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        outs = calls()
    graph.instantiate()
    o["x"].copy_(torch.randint(0, 256, o["x"].shape, device=cuda_device).to(torch.uint8))
    graph.replay()
    torch.cuda.synchronize()
    want = calls()
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    counts = dict(zip((fn.__name__ for fn, _, _ in COUNTERS),
                      count_kernels(graph_contents(graph)[1])))
    assert counts["w4a8_expert_matmul"] == 1 and counts["w4a8_sparse_expert_matmul"] == 1


@pytest.mark.parametrize("m", range(1, 129))
def test_expert_tier_by_rows(m):
    """The decode tier up to 48 rows an expert and from 65 to 80, the tile
    tier above; between, granite's wg/wu (40 x 8 tiles of 64 columns, one
    wave of 3 an SM) take the tile tier and its wd (40 x 24 tiles) the
    decode tier (the tiers' times at granite's sites): decode at granite's
    decode (4 rows) and a paged admit's 80 rows."""
    for k, n in GRANITE_EXPERT_SITES:
        between = "tile" if n == 512 else "decode"
        want = "decode" if m <= 48 or 64 < m <= 80 else (between if m <= 64 else "tile")
        assert W.expert_tier(m, n, 40) == want == W.w4a8_expert_plan(m, n, k, 40).tier
