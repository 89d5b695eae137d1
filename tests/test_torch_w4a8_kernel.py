"""The W4A8 GEMMs B1 (dense) and B4 (2:4) of ``csrc/w4a8_mm.cu``: their
plan, a model of their tensor-core fragments, and the kernels on the card.
This file imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_w4a8_kernel.py

On the CPU: ``w4a8_plan`` covers every output element and K row exactly
once, for M up to 4096, and splits K as far as a cluster allows at
smollm-360m's decode sites; a numpy model of the kernel's B fragments (the
nibble unpack, the column permutation, the 2:4 expansion) read through the
m16n8k32 fragment layout of the PTX ISA gives the exact integer product,
over the whole of K and summed over the plan's K chunks, and the same
model with the nibbles swapped or without the epilogue's column
un-permutation does not.

Tests marked ``cuda`` skip without a card (the kernels have no CPU
interpret mode). On the card B1 and B4 are held bit-equal to their plain
versions (integer sums are exact in any order; the epilogue rounds each
operation on its own) and B4 to B1 on the expanded codes, from decode to
prefill M, across ragged N, misaligned operands, CUDA-graph replay, the
sync-debug mode and a profiler count of one kernel a call.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import mask_2to4
from repro_torch.kernels import w4a8_mm as W
from test_torch_trace import complete_trace, traced_kernels

#: (K, N) of the 7 packed sites of one smollm-360m layer
SMOLLM_SITES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
#: ragged N (20, 60, 100: 4-byte loads), smollm-360m's sites, long K
KN_CASES = [(64, 20), (960, 60), (960, 100), (4096, 20), *SMOLLM_SITES, (8192, 64)]
M_CASES = [1, 2, 3, 4, 7, 8, 9, 17, 64, 255, 256, 257, 300]


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves (no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
def _spans(plan, m, n, k):
    """The (rows, columns, K rows) that each block of ``plan``'s grid owns,
    by the kernel's index arithmetic: block (x, y, z) owns rows y * TILE_M,
    columns x * TILE_N and K rows z * ck, each cut at the matrix edge."""
    gx, gy, gz = plan.grid
    rows = [(y * W.TILE_M, min(m, (y + 1) * W.TILE_M)) for y in range(gy)]
    cols = [(x * W.TILE_N, min(n, (x + 1) * W.TILE_N)) for x in range(gx)]
    ks = [(z * plan.ck, min(k, (z + 1) * plan.ck)) for z in range(gz)]
    return rows, cols, ks


def _exactly_once(spans, size):
    seen = np.zeros(size, dtype=np.int64)
    for lo, hi in spans:
        assert lo < hi or size == 0, f"empty span ({lo}, {hi})"
        seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("n_sm", [W.H100_SMS, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k,n", KN_CASES)
def test_plan_covers_every_element_once(k, n, aligned, n_sm):
    for m in [*M_CASES, 511, 1024, 4095, 4096]:
        plan = W.w4a8_plan(m, n, k, aligned, n_sm)
        rows, cols, ks = _spans(plan, m, n, k)
        # every (row tile, column tile, K chunk) once: the grid is their product
        assert _exactly_once(rows, m) and _exactly_once(cols, n) and _exactly_once(ks, k)
        # chunks of whole pipeline stages, so of whole quads (a quad of 4 K
        # rows is one 2:4 group)
        assert plan.ck % W.STAGE_K == 0
        # 16-byte loads only where the layout allows them
        assert plan.vec == 4 or (aligned and n % 16 == 0 and k % 16 == 0)
        # a split's chunks of a tile are one (portable) thread block cluster
        assert plan.grid[2] <= W.MAX_CHUNKS
        # computed once a shape
        assert W.w4a8_plan(m, n, k, aligned, n_sm) is plan


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", range(1, 9))
def test_plan_splits_k_at_smollm_decode(m, aligned):
    """At decode every smollm-360m site's tiles alone leave SMs idle, so K
    splits into chunks of whole stages, as far as one cluster allows or
    until two blocks an SM: 8 one-stage chunks at (960, 960) and (960,
    320), 4 of two stages at (960, 2560), 7 of three at (2560, 960); 16-byte
    loads where the operands are aligned."""
    want = {(960, 960): (128, 8), (960, 320): (128, 8), (960, 2560): (256, 4),
            (2560, 960): (384, 7)}
    for k, n in SMOLLM_SITES:
        plan = W.w4a8_plan(m, n, k, aligned)
        assert plan.grid[:2] == (-(-n // W.TILE_N), 1)
        assert (plan.ck, plan.grid[2]) == want[(k, n)], (k, n, plan)
        assert plan.vec == (16 if aligned else 4)


# ---------------------------------------------------------------------------
# A model of the kernels' arithmetic on 32-bit words
# ---------------------------------------------------------------------------
U32 = np.uint32


def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes {y, x} (x the low four)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=U32)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * sel)) & np.uint64(0xFF)
        out |= (byte.astype(U32) << U32(8 * i))
    return out


def sext_nibbles(v):
    return ((v ^ U32(0x08080808)) + U32(0x78787878)) ^ U32(0x80808080)


def vadd4(a, b):
    out = np.zeros_like(a, dtype=U32)
    for i in range(4):
        s = ((a >> U32(8 * i)) + (b >> U32(8 * i))) & U32(0xFF)
        out |= s << U32(8 * i)
    return out


def quad_codes(lo, hi, sparse, swap_nibbles=False):
    """``quad_codes<Sparse>``: four 4-code words, one per column."""
    low, high = lo & U32(0x0F0F0F0F), (lo >> U32(4)) & U32(0x0F0F0F0F)
    if swap_nibbles:
        low, high = high, low
    if sparse:
        v0, v1 = sext_nibbles(low), sext_nibbles(high)
        out = []
        for j in range(4):
            m = hi >> U32(8 * j)
            p0, p1 = U32(8) * (m & U32(3)), U32(8) * ((m >> U32(2)) & U32(3))
            s0 = ((v0 >> U32(8 * j)) & U32(0xFF)) << p0
            s1 = ((v1 >> U32(8 * j)) & U32(0xFF)) << p1
            out.append((s0 + s1) & ((U32(0xFF) << p0) | (U32(0xFF) << p1)))
        return out
    hlo, hhi = hi & U32(0x0F0F0F0F), (hi >> U32(4)) & U32(0x0F0F0F0F)
    if swap_nibbles:
        hlo, hhi = hhi, hlo
    a, b, c, d = sext_nibbles(low), sext_nibbles(high), sext_nibbles(hlo), sext_nibbles(hhi)
    ab_lo, ab_hi = byte_perm(a, b, 0x5140), byte_perm(a, b, 0x7362)
    cd_lo, cd_hi = byte_perm(c, d, 0x5140), byte_perm(c, d, 0x7362)
    return [byte_perm(ab_lo, cd_lo, 0x5410), byte_perm(ab_lo, cd_lo, 0x7632),
            byte_perm(ab_hi, cd_hi, 0x5410), byte_perm(ab_hi, cd_hi, 0x7632)]


def words(rows_bytes, r, col):
    """The little-endian 32-bit word of bytes col .. col+3 of row r."""
    b = rows_bytes[r, col:col + 4].astype(np.uint8).astype(U32)
    return b[0] | (b[1] << U32(8)) | (b[2] << U32(16)) | (b[3] << U32(24))


def lanes_words(rows_bytes, r, col):
    """``words`` for arrays of rows and columns."""
    b = np.stack([rows_bytes[r, col + i].astype(np.uint8).astype(U32) for i in range(4)])
    return b[0] | (b[1] << U32(8)) | (b[2] << U32(16)) | (b[3] << U32(24))


def bytes_of(word, signed):
    """(..., 4) the four bytes of each word, as int8 or uint8 values."""
    b = np.stack([(word >> U32(8 * i)) & U32(0xFF) for i in range(4)], -1).astype(np.int64)
    return np.where(b >= 128, b - 256, b) if signed else b


def mma_m16n8k32(a_regs, b_regs, a_signed):
    """mma.m16n8k32 .s32 on the fragment layout of the PTX ISA ("Matrix
    Fragments for mma.m16n8k32", 8-bit types): lane = 4 groupID +
    threadID_in_group. A element i of a lane (4 a register) is row groupID
    for i in [0, 4) or [8, 12), else groupID + 8, and column 4 tid + (i & 3),
    + 16 for i >= 8; B element i is row 4 tid + (i & 3), + 16 for i >= 4,
    column groupID; C element i is row groupID (+ 8 for i >= 2), column
    2 tid + (i & 1). ``a_regs`` is (32, 4) words, ``b_regs`` (32, 2);
    returns the (32, 4) int32 accumulator registers."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tid = lane // 4, lane % 4
        a = bytes_of(a_regs[lane], a_signed).reshape(16)
        for i in range(16):
            row = gid if (i < 4 or 8 <= i < 12) else gid + 8
            A[row, 4 * tid + (i & 3) + (16 if i >= 8 else 0)] = a[i]
        b = bytes_of(b_regs[lane], True).reshape(8)
        for i in range(8):
            B[4 * tid + (i & 3) + (16 if i >= 4 else 0), gid] = b[i]
    D = A @ B
    out = np.zeros((32, 4), np.int64)
    for lane in range(32):
        gid, tid = lane // 4, lane % 4
        for i in range(4):
            out[lane, i] = D[gid + (8 if i >= 2 else 0), 2 * tid + (i & 1)]
    return out


def mma_path_model(x, wbytes, meta, a_signed, *, swap_nibbles=False, unpermute=True):
    """The kernel's product of (M, K) codes ``x`` and the packed
    weights (``wbytes`` (K/2, N) dense, or (K/4, N) packed kept codes with
    ``meta``), as the kernel forms it: per 32-column group and k32 step,
    lane (g, t)'s B registers come from one ``quad_codes`` of columns
    4g .. 4g+3 (quads 8 ks + t and + 4) and feed n8 tiles 0..3; A registers
    are 32-bit words of x rows g and g + 8 at bytes 4t and 4t + 16; the
    accumulator of n8 tile j, column 2t + e, goes to column 4 (2t + e) + j."""
    m, k = x.shape
    n = wbytes.shape[1]
    sparse = meta is not None
    mp, kp, np_ = -(-m // 16) * 16, -(-k // 32) * 32, -(-n // 32) * 32
    xb = np.zeros((mp, kp), np.uint8)
    xb[:m, :k] = x.astype(np.uint8)
    rows_w = kp // (4 if sparse else 2)
    wb = np.zeros((rows_w, np_), np.int8)
    wb[:wbytes.shape[0], :n] = wbytes
    mb = None
    if sparse:
        mb = np.zeros((rows_w, np_), np.int8)
        mb[:meta.shape[0], :n] = meta
    out = np.zeros((mp, np_), np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for cg in range(np_ // 32):
        for mt in range(mp // 16):
            acc = np.zeros((4, 32, 4), np.int64)  # n8 tile, lane, register
            for ks in range(kp // 32):
                b = np.zeros((4, 32, 2), U32)
                for h in range(2):
                    q = 8 * ks + t + 4 * h
                    col = 32 * cg + 4 * g
                    if sparse:
                        lo, hi = lanes_words(wb, q, col), lanes_words(mb, q, col)
                    else:
                        lo, hi = lanes_words(wb, 2 * q, col), lanes_words(wb, 2 * q + 1, col)
                    for j, wc in enumerate(quad_codes(lo, hi, sparse, swap_nibbles)):
                        b[j, :, h] = wc
                r0 = 16 * mt + g
                kb = 32 * ks + 4 * t
                a = np.stack([lanes_words(xb, r0, kb), lanes_words(xb, r0 + 8, kb),
                              lanes_words(xb, r0, kb + 16), lanes_words(xb, r0 + 8, kb + 16)],
                             -1)
                for j in range(4):
                    acc[j] += mma_m16n8k32(a, b[j], a_signed)
            for j in range(4):
                for i in range(4):
                    row = 16 * mt + g + (8 if i >= 2 else 0)
                    c8 = 2 * t + (i & 1)
                    col = 4 * c8 + j if unpermute else 8 * j + c8
                    out[row, 32 * cg + col] = acc[j, :, i]
    return out[:m, :n]


def _codes(rng, m, k, n, signed, sparse):
    q = rng.integers(-8, 8, size=(k, n))  # full int4 range, -8 included
    if sparse:
        q = q * mask_2to4(_t(q.astype(np.float32))).numpy().astype(np.int64)
    lo, hi, dt = (-128, 128, np.int8) if signed else (0, 256, np.uint8)
    x = rng.integers(lo, hi, size=(m, k)).astype(dt)
    return q, x


def _weights(q, sparse):
    if sparse:
        packed, meta = W.compress_2to4(_t(q))
        return packed.numpy(), meta.numpy()
    return W.pack_int4(_t(q)).numpy(), None


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("m,k,n", [(16, 32, 32), (20, 96, 64), (33, 128, 36)])
def test_mma_fragment_model_is_the_exact_product(m, k, n, signed, sparse, rng):
    q, x = _codes(rng, m, k, n, signed, sparse)
    wbytes, meta = _weights(q, sparse)
    got = mma_path_model(x, wbytes, meta, signed)
    exact = W.exact_int_matmul(_t(x), _t(q)).numpy()
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("fault", ["swap_nibbles", "no_unpermute"])
def test_mma_fragment_model_catches_a_wrong_layout(fault, sparse, rng):
    """The model is sharp: with the nibbles of a byte swapped, or with the
    accumulators written back in n8-tile order, the product is wrong."""
    q, x = _codes(rng, 16, 64, 32, False, sparse)
    wbytes, meta = _weights(q, sparse)
    kw = {"swap_nibbles": True} if fault == "swap_nibbles" else {"unpermute": False}
    got = mma_path_model(x, wbytes, meta, False, **kw)
    assert not np.array_equal(got, W.exact_int_matmul(_t(x), _t(q)).numpy())


def test_sparse_loader_adds_per_byte_for_every_meta():
    """The 2:4 loader's masked add is the per-byte add (``__vadd4``) for
    every meta byte, hand-made ones with equal positions included, and so
    gives the codes of the reference's ``unpack_sparse24`` (which sums the
    two codes of equal positions, wrapping as int8)."""
    vals = np.arange(-8, 8)
    a, b, meta = (g.reshape(-1) for g in np.meshgrid(vals, vals, np.arange(16), indexing="ij"))
    packed = W.pack_int4(_t(np.stack([a, b]).astype(np.int8))).numpy()  # (1, n)
    meta = meta.reshape(1, -1)
    n = packed.shape[1]
    want = W.unpack_sparse24(_t(packed), _t(meta.astype(np.int8))).numpy().T  # (n, 4) a column
    lo = np.concatenate([packed, np.zeros((1, (-n) % 4), np.int8)], 1)
    hi = np.concatenate([meta, np.zeros((1, (-n) % 4), np.int64)], 1)
    for c0 in range(0, n, 4):
        wc = quad_codes(words(lo, 0, c0), words(hi, 0, c0), True)
        for j in range(4):
            assert wc[j] == vadd4(*(U32(((int(v) & 0xFF) << (8 * p)))
                                     for v, p in ((a[c0 + j], meta[0, c0 + j] & 3),
                                                  (b[c0 + j], (meta[0, c0 + j] >> 2) & 3))))
            np.testing.assert_array_equal(bytes_of(np.array(wc[j]), True), want[c0 + j])


def test_sext_nibbles_is_the_int4_value():
    nib = np.arange(16, dtype=U32)
    word = nib | (nib[::-1] << U32(8)) | (nib << U32(16)) | (nib[::-1] << U32(24))
    got = bytes_of(sext_nibbles(word), True)
    want = np.where(nib >= 8, nib.astype(np.int64) - 16, nib.astype(np.int64))
    np.testing.assert_array_equal(got[:, 0], want)
    np.testing.assert_array_equal(got[:, 1], want[::-1])


def split_k_model(x, wbytes, meta, a_signed, plan):
    """The kernel's sums over the plan's K split: each chunk's tile by
    ``mma_path_model`` on its K rows, then the cluster's reduction: per
    output tile, rank q owns the q-th share of the 4-column vectors in the
    tile's live rows (below M), every rank puts its vector into slot
    ``rank`` of the owner's receive buffer, and each owner sums its slots.
    Without a split each vector goes straight to the output."""
    m, k = x.shape
    per_row = 4 if meta is not None else 2
    tiles = []
    for z in range(plan.grid[2]):
        k0, k1 = z * plan.ck, min(k, (z + 1) * plan.ck)
        rows = slice(k0 // per_row, k1 // per_row)
        tiles.append(mma_path_model(x[:, k0:k1], wbytes[rows], None if meta is None
                                    else meta[rows], a_signed))
    n = tiles[0].shape[1]
    chunks, per_row_vectors = plan.grid[2], W.TILE_N // 4
    out = np.zeros((m, n), np.int64)
    written = np.zeros((m, n), np.int64)
    for ty, tx in itertools.product(range(plan.grid[1]), range(plan.grid[0])):
        live = min(W.TILE_M, m - ty * W.TILE_M) * per_row_vectors
        share = -(-live // chunks)
        rx = {q: np.zeros((chunks * share, 4), np.int64) for q in range(chunks)}
        for rank, v in itertools.product(range(chunks), range(live)):
            q = v // share
            row = ty * W.TILE_M + v // per_row_vectors
            col = tx * W.TILE_N + 4 * (v % per_row_vectors)
            if col < n:  # the kernel sends the vectors past N too; they add zeros
                cut = min(4, n - col)  # a ragged N's last vector holds N - col columns
                rx[q][rank * share + v - q * share, :cut] = tiles[rank][row, col:col + cut]
        for q in range(chunks):
            for u in range(share):
                v = q * share + u
                row = ty * W.TILE_M + v // per_row_vectors
                col = tx * W.TILE_N + 4 * (v % per_row_vectors)
                if v < live and col < n:  # stored cut at N
                    cut = min(4, n - col)
                    out[row, col:col + cut] = sum(rx[q][r * share + u]
                                                  for r in range(chunks))[:cut]
                    written[row, col:col + cut] += 1
    assert (written == 1).all()  # every output by exactly one rank
    return out


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("m,k,n,aligned,n_sm", [(3, 512, 32, True, 132), (3, 960, 20, True, 132),
                                                (70, 2176, 48, False, 132),
                                                (17, 1024, 36, True, 1), (2, 96, 48, False, 132)])
def test_split_k_model_is_the_exact_product(m, k, n, aligned, n_sm, sparse, rng):
    """K split into 1-8 chunks, a last chunk that ends inside a stage (K =
    960), 16- and 4-byte loads, a second row tile with fewer live rows (M =
    70)."""
    q, x = _codes(rng, m, k, n, True, sparse)
    wbytes, meta = _weights(q, sparse)
    plan = W.w4a8_plan(m, n, k, aligned, n_sm)
    got = split_k_model(x, wbytes, meta, True, plan)
    np.testing.assert_array_equal(got, W.exact_int_matmul(_t(x), _t(q)).numpy())


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------
def _operands(rng, m, k, n, signed, device, offset=0):
    """Full-range codes on the card: x (M, K), the dense packed weight, the
    2:4 codes' packed + meta and their expanded dense pack, the scale and
    both col_sums. ``offset`` places x and every weight that many bytes
    into a larger buffer (contiguous, 4-byte but not 16-byte aligned)."""
    q, x = _codes(rng, m, k, n, signed, False)
    qs = q * mask_2to4(_t(q.astype(np.float32))).numpy().astype(np.int64)

    def place(t):
        if not offset:
            return t.to(device)
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    packed, meta = W.compress_2to4(_t(qs))
    return {
        "x": place(_t(x)),
        "dense": place(W.pack_int4(_t(q))),
        "packed": place(packed), "meta": place(meta),
        "sdense": place(W.pack_int4(_t(qs))),
        "scale": _t(rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32), device),
        "col": _t(q.sum(0).astype(np.int32), device),
        "scol": _t(qs.sum(0).astype(np.int32), device),
    }


def _check_b1_b4(o, out, counted=True):
    kw = dict(out_dtype=out)
    b1_before, b4_before = W.w4a8_matmul.launches, W.w4a8_sparse_matmul.launches
    y = W.w4a8_matmul(o["x"], o["dense"], o["scale"], 0.02, 131.0, col_sums=o["col"], **kw)
    r = W.w4a8_matmul(o["x"], o["dense"], o["scale"], 0.02, 131.0, col_sums=o["col"],
                      reference=True, **kw)
    ys = W.w4a8_sparse_matmul(o["x"], o["packed"], o["meta"], o["scale"], 0.02, 131.0,
                              col_sums=o["scol"], **kw)
    rs = W.w4a8_sparse_matmul(o["x"], o["packed"], o["meta"], o["scale"], 0.02, 131.0,
                              col_sums=o["scol"], reference=True, **kw)
    b1s = W.w4a8_matmul(o["x"], o["sdense"], o["scale"], 0.02, 131.0, col_sums=o["scol"], **kw)
    torch.cuda.synchronize()
    if counted:
        assert W.w4a8_matmul.launches == b1_before + 2
        assert W.w4a8_sparse_matmul.launches == b4_before + 1
    assert torch.equal(y, r), "B1 != plain"
    assert torch.equal(ys, rs), "B4 != plain"
    assert torch.equal(ys, b1s), "B4 != B1 on the expanded codes"


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k,n", KN_CASES)
@pytest.mark.parametrize("m", M_CASES)
def test_cuda_kernel_bit_equal_to_plain(m, k, n, signed, rng, cuda_device):
    o = _operands(rng, m, k, n, signed, cuda_device)
    for out in (torch.float32, torch.bfloat16):
        _check_b1_b4(o, out)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64, 256])
def test_cuda_kernel_at_a_4_byte_offset(m, rng, cuda_device):
    """x and every weight 4 bytes into their buffers: contiguous, 4-byte
    but not 16-byte aligned, so the kernel takes its 4-byte loads."""
    o = _operands(rng, m, 960, 320, False, cuda_device, offset=4)
    assert all(o[key].data_ptr() % 16 == 4 for key in ("x", "dense", "packed", "meta"))
    assert not W.w4a8_plan(m, 320, 960, aligned=False).vec == 16
    for out in (torch.float32, torch.bfloat16):
        _check_b1_b4(o, out)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 256])
def test_cuda_kernel_replays_in_a_cuda_graph(m, rng, cuda_device):
    """One split-K call of B1 and one of B4 (a cluster launch) captured in a
    CUDA graph and replayed three times on new inputs copied into the
    captured buffers: equal to plain each time, so a launch leaves nothing
    behind that the next one reads."""
    k, n = 2560, 960
    assert W.w4a8_plan(m, n, k).grid[2] > 1  # the replay crosses the split
    o = _operands(rng, m, k, n, False, cuda_device)
    sw, corr = o["scale"] * 0.02, o["col"].to(torch.float32) * 131.0
    scorr = o["scol"].to(torch.float32) * 131.0
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):  # build and load before the capture
        W.w4a8_matmul_kernel(o["x"], o["dense"], sw, corr)
        W.w4a8_sparse_matmul_kernel(o["x"], o["packed"], o["meta"], sw, scorr)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        y = W.w4a8_matmul_kernel(o["x"], o["dense"], sw, corr)
        ys = W.w4a8_sparse_matmul_kernel(o["x"], o["packed"], o["meta"], sw, scorr)
    for _ in range(3):
        o["x"].copy_(_t(rng.integers(0, 256, size=(m, k)).astype(np.uint8), cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, W.w4a8_matmul_plain(o["x"], o["dense"], sw, corr))
        assert torch.equal(ys, W.w4a8_sparse_matmul_plain(o["x"], o["packed"], o["meta"],
                                                          sw, scorr))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 256])
def test_cuda_kernel_never_synchronizes(m, rng, cuda_device):
    o = _operands(rng, m, 2560, 960, False, cuda_device)
    sw, corr = o["scale"] * 0.02, o["col"].to(torch.float32) * 131.0
    scorr = o["scol"].to(torch.float32) * 131.0
    W.w4a8_matmul_kernel(o["x"], o["dense"], sw, corr)  # build and load first
    W.w4a8_sparse_matmul_kernel(o["x"], o["packed"], o["meta"], sw, scorr)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = W.w4a8_matmul_kernel(o["x"], o["dense"], sw, corr)
        ys = W.w4a8_sparse_matmul_kernel(o["x"], o["packed"], o["meta"], sw, scorr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(y, W.w4a8_matmul_plain(o["x"], o["dense"], sw, corr))
    assert torch.equal(ys, W.w4a8_sparse_matmul_plain(o["x"], o["packed"], o["meta"], sw, scorr))


@pytest.mark.cuda
def test_cuda_kernel_one_launch_a_call(rng, cuda_device):
    """The profiler sees exactly one kernel a call, by name, at decode and
    prefill M and with and without a K split."""
    cases = [(4, 960, 320), (4, 2560, 960), (256, 960, 2560), (256, 2560, 960)]
    ops = [_operands(rng, m, k, n, False, cuda_device) for m, k, n in cases]
    args = []
    for o in ops:
        sw, corr = o["scale"] * 0.02, o["col"].to(torch.float32) * 131.0
        args.append((o, sw, corr))
        W.w4a8_matmul_kernel(o["x"], o["dense"], sw, corr)
        W.w4a8_sparse_matmul_kernel(o["x"], o["packed"], o["meta"], sw, corr)
    torch.cuda.synchronize()

    def calls():
        for o, sw, corr in args:
            W.w4a8_matmul_kernel(o["x"], o["dense"], sw, corr)
            W.w4a8_sparse_matmul_kernel(o["x"], o["packed"], o["meta"], sw, corr)

    events = traced_kernels(complete_trace(calls).key_averages())
    assert sum(e.count for e in events if "w4a8_kernel" in e.key) == 2 * len(cases)
    assert sum(e.count for e in events) == 2 * len(cases), [e.key for e in events]
