// W4A8 integer GEMM for Hopper (sm_90a): packed-int4 weights x 8-bit
// activation codes, exact int32 accumulation, fused dequant epilogue.
//
// Replaces the Pallas TPU kernel repro/kernels/w4a8_mm.py:140 (`_kernel`,
// pallas_call at :263; wrappers w4a8_matmul :202, w4a8_decode_matmul :283).
//
//   out[m, n] = (float(sum_k x[m, k] * q[k, n]) - corr[n]) * sw[n]
//
// x is (M, K) uint8 or int8 codes, row-major; w is (K/2, N) int8 with two
// int4 codes per byte along K (row 2k = low nibble, row 2k+1 = high nibble,
// both sign-extended); corr = col_sums * act_zp and sw = w_scale * act_scale
// are f32 vectors formed by the caller.
//
// One kernel for every M, `w4a8_kernel`: int8 tensor cores, mma.sync
// m16n8k32 (.u8.s8, or .s8.s8 for signed codes; int32 accumulation in the
// tensor core is exact). 64 x 64 output tiles, 2 x 2 warps of 32 x 32; the
// x tile and the packed weight tile stream through a 4-stage cp.async ring
// in shared memory, 128 K rows a stage. A lane's B fragment is built from
// shared memory by the nibble unpack (`sext_nibbles`, `quad_codes`): n8
// tile j of a warp's 32-column group takes columns {4i + j}, so one quad
// of 4 adjacent columns (two 32-bit words) gives a lane its B register for
// all four n8 tiles; the epilogue puts each column back in its place. The
// Python plan (`w4a8_plan` in kernels/w4a8_mm.py) hands this launcher the
// load width, the K chunk and the grid as ints; each call is one launch.
//
// Where the output tiles alone would leave SMs idle (every decode-sized
// call), K is split into up to 8 chunks of whole stages (one stage a chunk
// where M fits one row tile), and the split is reduced inside the launch:
// the chunks of a tile are one thread block cluster, every block pushes
// each 4-column vector of its tile's live rows into the receive buffer of
// the rank that owns it (distributed shared memory), and after one cluster
// barrier each rank sums its vectors and runs their epilogue. No
// workspace, no atomics, no memset and no value from the host, so a launch
// replays in a CUDA graph.
// The epilogue rounds exactly as the plain version does: int32 -> f32
// (RN), subtract, multiply, each rounded on its own (no fused
// multiply-add), then f32 -> bf16 (RN). Integer sums are exact in any
// order, so the kernel is bit-equal to the plain version for every split.
//
// Every smollm-360m call is bound by latency, not by its bytes (0.15-1.23
// MB of weights a site) or its operations: at M = 4 a block's first stage
// lands 1.1-1.6 us after it starts, and the main loop, the split's sum and
// the epilogue follow in series behind it. A separate dp4a
// kernel for M <= 8 (one block per column tile and K chunk, 150-640 blocks
// a site), timed against this one site by site (PERF.md section 6), won
// by 0.05-0.3 us a call at K = 960, N <= 960 and lost by 0.2-0.5 us at the
// two larger sites and at M = 8: one layer ran 0.3-0.8 us faster on this
// kernel alone at every M from 1 to 8, so there is no second kernel.
//
// The 2:4 sparse GEMM (kernel B4) is the same kernel with another weight
// loader. It replaces the Pallas TPU kernel
// repro/kernels/w4a8_mm.py:311 (`_sparse_kernel`, pallas_call at :410;
// wrappers w4a8_sparse_matmul :349, w4a8_sparse_decode_matmul :431). Its
// weights are (K/4, N) int8 `packed` (per group of 4 K rows and column,
// low nibble = first kept code, high = second) and (K/4, N) `meta` (bits
// 0-1 / 2-3 = the in-group positions of the two). One group of 4 K rows is
// one 4-code word, as a quad of the dense layout is: the loader
// sign-extends the two nibbles, shifts each to the byte of its position and
// adds the two words per byte (a masked add), so a hand-made meta with
// equal positions sums the codes as the reference's unpack_sparse24 does.
// Weight bytes per column are K/4 + K/4, the same as B1's K/2, so B4 is
// bound as B1 is; mma.sp with a meta re-laid out at pack time is later
// work.
//
// B1e and B4e, the same two GEMMs over an expert axis, are the
// counterpart of the batched pallas_call that jax.vmap makes of both Pallas
// kernels for the MoE FFN (repro/models/moe.py:122): E problems of (M, N,
// K) in one launch, each expert with its own sw and corr rows, bit-equal to
// E launches of B1 and B4 on the slices (integer sums are exact in any
// order). Two tiers, chosen by rows an expert (w4a8_expert_plan in
// kernels/w4a8_mm.py): the tile tier is w4a8_kernel with `Experts` = true
// (entries w4a8_expert_matmul_launch and w4a8_sparse_expert_matmul_launch),
// the grid's rows walking the experts' row tiles; the decode tier is
// w4a8_expert_decode_kernel (entry w4a8_expert_decode_launch), below. B4e
// expands its 2:4 words by byte permutes (quad_codes_lut) in both tiers.
//
// What bounds the expert axis at decode: granite-moe-3b-a800m's decode
// step gives each expert M = 4 rows, so a site is 15.7 MB of int4 weights
// and nothing else (byte bound 4.9 us). On the tile tier 60 of 64 rows of
// every tile were dead, and each block walked the whole K through a
// 3-stage ring (24 us a site, the chain of stages, not the bytes). The
// decode tier puts the tokens on the mma's n8 side, streams 128-byte weight
// rows (every copy instruction moves whole rows, only live rows of x are
// copied), and splits K over a cluster where the experts' column tiles
// leave the card short of blocks. What holds it at 1.9-2.3x its byte bound
// in device time is not known yet: a clean cold L2 (no dirty line of the
// flush to write back) takes only ~1 us a site off.
//
// B4e on mma.sp (m16n8k64, the weights as the sparse operand, each group's
// stored meta put in ascending order in registers: descending positions
// swapped, equal ones summed into one slot; the metadata register, probed
// on the card, holds row g + 8 (t & 1), groups 8 (t >> 1) .. +7 of lane
// (g, t)) was bit-equal and slower: 27.6-29.0 us a site at M = 4 against
// 17.6-18.8 us for the byte permutes, 41.7-49.8 at M = 80 against
// 30.3-35.8 (scripts/torch_expert_tiers.py, both builds in one call). The
// byte permutes stay in both tiers.
//
// Measured (chip_smoke.py phase 11 and scripts/torch_expert_tiers.py;
// NVIDIA H100 80GB HBM3, 700.00 W; E = 40, cold L2, an event pair around
// one launch, where an empty kernel reads 5.0 us): at M = 4, B1e 15.5-16.9
// us a site (9.6-11.1 us of device time by the profiler; 14.4-15.9 after a
// flush by a read), one granite layer's 3 sites 49-51 us (before the
// decode tier 71.9), B4e 1.12-1.13x B1e; at M = 80 a layer 94.7-96.2 us
// (B1e) and 102-104 (B4e) against one bf16 bmm's 118-120. PERF.md section
// 6 has the table.
//
// Measured for B1/B4 (chip_smoke.py phases 2 and 8, the same card and
// timing): one smollm-360m layer's 7 sites take 0.0641 ms at M = 4 (8.5-9.9
// us a site) and 0.0898 ms at M = 256 (9.9-15.9 us a site); B4 is
// 1.03-1.12x B1 at M = 4 and 1.06-1.24x at M = 256.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// Building blocks
// ---------------------------------------------------------------------------

// Four nibbles, one per byte in [0, 15], to four sign-extended int8 bytes:
// per byte (n ^ 8) + 0x78 stays below 0x88 (no carry into the next byte),
// and flipping bit 7 of it gives (n ^ 8) - 8 mod 256.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return ((v ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// The 4 K codes of each of 4 adjacent columns, as one 4-code word per
// column (wc[j] = column j's codes for K rows 4q .. 4q+3), from two 32-bit
// words of the weights. Dense (Sparse = false): `lo`, `hi` are the 4
// columns' bytes of packed rows 2q and 2q+1. 2:4 (Sparse = true): `lo` is
// row q of the packed kept codes, `hi` row q of their meta.
template <bool Sparse>
__device__ __forceinline__ void quad_codes(uint32_t lo, uint32_t hi, uint32_t wc[4]);

template <>
__device__ __forceinline__ void quad_codes<false>(uint32_t lo, uint32_t hi, uint32_t wc[4]) {
  // codes of rows 4q, 4q+1 (byte row 2q) and 4q+2, 4q+3 (byte row 2q+1),
  // one byte per column
  const uint32_t a = sext_nibbles(lo & 0x0F0F0F0Fu);
  const uint32_t b = sext_nibbles((lo >> 4) & 0x0F0F0F0Fu);
  const uint32_t c = sext_nibbles(hi & 0x0F0F0F0Fu);
  const uint32_t d = sext_nibbles((hi >> 4) & 0x0F0F0F0Fu);
  // 4x4 byte transpose: wc[j] = [a_j, b_j, c_j, d_j], the 4 K codes of column j
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  wc[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  wc[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  wc[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  wc[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

template <>
__device__ __forceinline__ void quad_codes<true>(uint32_t lo, uint32_t hi, uint32_t wc[4]) {
  const uint32_t v0 = sext_nibbles(lo & 0x0F0F0F0Fu);         // first kept code per column
  const uint32_t v1 = sext_nibbles((lo >> 4) & 0x0F0F0F0Fu);  // second
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t m = hi >> (8 * j);
    const uint32_t p0 = 8 * (m & 3u), p1 = 8 * ((m >> 2) & 3u);
    // one nonzero byte each: their sum has no carry between two slots, and
    // where both slots are one (a hand-made meta) the carry out of it is
    // masked off, so this is the per-byte add
    wc[j] = ((((v0 >> (8 * j)) & 0xFFu) << p0) + (((v1 >> (8 * j)) & 0xFFu) << p1)) &
            ((0xFFu << p0) | (0xFFu << p1));
  }
}

// The 2:4 expansion of the expert axis (B4e) by byte permutes: a 16-entry
// table in shared memory maps a meta nibble (p0 | p1 << 2) to the selector
// of __byte_perm(x, 0, sel) that puts byte 0 of x (the first kept code) at
// p0, byte 1 (the second) at p1 and zeros elsewhere; an entry with p0 ==
// p1, which a hand-made meta may hold, is flagged (bit 31), and a quad with
// such a column takes quad_codes<true>, whose masked add sums the two codes
// as the reference's unpack_sparse24 does.
constexpr uint32_t kEqualPositions = 0x80000000u;

__host__ __device__ constexpr uint32_t sel_entry(uint32_t m) {
  return (m & 3u) == (m >> 2) ? kEqualPositions
                              : 0x4444u ^ (4u << (4 * (m & 3u))) ^ (5u << (4 * (m >> 2)));
}

__device__ __forceinline__ void quad_codes_lut(uint32_t lo, uint32_t hi, const uint32_t* lut,
                                               uint32_t wc[4]) {
  uint32_t sel[4], flags = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sel[j] = lut[(hi >> (8 * j)) & 0xFu];
    flags |= sel[j];
  }
  if (flags & kEqualPositions) {
    quad_codes<true>(lo, hi, wc);
    return;
  }
  const uint32_t v0 = sext_nibbles(lo & 0x0F0F0F0Fu);
  const uint32_t v1 = sext_nibbles((lo >> 4) & 0x0F0F0F0Fu);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wc[j] = __byte_perm(__byte_perm(v0, v1, j | ((4 + j) << 4)), 0u, sel[j]);
}

// cp.async of CP bytes (4 or 16) into shared memory, zero-filled when
// `bytes` is 0 (rows past M, columns past N, K past the chunk).
template <int CP>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CP == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  }
}

// Four 8 x 8 matrices of 16-bit elements (here 8 rows x 16 int8 codes
// each) from shared memory into the A fragment of mma.m16n8k32.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a x b on the int8 tensor cores: a 16x32 (row) by 32x8 (col) product
// with int32 accumulation, unsigned or signed A codes, signed B codes.
template <bool ASigned>
__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (ASigned) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ float epilogue(int s, int n, const float* sw, const float* corr) {
  return __fmul_rn(__fsub_rn(__int2float_rn(s), corr[n]), sw[n]);
}

// Four adjacent outputs at `off` from their exact sums; sw and corr are
// indexed from n (the tile's staged vectors, from the column in the tile).
__device__ __forceinline__ void store4(float* out, size_t off, int4 s, int n, const float* sw,
                                       const float* corr) {
  *reinterpret_cast<float4*>(out + off) =
      make_float4(epilogue(s.x, n, sw, corr), epilogue(s.y, n + 1, sw, corr),
                  epilogue(s.z, n + 2, sw, corr), epilogue(s.w, n + 3, sw, corr));
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t off, int4 s, int n,
                                       const float* sw, const float* corr) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(epilogue(s.x, n, sw, corr));
  lo.y = __float2bfloat16_rn(epilogue(s.y, n + 1, sw, corr));
  hi.x = __float2bfloat16_rn(epilogue(s.z, n + 2, sw, corr));
  hi.y = __float2bfloat16_rn(epilogue(s.w, n + 3, sw, corr));
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + off) = v;
}

// A ragged N (N % 4 != 0, kernel B1/B4 with CP = 1): the first `live`
// (< 4) outputs of a 4-column vector, each on its own (a row of the output
// starts at any element, so no vector store is aligned).
template <typename OutT>
__device__ __forceinline__ void store_ragged(OutT* out, size_t off, int4 s, int n, int live,
                                             const float* sw, const float* corr) {
  const int v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < live) {
      const float f = epilogue(v[i], n + i, sw, corr);
      if constexpr (sizeof(OutT) == 2) {
        out[off + i] = __float2bfloat16_rn(f);
      } else {
        out[off + i] = f;
      }
    }
  }
}

// One 4-column vector of outputs at column n0 + col of row `row_off`:
// whole where N % 4 == 0 (a vector is wholly in or out), cut at N where
// the kernel runs ragged.
template <bool Ragged, typename OutT>
__device__ __forceinline__ void store_cols(OutT* out, size_t row_off, int4 s, int n0, int col,
                                           int N, const float* sw, const float* corr) {
  if constexpr (Ragged) {
    const int live = min(4, N - (n0 + col));
    if (live > 0) store_ragged(out, row_off + n0 + col, s, col, live, sw, corr);
  } else {
    if (n0 + col < N) store4(out, row_off + n0 + col, s, col, sw, corr);
  }
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

constexpr int kMaxClusterChunks = 8;  // K chunks of a tile: one portable cluster

struct Problem {
  const uint8_t* x;
  const int8_t* w;
  const uint8_t* meta;
  const float* sw;
  const float* corr;
  void* out;
  int M, N, K;
  int ck;  // K rows per chunk (blockIdx.z)
};

// The tile's epilogue vectors sw and corr (BN each, 0 past N) on their way
// into shared memory (cp.async, in the caller's commit group), for the
// block's share of the epilogue.
template <int BN, int THREADS>
__device__ __forceinline__ void stage_epilogue(float* sw_s, float* corr_s, int n0,
                                               const Problem& p) {
  for (int j = threadIdx.x; j < 2 * BN; j += THREADS) {
    const int n = n0 + j % BN;
    const float* src = j < BN ? p.sw : p.corr;
    cp_async<4>((j < BN ? sw_s : corr_s) + j % BN, n < p.N ? src + n : src, n < p.N ? 4 : 0);
  }
}

// ---------------------------------------------------------------------------
// The kernel: int8 tensor cores (mma.sync m16n8k32)
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kBM = 64, kBK = 128;
constexpr int kQuads = kBK / 4;     // quads (groups of 4 K rows) a stage
constexpr int kAStride = kBK + 16;  // bytes; A fragment reads hit 32 distinct banks
constexpr int kBRows = 2 * kQuads;  // dense: packed rows; 2:4: packed rows, then meta rows

// 64 x 64 output tiles, 2 x 2 warps of 32 x 32, a 4-stage ring
constexpr int kWarpsN = 2, kWarpsM = kThreads / 32 / kWarpsN;
constexpr int kBN = 32 * kWarpsN, kStages = 4;
constexpr int kWarpRows = kBM / kWarpsM, kMTiles = kWarpRows / 16;

// B rows' pitch in bytes: the dense reads hit 32 distinct banks; the 2:4
// reads conflict two ways, which costs less than the pitch that avoids it
// (96 bytes: 78 KB a block, two blocks an SM instead of three at prefill)
constexpr int kBStride = kBN + 16;
constexpr int kStageBytes = kBM * kAStride + kBRows * kBStride;
constexpr int kRingBytes = kStages * kStageBytes;

// Shared memory: the ring, the tile's sw and corr, then (with a K split)
// the receive buffer, a share of the live rows' 4-column vectors from each
// chunk; apart from the ring, as another chunk may write into it while
// this block still reads its ring.
int smem_bytes(int m, int chunks) {
  const int rx = chunks > 1 ? ((m < kBM ? m : kBM) * (kBN / 4) + chunks) * 16 : 0;
  return kRingBytes + 2 * kBN * 4 + rx;
}

// CP is the load width in bytes: 16 or 4 (cp.async of x and the weights,
// N % 4 == 0), or 1, the ragged kernel for any N: a weight row of N bytes
// then starts at any byte, so each block copies its panel byte by byte
// with plain loads and stores (ordered for the ring's readers by the main
// loop's barrier), x still by 4-byte cp.async (K % 4 == 0), and stores
// every output on its own, cut at N.
//
// Experts: the grid's rows walk E problems of (M, N, K) laid out one
// after the other (x (E, M, K), w and meta (E, K/2 or K/4, N), sw and corr
// (E, N), out (E, M, N)); expert e owns grid rows [e * row_tiles,
// (e + 1) * row_tiles), and a block moves its pointers to its expert's
// problem before anything else. Without it the grid is one problem.
template <int CP, bool ASigned, bool Sparse, bool Experts, typename OutT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(Problem prob) {
  constexpr int A_BYTES = kBM * kAStride;
  extern __shared__ __align__(16) unsigned char smem[];

  Problem p = prob;
  int row_tile = blockIdx.y;
  const uint32_t* lut = nullptr;  // B4e's 2:4 selectors (read after the first barrier)
  if constexpr (Experts && Sparse) {
    __shared__ uint32_t lut_s[16];
    if (threadIdx.x < 16) lut_s[threadIdx.x] = sel_entry(threadIdx.x);
    lut = lut_s;
  }
  if constexpr (Experts) {
    const int row_tiles = (p.M + kBM - 1) / kBM;
    const int e = blockIdx.y / row_tiles;
    row_tile = blockIdx.y - e * row_tiles;
    const size_t w_elems = (size_t)(Sparse ? p.K / 4 : p.K / 2) * p.N;
    p.x += (size_t)e * p.M * p.K;
    p.w += e * w_elems;
    if constexpr (Sparse) p.meta += e * w_elems;
    p.sw += (size_t)e * p.N;
    p.corr += (size_t)e * p.N;
    p.out = static_cast<OutT*>(p.out) + (size_t)e * p.M * p.N;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = row_tile * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * p.ck;
  const int k_end = min(p.K, k_begin + p.ck);
  const int nkt = (k_end - k_begin + kBK - 1) / kBK;

  // one stage: the (kBM, kBK) x tile and its packed weight rows; K is a
  // multiple of CP for this load width, so a copy is wholly in or out
  constexpr bool Ragged = CP == 1;
  constexpr int XCP = Ragged ? 4 : CP;
  auto load_stage = [&](int kt, int slot) {
    unsigned char* sa = smem + slot * kStageBytes;
    unsigned char* sb = sa + A_BYTES;
    const int kb = k_begin + kt * kBK;
    for (int idx = tid; idx < kBM * kBK / XCP; idx += kThreads) {
      const int r = idx / (kBK / XCP), col = (idx % (kBK / XCP)) * XCP;
      const int m = m0 + r, k = kb + col;
      const bool ok = m < p.M && k < k_end;
      cp_async<XCP>(sa + r * kAStride + col, ok ? p.x + (size_t)m * p.K + k : p.x,
                    ok ? XCP : 0);
    }
    if constexpr (Ragged) {  // byte by byte, zero past N and past the chunk
      for (int idx = tid; idx < kBRows * kBN; idx += kThreads) {
        const int r = idx / kBN, col = idx % kBN;
        const int n = n0 + col;
        const int8_t* src;
        bool ok;
        if constexpr (Sparse) {
          const int pr = kb / 4 + r % kQuads;
          ok = 4 * pr < k_end && n < p.N;
          src = (r < kQuads ? p.w : reinterpret_cast<const int8_t*>(p.meta)) +
                (size_t)pr * p.N + n;
        } else {
          const int pr = kb / 2 + r;
          ok = 2 * pr < k_end && n < p.N;
          src = p.w + (size_t)pr * p.N + n;
        }
        sb[r * kBStride + col] = ok ? static_cast<unsigned char>(__ldg(src)) : 0;
      }
      return;
    }
    for (int idx = tid; idx < kBRows * kBN / CP; idx += kThreads) {
      const int r = idx / (kBN / CP), col = (idx % (kBN / CP)) * CP;
      const int n = n0 + col;
      const int8_t* src;
      bool ok;
      if constexpr (Sparse) {
        const int pr = kb / 4 + r % kQuads;
        ok = 4 * pr < k_end && n < p.N;
        src = (r < kQuads ? p.w : reinterpret_cast<const int8_t*>(p.meta)) + (size_t)pr * p.N + n;
      } else {
        const int pr = kb / 2 + r;
        ok = 2 * pr < k_end && n < p.N;
        src = p.w + (size_t)pr * p.N + n;
      }
      cp_async<CP>(sb + r * kBStride + col, ok ? src : p.w, ok ? CP : 0);
    }
  };

  float* sw_s = reinterpret_cast<float*>(smem + kRingBytes);
  float* corr_s = sw_s + kBN;

  int acc[kMTiles][4][4];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

  stage_epilogue<kBN, kThreads>(sw_s, corr_s, n0, p);  // in group 0
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* sa = smem + (kt % kStages) * kStageBytes;
    const unsigned char* sb = sa + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      // B: lane (g, t) holds K rows 32 ks + 4t .. +3 (b[j][0]) and 16 more
      // (b[j][1]) of column 32 wn + 4g + j, for n8 tile j
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ql = 8 * ks + t + 4 * h;  // quad within the stage
        const int col = 32 * wn + 4 * g;
        uint32_t wc[4];
        if constexpr (Sparse && Experts) {
          quad_codes_lut(*reinterpret_cast<const uint32_t*>(sb + ql * kBStride + col),
                         *reinterpret_cast<const uint32_t*>(sb + (kQuads + ql) * kBStride + col),
                         lut, wc);
        } else if constexpr (Sparse) {
          quad_codes<true>(*reinterpret_cast<const uint32_t*>(sb + ql * kBStride + col),
                           *reinterpret_cast<const uint32_t*>(sb + (kQuads + ql) * kBStride + col),
                           wc);
        } else {
          quad_codes<false>(*reinterpret_cast<const uint32_t*>(sb + (2 * ql) * kBStride + col),
                            *reinterpret_cast<const uint32_t*>(sb + (2 * ql + 1) * kBStride + col),
                            wc);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][h] = wc[j];
      }
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        // A: lane (g, t) gets rows g and g + 8 of the m16 tile, bytes 4t .. +3
        // and 16 more, as four 8 x 16-byte matrices; lane l addresses row
        // l % 8 (+ 8 for matrices 1 and 3) at byte 16 (l / 16)
        uint32_t a[4];
        ldmatrix_x4(a, sa + (kWarpRows * wm + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                               kAStride + 32 * ks + 16 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16832<ASigned>(acc[mi][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // The split's sum, inside the launch. The chunks of a tile are one thread
  // block cluster (cluster dims (1, 1, chunks): a block's rank is its
  // chunk), and rank q owns the q-th share of the tile's 4-column vectors
  // in its live rows (those below M). Each block sends every vector of its
  // tile to its owner, into slot `rank` of the owner's receive buffer
  // (distributed shared memory); after one cluster barrier each rank sums
  // its slots and runs its share's epilogue. No global workspace, no
  // atomics, no read of another block's memory after the barrier, nothing
  // left behind for the next launch. A lane's accumulators (row g (+8),
  // column 2t + e) of n8 tiles j = 0..3 are tile columns 32 wn + 4 (2t + e)
  // + j: one whole vector.
  const int chunks = gridDim.z, rank = blockIdx.z;
  const int live_rows = min(kBM, p.M - m0);
  OutT* out = static_cast<OutT*>(p.out);
  if (chunks == 1) {  // no split: each lane's vectors straight to the output
    __syncthreads();  // sw and corr, staged by every thread
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = kWarpRows * wm + 16 * mi + g + 8 * h, col = 32 * wn + 4 * (2 * t + e);
          if (row < live_rows)
            store_cols<Ragged>(out, (size_t)(m0 + row) * p.N,
                               make_int4(acc[mi][0][2 * h + e], acc[mi][1][2 * h + e],
                                         acc[mi][2][2 * h + e], acc[mi][3][2 * h + e]),
                               n0, col, p.N, sw_s, corr_s);
        }
    return;
  }
  const int live = live_rows * (kBN / 4);
  const int share = (live + chunks - 1) / chunks;
  int4* rx = reinterpret_cast<int4*>(smem + kRingBytes + 2 * kBN * 4);
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = kWarpRows * wm + 16 * mi + g + 8 * h;
        if (row < live_rows) {
          const int v = row * (kBN / 4) + 8 * wn + 2 * t + e, q = v / share;
          const int4 val = make_int4(acc[mi][0][2 * h + e], acc[mi][1][2 * h + e],
                                     acc[mi][2][2 * h + e], acc[mi][3][2 * h + e]);
          int4* dst = rx + rank * share + (v - q * share);
          if (q == rank) {
            *dst = val;
          } else {
            *cluster.map_shared_rank(dst, q) = val;
          }
        }
      }
  cluster.sync();  // every chunk's vectors are in their owners' buffers
  for (int u = tid; u < share && rank * share + u < live; u += kThreads) {
    const int v = rank * share + u;
    const int i = v / (kBN / 4), col = 4 * (v % (kBN / 4));
    int4 sum = rx[u];
    for (int r = 1; r < chunks; ++r) sum = add4(sum, rx[r * share + u]);
    store_cols<Ragged>(out, (size_t)(m0 + i) * p.N, sum, n0, col, p.N, sw_s, corr_s);
  }
}

// ---------------------------------------------------------------------------
// The expert axis's decode tier (B1e, B4e at M <= 80 rows an expert)
// ---------------------------------------------------------------------------
// The product runs transposed: the weights' output columns are the A
// operand of mma.m16n8k32 (16 columns an m16 tile) and the expert's tokens
// the B operand (8 a n8 tile), so at M = 4 four of eight token lanes are
// dead instead of 60 of 64 rows. A block owns 128 columns of one expert
// and a K chunk, and streams the chunk through a ring of `ring` stages of
// 128 K rows in shared memory: 64 weight rows of 128 bytes (each copy
// instruction of a warp moves four whole rows) and only the live rows of
// x (weight copies ask the L2 for 256 bytes, the neighbouring column
// tile's row too). Warp w computes the 32 columns 32w .. 32w+31 over the
// whole chunk: lane (g, t) unpacks one quad of columns 32w + 4g .. +3
// (quad_codes) for K quads t and t + 4 of a k32 step; words 0, 1 are the A
// registers of m16 tile 0 (rows g and g + 8 = columns 4g and 4g + 1 of the
// warp's 32), words 2, 3 those of tile 1 (columns 4g + 2, 4g + 3), so a
// lane's accumulators for token 2t + e are one 4-column vector. Without a
// K split each lane stores its vectors. With one, the chunks of a column
// tile are one thread block cluster: every block puts each of its live
// vectors into slot `rank` of the owning rank's receive buffer
// (distributed shared memory), and after one cluster barrier the owner
// sums its slots and runs the epilogue. NT is the most token tiles of 8 an
// instance takes: 2 (up to 16 tokens), whose receive buffer lies past the
// ring, so a block sends as soon as it is done; or 10 (up to 80), whose
// buffer takes the ring's place after a first cluster barrier (past the
// ring it would cost the wide width's third block an SM). Past the ring is
// 0.3 us a site faster at M = 1, (1536, 512) than in its place
// (scripts/torch_expert_tiers.py, both builds in one call on an NVIDIA
// H100 80GB HBM3 at 700.00 W: 16.45 / 16.51 against 16.77 / 16.80 us).
constexpr int kDecCols = 128;
constexpr int kDecStageK = 128;
constexpr int kDecXPitch = kDecStageK + 16;  // x rows: the B fragment reads hit 32 banks
constexpr int kDecMaxRing = 2;               // DECODE_RING in kernels/w4a8_mm.py
constexpr int kDecMaxTokens = 80;

// A stage: 64 weight rows of 128 bytes, then 8 NT rows of x.
__host__ __device__ constexpr int dec_stage_bytes(int nt) {
  return 64 * kDecCols + nt * 8 * kDecXPitch;
}

// The receive buffer of a K split: chunks slots of the share of live
// vectors a rank owns.
__host__ __device__ inline int dec_rx_bytes(int m, int chunks) {
  return chunks > 1 ? chunks * ((m * (kDecCols / 4) + chunks - 1) / chunks) * 16 : 0;
}

// The ring and the receive buffer: past the ring for NT = 2, in its place
// for NT = 10; sw and corr follow.
__host__ __device__ inline int dec_region_bytes(int nt, int ring, int m, int chunks) {
  const int rings = ring * dec_stage_bytes(nt), rx = dec_rx_bytes(m, chunks);
  return nt <= 2 ? rings + rx : (rings > rx ? rings : rx);
}

int dec_smem_bytes(int nt, int ring, int m, int chunks) {
  return dec_region_bytes(nt, ring, m, chunks) + 2 * kDecCols * 4;
}

// The most any launch of a width asks for: the deepest ring, 80 tokens,
// and the largest receive buffer of any cluster size (a share is rounded
// up, so 3 chunks need more than 8)
int dec_smem_limit(int nt) {
  int most = 0;
  for (int chunks = 1; chunks <= kMaxClusterChunks; ++chunks) {
    const int b = dec_smem_bytes(nt, kDecMaxRing, kDecMaxTokens, chunks);
    most = b > most ? b : most;
  }
  return most;
}

// d += a x b with the weights as A (signed) and the codes as B
template <bool XSigned>
__device__ __forceinline__ void mma_wx(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (XSigned) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// cp.async.wait_group with a count known only at run time (the ring's
// depth less one, below kDecMaxRing)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n == 0) {
    cp_async_wait<0>();
  } else {
    cp_async_wait<1>();
  }
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Where a stage keeps its weight rows (128 bytes each). Dense: the 16
// packed rows of a k32 step in the order 0 2 4 6 1 3 5 7 8 10 .. 15, so
// the rows 2t (+ 8) and 2t + 1 that lanes t = 0..3 read together have slot
// % 4 == t (2:4: quad rows, then meta rows, in order: slot % 4 == t
// already). Within a row, 16-byte chunk j sits at chunk j ^ 2 (slot % 4),
// so the four rows read together fill 32 distinct banks.
__device__ __forceinline__ int dec_slot(int r) {
  const int r16 = r & 15;
  return (r & ~15) + 8 * (r16 >> 3) + 4 * (r16 & 1) + ((r16 & 7) >> 1);
}

__device__ __forceinline__ int dec_swizzle(int slot, int byte) {
  return slot * kDecCols + ((((byte >> 4) ^ ((slot & 3) << 1))) << 4) + (byte & 15);
}

// cp.async of CP bytes with a 256-byte L2 prefetch (16-byte copies)
template <int CP>
__device__ __forceinline__ void cp_async_pf(void* dst, const void* src, int bytes) {
  if constexpr (CP == 16) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    cp_async<CP>(dst, src, bytes);
  }
}

template <int CP, bool XSigned, bool Sparse, int NT, typename OutT>
__global__ void __launch_bounds__(kThreads)
w4a8_expert_decode_kernel(Problem prob, int ring) {
  constexpr int STAGE = dec_stage_bytes(NT);
  constexpr bool RX_APART = NT <= 2;  // the receive buffer past the ring
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t lut[16];  // B4e's 2:4 selectors

  Problem p = prob;
  const int e = blockIdx.y;
  {
    const size_t w_elems = (size_t)(Sparse ? p.K / 4 : p.K / 2) * p.N;
    p.x += (size_t)e * p.M * p.K;
    p.w += e * w_elems;
    if constexpr (Sparse) p.meta += e * w_elems;
    p.sw += (size_t)e * p.N;
    p.corr += (size_t)e * p.N;
    p.out = static_cast<OutT*>(p.out) + (size_t)e * p.M * p.N;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDecCols;
  const int chunks = gridDim.z, rank = blockIdx.z;
  const int k_begin = min(p.K, rank * p.ck);
  const int k_end = min(p.K, k_begin + p.ck);
  const int steps = (k_end - k_begin + 31) / 32;
  const int stages = (steps + 3) / 4;
  const int nt = (p.M + 7) / 8;  // live token tiles, <= NT
  float* sw_s = reinterpret_cast<float*>(smem + dec_region_bytes(NT, ring, p.M, chunks));
  float* corr_s = sw_s + kDecCols;

  // One stage: 128 K rows of the block's 128 columns (64 rows of 128
  // bytes: dense packed rows at dec_slot; 2:4 the 32 packed rows, then
  // their 32 meta rows), each swizzled, zero past K and N; then the live
  // rows of x.
  auto load_stage = [&](int s, unsigned char* dst) {
    const int kb = k_begin + s * kDecStageK;
    for (int idx = tid; idx < 64 * (kDecCols / CP); idx += kThreads) {
      const int r = idx / (kDecCols / CP), c = (idx % (kDecCols / CP)) * CP;
      const int n = n0 + c;
      const int8_t* src;
      bool ok;
      int slot;
      if constexpr (Sparse) {
        const int pr = kb / 4 + (r & 31);
        ok = 4 * pr < k_end && n < p.N;
        src = (r < 32 ? p.w : reinterpret_cast<const int8_t*>(p.meta)) + (size_t)pr * p.N + n;
        slot = r;
      } else {
        const int pr = kb / 2 + r;
        ok = 2 * pr < k_end && n < p.N;
        src = p.w + (size_t)pr * p.N + n;
        slot = dec_slot(r);
      }
      cp_async_pf<CP>(dst + dec_swizzle(slot, c), ok ? src : p.w, ok ? CP : 0);
    }
    unsigned char* sx = dst + 64 * kDecCols;
    const int kn = min(kDecStageK, k_end - kb);  // a multiple of 4 (K % 4 == 0)
    for (int idx = tid; idx < p.M * (kDecStageK / CP); idx += kThreads) {
      const int m = idx / (kDecStageK / CP), c = (idx % (kDecStageK / CP)) * CP;
      if (c < kn) cp_async<CP>(sx + m * kDecXPitch + c, p.x + (size_t)m * p.K + kb + c, CP);
    }
  };

  // a split's blocks send into each other's buffers only once all have
  // started: arrive now, wait before sending
  if (RX_APART && chunks > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  stage_epilogue<kDecCols, kThreads>(sw_s, corr_s, n0, p);  // in group 0
#pragma unroll 1
  for (int s = 0; s < ring; ++s) {
    if (s < stages) load_stage(s, smem + s * STAGE);
    cp_async_commit();
  }
  if constexpr (Sparse) {
    if (tid < 16) lut[tid] = sel_entry(tid);  // read after the first barrier
  }

  // lane (g, t)'s word of the warp's 32 columns in a row whose slot % 4 == t
  const int colw = (((2 * warp + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  int slot = 0;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    cp_async_wait_upto(ring - 1);  // stage s landed (ring + s groups committed)
    __syncthreads();
    const unsigned char* sw_ = smem + slot * STAGE;
    const unsigned char* sx = sw_ + 64 * kDecCols;
    const int ns = min(4, steps - 4 * s);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < ns) {
        // A: quads t (w0) and t + 4 (w1) of the warp's columns 4g .. 4g+3
        uint32_t w0[4], w1[4];
        if constexpr (Sparse) {
          const unsigned char* q = sw_ + (8 * ks + t) * kDecCols + colw;
          quad_codes_lut(lds32(q), lds32(q + 32 * kDecCols), lut, w0);
          quad_codes_lut(lds32(q + 4 * kDecCols), lds32(q + 36 * kDecCols), lut, w1);
        } else {
          const unsigned char* q = sw_ + (16 * ks + t) * kDecCols + colw;
          quad_codes<false>(lds32(q), lds32(q + 4 * kDecCols), w0);
          quad_codes<false>(lds32(q + 8 * kDecCols), lds32(q + 12 * kDecCols), w1);
        }
        const uint32_t a0[4] = {w0[0], w0[1], w1[0], w1[1]};
        const uint32_t a1[4] = {w0[2], w0[3], w1[2], w1[3]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            // B: token 8j + g's codes at bytes 4t and 4t + 16 of the step
            const int m = 8 * j + g;
            uint32_t b0 = 0, b1 = 0;
            if (m < p.M) {
              const unsigned char* xr = sx + m * kDecXPitch + 32 * ks + 4 * t;
              b0 = lds32(xr);
              b1 = lds32(xr + 16);
            }
            mma_wx<XSigned>(acc[0][j], a0, b0, b1);
            mma_wx<XSigned>(acc[1][j], a1, b0, b1);
          }
        }
      }
    }
    if (s + ring < stages) {
      __syncthreads();  // every warp is done with the slot
      load_stage(s + ring, smem + slot * STAGE);
    }
    cp_async_commit();
    slot = slot + 1 == ring ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // Vector v = token * 32 + 8w + g holds columns 32w + 4g .. +3.
  OutT* out = static_cast<OutT*>(p.out);
  const int col = 32 * warp + 4 * g;
  if (chunks == 1) {  // no split: each lane's vectors straight to the output
    __syncthreads();  // sw and corr, staged by every thread
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * j + 2 * t + h;
        if (j < nt && m < p.M && n0 + col < p.N)  // N % 4 == 0: wholly in or out
          store4(out, (size_t)m * p.N + n0 + col,
                 make_int4(acc[0][j][h], acc[0][j][2 + h], acc[1][j][h], acc[1][j][2 + h]),
                 col, sw_s, corr_s);
      }
    return;
  }
  // The split's sum: rank q owns vectors [q * share, (q + 1) * share).
  const int live = p.M * (kDecCols / 4);
  const int share = (live + chunks - 1) / chunks;
  int4* rx = reinterpret_cast<int4*>(smem + (RX_APART ? ring * STAGE : 0));
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (RX_APART) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block has started
  } else {
    cluster.sync();  // every block of the cluster is done with its ring
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * j + 2 * t + h;
      if (j < nt && m < p.M) {
        const int v = m * (kDecCols / 4) + 8 * warp + g, q = v / share;
        const int4 val = make_int4(acc[0][j][h], acc[0][j][2 + h], acc[1][j][h],
                                   acc[1][j][2 + h]);
        int4* dst = rx + rank * share + (v - q * share);
        if (q == rank) {
          *dst = val;
        } else {
          *cluster.map_shared_rank(dst, q) = val;
        }
      }
    }
  cluster.sync();  // every chunk's vectors are in their owners' buffers
  for (int u = tid; u < share && rank * share + u < live; u += kThreads) {
    const int v = rank * share + u;
    const int m = v / (kDecCols / 4), c = 4 * (v % (kDecCols / 4));
    int4 sum = rx[u];
    for (int r = 1; r < chunks; ++r) sum = add4(sum, rx[r * share + u]);
    if (n0 + c < p.N)
      store4(out, (size_t)m * p.N + n0 + c, sum, c, sw_s, corr_s);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
// One launch; with a K split, the chunks of a tile form a cluster.
template <typename... Args>
int launch(void (*kernel)(Args...), dim3 grid, int threads, int smem, cudaStream_t s,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <bool ASigned, bool Sparse, bool Experts, typename OutT>
int launch_typed(const Problem& p, int vec, dim3 grid, cudaStream_t s) {
  auto kernel = vec == 16  ? w4a8_kernel<16, ASigned, Sparse, Experts, OutT>
                : vec == 4 ? w4a8_kernel<4, ASigned, Sparse, Experts, OutT>
                           : w4a8_kernel<1, ASigned, Sparse, Experts, OutT>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes(kBM, kMaxClusterChunks));
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(kernel, grid, kThreads, smem_bytes(p.M, grid.z), s, p);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

bool aligned16(const void* ptr) { return ptr == nullptr || (uintptr_t)ptr % 16 == 0; }

// The plan's ints, checked against the shape before anything launches.
bool plan_ok(const Problem& p, int experts, int vec, dim3 grid) {
  if (experts < 1) return false;
  if (p.M < 1 || p.N < 1 || p.K < 0 || p.K % 4 || p.ck < kBK || p.ck % kBK) return false;
  if (vec != 1 && vec != 4 && vec != 16) return false;
  if (vec != 1 && p.N % 4) return false;  // a ragged N takes the byte loader
  if (vec == 16 && (p.N % 16 || p.K % 16 || !aligned16(p.x) || !aligned16(p.w) ||
                    !aligned16(p.meta)))
    return false;
  return (int)grid.x == cdiv(p.N, kBN) && (long)grid.y == (long)experts * cdiv(p.M, kBM) &&
         (int)grid.z == (p.K ? cdiv(p.K, p.ck) : 1) && (int)grid.z <= kMaxClusterChunks;
}

template <bool Experts>
int launch_any(const Problem& p, int experts, int a_signed, int out_bf16, int sparse, int vec,
               int gx, int gy, int gz, void* stream) {
  const dim3 grid(gx, gy, gz);
  if (!plan_ok(p, experts, vec, grid) || (!Experts && experts != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define W4A8_TYPED(AS, SP)                                                           \
  return out_bf16 ? launch_typed<AS, SP, Experts, __nv_bfloat16>(p, vec, grid, s)    \
                  : launch_typed<AS, SP, Experts, float>(p, vec, grid, s)
  if (sparse) {
    if (a_signed) W4A8_TYPED(true, true);
    W4A8_TYPED(false, true);
  }
  if (a_signed) W4A8_TYPED(true, false);
  W4A8_TYPED(false, false);
#undef W4A8_TYPED
}

// The decode tier's launch: the dynamic shared-memory limit
// (dec_smem_limit) is set once per template instance, before its first
// launch.
template <int CP, bool XSigned, bool Sparse, int NT, typename OutT>
int launch_decode_typed(const Problem& p, int ring, dim3 grid, cudaStream_t s) {
  auto kernel = w4a8_expert_decode_kernel<CP, XSigned, Sparse, NT, OutT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dec_smem_limit(NT));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch(kernel, grid, kThreads, dec_smem_bytes(NT, ring, p.M, grid.z), s, p, ring);
}

template <int CP, bool XSigned, bool Sparse>
int launch_decode_nt(const Problem& p, int out_bf16, int ring, dim3 grid, cudaStream_t s) {
#define W4A8_DEC(NT)                                                                     \
  return out_bf16 ? launch_decode_typed<CP, XSigned, Sparse, NT, __nv_bfloat16>(p, ring, grid, s) \
                  : launch_decode_typed<CP, XSigned, Sparse, NT, float>(p, ring, grid, s)
  if (p.M > 16) W4A8_DEC(10);
  W4A8_DEC(2);
#undef W4A8_DEC
}

// The decode tier's plan (load width, K rows a chunk, ring depth, grid:
// 32-column tiles, experts, at most 8 chunks), checked against the shape.
bool dec_plan_ok(const Problem& p, int experts, int vec, int ring, dim3 grid) {
  if (experts < 1 || p.M < 1 || p.M > kDecMaxTokens || ring < 1 || ring > kDecMaxRing)
    return false;
  if (p.N < 4 || p.N % 4 || p.K < 0 || p.K % 4 || p.ck < kDecStageK || p.ck % kDecStageK)
    return false;
  if (vec != 4 && vec != 16) return false;
  if (vec == 16 && (p.N % 16 || p.K % 16 || !aligned16(p.x) || !aligned16(p.w) ||
                    !aligned16(p.meta)))
    return false;
  return (int)grid.x == cdiv(p.N, kDecCols) && (int)grid.y == experts &&
         (int)grid.z == (p.K ? cdiv(p.K, p.ck) : 1) && (int)grid.z <= kMaxClusterChunks;
}

int launch_decode(const Problem& p, int experts, int a_signed, int out_bf16, int sparse, int vec,
                  int ring, int gx, int gy, int gz, void* stream) {
  const dim3 grid(gx, gy, gz);
  if (!dec_plan_ok(p, experts, vec, ring, grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define W4A8_DEC(CP, XS, SP) return launch_decode_nt<CP, XS, SP>(p, out_bf16, ring, grid, s)
  if (vec == 16) {
    if (sparse) {
      if (a_signed) W4A8_DEC(16, true, true);
      W4A8_DEC(16, false, true);
    }
    if (a_signed) W4A8_DEC(16, true, false);
    W4A8_DEC(16, false, false);
  }
  if (sparse) {
    if (a_signed) W4A8_DEC(4, true, true);
    W4A8_DEC(4, false, true);
  }
  if (a_signed) W4A8_DEC(4, true, false);
  W4A8_DEC(4, false, false);
#undef W4A8_DEC
}

}  // namespace

// C entry points, bound with ctypes. The plan (load width 1, 4 or 16
// bytes, K rows a chunk, the grid: column tiles, row tiles, at most 8
// chunks) comes from kernels/w4a8_mm.py's w4a8_plan and is checked here
// against the shape. Requires K % 4 == 0 and 4-byte aligned x; a load
// width of 4 or 16 also N % 4 == 0 and 4-byte aligned w and meta (the
// ragged width 1 takes any N). Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int w4a8_matmul_launch(const void* x, const void* w, const void* sw,
                                  const void* corr, void* out, int M, int N, int K,
                                  int a_signed, int out_bf16, int vec, int ck, int gx, int gy,
                                  int gz, void* stream) {
  const Problem p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w), nullptr,
                  static_cast<const float*>(sw), static_cast<const float*>(corr), out, M, N, K,
                  ck};
  return launch_any<false>(p, 1, a_signed, out_bf16, 0, vec, gx, gy, gz, stream);
}

// The 2:4 entry point (kernel B4): w is the (K/4, N) packed codes, meta the
// (K/4, N) positions; the same plan and requirements.
extern "C" int w4a8_sparse_matmul_launch(const void* x, const void* w, const void* meta,
                                         const void* sw, const void* corr, void* out, int M,
                                         int N, int K, int a_signed, int out_bf16, int vec,
                                         int ck, int gx, int gy, int gz, void* stream) {
  const Problem p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
                  static_cast<const uint8_t*>(meta), static_cast<const float*>(sw),
                  static_cast<const float*>(corr), out, M, N, K, ck};
  return launch_any<false>(p, 1, a_signed, out_bf16, 1, vec, gx, gy, gz, stream);
}

// The expert-axis entry points (kernels B1e and B4e): E problems of (M, N,
// K) one after the other in x (E, M, K), w (and meta) (E, K/2 or K/4, N),
// sw and corr (E, N) and out (E, M, N), in one launch; the plan's grid has
// E times the row tiles of one problem. The same requirements as above.
extern "C" int w4a8_expert_matmul_launch(const void* x, const void* w, const void* sw,
                                         const void* corr, void* out, int E, int M, int N,
                                         int K, int a_signed, int out_bf16, int vec, int ck,
                                         int gx, int gy, int gz, void* stream) {
  const Problem p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w), nullptr,
                  static_cast<const float*>(sw), static_cast<const float*>(corr), out, M, N, K,
                  ck};
  return launch_any<true>(p, E, a_signed, out_bf16, 0, vec, gx, gy, gz, stream);
}

extern "C" int w4a8_sparse_expert_matmul_launch(const void* x, const void* w, const void* meta,
                                                const void* sw, const void* corr, void* out,
                                                int E, int M, int N, int K, int a_signed,
                                                int out_bf16, int vec, int ck, int gx, int gy,
                                                int gz, void* stream) {
  const Problem p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
                  static_cast<const uint8_t*>(meta), static_cast<const float*>(sw),
                  static_cast<const float*>(corr), out, M, N, K, ck};
  return launch_any<true>(p, E, a_signed, out_bf16, 1, vec, gx, gy, gz, stream);
}

// The expert axis's decode tier (B1e with meta null, B4e with the (E, K/4,
// N) meta): E problems of M <= 16 rows, one launch; the plan (load width,
// K rows a chunk, ring depth, grid) from w4a8_expert_plan. Requires
// N % 4 == 0 (w4a8_expert_plan sends a ragged N to the tile tier).
extern "C" int w4a8_expert_decode_launch(const void* x, const void* w, const void* meta,
                                         const void* sw, const void* corr, void* out, int E,
                                         int M, int N, int K, int a_signed, int out_bf16,
                                         int vec, int ck, int ring, int gx, int gy, int gz,
                                         void* stream) {
  const Problem p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
                  static_cast<const uint8_t*>(meta), static_cast<const float*>(sw),
                  static_cast<const float*>(corr), out, M, N, K, ck};
  return launch_decode(p, E, a_signed, out_bf16, meta != nullptr, vec, ring, gx, gy, gz,
                       stream);
}
