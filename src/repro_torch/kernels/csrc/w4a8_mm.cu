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
// What bounds it on an H100: at decode (M = batch, a few rows) the packed
// weight stream, K*N/2 bytes per call, read once from HBM: the kernel is
// bandwidth-bound and its design reads each weight byte exactly once per
// M tile with 128-byte coalesced rows. At prefill (M in the hundreds) the
// int8 MACs; this first version runs them as dp4a on the CUDA cores (no
// tensor cores yet: wgmma / mma with in-register nibble unpack is the
// planned next step), so prefill sits well below the int8 tensor-core peak.
//
// Design: one block of 256 threads per (BM rows x 64 columns) output tile.
// Thread (tn, ks) owns 4 adjacent columns and the K quads q = ks, ks + 16,
// ... (split-K over 16 thread rows, so a decode-sized N still spreads its
// weight reads over many warps). Per quad it loads one 32-bit word from
// each of the two packed rows (4 columns x 2 codes each), sign-extends the
// 8 nibbles with per-byte SIMD ops, transposes them into one 4-code word
// per column with byte permutes, and runs one dp4a per (row, column). The
// 16 K slices reduce through shared memory; the epilogue rounds exactly as
// the plain version does: int32 -> f32 (RN), subtract, multiply, each
// rounded on its own (no fused multiply-add), then f32 -> bf16 (RN).
// Integer sums are exact in any order, so the result is bit-equal to the
// plain version for every K split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;              // output columns per block
constexpr int kTN = kBN / 4;         // threads along N, 4 columns each
constexpr int kKS = kThreads / kTN;  // K slices per block

// 4-lane dot product with int32 accumulate: signed x signed, or the
// unsigned-activation x signed-weight form of dp4a.
template <bool ASigned>
__device__ __forceinline__ int dot4(uint32_t a, uint32_t w, int c);

template <>
__device__ __forceinline__ int dot4<true>(uint32_t a, uint32_t w, int c) {
  return __dp4a(static_cast<int>(a), static_cast<int>(w), c);
}

template <>
__device__ __forceinline__ int dot4<false>(uint32_t a, uint32_t w, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(w), "r"(c));
  return d;
}

// Four nibbles, one per byte in [0, 15], to four sign-extended int8 bytes:
// (n ^ 8) - 8 per byte without borrows between bytes.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BM, bool ASigned, typename OutT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sw, const float* __restrict__ corr,
            OutT* __restrict__ out, int M, int N, int K) {
  __shared__ int red[kKS][BM][kBN];
  const int tn = threadIdx.x % kTN;
  const int ks = threadIdx.x / kTN;
  const int n0 = blockIdx.x * kBN + tn * 4;
  const int m0 = blockIdx.y * BM;

  int acc[BM][4];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  if (n0 < N) {  // N % 4 == 0: a column group is wholly in or out
    const int nq = K / 4;
    for (int q = ks; q < nq; q += kKS) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(w + (size_t)(2 * q) * N + n0);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(w + (size_t)(2 * q + 1) * N + n0);
      // codes of rows 4q, 4q+1 (byte row 2q) and 4q+2, 4q+3 (byte row 2q+1),
      // one byte per column
      const uint32_t a = sext_nibbles(w0 & 0x0F0F0F0Fu);
      const uint32_t b = sext_nibbles((w0 >> 4) & 0x0F0F0F0Fu);
      const uint32_t c = sext_nibbles(w1 & 0x0F0F0F0Fu);
      const uint32_t d = sext_nibbles((w1 >> 4) & 0x0F0F0F0Fu);
      // 4x4 byte transpose: wc[j] = [a_j, b_j, c_j, d_j], the 4 K codes of column j
      const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
      const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
      const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
      const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
      const uint32_t wc[4] = {
          __byte_perm(ab_lo, cd_lo, 0x5410), __byte_perm(ab_lo, cd_lo, 0x7632),
          __byte_perm(ab_hi, cd_hi, 0x5410), __byte_perm(ab_hi, cd_hi, 0x7632)};
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const int m = m0 + i;
        const uint32_t xa =
            m < M ? *reinterpret_cast<const uint32_t*>(x + (size_t)m * K + 4 * q) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4<ASigned>(xa, wc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ks][i][tn * 4 + j] = acc[i][j];
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * kBN; idx += kThreads) {
    const int i = idx / kBN;
    const int col = idx % kBN;
    const int m = m0 + i;
    const int n = blockIdx.x * kBN + col;
    if (m < M && n < N) {
      int s = 0;
#pragma unroll
      for (int t = 0; t < kKS; ++t) s += red[t][i][col];
      const float v = __fmul_rn(__fsub_rn(__int2float_rn(s), corr[n]), sw[n]);
      out[(size_t)m * N + n] = from_float<OutT>(v);
    }
  }
}

template <int BM, bool ASigned, typename OutT>
void launch(const void* x, const void* w, const float* sw, const float* corr,
            void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  w4a8_kernel<BM, ASigned, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w), sw, corr,
      static_cast<OutT*>(out), M, N, K);
}

template <int BM>
void dispatch(const void* x, const void* w, const float* sw, const float* corr,
              void* out, int M, int N, int K, int a_signed, int out_bf16,
              cudaStream_t s) {
  if (a_signed) {
    if (out_bf16) launch<BM, true, __nv_bfloat16>(x, w, sw, corr, out, M, N, K, s);
    else launch<BM, true, float>(x, w, sw, corr, out, M, N, K, s);
  } else {
    if (out_bf16) launch<BM, false, __nv_bfloat16>(x, w, sw, corr, out, M, N, K, s);
    else launch<BM, false, float>(x, w, sw, corr, out, M, N, K, s);
  }
}

}  // namespace

// C entry point, bound with ctypes. Requires K % 4 == 0, N % 4 == 0 and
// 4-byte aligned x and w (the Python wrapper checks). Returns the launch's
// cudaError_t (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int w4a8_matmul_launch(const void* x, const void* w, const void* sw,
                                  const void* corr, void* out, int M, int N, int K,
                                  int a_signed, int out_bf16, void* stream) {
  const float* swf = static_cast<const float*>(sw);
  const float* cf = static_cast<const float*>(corr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows per block: small M (decode) keeps every dp4a on a real row
  if (M <= 1) dispatch<1>(x, w, swf, cf, out, M, N, K, a_signed, out_bf16, s);
  else if (M <= 2) dispatch<2>(x, w, swf, cf, out, M, N, K, a_signed, out_bf16, s);
  else if (M <= 4) dispatch<4>(x, w, swf, cf, out, M, N, K, a_signed, out_bf16, s);
  else dispatch<8>(x, w, swf, cf, out, M, N, K, a_signed, out_bf16, s);
  return static_cast<int>(cudaGetLastError());
}
