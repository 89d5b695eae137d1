// Fused RMSNorm + asymmetric 8-bit activation quantizer for Hopper (sm_90a).
// Plain C interface, bound with ctypes by repro_torch/kernels/quant_rmsnorm.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_rmsnorm.py:22
// (`_kernel`, pallas_call at :51, wrapper `quant_rmsnorm` :34). Per row m
// of x (M, D), f32 or bf16:
//
//   ms   = sum_d x[m, d]^2 / D                               (f32)
//   y    = x[m, d] * (1 / sqrt(ms + eps)) * gamma[d]
//   q    = clip(rint(y * inv_scale) + zp, 0, qmax)           -> uint8
//
// with qp = {inv_scale, zp} a device f32 pair formed by the wrapper
// (inv_scale = 1 / act_scale in f32, as the Pallas wrapper forms it; the
// kernel multiplies by it, as the Pallas kernel does).
//
// Bound: bytes. Each row is read once and written once as uint8 (D*4 + D
// or D*2 + D bytes) with a handful of operations per element: far below
// the H100's ridge. Design: one block of 256 threads per row; each thread
// keeps its strided elements of the row in registers between the two
// passes (D <= 256 * kMaxPer), reduces x*x with warp shuffles and one
// shared-memory step, and writes its codes. Every scalar operation is
// rounded on its own (no fused multiply-add) in the plain version's order;
// only the order of the D-long sum differs from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 32;  // elements a thread keeps: D <= 8192

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename InT>
__global__ void __launch_bounds__(kThreads)
quant_rmsnorm_kernel(const InT* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ qp, uint8_t* __restrict__ out, int D,
                     float eps, float qmax) {
  __shared__ float warp_sums[kThreads / 32];
  const InT* xr = x + (size_t)blockIdx.x * D;
  uint8_t* orow = out + (size_t)blockIdx.x * D;

  float v[kMaxPer];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int j = threadIdx.x + i * kThreads;
    v[i] = j < D ? to_float(xr[j]) : 0.f;
    ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, warp_sums[w]);

  const float ms = __fdiv_rn(total, (float)D);
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
  const float inv_scale = qp[0];
  const float zp = qp[1];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < D) {
      const float y = __fmul_rn(__fmul_rn(v[i], r), gamma[j]);
      const float q = __fadd_rn(rintf(__fmul_rn(y, inv_scale)), zp);
      orow[j] = (uint8_t)fminf(fmaxf(q, 0.f), qmax);
    }
  }
}

}  // namespace

// C entry point. x (M, D) f32 (x_bf16 = 0) or bf16, gamma (D,) f32, qp (2,)
// f32 {inv_scale, zp}, out (M, D) uint8; all contiguous. Returns the
// launch's cudaError_t (0 on success); runs asynchronously on `stream`.
extern "C" int quant_rmsnorm_launch(const void* x, const void* gamma, const void* qp,
                                    void* out, int M, int D, int x_bf16, float eps,
                                    float qmax, void* stream) {
  if (M <= 0 || D <= 0 || D > kThreads * kMaxPer) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* p = static_cast<const float*>(qp);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (x_bf16) {
    quant_rmsnorm_kernel<__nv_bfloat16><<<M, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, p, o, D, eps, qmax);
  } else {
    quant_rmsnorm_kernel<float><<<M, kThreads, 0, s>>>(static_cast<const float*>(x), g, p, o,
                                                         D, eps, qmax);
  }
  return (int)cudaGetLastError();
}
