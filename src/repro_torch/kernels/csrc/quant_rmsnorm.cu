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
// inv_scale = 1 / act_scale and zp come either as values formed in f32 by
// the wrapper (a Python number) or as pointers to device scalars (an
// artifact's act_scale / act_zp), for which the kernel forms
// __fdiv_rn(1, act_scale) itself: a call is one launch either way, and a
// captured launch reads the scalars' current values on replay.
//
// Bound: bytes. Each row is read once and written once as uint8 (D*4 + D
// or D*2 + D bytes) with a handful of operations an element. Design:
//
// - A row group of T threads (a power of two, 32..1024) owns a row; thread
//   t holds vectors t, t + T, t + 2T, ... of it, each 16 bytes (float4, or
//   8 bf16 as uint4), or one element where rows are not 16-byte aligned
//   (ragged D, a view at an offset). The wrapper's plan picks T, the slots
//   a thread has and the block from D and the type.
// - quant_rmsnorm_rows: up to 4 vectors (8 elements unaligned) a thread,
//   so a row of up to 16384 f32 or 32768 bf16 elements (8192 unaligned)
//   stays in registers. A block of max(256, T) threads holds several rows
//   where D is small (one row a block from T = 256 up). The grid is at
//   most what the card holds at once; each block walks its row tiles and
//   issues the next tile's loads (a second register set; the loop is
//   unrolled by two so the sets swap without a move) before it reduces the
//   current one. gamma is copied into shared memory once per block.
// - quant_rmsnorm_staged: wider rows, one row a 1024-thread block. The row
//   streams in four vectors a thread at a time and is kept in shared
//   memory (each thread reads back only what it wrote, so no barrier);
//   past 227 KB the rest of the row is read again (from L2).
// - The sum runs in one fixed order: each thread's partial in vector order,
//   a shuffle tree in the warp, then the row's warps in index order
//   through shared memory. The wrapper's quant_rmsnorm_model repeats that
//   order, so the kernel is bit-equal to it.
// - Codes are stored packed: four to a 32-bit word (f32) or eight to a
//   64-bit word (bf16), so a warp writes 128 or 256 contiguous bytes.
// - Every scalar operation is rounded on its own (no fused multiply-add),
//   as the plain version rounds them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStagedReserve = 256;  // bytes before a staged row: 2 x 32 warp sums

// V consecutive input elements as loaded: f32 (BF16 = false) or bf16 bits.
template <bool BF16, int V>
struct Vec;

template <>
struct Vec<false, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const void* row, int j) {
    return __ldcs(static_cast<const float4*>(row) + j);
  }
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float at(const Raw& r, int e) {
    return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
  }
};

template <>
struct Vec<false, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const void* row, int j) {
    return __ldcs(static_cast<const float*>(row) + j);
  }
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ float at(const Raw& r, int) { return r; }
};

template <>
struct Vec<true, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const void* row, int j) {
    return __ldcs(static_cast<const uint4*>(row) + j);
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ float at(const Raw& r, int e) {
    const uint32_t w = e < 2 ? r.x : e < 4 ? r.y : e < 6 ? r.z : r.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));  // little-endian pairs
  }
};

template <>
struct Vec<true, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const void* row, int j) {
    return __ldcs(static_cast<const unsigned short*>(row) + j);
  }
  static __device__ __forceinline__ Raw zero() { return 0; }
  static __device__ __forceinline__ float at(const Raw& r, int) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

// V codes of vector j of a row, packed into one store.
template <int V>
__device__ __forceinline__ void store_codes(uint8_t* row, int j, const uint32_t (&c)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<unsigned int*>(row) + j, c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24);
  } else if constexpr (V == 8) {
    __stcs(reinterpret_cast<uint2*>(row) + j,
           make_uint2(c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24,
                      c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24));
  } else {
    row[j] = static_cast<uint8_t>(c[0]);
  }
}

// gamma of vector j, from a copy in shared memory (16-byte aligned).
template <int V>
__device__ __forceinline__ void gamma_of(const float* sg, int j, float (&g)[V]) {
  if constexpr (V == 1) {
    g[0] = sg[j];
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 q = reinterpret_cast<const float4*>(sg)[j * (V / 4) + h];
      g[4 * h] = q.x;
      g[4 * h + 1] = q.y;
      g[4 * h + 2] = q.z;
      g[4 * h + 3] = q.w;
    }
  }
}

struct Quant {
  const float* scale;  // device act_scale, or null: use inv_scale
  const float* zp_ptr;  // device act_zp, or null: use zp
  float inv_scale;
  float zp;
};

__device__ __forceinline__ float2 quantizer(const Quant& q) {
  return make_float2(q.scale ? __fdiv_rn(1.f, __ldg(q.scale)) : q.inv_scale,
                     q.zp_ptr ? __ldg(q.zp_ptr) : q.zp);
}

__device__ __forceinline__ float sum_squares(float ss, float v) {
  return __fadd_rn(ss, __fmul_rn(v, v));
}

// The row's sum from each thread's partial: a shuffle tree in the warp,
// then the row's W warps in index order through `ws` (slots g*W .. g*W+W-1).
// Every thread of the block calls it (a block barrier where W > 1); every
// thread of the row gets the same value.
__device__ __forceinline__ float row_total(float ss, float* ws, int W, int g, int w, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (W == 1) return ss;
  if (lane == 0) ws[g * W + w] = ss;
  __syncthreads();
  float total = ws[g * W];
  for (int i = 1; i < W; ++i) total = __fadd_rn(total, ws[g * W + i]);
  return total;
}

__device__ __forceinline__ float inv_rms(float total, int D, float eps) {
  const float ms = __fdiv_rn(total, static_cast<float>(D));
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
}

__device__ __forceinline__ uint32_t code(float v, float r, float g, float2 qp, float qmax) {
  const float y = __fmul_rn(__fmul_rn(v, r), g);
  const float q = __fadd_rn(rintf(__fmul_rn(y, qp.x)), qp.y);
  return static_cast<uint32_t>(fminf(fmaxf(q, 0.f), qmax));
}

// What a thread of quant_rmsnorm_rows needs to finish a row.
struct RowCtx {
  const char* x;
  const float* sg;
  uint8_t* out;
  int M, D, T, nvec, R, g, t, w, W, lane;
  float eps, qmax;
  float2 qp;
};

template <bool BF16, int V, int NV>
__device__ __forceinline__ void load_row(typename Vec<BF16, V>::Raw (&buf)[NV], const RowCtx& c,
                                         int tile) {
  using L = Vec<BF16, V>;
  const int row = tile * c.R + c.g;
  const char* xr = c.x + static_cast<size_t>(row) * c.D * (BF16 ? 2 : 4);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = c.t + k * c.T;
    buf[k] = (row < c.M && j < c.nvec) ? L::load(xr, j) : L::zero();
  }
}

template <bool BF16, int V, int NV>
__device__ __forceinline__ void finish_row(const typename Vec<BF16, V>::Raw (&buf)[NV],
                                           const RowCtx& c, int tile, float* ws) {
  using L = Vec<BF16, V>;
  float ss = 0.f;  // empty slots hold zeros, which add nothing
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int e = 0; e < V; ++e) ss = sum_squares(ss, L::at(buf[k], e));
  }
  const float total = row_total(ss, ws, c.W, c.g, c.w, c.lane);
  const int row = tile * c.R + c.g;
  if (row >= c.M) return;
  const float r = inv_rms(total, c.D, c.eps);
  uint8_t* orow = c.out + static_cast<size_t>(row) * c.D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = c.t + k * c.T;
    if (j < c.nvec) {
      float g[V];
      gamma_of<V>(c.sg, j, g);
      uint32_t q[V];
#pragma unroll
      for (int e = 0; e < V; ++e) q[e] = code(L::at(buf[k], e), r, g[e], c.qp, c.qmax);
      store_codes<V>(orow, j, q);
    }
  }
}

// Rows held in registers: B threads a block, B / T rows a tile, NV vector
// slots a thread. Shared memory: gamma (D floats, padded to 4), then two
// halves of B / 32 warp sums (tiles alternate halves, so one barrier a tile).
template <bool BF16, int V, int NV, int B>
__global__ void __launch_bounds__(B, kMaxThreads / B)
quant_rmsnorm_rows(const void* __restrict__ x, const float* __restrict__ gamma, Quant qz,
                   uint8_t* __restrict__ out, int M, int D, int T, float eps, float qmax) {
  using Raw = typename Vec<BF16, V>::Raw;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem + ((D + 3) & ~3);
  RowCtx c;
  c.x = static_cast<const char*>(x);
  c.sg = smem;
  c.out = out;
  c.M = M;
  c.D = D;
  c.T = T;
  c.nvec = D / V;
  c.R = B / T;
  c.g = threadIdx.x / T;
  c.t = threadIdx.x % T;
  c.w = c.t >> 5;
  c.W = T >> 5;
  c.lane = threadIdx.x & 31;
  c.eps = eps;
  c.qmax = qmax;
  const int tiles = (M + c.R - 1) / c.R;

  Raw a[NV], b[NV];
  int tile = blockIdx.x;
  load_row<BF16, V, NV>(a, c, tile);
  for (int j = threadIdx.x; j < D; j += B) smem[j] = __ldg(gamma + j);
  c.qp = quantizer(qz);
  __syncthreads();
  while (tile < tiles) {
    const int t1 = tile + gridDim.x;
    load_row<BF16, V, NV>(b, c, t1);
    finish_row<BF16, V, NV>(a, c, tile, ws);
    if (t1 >= tiles) break;
    const int t2 = t1 + gridDim.x;
    load_row<BF16, V, NV>(a, c, t2);
    finish_row<BF16, V, NV>(b, c, t1, ws + B / 32);
    tile = t2;
  }
}

// Rows past the register tier: one row a block of 1024 threads, its first
// `held` vectors kept in shared memory (after two halves of 32 warp sums).
template <bool BF16, int V>
__global__ void __launch_bounds__(kMaxThreads)
quant_rmsnorm_staged(const void* __restrict__ x, const float* __restrict__ gamma, Quant qz,
                     uint8_t* __restrict__ out, int M, int D, int held, float eps, float qmax) {
  using L = Vec<BF16, V>;
  using Raw = typename L::Raw;
  extern __shared__ __align__(16) float smem[];
  Raw* buf = reinterpret_cast<Raw*>(reinterpret_cast<char*>(smem) + kStagedReserve);
  const int nvec = D / V, t = threadIdx.x, w = t >> 5, lane = t & 31;
  const float2 qp = quantizer(qz);
  int half = 0;
  for (int row = blockIdx.x; row < M; row += gridDim.x, half ^= 1) {
    const char* xr = static_cast<const char*>(x) + static_cast<size_t>(row) * D * (BF16 ? 2 : 4);
    float ss = 0.f;
    for (int j0 = t; j0 < nvec; j0 += 4 * kMaxThreads) {
      Raw v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i * kMaxThreads;
        v[i] = j < nvec ? L::load(xr, j) : L::zero();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < V; ++e) ss = sum_squares(ss, L::at(v[i], e));
        const int j = j0 + i * kMaxThreads;
        if (j < held) buf[j] = v[i];
      }
    }
    const float total = row_total(ss, smem + 32 * half, kMaxThreads / 32, 0, w, lane);
    const float r = inv_rms(total, D, eps);
    uint8_t* orow = out + static_cast<size_t>(row) * D;
    for (int j = t; j < nvec; j += kMaxThreads) {
      const Raw v = j < held ? buf[j] : L::load(xr, j);
      uint32_t q[V];
#pragma unroll
      for (int e = 0; e < V; ++e) q[e] = code(L::at(v, e), r, __ldg(gamma + j * V + e), qp, qmax);
      store_codes<V>(orow, j, q);
    }
  }
}

// The timing floor: nothing, on the grid, block and shared memory of a call.
__global__ void empty_probe_kernel() {}

struct Call {
  const void* x;
  const float* gamma;
  Quant q;
  uint8_t* out;
  int M, D, T, held;
  float eps, qmax;
  bool probe;
  cudaStream_t stream;
};

// Let `func` take `smem` bytes of dynamic shared memory (the card's opt-in
// limit, set once per kernel and device), then size a grid of at most what
// the card holds at once. The attributes and the occupancy are queried once
// per (device, kernel, block, smem) and kept, so a call repeats no query.
int resident_grid(const void* func, int block, size_t smem, int work, int* grid) {
  struct Resident {
    int dev;
    const void* func;
    int block;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static Resident seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  int blocks = 0;
  for (int i = 0; i < n_seen && !blocks; ++i) {
    const Resident& r = seen[i];
    if (r.dev == dev && r.func == func && r.block == block && r.smem == smem) blocks = r.blocks;
  }
  if (!blocks) {
    int sms = 0, optin = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > static_cast<size_t>(optin)) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(reinterpret_cast<const void*>(empty_probe_kernel),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, func, block, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = sms * occ;
    if (n_seen < 64) seen[n_seen++] = Resident{dev, func, block, smem, blocks};
  }
  *grid = work < blocks ? work : blocks;
  return 0;
}

template <bool BF16, int V, int NV, int B>
int launch_rows(const Call& a) {
  auto kern = quant_rmsnorm_rows<BF16, V, NV, B>;
  const int nvec = a.D / V;
  if (a.T < 32 || a.T > B || (a.T & (a.T - 1)) || a.D % V || (nvec + a.T - 1) / a.T > NV)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>((a.D + 3) & ~3) + 2 * (B / 32)) * sizeof(float);
  const int rows = B / a.T;
  int grid = 0;
  const int err = resident_grid(reinterpret_cast<const void*>(kern), B, smem,
                                (a.M + rows - 1) / rows, &grid);
  if (err) return err;
  if (a.probe) {
    empty_probe_kernel<<<grid, B, smem, a.stream>>>();
  } else {
    kern<<<grid, B, smem, a.stream>>>(a.x, a.gamma, a.q, a.out, a.M, a.D, a.T, a.eps, a.qmax);
  }
  return (int)cudaGetLastError();
}

template <bool BF16, int V>
int launch_staged(const Call& a) {
  auto kern = quant_rmsnorm_staged<BF16, V>;
  using Raw = typename Vec<BF16, V>::Raw;
  if (a.T != kMaxThreads || a.D % V || a.held < 0 || a.held > a.D / V)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kStagedReserve + static_cast<size_t>(a.held) * sizeof(Raw);
  int grid = 0;
  const int err = resident_grid(reinterpret_cast<const void*>(kern), kMaxThreads, smem, a.M, &grid);
  if (err) return err;
  if (a.probe) {
    empty_probe_kernel<<<grid, kMaxThreads, smem, a.stream>>>();
  } else {
    kern<<<grid, kMaxThreads, smem, a.stream>>>(a.x, a.gamma, a.q, a.out, a.M, a.D, a.held,
                                                  a.eps, a.qmax);
  }
  return (int)cudaGetLastError();
}

template <bool BF16, int V, int B>
int dispatch_slots(const Call& a, int per_thread) {
  if constexpr (V == 1) {
    switch (per_thread) {
      case 1: return launch_rows<BF16, 1, 1, B>(a);
      case 2: return launch_rows<BF16, 1, 2, B>(a);
      case 4: return launch_rows<BF16, 1, 4, B>(a);
      case 8: return launch_rows<BF16, 1, 8, B>(a);
    }
  } else {
    switch (per_thread) {
      case 1: return launch_rows<BF16, V, 1, B>(a);
      case 2: return launch_rows<BF16, V, 2, B>(a);
      case 3: return launch_rows<BF16, V, 3, B>(a);
      case 4: return launch_rows<BF16, V, 4, B>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BF16, int V>
int dispatch(const Call& a, int per_thread, int block, int staged) {
  if (staged) return launch_staged<BF16, V>(a);
  if (block == 256) return dispatch_slots<BF16, V, 256>(a, per_thread);
  if (block == 512) return dispatch_slots<BF16, V, 512>(a, per_thread);
  if (block == kMaxThreads) return dispatch_slots<BF16, V, kMaxThreads>(a, per_thread);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point. x (M, D) f32 (x_bf16 = 0) or bf16, contiguous, 16-byte
// aligned where vec > 1; gamma (D,) f32; out (M, D) uint8, contiguous.
// The quantizer: `scale` / `zp` point to device f32 scalars, or are null
// and `inv_scale` / `zp_value` are used. The plan (vec, threads,
// per_thread, block, staged, held) is the wrapper's rmsnorm_plan; probe = 1
// launches an empty kernel on the same grid instead (a timing floor).
// Returns the launch's cudaError_t (0 on success); runs asynchronously on
// `stream`.
extern "C" int quant_rmsnorm_launch(const void* x, const void* gamma, const void* scale,
                                    const void* zp, void* out, int M, int D, int x_bf16,
                                    float inv_scale, float zp_value, float eps, float qmax,
                                    int vec, int threads, int per_thread, int block, int staged,
                                    int held, int probe, void* stream) {
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Call a{x, static_cast<const float*>(gamma),
         Quant{static_cast<const float*>(scale), static_cast<const float*>(zp), inv_scale,
               zp_value},
         static_cast<uint8_t*>(out), M, D, threads, held, eps, qmax, probe != 0,
         static_cast<cudaStream_t>(stream)};
  if (x_bf16) {
    if (vec == 8) return dispatch<true, 8>(a, per_thread, block, staged);
    if (vec == 1) return dispatch<true, 1>(a, per_thread, block, staged);
  } else {
    if (vec == 4) return dispatch<false, 4>(a, per_thread, block, staged);
    if (vec == 1) return dispatch<false, 1>(a, per_thread, block, staged);
  }
  return (int)cudaErrorInvalidValue;
}
