// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a KV page pool walked through a block table, with GQA. Plain C
// interface, bound with ctypes by repro_torch/kernels/paged_attention.py.
//
// Two kernels replace the two bodies of the Pallas kernel
// src/repro/kernels/paged_attention.py (`paged_decode_attention`, one
// pallas_call):
//
//   B2 paged_attn_float_kernel  <- `_kernel` (:189), float pages (bf16/f32);
//   B3 paged_attn_int8_kernel   <- `_quant_kernel` (:226), int8 pages with
//      per-(page, kv-head) f32 scales: the integer datapath that
//      AttnDatapathSpec certifies.
//
// Both keep the online-softmax recurrence of `_softmax_accumulate` (:164):
// per page, m_new = max(m, max s); m_safe = m_new if finite else 0;
// p = exp(s - m_safe); corr = exp(m - m_safe) if m finite else 0;
// l = l * corr + sum(p_eff); acc = acc * corr + pv; the epilogue is
// acc / max(l, 1e-20), rounded to the output type.
//
//   B2: s = (q . k) / sqrt(hd), softcap cap * tanh(s / cap), the length
//       mask; p_eff = p, pv = p . v, all in f32.
//   B3: q quantized per head, scale = max(amax / 127, 1e-8), codes
//       clip(rint(q / scale), +-127); s_int = q_codes . k_codes (int32, the
//       P_qk register); s = s_int * q_scale * k_scale, then / sqrt(hd),
//       softcap and mask; probability codes rint(p * 255); pv_int =
//       p_codes . v_codes over the page (int32, the P_pv register), drained
//       as pv_int * (v_scale / 255); p_eff = p_codes / 255. When `wm` is
//       given, the largest |s_int| (valid positions) and |pv_int| go into
//       wm[0] and wm[1] with atomicMax.
//
// Design. The TPU grid (B, n_pages) carried m/l/acc in VMEM across
// sequential page steps. Here one block of 128 threads owns one (slot,
// kv head) and loops over the pages itself, so the g query heads of a GQA
// group share every K/V row load; m, l, acc, the group's q and one page
// of scores live in shared memory. The block reads table[b, j] itself,
// clamped to nb - 1 as the TPU index map does (idle slots hold the
// sentinel nb), and walks only ceil(len / bs) pages, not the table's whole
// width: masked positions add exp(-inf) = 0, so the function is unchanged.
// Each page's K and V rows of the block's kv head are first staged into
// shared memory by all threads at once (16-byte vectors where the row
// allows, several loads in flight per thread): a first version that read
// K and V straight from global memory inside the position loops took
// 96 us a call at 4 x 80 tokens against 68 us staged (chip_smoke.py phase
// 6, NVIDIA H100 80GB HBM3 at 700 W, PERF.md). Scores:
// each warp takes positions of the page, its lanes split hd, and a shuffle
// tree reduces the g dots. PV: each thread takes a head-dim lane and runs
// over the page's valid positions, g partials in registers. Hd of any
// width (7, 11, ... 256) reduces on the CUDA cores; bs and hd below the
// tensor-core tile minimums are the common case here.
//
// Bound. The function must read q, the sequence's K/V pages and (B3) their
// scales, and write the output: at smollm-360m decode (nh 15, nkv 5, hd 64,
// bs 64, bf16), 4 slots of 80 tokens move about 0.66 MB, 0.2 us at
// 3.35 TB/s; its operations (4 * B * nh * len * hd) are negligible. With
// only B * nkv = 20 blocks of 4 warps on 132 SMs and a page loop whose
// every step is a chain of dependent loads, shuffles and barriers, the
// kernel is bound by latency, not by either: about 34 us a page on the
// H100 above (68 us at 4 x 80 tokens, 1.13 ms at 4 x 2048). Splitting the
// pages of a sequence over blocks (and tensor cores for long contexts) is
// the next step (ROADMAP Queue B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // query heads per kv head (g) the kernels take

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_imax(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Dims {
  int nb, bs, nkv, g, hd, n_cols;  // pool pages, page size, heads, table width
  float sqrt_hd, cap;
  int has_cap;
};

// Scale, softcap and length-mask one score (the reference's order).
__device__ __forceinline__ float finish_score(float s, int pos, int len, const Dims& d) {
  s = __fdiv_rn(s, d.sqrt_hd);
  if (d.has_cap) s = __fmul_rn(d.cap, tanhf(__fdiv_rn(s, d.cap)));
  return pos < len ? s : -INFINITY;
}

// Pages this row walks: ceil(len / bs), at most the table's width.
__device__ __forceinline__ int pages_for(int len, const Dims& d) {
  int n = (len + d.bs - 1) / d.bs;
  return n < 0 ? 0 : (n > d.n_cols ? d.n_cols : n);
}

__device__ __forceinline__ int page_at(const int* table, int b, int j, const Dims& d) {
  int page = table[(size_t)b * d.n_cols + j];
  return page < d.nb - 1 ? (page < 0 ? 0 : page) : d.nb - 1;
}

// Stage one page's K and V rows of one kv head (bs rows of `row_bytes`,
// `stride` bytes apart in global memory) into k_dst and v_dst, contiguous.
// Every thread issues kUnroll loads before it stores any, so the block
// keeps up to 128 * kUnroll loads in flight; the caller synchronizes.
constexpr int kUnroll = 4;

template <typename V>
__device__ __forceinline__ void stage_rows(char* k_dst, char* v_dst, const char* k_src,
                                           const char* v_src, int rows, int row_bytes,
                                           size_t stride, int tid) {
  const int per_row = row_bytes / (int)sizeof(V);
  const int n = rows * per_row;  // vectors per tile
  for (int base = tid; base < 2 * n; base += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < 2 * n) {
        const int e = i < n ? i : i - n;
        const char* src = (i < n ? k_src : v_src) + (size_t)(e / per_row) * stride;
        v[u] = reinterpret_cast<const V*>(src)[e % per_row];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < 2 * n) reinterpret_cast<V*>(i < n ? k_dst : v_dst)[i < n ? i : i - n] = v[u];
    }
  }
}

__device__ __forceinline__ void stage_page(char* k_dst, char* v_dst, const char* k_src,
                                           const char* v_src, int rows, int row_bytes,
                                           size_t stride, int tid) {
  const bool vec16 = row_bytes % 16 == 0 && stride % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k_src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_src) % 16 == 0;
  if (vec16)
    stage_rows<uint4>(k_dst, v_dst, k_src, v_src, rows, row_bytes, stride, tid);
  else
    stage_rows<char>(k_dst, v_dst, k_src, v_src, rows, row_bytes, stride, tid);
}

// Bytes of one staged tile (bs rows of hd elements), rounded up to 16.
__host__ __device__ __forceinline__ size_t tile_bytes(int bs, int hd, int elem) {
  return ((size_t)bs * hd * elem + 15) / 16 * 16;
}

// One page's online-softmax step for the group's heads. On entry s_s holds
// the page's masked scores; on exit it holds the weights PV multiplies
// (p, or the probability codes when `quant`), and corr_s/l_s/m_s are
// updated. One warp per head.
template <bool quant>
__device__ __forceinline__ void softmax_page(float* s_s, float* m_s, float* l_s,
                                             float* corr_s, int lane, int warp,
                                             const Dims& d) {
  for (int h = warp; h < d.g; h += kWarps) {
    float* row = s_s + h * d.bs;
    float mx = -INFINITY;
    for (int t = lane; t < d.bs; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    const float m_prev = m_s[h];
    const float m_new = fmaxf(m_prev, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float sum = 0.f;
    for (int t = lane; t < d.bs; t += 32) {
      float p = expf(__fsub_rn(row[t], m_safe));  // masked: exp(-inf) = 0
      if (quant) {
        p = rintf(__fmul_rn(p, 255.f));
        sum += __fdiv_rn(p, 255.f);
      } else {
        sum += p;
      }
      row[t] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = isfinite(m_prev) ? expf(__fsub_rn(m_prev, m_safe)) : 0.f;
      corr_s[h] = corr;
      l_s[h] = __fadd_rn(__fmul_rn(l_s[h], corr), sum);
      m_s[h] = m_new;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attn_float_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                            const T* __restrict__ vp, const int* __restrict__ table,
                            const int* __restrict__ lens, T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  const int g = d.g, hd = d.hd, bs = d.bs;
  const size_t tile = tile_bytes(bs, hd, sizeof(T));
  T* k_s = reinterpret_cast<T*>(smem_raw);           // (bs, hd) this page's K
  T* v_s = reinterpret_cast<T*>(smem_raw + tile);    // (bs, hd) this page's V
  float* q_s = reinterpret_cast<float*>(smem_raw + 2 * tile);  // (g, hd)
  float* acc_s = q_s + g * hd;  // (g, hd)
  float* s_s = acc_s + g * hd;  // (g, bs)
  float* m_s = s_s + g * bs;
  float* l_s = m_s + g;
  float* corr_s = l_s + g;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = d.nkv * g;
  const size_t q_base = ((size_t)b * nh + (size_t)kvh * g) * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    q_s[i] = load_f(q + q_base + i);
    acc_s[i] = 0.f;
  }
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }

  const int len = lens[b];
  const int n_pages = pages_for(len, d);
  const size_t row_stride = (size_t)d.nkv * hd;
  for (int j = 0; j < n_pages; ++j) {
    const size_t page_base = (size_t)page_at(table, b, j, d) * bs * row_stride + (size_t)kvh * hd;
    stage_page(reinterpret_cast<char*>(k_s), reinterpret_cast<char*>(v_s),
               reinterpret_cast<const char*>(kp + page_base),
               reinterpret_cast<const char*>(vp + page_base), bs, hd * (int)sizeof(T),
               row_stride * sizeof(T), tid);
    __syncthreads();
    // scores: one warp per position, lanes across hd
    for (int t = warp; t < bs; t += kWarps) {
      const T* krow = k_s + t * hd;
      float dot[kMaxGroup];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) dot[h] = 0.f;
      for (int x = lane; x < hd; x += 32) {
        const float kv = load_f(krow + x);
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) dot[h] = fmaf(q_s[h * hd + x], kv, dot[h]);
      }
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < g) {
          const float s = warp_sum(dot[h]);
          if (lane == 0) s_s[h * bs + t] = finish_score(s, j * bs + t, len, d);
        }
      }
    }
    __syncthreads();
    softmax_page<false>(s_s, m_s, l_s, corr_s, lane, warp, d);
    __syncthreads();
    // PV: one head-dim lane per thread, over the page's valid positions
    const int t_end = min(bs, len - j * bs);
    for (int x = tid; x < hd; x += kThreads) {
      float part[kMaxGroup];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) part[h] = 0.f;
      for (int t = 0; t < t_end; ++t) {
        const float vv = load_f(v_s + t * hd + x);
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) part[h] = fmaf(s_s[h * bs + t], vv, part[h]);
      }
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) acc_s[h * hd + x] = __fadd_rn(__fmul_rn(acc_s[h * hd + x], corr_s[h]), part[h]);
    }
    __syncthreads();
  }
  for (int i = tid; i < g * hd; i += kThreads)
    store_f(out + q_base + i, __fdiv_rn(acc_s[i], fmaxf(l_s[i / hd], 1e-20f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kp,
                           const int8_t* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ table,
                           const int* __restrict__ lens, T* __restrict__ out,
                           int* __restrict__ wm, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  const int g = d.g, hd = d.hd, bs = d.bs;
  const size_t tile = tile_bytes(bs, hd, 1);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem_raw);         // (bs, hd) K codes
  int8_t* v_s = reinterpret_cast<int8_t*>(smem_raw + tile);  // (bs, hd) V codes
  int* qc_s = reinterpret_cast<int*>(smem_raw + 2 * tile);   // (g, hd) q codes
  float* acc_s = reinterpret_cast<float*>(qc_s + g * hd);    // (g, hd)
  float* s_s = acc_s + g * hd;                               // (g, bs)
  float* m_s = s_s + g * bs;
  float* l_s = m_s + g;
  float* corr_s = l_s + g;
  float* qscale_s = corr_s + g;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = d.nkv * g;
  const size_t q_base = ((size_t)b * nh + (size_t)kvh * g) * hd;
  // per-head symmetric quantization of the query rows
  for (int h = warp; h < g; h += kWarps) {
    float amax = 0.f;
    for (int x = lane; x < hd; x += 32) amax = fmaxf(amax, fabsf(load_f(q + q_base + h * hd + x)));
    amax = warp_max(amax);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    for (int x = lane; x < hd; x += 32) {
      const float c = rintf(__fdiv_rn(load_f(q + q_base + h * hd + x), scale));
      qc_s[h * hd + x] = (int)fminf(fmaxf(c, -127.f), 127.f);
    }
    if (lane == 0) {
      qscale_s[h] = scale;
      m_s[h] = -INFINITY;
      l_s[h] = 0.f;
    }
  }
  for (int i = tid; i < g * hd; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  const int len = lens[b];
  const int n_pages = pages_for(len, d);
  const size_t row_stride = (size_t)d.nkv * hd;
  int wm_qk = 0, wm_pv = 0;
  for (int j = 0; j < n_pages; ++j) {
    const int page = page_at(table, b, j, d);
    const size_t page_base = (size_t)page * bs * row_stride + (size_t)kvh * hd;
    const float k_scale = ks[(size_t)page * d.nkv + kvh];
    const float v_drain = __fdiv_rn(vs[(size_t)page * d.nkv + kvh], 255.f);
    stage_page(reinterpret_cast<char*>(k_s), reinterpret_cast<char*>(v_s),
               reinterpret_cast<const char*>(kp + page_base),
               reinterpret_cast<const char*>(vp + page_base), bs, hd, row_stride, tid);
    __syncthreads();
    // hd-deep integer QK^T (the P_qk register), one warp per position
    for (int t = warp; t < bs; t += kWarps) {
      const int8_t* krow = k_s + t * hd;
      int dot[kMaxGroup];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) dot[h] = 0;
      for (int x = lane; x < hd; x += 32) {
        const int kc = krow[x];
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) dot[h] += qc_s[h * hd + x] * kc;
      }
      const int pos = j * bs + t;
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < g) {
          const int si = warp_isum(dot[h]);
          if (lane == 0) {
            if (pos < len) wm_qk = max(wm_qk, abs(si));
            const float s = __fmul_rn(__fmul_rn(__int2float_rn(si), qscale_s[h]), k_scale);
            s_s[h * bs + t] = finish_score(s, pos, len, d);
          }
        }
      }
    }
    __syncthreads();
    softmax_page<true>(s_s, m_s, l_s, corr_s, lane, warp, d);
    __syncthreads();
    // page-deep integer PV (the P_pv register), drained scaled into acc
    const int t_end = min(bs, len - j * bs);
    for (int x = tid; x < hd; x += kThreads) {
      int part[kMaxGroup];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) part[h] = 0;
      for (int t = 0; t < t_end; ++t) {
        const int vc = v_s[t * hd + x];
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) part[h] += (int)s_s[h * bs + t] * vc;
      }
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < g) {
          wm_pv = max(wm_pv, abs(part[h]));
          const float pv = __fmul_rn(__int2float_rn(part[h]), v_drain);
          acc_s[h * hd + x] = __fadd_rn(__fmul_rn(acc_s[h * hd + x], corr_s[h]), pv);
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < g * hd; i += kThreads)
    store_f(out + q_base + i, __fdiv_rn(acc_s[i], fmaxf(l_s[i / hd], 1e-20f)));
  if (wm != nullptr) {
    wm_qk = warp_imax(wm_qk);
    wm_pv = warp_imax(wm_pv);
    if (lane == 0) {
      atomicMax(wm, wm_qk);
      atomicMax(wm + 1, wm_pv);
    }
  }
}

size_t smem_bytes(int g, int hd, int bs, int elem, int quantized) {
  // the staged K and V tiles; q (or q codes), acc, one page of scores, m,
  // l, corr (+ q scales)
  return 2 * tile_bytes(bs, hd, elem) +
         sizeof(float) * ((size_t)2 * g * hd + (size_t)g * bs + (quantized ? 4 : 3) * (size_t)g);
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes), for the wrapper's checks; `elem`
// is the page element's size in bytes.
size_t paged_attention_smem_bytes(int g, int hd, int bs, int elem, int quantized) {
  return smem_bytes(g, hd, bs, elem, quantized);
}

// q (B, nkv*g, hd) and out (same shape) in bf16 (dtype_bf16 = 1) or f32;
// k/v pages (nb, bs, nkv, hd) in q's type (quantized = 0) or int8 with
// k/v scales (nb, nkv) f32 (quantized = 1); table (B, n_cols) int32;
// lens (B,) int32; wm NULL or two int32 watermarks (quantized only). All
// contiguous on one device. Returns the CUDA error of the launch.
int paged_attention_launch(const void* q, const void* kp, const void* vp, const void* ks,
                           const void* vs, const void* table, const void* lens, void* out,
                           void* wm, int batch, int nb, int bs, int nkv, int g, int hd,
                           int n_cols, int dtype_bf16, int quantized, float sqrt_hd, float cap,
                           int has_cap, void* stream) {
  if (g < 1 || g > kMaxGroup || hd < 1 || bs < 1 || nb < 1 || n_cols < 1) return cudaErrorInvalidValue;
  const Dims d{nb, bs, nkv, g, hd, n_cols, sqrt_hd, cap, has_cap};
  const dim3 grid(nkv, batch);
  const int elem = quantized ? 1 : (dtype_bf16 ? 2 : 4);
  const size_t smem = smem_bytes(g, hd, bs, elem, quantized);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (quantized) {
    if (dtype_bf16) {
      auto k = paged_attn_int8_kernel<__nv_bfloat16>;
      if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
      k<<<grid, kThreads, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kp),
          static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out),
          static_cast<int*>(wm), d);
    } else {
      auto k = paged_attn_int8_kernel<float>;
      if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
      k<<<grid, kThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const int8_t*>(kp),
          static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const int*>(lens), static_cast<float*>(out), static_cast<int*>(wm), d);
    }
  } else {
    if (dtype_bf16) {
      auto k = paged_attn_float_kernel<__nv_bfloat16>;
      if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
      k<<<grid, kThreads, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
          static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
          static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), d);
    } else {
      auto k = paged_attn_float_kernel<float>;
      if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
      k<<<grid, kThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(kp),
          static_cast<const float*>(vp), static_cast<const int*>(table),
          static_cast<const int*>(lens), static_cast<float*>(out), d);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
