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
// Bound. The function must read q, the sequence's K/V pages and (B3) their
// scales, and write the output: at smollm-360m decode (nh 15, nkv 5, hd 64,
// bs 64, bf16) and 4 slots of 2048 tokens that is about 10.5 MB, 3.1 us at
// 3.35 TB/s (1.6 us for int8 pages); the operations (4 * B * nh * len * hd)
// are negligible. Bytes bound it, but at these sizes a launch (about 5 us
// under chip_smoke.py's timer) and each dependent DRAM round trip (length,
// table, pages) cost as much as the bytes.
//
// The first version (one block of 128 threads per (slot, kv head) walking
// every page in order) took 68 / 74 us (B2 / B3) at 4 x 80 tokens and
// 1.13 / 1.24 ms at 4 x 2048 (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// scripts/paged_attention_attribution.py put its 35 / 39 us a page on
// dependent latency inside one block, at 1 and 4 slots alike: staging 2 / 1
// us, scores 19 / 21 us (a shuffle tree per position and head, lane 0
// dividing), softmax 2 / 1 us, PV 12 / 16 us (64 threads, serial positions).
//
// Design.
// * Split. The grid is (nkv, B, S): S splits of each row's pages, S picked
//   by the wrapper from shapes alone (about three blocks per SM, one wave,
//   at most the table's width). Each row divides its own ceil(len / bs)
//   pages on the device: split s takes pages [s * per, (s + 1) * per), per =
//   ceil(n / S); splits past a row's pages write a neutral partial (m =
//   -inf, l = 0, acc = 0). Each split writes (m, l, acc) in f32 to a
//   workspace; the last block of a (slot, kv head) to finish, found by an
//   atomic counter that it resets to 0, combines the busy splits in one
//   pass per output with a running maximum. One split gives acc / max(l,
//   1e-20) as before; an idle slot gives 0.
// * Loads. A block reads its table entries ahead, beside the row's length
//   (512 columns in registers), then takes its pages in chunks of up to
//   `chunk` pages (192 positions): K and V of a chunk go into shared memory
//   by cp.async in two commit groups, so V lands while the scores run, the
//   next chunk's K loads while this one's PV runs, and its V while the next
//   scores run. Rows are padded so that 16-byte reads of neighbouring rows
//   hit distinct banks.
// * Scores: `tpp` threads per position (a power of two), each over 16-byte
//   units of the row, the g heads at once; one xor-shuffle step per factor
//   of two; the lanes of a position share the heads' finishing (scale,
//   softcap, mask in the reference's order). B3: dp4a on the packed q codes
//   (packed once per block) and the K codes.
// * Softmax: one warp per head over the chunk. B2 takes one max over the
//   chunk; B3 keeps the page order (below).
// * PV: warps split each page's positions, each lane two head-dim columns,
//   the g heads in registers; the per-page partials are summed over the
//   warps in the drain, page by page.
// * B3's running max. Its probability codes use the running maximum over
//   every page before, in table order, so a split needs the maximum of the
//   splits before it. One launch: each block first finds its split's
//   maximum of the finished scores (with the P_qk watermark) and publishes
//   it with a flag, then waits for the flags of the splits before it, takes
//   the maximum of their maxima and runs the sequential recurrence from it
//   (page maxima, running max, codes, per-page integer PV and drain in page
//   order). A block takes its split index as a ticket, in the order the
//   blocks start, so it only ever waits for blocks already running. A flag
//   is nonzero once published, and the row's last block to finish sets its
//   flags back to 0, so every call starts from zeroed flags and the launch
//   depends on no value from the host (it may be replayed in a graph). Codes
//   and both watermarks are those of the sequential kernel; only the f32
//   drain is reassociated (across splits, in the combine).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;    // query heads per kv head (g) the kernels take
constexpr int kMaxChunk = 8;     // pages per chunk
constexpr int kChunkPositions = 192;
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ int load_v(const int8_t* p) { return *p; }
__device__ __forceinline__ float load_v(const float* p) { return *p; }
__device__ __forceinline__ float load_v(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float pv_term(float p, float v, float acc) { return fmaf(p, v, acc); }
__device__ __forceinline__ int pv_term(float p, int v, int acc) { return acc + (int)p * v; }

__device__ __forceinline__ float warp_sum(float v) {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Dims {
  int nb, bs, nkv, g, hd, n_cols;  // pool pages, page size, kv heads, group, head dim, table width
  int n_splits, chunk;             // splits per row, pages per chunk
  int vec;                         // stage with 16-byte cp.async
  float sqrt_hd, cap;
  int has_cap;
};

enum Kind { kFloat = 0, kInt8 = 1 };

// Shared-memory layout of one block (byte offsets), the same on host and
// device. A staged row holds `units` 16-byte units (hd elements, zero-padded
// past hd) and rows lie `pitch` units apart, pitch / tpp odd: the 8 threads
// of a quarter warp then read 8 distinct bank groups.
struct Layout {
  int units, tpp, max_pages;
  size_t pitch, tile;  // bytes
  size_t k, v, q, s, red, acc, stat, pages, total;
};

__host__ __device__ inline Layout make_layout(const Dims& d, int elem, int kind) {
  Layout L;
  L.units = (d.hd * elem + 15) / 16;
  L.tpp = 1;
  while (L.tpp < 32 && 2 * L.tpp <= L.units && L.tpp * d.bs < kThreads) L.tpp *= 2;
  int p = L.units;
  if (L.tpp < 8) {
    p = (L.units + L.tpp - 1) / L.tpp;
    if (p % 2 == 0) ++p;
    p *= L.tpp;
  }
  L.pitch = (size_t)p * 16;
  L.tile = (size_t)d.bs * L.pitch;
  L.max_pages = (d.n_cols + d.n_splits - 1) / d.n_splits;
  const bool quant = kind != kFloat;
  const size_t tiles = (size_t)d.chunk * L.tile;
  size_t o = 0;
  L.k = o; o += tiles;
  L.v = o; o += tiles;
  // the combine's m, l and weights reuse the ring once the pages are done
  const size_t comb = (sizeof(float) * (2 * (size_t)d.n_splits + 1) * d.g + 15) / 16 * 16;
  o = o > comb ? o : comb;
  L.q = o; o += (size_t)d.g * L.units * (quant ? 16 : 64 / elem);
  L.s = o; o += sizeof(float) * (size_t)d.g * d.chunk * d.bs;
  L.red = o; o += sizeof(float) * (size_t)d.chunk * kWarps * d.g * d.hd;
  L.acc = o; o += sizeof(float) * (size_t)d.g * d.hd;
  // m, l, q scale, a correction per page; B3: the 256 quotients k / 255
  L.stat = o; o += sizeof(float) * ((size_t)d.g * (3 + d.chunk) + (quant ? 256 : 0));
  L.pages = o; o += sizeof(int) * (size_t)L.max_pages * (quant ? 3 : 1);
  L.total = o;
  return L;
}

// Workspace (f32): m and l (n_parts each), then acc
// (n_parts * hd); n_parts = B * nkv * S * g.
__host__ __device__ inline size_t n_parts(int batch, const Dims& d) {
  return (size_t)batch * d.nkv * d.n_splits * d.g;
}

// Scale, softcap and length-mask one score (the reference's order).
__device__ __forceinline__ float finish_score(float s, int pos, int len, const Dims& d) {
  s = __fdiv_rn(s, d.sqrt_hd);
  if (d.has_cap) s = __fmul_rn(d.cap, tanhf(__fdiv_rn(s, d.cap)));
  return pos < len ? s : -INFINITY;
}

// This block's split: pages [first, first + n) of row b's table.
struct Split {
  int kvh, b, s, len, first, n;
};

// Split s of a row of `len` tokens: pages [s * per, (s + 1) * per) of its
// ceil(len / bs) (at most the table's width), per = ceil(pages / S).
__device__ __forceinline__ Split split_of(int kvh, int b, int s, int len, const Dims& d) {
  int n_pages = (len + d.bs - 1) / d.bs;
  n_pages = n_pages < 0 ? 0 : (n_pages > d.n_cols ? d.n_cols : n_pages);
  const int per = (n_pages + d.n_splits - 1) / d.n_splits;
  const int first = min(n_pages, s * per);
  return Split{kvh, b, s, len, first, min(n_pages, first + per) - first};
}

// Table entries read ahead, before the row's length is known: thread t
// holds columns t + k * kThreads, k < kAhead (the first 512 columns).
constexpr int kAhead = 4;

__device__ __forceinline__ void read_ahead(int (&ahead)[kAhead], const int* table, int b,
                                           const Dims& d, int tid) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int j = tid + k * kThreads;
    ahead[k] = j < d.n_cols ? table[(size_t)b * d.n_cols + j] : 0;
  }
}

__device__ __forceinline__ int clamp_page(int page, const Dims& d) {
  return page < d.nb - 1 ? (page < 0 ? 0 : page) : d.nb - 1;
}

// The split's page ids, clamped to nb - 1 as the TPU index map does (idle
// slots hold the sentinel nb): from the read-ahead, else from the table.
__device__ __forceinline__ void fill_pages(int* pages_s, const int (&ahead)[kAhead],
                                           const int* table, const Split& sp, const Dims& d,
                                           int tid) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int j = tid + k * kThreads;
    if (j >= sp.first && j < sp.first + sp.n) pages_s[j - sp.first] = clamp_page(ahead[k], d);
  }
  for (int i = tid; i < sp.n; i += kThreads)
    if (sp.first + i >= kAhead * kThreads)
      pages_s[i] = clamp_page(table[(size_t)sp.b * d.n_cols + sp.first + i], d);
}

// Stage `n` pages (ids in pages_s) of one kv head into consecutive tiles at
// dst: cp.async by 16-byte units when d.vec, else element by element with
// the row's tail zeroed. R is the raw element type.
template <typename R>
__device__ __forceinline__ void stage_pages(char* dst, const R* src, const int* pages_s, int n,
                                            int kvh, const Layout& L, const Dims& d, int tid) {
  const size_t row_stride = (size_t)d.nkv * d.hd;
  const size_t page_stride = (size_t)d.bs * row_stride;
  if (d.vec) {
    const int per_page = d.bs * L.units;
    for (int i = tid; i < n * per_page; i += kThreads) {
      const int j = i / per_page, r = (i - j * per_page) / L.units, u = i % L.units;
      const R* row = src + (size_t)pages_s[j] * page_stride + (size_t)r * row_stride +
                     (size_t)kvh * d.hd;
      cp_async16(dst + j * L.tile + r * L.pitch + u * 16,
                 reinterpret_cast<const char*>(row) + u * 16);
    }
  } else {
    const int per_row = L.units * 16 / (int)sizeof(R);
    const int per_page = d.bs * per_row;
    for (int i = tid; i < n * per_page; i += kThreads) {
      const int j = i / per_page, r = (i - j * per_page) / per_row, x = i % per_row;
      const R* row = src + (size_t)pages_s[j] * page_stride + (size_t)r * row_stride +
                     (size_t)kvh * d.hd;
      reinterpret_cast<R*>(dst + j * L.tile + r * L.pitch)[x] = x < d.hd ? row[x] : R(0);
    }
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {  // 8 bf16
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {  // 4 f32
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// Scores of the chunk's n pages (staged K at k_tiles) into s_s (g rows of
// chunk * bs). Float pages: q_s holds q in f32, `units * 16 / sizeof(T)`
// per head, zero past hd.
template <typename T, int G>
__device__ __forceinline__ void scores_float(const char* k_tiles, const float* q_s, float* s_s,
                                             int n, int pos0, int len, const Layout& L,
                                             const Dims& d, int tid) {
  constexpr int kEpu = 16 / sizeof(T);
  const int tpp = L.tpp, sub = tid % tpp, qpitch = L.units * kEpu, row = d.chunk * d.bs;
  for (int c0 = 0; c0 < n * d.bs; c0 += kThreads / tpp) {
    const int c = c0 + tid / tpp;  // position in the chunk
    float dot[G];
#pragma unroll
    for (int h = 0; h < G; ++h) dot[h] = 0.f;
    if (c < n * d.bs) {
      const int j = c / d.bs, t = c - j * d.bs;
      const uint4* krow = reinterpret_cast<const uint4*>(k_tiles + j * L.tile + t * L.pitch);
      for (int u = sub; u < L.units; u += tpp) {
        float kf[kEpu];
        unpack(krow[u], kf);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h < d.g) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + h * qpitch + u * kEpu);
#pragma unroll
            for (int e = 0; e < kEpu / 4; ++e) {
              const float4 qq = qv[e];
              dot[h] = fmaf(qq.x, kf[4 * e], dot[h]);
              dot[h] = fmaf(qq.y, kf[4 * e + 1], dot[h]);
              dot[h] = fmaf(qq.z, kf[4 * e + 2], dot[h]);
              dot[h] = fmaf(qq.w, kf[4 * e + 3], dot[h]);
            }
          }
        }
      }
    }
    for (int o = tpp >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < G; ++h) dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
    }
    if (c < n * d.bs) {
#pragma unroll
      for (int h = 0; h < G; ++h)
        if (h < d.g && h % tpp == sub) s_s[h * row + c] = finish_score(dot[h], pos0 + c, len, d);
    }
  }
}

// Integer scores (dp4a over packed codes; qw_s holds units * 4 words per
// head, zero past hd). Raises wm_qk over valid positions when kTrack.
template <int G, bool kTrack>
__device__ __forceinline__ void scores_int8(const char* k_tiles, const int* qw_s,
                                            const float* qscale_s, const float* kscale_s,
                                            float* s_s, int n, int pos0, int len, int& wm_qk,
                                            const Layout& L, const Dims& d, int tid) {
  const int tpp = L.tpp, sub = tid % tpp, qpitch = L.units * 4, row = d.chunk * d.bs;
  for (int c0 = 0; c0 < n * d.bs; c0 += kThreads / tpp) {
    const int c = c0 + tid / tpp;
    const int j = c / d.bs, t = c - j * d.bs;
    int dot[G];
#pragma unroll
    for (int h = 0; h < G; ++h) dot[h] = 0;
    if (c < n * d.bs) {
      const int4* krow = reinterpret_cast<const int4*>(k_tiles + j * L.tile + t * L.pitch);
      for (int u = sub; u < L.units; u += tpp) {
        const int4 kv = krow[u];
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h < d.g) {
            const int4 qq = reinterpret_cast<const int4*>(qw_s + h * qpitch)[u];
            dot[h] = __dp4a(kv.x, qq.x, dot[h]);
            dot[h] = __dp4a(kv.y, qq.y, dot[h]);
            dot[h] = __dp4a(kv.z, qq.z, dot[h]);
            dot[h] = __dp4a(kv.w, qq.w, dot[h]);
          }
        }
      }
    }
    for (int o = tpp >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < G; ++h) dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
    }
    if (c < n * d.bs) {
      const int pos = pos0 + c;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h < d.g && h % tpp == sub) {
          if (kTrack && pos < len) wm_qk = max(wm_qk, abs(dot[h]));
          const float s = __fmul_rn(__fmul_rn(__int2float_rn(dot[h]), qscale_s[h]), kscale_s[j]);
          s_s[h * row + c] = finish_score(s, pos, len, d);
        }
      }
    }
  }
}

// B2's softmax over a chunk of n pages, one warp per head: one maximum for
// the chunk; corr_s[h][0] = the chunk's correction, corr_s[h][j > 0] = 1.
__device__ __forceinline__ void softmax_chunk_float(float* s_s, float* m_s, float* l_s,
                                                    float* corr_s, int n, int lane, int warp,
                                                    const Dims& d) {
  const int row = d.chunk * d.bs, cnt = n * d.bs;
  for (int h = warp; h < d.g; h += kWarps) {
    float* sr = s_s + h * row;
    float mx = -INFINITY;
    for (int c = lane; c < cnt; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max(mx);
    const float m_prev = m_s[h];
    const float m_new = fmaxf(m_prev, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float sum = 0.f;
    for (int c = lane; c < cnt; c += 32) {
      const float p = expf(__fsub_rn(sr[c], m_safe));  // masked: exp(-inf) = 0
      sum += p;
      sr[c] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = isfinite(m_prev) ? expf(__fsub_rn(m_prev, m_safe)) : 0.f;
      l_s[h] = __fadd_rn(__fmul_rn(l_s[h], corr), sum);
      m_s[h] = m_new;
    }
    for (int j = lane; j < n; j += 32)
      corr_s[h * d.chunk + j] = j == 0 ? (isfinite(m_prev) ? expf(__fsub_rn(m_prev, m_safe)) : 0.f)
                                       : 1.f;
  }
}

// B3's softmax over a chunk, page by page in table order (the sequential
// recurrence), one warp per head: the page's maximum, the running maximum,
// the probability codes rint(p * 255), their sum of code / 255 (from
// inv_s, the 256 quotients __fdiv_rn(k, 255)) and l.
__device__ __forceinline__ void softmax_chunk_int8(float* s_s, float* m_s, float* l_s,
                                                   float* corr_s, const float* inv_s, int n,
                                                   int lane, int warp, const Dims& d) {
  const int row = d.chunk * d.bs;
  for (int h = warp; h < d.g; h += kWarps) {
    float m = m_s[h], l = l_s[h];
    for (int j = 0; j < n; ++j) {
      float* sr = s_s + h * row + j * d.bs;
      float mx = -INFINITY;
      for (int t = lane; t < d.bs; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int t = lane; t < d.bs; t += 32) {
        const float p = rintf(__fmul_rn(expf(__fsub_rn(sr[t], m_safe)), 255.f));
        sum += inv_s[(int)p];
        sr[t] = p;
      }
      sum = warp_sum(sum);
      const float corr = isfinite(m) ? expf(__fsub_rn(m, m_safe)) : 0.f;
      l = __fadd_rn(__fmul_rn(l, corr), sum);
      m = m_new;
      if (lane == 0) corr_s[h * d.chunk + j] = corr;
    }
    if (lane == 0) {
      m_s[h] = m;
      l_s[h] = l;
    }
  }
}

// PV partials of each page of the chunk: warps split the page's positions,
// each lane takes columns x and x + 32; red_s[j][warp][h][x]. V is the
// staged element type, A the accumulator (float, or int for B3's codes).
template <typename V, typename A, int G>
__device__ __forceinline__ void pv_partials(const char* v_tiles, const float* s_s, A* red_s,
                                            int n, int pos0, int len, const Layout& L,
                                            const Dims& d, int lane, int warp) {
  const int row = d.chunk * d.bs, gh = d.g * d.hd;
  for (int j = 0; j < n; ++j) {
    const int t_end = min(d.bs, len - pos0 - j * d.bs);
    const char* vt = v_tiles + j * L.tile;
    const float* sp = s_s + j * d.bs;
    for (int x0 = 0; x0 < d.hd; x0 += 64) {
      const int xa = x0 + lane, xb = xa + 32;
      A pa[G], pb[G];
#pragma unroll
      for (int h = 0; h < G; ++h) pa[h] = pb[h] = A(0);
      for (int t = warp; t < t_end; t += kWarps) {
        const V* vr = reinterpret_cast<const V*>(vt + t * L.pitch);
        const auto va = load_v(vr + min(xa, d.hd - 1)), vb = load_v(vr + min(xb, d.hd - 1));
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h < d.g) {
            const float p = sp[h * row + t];
            pa[h] = pv_term(p, va, pa[h]);
            pb[h] = pv_term(p, vb, pb[h]);
          }
        }
      }
      A* red = red_s + (size_t)(j * kWarps + warp) * gh;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h < d.g) {
          if (xa < d.hd) red[h * d.hd + xa] = pa[h];
          if (xb < d.hd) red[h * d.hd + xb] = pb[h];
        }
      }
    }
  }
}

// Fold the chunk's PV partials into acc, page by page in order:
// acc = acc * corr_j + pv_j; B3 drains pv_int_j * v_drain_j and raises wm_pv.
template <bool kQuant>
__device__ __forceinline__ void drain(const void* red, float* acc_s, const float* corr_s,
                                      const float* vdrain_s, int n, int& wm_pv, const Dims& d,
                                      int tid) {
  const int gh = d.g * d.hd;
  for (int i = tid; i < gh; i += kThreads) {
    const int h = i / d.hd;
    float a = acc_s[i];
    for (int j = 0; j < n; ++j) {
      float pv;
      if (kQuant) {
        const int* r = static_cast<const int*>(red) + (size_t)j * kWarps * gh + i;
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += r[w * gh];
        wm_pv = max(wm_pv, abs(s));
        pv = __fmul_rn(__int2float_rn(s), vdrain_s[j]);
      } else {
        const float* r = static_cast<const float*>(red) + (size_t)j * kWarps * gh + i;
        pv = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) pv += r[w * gh];
      }
      a = __fadd_rn(__fmul_rn(a, corr_s[h * d.chunk + j]), pv);
    }
    acc_s[i] = a;
  }
}

// Per-head symmetric quantization of the group's q rows into packed codes
// (units * 16 bytes per head, zero past hd) and their scales.
template <typename T>
__device__ __forceinline__ void quantize_q(const T* q, int8_t* qc_s, float* qscale_s,
                                           const Layout& L, const Dims& d, int lane, int warp) {
  for (int h = warp; h < d.g; h += kWarps) {
    const T* qh = q + (size_t)h * d.hd;
    float amax = 0.f;
    for (int x = lane; x < d.hd; x += 32) amax = fmaxf(amax, fabsf(load_f(qh + x)));
    amax = warp_max(amax);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    for (int x = lane; x < L.units * 16; x += 32) {
      float c = 0.f;
      if (x < d.hd) c = fminf(fmaxf(rintf(__fdiv_rn(load_f(qh + x), scale)), -127.f), 127.f);
      qc_s[h * L.units * 16 + x] = (int8_t)c;
    }
    if (lane == 0) qscale_s[h] = scale;
  }
}

// Splits that hold pages of a row of `len` tokens (the others are neutral).
__device__ __forceinline__ int busy_splits(int len, const Dims& d) {
  int n_pages = (len + d.bs - 1) / d.bs;
  n_pages = n_pages < 0 ? 0 : (n_pages > d.n_cols ? d.n_cols : n_pages);
  const int per = (n_pages + d.n_splits - 1) / d.n_splits;
  return per ? (n_pages + per - 1) / per : 0;
}

// Write this split's partial, then let the last split of the (slot, kv
// head) to finish combine the busy splits' partials into the output: their
// m and l into shared memory in one round trip, one warp per head for the
// maximum M, the weights e^(m_s - M) and the sum of l_s * w_s, then each
// output sums acc_s * w_s with the loads of several splits in flight. The
// last block resets the row's counters (done, and B3's ticket) and B3's
// flags of the row (`flags`, NULL for B2) to 0; every other block of the row
// has read its flags before it counted itself done.
template <typename T>
__device__ __forceinline__ void finish_split(const float* m_s, const float* l_s,
                                             const float* acc_s, char* smem, float* ws,
                                             int* sync, unsigned long long* flags, T* out,
                                             const Split& sp, const Dims& d, int tid) {
  __shared__ int last;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t np = n_parts(gridDim.y, d);
  float* ws_m = ws;
  float* ws_l = ws + np;
  float* ws_acc = ws + 2 * np;
  const int row = sp.b * d.nkv + sp.kvh, rows = gridDim.y * d.nkv;
  const size_t base = (size_t)row * d.n_splits * d.g;  // split 0 of this row
  const size_t part = base + (size_t)sp.s * d.g;
  for (int h = tid; h < d.g; h += kThreads) {
    ws_m[part + h] = m_s ? m_s[h] : -INFINITY;
    ws_l[part + h] = l_s ? l_s[h] : 0.f;
  }
  for (int i = tid; i < d.g * d.hd; i += kThreads) ws_acc[part * d.hd + i] = acc_s ? acc_s[i] : 0.f;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(sync + row, 1) == d.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int busy = busy_splits(sp.len, d), n = busy * d.g;
  float* w_s = reinterpret_cast<float*>(smem);  // (busy, g): m, then the weights
  float* lw_s = w_s + n;                         // (busy, g): l
  float* den_s = lw_s + n;                       // (g)
  for (int k = tid; k < n; k += kThreads) {
    w_s[k] = __ldcg(ws_m + base + k);
    lw_s[k] = __ldcg(ws_l + base + k);
  }
  __syncthreads();
  for (int h = warp; h < d.g; h += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < busy; s += 32) mx = fmaxf(mx, w_s[s * d.g + h]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < busy; s += 32) {
      const float ms = w_s[s * d.g + h];
      const float w = isfinite(ms) ? expf(__fsub_rn(ms, mx)) : 0.f;
      w_s[s * d.g + h] = w;
      den = __fadd_rn(den, __fmul_rn(lw_s[s * d.g + h], w));
    }
    den = warp_sum(den);
    if (lane == 0) den_s[h] = fmaxf(den, 1e-20f);
  }
  __syncthreads();
  for (int i = tid; i < d.g * d.hd; i += kThreads) {
    const int h = i / d.hd;
    const float* acc = ws_acc + base * d.hd + i;
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < busy; ++s)
      num = __fadd_rn(num, __fmul_rn(__ldcg(acc + (size_t)s * d.g * d.hd), w_s[s * d.g + h]));
    store_f(out + (size_t)row * d.g * d.hd + i, __fdiv_rn(num, den_s[h]));
  }
  if (flags != nullptr)
    for (int k = tid; k < d.n_splits * d.g; k += kThreads) flags[k] = 0;
  if (tid == 0) {
    sync[row] = 0;
    sync[rows + row] = 0;
  }
}

// ---------------------------------------------------------------------------
// B2: float pages. T is q's (and the pages') type, R its raw storage.
// ---------------------------------------------------------------------------
template <typename T, typename R, int G>
__global__ void __launch_bounds__(kThreads)
    paged_attn_float_kernel(const T* __restrict__ q, const R* __restrict__ kp,
                            const R* __restrict__ vp, const int* __restrict__ table,
                            const int* __restrict__ lens, T* __restrict__ out, float* ws,
                            int* sync, Dims d) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = make_layout(d, sizeof(T), kFloat);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int ahead[kAhead];
  read_ahead(ahead, table, blockIdx.y, d, tid);
  const Split sp = split_of(blockIdx.x, blockIdx.y, blockIdx.z, lens[blockIdx.y], d);
  if (sp.n == 0) {  // past the row's pages: a neutral partial
    finish_split<T>(nullptr, nullptr, nullptr, smem, ws, sync, nullptr, out, sp, d, tid);
    return;
  }
  char* k_s = smem + L.k;
  char* v_s = smem + L.v;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.stat);
  float* l_s = m_s + d.g;
  float* corr_s = l_s + 2 * d.g;
  int* pages_s = reinterpret_cast<int*>(smem + L.pages);

  fill_pages(pages_s, ahead, table, sp, d, tid);
  __syncthreads();
  int unused = 0;
  int n = min(d.chunk, sp.n);
  stage_pages(k_s, kp, pages_s, n, sp.kvh, L, d, tid);  // the loads first, q while they fly
  cp_async_commit();
  stage_pages(v_s, vp, pages_s, n, sp.kvh, L, d, tid);
  cp_async_commit();
  const int qpitch = L.units * (16 / (int)sizeof(T));
  const T* qg = q + ((size_t)sp.b * d.nkv * d.g + (size_t)sp.kvh * d.g) * d.hd;
  for (int i = tid; i < d.g * qpitch; i += kThreads) {
    const int h = i / qpitch, x = i - h * qpitch;
    q_s[i] = x < d.hd ? load_f(qg + h * d.hd + x) : 0.f;
  }
  for (int i = tid; i < d.g * d.hd; i += kThreads) acc_s[i] = 0.f;
  for (int h = tid; h < d.g; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  for (int c = 0; c < sp.n; c += d.chunk) {
    n = min(d.chunk, sp.n - c);
    const int n_next = min(d.chunk, sp.n - c - n);
    const int pos0 = (sp.first + c) * d.bs;
    cp_async_wait_one();  // this chunk's K
    __syncthreads();
    scores_float<T, G>(k_s, q_s, s_s, n, pos0, sp.len, L, d, tid);
    __syncthreads();
    stage_pages(k_s, kp, pages_s + c + n, n_next, sp.kvh, L, d, tid);
    cp_async_commit();
    softmax_chunk_float(s_s, m_s, l_s, corr_s, n, lane, warp, d);
    cp_async_wait_one();  // this chunk's V
    __syncthreads();
    pv_partials<T, float, G>(v_s, s_s, red_s, n, pos0, sp.len, L, d, lane, warp);
    __syncthreads();
    stage_pages(v_s, vp, pages_s + c + n, n_next, sp.kvh, L, d, tid);
    cp_async_commit();
    drain<false>(red_s, acc_s, corr_s, nullptr, n, unused, d, tid);
  }
  __syncthreads();
  finish_split<T>(m_s, l_s, acc_s, smem, ws, sync, nullptr, out, sp, d, tid);
}

// Exact float max into shared memory: non-negative floats order as ints,
// negative ones in reverse as unsigned.
__device__ __forceinline__ void atomic_max_f(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// ---------------------------------------------------------------------------
// B3: int8 pages. Pass 1 finds the split's maximum of the finished scores
// (and the P_qk watermark) and publishes it; the block then takes the
// maximum over the splits before it (in table order), waiting for each one's
// flag, and runs pass 2, the sequential recurrence from that maximum, and
// the combine. A block takes its split index as a ticket in the order the
// blocks start, so every split it waits for belongs to a block that is
// already running and waits only on splits before its own: no block can
// wait forever. A published flag is nonzero (bit 32 set above the float's
// bits); the row's last block resets the row's flags to 0 in finish_split.
// ---------------------------------------------------------------------------
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    paged_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kp,
                           const int8_t* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ table,
                           const int* __restrict__ lens, T* __restrict__ out, float* ws,
                           int* sync, unsigned long long* flags, int* wm, Dims d) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int ticket;
  const Layout L = make_layout(d, 1, kInt8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y * d.nkv + blockIdx.x, rows = gridDim.y * d.nkv;
  int ahead[kAhead];
  read_ahead(ahead, table, blockIdx.y, d, tid);
  const int len = lens[blockIdx.y];
  if (tid == 0) ticket = atomicAdd(sync + rows + row, 1);
  __syncthreads();
  if (ticket >= d.n_splits) __trap();  // a counter not left at 0
  const Split sp = split_of(blockIdx.x, blockIdx.y, ticket, len, d);  // the split is the ticket
  flags += (size_t)row * d.n_splits * d.g;
  if (sp.n == 0) {
    // past the row's pages (these splits come after every busy one)
    finish_split<T>(nullptr, nullptr, nullptr, smem, ws, sync, flags, out, sp, d, tid);
    return;
  }
  char* k_s = smem + L.k;
  char* v_s = smem + L.v;
  int8_t* qc_s = reinterpret_cast<int8_t*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  int* red_s = reinterpret_cast<int*>(smem + L.red);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.stat);
  float* l_s = m_s + d.g;
  float* qscale_s = l_s + d.g;
  float* corr_s = qscale_s + d.g;
  float* inv_s = corr_s + d.g * d.chunk;
  int* pages_s = reinterpret_cast<int*>(smem + L.pages);
  float* kscale_s = reinterpret_cast<float*>(pages_s + L.max_pages);
  float* vdrain_s = kscale_s + L.max_pages;

  fill_pages(pages_s, ahead, table, sp, d, tid);
  __syncthreads();
  // pass 1: the split's maximum; one chunk keeps its scores for pass 2. The
  // loads first, the scales and q while they fly.
  const bool one_chunk = sp.n <= d.chunk;
  stage_pages(k_s, kp, pages_s, min(d.chunk, sp.n), sp.kvh, L, d, tid);
  cp_async_commit();
  if (one_chunk) stage_pages(v_s, vp, pages_s, sp.n, sp.kvh, L, d, tid);
  cp_async_commit();
  for (int i = tid; i < sp.n; i += kThreads) {
    kscale_s[i] = ks[(size_t)pages_s[i] * d.nkv + sp.kvh];
    vdrain_s[i] = __fdiv_rn(vs[(size_t)pages_s[i] * d.nkv + sp.kvh], 255.f);
  }
  quantize_q(q + (size_t)row * d.g * d.hd, qc_s, qscale_s, L, d, lane, warp);
  for (int h = tid; h < d.g; h += kThreads) m_s[h] = -INFINITY;
  for (int i = tid; i < d.g * d.hd; i += kThreads) acc_s[i] = 0.f;
  for (int k = tid; k < 256; k += kThreads) inv_s[k] = __fdiv_rn((float)k, 255.f);
  const int* qw_s = reinterpret_cast<const int*>(qc_s);
  const int srow = d.chunk * d.bs;
  int wm_qk = 0, wm_pv = 0, unused = 0;
  for (int c = 0; c < sp.n; c += d.chunk) {
    const int n = min(d.chunk, sp.n - c);
    if (c > 0) {
      __syncthreads();  // the previous chunk's scores and maxima are done
      stage_pages(k_s, kp, pages_s + c, n, sp.kvh, L, d, tid);
      cp_async_commit();
      cp_async_wait_all();
    } else {
      cp_async_wait_one();  // K (V of a single chunk may still be in flight)
    }
    __syncthreads();
    scores_int8<G, true>(k_s, qw_s, qscale_s, kscale_s + c, s_s, n, (sp.first + c) * d.bs,
                         sp.len, wm_qk, L, d, tid);
    __syncthreads();
    for (int h = warp; h < d.g; h += kWarps) {
      float mx = -INFINITY;
      for (int i = lane; i < n * d.bs; i += 32) mx = fmaxf(mx, s_s[h * srow + i]);
      mx = warp_max(mx);
      if (lane == 0) m_s[h] = fmaxf(m_s[h], mx);
    }
  }
  __syncthreads();
  // publish the split's maximum per head, with bit 32 set so that the word
  // is nonzero, then gather the maxima of the splits before
  for (int h = tid; h < d.g; h += kThreads)
    atomicExch(flags + sp.s * d.g + h, 1ull << 32 | __float_as_uint(m_s[h]));
  __syncthreads();
  for (int h = tid; h < d.g; h += kThreads) m_s[h] = -INFINITY;
  __syncthreads();
  for (int k = tid; k < sp.s * d.g; k += kThreads) {
    const volatile unsigned long long* flag = flags + k;
    unsigned long long v;
    for (long long spin = 0; (v = *flag) == 0; ++spin)
      if (spin > (1ll << 32)) __trap();  // never: every split before this one is running
    atomic_max_f(m_s + k % d.g, __uint_as_float((unsigned)v));
  }
  for (int h = tid; h < d.g; h += kThreads) l_s[h] = 0.f;
  __syncthreads();

  // pass 2: the recurrence over the split's pages in table order
  for (int c = 0; c < sp.n; c += d.chunk) {
    const int n = min(d.chunk, sp.n - c);
    const int pos0 = (sp.first + c) * d.bs;
    if (!one_chunk) {
      stage_pages(k_s, kp, pages_s + c, n, sp.kvh, L, d, tid);
      stage_pages(v_s, vp, pages_s + c, n, sp.kvh, L, d, tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      scores_int8<G, false>(k_s, qw_s, qscale_s, kscale_s + c, s_s, n, pos0, sp.len, unused, L,
                            d, tid);
      __syncthreads();
    }
    softmax_chunk_int8(s_s, m_s, l_s, corr_s, inv_s, n, lane, warp, d);
    cp_async_wait_all();  // this chunk's V
    __syncthreads();
    pv_partials<int8_t, int, G>(v_s, s_s, red_s, n, pos0, sp.len, L, d, lane, warp);
    __syncthreads();
    drain<true>(red_s, acc_s, corr_s, vdrain_s + c, n, wm_pv, d, tid);
    __syncthreads();
  }
  if (wm != nullptr) {
    wm_qk = warp_imax(wm_qk);
    wm_pv = warp_imax(wm_pv);
    if (lane == 0) {
      atomicMax(wm, wm_qk);
      atomicMax(wm + 1, wm_pv);
    }
  }
  finish_split<T>(m_s, l_s, acc_s, smem, ws, sync, flags, out, sp, d, tid);
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The launch's dims: the chunk is kChunkPositions / bs pages (1 to
// kMaxChunk), halved until the block's layout fits.
Dims make_dims(int bs, int nkv, int g, int hd, int n_cols, int n_splits, int elem, int quantized,
               float sqrt_hd, float cap, int has_cap) {
  Dims d{0, bs, nkv, g, hd, n_cols, n_splits, 1, 0, sqrt_hd, cap, has_cap};
  int chunk = kChunkPositions / bs;
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  for (d.chunk = chunk; d.chunk > 1; d.chunk /= 2)
    if (make_layout(d, elem, quantized ? kInt8 : kFloat).total <= kSmemLimit) break;
  return d;
}

template <typename T, int G>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const void* ks,
                         const void* vs, const void* table, const void* lens, void* out, void* wm,
                         void* ws, void* sync, void* flags, int batch, const Dims& d,
                         int quantized, cudaStream_t st) {
  const dim3 grid(d.nkv, batch, d.n_splits);
  cudaError_t err;
  if (quantized) {
    const size_t smem = make_layout(d, 1, kInt8).total;
    auto k = paged_attn_int8_kernel<T, G>;
    if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
    k<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(table), static_cast<const int*>(lens), static_cast<T*>(out),
        static_cast<float*>(ws), static_cast<int*>(sync),
        static_cast<unsigned long long*>(flags),
        static_cast<int*>(wm), d);
  } else {
    using R = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
    const size_t smem = make_layout(d, sizeof(T), kFloat).total;
    auto k = paged_attn_float_kernel<T, R, G>;
    if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
    k<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const R*>(kp), static_cast<const R*>(vp),
        static_cast<const int*>(table), static_cast<const int*>(lens), static_cast<T*>(out),
        static_cast<float*>(ws), static_cast<int*>(sync), d);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block (bytes), for the wrapper's check; `elem` is
// the page element's size in bytes.
size_t paged_attention_smem_bytes(int g, int hd, int bs, int elem, int quantized, int n_cols,
                                  int n_splits) {
  const Dims d = make_dims(bs, 1, g, hd, n_cols, n_splits, elem, quantized, 1.f, 0.f, 0);
  return make_layout(d, elem, quantized ? kInt8 : kFloat).total;
}

// Bytes of the f32 workspace one call needs (the splits' partials).
size_t paged_attention_workspace_bytes(int batch, int nkv, int g, int hd, int n_splits) {
  Dims d{};
  d.nkv = nkv;
  d.g = g;
  d.n_splits = n_splits;
  return sizeof(float) * n_parts(batch, d) * (2 + (size_t)hd);
}

// Entries of the two synchronization buffers: `sync` (int32), per (slot,
// kv head) a done counter and a ticket, which every call leaves at 0;
// `flags` (B3, 64-bit), per split and head the split's published maximum,
// which every call's last block of the row resets to 0 too. The wrapper
// zeroes both once.
size_t paged_attention_sync_ints(int batch, int nkv) { return (size_t)2 * batch * nkv; }
size_t paged_attention_flag_words(int batch, int nkv, int g, int n_splits) {
  return (size_t)batch * nkv * n_splits * g;
}

// q (B, nkv*g, hd) and out (same shape) in bf16 (dtype_bf16 = 1) or f32;
// k/v pages (nb, bs, nkv, hd) in q's type (quantized = 0) or int8 with
// k/v scales (nb, nkv) f32 (quantized = 1); table (B, n_cols) int32;
// lens (B,) int32; wm NULL or two int32 watermarks (quantized only); ws
// the workspace (paged_attention_workspace_bytes); sync and flags the
// synchronization buffers (paged_attention_sync_ints, _flag_words; zero on
// first use, and every call leaves them zero). All contiguous on one
// device. n_splits splits per row. Returns the CUDA error of the launch.
int paged_attention_launch(const void* q, const void* kp, const void* vp, const void* ks,
                           const void* vs, const void* table, const void* lens, void* out,
                           void* wm, void* ws, void* sync, void* flags, int batch, int nb, int bs,
                           int nkv, int g, int hd, int n_cols, int n_splits, int dtype_bf16,
                           int quantized, float sqrt_hd, float cap, int has_cap, void* stream) {
  if (g < 1 || g > kMaxGroup || hd < 1 || bs < 1 || nb < 1 || n_cols < 1 || n_splits < 1 ||
      n_splits > 65535)
    return cudaErrorInvalidValue;
  const int elem = quantized ? 1 : (dtype_bf16 ? 2 : 4);
  Dims d = make_dims(bs, nkv, g, hd, n_cols, n_splits, elem, quantized, sqrt_hd, cap, has_cap);
  if (make_layout(d, elem, quantized ? kInt8 : kFloat).total > kSmemLimit)
    return cudaErrorInvalidValue;
  d.nb = nb;
  d.vec = (hd * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = decltype(&launch_typed<float, 4>);
  const Launch run = dtype_bf16
                         ? (g <= 4 ? launch_typed<__nv_bfloat16, 4>
                                   : launch_typed<__nv_bfloat16, kMaxGroup>)
                         : (g <= 4 ? launch_typed<float, 4> : launch_typed<float, kMaxGroup>);
  return (int)run(q, kp, vp, ks, vs, table, lens, out, wm, ws, sync, flags, batch, d,
                  quantized, st);
}

}  // extern "C"
