// K6: paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/decode_attention.py :: paged_decode_fwd
//           (Pallas body _decode_kernel) — one query row per sequence
//           attends its KV history in place through the page table, with
//           the query RoPE and the int8 KV dequant fused, dead pages
//           skipped, and an idle slot (length 0) giving exact zeros.
// Bound on the H100: device-memory bytes.  Each live K/V element is read
//           once for 2 flops (q.k) + 2 flops (p.v), a few flops per byte,
//           so the least time is the live K/V bytes / 3.35 TB/s.
// Design:   one 256-thread CTA per (sequence, head).  The CTA reads
//           lengths[b] and walks only ceil(length / page) entries of its
//           page-table row, so it touches exactly the live pages, in
//           place, with no gather.  Each of the eight warps takes every
//           eighth page with its own online-softmax state (m, l, acc);
//           the eight states merge through shared memory at the end.  In
//           a page, lane t scores token t (q . k over the head dim from
//           16-byte loads of its K row, q rotated once in f32 and held in
//           shared memory); the p.v sum then runs with lane d owning head
//           dims d, d+32, ... so the V rows are read coalesced.  int8 pages multiply by their per
//           (head, token) f32 scale.  Positions >= length weigh zero.
//           bf16, f32 and int8 pages; bf16 or f32 queries; head dims 32
//           and 64.  Not yet used: splitting a long sequence over
//           several CTAs (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// q . (one K row of D elements), the row read as 16-byte vectors.
template <typename KVT, int D>
__device__ __forceinline__ float dot_row(const float* qs, const KVT* row) {
  constexpr int kPerVec = 16 / sizeof(KVT);
  static_assert(D % kPerVec == 0, "a K row is a whole number of 16-byte vectors");
  const uint4* vrow = reinterpret_cast<const uint4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < D / kPerVec; ++i) {
    const uint4 raw = vrow[i];
    const KVT* vals = reinterpret_cast<const KVT*>(&raw);
#pragma unroll
    for (int j = 0; j < kPerVec; ++j) dot += qs[i * kPerVec + j] * to_f(vals[j]);
  }
  return dot;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                    const KVT* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ cos_rows,
                    const float* __restrict__ sin_rows, QT* __restrict__ out,
                    int heads, int page, int np, float scale) {
  constexpr int kDimsPerLane = (D + 31) / 32;
  __shared__ float qs[D];
  __shared__ float part_o[kWarps][D];
  __shared__ float part_m[kWarps];
  __shared__ float part_l[kWarps];

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (static_cast<size_t>(b) * heads + h) * D;

  // q in f32, rotated (rotate_half layout) when cos/sin rows are given
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float x = to_f(q[qoff + d]);
    if (cos_rows != nullptr) {
      const float r = d < D / 2 ? -to_f(q[qoff + d + D / 2]) : to_f(q[qoff + d - D / 2]);
      x = x * cos_rows[static_cast<size_t>(b) * D + d] +
          r * sin_rows[static_cast<size_t>(b) * D + d];
    }
    qs[d] = x;
  }
  __syncthreads();

  const int len = lengths[b];
  const int live_pages = min((len + page - 1) / page, np);
  float m = -INFINITY, l = 0.f;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int j = warp; j < live_pages; j += kWarps) {
    const int pid = table[static_cast<size_t>(b) * np + j];
    // row index of (pid, h, token 0) in the (P, H, page) row space
    const size_t base = (static_cast<size_t>(pid) * heads + h) * page;
    for (int t0 = 0; t0 < page; t0 += 32) {
      const int t = t0 + lane;
      float s = -INFINITY;
      if (t < page && j * page + t < len) {
        float dot = dot_row<KVT, D>(qs, kp + (base + t) * D);
        if (ks != nullptr) dot *= ks[base + t];
        s = dot * scale;
      }
      const float mx = warp_max(s);
      if (mx == -INFINITY) continue;  // the whole chunk is past `len`
      const float m_new = fmaxf(m, mx);
      const float alpha = __expf(m - m_new);
      const float p = __expf(s - m_new);
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= alpha;
      const int nt = min(32, page - t0);
      for (int tt = 0; tt < nt; ++tt) {
        const float pt = __shfl_sync(kFull, p, tt);
        if (pt == 0.f) continue;
        const size_t r = base + t0 + tt;
        const float w = vs != nullptr ? pt * vs[r] : pt;
        const KVT* vrow = vp + r * D;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] += w * to_f(vrow[d]);
        }
      }
      m = m_new;
    }
  }

  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) part_o[warp][d] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, part_m[w]);
    float ll = 0.f, oo = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = __expf(part_m[w] - mm);
        ll += part_l[w] * f;
        oo += part_o[w][d] * f;
      }
    }
    // an idle slot (length 0) walked no page: the contract is zeros
    out[qoff + d] = from_f<QT>(ll > 0.f ? oo / ll : 0.f);
  }
}

template <typename QT, typename KVT>
int launch_d(int d, dim3 grid, cudaStream_t s, const void* q, const void* kp,
             const void* vp, const void* ks, const void* vs, const void* table,
             const void* lengths, const void* cos_rows, const void* sin_rows,
             void* out, int heads, int page, int np, float scale) {
#define APEX_DECODE_CASE(DIM)                                                 \
  case DIM:                                                                   \
    paged_decode_kernel<QT, KVT, DIM><<<grid, kThreads, 0, s>>>(              \
        static_cast<const QT*>(q), static_cast<const KVT*>(kp),               \
        static_cast<const KVT*>(vp), static_cast<const float*>(ks),           \
        static_cast<const float*>(vs), static_cast<const int*>(table),        \
        static_cast<const int*>(lengths), static_cast<const float*>(cos_rows),\
        static_cast<const float*>(sin_rows), static_cast<QT*>(out), heads,    \
        page, np, scale);                                                     \
    break;
  switch (d) {
    APEX_DECODE_CASE(32)
    APEX_DECODE_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef APEX_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(int kv_dtype, int d, dim3 grid, cudaStream_t s, const void* q,
              const void* kp, const void* vp, const void* ks, const void* vs,
              const void* table, const void* lengths, const void* cos_rows,
              const void* sin_rows, void* out, int heads, int page, int np,
              float scale) {
  switch (kv_dtype) {
    case 0:
      return launch_d<QT, float>(d, grid, s, q, kp, vp, ks, vs, table, lengths,
                                 cos_rows, sin_rows, out, heads, page, np, scale);
    case 1:
      return launch_d<QT, bf16>(d, grid, s, q, kp, vp, ks, vs, table, lengths,
                                cos_rows, sin_rows, out, heads, page, np, scale);
    case 2:
      return launch_d<QT, int8_t>(d, grid, s, q, kp, vp, ks, vs, table, lengths,
                                  cos_rows, sin_rows, out, heads, page, np, scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, H, D) and out (B, H, D) in q_dtype (0 f32, 1 bf16); k/v pages
// (P, H, page, D) in kv_dtype (0 f32, 1 bf16, 2 int8, the latter with f32
// scales (P, H, page)); table (B, NP) and lengths (B,) int32; cos/sin rows
// (B, D) f32 or null.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* table,
                            const void* lengths, const void* cos_rows,
                            const void* sin_rows, void* out, int batch,
                            int heads, int d, int page, int np, float scale,
                            int q_dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || page <= 0 || np <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(batch) * heads);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, d, grid, s, q, kp, vp, ks, vs, table,
                            lengths, cos_rows, sin_rows, out, heads, page, np,
                            scale);
  if (q_dtype == 1)
    return launch_kv<bf16>(kv_dtype, d, grid, s, q, kp, vp, ks, vs, table,
                           lengths, cos_rows, sin_rows, out, heads, page, np,
                           scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
