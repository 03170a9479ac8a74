// K6: paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/decode_attention.py :: paged_decode_fwd
//           (Pallas body _decode_kernel) — one query row per sequence
//           attends its KV history in place through the page table, with
//           the query RoPE and the int8 KV dequant fused, dead pages
//           skipped, and an idle slot (length 0) giving exact zeros.
// Bound on the H100: device-memory bytes.  Each live K/V element is read
//           once for 2 flops (q.k) + 2 flops (p.v), a few flops per byte,
//           so the least time is the live K/V bytes / 3.35 TB/s.  What
//           keeps a kernel from it is latency: a decode batch is a few
//           sequences of very different lengths, and one CTA that walks a
//           2048-token history page after page waits on each page in turn.
// Design:   split-KV.  The grid is fixed by the shapes alone (the wrapper's
//           plan, ops/paged_attention.py decode_split_plan, never reads
//           the lengths on the host): one 128-thread CTA per (sequence,
//           head, split), a split being `split_pages` consecutive entries
//           of the page table, split-major.  A CTA reads lengths[b] and
//           exits at once when its split lies past the sequence's live
//           pages, so the work follows the lengths and a long sequence is
//           spread over many CTAs, each walking a few pages; split-major,
//           the live CTAs fill the first wave and the dead ones trail.  Per head, not per
//           sequence over all heads: a page's (H, page, D) block outgrows
//           shared memory at wide D or f32 pages, and per-token addressing
//           lets a tile cross page boundaries at any page size.  A CTA
//           walks its tokens in tiles of up to 32 (fewer at wide rows, so
//           that two stages fit): the tile's K and V rows (and their int8
//           scales) stream through a two-stage shared-memory ring filled by
//           cp.async (16-byte copies where a row is a multiple of 16 bytes,
//           4-byte ones where it is a multiple of 4, else element copies;
//           rows past the length zero-filled), so the next tile's loads
//           overlap this tile's math.  Every lane works: 128 / tile lanes
//           score each token (q . k over strided head dims, shuffle-reduced),
//           one warp runs the online softmax over the tile's scores, and
//           the p.v sum runs with thread t owning head dims t, t + 128, ...
//           (the V rows read contiguously).  Shared-memory rows are padded
//           to a multiple of 128 bytes plus 16, so the 8 token rows a warp
//           scores fall on distinct banks.  q is rotated once in f32 (the
//           rotate-half RoPE pairs dim i with i + d/2 of the real d) and
//           kept in shared memory with the accumulator row, which makes any
//           head dim one instance, unpadded (padding would copy the page
//           pool, which is the KV cache).  A sequence with one live split
//           writes its output directly.  With several, each split writes
//           its f32 (m, l, acc) to a workspace the wrapper allocates, then
//           takes a ticket from an integer arrival counter per (sequence,
//           head) (atom.add, whose result it reads: no float atomics, no
//           red.); the CTA that arrives last merges the splits in split
//           order and resets the counter to 0 for the next launch, so the
//           output is the same bits from run to run and one launch does
//           it all.  bf16, f32 and int8 pages (per (head, token) f32
//           scales); bf16 or f32 queries.  Not yet used: TMA bulk copies of
//           whole pages, several heads a CTA, CUDA graphs around the decode
//           step (ROADMAP A2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;  // tokens a tile holds at most
constexpr int kStages = 2;
constexpr int kMaxSplits = 128;  // the plan's most splits a row
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes (16 or 4) from `src` to shared `dst`, or zeros when `in` is false.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// The shared-memory row stride of a K or V row of `row_bytes`: a multiple
// of 128 bytes plus 16, so consecutive rows start 4 banks apart.
__host__ __device__ inline int smem_row(int row_bytes) {
  return (row_bytes + 127) / 128 * 128 + 16;
}

// The floats before the ring: q and the accumulator row (d each, rounded
// up to 4), the tile's weights, each stage's K and V scales and the
// merge's weights of the splits.
__host__ __device__ inline int head_floats(int d) {
  return 2 * ((d + 3) / 4 * 4) + kMaxTile + 2 * kStages * kMaxTile +
         kMaxSplits;
}

__host__ inline size_t smem_bytes(int d, int row_bytes, int tile) {
  return sizeof(float) * head_floats(d) +
         size_t{kStages} * 2 * tile * smem_row(row_bytes);
}

// One (sequence, head, split) per CTA (see Design).  `vec` is the copy
// width in bytes (16, 4, or 0 for element copies); `tile` the tokens a
// stage holds (a power of two from 4 to 32).
template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                    const KVT* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ cos_rows,
                    const float* __restrict__ sin_rows, QT* __restrict__ out,
                    float* __restrict__ work, int* __restrict__ counters,
                    int heads, int d, int page, int np, float scale,
                    int split_pages, int n_split, int tile, int vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* acc = qs + (d + 3) / 4 * 4;
  float* wts = acc + (d + 3) / 4 * 4;         // the tile's scores, then p * v scale
  float* kscl = wts + kMaxTile;               // kStages x kMaxTile
  float* vscl = kscl + kStages * kMaxTile;    // kStages x kMaxTile
  float* split_w = vscl + kStages * kMaxTile; // kMaxSplits
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4) +
                        sizeof(float) * head_floats(d);
  __shared__ float sh_alpha, sh_m, sh_l;
  __shared__ int sh_last;

  // split-major: the first splits of every row (live unless the row is
  // empty) come first, and the splits past short rows, which exit at
  // once, last
  const int rows = static_cast<int>(gridDim.x) / n_split;
  const int split = static_cast<int>(blockIdx.x) / rows;
  const int bh = static_cast<int>(blockIdx.x) % rows;
  const int b = bh / heads, h = bh % heads;
  const int len = lengths[b];
  const int live_pages = min((len + page - 1) / page, np);
  const int n_live = max(1, (live_pages + split_pages - 1) / split_pages);
  if (split >= n_live) return;  // past the sequence: nothing to do
  const int tok0 = split * split_pages * page;
  const int tok_end = min(min(len, np * page), (split + 1) * split_pages * page);
  const int n_tiles = tok_end > tok0 ? (tok_end - tok0 + tile - 1) / tile : 0;
  const int row_bytes = d * static_cast<int>(sizeof(KVT));
  const int srow = smem_row(row_bytes);
  const int stage_bytes = 2 * tile * srow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = static_cast<size_t>(bh) * d;

  // the (P, H, page) row of token t of this sequence and head
  auto row_of = [&](int t) {
    const int pid = table[static_cast<size_t>(b) * np + t / page];
    return (static_cast<size_t>(pid) * heads + h) * page + t % page;
  };
  // tile `it`'s K and V rows (and scales) into stage it % kStages
  auto fill = [&](int it) {
    unsigned char* kdst = ring + (it % kStages) * stage_bytes;
    unsigned char* vdst = kdst + tile * srow;
    const int t0 = tok0 + it * tile;
    if (vec == 0) {
      const int n = tile * d;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / d, c = i % d;
        const bool in = t0 + r < tok_end;
        const size_t row = in ? row_of(t0 + r) : 0;
        reinterpret_cast<KVT*>(kdst + r * srow)[c] =
            in ? kp[row * d + c] : KVT{};
        reinterpret_cast<KVT*>(vdst + r * srow)[c] =
            in ? vp[row * d + c] : KVT{};
      }
    } else {
      const int per_row = row_bytes / vec;
      const int n = tile * per_row;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / per_row, c = (i % per_row) * vec;
        const bool in = t0 + r < tok_end;
        const size_t off = (in ? row_of(t0 + r) : 0) * row_bytes + c;
        const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(kp) + off;
        const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(vp) + off;
        if (vec == 16) {
          cp_async<16>(kdst + r * srow + c, ksrc, in);
          cp_async<16>(vdst + r * srow + c, vsrc, in);
        } else {
          cp_async<4>(kdst + r * srow + c, ksrc, in);
          cp_async<4>(vdst + r * srow + c, vsrc, in);
        }
      }
    }
    if (ks != nullptr && threadIdx.x < tile) {
      const int r = threadIdx.x;
      const bool in = t0 + r < tok_end;
      const size_t row = in ? row_of(t0 + r) : 0;
      const int s = (it % kStages) * kMaxTile + r;
      cp_async<4>(kscl + s, ks + row, in);
      cp_async<4>(vscl + s, vs + row, in);
    }
  };

  // start the first two tiles' loads (a split of 64 tokens is two tiles,
  // both in flight at once), then rotate q in f32 meanwhile
  if (n_tiles > 0) fill(0);
  cp_async_commit();
  if (n_tiles > 1) fill(1);
  cp_async_commit();
  const int half = d / 2;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float x = to_f(q[qoff + i]);
    if (cos_rows != nullptr) {
      const float r =
          i < half ? -to_f(q[qoff + i + half]) : to_f(q[qoff + i - half]);
      x = x * cos_rows[static_cast<size_t>(b) * d + i] +
          r * sin_rows[static_cast<size_t>(b) * d + i];
    }
    qs[i] = x;
    acc[i] = 0.f;
  }

  const int lpt = kThreads / tile;  // lanes that score one token
  const int tok = threadIdx.x / lpt, part = threadIdx.x % lpt;
  float m = -INFINITY, l = 0.f;     // warp 0's running max and sum
  for (int it = 0; it < n_tiles; ++it) {
    // this tile's rows (and q, on the first) are in; the next tile's may
    // still be in flight
    if (it + 1 < n_tiles)
      cp_async_wait_one();
    else
      cp_async_wait_all();
    __syncthreads();
    const int st = it % kStages;
    const unsigned char* kst = ring + st * stage_bytes;
    const unsigned char* vst = kst + tile * srow;
    const int t0 = tok0 + it * tile;

    // s = q . k * scale (* k scale), -inf past the length
    const KVT* krow = reinterpret_cast<const KVT*>(kst + tok * srow);
    float dot = 0.f;
    for (int dd = part; dd < d; dd += lpt) dot += qs[dd] * to_f(krow[dd]);
    for (int o = lpt / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
    if (part == 0) {
      float s = -INFINITY;
      if (t0 + tok < tok_end) {
        s = dot * scale;
        if (ks != nullptr) s *= kscl[st * kMaxTile + tok];
      }
      wts[tok] = s;
    }
    __syncthreads();

    // the online softmax over the tile, in warp 0: lane j takes token j
    if (warp == 0) {
      const float s = lane < tile ? wts[lane] : -INFINITY;
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = __expf(m - m_new);
      const float p = __expf(s - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
      if (lane < tile)
        wts[lane] = vs != nullptr ? p * vscl[st * kMaxTile + lane] : p;
      if (lane == 0) sh_alpha = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + sum over the tile of w_j v_j
    const float alpha = sh_alpha;
    for (int dd = threadIdx.x; dd < d; dd += kThreads) {
      float a = acc[dd] * alpha;
      for (int j = 0; j < tile; ++j)
        a += wts[j] * to_f(reinterpret_cast<const KVT*>(vst + j * srow)[dd]);
      acc[dd] = a;
    }
    if (it + 2 < n_tiles) {  // this tile's stage takes the one after next
      __syncthreads();
      fill(it + 2);
      cp_async_commit();
    }
  }
  __syncthreads();  // every thread is done with the weights and acc
  if (threadIdx.x == 0) {
    sh_m = m;
    sh_l = l;
  }
  __syncthreads();

  if (n_live == 1) {
    // one split: the output directly; an idle slot (length 0) walked no
    // token and gets exact zeros
    const float ll = sh_l;
    for (int dd = threadIdx.x; dd < d; dd += kThreads)
      out[qoff + dd] = from_f<QT>(ll > 0.f ? acc[dd] / ll : 0.f);
    return;
  }

  // several splits: this one's (m, l, acc), then a ticket
  const int rec_len = d + 2;
  float* rec = work + (static_cast<size_t>(bh) * n_split + split) * rec_len;
  for (int dd = threadIdx.x; dd < d; dd += kThreads) rec[2 + dd] = acc[dd];
  if (threadIdx.x == 0) {
    rec[0] = sh_m;
    rec[1] = sh_l;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh_last = atomicAdd(&counters[bh], 1) == n_live - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();

  // the last CTA to arrive merges the splits in split order: the splits'
  // m and l come in one load a thread, warp 0 turns them into weights
  // exp(m_s - max m), and each thread sums its head dims over the splits
  const float* recs = work + static_cast<size_t>(bh) * n_split * rec_len;
  if (threadIdx.x < n_live) {
    split_w[threadIdx.x] = __ldcg(recs + threadIdx.x * rec_len);
  }
  __syncthreads();
  if (warp == 0) {
    float mm = -INFINITY;
    for (int s = lane; s < n_live; s += 32) mm = fmaxf(mm, split_w[s]);
    mm = warp_max(mm);
    float ll = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float w = __expf(split_w[s] - mm);
      ll += __ldcg(recs + s * rec_len + 1) * w;
      split_w[s] = w;
    }
    ll = warp_sum(ll);
    if (lane == 0) sh_l = ll;
  }
  __syncthreads();
  const float inv = 1.f / sh_l;
  for (int dd = threadIdx.x; dd < d; dd += kThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s)
      o += __ldcg(recs + s * rec_len + 2 + dd) * split_w[s];
    out[qoff + dd] = from_f<QT>(o * inv);
  }
  if (threadIdx.x == 0) counters[bh] = 0;  // ready for the next launch
}

// The largest tile (32, 16, 8 or 4 tokens) whose two stages keep the CTA
// within 96 KB of shared memory (two CTAs an SM), else within the card's
// opt-in limit; 0 when no tile fits.
inline int pick_tile(int d, int row_bytes, int optin) {
  for (int tile = kMaxTile; tile >= 4; tile /= 2)
    if (smem_bytes(d, row_bytes, tile) <= 96 * 1024) return tile;
  return smem_bytes(d, row_bytes, 4) <= static_cast<size_t>(optin) ? 4 : 0;
}

template <typename QT, typename KVT>
int launch(dim3 grid, cudaStream_t s, const void* q, const void* kp,
           const void* vp, const void* ks, const void* vs, const void* table,
           const void* lengths, const void* cos_rows, const void* sin_rows,
           void* out, void* work, void* counters, int heads, int d, int page,
           int np, float scale, int split_pages, int n_split) {
  auto* kernel = &paged_decode_kernel<QT, KVT>;
  // the card's opt-in limit less the static shared memory, allowed once
  static int optin = -1;
  static const cudaError_t allowed = [kernel] {
    int dev = 0, limit = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
      optin = limit - static_cast<int>(attr.sharedSizeBytes);
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
    return err;
  }();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const int row_bytes = d * static_cast<int>(sizeof(KVT));
  const int tile = pick_tile(d, row_bytes, optin);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need whole 16-byte rows and 16-byte aligned pools
  const bool a16 = reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const bool a4 = reinterpret_cast<uintptr_t>(kp) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(vp) % 4 == 0;
  const int vec = row_bytes % 16 == 0 && a16 ? 16
                  : row_bytes % 4 == 0 && a4 ? 4
                                             : 0;
  kernel<<<grid, kThreads, smem_bytes(d, row_bytes, tile), s>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const float*>(cos_rows),
      static_cast<const float*>(sin_rows), static_cast<QT*>(out),
      static_cast<float*>(work), static_cast<int*>(counters), heads, d, page,
      np, scale, split_pages, n_split, tile, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(int kv_dtype, dim3 grid, cudaStream_t s, const void* q,
              const void* kp, const void* vp, const void* ks, const void* vs,
              const void* table, const void* lengths, const void* cos_rows,
              const void* sin_rows, void* out, void* work, void* counters,
              int heads, int d, int page, int np, float scale, int split_pages,
              int n_split) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(grid, s, q, kp, vp, ks, vs, table, lengths,
                               cos_rows, sin_rows, out, work, counters, heads,
                               d, page, np, scale, split_pages, n_split);
    case 1:
      return launch<QT, bf16>(grid, s, q, kp, vp, ks, vs, table, lengths,
                              cos_rows, sin_rows, out, work, counters, heads, d,
                              page, np, scale, split_pages, n_split);
    case 2:
      return launch<QT, int8_t>(grid, s, q, kp, vp, ks, vs, table, lengths,
                                cos_rows, sin_rows, out, work, counters, heads,
                                d, page, np, scale, split_pages, n_split);
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
// (B, D) f32 or null.  The split plan (split_pages, n_split <= 128) covers
// the NP entries; with n_split > 1, work holds B * H * n_split * (D + 2) f32 and
// counters B * H int32, zero before the launch (the kernel leaves them
// zero).  Any head dim D >= 1 whose two smallest stages fit a CTA; with
// RoPE, D even.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* table,
                            const void* lengths, const void* cos_rows,
                            const void* sin_rows, void* out, int batch,
                            int heads, int d, int page, int np, float scale,
                            int q_dtype, int kv_dtype, void* work,
                            void* counters, int split_pages, int n_split,
                            void* stream) {
  if (batch <= 0 || heads <= 0 || d <= 0 || page <= 0 || np <= 0 ||
      split_pages <= 0 || n_split <= 0 || n_split > kMaxSplits ||
      static_cast<long long>(n_split) * split_pages < np ||
      (n_split > 1 && (work == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = static_cast<long long>(batch) * heads * n_split;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(ctas));
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, grid, s, q, kp, vp, ks, vs, table,
                            lengths, cos_rows, sin_rows, out, work, counters,
                            heads, d, page, np, scale, split_pages, n_split);
  if (q_dtype == 1)
    return launch_kv<bf16>(kv_dtype, grid, s, q, kp, vp, ks, vs, table,
                           lengths, cos_rows, sin_rows, out, work, counters,
                           heads, d, page, np, scale, split_pages, n_split);
  return static_cast<int>(cudaErrorInvalidValue);
}
