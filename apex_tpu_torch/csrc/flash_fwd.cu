// K3: causal flash-attention forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py :: flash_fwd
//           (Pallas body _fwd_kernel, dead-tile skip _causal_block_live) —
//           online-softmax attention returning o and the f32 row
//           logsumexp, bottom-right causal alignment (offset S_k - S_q).
// Bound on the H100: tensor-core operations.  QK^T and PV cost
//           4 * S_q * S_k_live * D flops per head against reading q, k, v
//           and writing o once, i.e. ~S/2 flops per byte at causal D = 64:
//           above the 295 flop/byte balance point from S ~ 600 on, so the
//           least time is the live-tile flops / 989 TFLOP/s (bf16 dense).
// Design:   one 128-thread CTA per (batch*head, 64-row q tile); each of the
//           four warps owns 16 q rows.  The k/v loop stops at the causal
//           limit of the tile's last row (the effect of _causal_block_live;
//           a tile whose first row sees no key at all under bottom-right
//           alignment walks every key, like the TPU's include_fully_masked
//           rule).  K and V tiles of 64 rows are staged in shared memory;
//           QK^T and PV run on the tensor cores through wmma bf16
//           16x16x16 fragments with f32 accumulation; the online softmax
//           runs in f32 with two lanes per row.  Masked scores take the
//           finite MASK_VALUE = -1e9 (flash_attention.py:49) so a row that
//           sees no key averages V uniformly, as on the TPU; columns past
//           S_k (the ragged edge) get -inf and weigh exactly zero.  The
//           TPU kernel's 128-lane broadcast of lse is a tiling artifact of
//           Mosaic and is dropped: lse is written as (BH, S_q).
//           The heaviest causal tiles are issued first.  Head dim 64
//           only, the port's models' (one template instance).  Not yet used:
//           wgmma, TMA, cp.async pipelining (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;
constexpr float kMaskValue = -1e9f;
static_assert(kBQ == kBK, "load_tile stages q tiles and k/v tiles alike");
static_assert(kBQ == kWarps * kRowsPerWarp, "each warp owns 16 q rows");

// Shared-memory row strides, padded so that neither the wmma fragment
// loads nor the softmax lanes (16 rows x 2 lanes, interleaved columns)
// pile onto one bank: a bf16 tile row of D + 8 shifts each row by 16
// bytes; f32 rows of 68 / D + 4 floats and bf16 rows of 72 shift rows by
// 4 banks.  wmma needs ldm % 8 == 0 (bf16) and % 4 == 0 (f32).
template <int D> constexpr int kTileLd = D + 8;
constexpr int kSLd = kBK + 4;
constexpr int kPLd = kBK + 8;
template <int D> constexpr int kOLd = D + 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kBQ + 2 * kBK) * kTileLd<D>      // Q, K, V tiles
         + sizeof(float) * kWarps * kRowsPerWarp * kSLd   // scores
         + sizeof(bf16) * kWarps * kRowsPerWarp * kPLd    // probabilities
         + sizeof(float) * kWarps * kRowsPerWarp * kOLd<D>;  // output
}

// Copy 64 rows of D bf16 from global `src` into shared `dst` (row stride
// kTileLd) as 16-byte vectors, zero-filling rows at or past `limit`.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int limit) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D)[c];
    reinterpret_cast<uint4*>(dst + r * kTileLd<D>)[c] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int bh_count, int sq, int sk,
                 float scale, int causal, int offset) {
  constexpr int kLd = kTileLd<D>;
  constexpr int kOld = kOLd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLd;
  bf16* Vs = Ks + kBK * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * kLd);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kWarps * kRowsPerWarp * kSLd);
  float* Os = reinterpret_cast<float*>(Ps + kWarps * kRowsPerWarp * kPLd);

  const int n_tiles = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int q0 = tile * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // softmax lanes: two per row; lane `half` owns the row's columns
  // 2c + half (interleaved, so the 32 lanes of a warp hit distinct banks)
  const int row_local = lane >> 1, half = lane & 1;
  const int row = q0 + warp * kRowsPerWarp + row_local;

  const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;

  float* Sw = Ss + warp * kRowsPerWarp * kSLd;
  bf16* Pw = Ps + warp * kRowsPerWarp * kPLd;
  float* Ow = Os + warp * kRowsPerWarp * kOld;

  load_tile<D>(Qs, qb, q0, sq);
  for (int i = lane; i < kRowsPerWarp * kOld; i += 32) Ow[i] = 0.f;

  int k_end = sk;
  if (causal && q0 + offset >= 0) {
    const int q_last = min(q0 + kBQ, sq) - 1;
    k_end = min(sk, q_last + offset + 1);
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], Qs + warp * kRowsPerWarp * kLd + kk * 16, kLd);

  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt < k_end; kt += kBK) {
    load_tile<D>(Ks, kb, kt, sk);
    load_tile<D>(Vs, vb, kt, sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, kSLd, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax in f32: two lanes per row, 32 columns each
    const float* srow = Sw + row_local * kSLd;
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int cl = 2 * c + half;
      const int col = kt + cl;
      float s = srow[cl] * scale;
      if (col >= sk) s = -INFINITY;
      else if (causal && col > row + offset) s = kMaskValue;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
    bf16* prow = Pw + row_local * kPLd;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = __expf(sv[c] - m_new);
      psum += p;
      prow[2 * c + half] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = Ow + row_local * kOld;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[2 * c + half] *= alpha;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::load_matrix_sync(oc, Ow + n * 16, kOld, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, Pw + kk * 16, kPLd);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * kLd + n * 16, kLd);
        wmma::mma_sync(oc, pa, vf, oc);
      }
      wmma::store_matrix_sync(Ow + n * 16, oc, kOld, wmma::mem_row_major);
    }
    __syncthreads();
  }

  if (row < sq) {
    const float* orow = Ow + row_local * kOld;
    bf16* og = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      og[2 * c + half] = __float2bfloat16(orow[2 * c + half] / l);
    if (half == 0) lse[static_cast<size_t>(bh) * sq + row] = m + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int sk, float scale, int causal, int offset,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (sq + kBQ - 1) / kBQ;
  const dim3 grid(static_cast<unsigned>(bh) * n_tiles);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), bh, sq, sk, scale, causal, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (bh, sq, d), k and v (bh, sk, d) bf16; o (bh, sq, d) bf16; lse (bh, sq)
// f32.  d must be 64.  The causal mask is aligned bottom-right.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, int d, float scale,
                         int causal, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<64>(q, k, v, o, lse, bh, sq, sk, scale, causal, sk - sq,
                    static_cast<cudaStream_t>(stream));
}
