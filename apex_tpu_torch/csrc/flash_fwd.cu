// K3: flash-attention forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py :: flash_fwd
//           (Pallas body _fwd_kernel, dead-tile skip _causal_block_live) —
//           online-softmax attention returning o and the f32 row
//           logsumexp, bottom-right causal alignment (offset S_k - S_q),
//           with the TPU kernel's two optional operands: an additive f32
//           bias (G, RS, S_k) and dropout on the probabilities with the
//           hash keep mask of _dropout_keep_block (flash_operands.cuh).
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
//           The heaviest causal tiles are issued first.  Head dims 64
//           (GPT, BERT, the evoformer's MSA attention) and 32 (its triangle
//           attention): nothing depends on 64 but the template argument,
//           and a bf16 tile row of D + 8 (80 bytes at D = 32, 144 at 64)
//           starts the eight rows of a fragment load on distinct 16-byte
//           bank groups either way.  One template instance per head dim and
//           operand combination (bias, dropout: four each), so a call
//           without them runs the code it ran before they existed.
//           Bias: read straight from global memory in the softmax pass,
//           one f32 per score (a (1, S_k) key-padding row stays in L1/L2
//           for the whole tile), added after the scale and floored at
//           PAD_VALUE, before the causal mask.  Dropout: the seed is read
//           from device memory (no host sync); each lane hashes its row
//           once per CTA and each (row, col) once more, in registers; the
//           row max m and sum l take the undropped p, the bf16 P tile of
//           the PV product takes keep ? p / (1 - p_drop) : 0.  Besides lse
//           the kernel writes each row's m and l, from which K4 recomputes
//           p = exp(s - m) / l: exact also for a row that a bias masks
//           completely, whose lse rounds back to MASK_VALUE in f32.
//           Not yet used: wgmma, TMA, cp.async pipelining (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "flash_operands.cuh"

namespace {

using flash_operands::kMaskValue;

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;
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

template <int D, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seed, bf16* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ m_out,
                 float* __restrict__ l_out, int bh_count, int sq, int sk,
                 float scale, int causal, int offset, int bias_div,
                 int bias_rows, uint32_t threshold, float drop_scale) {
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

  // the operands: this row's bias (the ragged rows past S_q, which are
  // never written, read the last row's) and the row's half of the
  // dropout hash
  const float* brow = nullptr;
  if constexpr (kBias)
    brow = flash_operands::bias_row(bias, bh, bias_div, bias_rows,
                                    min(row, sq - 1), sk);
  uint32_t key = 0, row_hash = 0;
  if constexpr (kDropout) {
    key = flash_operands::dropout_key(seed, bh);
    row_hash = flash_operands::dropout_row(key, row);
  }

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
      if (col >= sk) {
        s = -INFINITY;
      } else {
        if constexpr (kBias) s += flash_operands::bias_at(brow, col);
        if (causal && col > row + offset) s = kMaskValue;
      }
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
      float pv = p;
      if constexpr (kDropout)
        pv = flash_operands::dropout_keep(key, row_hash, kt + 2 * c + half,
                                          threshold)
                 ? p * drop_scale
                 : 0.f;
      prow[2 * c + half] = __float2bfloat16(pv);
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
    if (half == 0) {
      const size_t i = static_cast<size_t>(bh) * sq + row;
      lse[i] = m + logf(l);
      m_out[i] = m;
      l_out[i] = l;
    }
  }
}

template <int D, bool kBias, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seed, void* o, void* lse, void* m, void* l, int bh,
           int sq, int sk, int bias_div, int bias_rows, float scale,
           int causal, int offset, uint32_t threshold, float drop_scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto* kernel = &flash_fwd_kernel<D, kBias, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (sq + kBQ - 1) / kBQ;
  const dim3 grid(static_cast<unsigned>(bh) * n_tiles);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<float*>(m),
      static_cast<float*>(l), bh, sq, sk, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = decltype(&launch<64, false, false>);

template <int D>
LaunchFn pick(bool with_bias, bool dropout) {
  if (with_bias)
    return dropout ? &launch<D, true, true> : &launch<D, true, false>;
  return dropout ? &launch<D, false, true> : &launch<D, false, false>;
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (bh, sq, d), k and v (bh, sk, d) bf16; bias (groups, bias_rows, sk)
// f32 or null; seed one int32 or null (no dropout); o (bh, sq, d) bf16;
// lse, m, l (bh, sq) f32.  d must be 32 or 64, groups must divide bh and
// bias_rows be 1 or sq.  The causal mask is aligned bottom-right.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* seed, void* o,
                         void* lse, void* m, void* l, int bh, int sq, int sk,
                         int d, int groups, int bias_rows, float scale,
                         int causal, unsigned threshold, float drop_scale,
                         void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || (d != 32 && d != 64) || groups <= 0 ||
      bh % groups != 0 || (bias_rows != 1 && bias_rows != sq))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchFn run = d == 32 ? pick<32>(bias != nullptr, seed != nullptr)
                               : pick<64>(bias != nullptr, seed != nullptr);
  return run(q, k, v, bias, seed, o, lse, m, l, bh, sq, sk, bh / groups,
             bias_rows, scale, causal, sk - sq, threshold, drop_scale,
             static_cast<cudaStream_t>(stream));
}
