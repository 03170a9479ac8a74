// K5: flash-attention bias gradient for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py :: flash_dbias
//           (Pallas body _dbias_kernel) — the gradient of a trainable
//           additive bias in its own (G, RS, S_k) layout:
//             dbias[g, r, c] = sum over the group's BH/G batch-heads (and,
//                              when RS = 1, over every query row) of ds,
//             ds = p * (D*dp - delta),
//           with K3/K4's bottom-right causal mask (ds = 0 where it masks),
//           their hash dropout (D = keep / (1 - p_drop), flash_operands.cuh)
//           and delta = rowsum(dO*O) - dlse computed outside, as for K4.
// Bound on the H100: bytes.  Per (q, k) pair two products of 2*D flops (the
//           recompute Q K^T and dO V^T) against 8 bytes of bias read and
//           dbias written at G = BH (the evoformer's layout): ~D/2 flops
//           per byte, far below the 295 of the balance point.  The least
//           time is q, k, v, dO, m, l, delta and the bias read once and
//           dbias written once over 3.35 TB/s.
// Design:   no model path since the bias gradient at G = BH, RS = S_q (the
//           layout of every trainable bias the ported models train) left
//           K4's dQ pass as an epilogue (flash_bwd.cu, flash_bwd_dbias):
//           this kernel serves the other layouts (groups summed over
//           members or rows) and the wide head dims.
//           No float atomics, so the gradient is the same from run to run
//           (K4's rule): the group reduction runs inside a CTA.
//           RS = S_q: one 128-thread CTA per (group, 64-row q tile, 64-key
//           k tile) loops over the group's members; RS = 1: one CTA per
//           (group, k tile) loops over the members and every q tile.  Each
//           warp owns 16 query rows of a tile and recomputes S = Q K^T and
//           dP = dO V^T with K4's wmma bf16 16x16x16 fragments (f32
//           accumulation, D = 32, 64, 128 or 256, the wrapper padding any
//           other head dim to the next with zeros; above 128 the A fragments
//           are read in chunks of 128 columns, so D = 256 holds no more of
//           them in registers than D = 128); two lanes per row form p =
//           exp(s - m) / l from K3's row max m and row sum l (exact also for
//           a row that a bias masks completely, where the TPU's exp(s - lse)
//           is not) and ds in f32, and each lane keeps its 32 (row, column)
//           sums of ds in registers across the loop.  The bias tile a lane
//           needs is the same for every member, so it is read once per CTA
//           (staged through shared memory, coalesced) instead of once per
//           score as K3/K4 read it; dbias is written through the same
//           staging, one coalesced row at a time.  RS = 1 sums the 64 rows'
//           registers in shared memory in a fixed order at the end.  Under
//           causal masking a tile with no live pair is skipped (ds is 0
//           there, fully masked rows included).  Bias and dbias offsets are
//           64-bit (G*RS*S_k is 67 M at the evoformer's triangle shape).
//           One template instance per (D, RS = S_q or 1, dropout), so a call
//           without dropout runs no dropout code.  Above 256 (any multiple
//           of 128; the wrapper pads to it) the wide instance (D = 0, the
//           head dim a run-time argument) streams the four tiles 64
//           columns at a time through the same shared memory, S and dP
//           summed over the chunks in wmma accumulators, so shared memory
//           does not grow with D.  Not yet used: wgmma, TMA, cp.async
//           pipelining (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "flash_operands.cuh"
#include "launch_query.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;
constexpr int kCols = kBK / 2;  // the columns each lane owns
static_assert(kBQ == kBK, "load_tile stages q tiles and k/v tiles alike");
static_assert(kBQ == kWarps * kRows, "each warp owns 16 rows of a tile");

// Shared-memory row strides, padded as in K4: a bf16 tile row of D + 8
// (144 bytes at D = 64, 80 at D = 32, 272 at D = 128: each way the eight
// rows of a fragment load start on distinct 16-byte bank groups) and f32
// scratch rows of 68 floats.  At D = 128 the four tiles and the scratch
// take 102 KB, at D = 256 170 KB.
template <int D> constexpr int kTileLd = D + 8;
constexpr int kSLd = kBK + 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 4 * kBK * kTileLd<D>            // Q, dO, K, V tiles
         + sizeof(float) * 2 * kWarps * kRows * kSLd;   // S, dP
}

// The wide instance (D = 0) holds kChunkW columns of each tile at a time.
constexpr int kChunkW = 64;
template <> constexpr int kTileLd<0> = kChunkW + 8;

// Columns [c0, c0 + 64) of 64 rows of a (rows x d) bf16 head into `dst`
// (row stride kTileLd<0>), zero past `limit`.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int row0,
                                           int limit, int d, int c0) {
  constexpr int kVec = kChunkW / 8;
  for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * d + c0)[c];
    reinterpret_cast<uint4*>(dst + r * kTileLd<0>)[c] = val;
  }
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[16 x 64] = A (16 rows of the shared tile, 16 x D) times the
// transpose of the 64-row shared tile `T` (64 x D), stored row-major into
// f32 `out`.  Up to D = 128 A's fragments are read once for every column
// block of `out`; above it they are read kChunk columns at a time for each
// block, so that no more of them are held in registers than at D = 128.
template <int D>
__device__ __forceinline__ void times_tile_t(const bf16* A, const bf16* T,
                                             float* out) {
  constexpr int kLd = kTileLd<D>;
  constexpr int kChunk = D < 128 ? D : 128;
  FragA a[kChunk / 16];
  if constexpr (D == kChunk) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(a[kk], A + kk * 16, kLd);
  }
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) {
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      if constexpr (D != kChunk) {
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          wmma::load_matrix_sync(a[kk], A + c0 + kk * 16, kLd);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        FragBCol bt;
        wmma::load_matrix_sync(bt, T + n * 16 * kLd + c0 + kk * 16, kLd);
        wmma::mma_sync(acc, a[kk], bt, acc);
      }
    }
    wmma::store_matrix_sync(out + n * 16, acc, kSLd, wmma::mem_row_major);
  }
}

// kRowBias: RS = S_q (a CTA owns one q tile); else RS = 1 (a CTA walks
// every q tile and sums the rows).  D = 0: the wide instance, head dim d.
template <int D, bool kRowBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_dbias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const float* __restrict__ delta,
                   const float* __restrict__ bias,
                   const int* __restrict__ seed, float* __restrict__ dbias,
                   int members, int sq, int sk, int nq, int nk, int d_arg,
                   float scale, int causal, int offset, uint32_t threshold,
                   float drop_scale) {
  constexpr int kLd = kTileLd<D>;
  const int d = D > 0 ? D : d_arg;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * kLd;
  bf16* Ks = dOs + kBQ * kLd;
  bf16* Vs = Ks + kBK * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * kLd);
  float* dPs = Ss + kWarps * kRows * kSLd;

  const int kt = static_cast<int>(blockIdx.x % nk);
  const int rest = static_cast<int>(blockIdx.x / nk);
  const int g = kRowBias ? rest / nq : rest;
  const int q_first = kRowBias ? rest % nq : 0;
  const int q_stop = kRowBias ? q_first + 1 : nq;
  const int k0 = kt * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  float* Sw = Ss + warp * kRows * kSLd;
  float* dPw = dPs + warp * kRows * kSLd;

  // this lane's bias values: (row, column 2c + half) of the tile, read
  // once for every member (and, with RS = 1, every q tile); RS = S_q
  // stages the warp's 16 rows through Sw so that the reads are coalesced
  const size_t bias_g = static_cast<size_t>(g) * (kRowBias ? sq : 1) * sk;
  const int wrow0 = q_first * kBQ + warp * kRows;
  float bias_reg[kCols];
  if constexpr (kRowBias) {
    for (int i = 0; i < kRows; ++i)
      for (int j = lane; j < kBK; j += 32) {
        const int row = wrow0 + i, col = k0 + j;
        Sw[i * kSLd + j] = row < sq && col < sk
                               ? bias[bias_g + static_cast<size_t>(row) * sk + col]
                               : 0.f;
      }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      bias_reg[c] = fmaxf(Sw[r * kSLd + 2 * c + half], flash_operands::kPadValue);
    __syncwarp();
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = k0 + 2 * c + half;
      bias_reg[c] = col < sk ? fmaxf(bias[bias_g + col], flash_operands::kPadValue)
                             : 0.f;
    }
  }

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int t = 0; t < members; ++t) {
    const int bh = g * members + t;
    const bf16* qb = q + static_cast<size_t>(bh) * sq * d;
    const bf16* kb = k + static_cast<size_t>(bh) * sk * d;
    const bf16* vb = v + static_cast<size_t>(bh) * sk * d;
    const bf16* ob = dout + static_cast<size_t>(bh) * sq * d;
    uint32_t key = 0;
    if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
    for (int qt = q_first; qt < q_stop; ++qt) {
      const int q0 = qt * kBQ;
      // a tile with no live pair has ds = 0 (uniform over the CTA)
      if (causal && k0 > min(q0 + kBQ, sq) - 1 + offset) continue;
      if constexpr (D > 0) {
        __syncthreads();  // the previous iteration's fragment loads are done
        load_tile<D>(Qs, qb, q0, sq);
        load_tile<D>(dOs, ob, q0, sq);
        load_tile<D>(Ks, kb, k0, sk);
        load_tile<D>(Vs, vb, k0, sk);
        __syncthreads();

        // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
        times_tile_t<D>(Qs + warp * kRows * kLd, Ks, Sw);
        times_tile_t<D>(dOs + warp * kRows * kLd, Vs, dPw);
      } else {
        // the same products 64 columns at a time, summed in the
        // accumulators over the chunks
        FragAcc acc_s[kBK / 16], acc_dp[kBK / 16];
#pragma unroll
        for (int n = 0; n < kBK / 16; ++n) {
          wmma::fill_fragment(acc_s[n], 0.f);
          wmma::fill_fragment(acc_dp[n], 0.f);
        }
        for (int c0 = 0; c0 < d; c0 += kChunkW) {
          __syncthreads();  // the previous chunk's fragment loads are done
          load_chunk(Qs, qb, q0, sq, d, c0);
          load_chunk(dOs, ob, q0, sq, d, c0);
          load_chunk(Ks, kb, k0, sk, d, c0);
          load_chunk(Vs, vb, k0, sk, d, c0);
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kChunkW / 16; ++kk) {
            FragA aq, ao;
            wmma::load_matrix_sync(aq, Qs + warp * kRows * kLd + kk * 16, kLd);
            wmma::load_matrix_sync(ao, dOs + warp * kRows * kLd + kk * 16, kLd);
#pragma unroll
            for (int n = 0; n < kBK / 16; ++n) {
              FragBCol bk, bv;
              wmma::load_matrix_sync(bk, Ks + n * 16 * kLd + kk * 16, kLd);
              wmma::load_matrix_sync(bv, Vs + n * 16 * kLd + kk * 16, kLd);
              wmma::mma_sync(acc_s[n], aq, bk, acc_s[n]);
              wmma::mma_sync(acc_dp[n], ao, bv, acc_dp[n]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kBK / 16; ++n) {
          wmma::store_matrix_sync(Sw + n * 16, acc_s[n], kSLd,
                                  wmma::mem_row_major);
          wmma::store_matrix_sync(dPw + n * 16, acc_dp[n], kSLd,
                                  wmma::mem_row_major);
        }
      }
      __syncwarp();

      const int row = q0 + warp * kRows + r;
      if (row < sq) {
        const size_t ri = static_cast<size_t>(bh) * sq + row;
        const float m_r = row_max[ri];
        const float il_r = 1.f / row_sum[ri];
        const float delta_r = delta[ri];
        uint32_t row_hash = 0;
        if constexpr (kDropout) row_hash = flash_operands::dropout_row(key, row);
        const float* srow = Sw + r * kSLd;
        const float* dprow = dPw + r * kSLd;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int cl = 2 * c + half;
          const int col = k0 + cl;
          if (col < sk && (!causal || col <= row + offset)) {
            const float s = srow[cl] * scale + bias_reg[c];
            const float p = __expf(s - m_r) * il_r;
            float dp = dprow[cl];
            if constexpr (kDropout)
              dp = flash_operands::dropout_keep(key, row_hash, col, threshold)
                       ? dp * drop_scale
                       : 0.f;
            acc[c] += p * (dp - delta_r);
          }
        }
      }
      __syncwarp();
    }
  }

  // stage the sums in the warp's scratch rows (zero for rows past S_q)
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCols; ++c) Sw[r * kSLd + 2 * c + half] = acc[c];
  if constexpr (kRowBias) {
    __syncwarp();
    for (int i = 0; i < kRows; ++i) {
      const int row = wrow0 + i;
      if (row >= sq) break;
      float* out = dbias + bias_g + static_cast<size_t>(row) * sk;
      for (int j = lane; j < kBK; j += 32)
        if (k0 + j < sk) out[k0 + j] = Sw[i * kSLd + j];
    }
  } else {
    __syncthreads();
    if (threadIdx.x < kBK && k0 + threadIdx.x < sk) {
      float sum = 0.f;
      for (int i = 0; i < kWarps * kRows; ++i) sum += Ss[i * kSLd + threadIdx.x];
      dbias[bias_g + k0 + threadIdx.x] = sum;
    }
  }
}

template <int D, bool kRowBias, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* m, const void* l, const void* delta, const void* bias,
           const void* seed, void* dbias, int groups, int members, int sq,
           int sk, int d, float scale, int causal, int offset,
           uint32_t threshold, float drop_scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto* kernel = &flash_dbias_kernel<D, kRowBias, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (sq + kBQ - 1) / kBQ;
  const int nk = (sk + kBK - 1) / kBK;
  const size_t ctas = static_cast<size_t>(groups) * (kRowBias ? nq : 1) * nk;
  if (ctas > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  { if (!apex_query::record(kernel, dim3(static_cast<unsigned>(ctas)), kThreads, bytes)) kernel<<<dim3(static_cast<unsigned>(ctas)), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<float*>(dbias), members, sq,
      sk, nq, nk, d, scale, causal, offset, threshold, drop_scale); }
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = decltype(&launch<64, true, false>);

template <int D>
LaunchFn pick(bool row_bias, bool dropout) {
  if (row_bias)
    return dropout ? &launch<D, true, true> : &launch<D, true, false>;
  return dropout ? &launch<D, false, true> : &launch<D, false, false>;
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, dout (bh, sq, d) and k, v (bh, sk, d) bf16; m, l (K3's row max and
// row sum) and delta (bh, sq) f32; bias (groups, bias_rows, sk) f32; seed
// one int32 or null (no dropout); dbias f32 in the bias's layout.  d must
// be 32, 64, 128, 256 or a multiple of 128 above 256, groups must divide
// bh and bias_rows be 1 or sq.  The causal mask is aligned bottom-right.
extern "C" int flash_dbias(const void* q, const void* k, const void* v,
                           const void* dout, const void* m, const void* l,
                           const void* delta, const void* bias,
                           const void* seed, void* dbias, int bh, int sq,
                           int sk, int d, int groups, int bias_rows,
                           float scale, int causal, unsigned threshold,
                           float drop_scale, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 ||
      (d != 32 && d != 64 && d != 128 && !(d >= 256 && d % 128 == 0)) ||
      bias == nullptr ||
      groups <= 0 || bh % groups != 0 || (bias_rows != 1 && bias_rows != sq))
    return static_cast<int>(cudaErrorInvalidValue);
  // with sq = 1 the two layouts coincide and the RS = 1 path serves both
  const bool row_bias = bias_rows != 1;
  const bool dropout = seed != nullptr;
  const LaunchFn run = d == 32    ? pick<32>(row_bias, dropout)
                       : d == 64  ? pick<64>(row_bias, dropout)
                       : d == 128 ? pick<128>(row_bias, dropout)
                       : d == 256 ? pick<256>(row_bias, dropout)
                                  : pick<0>(row_bias, dropout);
  return run(q, k, v, dout, m, l, delta, bias, seed, dbias, groups,
             bh / groups, sq, sk, d, scale, causal, sk - sq, threshold,
             drop_scale, static_cast<cudaStream_t>(stream));
}
