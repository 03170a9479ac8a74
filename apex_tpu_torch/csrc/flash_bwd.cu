// K4: flash-attention backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py :: flash_bwd
//           (Pallas bodies _dkdv_kernel and _dq_kernel, recompute helper
//           _recompute_p) — dq, dk, dv by recomputing the probabilities,
//           bottom-right causal alignment (offset S_k - S_q), with the
//           forward's optional additive bias (G, RS, S_k) and hash
//           dropout (flash_operands.cuh).  delta = rowsum(dO*O) - dlse
//           (O the dropped output) is computed outside the kernels, as
//           the JAX package does in jnp, so the dlse fold needs nothing
//           here.
// Bound on the H100: tensor-core operations.  Five products of 2*D flops
//           per live (q, k) pair (the recompute Q K^T, dO V^T, P^T dO,
//           dS K, dS^T Q: 2.5x the forward's count) against reading q, k,
//           v, dO and writing dq, dk, dv once: ~1.25*S flops per byte at
//           causal D = 64, so the least time is the live-pair flops /
//           989 TFLOP/s (bf16 dense).
// Design:   the TPU's two passes, kept because neither needs atomics, so
//           the gradients are the same from run to run.
//           dK/dV: one 128-thread CTA per (batch*head, 64-row k tile);
//           each warp owns 16 keys, keeps its K and V rows as wmma
//           fragments and its dK and dV sums in f32 accumulator
//           fragments, and loops over the q tiles.  Under causal masking a
//           q tile with no live pair is skipped unless it holds fully-masked
//           rows (row + offset < 0, Sq > Sk): those rows' p is 1/Sk (the
//           forward averaged V uniformly) and still feeds dV, as the TPU's
//           include_fully_masked rule keeps them.
//           dQ: one CTA per (batch*head, 64-row q tile), each warp owns 16
//           queries; the k loop stops at the tile's causal limit, and a
//           fully-masked row gets dq = 0 (the mask blocks its gradient).
//           Both recompute S and dP with wmma bf16 16x16x16 fragments and
//           f32 accumulation, form p and ds in f32 with two lanes per row
//           (interleaved columns, padded shared-memory rows), and round p
//           and ds to bf16 for the next products, as the TPU's bf16 MXU
//           passes do.  p = exp(s - m) / l from the forward's row max m and
//           row sum l, not exp(s - lse) as on the TPU: a row that a bias
//           masks completely has lse = MASK_VALUE + log(S_k), which f32
//           rounds back to MASK_VALUE, so exp(s - lse) would give 1 where
//           the softmax is 1/S_k (the Pallas kernel patches only the causal
//           case, with a closed form); with m and l every fully-masked row,
//           causal or by bias, gets 1/S_k and needs no special case.  The
//           bias is read from global memory per score (s*scale + max(bias,
//           PAD_VALUE), then the causal mask), the dropout keep mask is
//           re-hashed from (seed, bh, row, col): dv += (D*p)^T dO and
//           ds = p*(D*dp - delta) with D = keep / (1 - p_drop).  Causally
//           masked pairs have ds = 0 (the mask is a where() on the score);
//           their p is 0 unless the whole row is masked.  The ragged edge
//           (rows past S_q, keys past S_k) is masked here, with nothing
//           padded.  Heaviest causal tiles first.  Head dim 64 only, the
//           port's models'.  One template instance per operand combination
//           (bias, dropout: four), so a call without them runs the code it
//           ran before they existed.  Not yet used: wgmma, TMA, cp.async pipelining
//           (later work).

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
constexpr int kRows = 16;
static_assert(kBQ == kBK, "load_tile stages q tiles and k/v tiles alike");
static_assert(kBQ == kWarps * kRows, "each warp owns 16 rows of a tile");

// Shared-memory row strides, padded as in K3 so that the wmma loads and
// the two-lanes-per-row elementwise pass spread over the banks.  The f32
// scratch rows (kSLd) also stage the D-wide outputs.
template <int D> constexpr int kTileLd = D + 8;
constexpr int kSLd = kBK + 4;
constexpr int kPLd = kBK + 8;

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * 4 * kBK * kTileLd<D>            // K, V, Q, dO tiles
         + sizeof(float) * 3 * kBQ                      // m, 1/l, delta
         + sizeof(float) * 2 * kWarps * kRows * kSLd    // S^T, dP^T
         + sizeof(bf16) * 2 * kWarps * kRows * kPLd;    // P^T, dS^T
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 4 * kBK * kTileLd<D>            // Q, dO, K, V tiles
         + sizeof(float) * 2 * kWarps * kRows * kSLd    // S, dP
         + sizeof(bf16) * kWarps * kRows * kPLd;        // dS
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
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[16 x 64] = A_w (16 x D, register fragments) times the transpose of
// the 64-row shared tile `T` (64 x D), stored row-major into f32 `out`.
template <int D>
__device__ __forceinline__ void times_tile_t(const FragA (&a)[D / 16],
                                             const bf16* T, float* out) {
  constexpr int kLd = kTileLd<D>;
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) {
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBCol bt;
      wmma::load_matrix_sync(bt, T + n * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(acc, a[kk], bt, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, kSLd, wmma::mem_row_major);
  }
}

// acc[D/16] (16 x D) += P (16 x 64 bf16 in shared, row stride kPLd) times
// the 64-row shared tile `T` (64 x D).
template <int D>
__device__ __forceinline__ void accumulate(FragAcc (&acc)[D / 16],
                                           const bf16* P, const bf16* T) {
  constexpr int kLd = kTileLd<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragA pa;
      FragBRow tb;
      wmma::load_matrix_sync(pa, P + kk * 16, kPLd);
      wmma::load_matrix_sync(tb, T + kk * 16 * kLd + n * 16, kLd);
      wmma::mma_sync(acc[n], pa, tb, acc[n]);
    }
  }
}

// Write the warp's 16 x D accumulator times `scale` as bf16 rows
// row0 + r (r < 16, rows at or past `limit` skipped), staged through the
// warp's f32 scratch `stage` (16 x kSLd).
template <int D>
__device__ __forceinline__ void store_rows(const FragAcc (&acc)[D / 16],
                                           float* stage, bf16* out, int row0,
                                           int limit, float scale) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], kSLd, wmma::mem_row_major);
  __syncwarp();
  if (row0 + r < limit) {
    bf16* og = out + static_cast<size_t>(row0 + r) * D;
    const float* srow = stage + r * kSLd;
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      og[2 * c + half] = __float2bfloat16(srow[2 * c + half] * scale);
  }
  __syncwarp();
}

template <int D, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ row_max,
                      const float* __restrict__ row_sum,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias,
                      const int* __restrict__ seed, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int bh_count, int sq, int sk,
                      float scale, int causal, int offset, int bias_div,
                      int bias_rows, uint32_t threshold, float drop_scale) {
  static_assert(D <= kSLd, "the f32 scratch rows stage D-wide outputs");
  constexpr int kLd = kTileLd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * kLd;
  bf16* Qs = Vs + kBK * kLd;
  bf16* dOs = Qs + kBQ * kLd;
  float* m_s = reinterpret_cast<float*>(dOs + kBQ * kLd);
  float* il_s = m_s + kBQ;
  float* delta_s = il_s + kBQ;
  float* Ss = delta_s + kBQ;
  float* dPs = Ss + kWarps * kRows * kSLd;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + kWarps * kRows * kSLd);
  bf16* dSs = Ps + kWarps * kRows * kPLd;

  const int bh = blockIdx.x % bh_count;
  const int k0 = static_cast<int>(blockIdx.x / bh_count) * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int krow = k0 + warp * kRows + r;

  const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
  const bf16* ob = dout + static_cast<size_t>(bh) * sq * D;
  const float* m_b = row_max + static_cast<size_t>(bh) * sq;
  const float* l_b = row_sum + static_cast<size_t>(bh) * sq;
  const float* delta_b = delta + static_cast<size_t>(bh) * sq;
  // the bias of this lane's key: one value for a key-padding row (RS = 1;
  // keys past S_k, never written, read the last key's), else row `qrow`
  // of the group's (S_q, S_k) block
  const float* bias_g = nullptr;
  float bias_k = 0.f;
  if constexpr (kBias) {
    bias_g = flash_operands::bias_row(bias, bh, bias_div, bias_rows, 0, sk);
    if (bias_rows == 1) bias_k = flash_operands::bias_at(bias_g, min(krow, sk - 1));
  }
  uint32_t key = 0;
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);

  float* Sw = Ss + warp * kRows * kSLd;
  float* dPw = dPs + warp * kRows * kSLd;
  bf16* Pw = Ps + warp * kRows * kPLd;
  bf16* dSw = dSs + warp * kRows * kPLd;

  load_tile<D>(Ks, kb, k0, sk);
  load_tile<D>(Vs, vb, k0, sk);
  __syncthreads();
  FragA ka[D / 16], va[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(ka[kk], Ks + warp * kRows * kLd + kk * 16, kLd);
    wmma::load_matrix_sync(va[kk], Vs + warp * kRows * kLd + kk * 16, kLd);
  }
  FragAcc acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  const int nq = (sq + kBQ - 1) / kBQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    if (causal) {
      const int q_last = min(q0 + kBQ, sq) - 1;
      const bool live = q_last + offset >= k0;
      const bool fully_masked_rows = q0 + offset < 0;
      if (!live && !fully_masked_rows) continue;  // uniform over the CTA
    }
    load_tile<D>(Qs, qb, q0, sq);
    load_tile<D>(dOs, ob, q0, sq);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const bool in = q0 + i < sq;
      m_s[i] = in ? m_b[q0 + i] : 0.f;
      il_s[i] = in ? 1.f / l_b[q0 + i] : 0.f;
      delta_s[i] = in ? delta_b[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
    times_tile_t<D>(ka, Qs, Sw);
    times_tile_t<D>(va, dOs, dPw);
    __syncwarp();

    // P^T and dS^T in f32, rounded to bf16 for the products below
    const float* srow = Sw + r * kSLd;
    const float* dprow = dPw + r * kSLd;
    bf16* prow = Pw + r * kPLd;
    bf16* dsrow = dSw + r * kPLd;
#pragma unroll 8
    for (int c = 0; c < kBQ / 2; ++c) {
      const int cl = 2 * c + half;
      const int qrow = q0 + cl;
      float pv = 0.f, ds = 0.f;
      if (qrow < sq && krow < sk) {
        const bool masked = causal && krow > qrow + offset;
        float s = kMaskValue;
        if (!masked) {
          s = srow[cl] * scale;
          if constexpr (kBias)
            s += bias_rows == 1 ? bias_k
                                : flash_operands::bias_at(
                                      bias_g + static_cast<size_t>(qrow) * sk,
                                      krow);
        }
        const float p = __expf(s - m_s[cl]) * il_s[cl];
        float dp = dprow[cl];
        pv = p;
        if constexpr (kDropout) {
          const float keep =
              flash_operands::dropout_keep(
                  key, flash_operands::dropout_row(key, qrow), krow, threshold)
                  ? drop_scale
                  : 0.f;
          pv = p * keep;
          dp *= keep;
        }
        if (!masked) ds = p * (dp - delta_s[cl]);
      }
      prow[cl] = __float2bfloat16(pv);
      dsrow[cl] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q
    accumulate<D>(acc_dv, Pw, dOs);
    accumulate<D>(acc_dk, dSw, Qs);
    __syncthreads();
  }

  const int row0 = k0 + warp * kRows;
  bf16* dkb = dk + static_cast<size_t>(bh) * sk * D;
  bf16* dvb = dv + static_cast<size_t>(bh) * sk * D;
  store_rows<D>(acc_dk, Sw, dkb, row0, sk, scale);
  store_rows<D>(acc_dv, Sw, dvb, row0, sk, 1.f);
}

template <int D, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias,
                    const int* __restrict__ seed, bf16* __restrict__ dq,
                    int bh_count, int sq, int sk, float scale, int causal,
                    int offset, int bias_div, int bias_rows,
                    uint32_t threshold, float drop_scale) {
  static_assert(D <= kSLd, "the f32 scratch rows stage D-wide outputs");
  constexpr int kLd = kTileLd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * kLd;
  bf16* Ks = dOs + kBQ * kLd;
  bf16* Vs = Ks + kBK * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * kLd);
  float* dPs = Ss + kWarps * kRows * kSLd;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + kWarps * kRows * kSLd);

  const int n_tiles = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int q0 = tile * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * kRows + r;

  const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
  const bf16* ob = dout + static_cast<size_t>(bh) * sq * D;

  float* Sw = Ss + warp * kRows * kSLd;
  float* dPw = dPs + warp * kRows * kSLd;
  bf16* dSw = dSs + warp * kRows * kPLd;

  load_tile<D>(Qs, qb, q0, sq);
  load_tile<D>(dOs, ob, q0, sq);
  const size_t ri = static_cast<size_t>(bh) * sq + row;
  const float m_r = row < sq ? row_max[ri] : 0.f;
  const float il_r = row < sq ? 1.f / row_sum[ri] : 0.f;
  const float delta_r = row < sq ? delta[ri] : 0.f;
  // rows past S_q, never written, read the last row's bias
  const float* brow = nullptr;
  if constexpr (kBias)
    brow = flash_operands::bias_row(bias, bh, bias_div, bias_rows,
                                    min(row, sq - 1), sk);
  uint32_t key = 0, row_hash = 0;
  if constexpr (kDropout) {
    key = flash_operands::dropout_key(seed, bh);
    row_hash = flash_operands::dropout_row(key, row);
  }
  int k_end = sk;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;
    k_end = max(0, min(sk, q_last + offset + 1));
  }
  __syncthreads();

  FragA qa[D / 16], oa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], Qs + warp * kRows * kLd + kk * 16, kLd);
    wmma::load_matrix_sync(oa[kk], dOs + warp * kRows * kLd + kk * 16, kLd);
  }
  FragAcc acc_dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc_dq[n], 0.f);

  for (int kt = 0; kt < k_end; kt += kBK) {
    load_tile<D>(Ks, kb, kt, sk);
    load_tile<D>(Vs, vb, kt, sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    times_tile_t<D>(qa, Ks, Sw);
    times_tile_t<D>(oa, Vs, dPw);
    __syncwarp();

    const float* srow = Sw + r * kSLd;
    const float* dprow = dPw + r * kSLd;
    bf16* dsrow = dSw + r * kPLd;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const int cl = 2 * c + half;
      const int col = kt + cl;
      float ds = 0.f;
      if (row < sq && col < sk && (!causal || col <= row + offset)) {
        float s = srow[cl] * scale;
        if constexpr (kBias) s += flash_operands::bias_at(brow, col);
        const float p = __expf(s - m_r) * il_r;
        float dp = dprow[cl];
        if constexpr (kDropout)
          dp = flash_operands::dropout_keep(key, row_hash, col, threshold)
                   ? dp * drop_scale
                   : 0.f;
        ds = p * (dp - delta_r);
      }
      dsrow[cl] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ += dS K
    accumulate<D>(acc_dq, dSw, Ks);
    __syncthreads();
  }

  store_rows<D>(acc_dq, Sw, dq + static_cast<size_t>(bh) * sq * D,
                q0 + warp * kRows, sq, scale);
}

template <int D, bool kBias, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* m, const void* l, const void* delta, const void* bias,
           const void* seed, void* dq, void* dk, void* dv, int bh, int sq,
           int sk, int bias_div, int bias_rows, float scale, int causal,
           int offset, uint32_t threshold, float drop_scale,
           cudaStream_t stream) {
  constexpr size_t dkdv_bytes = dkdv_smem_bytes<D>();
  constexpr size_t dq_bytes = dq_smem_bytes<D>();
  auto* dkdv_kernel = &flash_bwd_dkdv_kernel<D, kBias, kDropout>;
  auto* dq_kernel = &flash_bwd_dq_kernel<D, kBias, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* dp = static_cast<const float*>(delta);
  const float* bp = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(seed);
  const int nk = (sk + kBK - 1) / kBK;
  const int nq = (sq + kBQ - 1) / kBQ;
  dkdv_kernel<<<dim3(static_cast<unsigned>(bh) * nk), kThreads, dkdv_bytes,
                stream>>>(
      qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), bh, sq, sk, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3(static_cast<unsigned>(bh) * nq), kThreads, dq_bytes,
              stream>>>(
      qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<bf16*>(dq), bh, sq, sk,
      scale, causal, offset, bias_div, bias_rows, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, dout (bh, sq, d) and k, v (bh, sk, d) bf16; m, l (K3's row max and
// row sum) and delta (bh, sq) f32; bias and seed as K3's (null when
// absent); dq (bh, sq, d), dk and dv (bh, sk, d) bf16.  d must be 64.
// The causal mask is aligned bottom-right.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* m, const void* l,
                         const void* delta, const void* bias, const void* seed,
                         void* dq, void* dk, void* dv, int bh, int sq, int sk,
                         int d, int groups, int bias_rows, float scale,
                         int causal, unsigned threshold, float drop_scale,
                         void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != 64 || groups <= 0 ||
      bh % groups != 0 || (bias_rows != 1 && bias_rows != sq))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run = bias != nullptr
                       ? (seed != nullptr ? &launch<64, true, true>
                                          : &launch<64, true, false>)
                       : (seed != nullptr ? &launch<64, false, true>
                                          : &launch<64, false, false>);
  return run(q, k, v, dout, m, l, delta, bias, seed, dq, dk, dv, bh, sq, sk,
             bh / groups, bias_rows, scale, causal, sk - sq, threshold,
             drop_scale, static_cast<cudaStream_t>(stream));
}
