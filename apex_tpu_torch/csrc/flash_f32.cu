// K3, K4 and K5 on f32 q, k, v: flash-attention forward, backward and bias
// gradient at f32 accuracy, for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py :: flash_fwd, flash_bwd
//           and flash_dbias on f32 inputs, which the Pallas kernels run with
//           f32-accurate dots (_dot_precision: Precision.HIGHEST) — the same
//           functions as the bf16 kernels flash_fwd.cu, flash_bwd.cu and
//           flash_dbias.cu: online-softmax attention with the f32 row
//           logsumexp, max m and sum l; dq, dk, dv by recomputing p = exp(s -
//           m) / l in two atomic-free passes; dbias summed over each group's
//           members (and every query row when RS = 1) in a fixed order; the
//           bottom-right causal mask, the (G, RS, S_k) bias floored at
//           PAD_VALUE and the hash dropout of flash_operands.cuh.
// Bound on the H100: operations.  bf16 or TF32 tensor cores would round the
//           inputs and miss the reference's f32 accuracy, so every product
//           runs in f32 FFMA on the CUDA cores: 67 TFLOP/s, against which
//           the 4*D flops per (q, k) pair of the forward (10*D backward, 4*D
//           for dbias's recompute) outweigh the bytes at S >= ~64.
// Design:   simple and right first: every product is SIMT FFMA over 64 x 64
//           tiles staged in shared memory, each of 256 threads owning a 4 x 4
//           block of the 64 x 64 score tile (rows ty + 16i, columns tx + 16j:
//           a row's 16 threads share a half-warp, so its max and sum reduce
//           with four shuffles).  The q, k, v and dO tiles are staged
//           transposed (head dim x 65 floats), so every inner-loop read is a
//           broadcast or 16 consecutive banks.  Forward: one CTA per
//           (batch*head, 64-row q tile), heaviest causal tiles first, looping
//           over 64-key tiles up to K3's key walk (its key_limit: the causal
//           limit of the tile's last row rounded up to 64, or every key when
//           its first row sees none; masked scores MASK_VALUE, keys past the
//           walk -inf); P goes through shared memory to O += P V.  Backward:
//           K4's two passes — dK/dV with one CTA per (batch*head, 64-key
//           tile) over the live q tiles (K4's block_live, fully-masked rows
//           included), dQ with one CTA per (batch*head, 64-row q tile) up to
//           the causal limit — with no atomics, so the gradients are the
//           same bits from run to run.  dbias: K5's grid (RS = S_q: one CTA
//           per (group, q tile, k tile); RS = 1: one CTA per (group, k tile)
//           over every q tile, its 64 rows summed in shared memory in order).
//           expf, not __expf.  Head dims 32, 64 and 128, the wrapper padding
//           any other head dim up to 128 with zeros; the bias is read per
//           score from global memory.  Not yet used: register tiling beyond
//           4 x 4, a cp.async pipeline, 3xTF32 tensor-core products (later
//           work: the times are in PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_operands.cuh"

namespace {

using flash_operands::kMaskValue;

constexpr int kB = 64;          // q rows and keys of a tile
constexpr int kThreads = 256;   // 16 x 16, each 4 x 4 of a 64 x 64 tile
constexpr int kLd = kB + 1;     // a transposed tile's row stride, in floats

// Rows [row0, row0 + 64) of one head (rows x D, row-major) into the
// transposed tile t[k * kLd + r], zero past `limit`.
template <int D>
__device__ __forceinline__ void load_t(float* t, const float* src, int row0,
                                       int limit) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, k = i % D;
    t[k * kLd + r] =
        row0 + r < limit ? src[static_cast<size_t>(row0 + r) * D + k] : 0.f;
  }
}

// acc[i][j] = sum over k of a[k][ty + 16i] * b[k][tx + 16j] for two
// transposed tiles.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const float* a,
                                             const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[k * kLd + ty + 16 * i];
      bv[i] = b[k * kLd + tx + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum over n of p[(ty + 16i) * kLd + n] * t[(tx + 16c) * kLd + n]:
// a 64 x 64 row-major tile p times the transposed tile t (D x 64), into
// this thread's rows ty + 16i and head dims tx + 16c.
template <int D>
__device__ __forceinline__ void times_t(float (&acc)[4][D / 16], const float* p,
                                        const float* t, int ty, int tx) {
#pragma unroll 4
  for (int n = 0; n < kB; ++n) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kLd + n];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float tv = t[(tx + 16 * c) * kLd + n];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], tv, acc[i][c]);
    }
  }
}

// Sum or max over the 16 threads of a row (a half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K3's key walk for the 64 rows from q0 (flash_fwd.cu key_limit).
__device__ __forceinline__ int key_limit(int q0, int sq, int sk, int causal,
                                         int offset) {
  if (!causal || q0 + offset < 0) return sk;
  const int q_last = min(q0 + kB, sq) - 1;
  return min(sk, (q_last + offset + 1 + kB - 1) / kB * kB);
}

// K4's rule: whether the 64 keys from k0 take part in the q tile from q0.
__device__ __forceinline__ bool block_live(int q0, int k0, int sq, int sk,
                                           int causal, int offset) {
  if (k0 >= sk) return false;
  if (!causal) return true;
  const int q_last = min(q0 + kB, sq) - 1;
  return q_last + offset >= k0 || q0 + offset < 0;
}

// The bias of score (row, col) of batch-head bh, or 0 without a bias.
__device__ __forceinline__ float bias_of(const float* bias, int bh,
                                         int bias_div, int bias_rows, int row,
                                         int col, int sk) {
  if (bias == nullptr) return 0.f;
  return flash_operands::bias_at(
      flash_operands::bias_row(bias, bh, bias_div, bias_rows, row, sk), col);
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * D * kLd + kB * kLd);  // Q^T, K^T, V^T, P
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed, float* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ m_out,
                     float* __restrict__ l_out, int bh_count, int sq, int sk,
                     float scale, int causal, int offset, int bias_div,
                     int bias_rows, uint32_t threshold, float drop_scale) {
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + D * kLd;
  float* Vt = Kt + D * kLd;
  float* Ps = Vt + D * kLd;
  const int n_tiles = (sq + kB - 1) / kB;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x / bh_count)) * kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lim = key_limit(q0, sq, sk, causal, offset);
  const int n_kt = (lim + kB - 1) / kB;
  const size_t head_q = static_cast<size_t>(bh) * sq * D;
  const size_t head_k = static_cast<size_t>(bh) * sk * D;

  uint32_t key = 0, row_hash[4] = {0, 0, 0, 0};
  if constexpr (kDropout) {
    key = flash_operands::dropout_key(seed, bh);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      row_hash[i] = flash_operands::dropout_row(key, q0 + ty + 16 * i);
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  load_t<D>(Qt, q + head_q, q0, sq);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's reads of K^T, V^T and P are done
    load_t<D>(Kt, k + head_k, k0, sk);
    load_t<D>(Vt, v + head_k, k0, sk);
    __syncthreads();
    float s[4][4];
    tile_product<D>(s, Qt, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x;
        if (col >= lim) {
          x = -INFINITY;
        } else {
          x = s[i][j] * scale +
              bias_of(bias, bh, bias_div, bias_rows, min(row, sq - 1), col, sk);
          if (causal && col > row + offset) x = kMaskValue;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;
        float pv = p;
        if constexpr (kDropout)
          pv = flash_operands::dropout_keep(key, row_hash[i], k0 + tx + 16 * j,
                                            threshold)
                   ? p * drop_scale
                   : 0.f;
        Ps[(ty + 16 * i) * kLd + tx + 16 * j] = pv;
      }
    }
    __syncthreads();
    times_t<D>(acc, Ps, Vt, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = row_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float inv = 1.f / lt;
    float* orow = o + head_q + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) {
      const size_t r = static_cast<size_t>(bh) * sq + row;
      lse[r] = m[i] + logf(lt);
      m_out[r] = m[i];
      l_out[r] = lt;
    }
  }
}

template <int D>
constexpr size_t bwd_smem() {
  // four transposed tiles and two 64 x 64 score tiles
  return sizeof(float) * (4 * D * kLd + 2 * kB * kLd);
}

// p (undropped) and ds of score (row, col), or zeros past the edge: K4's
// elementwise pass in f32.  `pv` gets D*p (the dropped p), `ds` p*(D*dp -
// delta), 0 where the causal mask holds.
template <bool kDropout>
__device__ __forceinline__ void p_and_ds(float s, float dp, float b, int row,
                                         int col, int sq, int sk, float scale,
                                         int causal, int offset, float m_r,
                                         float il_r, float delta_r,
                                         uint32_t key, uint32_t row_hash,
                                         uint32_t threshold, float drop_scale,
                                         float& pv, float& ds) {
  pv = ds = 0.f;
  if (row >= sq || col >= sk) return;
  const bool masked = causal && col > row + offset;
  const float x = masked ? kMaskValue : fmaf(s, scale, b);
  const float p = expf(x - m_r) * il_r;
  pv = p;
  if constexpr (kDropout) {
    const float keep = flash_operands::dropout_keep(key, row_hash, col, threshold)
                           ? drop_scale
                           : 0.f;
    pv = p * keep;
    dp *= keep;
  }
  if (!masked) ds = p * (dp - delta_r);
}

// dK/dV: one CTA per (batch-head, 64-key tile).  Thread (ty, tx) holds keys
// k0 + ty + 16i and head dims tx + 16c of dK and dV, and of S^T keys ty +
// 16i by queries tx + 16j.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ row_max_in,
                          const float* __restrict__ row_sum_in,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias,
                          const int* __restrict__ seed, float* __restrict__ dk,
                          float* __restrict__ dv, int bh_count, int sq, int sk,
                          float scale, int causal, int offset, int bias_div,
                          int bias_rows, uint32_t threshold, float drop_scale) {
  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + D * kLd;
  float* Qt = Vt + D * kLd;
  float* dOt = Qt + D * kLd;
  float* Ps = dOt + D * kLd;  // P^T: keys x queries
  float* dSs = Ps + kB * kLd;
  __shared__ float stats[3][kB];  // the q tile's m, 1/l and delta
  const int bh = blockIdx.x % bh_count;
  const int k0 = static_cast<int>(blockIdx.x / bh_count) * kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t head_q = static_cast<size_t>(bh) * sq * D;
  const size_t head_k = static_cast<size_t>(bh) * sk * D;
  const size_t rows = static_cast<size_t>(bh) * sq;
  uint32_t key = 0;
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);

  float acc_dk[4][D / 16], acc_dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  load_t<D>(Kt, k + head_k, k0, sk);
  load_t<D>(Vt, v + head_k, k0, sk);
  const int nq = (sq + kB - 1) / kB;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kB;
    if (!block_live(q0, k0, sq, sk, causal, offset)) continue;
    __syncthreads();  // the previous tile's reads are done
    load_t<D>(Qt, q + head_q, q0, sq);
    load_t<D>(dOt, dout + head_q, q0, sq);
    if (threadIdx.x < kB) {
      const int r = q0 + threadIdx.x;
      stats[0][threadIdx.x] = r < sq ? row_max_in[rows + r] : 0.f;
      stats[1][threadIdx.x] = r < sq ? 1.f / row_sum_in[rows + r] : 0.f;
      stats[2][threadIdx.x] = r < sq ? delta[rows + r] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_product<D>(st, Kt, Qt, ty, tx);
    tile_product<D>(dpt, Vt, dOt, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int row = q0 + c;
      uint32_t row_hash = 0;
      if constexpr (kDropout) row_hash = flash_operands::dropout_row(key, row);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty + 16 * i;
        const float b =
            row < sq && col < sk
                ? bias_of(bias, bh, bias_div, bias_rows, row, col, sk)
                : 0.f;
        float pv, ds;
        p_and_ds<kDropout>(st[i][j], dpt[i][j], b, row, col, sq, sk, scale,
                           causal, offset, stats[0][c], stats[1][c],
                           stats[2][c], key, row_hash, threshold, drop_scale,
                           pv, ds);
        Ps[(ty + 16 * i) * kLd + c] = pv;
        dSs[(ty + 16 * i) * kLd + c] = ds;
      }
    }
    __syncthreads();
    times_t<D>(acc_dv, Ps, dOt, ty, tx);   // dV += P^T dO
    times_t<D>(acc_dk, dSs, Qt, ty, tx);   // dK += dS^T Q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key_row = k0 + ty + 16 * i;
    if (key_row >= sk) continue;
    const size_t off = head_k + static_cast<size_t>(key_row) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[off + tx + 16 * c] = acc_dk[i][c] * scale;
      dv[off + tx + 16 * c] = acc_dv[i][c];
    }
  }
}

// dQ: one CTA per (batch-head, 64-row q tile), heaviest causal tiles first.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ row_max_in,
                        const float* __restrict__ row_sum_in,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed, float* __restrict__ dq,
                        int bh_count, int sq, int sk, float scale, int causal,
                        int offset, int bias_div, int bias_rows,
                        uint32_t threshold, float drop_scale) {
  extern __shared__ float smem[];
  float* Qt = smem;
  float* dOt = Qt + D * kLd;
  float* Kt = dOt + D * kLd;
  float* Vt = Kt + D * kLd;
  float* dSs = Vt + D * kLd;  // dS: queries x keys
  const int n_tiles = (sq + kB - 1) / kB;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x / bh_count)) * kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t head_q = static_cast<size_t>(bh) * sq * D;
  const size_t head_k = static_cast<size_t>(bh) * sk * D;
  const int q_last = min(q0 + kB, sq) - 1;
  const int k_end = causal ? max(0, min(sk, q_last + offset + 1)) : sk;
  const int n_kt = (k_end + kB - 1) / kB;

  float m_r[4], il_r[4], delta_r[4];
  uint32_t key = 0, row_hash[4] = {0, 0, 0, 0};
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t ri = static_cast<size_t>(bh) * sq + row;
    m_r[i] = row < sq ? row_max_in[ri] : 0.f;
    il_r[i] = row < sq ? 1.f / row_sum_in[ri] : 0.f;
    delta_r[i] = row < sq ? delta[ri] : 0.f;
    if constexpr (kDropout) row_hash[i] = flash_operands::dropout_row(key, row);
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  load_t<D>(Qt, q + head_q, q0, sq);
  load_t<D>(dOt, dout + head_q, q0, sq);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_t<D>(Kt, k + head_k, k0, sk);
    load_t<D>(Vt, v + head_k, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product<D>(s, Qt, Kt, ty, tx);
    tile_product<D>(dp, dOt, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float b =
            row < sq && col < sk
                ? bias_of(bias, bh, bias_div, bias_rows, row, col, sk)
                : 0.f;
        float pv, ds;
        p_and_ds<kDropout>(s[i][j], dp[i][j], b, row, col, sq, sk, scale,
                           causal, offset, m_r[i], il_r[i], delta_r[i], key,
                           row_hash[i], threshold, drop_scale, pv, ds);
        dSs[(ty + 16 * i) * kLd + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    times_t<D>(acc, dSs, Kt, ty, tx);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* out = dq + head_q + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) out[tx + 16 * c] = acc[i][c] * scale;
  }
}

// dbias: kRowBias (RS = S_q) one CTA per (group, q tile, k tile) over the
// group's members; else (RS = 1) one CTA per (group, k tile) over the
// members and every q tile, the 64 rows summed in order at the end.
template <int D, bool kRowBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_dbias_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ row_max_in,
                       const float* __restrict__ row_sum_in,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias,
                       const int* __restrict__ seed, float* __restrict__ dbias,
                       int members, int sq, int sk, int nq, int nk, float scale,
                       int causal, int offset, uint32_t threshold,
                       float drop_scale) {
  extern __shared__ float smem[];
  float* Qt = smem;
  float* dOt = Qt + D * kLd;
  float* Kt = dOt + D * kLd;
  float* Vt = Kt + D * kLd;
  float* sums = Vt + D * kLd;  // RS = 1: the 64 rows' sums
  const int kt = static_cast<int>(blockIdx.x % nk);
  const int rest = static_cast<int>(blockIdx.x / nk);
  const int g = kRowBias ? rest / nq : rest;
  const int q_first = kRowBias ? rest % nq : 0;
  const int q_stop = kRowBias ? q_first + 1 : nq;
  const int k0 = kt * kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t bias_g = static_cast<size_t>(g) * (kRowBias ? sq : 1) * sk;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < members; ++t) {
    const int bh = g * members + t;
    const size_t head_q = static_cast<size_t>(bh) * sq * D;
    const size_t head_k = static_cast<size_t>(bh) * sk * D;
    uint32_t key = 0;
    if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
    for (int qt = q_first; qt < q_stop; ++qt) {
      const int q0 = qt * kB;
      // a tile with no live pair has ds = 0 (uniform over the CTA)
      if (causal && k0 > min(q0 + kB, sq) - 1 + offset) continue;
      __syncthreads();
      load_t<D>(Qt, q + head_q, q0, sq);
      load_t<D>(dOt, dout + head_q, q0, sq);
      load_t<D>(Kt, k + head_k, k0, sk);
      load_t<D>(Vt, v + head_k, k0, sk);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_product<D>(s, Qt, Kt, ty, tx);
      tile_product<D>(dp, dOt, Vt, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= sq) continue;
        const size_t ri = static_cast<size_t>(bh) * sq + row;
        const float m_r = row_max_in[ri], il_r = 1.f / row_sum_in[ri];
        const float delta_r = delta[ri];
        uint32_t row_hash = 0;
        if constexpr (kDropout) row_hash = flash_operands::dropout_row(key, row);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          if (col >= sk) continue;
          const float b = flash_operands::bias_at(
              bias + bias_g + (kRowBias ? static_cast<size_t>(row) * sk : 0),
              col);
          float pv, ds;
          p_and_ds<kDropout>(s[i][j], dp[i][j], b, row, col, sq, sk, scale,
                             causal, offset, m_r, il_r, delta_r, key, row_hash,
                             threshold, drop_scale, pv, ds);
          acc[i][j] += ds;
        }
      }
    }
  }

  if constexpr (kRowBias) {
    const int q0 = q_first * kB;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= sq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col < sk) dbias[bias_g + static_cast<size_t>(row) * sk + col] = acc[i][j];
      }
    }
  } else {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sums[(ty + 16 * i) * kLd + tx + 16 * j] = acc[i][j];
    __syncthreads();
    if (threadIdx.x < kB && k0 + static_cast<int>(threadIdx.x) < sk) {
      float sum = 0.f;
      for (int r = 0; r < kB; ++r) sum += sums[r * kLd + threadIdx.x];
      dbias[bias_g + k0 + threadIdx.x] = sum;
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, bool kDropout>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               const void* seed, void* o, void* lse, void* m, void* l, int bh,
               int sq, int sk, int bias_div, int bias_rows, float scale,
               int causal, int offset, uint32_t threshold, float drop_scale,
               cudaStream_t stream) {
  auto* kernel = &flash_fwd_f32_kernel<D, kDropout>;
  constexpr size_t bytes = fwd_smem<D>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (sq + kB - 1) / kB;
  kernel<<<dim3(static_cast<unsigned>(bh) * n_tiles), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<float*>(m), static_cast<float*>(l),
      bh, sq, sk, scale, causal, offset, bias_div, bias_rows, threshold,
      drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDropout>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* m, const void* l, const void* delta,
               const void* bias, const void* seed, void* dq, void* dk,
               void* dv, int bh, int sq, int sk, int bias_div, int bias_rows,
               float scale, int causal, int offset, uint32_t threshold,
               float drop_scale, cudaStream_t stream) {
  auto* dkdv = &flash_bwd_dkdv_f32_kernel<D, kDropout>;
  auto* dqk = &flash_bwd_dq_f32_kernel<D, kDropout>;
  constexpr size_t bytes = bwd_smem<D>();
  cudaError_t err = allow_smem(dkdv, bytes);
  if (err == cudaSuccess) err = allow_smem(dqk, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* op = static_cast<const float*>(dout);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* dp = static_cast<const float*>(delta);
  const float* bp = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(seed);
  const int nk = (sk + kB - 1) / kB;
  const int nq = (sq + kB - 1) / kB;
  dkdv<<<dim3(static_cast<unsigned>(bh) * nk), kThreads, bytes, stream>>>(
      qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, sq, sk, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(static_cast<unsigned>(bh) * nq), kThreads, bytes, stream>>>(
      qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<float*>(dq), bh, sq, sk,
      scale, causal, offset, bias_div, bias_rows, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kRowBias, bool kDropout>
int launch_dbias(const void* q, const void* k, const void* v, const void* dout,
                 const void* m, const void* l, const void* delta,
                 const void* bias, const void* seed, void* dbias, int groups,
                 int members, int sq, int sk, float scale, int causal,
                 int offset, uint32_t threshold, float drop_scale,
                 cudaStream_t stream) {
  auto* kernel = &flash_dbias_f32_kernel<D, kRowBias, kDropout>;
  constexpr size_t bytes = sizeof(float) * (4 * D * kLd + kB * kLd);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (sq + kB - 1) / kB;
  const int nk = (sk + kB - 1) / kB;
  const size_t ctas = static_cast<size_t>(groups) * (kRowBias ? nq : 1) * nk;
  if (ctas > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(static_cast<unsigned>(ctas)), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<float*>(dbias), members, sq,
      sk, nq, nk, scale, causal, offset, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int bh, int sq, int sk, int d, int groups, int bias_rows) {
  return bh <= 0 || sq <= 0 || sk <= 0 || (d != 32 && d != 64 && d != 128) ||
         groups <= 0 || bh % groups != 0 ||
         (bias_rows != 1 && bias_rows != sq);
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The C entry points take the arguments of their bf16 counterparts
// (flash_fwd.cu, flash_bwd.cu, flash_dbias.cu) with f32 q, k, v, dO, o, dq,
// dk and dv.  d must be 32, 64 or 128.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, void* o,
                             void* lse, void* m, void* l, int bh, int sq,
                             int sk, int d, int groups, int bias_rows,
                             float scale, int causal, unsigned threshold,
                             float drop_scale, void* stream) {
  if (bad_args(bh, sq, sk, d, groups, bias_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = decltype(&launch_fwd<64, false>);
  const bool drop = seed != nullptr;
  const Fn run = d == 32   ? (drop ? &launch_fwd<32, true> : &launch_fwd<32, false>)
                 : d == 64 ? (drop ? &launch_fwd<64, true> : &launch_fwd<64, false>)
                           : (drop ? &launch_fwd<128, true> : &launch_fwd<128, false>);
  return run(q, k, v, bias, seed, o, lse, m, l, bh, sq, sk, bh / groups,
             bias_rows, scale, causal, sk - sq, threshold, drop_scale,
             static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             const void* delta, const void* bias,
                             const void* seed, void* dq, void* dk, void* dv,
                             int bh, int sq, int sk, int d, int groups,
                             int bias_rows, float scale, int causal,
                             unsigned threshold, float drop_scale,
                             void* stream) {
  if (bad_args(bh, sq, sk, d, groups, bias_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = decltype(&launch_bwd<64, false>);
  const bool drop = seed != nullptr;
  const Fn run = d == 32   ? (drop ? &launch_bwd<32, true> : &launch_bwd<32, false>)
                 : d == 64 ? (drop ? &launch_bwd<64, true> : &launch_bwd<64, false>)
                           : (drop ? &launch_bwd<128, true> : &launch_bwd<128, false>);
  return run(q, k, v, dout, m, l, delta, bias, seed, dq, dk, dv, bh, sq, sk,
             bh / groups, bias_rows, scale, causal, sk - sq, threshold,
             drop_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_dbias_f32(const void* q, const void* k, const void* v,
                               const void* dout, const void* m, const void* l,
                               const void* delta, const void* bias,
                               const void* seed, void* dbias, int bh, int sq,
                               int sk, int d, int groups, int bias_rows,
                               float scale, int causal, unsigned threshold,
                               float drop_scale, void* stream) {
  if (bias == nullptr || bad_args(bh, sq, sk, d, groups, bias_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = decltype(&launch_dbias<64, true, false>);
  // with sq = 1 the two layouts coincide and the RS = 1 path serves both
  const bool row = bias_rows != 1, drop = seed != nullptr;
  Fn run;
  if (d == 32)
    run = row ? (drop ? &launch_dbias<32, true, true> : &launch_dbias<32, true, false>)
              : (drop ? &launch_dbias<32, false, true> : &launch_dbias<32, false, false>);
  else if (d == 64)
    run = row ? (drop ? &launch_dbias<64, true, true> : &launch_dbias<64, true, false>)
              : (drop ? &launch_dbias<64, false, true> : &launch_dbias<64, false, false>);
  else
    run = row ? (drop ? &launch_dbias<128, true, true> : &launch_dbias<128, true, false>)
              : (drop ? &launch_dbias<128, false, true> : &launch_dbias<128, false, false>);
  return run(q, k, v, dout, m, l, delta, bias, seed, dbias, groups,
             bh / groups, sq, sk, scale, causal, sk - sq, threshold,
             drop_scale, static_cast<cudaStream_t>(stream));
}
