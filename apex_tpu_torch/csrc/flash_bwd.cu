// K4: flash-attention backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py :: flash_bwd
//           (Pallas bodies _dkdv_kernel and _dq_kernel, recompute helper
//           _recompute_p) — dq, dk, dv by recomputing p = exp(s*scale - lse)
//           from the forward's f32 row logsumexp, bottom-right causal
//           alignment (offset S_k - S_q).  delta = rowsum(dO*O) - dlse is
//           computed outside the kernels, as the JAX package does in jnp,
//           so the dlse fold needs nothing here.
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
//           rows (row + offset < 0, Sq > Sk): those rows' p is the closed
//           form 1/Sk (the forward averaged V uniformly) and still feeds dV,
//           as the TPU's include_fully_masked rule keeps them.
//           dQ: one CTA per (batch*head, 64-row q tile), each warp owns 16
//           queries; the k loop stops at the tile's causal limit, and a
//           fully-masked row gets dq = 0 (the mask blocks its gradient).
//           Both recompute S and dP with wmma bf16 16x16x16 fragments and
//           f32 accumulation, form p and ds = p*(dp - delta) in f32 with
//           two lanes per row (interleaved columns, padded shared-memory
//           rows), and round p and ds to bf16 for the next products, as
//           the TPU's bf16 MXU passes do.  Masked pairs have p = 0 (the
//           forward's finite MASK_VALUE gives exp(-1e9 - lse) = 0) and
//           ds = 0; the ragged edge (rows past S_q, keys past S_k) is masked
//           here, with nothing padded.  Heaviest causal tiles first.  Head
//           dim 64 only, the port's models'.  Not yet used: wgmma, TMA,
//           cp.async pipelining (later work).

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
         + sizeof(float) * 2 * kBQ                      // lse, delta
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int bh_count, int sq, int sk,
                      float scale, int causal, int offset) {
  static_assert(D <= kSLd, "the f32 scratch rows stage D-wide outputs");
  constexpr int kLd = kTileLd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * kLd;
  bf16* Qs = Vs + kBK * kLd;
  bf16* dOs = Qs + kBQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dOs + kBQ * kLd);
  float* delta_s = lse_s + kBQ;
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
  const float* lse_b = lse + static_cast<size_t>(bh) * sq;
  const float* delta_b = delta + static_cast<size_t>(bh) * sq;

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

  const float inv_sk = 1.f / static_cast<float>(sk);
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
      lse_s[i] = in ? lse_b[q0 + i] : 0.f;
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
      float p = 0.f, ds = 0.f;
      if (qrow < sq) {
        if (causal && qrow + offset < 0) {
          p = inv_sk;  // fully-masked row: the closed form of its softmax
        } else if (!causal || krow <= qrow + offset) {
          p = __expf(srow[cl] * scale - lse_s[cl]);
          ds = p * (dprow[cl] - delta_s[cl]);
        }
      }
      prow[cl] = __float2bfloat16(p);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int bh_count, int sq, int sk, float scale, int causal,
                    int offset) {
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
  const float lse_r = row < sq ? lse[static_cast<size_t>(bh) * sq + row] : 0.f;
  const float delta_r =
      row < sq ? delta[static_cast<size_t>(bh) * sq + row] : 0.f;
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
        const float p = __expf(srow[cl] * scale - lse_r);
        ds = p * (dprow[cl] - delta_r);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int sq, int sk, float scale, int causal, int offset,
           cudaStream_t stream) {
  constexpr size_t dkdv_bytes = dkdv_smem_bytes<D>();
  constexpr size_t dq_bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const int nk = (sk + kBK - 1) / kBK;
  const int nq = (sq + kBQ - 1) / kBQ;
  flash_bwd_dkdv_kernel<D><<<dim3(static_cast<unsigned>(bh) * nk), kThreads,
                             dkdv_bytes, stream>>>(
      qp, kp, vp, op, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      bh, sq, sk, scale, causal, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3(static_cast<unsigned>(bh) * nq), kThreads,
                           dq_bytes, stream>>>(
      qp, kp, vp, op, lp, dp, static_cast<bf16*>(dq), bh, sq, sk, scale,
      causal, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, dout (bh, sq, d) and k, v (bh, sk, d) bf16; lse and delta (bh, sq)
// f32; dq (bh, sq, d), dk and dv (bh, sk, d) bf16.  d must be 64.  The
// causal mask is aligned bottom-right.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, int bh, int sq, int sk,
                         int d, float scale, int causal, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk, scale,
                    causal, sk - sq, static_cast<cudaStream_t>(stream));
}
