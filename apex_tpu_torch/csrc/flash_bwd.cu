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
//           here.  The entry flash_bwd_dbias also replaces flash_dbias
//           (_dbias_kernel) where each dbias element has one owner (G =
//           BH, RS = S_q): see the dQ pass below.
// Bound on the H100: tensor-core operations.  Five products of 2*D flops
//           per live (q, k) pair (the recompute Q K^T, dO V^T, P^T dO,
//           dS K, dS^T Q: 2.5x the forward's count) against reading q, k,
//           v, dO and writing dq, dk, dv once: ~1.25*S flops per byte at
//           causal D = 64, so the least time is the live-pair flops /
//           989 TFLOP/s (bf16 dense).  The two passes below do seven
//           products (the recompute twice).
// Design:   the TPU's two passes, kept because neither needs atomics, so
//           the gradients are the same bits from run to run.  Both are
//           built like K3 (flash_fwd.cu): two consumer warpgroups of 64
//           rows (wgmma's M) and a producer warpgroup that hands its
//           registers to them (setmaxnreg) and streams tiles through a
//           ring of shared-memory stages (3 without a bias, 2 with one)
//           with TMA (3-D tensor maps (D, S, BH), 128-byte swizzle at
//           D = 64, 64-byte at D = 32), each stage guarded by a full and an
//           empty mbarrier; every product runs on wgmma with f32
//           accumulators in registers, and P and dS go to the next product
//           as bf16 register A operands.
//           dK/dV: one CTA per (batch*head, 128-key tile), heaviest
//           first; K and V are loaded once, each warpgroup owns 64 keys
//           and keeps its dK and dV sums in registers for the whole loop.
//           The ring carries 64-row Q and dO tiles and the rows' m, 1/l
//           and delta (plain loads by one producer warp's lanes, issued
//           one tile ahead, which then arrive on the stage's full barrier
//           beside the TMA bytes).  Per q tile: S^T = K Q^T and dP^T = V dO^T (A and B
//           from shared memory), P^T and dS^T formed in registers, then
//           dV += P^T dO and dK += dS^T Q with dO and Q transposed from
//           shared memory.  Under causal masking a (64-key, 64-row) block
//           with no live pair is skipped unless it holds fully-masked
//           rows (row + offset < 0, Sq > Sk): those rows' p is 1/Sk (the
//           forward averaged V uniformly) and still feeds dV, as the
//           TPU's include_fully_masked rule keeps them.
//           dQ: one CTA per (batch*head, 128-row q tile), heaviest first;
//           Q, dO and the rows' statistics stay resident, the ring runs
//           over 64-key K and V tiles up to each warpgroup's causal
//           limit: S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K
//           with K transposed from shared memory; a fully-masked row gets
//           dq = 0 (the mask blocks its gradient).  With a trainable bias
//           at G = BH and RS = S_q (flash_bwd_dbias, its own __global__
//           flash_bwd_dq_dbias_kernel) the dQ pass also writes K5's
//           output: each tile's f32 ds, which the bias differentiates to,
//           leaves the registers as dbias before it is rounded for dQ
//           (float2 stores from the accumulator layout, eight full 32-byte
//           sectors a warp store; zeros for the key tiles the causal walk
//           skips; at D = 256 only the first of the two CTAs of a q tile
//           writes).  That costs one f32 write of the bias's size, where a
//           separate K5 recomputes S and dP and reads q, k, v, dO and the
//           bias again; each element is written once, so dbias is the
//           same bits from run to run.
//           p and ds are formed in f32 and rounded to bf16 for the next
//           products, as the TPU's bf16 MXU passes do.  p = exp(s - m) / l
//           from the forward's row max m and row sum l, not exp(s - lse)
//           as on the TPU: a row that a bias masks completely has lse =
//           MASK_VALUE + log(S_k), which f32 rounds back to MASK_VALUE, so
//           exp(s - lse) would give 1 where the softmax is 1/S_k (the
//           Pallas kernel patches only the causal case, with a closed
//           form); with m and l every fully-masked row, causal or by bias,
//           gets 1/S_k and needs no special case.  Blocks with no masked
//           pair and no ragged row or key skip the masks and, without a
//           bias, fold the scale into one FFMA before exp2.  Bias (s*scale
//           + max(bias, PAD_VALUE), then the causal mask): a (G, S_q, S_k)
//           bias with S_k % 4 == 0 rides the ring as 128-byte swizzled TMA
//           boxes of 32 keys, which the dK/dV pass reads transposed (8
//           keys of 4 queries per warp load, on distinct banks); a
//           key-padding row (RS = 1) or a row stride TMA cannot map is
//           read per score from global memory.  The dropout keep mask is
//           re-hashed from (seed, bh, row, col): dv += (D*p)^T dO and ds =
//           p*(D*dp - delta) with D = keep / (1 - p_drop).  Causally
//           masked pairs have ds = 0 (the mask is a where() on the
//           score); their p is 0 unless the whole row is masked.  The
//           ragged edge (rows past S_q, keys past S_k) reads zeros from
//           TMA and is masked here.  Head dims 32, 64, 128 and 256, as K3
//           (the wrapper pads any other head dim to the next with zeros).  At
//           D = 128 a tile is two 64-column blocks (hopper.cuh,
//           TileLayout), and the dK/dV pass splits by halves of D: dK and
//           dV of 64 keys x 128 would take 128 f32 registers a thread
//           beside S^T and dP^T, past
//           the 168 that ptxas gives each instance (it allocates no more
//           after setmaxnreg: the unsplit pass spilled up to 2 KB), so each
//           of two CTAs per key tile recomputes S^T and dP^T and accumulates
//           one 64-column half of dK and dV (the register profile of D =
//           64, at 1.5x the pass's products); the bias is read inside the
//           elementwise pass rather than into 32 registers ahead of it.
//           Above 128 (the D = 256 instance) the products that reduce over
//           D (S^T, dP^T, S, dP) loop over the tiles' four 64-column blocks
//           into the same registers, the dK/dV pass runs four CTAs per key
//           tile (one per 64 columns of dK and dV) and the dQ pass two per
//           q tile (one per 128 columns of dQ), each recomputing the scores
//           over all of D; the ring has one stage (two would pass 227 KB).
//           Above 256 (any multiple of 128; the wrapper pads to it) a wide
//           instance of each pass takes the head dim at run time and keeps
//           no tile resident: the products over D stream K, V, Q and dO
//           through a ring one 64-column block a stage, the dK/dV pass
//           taking its own block last and holding that stage for dV and dK,
//           the dQ pass reading K's slice from a second ring (the wide
//           kernels below), so shared memory does not grow with D.
//           One template instance per head dim, bias mode and dropout.  Not
//           yet used: overlap of the elementwise pass with the next
//           tile's products, persistent CTAs (ROADMAP B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_operands.cuh"
#include "hopper.cuh"
#include "launch_query.cuh"

namespace {

using flash_operands::kMaskValue;
using namespace hopper;

using bf16 = __nv_bfloat16;

using flash_operands::kBiasGlobal;
using flash_operands::kBiasTile;
using flash_operands::kNoBias;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kResident = 64 * kConsumers;        // rows a CTA keeps
constexpr int kBlock = 64;  // rows of a ring stage: the producer's lanes
                            // load two each

constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr float kLog2e = 1.4426950408889634f;
// the staged bias of one stage (kBlock x kResident f32 either way round)
constexpr int kStageBiasBytes = kBlock * kResident * 4;

// The ring's depth of each bias mode (measured with
// apex_tpu_torch/tools/flash_tiles.py, whose sweep overrides it through
// the macro below D = 128, where 3 stages with a bias would pass the 227
// KB of shared memory): 3 stages without a bias, 2 with one; one at D =
// 256, whose resident tiles take 128 KB.
template <int D, int kBias>
__host__ __device__ constexpr int stages() {
#ifdef APEX_FLASH_BWD_STAGES
  if (D < 128) return APEX_FLASH_BWD_STAGES;
#endif
  if (D > 128) return 1;
  return kBias == kNoBias ? 3 : 2;
}

// The CTAs per key tile of the dK/dV pass, each accumulating D / split of
// the head dims: one 64-column block each from D = 128 on (see Design).
template <int D>
__host__ __device__ constexpr int dkdv_split() {
  return D >= 128 ? D / 64 : 1;
}

// The CTAs per q tile of the dQ pass, each accumulating 128 of the head
// dims above D = 128.
template <int D>
__host__ __device__ constexpr int dq_split() {
  return D > 128 ? D / 128 : 1;
}

template <int kBias>
__host__ __device__ constexpr int stage_bias_bytes() {
  return kBias == kBiasTile ? kStageBiasBytes : 0;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// Two resident tiles of kResident rows and the stages of two kBlock-row
// tiles, the staged bias (and, for dK/dV, three rows of kBlock f32
// statistics).
template <int D, int kBias, bool kStats>
constexpr size_t smem_bytes() {
  constexpr int kStages = stages<D, kBias>();
  return 1024 + size_t{2} * D * 2 * (kResident + kStages * kBlock) +
         size_t{stage_bias_bytes<kBias>()} * kStages +
         (kStats ? sizeof(float) * 3 * kBlock * kStages : 0) +
         sizeof(uint64_t) * (2 * kStages + 1);
}

// Whether the 64 keys from kw0 take part in the 64-row q tile qt.
__device__ __forceinline__ bool block_live(int qt, int kw0, int sq, int sk,
                                           int causal, int offset) {
  if (kw0 >= sk) return false;
  if (!causal) return true;
  const int q0 = qt * kBlock;
  const int q_last = min(q0 + kBlock, sq) - 1;
  return q_last + offset >= kw0 || q0 + offset < 0;
}

// Write this thread's two rows (row0, row0 + 8) of a warpgroup's 64 x
// kWidth f32 accumulator, times `scale`, as bf16 rows kStride apart of
// `out` below `limit`.
template <int kWidth, int kStride>
__device__ __forceinline__ void store_rows(const float (&acc)[kWidth / 2],
                                           bf16* out, int row0, int limit,
                                           float scale) {
  const int quad = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= limit) continue;
    bf16* og = out + static_cast<size_t>(row) * kStride + 2 * quad;
#pragma unroll
    for (int j = 0; j < kWidth / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int D, int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_bias,
                      const float* __restrict__ row_max,
                      const float* __restrict__ row_sum,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias,
                      const int* __restrict__ seed, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int bh_count, int sq, int sk,
                      float scale, int causal, int offset, int bias_div,
                      int bias_rows, uint32_t threshold, float drop_scale) {
  constexpr int kStages = stages<D, kBias>();
  constexpr int kBiasBytes = stage_bias_bytes<kBias>();
  constexpr bool kHasBias = kBias != kNoBias;
  using L = TileLayout<D>;
  constexpr int kAtom = L::kAtomBytes;
  constexpr int kRowBytes = 2 * D;
  constexpr int kResBytes = kResident * kRowBytes;
  constexpr int kTileBytes = kBlock * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align_1024(smem_raw);
  unsigned char* Vs = Ks + kResBytes;
  unsigned char* Qs = Vs + kResBytes;              // kStages tiles
  unsigned char* dOs = Qs + kStages * kTileBytes;  // kStages tiles
  unsigned char* Bs = dOs + kStages * kTileBytes;  // kStages bias tiles
  float* stats = reinterpret_cast<float*>(Bs + kStages * kBiasBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 3 * kBlock * kStages);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  // the head dims [half * kOutD, (half + 1) * kOutD) of dK and dV that this
  // CTA accumulates (all of them below D = 128; see Design): from D = 128
  // on, column block `half` of the tiles
  constexpr int kSplit = dkdv_split<D>();
  constexpr int kOutD = D / kSplit;
  const int half = static_cast<int>(blockIdx.x % kSplit);
  const int rest = static_cast<int>(blockIdx.x / kSplit);
  const int bh = rest % bh_count;
  const int k0 = (rest / bh_count) * kResident;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (sq + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);               // the producer warp's lanes
      mbar_init(&empty[s], 4 * kConsumers);  // one per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one warp
    setmaxnreg_dec<24>();
    if (warp > 4 * kConsumers) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * kResBytes);
      tma_load_tile<D, kResident>(Ks, &tm_k, kv_full, k0, bh);
      tma_load_tile<D, kResident>(Vs, &tm_v, kv_full, k0, bh);
    }
    // each lane loads rows lane and lane + 32 of a q tile's m, 1/l and
    // delta one live tile ahead, so the loads wait behind the ring
    const size_t base = static_cast<size_t>(bh) * sq;
    auto next_live = [&](int qt) {
      while (qt < nq && !block_live(qt, k0, sq, sk, causal, offset) &&
             !block_live(qt, k0 + 64, sq, sk, causal, offset))
        ++qt;
      return qt;
    };
    float row_stats[2][3];
    auto fetch = [&](int qt) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = qt * kBlock + lane + 32 * k;
        const bool in = qt < nq && r < sq;
        row_stats[k][0] = in ? row_max[base + r] : 0.f;
        row_stats[k][1] = in ? 1.f / row_sum[base + r] : 0.f;
        row_stats[k][2] = in ? delta[base + r] : 0.f;
      }
    };
    int qt = next_live(0);
    fetch(qt);
    for (int t = 0; qt < nq; ++t) {
      const int s = t % kStages;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      float* st = stats + 3 * kBlock * s;
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          st[c * kBlock + lane + 32 * k] = row_stats[k][c];
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * kTileBytes + kBiasBytes);
        tma_load_tile<D, kBlock>(Qs + s * kTileBytes, &tm_q, &full[s],
                                 qt * kBlock, bh);
        tma_load_tile<D, kBlock>(dOs + s * kTileBytes, &tm_do, &full[s],
                                 qt * kBlock, bh);
        if constexpr (kBias == kBiasTile)
          for (int b = 0; b < kResident / 32; ++b)
            tma_load_3d(Bs + s * kBiasBytes + b * kBlock * 128, &tm_bias,
                        &full[s], k0 + 32 * b, qt * kBlock, bh / bias_div);
      } else {
        mbar_arrive(&full[s]);
      }
      qt = next_live(qt + 1);
      fetch(qt);
    }
    return;
  }

  setmaxnreg_inc<240>();
  // a consumer: warpgroup wg owns keys [kw0, kw0 + 64); this thread holds
  // keys krow0 and krow0 + 8 (the accumulators' rows) and queries
  // 8j + 2 quad + e of the tile (their columns)
  const int wg = warp >> 2;
  const int kw0 = k0 + 64 * wg;
  const int quad = lane & 3;
  const int krow0 = kw0 + 16 * (warp & 3) + (lane >> 2);

  // the bias of the group; with one key-padding row (RS = 1) the two
  // keys' values (keys past S_k, never written, read the last key's)
  const float* bias_g = nullptr;
  float bias_k[2] = {0.f, 0.f};
  if constexpr (kBias == kBiasGlobal) {
    bias_g = flash_operands::bias_row(bias, bh, bias_div, bias_rows, 0, sk);
    if (bias_rows == 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bias_k[h] = flash_operands::bias_at(bias_g, min(krow0 + 8 * h, sk - 1));
  }
  uint32_t key = 0;
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);

  const float scale_log2 = scale * kLog2e;
  float acc_dk[kOutD / 2], acc_dv[kOutD / 2];
#pragma unroll
  for (int i = 0; i < kOutD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  const uint64_t k_desc = make_desc<kAtom>(Ks + wg * 64 * kAtom);
  const uint64_t v_desc = make_desc<kAtom>(Vs + wg * 64 * kAtom);
  // at D = 128 the bias is read inside the elementwise pass (see Design)
  constexpr bool kBiasAhead = kHasBias && D < 128;

  int t = 0;
  for (int qt = 0; qt < nq; ++qt) {
    const bool mine = block_live(qt, kw0, sq, sk, causal, offset);
    if (!block_live(qt, k0, sq, sk, causal, offset) &&
        !block_live(qt, k0 + 64, sq, sk, causal, offset))
      continue;
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (mine) {
      const int q0 = qt * kBlock;
      const uint64_t q_desc = make_desc<kAtom>(Qs + s * kTileBytes);
      const uint64_t do_desc = make_desc<kAtom>(dOs + s * kTileBytes);
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float acc_s[kBlock / 2], acc_dp[kBlock / 2];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(acc_s, desc_add(k_desc, L::template kmajor_step<kResident>(kk)),
                 desc_add(q_desc, L::template kmajor_step<kBlock>(kk)), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(acc_dp, desc_add(v_desc, L::template kmajor_step<kResident>(kk)),
                 desc_add(do_desc, L::template kmajor_step<kBlock>(kk)), 1);
      wgmma_commit();

      // the bias of score (query 8j + 2 quad + e of the tile, key krow0 +
      // 8h): global memory (keys and rows past the edge read 0), or the
      // staged (query, key) tile read transposed, whose warp reads of 8
      // keys of 4 queries hit distinct banks
      auto bias_of = [&](int j, int e, int h) -> float {
        if constexpr (kBias == kBiasGlobal) {
          const int qrow = q0 + 8 * j + 2 * quad + e;
          const int krow = krow0 + 8 * h;
          return bias_rows == 1 ? bias_k[h]
                 : qrow < sq && krow < sk
                     ? flash_operands::bias_at(
                           bias_g + static_cast<size_t>(qrow) * sk, krow)
                     : 0.f;
        } else if constexpr (kBias == kBiasTile) {
          return fmaxf(*flash_operands::bias_tile_at<kBlock>(
                           Bs + s * kBiasBytes, 8 * j + 2 * quad + e,
                           krow0 - k0 + 8 * h),
                       flash_operands::kPadValue);
        } else {
          return 0.f;
        }
      };
      float bv[kBlock / 2];
      if constexpr (kBiasAhead) {
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) bv[4 * j + 2 * h + e] = bias_of(j, e, h);
      }
      wgmma_wait();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // P^T and dS^T in f32, rounded to bf16 as the next products' A.  A
      // block with no masked pair and no ragged row or key (not "edge")
      // skips the masks, and without a bias folds the scale into the
      // exponent; elsewhere p = exp(s - m) takes the difference first,
      // exact for a fully masked row (s = m = MASK_VALUE).
      const float* st = stats + 3 * kBlock * s;
      auto elementwise = [&](auto edge_tag) {
        constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * quad + e;
            const int qrow = q0 + c;
            const float m_c = st[c], il_c = st[kBlock + c];
            const float delta_c = st[2 * kBlock + c];
            uint32_t row_hash = 0;
            if constexpr (kDropout)
              row_hash = flash_operands::dropout_row(key, qrow);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              const int krow = krow0 + 8 * h;
              float pv = 0.f, ds = 0.f;
              if (!kEdge || (qrow < sq && krow < sk)) {
                const bool masked =
                    kEdge && causal && krow > qrow + offset;
                float p;
                if constexpr (!kEdge && !kHasBias) {
                  p = ex2(fmaf(acc_s[i], scale_log2, -m_c * kLog2e)) * il_c;
                } else {
                  float x = kMaskValue;
                  if (!masked) {
                    x = acc_s[i] * scale;
                    if constexpr (kHasBias)
                      x = fmaf(acc_s[i], scale,
                               kBiasAhead ? bv[i] : bias_of(j, e, h));
                  }
                  p = __expf(x - m_c) * il_c;
                }
                float dp = acc_dp[i];
                pv = p;
                if constexpr (kDropout) {
                  const float keep = flash_operands::dropout_keep(
                                         key, row_hash, krow, threshold)
                                         ? drop_scale
                                         : 0.f;
                  pv = p * keep;
                  dp *= keep;
                }
                if (!masked) ds = p * (dp - delta_c);
              }
              acc_s[i] = pv;
              acc_dp[i] = ds;
            }
          }
      };
      const bool edge = q0 + kBlock > sq || kw0 + 64 > sk ||
                        (causal && kw0 + 63 > q0 + offset);
      if (edge)
        elementwise(std::true_type{});
      else
        elementwise(std::false_type{});
      uint32_t pa[kBlock / 4], dsa[kBlock / 4];
#pragma unroll
      for (int i = 0; i < kBlock / 4; ++i) {
        pa[i] = pack_bf16(acc_s[2 * i], acc_s[2 * i + 1]);
        dsa[i] = pack_bf16(acc_dp[2 * i], acc_dp[2 * i + 1]);
      }

      // dV += P^T dO and dK += dS^T Q over this CTA's head dims, dO and Q
      // transposed: N = kOutD, within one column block from D = 128 on
      const uint32_t cols = half * kBlock * kAtom;
      const uint64_t do_t = make_desc<kAtom>(dOs + s * kTileBytes + cols,
                                             kBlock * kAtom);
      const uint64_t q_t =
          make_desc<kAtom>(Qs + s * kTileBytes + cols, kBlock * kAtom);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        wgmma_rs(acc_dv, pa + 4 * kk, desc_add(do_t, L::mnmajor_step(kk)), 1);
        wgmma_rs(acc_dk, dsa + 4 * kk, desc_add(q_t, L::mnmajor_step(kk)), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    ++t;
  }

  const size_t base = static_cast<size_t>(bh) * sk * D + half * kOutD;
  store_rows<kOutD, D>(acc_dk, dk + base, krow0, sk, scale);
  store_rows<kOutD, D>(acc_dv, dv + base, krow0, sk, 1.f);
}

// Write this thread's part of a warpgroup's 64-row x 64-key f32 tile
// (rows row0 and row0 + 8, keys col0 + 8j + 2 quad + e, the accumulator
// layout of wgmma) into the (S_q, S_k) f32 rows of `out`, below sq and sk:
// a quad's two adjacent keys as one float2 where S_k is even (each warp
// store fills eight whole 32-byte sectors), else one float each.
__device__ __forceinline__ void store_dbias_tile(const float (&acc)[kBlock / 2],
                                                 float* out, int row0,
                                                 int col0, int sq, int sk) {
  const int quad = threadIdx.x & 3;
  const bool pairs = (sk & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    float* o = out + static_cast<size_t>(row) * sk;
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      const int col = col0 + 8 * j + 2 * quad;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (pairs) {
        if (col < sk) *reinterpret_cast<float2*>(o + col) = make_float2(x, y);
      } else {
        if (col < sk) o[col] = x;
        if (col + 1 < sk) o[col + 1] = y;
      }
    }
  }
}

// The dQ pass (see Design); with kDbias (a bias at G = BH, RS = S_q, where
// each dbias element has one owner) it also writes K5's output: each
// tile's f32 ds, before it is rounded for dQ += dS K, is dbias[bh, row,
// key], and the key tiles that the causal walk skips get zeros, as K5
// writes an element for every (row, key).  With dq_split 2 (D = 256) the
// CTA of part 0 writes it.  Each element is written once, so dbias is the
// same bits from run to run.
template <int D, int kBias, bool kDropout, bool kDbias>
__device__ __forceinline__ void dq_pass(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_do, const CUtensorMap& tm_bias,
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    const float* __restrict__ delta, const float* __restrict__ bias,
    const int* __restrict__ seed, bf16* __restrict__ dq,
    float* __restrict__ dbias, int bh_count, int sq, int sk, float scale,
    int causal, int offset, int bias_div, int bias_rows, uint32_t threshold,
    float drop_scale) {
  static_assert(!kDbias || kBias != kNoBias, "dbias needs a bias");
  constexpr int kStages = stages<D, kBias>();
  constexpr int kBiasBytes = stage_bias_bytes<kBias>();
  constexpr bool kHasBias = kBias != kNoBias;
  using L = TileLayout<D>;
  constexpr int kAtom = L::kAtomBytes;
  constexpr int kRowBytes = 2 * D;
  constexpr int kResBytes = kResident * kRowBytes;
  constexpr int kTileBytes = kBlock * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* dOs = Qs + kResBytes;
  unsigned char* Ks = dOs + kResBytes;            // kStages tiles
  unsigned char* Vs = Ks + kStages * kTileBytes;  // kStages tiles
  unsigned char* Bs = Vs + kStages * kTileBytes;  // kStages bias tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBiasBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  // the head dims [part * kOutD, (part + 1) * kOutD) of dQ that this CTA
  // accumulates (all of them up to D = 128; see Design)
  constexpr int kSplit = dq_split<D>();
  constexpr int kOutD = D / kSplit;
  const int n_tiles = (sq + kResident - 1) / kResident;
  const int part = static_cast<int>(blockIdx.x % kSplit);
  const int rest = static_cast<int>(blockIdx.x / kSplit);
  const int bh = rest % bh_count;
  const int q0 = (n_tiles - 1 - rest / bh_count) * kResident;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // each warpgroup's keys [0, k_end): up to the causal limit of its last row
  int k_end[kConsumers];
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) {
    const int wq0 = q0 + 64 * w;
    const int q_last = min(wq0 + 64, sq) - 1;
    k_end[w] = wq0 >= sq ? 0
               : causal  ? max(0, min(sk, q_last + offset + 1))
                         : sk;
  }
  const int n_kt = (max(k_end[0], k_end[1]) + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one thread
    setmaxnreg_dec<24>();
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(q_full, 2 * kResBytes);
      tma_load_tile<D, kResident>(Qs, &tm_q, q_full, q0, bh);
      tma_load_tile<D, kResident>(dOs, &tm_do, q_full, q0, bh);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes + kBiasBytes);
        tma_load_tile<D, kBlock>(Ks + s * kTileBytes, &tm_k, &full[s],
                                 t * kBlock, bh);
        tma_load_tile<D, kBlock>(Vs + s * kTileBytes, &tm_v, &full[s],
                                 t * kBlock, bh);
        if constexpr (kBias == kBiasTile)
          for (int b = 0; b < kBlock / 32; ++b)
            tma_load_3d(Bs + s * kBiasBytes + b * kResident * 128, &tm_bias,
                        &full[s], t * kBlock + 32 * b, q0, bh / bias_div);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  // a consumer: rows row0 and row0 + 8 of warpgroup wg's 64
  const int wg = warp >> 2;
  const int quad = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int my_kt = (k_end[wg] + kBlock - 1) / kBlock;
  // this batch-head's (S_q, S_k) dbias rows (64-bit: BH * S_q * S_k is 67
  // M at the evoformer's triangle shape)
  float* dbias_bh = nullptr;
  if constexpr (kDbias) dbias_bh = dbias + static_cast<size_t>(bh) * sq * sk;

  float m_r[2], il_r[2], delta_r[2];
  const float* brow[2] = {nullptr, nullptr};
  uint32_t key = 0, row_hash[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const size_t ri = static_cast<size_t>(bh) * sq + row;
    m_r[h] = row < sq ? row_max[ri] : 0.f;
    il_r[h] = row < sq ? 1.f / row_sum[ri] : 0.f;
    delta_r[h] = row < sq ? delta[ri] : 0.f;
    // rows past S_q, never written, read the last row's bias
    if constexpr (kBias == kBiasGlobal)
      brow[h] = flash_operands::bias_row(bias, bh, bias_div, bias_rows,
                                         min(row, sq - 1), sk);
    if constexpr (kDropout) {
      key = flash_operands::dropout_key(seed, bh);
      row_hash[h] = flash_operands::dropout_row(key, row);
    }
  }

  const float scale_log2 = scale * kLog2e;
  const float mb_r[2] = {m_r[0] * kLog2e, m_r[1] * kLog2e};
  float acc_dq[kOutD / 2];
#pragma unroll
  for (int i = 0; i < kOutD / 2; ++i) acc_dq[i] = 0.f;

  mbar_wait(q_full, 0);
  const uint64_t q_desc = make_desc<kAtom>(Qs + wg * 64 * kAtom);
  const uint64_t do_desc = make_desc<kAtom>(dOs + wg * 64 * kAtom);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (t < my_kt) {
      const uint64_t k_desc = make_desc<kAtom>(Ks + s * kTileBytes);
      const uint64_t v_desc = make_desc<kAtom>(Vs + s * kTileBytes);
      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
      float acc_s[kBlock / 2], acc_dp[kBlock / 2];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(acc_s, desc_add(q_desc, L::template kmajor_step<kResident>(kk)),
                 desc_add(k_desc, L::template kmajor_step<kBlock>(kk)), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(acc_dp, desc_add(do_desc, L::template kmajor_step<kResident>(kk)),
                 desc_add(v_desc, L::template kmajor_step<kBlock>(kk)), 1);
      wgmma_commit();

      const int c0 = t * kBlock + 2 * quad;
      float bv[kBlock / 2];
      if constexpr (kBias == kBiasGlobal) {
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c0 + 8 * j + e;
              bv[4 * j + 2 * h + e] =
                  col < sk ? flash_operands::bias_at(brow[h], col) : 0.f;
            }
      } else if constexpr (kBias == kBiasTile) {
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 b2 = *reinterpret_cast<const float2*>(
                flash_operands::bias_tile_at<kResident>(
                    Bs + s * kBiasBytes, row0 - q0 + 8 * h,
                    8 * j + 2 * quad));
            bv[4 * j + 2 * h] = fmaxf(b2.x, flash_operands::kPadValue);
            bv[4 * j + 2 * h + 1] = fmaxf(b2.y, flash_operands::kPadValue);
          }
      }
      wgmma_wait();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // dS in f32, rounded to bf16 as the next product's A; a tile with
      // no masked pair and no ragged row or key skips the masks, as in
      // the dK/dV pass
      auto elementwise = [&](auto edge_tag) {
        constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const int col = c0 + 8 * j + e;
              const int row = row0 + 8 * h;
              float ds = 0.f;
              if (!kEdge ||
                  (row < sq && col < sk && (!causal || col <= row + offset))) {
                float p;
                if constexpr (!kEdge && !kHasBias) {
                  p = ex2(fmaf(acc_s[i], scale_log2, -mb_r[h])) * il_r[h];
                } else {
                  float x = acc_s[i] * scale;
                  if constexpr (kHasBias) x = fmaf(acc_s[i], scale, bv[i]);
                  p = __expf(x - m_r[h]) * il_r[h];
                }
                float dp = acc_dp[i];
                if constexpr (kDropout)
                  dp = flash_operands::dropout_keep(key, row_hash[h], col,
                                                    threshold)
                           ? dp * drop_scale
                           : 0.f;
                ds = p * (dp - delta_r[h]);
              }
              acc_s[i] = ds;
            }
      };
      const bool edge = (t + 1) * kBlock > sk || q0 + 64 * (wg + 1) > sq ||
                        (causal && (t + 1) * kBlock - 1 > q0 + 64 * wg + offset);
      if (edge)
        elementwise(std::true_type{});
      else
        elementwise(std::false_type{});
      if constexpr (kDbias)
        if (part == 0) store_dbias_tile(acc_s, dbias_bh, row0, t * kBlock, sq, sk);
      uint32_t dsa[kBlock / 4];
#pragma unroll
      for (int i = 0; i < kBlock / 4; ++i)
        dsa[i] = pack_bf16(acc_s[2 * i], acc_s[2 * i + 1]);

      // dQ += dS K, K transposed: N = kOutD spans this CTA's column blocks
      const uint64_t k_t = make_desc<kAtom>(
          Ks + s * kTileBytes + part * (kOutD / 64) * kBlock * kAtom,
          kBlock * kAtom);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        wgmma_rs(acc_dq, dsa + 4 * kk, desc_add(k_t, L::mnmajor_step(kk)), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if constexpr (kDbias) {
    // the key tiles past this warpgroup's causal limit: ds is 0 there
    if (part == 0) {
      float zeros[kBlock / 2];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i) zeros[i] = 0.f;
      for (int t = my_kt; t * kBlock < sk; ++t)
        store_dbias_tile(zeros, dbias_bh, row0, t * kBlock, sq, sk);
    }
  }
  store_rows<kOutD, D>(acc_dq,
                       dq + static_cast<size_t>(bh) * sq * D + part * kOutD,
                       row0, sq, scale);
}

template <int D, int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_bias,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias,
                    const int* __restrict__ seed, bf16* __restrict__ dq,
                    int bh_count, int sq, int sk, float scale, int causal,
                    int offset, int bias_div, int bias_rows,
                    uint32_t threshold, float drop_scale) {
  dq_pass<D, kBias, kDropout, false>(
      tm_q, tm_k, tm_v, tm_do, tm_bias, row_max, row_sum, delta, bias, seed,
      dq, nullptr, bh_count, sq, sk, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
}

// The dQ pass with K5's dbias as its epilogue (its own name, so a profile
// reports its time apart from the plain pass)
template <int D, int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_dbias_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_bias,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias,
                          const int* __restrict__ seed, bf16* __restrict__ dq,
                          float* __restrict__ dbias, int bh_count, int sq,
                          int sk, float scale, int causal, int offset,
                          int bias_div, int bias_rows, uint32_t threshold,
                          float drop_scale) {
  dq_pass<D, kBias, kDropout, true>(
      tm_q, tm_k, tm_v, tm_do, tm_bias, row_max, row_sum, delta, bias, seed,
      dq, dbias, bh_count, sq, sk, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
}

// ------------------------------------------------------- the wide instance
//
// Any head dim above 256 (a multiple of 128; the wrapper pads to it), the
// number of 64-column blocks d / 64 a run-time argument.  No tile stays
// resident: the products that reduce over D (S^T and dP^T, or S and dP)
// stream both operands through ring A one 64-column block a stage, all
// four of them (K, V, Q, dO) in one stage, summed in the same registers.
// dK/dV: a q tile's blocks come in an order that ends with the CTA's own
// 64 columns, and the consumers hold that last stage until dV += P^T dO
// and dK += dS^T Q have read its Q and dO blocks; ring B carries the q
// tile's m, 1/l, delta and staged bias tile.  dQ: ring B carries each key
// tile's slice of K (128 columns) and its staged bias tile.  So shared
// memory does not grow with d.  Grids, walks and the elementwise pass are
// the D = 256 instance's.
constexpr int kWideStagesA = 3;
constexpr int kWideBlkBytes = kBlock * 128;        // 64 rows x 64 bf16
constexpr int kWideResBlkBytes = kResident * 128;  // 128 rows x 64 bf16
constexpr int kWideABytes = 2 * (kWideBlkBytes + kWideResBlkBytes);

template <int kBias>
__host__ __device__ constexpr int wide_stages_b(bool stats) {
  return stats || kBias != kBiasTile ? 2 : 1;
}

// ring B's stage: the staged bias tile and (dK/dV) the statistics, or
// (dQ) K's slice and the bias tile; a multiple of 1024 bytes
template <int kBias>
__host__ __device__ constexpr int wide_b_bytes(bool stats) {
  return ((stats ? 3 * kBlock * 4 : kBlock * 2 * 128) +
          stage_bias_bytes<kBias>() + 1023) /
         1024 * 1024;
}

template <int kBias>
constexpr size_t wide_smem_bytes(bool stats) {
  return 1024 + size_t{kWideStagesA} * kWideABytes +
         size_t{wide_stages_b<kBias>(stats)} * wide_b_bytes<kBias>(stats) +
         sizeof(uint64_t) * 2 * (kWideStagesA + 2);
}

// store_rows with a row stride known at run time
template <int kWidth>
__device__ __forceinline__ void store_rows_d(const float (&acc)[kWidth / 2],
                                             bf16* out, int row0, int limit,
                                             int stride, float scale) {
  const int quad = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= limit) continue;
    bf16* og = out + static_cast<size_t>(row) * stride + 2 * quad;
#pragma unroll
    for (int j = 0; j < kWidth / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_bias,
                           const float* __restrict__ row_max,
                           const float* __restrict__ row_sum,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           const int* __restrict__ seed, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int bh_count, int sq, int sk,
                           int d, float scale, int causal, int offset,
                           int bias_div, int bias_rows, uint32_t threshold,
                           float drop_scale) {
  constexpr int kStagesB = wide_stages_b<kBias>(true);
  constexpr int kBBytes = wide_b_bytes<kBias>(true);
  constexpr int kBiasBytes = stage_bias_bytes<kBias>();
  constexpr bool kHasBias = kBias != kNoBias;
  // a stage of ring A: K block, V block (128 keys), Q block, dO block (64
  // rows)
  constexpr int kVOff = kWideResBlkBytes, kQOff = 2 * kWideResBlkBytes;
  constexpr int kDOOff = kQOff + kWideBlkBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_a = align_1024(smem_raw);
  unsigned char* ring_b = ring_a + kWideStagesA * kWideABytes;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring_b + kStagesB * kBBytes);
  uint64_t* empty_a = full_a + kWideStagesA;
  uint64_t* full_b = empty_a + kWideStagesA;
  uint64_t* empty_b = full_b + kStagesB;

  const int nb = d / 64;
  const int half = static_cast<int>(blockIdx.x % nb);
  const int rest = static_cast<int>(blockIdx.x / nb);
  const int bh = rest % bh_count;
  const int k0 = (rest / bh_count) * kResident;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (sq + kBlock - 1) / kBlock;
  // the column block of a q tile's i-th stage: the others in order, then
  // this CTA's own
  auto block_of = [&](int i) {
    return i == nb - 1 ? half : i < half ? i : i + 1;
  };
  auto live_any = [&](int qt) {
    return block_live(qt, k0, sq, sk, causal, offset) ||
           block_live(qt, k0 + 64, sq, sk, causal, offset);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStagesA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], 4 * kConsumers);
    }
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(&full_b[s], 32);  // the producer warp's lanes
      mbar_init(&empty_b[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one warp
    setmaxnreg_dec<24>();
    if (warp > 4 * kConsumers) return;
    const size_t base = static_cast<size_t>(bh) * sq;
    auto next_live = [&](int qt) {
      while (qt < nq && !live_any(qt)) ++qt;
      return qt;
    };
    float row_stats[2][3];
    auto fetch = [&](int qt) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = qt * kBlock + lane + 32 * k;
        const bool in = qt < nq && r < sq;
        row_stats[k][0] = in ? row_max[base + r] : 0.f;
        row_stats[k][1] = in ? 1.f / row_sum[base + r] : 0.f;
        row_stats[k][2] = in ? delta[base + r] : 0.f;
      }
    };
    int qt = next_live(0), ta = 0;
    fetch(qt);
    for (int t = 0; qt < nq; ++t) {
      if (lane == 0) {
        for (int i = 0; i < nb; ++i, ++ta) {
          const int s = ta % kWideStagesA, col = 64 * block_of(i);
          mbar_wait(&empty_a[s], ((ta / kWideStagesA) & 1) ^ 1);
          mbar_expect_tx(&full_a[s], kWideABytes);
          unsigned char* st = ring_a + s * kWideABytes;
          tma_load_3d(st, &tm_k, &full_a[s], col, k0, bh);
          tma_load_3d(st + kVOff, &tm_v, &full_a[s], col, k0, bh);
          tma_load_3d(st + kQOff, &tm_q, &full_a[s], col, qt * kBlock, bh);
          tma_load_3d(st + kDOOff, &tm_do, &full_a[s], col, qt * kBlock, bh);
        }
      }
      const int s = t % kStagesB;
      mbar_wait(&empty_b[s], ((t / kStagesB) & 1) ^ 1);
      unsigned char* st = ring_b + s * kBBytes;
      float* stats = reinterpret_cast<float*>(st + kBiasBytes);
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          stats[c * kBlock + lane + 32 * k] = row_stats[k][c];
      if (lane == 0) {
        mbar_expect_tx(&full_b[s], kBiasBytes);
        if constexpr (kBias == kBiasTile)
          for (int b = 0; b < kResident / 32; ++b)
            tma_load_3d(st + b * kBlock * 128, &tm_bias, &full_b[s],
                        k0 + 32 * b, qt * kBlock, bh / bias_div);
      } else {
        mbar_arrive(&full_b[s]);
      }
      qt = next_live(qt + 1);
      fetch(qt);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int kw0 = k0 + 64 * wg;
  const int quad = lane & 3;
  const int krow0 = kw0 + 16 * (warp & 3) + (lane >> 2);

  const float* bias_g = nullptr;
  float bias_k[2] = {0.f, 0.f};
  if constexpr (kBias == kBiasGlobal) {
    bias_g = flash_operands::bias_row(bias, bh, bias_div, bias_rows, 0, sk);
    if (bias_rows == 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bias_k[h] = flash_operands::bias_at(bias_g, min(krow0 + 8 * h, sk - 1));
  }
  uint32_t key = 0;
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);

  const float scale_log2 = scale * kLog2e;
  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  int ta = 0, tb = 0;
  for (int qt = 0; qt < nq; ++qt) {
    if (!live_any(qt)) continue;
    const bool mine = block_live(qt, kw0, sq, sk, causal, offset);
    const int q0 = qt * kBlock;
    // S^T = K Q^T and dP^T = V dO^T, one column block a stage
    float acc_s[kBlock / 2], acc_dp[kBlock / 2];
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;
    int s_last = 0;
    for (int i = 0; i < nb; ++i, ++ta) {
      const int s = ta % kWideStagesA;
      mbar_wait(&full_a[s], (ta / kWideStagesA) & 1);
      if (mine) {
        const unsigned char* st = ring_a + s * kWideABytes;
        const uint64_t k_desc = make_desc<128>(st + wg * 64 * 128);
        const uint64_t v_desc = make_desc<128>(st + kVOff + wg * 64 * 128);
        const uint64_t q_desc = make_desc<128>(st + kQOff);
        const uint64_t do_desc = make_desc<128>(st + kDOOff);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc_s, desc_add(k_desc, 32 * kk), desc_add(q_desc, 32 * kk),
                   1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc_dp, desc_add(v_desc, 32 * kk),
                   desc_add(do_desc, 32 * kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc_s);
        fence_regs(acc_dp);
      }
      if (i < nb - 1) {  // the last block's stage is held for dV and dK
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_a[s]);
      } else {
        s_last = s;
      }
    }

    const int sb = tb % kStagesB;
    mbar_wait(&full_b[sb], (tb / kStagesB) & 1);
    if (mine) {
      const unsigned char* Bs = ring_b + sb * kBBytes;
      const float* st = reinterpret_cast<const float*>(Bs + kBiasBytes);
      auto bias_of = [&](int j, int e, int h) -> float {
        if constexpr (kBias == kBiasGlobal) {
          const int qrow = q0 + 8 * j + 2 * quad + e;
          const int krow = krow0 + 8 * h;
          return bias_rows == 1 ? bias_k[h]
                 : qrow < sq && krow < sk
                     ? flash_operands::bias_at(
                           bias_g + static_cast<size_t>(qrow) * sk, krow)
                     : 0.f;
        } else if constexpr (kBias == kBiasTile) {
          return fmaxf(*flash_operands::bias_tile_at<kBlock>(
                           Bs, 8 * j + 2 * quad + e, krow0 - k0 + 8 * h),
                       flash_operands::kPadValue);
        } else {
          return 0.f;
        }
      };
      // P^T and dS^T, as the fixed instances form them
      auto elementwise = [&](auto edge_tag) {
        constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * quad + e;
            const int qrow = q0 + c;
            const float m_c = st[c], il_c = st[kBlock + c];
            const float delta_c = st[2 * kBlock + c];
            uint32_t row_hash = 0;
            if constexpr (kDropout)
              row_hash = flash_operands::dropout_row(key, qrow);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              const int krow = krow0 + 8 * h;
              float pv = 0.f, ds = 0.f;
              if (!kEdge || (qrow < sq && krow < sk)) {
                const bool masked = kEdge && causal && krow > qrow + offset;
                float p;
                if constexpr (!kEdge && !kHasBias) {
                  p = ex2(fmaf(acc_s[i], scale_log2, -m_c * kLog2e)) * il_c;
                } else {
                  float x = kMaskValue;
                  if (!masked) {
                    x = acc_s[i] * scale;
                    if constexpr (kHasBias)
                      x = fmaf(acc_s[i], scale, bias_of(j, e, h));
                  }
                  p = __expf(x - m_c) * il_c;
                }
                float dp = acc_dp[i];
                pv = p;
                if constexpr (kDropout) {
                  const float keep = flash_operands::dropout_keep(
                                         key, row_hash, krow, threshold)
                                         ? drop_scale
                                         : 0.f;
                  pv = p * keep;
                  dp *= keep;
                }
                if (!masked) ds = p * (dp - delta_c);
              }
              acc_s[i] = pv;
              acc_dp[i] = ds;
            }
          }
      };
      const bool edge = q0 + kBlock > sq || kw0 + 64 > sk ||
                        (causal && kw0 + 63 > q0 + offset);
      if (edge)
        elementwise(std::true_type{});
      else
        elementwise(std::false_type{});
      uint32_t pa[kBlock / 4], dsa[kBlock / 4];
#pragma unroll
      for (int i = 0; i < kBlock / 4; ++i) {
        pa[i] = pack_bf16(acc_s[2 * i], acc_s[2 * i + 1]);
        dsa[i] = pack_bf16(acc_dp[2 * i], acc_dp[2 * i + 1]);
      }

      // dV += P^T dO and dK += dS^T Q over this CTA's 64 columns: the held
      // stage's dO and Q blocks, transposed
      const unsigned char* sa = ring_a + s_last * kWideABytes;
      const uint64_t do_t = make_desc<128>(sa + kDOOff, kBlock * 128);
      const uint64_t q_t = make_desc<128>(sa + kQOff, kBlock * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        wgmma_rs(acc_dv, pa + 4 * kk, desc_add(do_t, 16 * kk * 128), 1);
        wgmma_rs(acc_dk, dsa + 4 * kk, desc_add(q_t, 16 * kk * 128), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty_a[s_last]);
      mbar_arrive(&empty_b[sb]);
    }
    ++tb;
  }

  const size_t base = static_cast<size_t>(bh) * sk * d + half * 64;
  store_rows_d<64>(acc_dk, dk + base, krow0, sk, d, scale);
  store_rows_d<64>(acc_dv, dv + base, krow0, sk, d, 1.f);
}

template <int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_bias,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed, bf16* __restrict__ dq,
                         int bh_count, int sq, int sk, int d, float scale,
                         int causal, int offset, int bias_div, int bias_rows,
                         uint32_t threshold, float drop_scale) {
  constexpr int kStagesB = wide_stages_b<kBias>(false);
  constexpr int kBBytes = wide_b_bytes<kBias>(false);
  constexpr int kSliceBytes = kBlock * 2 * 128;  // 64 keys x 128 bf16
  constexpr bool kHasBias = kBias != kNoBias;
  // a stage of ring A: Q block, dO block (128 rows), K block, V block (64
  // keys)
  constexpr int kDOOff = kWideResBlkBytes, kKOff = 2 * kWideResBlkBytes;
  constexpr int kVOff = kKOff + kWideBlkBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_a = align_1024(smem_raw);
  unsigned char* ring_b = ring_a + kWideStagesA * kWideABytes;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring_b + kStagesB * kBBytes);
  uint64_t* empty_a = full_a + kWideStagesA;
  uint64_t* full_b = empty_a + kWideStagesA;
  uint64_t* empty_b = full_b + kStagesB;

  const int nb = d / 64, parts = d / 128;
  const int n_tiles = (sq + kResident - 1) / kResident;
  const int part = static_cast<int>(blockIdx.x % parts);
  const int rest = static_cast<int>(blockIdx.x / parts);
  const int bh = rest % bh_count;
  const int q0 = (n_tiles - 1 - rest / bh_count) * kResident;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int k_end[kConsumers];
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) {
    const int wq0 = q0 + 64 * w;
    const int q_last = min(wq0 + 64, sq) - 1;
    k_end[w] = wq0 >= sq ? 0
               : causal  ? max(0, min(sk, q_last + offset + 1))
                         : sk;
  }
  const int n_kt = (max(k_end[0], k_end[1]) + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStagesA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], 4 * kConsumers);
    }
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one thread
    setmaxnreg_dec<24>();
    if (warp == 4 * kConsumers && lane == 0) {
      int ta = 0;
      for (int t = 0; t < n_kt; ++t) {
        for (int c = 0; c < nb; ++c, ++ta) {
          const int s = ta % kWideStagesA;
          mbar_wait(&empty_a[s], ((ta / kWideStagesA) & 1) ^ 1);
          mbar_expect_tx(&full_a[s], kWideABytes);
          unsigned char* st = ring_a + s * kWideABytes;
          tma_load_3d(st, &tm_q, &full_a[s], 64 * c, q0, bh);
          tma_load_3d(st + kDOOff, &tm_do, &full_a[s], 64 * c, q0, bh);
          tma_load_3d(st + kKOff, &tm_k, &full_a[s], 64 * c, t * kBlock, bh);
          tma_load_3d(st + kVOff, &tm_v, &full_a[s], 64 * c, t * kBlock, bh);
        }
        const int s = t % kStagesB;
        mbar_wait(&empty_b[s], ((t / kStagesB) & 1) ^ 1);
        mbar_expect_tx(&full_b[s], kSliceBytes + stage_bias_bytes<kBias>());
        unsigned char* st = ring_b + s * kBBytes;
        tma_load_tile<128, kBlock>(st, &tm_k, &full_b[s], t * kBlock, bh,
                                   128 * part);
        if constexpr (kBias == kBiasTile)
          for (int b = 0; b < kBlock / 32; ++b)
            tma_load_3d(st + kSliceBytes + b * kResident * 128, &tm_bias,
                        &full_b[s], t * kBlock + 32 * b, q0, bh / bias_div);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int quad = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int my_kt = (k_end[wg] + kBlock - 1) / kBlock;

  float m_r[2], il_r[2], delta_r[2];
  const float* brow[2] = {nullptr, nullptr};
  uint32_t key = 0, row_hash[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const size_t ri = static_cast<size_t>(bh) * sq + row;
    m_r[h] = row < sq ? row_max[ri] : 0.f;
    il_r[h] = row < sq ? 1.f / row_sum[ri] : 0.f;
    delta_r[h] = row < sq ? delta[ri] : 0.f;
    if constexpr (kBias == kBiasGlobal)
      brow[h] = flash_operands::bias_row(bias, bh, bias_div, bias_rows,
                                         min(row, sq - 1), sk);
    if constexpr (kDropout) {
      key = flash_operands::dropout_key(seed, bh);
      row_hash[h] = flash_operands::dropout_row(key, row);
    }
  }

  const float scale_log2 = scale * kLog2e;
  const float mb_r[2] = {m_r[0] * kLog2e, m_r[1] * kLog2e};
  float acc_dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_dq[i] = 0.f;

  int ta = 0;
  for (int t = 0; t < n_kt; ++t) {
    const bool mine = t < my_kt;
    // S = Q K^T and dP = dO V^T, one column block a stage
    float acc_s[kBlock / 2], acc_dp[kBlock / 2];
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;
    for (int c = 0; c < nb; ++c, ++ta) {
      const int s = ta % kWideStagesA;
      mbar_wait(&full_a[s], (ta / kWideStagesA) & 1);
      if (mine) {
        const unsigned char* st = ring_a + s * kWideABytes;
        const uint64_t q_desc = make_desc<128>(st + wg * 64 * 128);
        const uint64_t do_desc = make_desc<128>(st + kDOOff + wg * 64 * 128);
        const uint64_t k_desc = make_desc<128>(st + kKOff);
        const uint64_t v_desc = make_desc<128>(st + kVOff);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc_s, desc_add(q_desc, 32 * kk), desc_add(k_desc, 32 * kk),
                   1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc_dp, desc_add(do_desc, 32 * kk),
                   desc_add(v_desc, 32 * kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc_s);
        fence_regs(acc_dp);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_a[s]);
    }

    const int sb = t % kStagesB;
    mbar_wait(&full_b[sb], (t / kStagesB) & 1);
    if (mine) {
      const unsigned char* Ks = ring_b + sb * kBBytes;
      const unsigned char* Bs = Ks + kSliceBytes;
      const int c0 = t * kBlock + 2 * quad;
      float bv[kBlock / 2];
      if constexpr (kBias == kBiasGlobal) {
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c0 + 8 * j + e;
              bv[4 * j + 2 * h + e] =
                  col < sk ? flash_operands::bias_at(brow[h], col) : 0.f;
            }
      } else if constexpr (kBias == kBiasTile) {
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 b2 = *reinterpret_cast<const float2*>(
                flash_operands::bias_tile_at<kResident>(
                    Bs, row0 - q0 + 8 * h, 8 * j + 2 * quad));
            bv[4 * j + 2 * h] = fmaxf(b2.x, flash_operands::kPadValue);
            bv[4 * j + 2 * h + 1] = fmaxf(b2.y, flash_operands::kPadValue);
          }
      }
      // dS, as the fixed instances form it
      auto elementwise = [&](auto edge_tag) {
        constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const int col = c0 + 8 * j + e;
              const int row = row0 + 8 * h;
              float ds = 0.f;
              if (!kEdge ||
                  (row < sq && col < sk && (!causal || col <= row + offset))) {
                float p;
                if constexpr (!kEdge && !kHasBias) {
                  p = ex2(fmaf(acc_s[i], scale_log2, -mb_r[h])) * il_r[h];
                } else {
                  float x = acc_s[i] * scale;
                  if constexpr (kHasBias) x = fmaf(acc_s[i], scale, bv[i]);
                  p = __expf(x - m_r[h]) * il_r[h];
                }
                float dp = acc_dp[i];
                if constexpr (kDropout)
                  dp = flash_operands::dropout_keep(key, row_hash[h], col,
                                                    threshold)
                           ? dp * drop_scale
                           : 0.f;
                ds = p * (dp - delta_r[h]);
              }
              acc_s[i] = ds;
            }
      };
      const bool edge = (t + 1) * kBlock > sk || q0 + 64 * (wg + 1) > sq ||
                        (causal && (t + 1) * kBlock - 1 > q0 + 64 * wg + offset);
      if (edge)
        elementwise(std::true_type{});
      else
        elementwise(std::false_type{});
      uint32_t dsa[kBlock / 4];
#pragma unroll
      for (int i = 0; i < kBlock / 4; ++i)
        dsa[i] = pack_bf16(acc_s[2 * i], acc_s[2 * i + 1]);

      // dQ += dS K over this CTA's 128 columns, K's slice transposed
      const uint64_t k_t = make_desc<128>(Ks, kBlock * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        wgmma_rs(acc_dq, dsa + 4 * kk, desc_add(k_t, 16 * kk * 128), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_b[sb]);
  }

  store_rows_d<128>(acc_dq, dq + static_cast<size_t>(bh) * sq * d + part * 128,
                    row0, sq, d, scale);
}

// D: 32, 64, 128 or 256, or 0 for the wide instance (d a multiple of 128
// above 256).  kDbias: the dQ pass also writes dbias (G = BH, RS = S_q,
// D <= 256).
template <int D, int kBias, bool kDropout, bool kDbias = false>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* m, const void* l, const void* delta, const void* bias,
           const void* seed, void* dq, void* dk, void* dv, void* dbias,
           int bh, int sq, int sk, int d, int bias_div, int bias_rows,
           float scale, int causal, int offset, uint32_t threshold,
           float drop_scale, cudaStream_t stream) {
  static_assert(!kDbias || (D > 0 && kBias != kNoBias),
                "the dbias epilogue is in the fixed instances' dQ pass");
  // the dK/dV pass keeps kResident keys and streams kBlock query rows; the
  // dQ pass the other way round
  CUtensorMap q_ring, do_ring, k_res, v_res, q_res, do_res, k_ring, v_ring;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int rows, box;
  } maps[] = {{&q_ring, q, sq, kBlock},      {&do_ring, dout, sq, kBlock},
              {&k_res, k, sk, kResident},    {&v_res, v, sk, kResident},
              {&q_res, q, sq, kResident},    {&do_res, dout, sq, kResident},
              {&k_ring, k, sk, kBlock},      {&v_ring, v, sk, kBlock}};
  for (const auto& mp : maps) {
    const cudaError_t err =
        hopper_host::make_map(mp.map, mp.ptr, bh, mp.rows, d, mp.box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the staged bias: (64 queries, 128 keys) tiles for dK/dV, (128, 64)
  // for dQ
  CUtensorMap bias_ring{}, bias_res{};
  if (kBias == kBiasTile) {
    cudaError_t err = hopper_host::make_bias_map(&bias_ring, bias,
                                                 bh / bias_div, sq, sk, kBlock);
    if (err == cudaSuccess)
      err = hopper_host::make_bias_map(&bias_res, bias, bh / bias_div, sq, sk,
                                       kResident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* dp = static_cast<const float*>(delta);
  const float* bp = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(seed);
  const int nk = (sk + kResident - 1) / kResident;
  const int nq = (sq + kResident - 1) / kResident;
  if constexpr (D == 0) {
    constexpr size_t dkdv_bytes = wide_smem_bytes<kBias>(true);
    constexpr size_t dq_bytes = wide_smem_bytes<kBias>(false);
    auto* dkdv_kernel = &flash_bwd_dkdv_wide_kernel<kBias, kDropout>;
    auto* dq_kernel = &flash_bwd_dq_wide_kernel<kBias, kDropout>;
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dq_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    { if (!apex_query::record(dkdv_kernel, dim3(static_cast<unsigned>(bh) * nk * (d / 64)), kThreads, dkdv_bytes)) dkdv_kernel<<<dim3(static_cast<unsigned>(bh) * nk * (d / 64)), kThreads,
                  dkdv_bytes, stream>>>(
        q_ring, k_res, v_res, do_ring, bias_ring, mp, lp, dp, bp, sp,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, sq, sk, d, scale,
        causal, offset, bias_div, bias_rows, threshold, drop_scale); }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    { if (!apex_query::record(dq_kernel, dim3(static_cast<unsigned>(bh) * nq * (d / 128)), kThreads, dq_bytes)) dq_kernel<<<dim3(static_cast<unsigned>(bh) * nq * (d / 128)), kThreads,
                dq_bytes, stream>>>(
        q_res, k_ring, v_ring, do_res, bias_res, mp, lp, dp, bp, sp,
        static_cast<bf16*>(dq), bh, sq, sk, d, scale, causal, offset,
        bias_div, bias_rows, threshold, drop_scale); }
    return static_cast<int>(cudaGetLastError());
  } else {
    constexpr size_t dkdv_bytes = smem_bytes<D, kBias, true>();
    constexpr size_t dq_bytes = smem_bytes<D, kBias, false>();
    auto* dkdv_kernel = &flash_bwd_dkdv_kernel<D, kBias, kDropout>;
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if constexpr (kDbias)
      err = cudaFuncSetAttribute(&flash_bwd_dq_dbias_kernel<D, kBias, kDropout>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dq_bytes));
    else
      err = cudaFuncSetAttribute(&flash_bwd_dq_kernel<D, kBias, kDropout>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dq_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    { if (!apex_query::record(dkdv_kernel, dim3(static_cast<unsigned>(bh) * nk * dkdv_split<D>()), kThreads, dkdv_bytes)) dkdv_kernel<<<dim3(static_cast<unsigned>(bh) * nk * dkdv_split<D>()),
                  kThreads, dkdv_bytes, stream>>>(
        q_ring, k_res, v_res, do_ring, bias_ring, mp, lp, dp, bp, sp,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, sq, sk, scale,
        causal, offset, bias_div, bias_rows, threshold, drop_scale); }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 dq_grid(static_cast<unsigned>(bh) * nq * dq_split<D>());
    if constexpr (kDbias)
      { if (!apex_query::record(&flash_bwd_dq_dbias_kernel<D, kBias, kDropout>, dq_grid, kThreads, dq_bytes)) flash_bwd_dq_dbias_kernel<D, kBias, kDropout>
          <<<dq_grid, kThreads, dq_bytes, stream>>>(
              q_res, k_ring, v_ring, do_res, bias_res, mp, lp, dp, bp, sp,
              static_cast<bf16*>(dq), static_cast<float*>(dbias), bh, sq, sk,
              scale, causal, offset, bias_div, bias_rows, threshold,
              drop_scale); }
    else
      { if (!apex_query::record(&flash_bwd_dq_kernel<D, kBias, kDropout>, dq_grid, kThreads, dq_bytes)) flash_bwd_dq_kernel<D, kBias, kDropout>
          <<<dq_grid, kThreads, dq_bytes, stream>>>(
              q_res, k_ring, v_ring, do_res, bias_res, mp, lp, dp, bp, sp,
              static_cast<bf16*>(dq), bh, sq, sk, scale, causal, offset,
              bias_div, bias_rows, threshold, drop_scale); }
    return static_cast<int>(cudaGetLastError());
  }
}

using LaunchFn = decltype(&launch<64, kNoBias, false>);

// The fused instances: a bias in either mode, with or without dropout
template <int D>
LaunchFn pick_dbias(int bias_mode, bool dropout) {
  if (bias_mode == kBiasTile)
    return dropout ? &launch<D, kBiasTile, true, true>
                   : &launch<D, kBiasTile, false, true>;
  return dropout ? &launch<D, kBiasGlobal, true, true>
                 : &launch<D, kBiasGlobal, false, true>;
}

template <int D>
LaunchFn pick(int bias_mode, bool dropout) {
  if (bias_mode == kBiasTile)
    return dropout ? &launch<D, kBiasTile, true> : &launch<D, kBiasTile, false>;
  if (bias_mode == kBiasGlobal)
    return dropout ? &launch<D, kBiasGlobal, true>
                   : &launch<D, kBiasGlobal, false>;
  return dropout ? &launch<D, kNoBias, true> : &launch<D, kNoBias, false>;
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, dout (bh, sq, d) and k, v (bh, sk, d) bf16, 16-byte aligned; m, l
// (K3's row max and row sum) and delta (bh, sq) f32; bias and seed as
// K3's (null when absent); dq (bh, sq, d), dk and dv (bh, sk, d) bf16.
// d must be 32, 64, 128, 256 or a multiple of 128 above 256.  The causal
// mask is aligned bottom-right.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* m, const void* l,
                         const void* delta, const void* bias, const void* seed,
                         void* dq, void* dk, void* dv, int bh, int sq, int sk,
                         int d, int groups, int bias_rows, float scale,
                         int causal, unsigned threshold, float drop_scale,
                         void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 ||
      (d != 32 && d != 64 && d != 128 && !(d >= 256 && d % 128 == 0)) ||
      groups <= 0 || bh % groups != 0 || (bias_rows != 1 && bias_rows != sq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = flash_operands::bias_mode(bias, bias_rows, sq, sk);
  const bool dropout = seed != nullptr;
  const LaunchFn run = d == 32    ? pick<32>(mode, dropout)
                       : d == 64  ? pick<64>(mode, dropout)
                       : d == 128 ? pick<128>(mode, dropout)
                       : d == 256 ? pick<256>(mode, dropout)
                                  : pick<0>(mode, dropout);
  return run(q, k, v, dout, m, l, delta, bias, seed, dq, dk, dv, nullptr, bh,
             sq, sk, d, bh / groups, bias_rows, scale, causal, sk - sq,
             threshold, drop_scale, static_cast<cudaStream_t>(stream));
}

// flash_bwd, and the gradient of the bias in the same launch (K5's
// function where each dbias element has one owner): bias (bh, sq, sk) f32
// (G = BH, RS = S_q) and dbias f32 of the same shape, written by the dQ
// pass.  d must be 32, 64, 128 or 256 (the wide instance and other
// layouts take flash_bwd, then flash_dbias).
extern "C" int flash_bwd_dbias(const void* q, const void* k, const void* v,
                               const void* dout, const void* m, const void* l,
                               const void* delta, const void* bias,
                               const void* seed, void* dq, void* dk, void* dv,
                               void* dbias, int bh, int sq, int sk, int d,
                               int groups, int bias_rows, float scale,
                               int causal, unsigned threshold,
                               float drop_scale, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 ||
      (d != 32 && d != 64 && d != 128 && d != 256) || bias == nullptr ||
      dbias == nullptr || groups != bh || bias_rows != sq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = flash_operands::bias_mode(bias, bias_rows, sq, sk);
  const bool dropout = seed != nullptr;
  const LaunchFn run = d == 32    ? pick_dbias<32>(mode, dropout)
                       : d == 64  ? pick_dbias<64>(mode, dropout)
                       : d == 128 ? pick_dbias<128>(mode, dropout)
                                  : pick_dbias<256>(mode, dropout);
  return run(q, k, v, dout, m, l, delta, bias, seed, dq, dk, dv, dbias, bh,
             sq, sk, d, 1, bias_rows, scale, causal, sk - sq, threshold,
             drop_scale, static_cast<cudaStream_t>(stream));
}
