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
//           With a (BH, S, S) f32 bias the bias bytes bound it instead.
// Design:   persistent CTAs, one per SM, walk the work items (batch*head,
//           128-row q tile), heaviest causal tiles first, in rounds of the
//           grid that alternate direction, so the CTA that took one round's
//           heaviest item takes the next one's lightest.  Each CTA has two
//           consumer warpgroups of 64 rows each (wgmma's M) and a producer
//           warpgroup that hands its registers to them (setmaxnreg) and
//           issues every load from one thread. The producer loads each item's
//           Q tile into one of two buffers (so the next item's loads overlap
//           this one's epilogue, which matters at S = 128-256) and streams K
//           and V tiles through a ring of shared-memory stages with TMA (3-D
//           tensor maps (D, S, BH), so ragged rows read as zeros without
//           touching the next head; 128-byte swizzle at D = 64, 64-byte at D
//           = 32), each stage guarded by a full and an empty mbarrier: 128
//           keys and 3 stages without a bias, 64 keys and 2 stages with one
//           (Tile, measured by tools/flash_tiles.py).  Each consumer computes
//           S = Q K^T with wgmma (A and B from shared memory), runs the
//           online softmax on the accumulator registers (row max and sum
//           reduced over the quad that shares a row), converts P to bf16 in
//           registers and feeds it as wgmma's A operand for O += P V (V
//           transposed from shared memory); O stays in registers until the
//           epilogue writes o, lse, m and l.  Each warpgroup walks the keys
//           the old 64-row tiles walked: up to the causal limit of its last
//           row, rounded up to 64, or every key when its first row sees none
//           (like the TPU's include_fully_masked rule); masked scores take
//           the finite MASK_VALUE = -1e9 (flash_attention.py:49), so a row
//           that sees no key averages V uniformly, and keys past that walk or
//           past S_k get -inf and weigh exactly zero.  Tiles that no row sees
//           masked skip the masks and, without a bias, fold the scale into
//           one FFMA before exp2.  The TPU kernel's 128-lane broadcast of lse
//           is a tiling artifact of Mosaic and is dropped: lse is written as
//           (BH, S_q).  Bias (added after the scale, floored at PAD_VALUE,
//           before the causal mask): a (G, S_q, S_k) bias with S_k % 4 == 0
//           rides the ring as TMA boxes of 32 keys x 128 rows, 128-byte
//           swizzled so that each quad's float2 reads of 8 rows hit distinct
//           banks; a key-padding row (RS = 1) or a row stride TMA cannot map
//           is read per score from global memory in the accumulator layout (a
//           quad reads 32 contiguous bytes). Dropout: the seed is read from
//           device memory (no host sync); each thread hashes its two rows
//           once and each (row, col) it holds; m and l take the undropped p,
//           the bf16 P of the PV product takes keep ? p / (1 - p_drop) : 0.
//           Besides lse the kernel writes each row's m and l, from which K4
//           recomputes p = exp(s - m) / l: exact also for a row that a bias
//           masks completely, whose lse rounds back to MASK_VALUE in f32. One
//           template instance per head dim (32, 64, 128, 256), bias mode and
//           dropout; the wrapper pads any other head dim to the next
//           instance with zeros.  At D = 128 a tile is two 64-column
//           blocks (hopper.cuh, TileLayout) and the stages hold 64 keys (the
//           O accumulator is 64 f32 registers a thread).  Above 128 (the
//           D = 256 instance) QK^T loops over the four 64-column blocks of
//           the Q and K tiles into the same S registers, and O is split
//           over CTAs by slices of 128 columns (DV): a work item is (batch*
//           head, q tile, slice), each recomputing the scores over all of D
//           and staging only its slice of V, so the O accumulator stays at
//           64 registers; one Q buffer and two stages fit in 227 KB.
//           Above 256 (any multiple of 128; the wrapper pads to it) a wide
//           instance takes the head dim at run time: Q is no longer
//           resident, QK^T streams Q's and K's 64-column blocks through a
//           ring of its own, one pair a stage, and a second ring carries
//           each key tile's V slice and bias tile (flash_fwd_wide_kernel),
//           so shared memory does not grow with D.
//           Not yet used: overlap of one tile's softmax with the next tile's
//           QK^T (ROADMAP B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_operands.cuh"
#include "hopper.cuh"

namespace {

using flash_operands::kMaskValue;
using namespace hopper;

using bf16 = __nv_bfloat16;

using flash_operands::kBiasGlobal;
using flash_operands::kBiasTile;
using flash_operands::kNoBias;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kBlockQ = 64 * kConsumers;          // q rows per CTA
constexpr int kWalk = 64;  // the key walk's granularity (see Design)

constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr float kLog2e = 1.4426950408889634f;

// Keys per stage and the ring's depth of each bias mode (measured with
// apex_tpu_torch/tools/flash_tiles.py, whose sweep overrides them through
// the macros): 128 keys and 3 stages without a bias; 64 keys and 2 stages
// with one, which keeps the bias registers or the staged tile small.
template <int D, int kBias>
struct Tile {
  // the columns of O a CTA computes (see Design)
  static constexpr int kDV = D < 128 ? D : 128;
  // Q buffers: two (the next item's Q loads during this one's epilogue),
  // one at D = 256, where two would not fit
  static constexpr int kQBufs = D > 128 ? 1 : 2;
  // D >= 128 keeps 64 keys and its ring: 128 keys, or 3 stages with a
  // bias, would pass the 227 KB of shared memory
#ifdef APEX_FLASH_FWD_BLOCK_K
  static constexpr int kBlockK = D < 128 ? APEX_FLASH_FWD_BLOCK_K : 64;
#else
  static constexpr int kBlockK = kBias == kNoBias && D < 128 ? 128 : 64;
#endif
#ifdef APEX_FLASH_FWD_STAGES
  static constexpr int kStages =
      D < 128 ? APEX_FLASH_FWD_STAGES : kBias == kNoBias ? 3 : 2;
#else
  static constexpr int kStages = kBias == kNoBias ? 3 : 2;
#endif
  static_assert(kBlockK == 64 || kBlockK == 128, "wgmma N of QK^T");
  // the staged bias of one stage: kBlockK / 32 boxes of 32 keys x kBlockQ
  // rows of f32
  static constexpr int kBiasBytes = kBias == kBiasTile ? kBlockQ * kBlockK * 4
                                                       : 0;
};

template <int D, int kBias>
constexpr size_t smem_bytes() {
  using T = Tile<D, kBias>;
  return 1024                                                   // alignment
         + size_t{2} * D * T::kQBufs * kBlockQ                  // Q
         + size_t{2} * (D + T::kDV) * T::kStages * T::kBlockK   // K, V
         + size_t{T::kBiasBytes} * T::kStages                   // bias
         + sizeof(uint64_t) * (2 * T::kStages + 2 * T::kQBufs); // mbarriers
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// The keys [0, limit) that warpgroup rows [wq0, wq0 + 64) walk; 0 when
// none of them is a real row.
__device__ __forceinline__ int key_limit(int wq0, int sq, int sk, int causal,
                                         int offset) {
  if (wq0 >= sq) return 0;
  if (!causal || wq0 + offset < 0) return sk;
  const int q_last = min(wq0 + 64, sq) - 1;
  const int end = q_last + offset + 1;
  return min(sk, (end + kWalk - 1) / kWalk * kWalk);
}

template <int D, int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_bias,
                 const float* __restrict__ bias, const int* __restrict__ seed,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int bh_count, int sq, int sk, float scale, int causal,
                 int offset, int bias_div, int bias_rows, uint32_t threshold,
                 float drop_scale) {
  using T = Tile<D, kBias>;
  constexpr int kBlockK = T::kBlockK;
  constexpr int kStages = T::kStages;
  constexpr int kBiasBytes = T::kBiasBytes;
  constexpr int kDV = T::kDV;
  constexpr int kQBufs = T::kQBufs;
  constexpr int kSlices = D / kDV;
  constexpr bool kHasBias = kBias != kNoBias;
  using L = TileLayout<D>;
  using LV = TileLayout<kDV>;
  constexpr int kAtom = L::kAtomBytes;
  constexpr int kRowBytes = 2 * D;
  constexpr int kQBytes = kBlockQ * kRowBytes;
  constexpr int kKBytes = kBlockK * kRowBytes;
  constexpr int kVBytes = kBlockK * 2 * kDV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);     // kQBufs Q tiles
  unsigned char* Ks = Qs + kQBufs * kQBytes;
  unsigned char* Vs = Ks + kStages * kKBytes;   // the slice's columns of V
  unsigned char* Bs = Vs + kStages * kVBytes;   // the staged bias tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBiasBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;  // kQBufs each, one per Q tile
  uint64_t* q_empty = q_full + kQBufs;

  const int n_tiles = (sq + kBlockQ - 1) / kBlockQ;
  const int n_items = bh_count * kSlices * n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // work item w: batch-head and slice from w % (BH * slices), q tile
  // n_tiles - 1 - w / (BH * slices), so the heaviest causal tiles come
  // first; each warpgroup walks [0, lim0 or lim1), the CTA loads n_kt key
  // tiles
  struct Item {
    int bh, dv0, q0, lim0, lim1, n_kt;
  };
  // round r of the grid takes items [r G, r G + G) (G CTAs), forwards in
  // even rounds and backwards in odd ones: the CTA that took one round's
  // heaviest item takes the next round's lightest
  auto item_index = [&](int r) {
    const int g = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
    return r * g + ((r & 1) ? g - 1 - c : c);
  };
  auto item = [&](int w) {
    Item it;
    const int head = w % (bh_count * kSlices);
    it.bh = head / kSlices;
    it.dv0 = (head % kSlices) * kDV;
    it.q0 = (n_tiles - 1 - w / (bh_count * kSlices)) * kBlockQ;
    it.lim0 = key_limit(it.q0, sq, sk, causal, offset);
    it.lim1 = key_limit(it.q0 + 64, sq, sk, causal, offset);
    it.n_kt = (max(it.lim0, it.lim1) + kBlockK - 1) / kBlockK;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int b = 0; b < kQBufs; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one thread
    setmaxnreg_dec<24>();
    if (warp == 4 * kConsumers && lane == 0) {
      int t = 0;  // the ring's running count over all items
      for (int r = 0, n = 0; r * static_cast<int>(gridDim.x) < n_items; ++r) {
        const int w = item_index(r);
        if (w >= n_items) continue;
        const Item it = item(w);
        // the Q buffer and its phase by shifts: a signed % and / here
        // cost 7% at BERT's shape (PERF.md)
        const int qb = kQBufs == 1 ? 0 : n & 1;
        const uint32_t q_phase = (kQBufs == 1 ? n : n >> 1) & 1;
        ++n;
        mbar_wait(&q_empty[qb], q_phase ^ 1);
        mbar_expect_tx(&q_full[qb], kQBytes);
        tma_load_tile<D, kBlockQ>(Qs + qb * kQBytes, &tm_q, &q_full[qb], it.q0,
                                  it.bh);
        for (int kt = 0; kt < it.n_kt; ++kt, ++t) {
          const int s = t % kStages;
          mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kKBytes + kVBytes + kBiasBytes);
          tma_load_tile<D, kBlockK>(Ks + s * kKBytes, &tm_k, &full[s],
                                    kt * kBlockK, it.bh);
          tma_load_tile<kDV, kBlockK>(Vs + s * kVBytes, &tm_v, &full[s],
                                      kt * kBlockK, it.bh, it.dv0);
          if constexpr (kBias == kBiasTile)
            for (int b = 0; b < kBlockK / 32; ++b)
              tma_load_3d(Bs + s * kBiasBytes + b * kBlockQ * 128, &tm_bias,
                          &full[s], kt * kBlockK + 32 * b, it.q0,
                          it.bh / bias_div);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int quad = lane & 3;
  const float scale_log2 = scale * kLog2e;
  int t = 0;
  for (int r = 0, n = 0; r * static_cast<int>(gridDim.x) < n_items; ++r) {
    const int w = item_index(r);
    if (w >= n_items) continue;
    const Item it = item(w);
    const int bh = it.bh, q0 = it.q0;
    // warpgroup wg owns rows [wq0, wq0 + 64); this thread holds rows row0
    // and row0 + 8 of the accumulators, columns 8j + 2 quad + e
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (warp & 3) + (lane >> 2);
    const int col_lim = wg == 0 ? it.lim0 : it.lim1;
    const int my_kt = (col_lim + kBlockK - 1) / kBlockK;

    // the operands: the bias rows (rows past S_q, never written, read the
    // last row's) and the dropout hash of each row
    const float* brow[2] = {nullptr, nullptr};
    uint32_t key = 0, row_hash[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kBias == kBiasGlobal)
        brow[h] = flash_operands::bias_row(bias, bh, bias_div, bias_rows,
                                           min(row0 + 8 * h, sq - 1), sk);
      if constexpr (kDropout) {
        key = flash_operands::dropout_key(seed, bh);
        row_hash[h] = flash_operands::dropout_row(key, row0 + 8 * h);
      }
    }

    float acc_o[kDV / 2];
#pragma unroll
    for (int j = 0; j < kDV / 2; ++j) acc_o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const int qb = kQBufs == 1 ? 0 : n & 1;
    mbar_wait(&q_full[qb], (kQBufs == 1 ? n : n >> 1) & 1);
    ++n;
    const uint64_t q_desc =
        make_desc<kAtom>(Qs + qb * kQBytes + wg * 64 * kAtom);

    for (int kt = 0; kt < it.n_kt; ++kt, ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      if (kt < my_kt) {
        // S = Q K^T
        const uint64_t k_desc = make_desc<kAtom>(Ks + s * kKBytes);
        float acc_s[kBlockK / 2];
#pragma unroll
        for (int i = 0; i < kBlockK / 2; ++i) acc_s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(acc_s, desc_add(q_desc, L::template kmajor_step<kBlockQ>(kk)),
                   desc_add(k_desc, L::template kmajor_step<kBlockK>(kk)), 1);
        wgmma_commit();

        const int c0 = kt * kBlockK + 2 * quad;
        float bv[kBlockK / 2];
        if constexpr (kBias == kBiasGlobal) {
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = c0 + 8 * j + e;
                bv[4 * j + 2 * h + e] =
                    col < col_lim ? flash_operands::bias_at(brow[h], col) : 0.f;
              }
        } else if constexpr (kBias == kBiasTile) {
          // this thread's rows of the staged tile, two keys at a time
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 b2 = *reinterpret_cast<const float2*>(
                  flash_operands::bias_tile_at<kBlockQ>(
                      Bs + s * kBiasBytes, row0 - q0 + 8 * h,
                      8 * j + 2 * quad));
              bv[4 * j + 2 * h] = fmaxf(b2.x, flash_operands::kPadValue);
              bv[4 * j + 2 * h + 1] = fmaxf(b2.y, flash_operands::kPadValue);
            }
        }
        wgmma_wait();
        fence_regs(acc_s);

        // online softmax on the accumulator registers.  A tile that no
        // row of the warpgroup sees masked or past its walk (not "edge")
        // skips the masks, and without a bias keeps S unscaled and folds the
        // scale into the exponent (one FFMA); elsewhere p = exp(s - m) with
        // the difference taken first, exact when s and m are both
        // MASK_VALUE (a fully masked row) or both ~ -1e9 (a padding bias).
        uint32_t pa[kBlockK / 4];
        auto softmax = [&](auto edge_tag) {
          constexpr bool kEdge = decltype(edge_tag)::value;
          constexpr bool kRaw = !kEdge && !kHasBias;
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * h + e;
                const int col = c0 + 8 * j + e;
                float x = acc_s[i];
                if constexpr (kHasBias) x = fmaf(x, scale, bv[i]);
                else if constexpr (kEdge) x *= scale;
                if constexpr (kEdge) {
                  if (col >= col_lim) x = -INFINITY;
                  else if (causal && col > row0 + 8 * h + offset) x = kMaskValue;
                }
                acc_s[i] = x;
                mx[h] = fmaxf(mx[h], x);
              }
          float alpha[2], mb[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            if constexpr (kRaw) mx[h] *= scale;
            const float m_new = fmaxf(m[h], mx[h]);
            alpha[h] = __expf(m[h] - m_new);
            m[h] = m_new;
            mb[h] = m_new * kLog2e;
            l[h] *= alpha[h];
          }
#pragma unroll
          for (int i = 0; i < kDV / 2; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float pv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x = acc_s[4 * j + 2 * h + e];
                const float p = kRaw ? ex2(fmaf(x, scale_log2, -mb[h]))
                                     : __expf(x - m[h]);
                l[h] += p;
                pv[e] = p;
                if constexpr (kDropout)
                  pv[e] = flash_operands::dropout_keep(key, row_hash[h],
                                                       c0 + 8 * j + e, threshold)
                              ? p * drop_scale
                              : 0.f;
              }
              pa[2 * j + h] = pack_bf16(pv[0], pv[1]);
            }
        };
        const bool edge = (kt + 1) * kBlockK > col_lim ||
                          (causal && (kt + 1) * kBlockK - 1 > wq0 + offset);
        if (edge)
          softmax(std::true_type{});
        else
          softmax(std::false_type{});

        // O += P V
        const uint64_t v_desc = make_desc<LV::kAtomBytes>(
            Vs + s * kVBytes, kBlockK * LV::kAtomBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk)
          wgmma_rs(acc_o, pa + 4 * kk, desc_add(v_desc, LV::mnmajor_step(kk)),
                   1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc_o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);  // the last QK^T has read Q

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float inv = 1.f / l[h];
      bf16* og =
          o + (static_cast<size_t>(bh) * sq + row) * D + it.dv0 + 2 * quad;
#pragma unroll
      for (int j = 0; j < kDV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2 * h] * inv,
                                  acc_o[4 * j + 2 * h + 1] * inv);
      if (quad == 0 && it.dv0 == 0) {
        const size_t r = static_cast<size_t>(bh) * sq + row;
        lse[r] = m[h] + logf(l[h]);
        m_out[r] = m[h];
        l_out[r] = l[h];
      }
    }
  }
}

// ------------------------------------------------------- the wide instance
//
// Any head dim above 256 (a multiple of 128; the wrapper pads to it), the
// number of 64-column blocks d / 64 a run-time argument.  Q no longer stays
// resident: QK^T streams Q's and K's column blocks through ring A, one
// (128-row Q block, 64-key K block) pair a stage, and sums them in the S
// registers; ring B carries each key tile's slice of V (128 columns: O is
// split over work items as at D = 256) and its staged bias tile.  So
// shared memory does not grow with d.  The work items, key walk, softmax
// and epilogue are the D = 256 instance's.
constexpr int kWideStagesA = 4;
constexpr int kWideStagesB = 2;
constexpr int kWideBlockK = 64;
constexpr int kWideDV = 128;
constexpr int kQBlkBytes = kBlockQ * 128;      // 128 rows x 64 bf16
constexpr int kKBlkBytes = kWideBlockK * 128;  // 64 keys x 64 bf16

template <int kBias>
__host__ __device__ constexpr int wide_bias_bytes() {
  return kBias == kBiasTile ? kBlockQ * kWideBlockK * 4 : 0;
}

template <int kBias>
constexpr size_t wide_smem_bytes() {
  return 1024 + size_t{kWideStagesA} * (kQBlkBytes + kKBlkBytes) +
         size_t{kWideStagesB} *
             (kWideBlockK * 2 * kWideDV + wide_bias_bytes<kBias>()) +
         sizeof(uint64_t) * 2 * (kWideStagesA + kWideStagesB);
}

template <int kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_bias,
                      const float* __restrict__ bias,
                      const int* __restrict__ seed, bf16* __restrict__ o,
                      float* __restrict__ lse, float* __restrict__ m_out,
                      float* __restrict__ l_out, int bh_count, int sq, int sk,
                      int d, float scale, int causal, int offset,
                      int bias_div, int bias_rows, uint32_t threshold,
                      float drop_scale) {
  constexpr int kBlockK = kWideBlockK;
  constexpr int kDV = kWideDV;
  constexpr int kBiasBytes = wide_bias_bytes<kBias>();
  constexpr bool kHasBias = kBias != kNoBias;
  using LV = TileLayout<kDV>;
  constexpr int kABytes = kQBlkBytes + kKBlkBytes;
  constexpr int kVBytes = kBlockK * 2 * kDV;
  constexpr int kBBytes = kVBytes + kBiasBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_a = align_1024(smem_raw);   // Q block, K block
  unsigned char* ring_b = ring_a + kWideStagesA * kABytes;  // V slice, bias
  uint64_t* full_a =
      reinterpret_cast<uint64_t*>(ring_b + kWideStagesB * kBBytes);
  uint64_t* empty_a = full_a + kWideStagesA;
  uint64_t* full_b = empty_a + kWideStagesA;
  uint64_t* empty_b = full_b + kWideStagesB;

  const int nb = d / 64, slices = d / kDV;
  const int n_tiles = (sq + kBlockQ - 1) / kBlockQ;
  const int n_items = bh_count * slices * n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  struct Item {
    int bh, dv0, q0, lim0, lim1, n_kt;
  };
  auto item_index = [&](int r) {
    const int g = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
    return r * g + ((r & 1) ? g - 1 - c : c);
  };
  auto item = [&](int w) {
    Item it;
    const int head = w % (bh_count * slices);
    it.bh = head / slices;
    it.dv0 = (head % slices) * kDV;
    it.q0 = (n_tiles - 1 - w / (bh_count * slices)) * kBlockQ;
    it.lim0 = key_limit(it.q0, sq, sk, causal, offset);
    it.lim1 = key_limit(it.q0 + 64, sq, sk, causal, offset);
    it.n_kt = (max(it.lim0, it.lim1) + kBlockK - 1) / kBlockK;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStagesA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], 4 * kConsumers);
    }
    for (int s = 0; s < kWideStagesB; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one thread
    setmaxnreg_dec<24>();
    if (warp == 4 * kConsumers && lane == 0) {
      int ta = 0, tb = 0;  // each ring's running count over all items
      for (int r = 0; r * static_cast<int>(gridDim.x) < n_items; ++r) {
        const int w = item_index(r);
        if (w >= n_items) continue;
        const Item it = item(w);
        for (int kt = 0; kt < it.n_kt; ++kt) {
          for (int c = 0; c < nb; ++c, ++ta) {
            const int s = ta % kWideStagesA;
            mbar_wait(&empty_a[s], ((ta / kWideStagesA) & 1) ^ 1);
            mbar_expect_tx(&full_a[s], kABytes);
            unsigned char* st = ring_a + s * kABytes;
            tma_load_3d(st, &tm_q, &full_a[s], 64 * c, it.q0, it.bh);
            tma_load_3d(st + kQBlkBytes, &tm_k, &full_a[s], 64 * c,
                        kt * kBlockK, it.bh);
          }
          const int s = tb % kWideStagesB;
          mbar_wait(&empty_b[s], ((tb / kWideStagesB) & 1) ^ 1);
          mbar_expect_tx(&full_b[s], kBBytes);
          unsigned char* st = ring_b + s * kBBytes;
          tma_load_tile<kDV, kBlockK>(st, &tm_v, &full_b[s], kt * kBlockK,
                                      it.bh, it.dv0);
          if constexpr (kBias == kBiasTile)
            for (int b = 0; b < kBlockK / 32; ++b)
              tma_load_3d(st + kVBytes + b * kBlockQ * 128, &tm_bias,
                          &full_b[s], kt * kBlockK + 32 * b, it.q0,
                          it.bh / bias_div);
          ++tb;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int quad = lane & 3;
  const float scale_log2 = scale * kLog2e;
  int ta = 0, tb = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < n_items; ++r) {
    const int w = item_index(r);
    if (w >= n_items) continue;
    const Item it = item(w);
    const int bh = it.bh, q0 = it.q0;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (warp & 3) + (lane >> 2);
    const int col_lim = wg == 0 ? it.lim0 : it.lim1;
    const int my_kt = (col_lim + kBlockK - 1) / kBlockK;

    const float* brow[2] = {nullptr, nullptr};
    uint32_t key = 0, row_hash[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kBias == kBiasGlobal)
        brow[h] = flash_operands::bias_row(bias, bh, bias_div, bias_rows,
                                           min(row0 + 8 * h, sq - 1), sk);
      if constexpr (kDropout) {
        key = flash_operands::dropout_key(seed, bh);
        row_hash[h] = flash_operands::dropout_row(key, row0 + 8 * h);
      }
    }

    float acc_o[kDV / 2];
#pragma unroll
    for (int j = 0; j < kDV / 2; ++j) acc_o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int kt = 0; kt < it.n_kt; ++kt) {
      const bool mine = kt < my_kt;
      // S = Q K^T, one column block of Q and K a stage of ring A
      float acc_s[kBlockK / 2];
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) acc_s[i] = 0.f;
      for (int c = 0; c < nb; ++c, ++ta) {
        const int s = ta % kWideStagesA;
        mbar_wait(&full_a[s], (ta / kWideStagesA) & 1);
        if (mine) {
          const unsigned char* st = ring_a + s * kABytes;
          const uint64_t q_desc = make_desc<128>(st + wg * 64 * 128);
          const uint64_t k_desc = make_desc<128>(st + kQBlkBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(acc_s, desc_add(q_desc, 32 * kk),
                     desc_add(k_desc, 32 * kk), 1);
          wgmma_commit();
          wgmma_wait();
          fence_regs(acc_s);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_a[s]);
      }

      const int sb = tb % kWideStagesB;
      mbar_wait(&full_b[sb], (tb / kWideStagesB) & 1);
      if (mine) {
        const unsigned char* Vs = ring_b + sb * kBBytes;
        const unsigned char* Bs = Vs + kVBytes;
        const int c0 = kt * kBlockK + 2 * quad;
        float bv[kBlockK / 2];
        if constexpr (kBias == kBiasGlobal) {
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = c0 + 8 * j + e;
                bv[4 * j + 2 * h + e] =
                    col < col_lim ? flash_operands::bias_at(brow[h], col) : 0.f;
              }
        } else if constexpr (kBias == kBiasTile) {
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 b2 = *reinterpret_cast<const float2*>(
                  flash_operands::bias_tile_at<kBlockQ>(Bs, row0 - q0 + 8 * h,
                                                        8 * j + 2 * quad));
              bv[4 * j + 2 * h] = fmaxf(b2.x, flash_operands::kPadValue);
              bv[4 * j + 2 * h + 1] = fmaxf(b2.y, flash_operands::kPadValue);
            }
        }

        // the online softmax, as the fixed instances run it
        uint32_t pa[kBlockK / 4];
        auto softmax = [&](auto edge_tag) {
          constexpr bool kEdge = decltype(edge_tag)::value;
          constexpr bool kRaw = !kEdge && !kHasBias;
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * h + e;
                const int col = c0 + 8 * j + e;
                float x = acc_s[i];
                if constexpr (kHasBias) x = fmaf(x, scale, bv[i]);
                else if constexpr (kEdge) x *= scale;
                if constexpr (kEdge) {
                  if (col >= col_lim) x = -INFINITY;
                  else if (causal && col > row0 + 8 * h + offset) x = kMaskValue;
                }
                acc_s[i] = x;
                mx[h] = fmaxf(mx[h], x);
              }
          float alpha[2], mb[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            if constexpr (kRaw) mx[h] *= scale;
            const float m_new = fmaxf(m[h], mx[h]);
            alpha[h] = __expf(m[h] - m_new);
            m[h] = m_new;
            mb[h] = m_new * kLog2e;
            l[h] *= alpha[h];
          }
#pragma unroll
          for (int i = 0; i < kDV / 2; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float pv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x = acc_s[4 * j + 2 * h + e];
                const float p = kRaw ? ex2(fmaf(x, scale_log2, -mb[h]))
                                     : __expf(x - m[h]);
                l[h] += p;
                pv[e] = p;
                if constexpr (kDropout)
                  pv[e] = flash_operands::dropout_keep(key, row_hash[h],
                                                       c0 + 8 * j + e, threshold)
                              ? p * drop_scale
                              : 0.f;
              }
              pa[2 * j + h] = pack_bf16(pv[0], pv[1]);
            }
        };
        const bool edge = (kt + 1) * kBlockK > col_lim ||
                          (causal && (kt + 1) * kBlockK - 1 > wq0 + offset);
        if (edge)
          softmax(std::true_type{});
        else
          softmax(std::false_type{});

        // O += P V over this item's slice
        const uint64_t v_desc =
            make_desc<LV::kAtomBytes>(Vs, kBlockK * LV::kAtomBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk)
          wgmma_rs(acc_o, pa + 4 * kk, desc_add(v_desc, LV::mnmajor_step(kk)),
                   1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc_o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_b[sb]);
      ++tb;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float inv = 1.f / l[h];
      bf16* og =
          o + (static_cast<size_t>(bh) * sq + row) * d + it.dv0 + 2 * quad;
#pragma unroll
      for (int j = 0; j < kDV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2 * h] * inv,
                                  acc_o[4 * j + 2 * h + 1] * inv);
      if (quad == 0 && it.dv0 == 0) {
        const size_t rr = static_cast<size_t>(bh) * sq + row;
        lse[rr] = m[h] + logf(l[h]);
        m_out[rr] = m[h];
        l_out[rr] = l[h];
      }
    }
  }
}

// The wide instance's launch (d a multiple of 128 above 256).
template <int kBias, bool kDropout>
int launch_wide(const void* q, const void* k, const void* v, const void* bias,
                const void* seed, void* o, void* lse, void* m, void* l, int bh,
                int sq, int sk, int d, int bias_div, int bias_rows, float scale,
                int causal, int offset, uint32_t threshold, float drop_scale,
                cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_bias{};
  cudaError_t err = hopper_host::make_map(&tm_q, q, bh, sq, d, kBlockQ);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&tm_k, k, bh, sk, d, kWideBlockK);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&tm_v, v, bh, sk, d, kWideBlockK);
  if (err == cudaSuccess && kBias == kBiasTile)
    err = hopper_host::make_bias_map(&tm_bias, bias, bh / bias_div, sq, sk,
                                     kBlockQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t bytes = wide_smem_bytes<kBias>();
  auto* kernel = &flash_fwd_wide_kernel<kBias, kDropout>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = bh * (d / kWideDV) * ((sq + kBlockQ - 1) / kBlockQ);
  const int grid = min(n_items, sms);
  kernel<<<dim3(static_cast<unsigned>(grid)), kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_bias, static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<float*>(m),
      static_cast<float*>(l), bh, sq, sk, d, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kBias, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seed, void* o, void* lse, void* m, void* l, int bh,
           int sq, int sk, int bias_div, int bias_rows, float scale,
           int causal, int offset, uint32_t threshold, float drop_scale,
           cudaStream_t stream) {
  constexpr int kBlockK = Tile<D, kBias>::kBlockK;
  CUtensorMap tm_q, tm_k, tm_v, tm_bias{};
  cudaError_t err = hopper_host::make_map(&tm_q, q, bh, sq, D, kBlockQ);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&tm_k, k, bh, sk, D, kBlockK);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&tm_v, v, bh, sk, D, kBlockK);
  if (err == cudaSuccess && kBias == kBiasTile)
    err = hopper_host::make_bias_map(&tm_bias, bias, bh / bias_div, sq, sk,
                                     kBlockQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t bytes = smem_bytes<D, kBias>();
  auto* kernel = &flash_fwd_kernel<D, kBias, kDropout>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one CTA per SM (shared memory and registers allow one)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items =
      bh * (D / Tile<D, kBias>::kDV) * ((sq + kBlockQ - 1) / kBlockQ);
  const int grid = min(n_items, sms);
  kernel<<<dim3(static_cast<unsigned>(grid)), kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_bias, static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<float*>(m),
      static_cast<float*>(l), bh, sq, sk, scale, causal, offset, bias_div,
      bias_rows, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = decltype(&launch<64, kNoBias, false>);

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

// q (bh, sq, d), k and v (bh, sk, d) bf16, 16-byte aligned; bias (groups,
// bias_rows, sk) f32 or null; seed one int32 or null (no dropout); o (bh,
// sq, d) bf16; lse, m, l (bh, sq) f32.  d must be 32, 64, 128, 256 or a
// multiple of 128 above 256, groups must divide bh and bias_rows be 1 or
// sq.  The causal mask is aligned bottom-right.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* seed, void* o,
                         void* lse, void* m, void* l, int bh, int sq, int sk,
                         int d, int groups, int bias_rows, float scale,
                         int causal, unsigned threshold, float drop_scale,
                         void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 ||
      (d != 32 && d != 64 && d != 128 && !(d >= 256 && d % 128 == 0)) ||
      groups <= 0 || bh % groups != 0 || (bias_rows != 1 && bias_rows != sq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = flash_operands::bias_mode(bias, bias_rows, sq, sk);
  const bool dropout = seed != nullptr;
  if (d > 256) {
    using WideFn = decltype(&launch_wide<kNoBias, false>);
    const WideFn wide =
        mode == kBiasTile
            ? (dropout ? &launch_wide<kBiasTile, true>
                       : &launch_wide<kBiasTile, false>)
        : mode == kBiasGlobal
            ? (dropout ? &launch_wide<kBiasGlobal, true>
                       : &launch_wide<kBiasGlobal, false>)
            : (dropout ? &launch_wide<kNoBias, true>
                       : &launch_wide<kNoBias, false>);
    return wide(q, k, v, bias, seed, o, lse, m, l, bh, sq, sk, d,
                bh / groups, bias_rows, scale, causal, sk - sq, threshold,
                drop_scale, static_cast<cudaStream_t>(stream));
  }
  const LaunchFn run = d == 32    ? pick<32>(mode, dropout)
                       : d == 64  ? pick<64>(mode, dropout)
                       : d == 128 ? pick<128>(mode, dropout)
                                  : pick<256>(mode, dropout);
  return run(q, k, v, bias, seed, o, lse, m, l, bh, sq, sk, bh / groups,
             bias_rows, scale, causal, sk - sq, threshold, drop_scale,
             static_cast<cudaStream_t>(stream));
}
