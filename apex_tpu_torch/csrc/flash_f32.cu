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
// Bound on the H100: the longer of the bytes (q, k, v, dO, the bias and the
//           row statistics read once, o, dq, dk, dv or dbias written once)
//           over 3.35 TB/s and the operations (4*D flops per (q, k) pair
//           forward, 10*D backward, 4*D for dbias's recompute) at three
//           TF32 products each over 495 TFLOP/s.  At the evoformer's shapes
//           (D 32 and 64 with a (BH, S, S) f32 bias) that is the bytes.
// Design:   K3, K4 and K5 run every product on the tensor cores as 3xTF32
//           (CUTLASS's OpMultiplyAddFastF32 scheme): each f32 operand x is
//           split in registers into big = cvt.rna.tf32(x) and small =
//           cvt.rna.tf32(x - big), and a product is small*big + big*small +
//           big*big, the small terms first, on mma.sync m16n8k8 tf32 with
//           f32 accumulators — about 21 of f32's 24 mantissa bits, where one
//           TF32 product keeps 11.  mma.sync and not wgmma: wgmma reads an
//           f32 tile as TF32 by dropping its low bits and takes TF32 only
//           K-major from shared memory, so big and small would have to be
//           written out as separate tiles, and V, Q and dO staged
//           transposed; with mma.sync the split is three instructions per
//           fragment element, the same tiles feed every product, and P and
//           dS go from an accumulator to the next product's A fragment in
//           registers (the reduction index inside a k8 step is permuted,
//           A's k = t <-> column 2t and k = t + 4 <-> 2t + 1, and B's rows
//           alike, so no shuffle is needed).  A CTA is 4 warps, each owning
//           16 rows of a 64-row tile.  Tiles stream through a ring of
//           shared-memory stages filled by 16-byte cp.async copies (4-byte
//           ones for a bias whose rows are not 16-byte aligned; rows and keys
//           past the edge zero-filled), one commit group per stage: every
//           thread both loads and computes, so cp.async.wait_group and a
//           barrier are the whole handshake and no mbarrier is needed.  f32
//           rows are padded to D + 4 floats, so the fragment reads (a
//           quad's rows t, or a column 2t of 8 rows) hit 32 distinct banks;
//           the bias tile is staged with its K (or Q) tile instead of being
//           read per score from device memory.
//           K3: one CTA per (batch*head, 64-row q tile, slice of at most 128
//           columns of o), heaviest causal tiles first; Q (all of D) stays
//           resident, the ring carries 32-key K tiles, the slice of V and the
//           (64 rows x 32 keys) bias tile; the key walk is K3's (key_limit:
//           the causal limit of the tile's last row rounded up to 64, or
//           every key when its first row sees none; masked scores
//           MASK_VALUE, keys past the walk -inf) and the online softmax
//           keeps f32 m and l per row; p = expf(s - m).
//           K4: the dK/dV pass runs one CTA per (batch*head, 64-key tile,
//           slice of at most 64 columns of dk and dv) over the live 32-row q
//           tiles (K4's block_live, fully-masked rows included), K and V
//           resident, Q, dO, their rows' m, l, delta and the (32 x 64) bias
//           tile through the ring; the dQ pass one CTA per (batch*head,
//           64-row q tile, slice of at most 128 columns of dq) up to the
//           causal limit, Q and dO resident, K, V and the bias tile through
//           the ring.  p = expf(s - m) / l, so a fully-masked row is exact;
//           no atomics, so the gradients are the same bits from run to run.
//           Products over D loop over the whole padded head dim; outputs
//           indexed by D are split over CTAs by slices, each recomputing the
//           scores.
//           K5 (redesigned on the same machinery): one CTA per (group,
//           64-row q tile) at RS = S_q, the evoformer's layout, walking
//           the keys 32 a step up to the causal limit; at G = BH the group
//           has one member and Q and dO stay resident (loaded once), so K,
//           V and the staged bias tile are all that stream and every
//           operand is read once (the SIMT kernel re-read its Q and dO
//           tiles once per key tile).  S = Q K^T and dP = dO V^T as 3xTF32
//           products, ds = p (D dp - delta) in registers; a group's
//           members loop inside the walk and their ds sum in registers in
//           member order (no float atomics: the same bits from run to run);
//           each (64 x 32) dbias tile goes out through a shared-memory
//           staging tile in 16-byte coalesced stores, and the keys past the
//           causal walk get zeros.  RS = 1 keeps its rule: one CTA per
//           (group, 32-key tile) over the members and every live q tile,
//           the 64 rows summed in order at the end.
//           Head dims 32, 64, 128 and 256, and a wide instance for any
//           multiple of 128 above 256 (the wrapper pads to the next of
//           them with zeros), the number of 64-column blocks a run-time
//           argument: every product that reduces over D streams both of
//           its operands through the ring one 64-column block a stage, and
//           the operand of the product into a D-indexed output (V's or K's
//           slice; Q's and dO's block of the dK/dV slice, taken last) rides
//           the last block's stage, so shared memory does not grow with D.
//           K5 takes 64-column blocks from D = 256 on (and at D = 128 when
//           Q and dO cannot stay resident).  Not yet used: wgmma, a
//           producer warp (later work: the times are in PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_operands.cuh"

namespace {

using flash_operands::kMaskValue;
using flash_operands::kPadValue;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // the tensor-core kernels (K3, K4)
constexpr int kRowsT = 64;             // rows of a resident or q tile
constexpr int kKeysT = 32;             // keys (K3, dQ) or rows (dK/dV) a stage
constexpr int kBiasLd = kKeysT + 8;    // a (64 x 32) bias tile's row stride
constexpr int kBiasLdT = kRowsT + 4;   // a (32 x 64) bias tile's row stride

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`, or zeros when `in` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes from `src` to shared `dst`, or zero when `in` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [row0, row0 + R) (zero at or past `limit`), columns [col0, col0 +
// C) of a row-major f32 array of row stride `src_ld` into `dst` (row stride
// `ld`), as 16-byte copies.
template <int R, int C>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           int src_ld, int row0, int limit,
                                           int col0) {
  constexpr int kVecs = C / 4;
  for (int i = threadIdx.x; i < R * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const bool in = row0 + r < limit;
    cp_async16(dst + r * ld + c,
               src + static_cast<size_t>(in ? row0 + r : 0) * src_ld + col0 + c,
               in);
  }
}

// Rows [row0, row0 + R) and keys [col0, col0 + C) of one group's bias
// (`bias_g`, rows of `sk`) into `dst` (row stride `ld`); with one
// key-padding row (rs1) only row 0.  Rows past `sq` and keys past `sk` read
// 0; 16-byte copies when every row is 16-byte aligned (`vec`).
template <int R, int C>
__device__ __forceinline__ void stage_bias(float* dst, int ld,
                                           const float* bias_g, bool rs1,
                                           int row0, int sq, int col0, int sk,
                                           bool vec) {
  const int rows = rs1 ? 1 : R;
  const int per = vec ? 4 : 1;
  const int n = rows * (C / per);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / (C / per), c = (i % (C / per)) * per;
    const bool in = (rs1 || row0 + r < sq) && col0 + c < sk;
    const float* src =
        bias_g + (in ? static_cast<size_t>(rs1 ? 0 : row0 + r) * sk + col0 + c
                     : 0);
    if (vec)
      cp_async16(dst + r * ld + c, src, in);
    else
      cp_async4(dst + r * ld + c, src, in);
  }
}

// ------------------------------------------------------- 3xTF32 products

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An operand split into its TF32 big part and the TF32 rounding of the rest.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// m16n8k8 A (row) and B (col) fragments, each split.  Thread (g, t) = (lane
// / 4, lane % 4) holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]
// and B[t][g], B[t + 4][g]; its accumulator C[g][2t + e], C[g + 8][2t + e].
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// Not volatile: the products of independent accumulators may interleave.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at f32 accuracy: the small terms first, then big * big, into
// a fresh accumulator that one FADD a value adds to d.  The tensor cores
// truncate their f32 sums, so a running sum kept inside them drifts by
// up to an ulp of the sum per step; here each step truncates only its own
// k8 partial, and the running sum rounds to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A = rows [r0, r0 + 16), columns [c0, c0 + 8) of a row-major tile.
__device__ __forceinline__ FragA load_a(const float* tile, int ld, int r0,
                                        int c0) {
  const int g = lane_g(), t = lane_t();
  const float* p = tile + (r0 + g) * ld + c0 + t;
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], a.big[i], a.small[i]);
  return a;
}

// B = the transpose of rows [n0, n0 + 8), columns [k0, k0 + 8) of a
// row-major tile (B[k][n] = tile[n0 + n][k0 + k]).
__device__ __forceinline__ FragB load_bt(const float* tile, int ld, int n0,
                                         int k0) {
  const float* p = tile + (n0 + lane_g()) * ld + k0 + lane_t();
  FragB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[4], b.big[1], b.small[1]);
  return b;
}

// B = rows [k0, k0 + 8), columns [n0, n0 + 8) of a row-major tile, its k
// permuted to match a_from_acc: B's k = t is row 2t, k = t + 4 row 2t + 1.
__device__ __forceinline__ FragB load_b_perm(const float* tile, int ld, int k0,
                                             int n0) {
  const float* p = tile + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  FragB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[ld], b.big[1], b.small[1]);
  return b;
}

// The A fragment of the k8 step over the 8 columns of accumulator block
// `c` (16 x 8), k permuted: A's k = t is column 2t, k = t + 4 column 2t + 1.
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  FragA a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

// ------------------------------------------------------------ the rules

// K3's key walk for the 64 rows from q0 (flash_fwd.cu key_limit).
__device__ __forceinline__ int key_limit(int q0, int sq, int sk, int causal,
                                         int offset) {
  if (!causal || q0 + offset < 0) return sk;
  const int q_last = min(q0 + kRowsT, sq) - 1;
  return min(sk, (q_last + offset + 1 + kRowsT - 1) / kRowsT * kRowsT);
}

// K4's rule: whether the `keys` keys from k0 take part in the `rows` rows
// from q0 (some pair live, or a row that sees no key at all).
__device__ __forceinline__ bool block_live(int q0, int rows, int k0, int sq,
                                           int sk, int causal, int offset) {
  if (k0 >= sk || q0 >= sq) return false;
  if (!causal) return true;
  const int q_last = min(q0 + rows, sq) - 1;
  return q_last + offset >= k0 || q0 + offset < 0;
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

// Per head dim: the slice of D whose outputs a CTA accumulates (K3's o and
// the dQ pass's dq: at most 128 columns; the dK/dV pass, two accumulators:
// 64), and each ring's depth: as deep as keeps two or three CTAs on an SM at
// the evoformer's D = 32 and 64; one stage at D = 256 in K4, whose resident
// tiles take 133 KB.
template <int D>
struct Slice {
  static constexpr int kDV = D < 128 ? D : 128;
  static constexpr int kDkdvDV = D < 64 ? D : 64;
  static constexpr int kFwdStages = D <= 64 ? 3 : 2;
  static constexpr int kDkdvStages = D == 32 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int kDqStages = D <= 128 ? 2 : 1;
};

// ------------------------------------------------------------------ K3

template <int D, bool kBias>
constexpr size_t fwd_smem() {
  constexpr int kLd = D + 4, kLdV = Slice<D>::kDV + 4;
  constexpr int kStage =
      kKeysT * kLd + kKeysT * kLdV + (kBias ? kRowsT * kBiasLd : 0);
  return sizeof(float) * (kRowsT * kLd + Slice<D>::kFwdStages * kStage);
}

template <int D, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed, float* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ m_out,
                     float* __restrict__ l_out, int bh_count, int sq, int sk,
                     float scale, int causal, int offset, int bias_div,
                     int bias_rows, uint32_t threshold, float drop_scale) {
  constexpr int kDV = Slice<D>::kDV;
  constexpr int kSlices = D / kDV;
  constexpr int kStages = Slice<D>::kFwdStages;
  constexpr int kLd = D + 4, kLdV = kDV + 4;
  constexpr int kKFloats = kKeysT * kLd, kVFloats = kKeysT * kLdV;
  constexpr int kStageFloats = kKFloats + kVFloats + (kBias ? kRowsT * kBiasLd : 0);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + kRowsT * kLd;

  const int n_tiles = (sq + kRowsT - 1) / kRowsT;
  const int head = static_cast<int>(blockIdx.x % (bh_count * kSlices));
  const int bh = head / kSlices, dv0 = (head % kSlices) * kDV;
  const int q0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x / (bh_count * kSlices))) *
      kRowsT;
  const int lim = key_limit(q0, sq, sk, causal, offset);
  const int n_kt = (lim + kKeysT - 1) / kKeysT;
  const float* qh = q + static_cast<size_t>(bh) * sq * D;
  const float* kh = k + static_cast<size_t>(bh) * sk * D;
  const float* vh = v + static_cast<size_t>(bh) * sk * D;
  const bool rs1 = bias_rows == 1;
  const float* bias_g =
      kBias ? bias + static_cast<size_t>(bh / bias_div) * bias_rows * sk
            : nullptr;
  const bool bias_vec =
      kBias && sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;

  auto fill = [&](int kt) {
    float* st = ring + (kt % kStages) * kStageFloats;
    const int k0 = kt * kKeysT;
    stage_rows<kKeysT, D>(st, kLd, kh, D, k0, sk, 0);
    stage_rows<kKeysT, kDV>(st + kKFloats, kLdV, vh, D, k0, sk, dv0);
    if constexpr (kBias)
      stage_bias<kRowsT, kKeysT>(st + kKFloats + kVFloats, kBiasLd, bias_g,
                                 rs1, q0, sq, k0, sk, bias_vec);
  };
  stage_rows<kRowsT, D>(Qs, kLd, qh, D, q0, sq, 0);  // with stage 0's group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) fill(s);
    cp_async_commit();
  }

  // this thread: rows wr + g and wr + g + 8 of the tile, keys and head dims
  // 8j + 2t + e of each 8-column block
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int wr = 16 * warp;
  uint32_t key = 0, row_hash[2] = {0, 0};
  if constexpr (kDropout) {
    key = flash_operands::dropout_key(seed, bh);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_hash[h] = flash_operands::dropout_row(key, q0 + wr + g + 8 * h);
  }
  float acc_o[kDV / 8][4];
#pragma unroll
  for (int n = 0; n < kDV / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + kStages - 1 < n_kt) fill(kt + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* Ks = ring + (kt % kStages) * kStageFloats;
    const float* Vs = Ks + kKFloats;
    const float* Bs = Vs + kVFloats;
    const int k0 = kt * kKeysT;

    // S = Q K^T: 16 rows x 32 keys a warp
    float s[kKeysT / 8][4];
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const FragA a = load_a(Qs, kLd, wr, 8 * kk);
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
        mma3(s[j], a, load_bt(Ks, kLd, 8 * j, 8 * kk));
    }

    // the online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float b2[2] = {0.f, 0.f};
        if constexpr (kBias) {
          const float2 bb = *reinterpret_cast<const float2*>(
              Bs + (rs1 ? 0 : wr + g + 8 * h) * kBiasLd + 8 * j + 2 * t);
          b2[0] = fmaxf(bb.x, kPadValue);
          b2[1] = fmaxf(bb.y, kPadValue);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          const int row = q0 + wr + g + 8 * h;
          float x;
          if (col >= lim) {
            x = -INFINITY;
          } else {
            x = fmaf(s[j][2 * h + e], scale, b2[e]);
            if (causal && col > row + offset) x = kMaskValue;
          }
          s[j][2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < kDV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_o[n][i] *= alpha[i >> 1];
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const float p = expf(s[j][i] - m[h]);
        l[h] += p;
        float pv = p;
        if constexpr (kDropout)
          pv = flash_operands::dropout_keep(key, row_hash[h],
                                            k0 + 8 * j + 2 * t + (i & 1),
                                            threshold)
                   ? p * drop_scale
                   : 0.f;
        s[j][i] = pv;
      }

    // O += P V over this CTA's slice
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j) {
      const FragA a = a_from_acc(s[j]);
#pragma unroll
      for (int n = 0; n < kDV / 8; ++n)
        mma3(acc_o[n], a, load_b_perm(Vs, kLdV, 8 * j, 8 * n));
    }
    __syncthreads();  // every warp is done with the stage before its refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + wr + g + 8 * h;
    if (row >= sq) continue;
    const float inv = 1.f / l[h];
    float* orow = o + (static_cast<size_t>(bh) * sq + row) * D + dv0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kDV / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc_o[n][2 * h] * inv, acc_o[n][2 * h + 1] * inv);
    if (t == 0 && dv0 == 0) {
      const size_t r = static_cast<size_t>(bh) * sq + row;
      lse[r] = m[h] + logf(l[h]);
      m_out[r] = m[h];
      l_out[r] = l[h];
    }
  }
}

// ------------------------------------------------------------------ K4

template <int D, bool kBias>
constexpr size_t dkdv_smem() {
  constexpr int kLd = D + 4;
  constexpr int kStage = 2 * kKeysT * kLd + 3 * kKeysT +
                         (kBias ? kKeysT * kBiasLdT : 0);
  return sizeof(float) * (2 * kRowsT * kLd + Slice<D>::kDkdvStages * kStage);
}

// dK/dV: one CTA per (batch-head, 64-key tile, slice of dK and dV).  Warp w
// holds keys k0 + 16w + g (+8) of S^T, dP^T, dK and dV; the ring carries
// 32-row Q and dO tiles, their rows' m, l and delta, and the (32 rows x 64
// keys) bias tile.
template <int D, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias,
                          const int* __restrict__ seed, float* __restrict__ dk,
                          float* __restrict__ dv, int bh_count, int sq, int sk,
                          float scale, int causal, int offset, int bias_div,
                          int bias_rows, uint32_t threshold, float drop_scale) {
  constexpr int kDV = Slice<D>::kDkdvDV;
  constexpr int kSlices = D / kDV;
  constexpr int kStages = Slice<D>::kDkdvStages;
  constexpr int kLd = D + 4;
  constexpr int kTile = kKeysT * kLd;  // one 32-row Q or dO tile
  constexpr int kStageFloats =
      2 * kTile + 3 * kKeysT + (kBias ? kKeysT * kBiasLdT : 0);
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kRowsT * kLd;
  float* ring = Vs + kRowsT * kLd;

  const int slice = static_cast<int>(blockIdx.x % kSlices);
  const int rest = static_cast<int>(blockIdx.x / kSlices);
  const int bh = rest % bh_count;
  const int k0 = (rest / bh_count) * kRowsT;
  const int dv0 = slice * kDV;
  const int nq = (sq + kKeysT - 1) / kKeysT;
  const size_t rows = static_cast<size_t>(bh) * sq;
  const float* qh = q + rows * D;
  const float* oh = dout + rows * D;
  const bool rs1 = bias_rows == 1;
  const float* bias_g =
      kBias ? bias + static_cast<size_t>(bh / bias_div) * bias_rows * sk
            : nullptr;
  const bool bias_vec =
      kBias && sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;

  auto live = [&](int qb) {
    return block_live(qb * kKeysT, kKeysT, k0, sq, sk, causal, offset);
  };
  auto next_live = [&](int qb) {
    while (qb < nq && !live(qb)) ++qb;
    return qb;
  };
  // the n-th live q tile qb goes to stage n % kStages
  auto fill = [&](int qb, int n) {
    float* st = ring + (n % kStages) * kStageFloats;
    const int q0 = qb * kKeysT;
    stage_rows<kKeysT, D>(st, kLd, qh, D, q0, sq, 0);
    stage_rows<kKeysT, D>(st + kTile, kLd, oh, D, q0, sq, 0);
    float* stats = st + 2 * kTile;
    if (threadIdx.x < 3 * kKeysT) {
      const int c = threadIdx.x / kKeysT, r = threadIdx.x % kKeysT;
      const float* src = c == 0 ? row_max : c == 1 ? row_sum : delta;
      const bool in = q0 + r < sq;
      cp_async4(stats + threadIdx.x, src + rows + (in ? q0 + r : 0), in);
    }
    if constexpr (kBias)
      stage_bias<kKeysT, kRowsT>(stats + 3 * kKeysT, kBiasLdT, bias_g, rs1, q0,
                                 sq, k0, sk, bias_vec);
  };

  stage_rows<kRowsT, D>(Ks, kLd, k + static_cast<size_t>(bh) * sk * D, D, k0,
                        sk, 0);
  stage_rows<kRowsT, D>(Vs, kLd, v + static_cast<size_t>(bh) * sk * D, D, k0,
                        sk, 0);
  int qb_load = next_live(0), n_loaded = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (qb_load < nq) {
      fill(qb_load, n_loaded++);
      qb_load = next_live(qb_load + 1);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int kr = 16 * warp;  // the warp's first key in the tile
  uint32_t key = 0;
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
  float acc_dk[kDV / 8][4], acc_dv[kDV / 8][4];
#pragma unroll
  for (int n = 0; n < kDV / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[n][i] = acc_dv[n][i] = 0.f;

  int it = 0;
  for (int qb = next_live(0); qb < nq; qb = next_live(qb + 1), ++it) {
    if (qb_load < nq) {
      fill(qb_load, n_loaded++);
      qb_load = next_live(qb_load + 1);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* Qs = ring + (it % kStages) * kStageFloats;
    const float* dOs = Qs + kTile;
    const float* stats = dOs + kTile;
    const float* Bs = stats + 3 * kKeysT;
    const int q0 = qb * kKeysT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
    float st[kKeysT / 8][4], dpt[kKeysT / 8][4];
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const FragA ak = load_a(Ks, kLd, kr, 8 * kk);
      const FragA av = load_a(Vs, kLd, kr, 8 * kk);
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j) {
        mma3(st[j], ak, load_bt(Qs, kLd, 8 * j, 8 * kk));
        mma3(dpt[j], av, load_bt(dOs, kLd, 8 * j, 8 * kk));
      }
    }

    // P^T and dS^T: query c = 8j + 2t + e of the tile, key kr + g + 8h
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const int qrow = q0 + c;
        uint32_t row_hash = 0;
        if constexpr (kDropout) row_hash = flash_operands::dropout_row(key, qrow);
        const float m_c = stats[c], il_c = 1.f / stats[kKeysT + c];
        const float delta_c = stats[2 * kKeysT + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * h + e;
          float b = 0.f;
          if constexpr (kBias)
            b = fmaxf(Bs[(rs1 ? 0 : c) * kBiasLdT + kr + g + 8 * h], kPadValue);
          float pv, ds;
          p_and_ds<kDropout>(st[j][i], dpt[j][i], b, qrow, k0 + kr + g + 8 * h,
                             sq, sk, scale, causal, offset, m_c, il_c, delta_c,
                             key, row_hash, threshold, drop_scale, pv, ds);
          st[j][i] = pv;
          dpt[j][i] = ds;
        }
      }

    // dV += P^T dO and dK += dS^T Q over this CTA's slice
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j) {
      const FragA ap = a_from_acc(st[j]);
      const FragA ad = a_from_acc(dpt[j]);
#pragma unroll
      for (int n = 0; n < kDV / 8; ++n) {
        mma3(acc_dv[n], ap, load_b_perm(dOs, kLd, 8 * j, dv0 + 8 * n));
        mma3(acc_dk[n], ad, load_b_perm(Qs, kLd, 8 * j, dv0 + 8 * n));
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy is left in flight past the kernel's end

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key_row = k0 + kr + g + 8 * h;
    if (key_row >= sk) continue;
    const size_t off =
        (static_cast<size_t>(bh) * sk + key_row) * D + dv0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kDV / 8; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) = make_float2(
          acc_dk[n][2 * h] * scale, acc_dk[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(acc_dv[n][2 * h], acc_dv[n][2 * h + 1]);
    }
  }
}

template <int D, bool kBias>
constexpr size_t dq_smem() {
  constexpr int kLd = D + 4;
  constexpr int kStage = 2 * kKeysT * kLd + (kBias ? kRowsT * kBiasLd : 0);
  return sizeof(float) * (2 * kRowsT * kLd + Slice<D>::kDqStages * kStage);
}

// dQ: one CTA per (batch-head, 64-row q tile, slice of dQ), heaviest causal
// tiles first.  Warp w holds rows q0 + 16w + g (+8); the ring carries 32-key
// K and V tiles and the (64 rows x 32 keys) bias tile.
template <int D, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ row_max,
                        const float* __restrict__ row_sum,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed, float* __restrict__ dq,
                        int bh_count, int sq, int sk, float scale, int causal,
                        int offset, int bias_div, int bias_rows,
                        uint32_t threshold, float drop_scale) {
  constexpr int kDV = Slice<D>::kDV;
  constexpr int kSlices = D / kDV;
  constexpr int kStages = Slice<D>::kDqStages;
  constexpr int kLd = D + 4;
  constexpr int kTile = kKeysT * kLd;
  constexpr int kStageFloats = 2 * kTile + (kBias ? kRowsT * kBiasLd : 0);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kRowsT * kLd;
  float* ring = dOs + kRowsT * kLd;

  const int n_tiles = (sq + kRowsT - 1) / kRowsT;
  const int slice = static_cast<int>(blockIdx.x % kSlices);
  const int rest = static_cast<int>(blockIdx.x / kSlices);
  const int bh = rest % bh_count;
  const int q0 = (n_tiles - 1 - rest / bh_count) * kRowsT;
  const int dv0 = slice * kDV;
  const int q_last = min(q0 + kRowsT, sq) - 1;
  const int k_end = causal ? max(0, min(sk, q_last + offset + 1)) : sk;
  const int n_kt = (k_end + kKeysT - 1) / kKeysT;
  const float* kh = k + static_cast<size_t>(bh) * sk * D;
  const float* vh = v + static_cast<size_t>(bh) * sk * D;
  const bool rs1 = bias_rows == 1;
  const float* bias_g =
      kBias ? bias + static_cast<size_t>(bh / bias_div) * bias_rows * sk
            : nullptr;
  const bool bias_vec =
      kBias && sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;

  auto fill = [&](int kt) {
    float* st = ring + (kt % kStages) * kStageFloats;
    const int k0 = kt * kKeysT;
    stage_rows<kKeysT, D>(st, kLd, kh, D, k0, sk, 0);
    stage_rows<kKeysT, D>(st + kTile, kLd, vh, D, k0, sk, 0);
    if constexpr (kBias)
      stage_bias<kRowsT, kKeysT>(st + 2 * kTile, kBiasLd, bias_g, rs1, q0, sq,
                                 k0, sk, bias_vec);
  };
  const size_t head_q = static_cast<size_t>(bh) * sq * D;
  stage_rows<kRowsT, D>(Qs, kLd, q + head_q, D, q0, sq, 0);
  stage_rows<kRowsT, D>(dOs, kLd, dout + head_q, D, q0, sq, 0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) fill(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int wr = 16 * warp;
  float m_r[2], il_r[2], delta_r[2];
  uint32_t key = 0, row_hash[2] = {0, 0};
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    const size_t ri = static_cast<size_t>(bh) * sq + row;
    m_r[h] = row < sq ? row_max[ri] : 0.f;
    il_r[h] = row < sq ? 1.f / row_sum[ri] : 0.f;
    delta_r[h] = row < sq ? delta[ri] : 0.f;
    if constexpr (kDropout) row_hash[h] = flash_operands::dropout_row(key, row);
  }
  float acc[kDV / 8][4];
#pragma unroll
  for (int n = 0; n < kDV / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  // with no key to walk, the Q and dO copies still complete before the end
  if (n_kt == 0) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + kStages - 1 < n_kt) fill(kt + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* Ks = ring + (kt % kStages) * kStageFloats;
    const float* Vs = Ks + kTile;
    const float* Bs = Vs + kTile;
    const int k0 = kt * kKeysT;

    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys a warp
    float s[kKeysT / 8][4], dp[kKeysT / 8][4];
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const FragA aq = load_a(Qs, kLd, wr, 8 * kk);
      const FragA ao = load_a(dOs, kLd, wr, 8 * kk);
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j) {
        mma3(s[j], aq, load_bt(Ks, kLd, 8 * j, 8 * kk));
        mma3(dp[j], ao, load_bt(Vs, kLd, 8 * j, 8 * kk));
      }
    }

    // dS
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float b2[2] = {0.f, 0.f};
        if constexpr (kBias) {
          const float2 bb = *reinterpret_cast<const float2*>(
              Bs + (rs1 ? 0 : wr + g + 8 * h) * kBiasLd + 8 * j + 2 * t);
          b2[0] = fmaxf(bb.x, kPadValue);
          b2[1] = fmaxf(bb.y, kPadValue);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          float pv, ds;
          p_and_ds<kDropout>(s[j][i], dp[j][i], b2[e], q0 + wr + g + 8 * h,
                             k0 + 8 * j + 2 * t + e, sq, sk, scale, causal,
                             offset, m_r[h], il_r[h], delta_r[h], key,
                             row_hash[h], threshold, drop_scale, pv, ds);
          s[j][i] = ds;
        }
      }

    // dQ += dS K over this CTA's slice
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j) {
      const FragA a = a_from_acc(s[j]);
#pragma unroll
      for (int n = 0; n < kDV / 8; ++n)
        mma3(acc[n], a, load_b_perm(Ks, kLd, 8 * j, dv0 + 8 * n));
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= sq) continue;
    float* out = dq + head_q + static_cast<size_t>(row) * D + dv0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kDV / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ------------------------------------------------------- the wide instances
//
// Any head dim above 256 (a multiple of 128: the wrapper pads to it), the
// number of 64-column blocks a run-time argument.  Every product that
// reduces over D streams both operands through the ring one 64-column
// block a stage; the operand of a product into D-indexed outputs (V's and
// K's slice, or Q's and dO's block of the slice) rides the block's last
// stage, so no tile grows with D.  The grids and the key walks are the
// fixed instances'.

constexpr int kCB = 64;            // the column block of a stage
constexpr int kLdB = kCB + 4;      // its row stride, in floats
constexpr int kWideDV = 128;       // K3's and dQ's output slice
constexpr int kLdWV = kWideDV + 4;
constexpr int kFwdWideStages = 3;
constexpr int kBwdWideStages = 2;

// Q block, K block, the V slice and the bias tile
template <bool kBias>
__host__ __device__ constexpr int fwd_wide_stage() {
  return kRowsT * kLdB + kKeysT * kLdB + kKeysT * kLdWV +
         (kBias ? kRowsT * kBiasLd : 0);
}

template <bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ bias,
                          const int* __restrict__ seed, float* __restrict__ o,
                          float* __restrict__ lse, float* __restrict__ m_out,
                          float* __restrict__ l_out, int bh_count, int sq,
                          int sk, int d, float scale, int causal, int offset,
                          int bias_div, int bias_rows, uint32_t threshold,
                          float drop_scale) {
  constexpr int kStages = kFwdWideStages;
  constexpr int kStageFloats = fwd_wide_stage<kBias>();
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);

  const int nb = d / kCB, slices = d / kWideDV;
  const int n_tiles = (sq + kRowsT - 1) / kRowsT;
  const int head = static_cast<int>(blockIdx.x % (bh_count * slices));
  const int bh = head / slices, dv0 = (head % slices) * kWideDV;
  const int q0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x / (bh_count * slices))) *
      kRowsT;
  const int lim = key_limit(q0, sq, sk, causal, offset);
  const int n_steps = (lim + kKeysT - 1) / kKeysT * nb;
  const float* qh = q + static_cast<size_t>(bh) * sq * d;
  const float* kh = k + static_cast<size_t>(bh) * sk * d;
  const float* vh = v + static_cast<size_t>(bh) * sk * d;
  const bool rs1 = bias_rows == 1;
  const float* bias_g =
      kBias ? bias + static_cast<size_t>(bh / bias_div) * bias_rows * sk
            : nullptr;
  const bool bias_vec =
      kBias && sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;

  // step n: key tile n / nb, column block n % nb
  auto fill = [&](int n) {
    float* st = ring + (n % kStages) * kStageFloats;
    const int k0 = (n / nb) * kKeysT, c = n % nb;
    stage_rows<kRowsT, kCB>(st, kLdB, qh, d, q0, sq, c * kCB);
    stage_rows<kKeysT, kCB>(st + kRowsT * kLdB, kLdB, kh, d, k0, sk, c * kCB);
    if (c == nb - 1) {
      float* vs = st + (kRowsT + kKeysT) * kLdB;
      stage_rows<kKeysT, kWideDV>(vs, kLdWV, vh, d, k0, sk, dv0);
      if constexpr (kBias)
        stage_bias<kRowsT, kKeysT>(vs + kKeysT * kLdWV, kBiasLd, bias_g, rs1,
                                   q0, sq, k0, sk, bias_vec);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) fill(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int wr = 16 * warp;
  uint32_t key = 0, row_hash[2] = {0, 0};
  if constexpr (kDropout) {
    key = flash_operands::dropout_key(seed, bh);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_hash[h] = flash_operands::dropout_row(key, q0 + wr + g + 8 * h);
  }
  float acc_o[kWideDV / 8][4];
#pragma unroll
  for (int n = 0; n < kWideDV / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kKeysT / 8][4];

  for (int n = 0; n < n_steps; ++n) {
    if (n + kStages - 1 < n_steps) fill(n + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* Qs = ring + (n % kStages) * kStageFloats;
    const float* Ks = Qs + kRowsT * kLdB;
    const float* Vs = Ks + kKeysT * kLdB;
    const float* Bs = Vs + kKeysT * kLdWV;
    const int k0 = (n / nb) * kKeysT, c = n % nb;

    // S += Q K^T over this column block
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < kCB / 8; ++kk) {
      const FragA a = load_a(Qs, kLdB, wr, 8 * kk);
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
        mma3(s[j], a, load_bt(Ks, kLdB, 8 * j, 8 * kk));
    }

    if (c == nb - 1) {
      // the online softmax (the fixed instances' own)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float b2[2] = {0.f, 0.f};
          if constexpr (kBias) {
            const float2 bb = *reinterpret_cast<const float2*>(
                Bs + (rs1 ? 0 : wr + g + 8 * h) * kBiasLd + 8 * j + 2 * t);
            b2[0] = fmaxf(bb.x, kPadValue);
            b2[1] = fmaxf(bb.y, kPadValue);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            const int row = q0 + wr + g + 8 * h;
            float x;
            if (col >= lim) {
              x = -INFINITY;
            } else {
              x = fmaf(s[j][2 * h + e], scale, b2[e]);
              if (causal && col > row + offset) x = kMaskValue;
            }
            s[j][2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int nn = 0; nn < kWideDV / 8; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_o[nn][i] *= alpha[i >> 1];
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const float p = expf(s[j][i] - m[h]);
          l[h] += p;
          float pv = p;
          if constexpr (kDropout)
            pv = flash_operands::dropout_keep(key, row_hash[h],
                                              k0 + 8 * j + 2 * t + (i & 1),
                                              threshold)
                     ? p * drop_scale
                     : 0.f;
          s[j][i] = pv;
        }
      // O += P V over this CTA's slice
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j) {
        const FragA a = a_from_acc(s[j]);
#pragma unroll
        for (int nn = 0; nn < kWideDV / 8; ++nn)
          mma3(acc_o[nn], a, load_b_perm(Vs, kLdWV, 8 * j, 8 * nn));
      }
    }
    __syncthreads();  // every warp is done with the stage before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + wr + g + 8 * h;
    if (row >= sq) continue;
    const float inv = 1.f / l[h];
    float* orow = o + (static_cast<size_t>(bh) * sq + row) * d + dv0 + 2 * t;
#pragma unroll
    for (int nn = 0; nn < kWideDV / 8; ++nn)
      *reinterpret_cast<float2*>(orow + 8 * nn) =
          make_float2(acc_o[nn][2 * h] * inv, acc_o[nn][2 * h + 1] * inv);
    if (t == 0 && dv0 == 0) {
      const size_t r = static_cast<size_t>(bh) * sq + row;
      lse[r] = m[h] + logf(l[h]);
      m_out[r] = m[h];
      l_out[r] = l[h];
    }
  }
}

// K block, V block, Q block, dO block, the rows' m, l, delta and the bias
// tile (32 rows x 64 keys)
template <bool kBias>
__host__ __device__ constexpr int dkdv_wide_stage() {
  return 2 * kRowsT * kLdB + 2 * kKeysT * kLdB + 3 * kKeysT +
         (kBias ? kKeysT * kBiasLdT : 0);
}

// The dK/dV pass at wide D: one CTA per (batch-head, 64-key tile, 64-column
// slice of dK and dV).  A live q tile takes nb stages, its column blocks in
// an order that ends with the slice's own, whose Q and dO blocks then feed
// dV += P^T dO and dK += dS^T Q.
template <bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_wide_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ row_max,
                               const float* __restrict__ row_sum,
                               const float* __restrict__ delta,
                               const float* __restrict__ bias,
                               const int* __restrict__ seed,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int bh_count, int sq, int sk, int d,
                               float scale, int causal, int offset,
                               int bias_div, int bias_rows,
                               uint32_t threshold, float drop_scale) {
  constexpr int kStages = kBwdWideStages;
  constexpr int kStageFloats = dkdv_wide_stage<kBias>();
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);

  const int nb = d / kCB;
  const int slice = static_cast<int>(blockIdx.x % nb);
  const int rest = static_cast<int>(blockIdx.x / nb);
  const int bh = rest % bh_count;
  const int k0 = (rest / bh_count) * kRowsT;
  const int dv0 = slice * kCB;
  const int nq = (sq + kKeysT - 1) / kKeysT;
  const size_t rows = static_cast<size_t>(bh) * sq;
  const float* qh = q + rows * d;
  const float* oh = dout + rows * d;
  const float* kh = k + static_cast<size_t>(bh) * sk * d;
  const float* vh = v + static_cast<size_t>(bh) * sk * d;
  const bool rs1 = bias_rows == 1;
  const float* bias_g =
      kBias ? bias + static_cast<size_t>(bh / bias_div) * bias_rows * sk
            : nullptr;
  const bool bias_vec =
      kBias && sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;

  auto next_live = [&](int qb) {
    while (qb < nq &&
           !block_live(qb * kKeysT, kKeysT, k0, sq, sk, causal, offset))
      ++qb;
    return qb;
  };
  // the column block of a q tile's i-th stage: the others in order, then
  // the slice's
  auto block_of = [&](int i) {
    return i == nb - 1 ? slice : i < slice ? i : i + 1;
  };
  auto fill = [&](int qb, int i, int n) {
    float* st = ring + (n % kStages) * kStageFloats;
    const int q0 = qb * kKeysT, col = block_of(i) * kCB;
    stage_rows<kRowsT, kCB>(st, kLdB, kh, d, k0, sk, col);
    stage_rows<kRowsT, kCB>(st + kRowsT * kLdB, kLdB, vh, d, k0, sk, col);
    float* qs = st + 2 * kRowsT * kLdB;
    stage_rows<kKeysT, kCB>(qs, kLdB, qh, d, q0, sq, col);
    stage_rows<kKeysT, kCB>(qs + kKeysT * kLdB, kLdB, oh, d, q0, sq, col);
    if (i == nb - 1) {
      float* stats = qs + 2 * kKeysT * kLdB;
      if (threadIdx.x < 3 * kKeysT) {
        const int cs = threadIdx.x / kKeysT, r = threadIdx.x % kKeysT;
        const float* src = cs == 0 ? row_max : cs == 1 ? row_sum : delta;
        const bool in = q0 + r < sq;
        cp_async4(stats + threadIdx.x, src + rows + (in ? q0 + r : 0), in);
      }
      if constexpr (kBias)
        stage_bias<kKeysT, kRowsT>(stats + 3 * kKeysT, kBiasLdT, bias_g, rs1,
                                   q0, sq, k0, sk, bias_vec);
    }
  };

  // the loads run kStages - 1 steps ahead of the math: (q tile, block)
  int qb_load = next_live(0), i_load = 0, n_loaded = 0;
  auto fill_next = [&]() {
    if (qb_load >= nq) return;
    fill(qb_load, i_load, n_loaded++);
    if (++i_load == nb) {
      i_load = 0;
      qb_load = next_live(qb_load + 1);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    fill_next();
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int kr = 16 * warp;
  uint32_t key = 0;
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
  float acc_dk[kCB / 8][4], acc_dv[kCB / 8][4];
#pragma unroll
  for (int nn = 0; nn < kCB / 8; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[nn][i] = acc_dv[nn][i] = 0.f;
  float st[kKeysT / 8][4], dpt[kKeysT / 8][4];

  int n = 0;
  for (int qb = next_live(0); qb < nq; qb = next_live(qb + 1)) {
    for (int i = 0; i < nb; ++i, ++n) {
      fill_next();
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const float* Ks = ring + (n % kStages) * kStageFloats;
      const float* Vs = Ks + kRowsT * kLdB;
      const float* Qs = Vs + kRowsT * kLdB;
      const float* dOs = Qs + kKeysT * kLdB;
      const float* stats = dOs + kKeysT * kLdB;
      const float* Bs = stats + 3 * kKeysT;
      const int q0 = qb * kKeysT;

      // S^T += K Q^T and dP^T += V dO^T over this column block
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll 2
      for (int kk = 0; kk < kCB / 8; ++kk) {
        const FragA ak = load_a(Ks, kLdB, kr, 8 * kk);
        const FragA av = load_a(Vs, kLdB, kr, 8 * kk);
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j) {
          mma3(st[j], ak, load_bt(Qs, kLdB, 8 * j, 8 * kk));
          mma3(dpt[j], av, load_bt(dOs, kLdB, 8 * j, 8 * kk));
        }
      }

      if (i == nb - 1) {
        // P^T and dS^T, as the fixed instances form them
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e;
            const int qrow = q0 + c;
            uint32_t row_hash = 0;
            if constexpr (kDropout)
              row_hash = flash_operands::dropout_row(key, qrow);
            const float m_c = stats[c], il_c = 1.f / stats[kKeysT + c];
            const float delta_c = stats[2 * kKeysT + c];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ii = 2 * h + e;
              float b = 0.f;
              if constexpr (kBias)
                b = fmaxf(Bs[(rs1 ? 0 : c) * kBiasLdT + kr + g + 8 * h],
                          kPadValue);
              float pv, ds;
              p_and_ds<kDropout>(st[j][ii], dpt[j][ii], b, qrow,
                                 k0 + kr + g + 8 * h, sq, sk, scale, causal,
                                 offset, m_c, il_c, delta_c, key, row_hash,
                                 threshold, drop_scale, pv, ds);
              st[j][ii] = pv;
              dpt[j][ii] = ds;
            }
          }
        // dV += P^T dO and dK += dS^T Q over the slice (this stage's block)
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j) {
          const FragA ap = a_from_acc(st[j]);
          const FragA ad = a_from_acc(dpt[j]);
#pragma unroll
          for (int nn = 0; nn < kCB / 8; ++nn) {
            mma3(acc_dv[nn], ap, load_b_perm(dOs, kLdB, 8 * j, 8 * nn));
            mma3(acc_dk[nn], ad, load_b_perm(Qs, kLdB, 8 * j, 8 * nn));
          }
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key_row = k0 + kr + g + 8 * h;
    if (key_row >= sk) continue;
    const size_t off =
        (static_cast<size_t>(bh) * sk + key_row) * d + dv0 + 2 * t;
#pragma unroll
    for (int nn = 0; nn < kCB / 8; ++nn) {
      *reinterpret_cast<float2*>(dk + off + 8 * nn) = make_float2(
          acc_dk[nn][2 * h] * scale, acc_dk[nn][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * nn) =
          make_float2(acc_dv[nn][2 * h], acc_dv[nn][2 * h + 1]);
    }
  }
}

// Q block, dO block, K block, V block, K's slice and the bias tile
template <bool kBias>
__host__ __device__ constexpr int dq_wide_stage() {
  return 2 * kRowsT * kLdB + 2 * kKeysT * kLdB + kKeysT * kLdWV +
         (kBias ? kRowsT * kBiasLd : 0);
}

// The dQ pass at wide D: one CTA per (batch-head, 64-row q tile, 128-column
// slice of dQ); a key tile takes nb stages, the last with K's slice.
template <bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ row_max,
                             const float* __restrict__ row_sum,
                             const float* __restrict__ delta,
                             const float* __restrict__ bias,
                             const int* __restrict__ seed,
                             float* __restrict__ dq, int bh_count, int sq,
                             int sk, int d, float scale, int causal,
                             int offset, int bias_div, int bias_rows,
                             uint32_t threshold, float drop_scale) {
  constexpr int kStages = kBwdWideStages;
  constexpr int kStageFloats = dq_wide_stage<kBias>();
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);

  const int nb = d / kCB, slices = d / kWideDV;
  const int n_tiles = (sq + kRowsT - 1) / kRowsT;
  const int slice = static_cast<int>(blockIdx.x % slices);
  const int rest = static_cast<int>(blockIdx.x / slices);
  const int bh = rest % bh_count;
  const int q0 = (n_tiles - 1 - rest / bh_count) * kRowsT;
  const int dv0 = slice * kWideDV;
  const int q_last = min(q0 + kRowsT, sq) - 1;
  const int k_end = causal ? max(0, min(sk, q_last + offset + 1)) : sk;
  const int n_steps = (k_end + kKeysT - 1) / kKeysT * nb;
  const size_t head_q = static_cast<size_t>(bh) * sq * d;
  const float* kh = k + static_cast<size_t>(bh) * sk * d;
  const float* vh = v + static_cast<size_t>(bh) * sk * d;
  const bool rs1 = bias_rows == 1;
  const float* bias_g =
      kBias ? bias + static_cast<size_t>(bh / bias_div) * bias_rows * sk
            : nullptr;
  const bool bias_vec =
      kBias && sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;

  auto fill = [&](int n) {
    float* st = ring + (n % kStages) * kStageFloats;
    const int k0 = (n / nb) * kKeysT, col = (n % nb) * kCB;
    stage_rows<kRowsT, kCB>(st, kLdB, q + head_q, d, q0, sq, col);
    stage_rows<kRowsT, kCB>(st + kRowsT * kLdB, kLdB, dout + head_q, d, q0, sq,
                            col);
    float* ks = st + 2 * kRowsT * kLdB;
    stage_rows<kKeysT, kCB>(ks, kLdB, kh, d, k0, sk, col);
    stage_rows<kKeysT, kCB>(ks + kKeysT * kLdB, kLdB, vh, d, k0, sk, col);
    if (n % nb == nb - 1) {
      float* kslice = ks + 2 * kKeysT * kLdB;
      stage_rows<kKeysT, kWideDV>(kslice, kLdWV, kh, d, k0, sk, dv0);
      if constexpr (kBias)
        stage_bias<kRowsT, kKeysT>(kslice + kKeysT * kLdWV, kBiasLd, bias_g,
                                   rs1, q0, sq, k0, sk, bias_vec);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) fill(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int wr = 16 * warp;
  float m_r[2], il_r[2], delta_r[2];
  uint32_t key = 0, row_hash[2] = {0, 0};
  if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    const size_t ri = static_cast<size_t>(bh) * sq + row;
    m_r[h] = row < sq ? row_max[ri] : 0.f;
    il_r[h] = row < sq ? 1.f / row_sum[ri] : 0.f;
    delta_r[h] = row < sq ? delta[ri] : 0.f;
    if constexpr (kDropout) row_hash[h] = flash_operands::dropout_row(key, row);
  }
  float acc[kWideDV / 8][4];
#pragma unroll
  for (int nn = 0; nn < kWideDV / 8; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nn][i] = 0.f;
  float s[kKeysT / 8][4], dp[kKeysT / 8][4];

  for (int n = 0; n < n_steps; ++n) {
    if (n + kStages - 1 < n_steps) fill(n + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* Qs = ring + (n % kStages) * kStageFloats;
    const float* dOs = Qs + kRowsT * kLdB;
    const float* Ks = dOs + kRowsT * kLdB;
    const float* Vs = Ks + kKeysT * kLdB;
    const float* Kslice = Vs + kKeysT * kLdB;
    const float* Bs = Kslice + kKeysT * kLdWV;
    const int k0 = (n / nb) * kKeysT, c = n % nb;

    // S += Q K^T and dP += dO V^T over this column block
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < kCB / 8; ++kk) {
      const FragA aq = load_a(Qs, kLdB, wr, 8 * kk);
      const FragA ao = load_a(dOs, kLdB, wr, 8 * kk);
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j) {
        mma3(s[j], aq, load_bt(Ks, kLdB, 8 * j, 8 * kk));
        mma3(dp[j], ao, load_bt(Vs, kLdB, 8 * j, 8 * kk));
      }
    }

    if (c == nb - 1) {
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float b2[2] = {0.f, 0.f};
          if constexpr (kBias) {
            const float2 bb = *reinterpret_cast<const float2*>(
                Bs + (rs1 ? 0 : wr + g + 8 * h) * kBiasLd + 8 * j + 2 * t);
            b2[0] = fmaxf(bb.x, kPadValue);
            b2[1] = fmaxf(bb.y, kPadValue);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            float pv, ds;
            p_and_ds<kDropout>(s[j][i], dp[j][i], b2[e], q0 + wr + g + 8 * h,
                               k0 + 8 * j + 2 * t + e, sq, sk, scale, causal,
                               offset, m_r[h], il_r[h], delta_r[h], key,
                               row_hash[h], threshold, drop_scale, pv, ds);
            s[j][i] = ds;
          }
        }
      // dQ += dS K over this CTA's slice
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j) {
        const FragA a = a_from_acc(s[j]);
#pragma unroll
        for (int nn = 0; nn < kWideDV / 8; ++nn)
          mma3(acc[nn], a, load_b_perm(Kslice, kLdWV, 8 * j, 8 * nn));
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= sq) continue;
    float* out = dq + head_q + static_cast<size_t>(row) * d + dv0 + 2 * t;
#pragma unroll
    for (int nn = 0; nn < kWideDV / 8; ++nn)
      *reinterpret_cast<float2*>(out + 8 * nn) =
          make_float2(acc[nn][2 * h] * scale, acc[nn][2 * h + 1] * scale);
  }
}

// ------------------------------------------------------------------ K5

// The head dims a stage holds: all of D up to 128; above, 64-column blocks
// (kBlocked), nb = D / 64 of them a tile pair.  Three stages at D = 32 keep
// three CTAs on an SM (72 KB each), two elsewhere.
template <int kC>
struct Dbias {
  static constexpr int kLd = kC + 4;
  static constexpr int kStages = kC == 32 ? 3 : 2;
};
// The (64 rows x 32 keys) bias tile's row stride: the float2 reads of a
// quad's 8 rows fall 4 banks apart.  The tile, read, then holds the
// dbias tile on its way out (each thread overwrites what it read).
constexpr int kBiasLd5 = kKeysT + 4;

// Floats of one stage: the Q and dO tiles unless they are resident, the K
// and V tiles and the bias tile.
__host__ __device__ inline int dbias_stage(int ld, bool resident) {
  return (resident ? 0 : 2 * kRowsT * ld) + 2 * kKeysT * ld +
         kRowsT * kBiasLd5;
}

__host__ __device__ inline size_t dbias_smem(int ld, int stages, bool resident) {
  return sizeof(float) * ((resident ? 2 * kRowsT * ld : 0) +
                          stages * dbias_stage(ld, resident));
}

// dbias: kRowBias (RS = S_q) one CTA per (group, 64-row q tile) along the
// key walk, 32 keys a step; else (RS = 1) one CTA per (group, 32-key tile)
// over every live q tile.  Each step of the walk is one (outer tile,
// member, column block): the group's members loop inside the walk and ds
// sums in registers in member order.  Q and dO stay resident when the
// group has one member (G = BH, the evoformer's layout) at RS = S_q and D
// <= 128: then K, V and the bias tile are all that stream, and every
// operand is read once.  Each step waits for its stage and passes a
// barrier, then issues the copies of the step kStages - 1 ahead into the
// stage the step before used: one barrier a step guards the ring (two
// where a dbias tile goes out).
template <int kC, bool kBlocked, bool kRowBias, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_dbias_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_sum,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias,
                       const int* __restrict__ seed, float* __restrict__ dbias,
                       int members, int sq, int sk, int d, float scale,
                       int causal, int offset, uint32_t threshold,
                       float drop_scale) {
  constexpr int kLd = Dbias<kC>::kLd;
  constexpr int kStages = Dbias<kC>::kStages;
  const int nb = kBlocked ? d / kC : 1;
  const bool resident = !kBlocked && kRowBias && members == 1;
  const int stage_floats = dbias_stage(kLd, resident);
  extern __shared__ float4 smem4[];
  float* q_res = reinterpret_cast<float*>(smem4);  // resident Q, then dO
  float* ring = q_res + (resident ? 2 * kRowsT * kLd : 0);

  const int nq = (sq + kRowsT - 1) / kRowsT;
  const int nk = (sk + kKeysT - 1) / kKeysT;
  const int g = static_cast<int>(blockIdx.x / (kRowBias ? nq : nk));
  const int fixed = static_cast<int>(blockIdx.x % (kRowBias ? nq : nk));
  // RS = S_q: this CTA's q tile and its key walk; RS = 1: its key tile
  // and the first q tile with a live pair
  int n_outer, first = 0;
  if constexpr (kRowBias) {
    const int q_last = min(fixed * kRowsT + kRowsT, sq) - 1;
    const int k_end = causal ? max(0, min(sk, q_last + offset + 1)) : sk;
    n_outer = (k_end + kKeysT - 1) / kKeysT;
  } else {
    if (causal)
      while (first < nq &&
             min(first * kRowsT + kRowsT, sq) - 1 + offset < fixed * kKeysT)
        ++first;
    n_outer = nq - first;
  }
  const int n_steps = n_outer * members * nb;
  const size_t bias_off = static_cast<size_t>(g) * (kRowBias ? sq : 1) * sk;
  const float* bias_g = bias + bias_off;
  const bool bias_vec =
      sk % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  // step n: outer tile n / (members nb), member n / nb % members, column
  // block n % nb
  auto tiles = [&](int n, int& q0, int& k0, int& bh, int& c) {
    const int o = n / (members * nb);
    bh = g * members + (n / nb) % members;
    c = n % nb;
    q0 = (kRowBias ? fixed : first + o) * kRowsT;
    k0 = (kRowBias ? o : fixed) * kKeysT;
  };
  auto fill = [&](int n) {
    int q0, k0, bh, c;
    tiles(n, q0, k0, bh, c);
    float* st = ring + (n % kStages) * stage_floats;
    const size_t head_q = static_cast<size_t>(bh) * sq * d;
    const size_t head_k = static_cast<size_t>(bh) * sk * d;
    if (!resident) {
      stage_rows<kRowsT, kC>(st, kLd, q + head_q, d, q0, sq, c * kC);
      stage_rows<kRowsT, kC>(st + kRowsT * kLd, kLd, dout + head_q, d, q0, sq,
                             c * kC);
      st += 2 * kRowsT * kLd;
    }
    stage_rows<kKeysT, kC>(st, kLd, k + head_k, d, k0, sk, c * kC);
    stage_rows<kKeysT, kC>(st + kKeysT * kLd, kLd, v + head_k, d, k0, sk,
                           c * kC);
    if (c == nb - 1)
      stage_bias<kRowsT, kKeysT>(st + 2 * kKeysT * kLd, kBiasLd5, bias_g,
                                 !kRowBias, q0, sq, k0, sk, bias_vec);
  };

  if (resident) {  // with stage 0's group
    const size_t head_q = static_cast<size_t>(g) * sq * d;
    const int q0 = fixed * kRowsT;
    stage_rows<kRowsT, kC>(q_res, kLd, q + head_q, d, q0, sq, 0);
    stage_rows<kRowsT, kC>(q_res + kRowsT * kLd, kLd, dout + head_q, d, q0,
                           sq, 0);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) fill(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, gl = lane_g(), t = lane_t();
  const int wr = 16 * warp;
  float s[kKeysT / 8][4], dp[kKeysT / 8][4], dsum[kKeysT / 8][4];
#pragma unroll
  for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dsum[j][i] = 0.f;
  // the rows' m, 1/l, delta and dropout hash, reloaded when the member or
  // the q tile changes (once, at G = BH and RS = S_q)
  int stats_bh = -1, stats_q0 = -1;
  float m_r[2] = {0.f, 0.f}, il_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  uint32_t key = 0, row_hash[2] = {0, 0};

  for (int n = 0; n < n_steps; ++n) {
    // step n's stage has landed and every thread is done with step n - 1,
    // whose stage the next fill reuses
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (n + kStages - 1 < n_steps) fill(n + kStages - 1);
    cp_async_commit();
    int q0, k0, bh, c;
    tiles(n, q0, k0, bh, c);
    float* st = ring + (n % kStages) * stage_floats;
    const float* Qs = resident ? q_res : st;
    const float* dOs = resident ? q_res + kRowsT * kLd : st + kRowsT * kLd;
    const float* Ks = resident ? st : st + 2 * kRowsT * kLd;
    const float* Vs = Ks + kKeysT * kLd;
    float* Bs = const_cast<float*>(Vs) + kKeysT * kLd;

    // S += Q K^T and dP += dO V^T over this column block: 16 rows x 32
    // keys a warp
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < kC / 8; ++kk) {
      const FragA aq = load_a(Qs, kLd, wr, 8 * kk);
      const FragA ao = load_a(dOs, kLd, wr, 8 * kk);
#pragma unroll
      for (int j = 0; j < kKeysT / 8; ++j) {
        mma3(s[j], aq, load_bt(Ks, kLd, 8 * j, 8 * kk));
        mma3(dp[j], ao, load_bt(Vs, kLd, 8 * j, 8 * kk));
      }
    }

    if (c == nb - 1) {
      // ds of this member, added to the sum in member order
      const int member = bh - g * members;
      if (kRowBias && member == 0) {
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) dsum[j][i] = 0.f;
      }
      if (bh != stats_bh || q0 != stats_q0) {
        stats_bh = bh;
        stats_q0 = q0;
        if constexpr (kDropout) key = flash_operands::dropout_key(seed, bh);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + wr + gl + 8 * h;
          const size_t ri = static_cast<size_t>(bh) * sq + row;
          m_r[h] = row < sq ? row_max[ri] : 0.f;
          il_r[h] = row < sq ? 1.f / row_sum[ri] : 0.f;
          delta_r[h] = row < sq ? delta[ri] : 0.f;
          if constexpr (kDropout)
            row_hash[h] = flash_operands::dropout_row(key, row);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + wr + gl + 8 * h;
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(
              Bs + (kRowBias ? wr + gl + 8 * h : 0) * kBiasLd5 + 8 * j + 2 * t);
          const float b2[2] = {fmaxf(bb.x, kPadValue), fmaxf(bb.y, kPadValue)};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            float pv, ds;
            p_and_ds<kDropout>(s[j][i], dp[j][i], b2[e], row,
                               k0 + 8 * j + 2 * t + e, sq, sk, scale, causal,
                               offset, m_r[h], il_r[h], delta_r[h], key,
                               row_hash[h], threshold, drop_scale, pv, ds);
            dsum[j][i] += ds;
          }
        }
      }
      if (kRowBias && member == members - 1) {
        // the (64 rows x 32 keys) dbias tile out through the bias tile's
        // place (each thread overwrites what it read), 16 bytes a store
#pragma unroll
        for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(Bs + (wr + gl + 8 * h) * kBiasLd5 +
                                       8 * j + 2 * t) =
                make_float2(dsum[j][2 * h], dsum[j][2 * h + 1]);
        __syncthreads();
        for (int i = threadIdx.x; i < kRowsT * kKeysT / 4; i += kThreads) {
          const int r = i / (kKeysT / 4), c4 = (i % (kKeysT / 4)) * 4;
          const int row = q0 + r, col = k0 + c4;
          if (row >= sq || col >= sk) continue;
          const float* src = Bs + r * kBiasLd5 + c4;
          float* dst = dbias + bias_off + static_cast<size_t>(row) * sk + col;
          if (bias_vec && col + 4 <= sk)
            *reinterpret_cast<float4*>(dst) =
                *reinterpret_cast<const float4*>(src);
          else
            for (int e = 0; e < 4 && col + e < sk; ++e) dst[e] = src[e];
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight past the kernel's end

  if constexpr (kRowBias) {
    // keys past the walk see no live pair: dbias is 0 there
    const int q0 = fixed * kRowsT, kz = n_outer * kKeysT;
    const int w = sk - kz;
    for (int i = threadIdx.x; w > 0 && i < kRowsT * w; i += kThreads) {
      const int row = q0 + i / w;
      if (row < sq)
        dbias[bias_off + static_cast<size_t>(row) * sk + kz + i % w] = 0.f;
    }
  } else {
    // the 64 rows' sums (in the first stage's bias tile), then each key's
    // sum over the rows in order
    float* sums = ring + stage_floats - kRowsT * kBiasLd5;
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int j = 0; j < kKeysT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(sums + (wr + gl + 8 * h) * kBiasLd5 +
                                   8 * j + 2 * t) =
            make_float2(dsum[j][2 * h], dsum[j][2 * h + 1]);
    __syncthreads();
    const int k0 = fixed * kKeysT;
    if (threadIdx.x < kKeysT && k0 + static_cast<int>(threadIdx.x) < sk) {
      float sum = 0.f;
      for (int r = 0; r < kRowsT; ++r) sum += sums[r * kBiasLd5 + threadIdx.x];
      dbias[bias_off + k0 + threadIdx.x] = sum;
    }
  }
}

// ------------------------------------------------------------ launchers

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// D: 32, 64, 128 or 256, or 0 for the wide instance (d a multiple of 128
// above 256)
template <int D, bool kBias, bool kDropout>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               const void* seed, void* o, void* lse, void* m, void* l, int bh,
               int sq, int sk, int d, int bias_div, int bias_rows, float scale,
               int causal, int offset, uint32_t threshold, float drop_scale,
               cudaStream_t stream) {
  // one CTA per (batch-head, q tile, slice of o)
  int slices = 0;
  if constexpr (D == 0)
    slices = d / kWideDV;
  else
    slices = D / Slice<D>::kDV;
  const size_t ctas =
      static_cast<size_t>(bh) * ((sq + kRowsT - 1) / kRowsT) * slices;
  if (ctas > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* bp = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(seed);
  float* op = static_cast<float*>(o);
  float* lsep = static_cast<float*>(lse);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  const dim3 grid(static_cast<unsigned>(ctas));
  if constexpr (D == 0) {
    auto* kernel = &flash_fwd_f32_wide_kernel<kBias, kDropout>;
    constexpr size_t bytes =
        sizeof(float) * kFwdWideStages * fwd_wide_stage<kBias>();
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, bytes, stream>>>(
        qp, kp, vp, bp, sp, op, lsep, mp, lp, bh, sq, sk, d, scale, causal,
        offset, bias_div, bias_rows, threshold, drop_scale);
  } else {
    auto* kernel = &flash_fwd_f32_kernel<D, kBias, kDropout>;
    constexpr size_t bytes = fwd_smem<D, kBias>();
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, bytes, stream>>>(
        qp, kp, vp, bp, sp, op, lsep, mp, lp, bh, sq, sk, scale, causal,
        offset, bias_div, bias_rows, threshold, drop_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBias, bool kDropout>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* m, const void* l, const void* delta,
               const void* bias, const void* seed, void* dq, void* dk,
               void* dv, int bh, int sq, int sk, int d, int bias_div,
               int bias_rows, float scale, int causal, int offset,
               uint32_t threshold, float drop_scale, cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* op = static_cast<const float*>(dout);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* dp = static_cast<const float*>(delta);
  const float* bp = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(seed);
  const size_t nk = (sk + kRowsT - 1) / kRowsT;
  const size_t nq = (sq + kRowsT - 1) / kRowsT;
  // the CTAs of a key tile (dK/dV) and of a q tile (dQ): one per slice
  int dkdv_slices = 0, dq_slices = 0;
  if constexpr (D == 0) {
    dkdv_slices = d / kCB;
    dq_slices = d / kWideDV;
  } else {
    dkdv_slices = D / Slice<D>::kDkdvDV;
    dq_slices = D / Slice<D>::kDV;
  }
  const size_t dkdv_ctas = bh * nk * dkdv_slices;
  const size_t dq_ctas = bh * nq * dq_slices;
  if (dkdv_ctas > 0x7fffffffu || dq_ctas > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 dkdv_grid(static_cast<unsigned>(dkdv_ctas));
  const dim3 dq_grid(static_cast<unsigned>(dq_ctas));
  cudaError_t err;
  if constexpr (D == 0) {
    auto* dkdv = &flash_bwd_dkdv_f32_wide_kernel<kBias, kDropout>;
    auto* dqk = &flash_bwd_dq_f32_wide_kernel<kBias, kDropout>;
    constexpr size_t dkdv_bytes =
        sizeof(float) * kBwdWideStages * dkdv_wide_stage<kBias>();
    constexpr size_t dq_bytes =
        sizeof(float) * kBwdWideStages * dq_wide_stage<kBias>();
    err = allow_smem(dkdv, dkdv_bytes);
    if (err == cudaSuccess) err = allow_smem(dqk, dq_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv<<<dkdv_grid, kThreads, dkdv_bytes, stream>>>(
        qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<float*>(dk),
        static_cast<float*>(dv), bh, sq, sk, d, scale, causal, offset,
        bias_div, bias_rows, threshold, drop_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dqk<<<dq_grid, kThreads, dq_bytes, stream>>>(
        qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<float*>(dq), bh, sq,
        sk, d, scale, causal, offset, bias_div, bias_rows, threshold,
        drop_scale);
  } else {
    auto* dkdv = &flash_bwd_dkdv_f32_kernel<D, kBias, kDropout>;
    auto* dqk = &flash_bwd_dq_f32_kernel<D, kBias, kDropout>;
    constexpr size_t dkdv_bytes = dkdv_smem<D, kBias>();
    constexpr size_t dq_bytes = dq_smem<D, kBias>();
    err = allow_smem(dkdv, dkdv_bytes);
    if (err == cudaSuccess) err = allow_smem(dqk, dq_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv<<<dkdv_grid, kThreads, dkdv_bytes, stream>>>(
        qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<float*>(dk),
        static_cast<float*>(dv), bh, sq, sk, scale, causal, offset, bias_div,
        bias_rows, threshold, drop_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dqk<<<dq_grid, kThreads, dq_bytes, stream>>>(
        qp, kp, vp, op, mp, lp, dp, bp, sp, static_cast<float*>(dq), bh, sq,
        sk, scale, causal, offset, bias_div, bias_rows, threshold, drop_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// kC: 32, 64 or 128 (D itself), or 64 with kBlocked (D = 256 and the wide
// head dims)
template <int kC, bool kBlocked, bool kRowBias, bool kDropout>
int launch_dbias(const void* q, const void* k, const void* v, const void* dout,
                 const void* m, const void* l, const void* delta,
                 const void* bias, const void* seed, void* dbias, int groups,
                 int members, int sq, int sk, int d, float scale, int causal,
                 int offset, uint32_t threshold, float drop_scale,
                 cudaStream_t stream) {
  auto* kernel = &flash_dbias_f32_kernel<kC, kBlocked, kRowBias, kDropout>;
  const bool resident = !kBlocked && kRowBias && members == 1;
  const size_t bytes =
      dbias_smem(Dbias<kC>::kLd, Dbias<kC>::kStages, resident);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (sq + kRowsT - 1) / kRowsT;
  const int nk = (sk + kKeysT - 1) / kKeysT;
  const size_t ctas = static_cast<size_t>(groups) * (kRowBias ? nq : nk);
  if (ctas > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(static_cast<unsigned>(ctas)), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<float*>(dbias), members, sq,
      sk, d, scale, causal, offset, threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

// d: 32, 64, 128, 256, or a multiple of 128 above 256 (the wide instance)
bool bad_args(int bh, int sq, int sk, int d, int groups, int bias_rows) {
  return bh <= 0 || sq <= 0 || sk <= 0 ||
         (d != 32 && d != 64 && d != 128 && !(d >= 256 && d % 128 == 0)) ||
         groups <= 0 || bh % groups != 0 ||
         (bias_rows != 1 && bias_rows != sq);
}

// The instance of a launcher template for (d, two flags).
#define APEX_F32_PICK(FN, D, A, B)                                          \
  ((A) ? ((B) ? &FN<D, true, true> : &FN<D, true, false>)                   \
       : ((B) ? &FN<D, false, true> : &FN<D, false, false>))
#define APEX_F32_BY_D(FN, d, A, B)                                          \
  ((d) == 32    ? APEX_F32_PICK(FN, 32, A, B)                               \
   : (d) == 64  ? APEX_F32_PICK(FN, 64, A, B)                               \
   : (d) == 128 ? APEX_F32_PICK(FN, 128, A, B)                              \
   : (d) == 256 ? APEX_F32_PICK(FN, 256, A, B)                              \
                : APEX_F32_PICK(FN, 0, A, B))

using DbiasFn = decltype(&launch_dbias<32, false, true, true>);

template <int kC, bool kBlocked>
DbiasFn pick_dbias(bool row_bias, bool dropout) {
  if (row_bias)
    return dropout ? &launch_dbias<kC, kBlocked, true, true>
                   : &launch_dbias<kC, kBlocked, true, false>;
  return dropout ? &launch_dbias<kC, kBlocked, false, true>
                 : &launch_dbias<kC, kBlocked, false, false>;
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The C entry points take the arguments of their bf16 counterparts
// (flash_fwd.cu, flash_bwd.cu, flash_dbias.cu) with f32 q, k, v, dO, o, dq,
// dk and dv, 16-byte aligned.  d must be 32, 64, 128, 256 or a multiple of
// 128 above 256.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, void* o,
                             void* lse, void* m, void* l, int bh, int sq,
                             int sk, int d, int groups, int bias_rows,
                             float scale, int causal, unsigned threshold,
                             float drop_scale, void* stream) {
  if (bad_args(bh, sq, sk, d, groups, bias_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run =
      APEX_F32_BY_D(launch_fwd, d, bias != nullptr, seed != nullptr);
  return run(q, k, v, bias, seed, o, lse, m, l, bh, sq, sk, d, bh / groups,
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
  const auto run =
      APEX_F32_BY_D(launch_bwd, d, bias != nullptr, seed != nullptr);
  return run(q, k, v, dout, m, l, delta, bias, seed, dq, dk, dv, bh, sq, sk,
             d, bh / groups, bias_rows, scale, causal, sk - sq, threshold,
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
  // with sq = 1 the two layouts coincide and the RS = 1 path serves both;
  // D = 128 keeps its tiles whole only with Q and dO resident (streamed
  // too they would pass 227 KB), else it takes 64-column blocks
  const bool row_bias = bias_rows != 1, dropout = seed != nullptr;
  const bool resident = row_bias && groups == bh;
  const auto run =
      d == 32                ? pick_dbias<32, false>(row_bias, dropout)
      : d == 64              ? pick_dbias<64, false>(row_bias, dropout)
      : d == 128 && resident ? pick_dbias<128, false>(row_bias, dropout)
                             : pick_dbias<64, true>(row_bias, dropout);
  return run(q, k, v, dout, m, l, delta, bias, seed, dbias, groups,
             bh / groups, sq, sk, d, scale, causal, sk - sq, threshold,
             drop_scale, static_cast<cudaStream_t>(stream));
}
