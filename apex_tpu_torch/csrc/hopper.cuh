// Hopper building blocks that K3 (flash_fwd.cu) and K4 (flash_bwd.cu)
// share, written as inline PTX so that each kernel builds in seconds:
//
// - mbarriers, the full/empty handshake of a ring of shared-memory stages;
// - TMA loads of a (D, rows, BH) bf16 tensor map into a swizzled stage;
// - wgmma (m64nNk16, bf16 in, f32 accumulators) with A and B from shared
//   memory, or A from registers and B transposed, and the shared-memory
//   descriptors of the swizzled tiles;
// - on the host, the encoding of the tensor maps through the driver entry
//   point fetched from the runtime (no -lcuda in the build).
//
// A tile row holds one head's D bf16 values: 128 bytes at D = 64 (swizzled
// in 128-byte atoms of 8 rows, descriptor layout 1), 64 bytes at D = 32
// (64-byte atoms of 8 rows, layout 2).  From D = 128 on a row is 256 bytes
// or more, past the 128-byte atom and past the widest TMA box that swizzle
// allows, so a tile of R rows is D / 64 column blocks of R x 64 values (R x
// 128 bytes) side by side (TileLayout): a K-major k16 step past column 64
// moves to the next block, and an MN-major operand whose N spans two blocks
// reaches the second one through the descriptor's leading byte offset.
// TMA and wgmma must agree on the swizzle, and a stage must start on a
// multiple of the atom (1024 bytes).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// How a tile of bf16 rows of D values lies in shared memory: kBlocks
// column blocks of kBoxCols values, each block kRows x kAtomBytes,
// swizzled in kAtomBytes atoms.
template <int D>
struct TileLayout {
  static_assert(D == 32 || D % 64 == 0, "head dim 32 or a multiple of 64");
  static constexpr int kAtomBytes = D >= 64 ? 128 : 2 * D;
  static constexpr int kBlocks = 2 * D / kAtomBytes;
  static constexpr int kBoxCols = kAtomBytes / 2;
  // the byte offset of k16 step kk of a K-major operand (32 bytes of a
  // row per step) in a tile of kRows rows
  template <int kRows>
  __host__ __device__ static constexpr uint32_t kmajor_step(int kk) {
    return (32 * kk / kAtomBytes) * kRows * kAtomBytes + (32 * kk) % kAtomBytes;
  }
  // the byte offset of k16 step kk of an MN-major operand (16 rows)
  __host__ __device__ static constexpr uint32_t mnmajor_step(int kk) {
    return 16 * kk * kAtomBytes;
  }
};

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// never ends (a lost arrival) traps after ~2^26 tries, seconds past any
// real wait, so it surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t tries = 0; !mbar_try_wait(addr, parity);)
    if (++tries == (1u << 26)) __trap();
}

// --------------------------------------------------------------------- TMA

// The box at (c0, c1, c2) of a 3-D tensor map into shared `dst`; the
// transfer completes on `bar`.  Elements outside the tensor read as 0.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row, row + kRows) of head `outer` of a tensor map into the tile
// of D columns at `dst`, one box per column block (TileLayout<D>), from
// column `col` of the map on (a slice of a wider head).
template <int D, int kRows>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int outer, int col = 0) {
  using L = TileLayout<D>;
#pragma unroll
  for (int c = 0; c < L::kBlocks; ++c)
    tma_load_3d(static_cast<unsigned char*>(dst) + c * kRows * L::kAtomBytes,
                map, bar, col + c * L::kBoxCols, row, outer);
}

// ------------------------------------------------------------------- wgmma

// The shared-memory descriptor of a swizzled bf16 tile whose rows are
// kRowBytes (64 or 128) long, starting at `tile`: 8-row groups kRowBytes * 8
// apart (the stride byte offset), swizzle layout 1 (128 B) or 2 (64 B).
// For a K-major operand the rows are M or N and one k16 step is 32 bytes
// of a row; for an MN-major (transposed) operand the rows are K and one
// k16 step is 16 rows.  `lead_bytes` (the leading byte offset) is the
// distance between the 64-value column blocks along N of an MN-major
// operand whose N spans two of them (D >= 128); where N fits in one row
// it is never used.
template <int kRowBytes>
__device__ __forceinline__ uint64_t make_desc(const void* tile,
                                              uint32_t lead_bytes = 16) {
  static_assert(kRowBytes == 64 || kRowBytes == 128, "64 or 128-byte rows");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{(lead_bytes >> 4) & 0x3FFF} << 16) |
         (uint64_t{(8 * kRowBytes) >> 4} << 32) | (kLayout << 62);
}

// A descriptor advanced by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins an accumulator's registers at this point of the program, so that
// no read of them moves above the wait of the wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit (flushes denormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Hand registers from the producer warpgroup to the consumers (both
// sides of a kernel of three warpgroups call one of these once, before
// their loops).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Two f32 as the bf16x2 register of an A fragment (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// In the f32 accumulator of m64nNk16, thread t of the warpgroup holds,
// for each 8-column group j, d[4j + 2h + e] at row 16 (t / 32) + (t % 32)
// / 4 + 8h and column 8j + 2 (t % 4) + e.  Packing d[2i], d[2i + 1] in
// order gives the A fragments of the k16 steps over those columns, which
// is how P and dS go from one product to the next without shared memory.

// m64n64k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n128k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n32k16: A from registers (four bf16x2 per thread), B from
// shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// m64n64k16: A from registers (four bf16x2 per thread), B from
// shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// m64n128k16: A from registers (four bf16x2 per thread), B from
// shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace hopper

// ------------------------------------------------------------ host side

namespace hopper_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a 3-D array (outer, rows, inner) as (inner, rows,
// outer) with a box of (box_inner, box_rows, 1); elements outside the
// array (past `rows` of one outer index, past `inner`) read as zeros.
inline cudaError_t encode_3d(CUtensorMap* map, CUtensorMapDataType type,
                             int elem_bytes, const void* ptr, int outer,
                             int rows, int inner, int box_inner, int box_rows,
                             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(inner) * elem_bytes,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(inner) *
          elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A (bh, rows, d) bf16 array, swizzled as the wgmma descriptors expect:
// one box per head's rows and column block (TileLayout), at most 64
// values (128 bytes) wide.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh,
                            int rows, int d, int box_rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, bh, rows, d,
                   d >= 64 ? 64 : d, box_rows,
                   d >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B);
}

// A (groups, rows, sk) f32 bias in boxes of 32 keys x box_rows rows,
// 128-byte swizzled (flash_operands::bias_tile_at reads them).  TMA needs
// a 16-byte aligned base and row stride: sk % 4 == 0.
inline cudaError_t make_bias_map(CUtensorMap* map, const void* ptr,
                                 int groups, int rows, int sk, int box_rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, groups, rows,
                   sk, 32, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hopper_host
