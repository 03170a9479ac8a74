// What K1's and K2's wide-row instances share (layer_norm_fwd.cu,
// layer_norm_bwd.cu): a row of 1025 to kWideMax values on 4 or 8 warps
// of one CTA of 8 warps.  ops/layer_norm.py mirrors kWideMax
// (WIDE_MAX_HIDDEN) and WideCfg (_wide_regs, _min_blocks): the launch
// plan picks the layout and sizes the grid from them.
#pragma once

#include <cuda_runtime.h>

namespace norm_wide {

// The widest row the wide-row instance holds: 8 warps of 32 lanes, 32
// values a lane.  Wider rows stream (kPer = 0).
constexpr int kWideMax = 8 * 32 * 32;

// A barrier of one row group's `threads` threads (named barrier `id`, 1
// to 15; 0 is __syncthreads'): the other row groups of the CTA run on.
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The registers kPer values of kElem bytes take when loaded kVec at a
// time (a one-element bf16 load takes a whole register).
template <int kElem, int kVec, int kPer>
constexpr int raw_regs() {
  return kPer / kVec * ((kVec * kElem + 3) / 4);
}

// CTAs per SM that a wide variant's registers allow: the loaded values of
// kStreams / 2 row tensors now and next (K1: x; K2: x and g), kStreams
// f32 registers a value (K1: w and b; K2: w, b in x_is_output mode, dw
// and db), and ~24 registers of addresses and sums; two CTAs of 8 warps
// fit 128 registers a thread.
template <typename T, int kVec, int kPer, int kStreams>
struct WideCfg {
  static constexpr int kRegs =
      kStreams * (raw_regs<static_cast<int>(sizeof(T)), kVec, kPer>() + kPer) +
      24;
  static constexpr int kCtas = kRegs <= 128 ? 2 : 1;
};

}  // namespace norm_wide
