// The additive-bias and dropout operands that K3 (flash_fwd.cu) and K4
// (flash_bwd.cu) share, as the TPU kernels define them in
// apex_tpu/ops/pallas/flash_attention.py.
//
// Bias: f32 (G, RS, S_k), G dividing BH (batch-head bh reads group
// bh / (BH / G)), RS 1 (one key-padding row) or S_q (one row per query).
// It is added after the scale and floored at PAD_VALUE, so a padded or
// -inf key stays strictly below a key masked at MASK_VALUE.
//
// Dropout: _dropout_keep_block's keep mask, bit for bit — a keyed
// two-round murmur3-fmix hash of (seed, bh, row, col) in uint32
// arithmetic; an element is kept when the hash is >= the threshold
// min(int(p * 2^32), 2^32 - 1), computed on the host.

#pragma once

#include <cstdint>

namespace flash_operands {

constexpr float kMaskValue = -1e9f;
constexpr float kPadValue = -1.5e9f;

__device__ __forceinline__ uint32_t fmix(uint32_t h, uint32_t mul,
                                         uint32_t key) {
  h ^= h >> 16;
  h *= mul;
  h ^= h >> 13;
  h *= 0x27D4EB2Fu;
  h ^= h >> 16;
  return h + key;
}

// The hash key of one batch-head: seed + bh * 0x9E3779B9 (mod 2^32).
__device__ __forceinline__ uint32_t dropout_key(const int* seed, int bh) {
  return static_cast<uint32_t>(*seed) +
         static_cast<uint32_t>(bh) * 0x9E3779B9u;
}

// The first round, which depends on the row only.
__device__ __forceinline__ uint32_t dropout_row(uint32_t key, int row) {
  return fmix(static_cast<uint32_t>(row) ^ key, 0x85EBCA6Bu, key);
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, uint32_t row_hash,
                                             int col, uint32_t threshold) {
  return fmix(row_hash ^ static_cast<uint32_t>(col), 0xC2B2AE35u, key) >=
         threshold;
}

// Row `row` of batch-head `bh`'s bias (or nullptr without a bias).
__device__ __forceinline__ const float* bias_row(const float* bias, int bh,
                                                 int bias_div, int bias_rows,
                                                 int row, int sk) {
  if (bias == nullptr) return nullptr;
  const size_t group = static_cast<size_t>(bh / bias_div);
  return bias + (group * bias_rows + (bias_rows == 1 ? 0 : row)) *
                    static_cast<size_t>(sk);
}

__device__ __forceinline__ float bias_at(const float* row, int col) {
  return fmaxf(row[col], kPadValue);
}

// How K3 and K4 read a bias: none; per score from global memory (RS = 1,
// or a row stride TMA cannot map); or staged per tile into shared memory
// by TMA (RS = S_q, S_k % 4 == 0, 16-byte aligned).
enum BiasMode { kNoBias = 0, kBiasGlobal = 1, kBiasTile = 2 };

// The mode of a call's bias (null when absent) on the host.
inline int bias_mode(const void* bias, int bias_rows, int sq, int sk) {
  if (bias == nullptr) return kNoBias;
  const bool tma = bias_rows == sq && sq > 1 && sk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  return tma ? kBiasTile : kBiasGlobal;
}

// Element (r, c) of a bias tile staged by TMA as boxes of 32 keys x kRows
// rows of 128 bytes, each box 128-byte swizzled: the 16-byte chunk of a
// row is XORed with the row's index mod 8, so the quads of a warp that
// read 8 rows of one box, or 8 keys of 8 rows, hit distinct banks.
template <int kRows>
__device__ __forceinline__ const float* bias_tile_at(const unsigned char* tile,
                                                     int r, int c) {
  const int cc = c & 31;
  return reinterpret_cast<const float*>(
      tile + (c >> 5) * kRows * 128 + r * 128 + (((cc >> 2) ^ (r & 7)) << 4) +
      ((cc & 3) << 2));
}

}  // namespace flash_operands
