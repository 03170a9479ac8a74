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

}  // namespace flash_operands
