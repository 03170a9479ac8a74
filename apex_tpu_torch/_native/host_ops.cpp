// Host-side native ops of apex_tpu_torch: the port's own copy of the
// JAX package's host C++ layer (the counterpart of the reference's
// csrc/flatten_unflatten.cpp :: flatten/unflatten, and of the input
// pipeline work it leaves to DALI/data_prefetcher).
//
// The device side belongs to the CUDA kernels and cuBLAS; the host side
// of a training job, assembling flat buffers and producing masked-LM
// batches fast enough to keep the card fed, is ordinary native code:
//
//  - flatten/unflatten: threaded memcpy of a tensor list into one
//    contiguous buffer (one host-to-device copy instead of one a tensor);
//  - gather_rows: a shuffled batch's rows gathered from a memory-mapped
//    token file into one contiguous buffer;
//  - mlm_mask: BERT masked-LM corruption (the 80/10/10 rule) with a
//    counter-based RNG, deterministic in (seed, position), so the numpy
//    replay in apex_tpu_torch/_native/__init__.py gives the same bits.
//
// Built at first use by apex_tpu_torch/_native/__init__.py with
// g++ -O3 into build/apex_tpu_torch/ and loaded through ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// flatten / unflatten (≙ apex_C.flatten / apex_C.unflatten)
// ---------------------------------------------------------------------------

void apex_flatten_f32(const float** srcs, const int64_t* sizes, int64_t n,
                      float* dst, int64_t n_threads) {
  std::vector<int64_t> offsets(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + sizes[i];
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        std::memcpy(dst + offsets[i], srcs[i], sizes[i] * sizeof(float));
      }
    });
  }
  for (auto& w : workers) w.join();
}

void apex_unflatten_f32(const float* src, const int64_t* sizes, int64_t n,
                        float** dsts, int64_t n_threads) {
  std::vector<int64_t> offsets(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + sizes[i];
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        std::memcpy(dsts[i], src + offsets[i], sizes[i] * sizeof(float));
      }
    });
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// batch row gather (the data-loader hot loop: assemble a shuffled batch
// from a memory-mapped token file into one contiguous host buffer)
// ---------------------------------------------------------------------------

void apex_gather_rows(const uint8_t* base, const int64_t* offsets,
                      int64_t n_rows, int64_t row_bytes, uint8_t* dst,
                      int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < n_rows; i += n_threads) {
        std::memcpy(dst + i * row_bytes, base + offsets[i], row_bytes);
      }
    });
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// masked-LM batch corruption (the BERT phase-1 input hot loop)
// ---------------------------------------------------------------------------

// splitmix64: counter-based, so (seed, index) fully determines each draw —
// reproducible regardless of threading.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

static inline double u01(uint64_t bits) {
  return (bits >> 11) * (1.0 / 9007199254740992.0);  // 53-bit mantissa
}

// ids/out_ids/out_labels: length n.  Standard BERT corruption:
//   with prob mask_prob, position is "selected":
//     80%: token -> mask_id; 10%: token -> uniform random; 10%: unchanged;
//   labels = original id at selected positions, -1 elsewhere.
// special_floor: ids < special_floor (CLS/SEP/PAD) are never selected.
void apex_mlm_mask(const int32_t* ids, int64_t n, uint64_t seed,
                   double mask_prob, int32_t mask_id, int32_t vocab_size,
                   int32_t special_floor, int32_t* out_ids,
                   int32_t* out_labels, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      for (int64_t i = lo; i < hi; ++i) {
        int32_t id = ids[i];
        out_ids[i] = id;
        out_labels[i] = -1;
        if (id < special_floor) continue;
        uint64_t r0 = splitmix64(seed ^ (uint64_t)i);
        if (u01(r0) >= mask_prob) continue;
        out_labels[i] = id;
        uint64_t r1 = splitmix64(r0);
        double action = u01(r1);
        if (action < 0.8) {
          out_ids[i] = mask_id;
        } else if (action < 0.9) {
          uint64_t r2 = splitmix64(r1);
          out_ids[i] =
              special_floor +
              (int32_t)(splitmix64(r2) % (uint64_t)(vocab_size - special_floor));
        }  // else: keep original token
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
