// K1: fused LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/layer_norm.py :: layer_norm_fwd
//           (Pallas body _ln_fwd_kernel) — per-row f32 statistics, y in
//           the input dtype, mu and rstd saved in f32.
// Bound on the H100: device-memory bytes.  Each element is read once and
//           written once (2 + 2 bytes in bf16) against ~8 flops, far below
//           the 295 flop/byte balance point, so the least time is
//           (bytes of x + bytes of y) / 3.35 TB/s.
// Design:   the row lives in registers.  A row goes to a group of `lanes`
//           lanes of one warp (32 for rows of 128 values and more, fewer
//           for narrower rows, so no lane idles), each lane holding kPer
//           values from 16-byte loads (8 bf16 or 4 f32; a row whose byte
//           width or base is not a multiple of 16 takes the same path with
//           one element per load).  The statistics are the two-pass mean
//           and variance of _jnp_fwd, from the registers, each reduced by
//           shuffles within the lane group: the row path has no shared
//           memory and no __syncthreads.  The grid is persistent (the
//           wrapper's launch plan, ops/layer_norm.py norm_launch_plan:
//           the CTAs of 8 warps that stay resident on an SM, as
//           layer_norm_fwd_ctas_per_sm reports them; __launch_bounds__
//           keeps at least kCtas), each warp striding over the rows with w and b
//           loaded once into registers (16-byte loads too, their bases
//           in the plan's alignment check), and the next row's loads issued
//           before the current row's reductions so that every warp keeps
//           two rows of loads in flight.  Rows wider than 32 * 32 values
//           (kPer = 0) stream: three passes over the row, which L1 and L2
//           serve after the first.  bf16 and f32 I/O share one template;
//           weights are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include "launch_query.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// kVec values of T as one load: a 16-byte vector, or one element.
template <typename T, int kVec>
using Raw = std::conditional_t<(kVec > 1), uint4, T>;

template <typename T, int kVec>
__device__ __forceinline__ Raw<T, kVec> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, kVec>*>(p);
}

template <typename T, int kVec>
__device__ __forceinline__ Raw<T, kVec> zero_raw() {
  if constexpr (kVec > 1)
    return make_uint4(0u, 0u, 0u, 0u);
  else
    return from_f<T>(0.f);
}

template <typename T, int kVec>
__device__ __forceinline__ float raw_at(const Raw<T, kVec>& r, int e) {
  if constexpr (kVec > 1)
    return to_f(reinterpret_cast<const T*>(&r)[e]);
  else
    return to_f(r);
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[kVec]) {
  Raw<T, kVec> r;
  if constexpr (kVec > 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) reinterpret_cast<T*>(&r)[e] = from_f<T>(v[e]);
  } else {
    r = from_f<T>(v[0]);
  }
  *reinterpret_cast<Raw<T, kVec>*>(p) = r;
}

// kVec f32 values from p into out: 16-byte loads when kVec >= 4 (p then
// 16-byte aligned), else one at a time.
template <int kVec>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (kVec >= 4) {
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      out[e] = v.x;
      out[e + 1] = v.y;
      out[e + 2] = v.z;
      out[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = p[e];
  }
}

// Sum over a lane group (lanes a power of two, groups aligned in the warp).
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CTAs per SM that each variant's registers allow: kPer values a lane of
// kBytes bytes.  The launch plan reads the resident count back through
// layer_norm_fwd_ctas_per_sm.
template <typename T, int kPer>
struct Cfg {
  static constexpr int kBytes = kPer * static_cast<int>(sizeof(T));
  static constexpr int kCtas = kPer == 0 || kBytes <= 32 ? 4 : kBytes <= 64 ? 2 : 1;
};

template <typename T, int kVec, int kPer>
__global__ void __launch_bounds__(kThreads, (Cfg<T, kPer>::kCtas))
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              int rows, int hidden, int lanes, float eps, int rms) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / lanes, li0 = lane % lanes;
  const int per_warp = 32 / lanes;
  const int stride = static_cast<int>(gridDim.x) * kWarps * per_warp;
  const int first = (static_cast<int>(blockIdx.x) * kWarps + warp) * per_warp;
  const float inv_n = 1.f / static_cast<float>(hidden);

  if constexpr (kPer > 0) {
    constexpr int kLoads = kPer / kVec;
    // load t of a lane covers columns [col(t), col(t) + kVec)
    auto col = [&](int t) { return (li0 + lanes * t) * kVec; };
    Raw<T, kVec> cur[kLoads], nxt[kLoads];
    auto fetch = [&](Raw<T, kVec>(&dst)[kLoads], int r) {
      const T* xr = x + static_cast<size_t>(r) * hidden;
#pragma unroll
      for (int t = 0; t < kLoads; ++t)
        dst[t] = r < rows && col(t) < hidden ? load_raw<T, kVec>(xr + col(t))
                                              : zero_raw<T, kVec>();
    };
    // w and b once per warp
    float wv[kPer], bv[kPer];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      if (col(t) < hidden) {
        load_f32<kVec>(w + col(t), wv + t * kVec);
        load_f32<kVec>(b + col(t), bv + t * kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) wv[t * kVec + e] = bv[t * kVec + e] = 0.f;
      }
    }
    fetch(cur, first + group);
    for (int base = first; base < rows; base += stride) {
      const int r = base + group;
      fetch(nxt, r + stride);  // in flight during this row's reductions
      float mean = 0.f;
      if (!rms) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < kLoads; ++t)
#pragma unroll
          for (int e = 0; e < kVec; ++e) s += raw_at<T, kVec>(cur[t], e);
        mean = group_sum(s, lanes) * inv_n;
      }
      float s2 = 0.f;
#pragma unroll
      for (int t = 0; t < kLoads; ++t)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = raw_at<T, kVec>(cur[t], e) - mean;
          s2 += col(t) + e < hidden ? d * d : 0.f;
        }
      const float rstd = 1.f / sqrtf(group_sum(s2, lanes) * inv_n + eps);
      if (r < rows) {
        T* yr = y + static_cast<size_t>(r) * hidden;
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          if (col(t) >= hidden) continue;
          float out[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            out[e] = (raw_at<T, kVec>(cur[t], e) - mean) * rstd *
                         wv[t * kVec + e] +
                     bv[t * kVec + e];
          store_vec<T, kVec>(yr + col(t), out);
        }
        if (li0 == 0) {
          mu_out[r] = mean;
          rstd_out[r] = rstd;
        }
      }
#pragma unroll
      for (int t = 0; t < kLoads; ++t) cur[t] = nxt[t];
    }
  } else {
    // a wide row streams: one warp per row (lanes = 32), three passes
    for (int r = first; r < rows; r += stride) {
      const T* xr = x + static_cast<size_t>(r) * hidden;
      float mean = 0.f;
      if (!rms) {
        float s = 0.f;
        for (int c = lane * kVec; c < hidden; c += 32 * kVec) {
          const Raw<T, kVec> v = load_raw<T, kVec>(xr + c);
#pragma unroll
          for (int e = 0; e < kVec; ++e) s += raw_at<T, kVec>(v, e);
        }
        mean = group_sum(s, 32) * inv_n;
      }
      float s2 = 0.f;
      for (int c = lane * kVec; c < hidden; c += 32 * kVec) {
        const Raw<T, kVec> v = load_raw<T, kVec>(xr + c);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = raw_at<T, kVec>(v, e) - mean;
          s2 += d * d;
        }
      }
      const float rstd = 1.f / sqrtf(group_sum(s2, 32) * inv_n + eps);
      T* yr = y + static_cast<size_t>(r) * hidden;
      for (int c = lane * kVec; c < hidden; c += 32 * kVec) {
        const Raw<T, kVec> v = load_raw<T, kVec>(xr + c);
        float out[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          out[e] = (raw_at<T, kVec>(v, e) - mean) * rstd * w[c + e] + b[c + e];
        store_vec<T, kVec>(yr + c, out);
      }
      if (lane == 0) {
        mu_out[r] = mean;
        rstd_out[r] = rstd;
      }
    }
  }
}

template <typename T>
using Kernel = decltype(&ln_fwd_kernel<T, 1, 0>);

template <typename T, int kVec>
Kernel<T> pick_per(int per_lane) {
  switch (per_lane) {
    case 0: return ln_fwd_kernel<T, kVec, 0>;
    case 8: return ln_fwd_kernel<T, kVec, 8>;
    case 16: return ln_fwd_kernel<T, kVec, 16>;
    case 32: return ln_fwd_kernel<T, kVec, 32>;
    case 4:
      if constexpr (kVec <= 4) return ln_fwd_kernel<T, kVec, 4>;
      [[fallthrough]];
    default: return nullptr;
  }
}

// The instance for `vec` values per load and `per_lane` values a lane, or
// nullptr.
template <typename T>
Kernel<T> pick(int vec, int per_lane) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) return pick_per<T, kWide>(per_lane);
  if (vec == 1) return pick_per<T, 1>(per_lane);
  return nullptr;
}

template <typename T>
int launch(int vec, int per_lane, const void* x, const void* w, const void* b,
           void* y, void* mu, void* rstd, int rows, int hidden, int lanes,
           int grid, float eps, int rms, cudaStream_t stream) {
  const Kernel<T> kernel = pick<T>(vec, per_lane);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  { if (!apex_query::record(kernel, dim3(grid), kThreads, 0)) kernel<<<dim3(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, hidden, lanes,
      eps, rms); }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident(int vec, int per_lane, int* ctas) {
  const Kernel<T> kernel = pick<T>(vec, per_lane);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads, 0));
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x and y); w, b, mu, rstd are float32.
// The launch plan (ops/layer_norm.py norm_launch_plan): `vec` values per
// load (16 bytes' worth, x and y 16-byte aligned, or 1), `per_lane`
// values a lane holds (4, 8, 16 or 32; 0 streams the row), `lanes` lanes
// per row (a power of two; 32 when streaming) and `grid` CTAs.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mu, void* rstd, int rows,
                              int hidden, float eps, int rms, int dtype,
                              int vec, int per_lane, int lanes, int grid,
                              void* stream) {
  if (rows <= 0 || hidden <= 0 || grid <= 0 || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || (per_lane == 0 && lanes != 32) ||
      hidden % vec != 0 ||
      (per_lane > 0 && (lanes * per_lane < hidden || per_lane % vec != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vec, per_lane, x, w, b, y, mu, rstd, rows, hidden,
                         lanes, grid, eps, rms, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vec, per_lane, x, w, b, y, mu, rstd, rows,
                                 hidden, lanes, grid, eps, rms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CTAs of the instance for (dtype, vec, per_lane) that stay resident on
// an SM of the current device, into *ctas: the launch plan sizes its
// persistent grid from it.
extern "C" int layer_norm_fwd_ctas_per_sm(int dtype, int vec, int per_lane,
                                          int* ctas) {
  if (dtype == 0) return resident<float>(vec, per_lane, ctas);
  if (dtype == 1) return resident<__nv_bfloat16>(vec, per_lane, ctas);
  return static_cast<int>(cudaErrorInvalidValue);
}
