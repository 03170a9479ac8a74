// K2: fused LayerNorm / RMSNorm backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/layer_norm.py :: layer_norm_bwd
//           (Pallas body _ln_bwd_kernel; its per-block dw/db partials are
//           summed by the caller) — dx in the input dtype and f32 dw, db,
//           with the rms and x_is_output (memory_efficient) modes.
// Bound on the H100: device-memory bytes.  x and g are read and dx is
//           written once (6 bytes per element in bf16) against ~12 flops,
//           far below the 295 flop/byte balance point, so the least time is
//           (bytes of x, g, dx + w, b, mu, rstd, dw, db) / 3.35 TB/s.
// Design:   K1's shape (layer_norm_fwd.cu).  A row goes to a group of
//           `lanes` lanes of one warp, each lane holding kPer values of x
//           and of g from 16-byte loads (one element per load where the
//           row's byte width or base is not a multiple of 16), with w in
//           registers; c1 = mean(g*w) and c2 = mean(g*w*xhat) are reduced by
//           shuffles within the group (no shared memory, no __syncthreads
//           on the row path), dx is written, and dw += g*xhat and db += g
//           accumulate in registers for the lane's columns across the
//           warp's rows.  The grid is persistent (the wrapper's launch plan,
//           ops/layer_norm.py norm_launch_plan), the next row's x, g, mu and
//           rstd loads are issued before the current row's reductions, and
//           at the end the lane groups of a warp combine by shuffles and the
//           CTA's warps in shared memory in a fixed order, once; each CTA
//           writes one partial row of dw and db, and the wrapper sums the
//           partial rows with one torch.sum, as the JAX package sums the
//           Pallas partials in jnp — no atomics, so the result is the same
//           from run to run.  Rows wider than 32 * 32 values (kPer = 0)
//           stream through L1/L2, one warp per row, each warp accumulating
//           into a partial row of its own.  x_is_output recovers xhat =
//           (y - b) / w from the saved output, with xhat = 0 where w == 0
//           (_jnp_bwd's guard), reading b through L1; the row loop is
//           compiled once per mode, so the plain mode's unrolled loops carry
//           no per-element branch or division (xhat is one FFMA there).
//           bf16 and f32 I/O share one template; w, b, mu, rstd are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include "launch_query.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRegHidden = 32 * 32;  // the widest row held in registers

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

__device__ __forceinline__ float recover_xhat(float xv, float wv, float bv,
                                              float mean, float rstd,
                                              int x_is_output) {
  if (x_is_output) return wv == 0.f ? 0.f : (xv - bv) / wv;
  return (xv - mean) * rstd;
}

// CTAs per SM that each variant's registers allow: kPer values a lane of
// kBytes bytes, held for x, g and the next row's x and g, beside w, dw and
// db.  The launch plan reads the resident count back through
// layer_norm_bwd_ctas_per_sm.
template <typename T, int kPer>
struct Cfg {
  static constexpr int kBytes = kPer * static_cast<int>(sizeof(T));
  static constexpr int kCtas =
      kPer == 0 ? 2 : kBytes <= 16 ? 4 : kBytes <= 32 ? 2 : 1;
};

template <typename T, int kVec, int kPer>
__global__ void __launch_bounds__(kThreads, (Cfg<T, kPer>::kCtas))
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ mu,
              const float* __restrict__ rstd, const T* __restrict__ g,
              T* __restrict__ dx, float* __restrict__ part, int rows,
              int hidden, int lanes, int rms, int x_is_output) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / lanes, li0 = lane % lanes;
  const int per_warp = 32 / lanes;
  const int stride = static_cast<int>(gridDim.x) * kWarps * per_warp;
  const int first = (static_cast<int>(blockIdx.x) * kWarps + warp) * per_warp;
  const float inv_n = 1.f / static_cast<float>(hidden);

  if constexpr (kPer > 0) {
    constexpr int kLoads = kPer / kVec;
    __shared__ float sums[2][kMaxRegHidden];  // the CTA's dw, db (at the end)
    auto col = [&](int t) { return (li0 + lanes * t) * kVec; };
    Raw<T, kVec> cx[kLoads], cg[kLoads], nx[kLoads], ng[kLoads];
    float c_mu = 0.f, c_rs = 0.f, n_mu = 0.f, n_rs = 0.f;
    auto fetch = [&](Raw<T, kVec>(&dst_x)[kLoads], Raw<T, kVec>(&dst_g)[kLoads],
                     float& m, float& rs, int r) {
      const bool in = r < rows;
      const size_t off = static_cast<size_t>(r) * hidden;
#pragma unroll
      for (int t = 0; t < kLoads; ++t) {
        const bool ok = in && col(t) < hidden;
        dst_x[t] = ok ? load_raw<T, kVec>(x + off + col(t)) : zero_raw<T, kVec>();
        dst_g[t] = ok ? load_raw<T, kVec>(g + off + col(t)) : zero_raw<T, kVec>();
      }
      m = in ? mu[r] : 0.f;
      rs = in ? rstd[r] : 0.f;
    };
    fetch(cx, cg, c_mu, c_rs, first + group);
    // w once per warp
    float wv[kPer], acc_dw[kPer], acc_db[kPer];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      if (col(t) < hidden) {
        load_f32<kVec>(w + col(t), wv + t * kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) wv[t * kVec + e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc_dw[i] = acc_db[i] = 0.f;
    // the row loop, with x_is_output fixed at compile time so that no
    // per-element branch (or the division of the recovered xhat) sits in
    // the plain path's unrolled loops
    auto rows_loop = [&](auto output_tag) {
      constexpr bool kFromOutput = decltype(output_tag)::value;
      for (int base = first; base < rows; base += stride) {
        const int r = base + group;
        fetch(nx, ng, n_mu, n_rs, r + stride);  // in flight during this row
        const float shift = -c_mu * c_rs;
        auto xhat_at = [&](int t, int e, float wc) {
          const float xv = raw_at<T, kVec>(cx[t], e);
          if constexpr (kFromOutput) {
            const float bc = __ldg(b + col(t) + e);
            return wc == 0.f ? 0.f : (xv - bc) / wc;
          } else {
            return fmaf(xv, c_rs, shift);
          }
        };
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          if (col(t) >= hidden) continue;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float wc = wv[t * kVec + e];
            const float dyw = raw_at<T, kVec>(cg[t], e) * wc;
            s1 += dyw;
            s2 += dyw * xhat_at(t, e, wc);
          }
        }
        const float c1 = rms ? 0.f : group_sum(s1, lanes) * inv_n;
        const float c2 = group_sum(s2, lanes) * inv_n;
        if (r < rows) {
          T* dxr = dx + static_cast<size_t>(r) * hidden;
#pragma unroll
          for (int t = 0; t < kLoads; ++t) {
            if (col(t) >= hidden) continue;
            float out[kVec];
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const int i = t * kVec + e;
              const float gg = raw_at<T, kVec>(cg[t], e);
              const float xh = xhat_at(t, e, wv[i]);
              out[e] = c_rs * (gg * wv[i] - c1 - xh * c2);
              acc_dw[i] += gg * xh;
              acc_db[i] += gg;
            }
            store_vec<T, kVec>(dxr + col(t), out);
          }
        }
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          cx[t] = nx[t];
          cg[t] = ng[t];
        }
        c_mu = n_mu;
        c_rs = n_rs;
      }
    };
    if (x_is_output)
      rows_loop(std::true_type{});
    else
      rows_loop(std::false_type{});
    // the warp's lane groups hold the same columns: combine them
    for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        acc_dw[i] += __shfl_xor_sync(0xffffffffu, acc_dw[i], o);
        acc_db[i] += __shfl_xor_sync(0xffffffffu, acc_db[i], o);
      }
    // then the CTA's warps, in order, into one partial row
    for (int c = threadIdx.x; c < hidden; c += kThreads) sums[0][c] = sums[1][c] = 0.f;
    __syncthreads();
    for (int wi = 0; wi < kWarps; ++wi) {
      if (warp == wi && group == 0) {
#pragma unroll
        for (int t = 0; t < kLoads; ++t)
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int c = col(t) + e;
            if (c < hidden) {
              sums[0][c] += acc_dw[t * kVec + e];
              sums[1][c] += acc_db[t * kVec + e];
            }
          }
      }
      __syncthreads();
    }
    float* out = part + static_cast<size_t>(blockIdx.x) * 2 * hidden;
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      out[c] = sums[0][c];
      out[hidden + c] = sums[1][c];
    }
  } else {
    // a wide row streams, one warp per row (lanes = 32); the warp owns
    // partial row blockIdx.x * kWarps + warp
    float* pw = part + (static_cast<size_t>(blockIdx.x) * kWarps + warp) * 2 * hidden;
    float* pb = pw + hidden;
    // each lane zeroes the columns it accumulates below
    for (int c = lane * kVec; c < hidden; c += 32 * kVec)
#pragma unroll
      for (int e = 0; e < kVec; ++e) pw[c + e] = pb[c + e] = 0.f;
    for (int r = first; r < rows; r += stride) {
      const size_t off = static_cast<size_t>(r) * hidden;
      const float m = mu[r], rs = rstd[r];
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane * kVec; c < hidden; c += 32 * kVec) {
        const Raw<T, kVec> xv = load_raw<T, kVec>(x + off + c);
        const Raw<T, kVec> gv = load_raw<T, kVec>(g + off + c);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float wc = w[c + e];
          const float dyw = raw_at<T, kVec>(gv, e) * wc;
          s1 += dyw;
          s2 += dyw * recover_xhat(raw_at<T, kVec>(xv, e), wc, b[c + e], m, rs,
                                   x_is_output);
        }
      }
      const float c1 = rms ? 0.f : group_sum(s1, 32) * inv_n;
      const float c2 = group_sum(s2, 32) * inv_n;
      for (int c = lane * kVec; c < hidden; c += 32 * kVec) {
        const Raw<T, kVec> xv = load_raw<T, kVec>(x + off + c);
        const Raw<T, kVec> gv = load_raw<T, kVec>(g + off + c);
        float out[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float wc = w[c + e];
          const float gg = raw_at<T, kVec>(gv, e);
          const float xhat = recover_xhat(raw_at<T, kVec>(xv, e), wc, b[c + e],
                                          m, rs, x_is_output);
          out[e] = rs * (gg * wc - c1 - xhat * c2);
          pw[c + e] += gg * xhat;
          pb[c + e] += gg;
        }
        store_vec<T, kVec>(dx + off + c, out);
      }
    }
  }
}

template <typename T>
using Kernel = decltype(&ln_bwd_kernel<T, 1, 0>);

template <typename T, int kVec>
Kernel<T> pick_per(int per_lane) {
  switch (per_lane) {
    case 0: return ln_bwd_kernel<T, kVec, 0>;
    case 8: return ln_bwd_kernel<T, kVec, 8>;
    case 16: return ln_bwd_kernel<T, kVec, 16>;
    case 32: return ln_bwd_kernel<T, kVec, 32>;
    case 4:
      if constexpr (kVec <= 4) return ln_bwd_kernel<T, kVec, 4>;
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
           const void* mu, const void* rstd, const void* g, void* dx,
           void* part, int rows, int hidden, int lanes, int grid, int rms,
           int x_is_output, cudaStream_t stream) {
  const Kernel<T> kernel = pick<T>(vec, per_lane);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  { if (!apex_query::record(kernel, dim3(grid), kThreads, 0)) kernel<<<dim3(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), rows, hidden, lanes, rms,
      x_is_output); }
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

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx); w, b, mu, rstd are f32.
// x holds the forward output y when x_is_output is set.  The launch plan
// as K1's (layer_norm_fwd.cu).  part is f32 (grid, 2, hidden) when the row
// is held in registers (per_lane > 0) and (grid * 8, 2, hidden) when it
// streams: the partial rows of dw and db.
extern "C" int layer_norm_bwd(const void* x, const void* w, const void* b,
                              const void* mu, const void* rstd, const void* g,
                              void* dx, void* part, int rows, int hidden,
                              int rms, int x_is_output, int dtype, int vec,
                              int per_lane, int lanes, int grid, void* stream) {
  if (rows <= 0 || hidden <= 0 || grid <= 0 || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || (per_lane == 0 && lanes != 32) ||
      hidden % vec != 0 ||
      (per_lane > 0 && (lanes * per_lane < hidden || per_lane % vec != 0 ||
                        hidden > kMaxRegHidden)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vec, per_lane, x, w, b, mu, rstd, g, dx, part, rows,
                         hidden, lanes, grid, rms, x_is_output, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vec, per_lane, x, w, b, mu, rstd, g, dx,
                                 part, rows, hidden, lanes, grid, rms,
                                 x_is_output, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As layer_norm_fwd_ctas_per_sm (layer_norm_fwd.cu), for K2's instances.
extern "C" int layer_norm_bwd_ctas_per_sm(int dtype, int vec, int per_lane,
                                          int* ctas) {
  if (dtype == 0) return resident<float>(vec, per_lane, ctas);
  if (dtype == 1) return resident<__nv_bfloat16>(vec, per_lane, ctas);
  return static_cast<int>(cudaErrorInvalidValue);
}
