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
// Design:   a grid of a few CTAs per SM (the wrapper picks n_blocks); each
//           256-thread CTA walks rows blockIdx.x, blockIdx.x + gridDim.x, ...
//           Thread t owns columns t, t + 256, ...  For hidden <= 4096 it
//           keeps its slice of the row (x, g) and of w, b in registers, so
//           each element is read from device memory once; c1 = mean(g*w)
//           and c2 = mean(g*w*xhat) are one fused pair of warp-shuffle and
//           shared-memory block sums in f32; dx is written; dw += g*xhat and
//           db += g accumulate over the CTA's rows in registers.  The TPU
//           grid's sequential row blocks have no counterpart: each CTA
//           writes its partial row of dw and db to an f32 (n_blocks, hidden)
//           buffer, and the wrapper sums the rows with torch.sum as the JAX
//           package sums the Pallas partials in jnp — no atomics, so the
//           result is the same from run to run.  Wider rows (any hidden
//           size) stream x and g through L1/L2 and accumulate into the
//           CTA's own partial row.  x_is_output recovers xhat = (y - b) / w
//           from the saved output, with xhat = 0 where w == 0 (_jnp_bwd's
//           guard).  bf16 and f32 I/O share one template; w, b, mu, rstd
//           are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// Two sums over the block at once; every thread gets both totals.  `red`
// holds one float2 per warp and is free again when this returns.
__device__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < (kThreads >> 5) ? red[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
    }
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float2 total = red[0];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float recover_xhat(float xv, float wv, float bv,
                                              float mean, float rstd,
                                              int x_is_output) {
  if (x_is_output) return wv == 0.f ? 0.f : (xv - bv) / wv;
  return (xv - mean) * rstd;
}

// kCols > 0: hidden <= kCols * kThreads, the row slice lives in registers.
// kCols == 0: any hidden, streamed; the partial rows accumulate in place.
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ mu,
              const float* __restrict__ rstd, const T* __restrict__ g,
              T* __restrict__ dx, float* __restrict__ dw_part,
              float* __restrict__ db_part, int rows, int hidden, int rms,
              int x_is_output) {
  __shared__ float2 red[kThreads / 32];
  const float inv_n = 1.f / static_cast<float>(hidden);
  float* dwp = dw_part + static_cast<size_t>(blockIdx.x) * hidden;
  float* dbp = db_part + static_cast<size_t>(blockIdx.x) * hidden;

  if constexpr (kCols > 0) {
    float wv[kCols], bv[kCols], xh[kCols], gv[kCols], acc_dw[kCols],
        acc_db[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = threadIdx.x + j * kThreads;
      wv[j] = c < hidden ? w[c] : 0.f;
      bv[j] = c < hidden ? b[c] : 0.f;
      acc_dw[j] = 0.f;
      acc_db[j] = 0.f;
    }
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const T* xr = x + static_cast<size_t>(row) * hidden;
      const T* gr = g + static_cast<size_t>(row) * hidden;
      const float r = rstd[row];
      const float m = mu[row];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = threadIdx.x + j * kThreads;
        float xhat = 0.f, gg = 0.f;
        if (c < hidden) {
          gg = to_f(gr[c]);
          xhat = recover_xhat(to_f(xr[c]), wv[j], bv[j], m, r, x_is_output);
        }
        xh[j] = xhat;
        gv[j] = gg;
        const float dyw = gg * wv[j];
        s1 += dyw;
        s2 += dyw * xhat;
      }
      const float2 s = block_sum2(s1, s2, red);
      const float c1 = rms ? 0.f : s.x * inv_n;
      const float c2 = s.y * inv_n;
      T* dxr = dx + static_cast<size_t>(row) * hidden;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = threadIdx.x + j * kThreads;
        if (c < hidden) {
          dxr[c] = from_f<T>(r * (gv[j] * wv[j] - c1 - xh[j] * c2));
          acc_dw[j] += gv[j] * xh[j];
          acc_db[j] += gv[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < hidden) {
        dwp[c] = acc_dw[j];
        dbp[c] = acc_db[j];
      }
    }
  } else {
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      dwp[c] = 0.f;
      dbp[c] = 0.f;
    }
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const T* xr = x + static_cast<size_t>(row) * hidden;
      const T* gr = g + static_cast<size_t>(row) * hidden;
      const float r = rstd[row];
      const float m = mu[row];
      float s1 = 0.f, s2 = 0.f;
      for (int c = threadIdx.x; c < hidden; c += kThreads) {
        const float wc = w[c];
        const float dyw = to_f(gr[c]) * wc;
        s1 += dyw;
        s2 += dyw * recover_xhat(to_f(xr[c]), wc, b[c], m, r, x_is_output);
      }
      const float2 s = block_sum2(s1, s2, red);
      const float c1 = rms ? 0.f : s.x * inv_n;
      const float c2 = s.y * inv_n;
      T* dxr = dx + static_cast<size_t>(row) * hidden;
      for (int c = threadIdx.x; c < hidden; c += kThreads) {
        const float wc = w[c];
        const float gg = to_f(gr[c]);
        const float xhat = recover_xhat(to_f(xr[c]), wc, b[c], m, r, x_is_output);
        dxr[c] = from_f<T>(r * (gg * wc - c1 - xhat * c2));
        dwp[c] += gg * xhat;
        dbp[c] += gg;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* mu,
           const void* rstd, const void* g, void* dx, void* dw_part,
           void* db_part, int rows, int hidden, int n_blocks, int rms,
           int x_is_output, cudaStream_t stream) {
  const dim3 grid(n_blocks);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const float* mp = static_cast<const float*>(mu);
  const float* rp = static_cast<const float*>(rstd);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* dwp = static_cast<float*>(dw_part);
  float* dbp = static_cast<float*>(db_part);
#define APEX_LN_BWD(COLS)                                                  \
  ln_bwd_kernel<T, COLS><<<grid, kThreads, 0, stream>>>(                   \
      xp, wp, bp, mp, rp, gp, dxp, dwp, dbp, rows, hidden, rms, x_is_output)
  if (hidden <= kThreads) APEX_LN_BWD(1);
  else if (hidden <= 2 * kThreads) APEX_LN_BWD(2);
  else if (hidden <= 4 * kThreads) APEX_LN_BWD(4);
  else if (hidden <= 8 * kThreads) APEX_LN_BWD(8);
  else if (hidden <= 16 * kThreads) APEX_LN_BWD(16);
  else APEX_LN_BWD(0);
#undef APEX_LN_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx); w, b, mu, rstd are f32.
// x holds the forward output y when x_is_output is set.  dw_part and
// db_part are f32 (n_blocks, hidden), one partial row per CTA.
extern "C" int layer_norm_bwd(const void* x, const void* w, const void* b,
                              const void* mu, const void* rstd, const void* g,
                              void* dx, void* dw_part, void* db_part, int rows,
                              int hidden, int n_blocks, int rms,
                              int x_is_output, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || n_blocks <= 0 || n_blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, mu, rstd, g, dx, dw_part, db_part, rows,
                         hidden, n_blocks, rms, x_is_output, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, mu, rstd, g, dx, dw_part, db_part,
                                 rows, hidden, n_blocks, rms, x_is_output, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
