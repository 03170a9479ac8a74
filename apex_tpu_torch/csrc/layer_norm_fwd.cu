// K1: fused LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/layer_norm.py :: layer_norm_fwd
//           (Pallas body _ln_fwd_kernel) — per-row f32 statistics, y in
//           the input dtype, mu and rstd saved in f32.
// Bound on the H100: device-memory bytes.  Each element is read once and
//           written once (2 + 2 bytes in bf16) against ~8 flops, far below
//           the 295 flop/byte balance point, so the least time is
//           (bytes of x + bytes of y) / 3.35 TB/s.
// Design:   one 256-thread block per row, strided so neighbouring threads
//           read neighbouring elements (coalesced).  The two-pass mean and
//           variance (the same arithmetic as _jnp_fwd) re-read the row,
//           which a row of a few KB serves from L1, so device memory still
//           sees the row about once.  Rows run in parallel blocks — the
//           TPU grid's sequential row blocks have no counterpart here.
//           bf16 and f32 I/O go through one template; weights are f32.

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

// Sum over the block; every thread gets the total.  `red` holds one
// float per warp and is free again when this returns.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              int hidden, float eps, int rms) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  const float inv_n = 1.f / static_cast<float>(hidden);

  float mean = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int i = threadIdx.x; i < hidden; i += kThreads) s += to_f(xr[i]);
    mean = block_sum(s, red) * inv_n;
  }
  float s2 = 0.f;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    const float d = to_f(xr[i]) - mean;
    s2 += d * d;
  }
  const float var = block_sum(s2, red) * inv_n;
  const float rstd = 1.f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    const float xhat = (to_f(xr[i]) - mean) * rstd;
    yr[i] = from_f<T>(xhat * w[i] + b[i]);
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

}  // namespace

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x and y); w, b, mu, rstd are float32.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mu, void* rstd, int rows,
                              int hidden, float eps, int rms, int dtype,
                              void* stream) {
  if (rows <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows);
  if (dtype == 0) {
    ln_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), hidden, eps, rms);
  } else if (dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), hidden, eps, rms);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
