// What a launch would run, asked of the card instead of launched.
//
// Each kernel source includes this header once.  Between
// apex_query_begin(out, cap) and apex_query_end() on the calling thread,
// the source's C entry points run their own dispatch (the same instance,
// grid and shared memory a launch picks) and, at each kernel launch, write
// one record of the card's own figures instead of launching:
//
//   [0] registers per thread      (cudaFuncGetAttributes numRegs)
//   [1] static shared memory      (sharedSizeBytes)
//   [2] maximum dynamic shared memory the instance may take
//       (maxDynamicSharedSizeBytes, after the launcher's opt-in)
//   [3] dynamic shared memory the launch requests
//   [4] threads per CTA
//   [5] resident CTAs per SM      (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
//   [6] CTAs in the grid
//   [7] local memory per thread   (localSizeBytes: spills)
//
// apex_query_end() returns the number of launches the call made.  The
// entry points' own argument lists are unchanged; a query passes them
// placeholder pointers (the dispatch reads only whether a pointer is null
// and its alignment).
#pragma once

#include <cuda_runtime.h>

namespace apex_query {

constexpr int kFields = 8;

inline thread_local int* g_out = nullptr;
inline thread_local int g_cap = 0;
inline thread_local int g_n = 0;

// True (and the record written) when a query is running: the caller then
// skips the launch.
template <typename Kernel>
inline bool record(Kernel kernel, dim3 grid, dim3 block, size_t dyn) {
  if (g_out == nullptr) return false;
  if (g_n < g_cap) {
    int* r = g_out + kFields * g_n;
    cudaFuncAttributes a{};
    int ctas = 0;
    const int threads = static_cast<int>(block.x * block.y * block.z);
    cudaError_t err =
        cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                          threads, dyn);
    r[0] = err == cudaSuccess ? a.numRegs : -static_cast<int>(err);
    r[1] = static_cast<int>(a.sharedSizeBytes);
    r[2] = a.maxDynamicSharedSizeBytes;
    r[3] = static_cast<int>(dyn);
    r[4] = threads;
    r[5] = ctas;
    r[6] = static_cast<int>(grid.x * grid.y * grid.z);
    r[7] = static_cast<int>(a.localSizeBytes);
  }
  ++g_n;
  return true;
}

}  // namespace apex_query

extern "C" void apex_query_begin(int* out, int cap) {
  apex_query::g_out = out;
  apex_query::g_cap = cap;
  apex_query::g_n = 0;
}

extern "C" int apex_query_end() {
  apex_query::g_out = nullptr;
  apex_query::g_cap = 0;
  return apex_query::g_n;
}
