// Shared helpers of the port's kernels. Every kernel source is compiled on
// its own with nvcc into a shared library with a plain C interface and
// loaded through ctypes (ops/_build.py). Entry points launch on the stream
// they are given, allocate nothing, and return cudaGetLastError() right
// after their launches (0 = success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LD_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

static inline int grid_1d(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Threads of a warp whose lane is equal modulo `group` hold partial sums of
// the same channels (group a power of two <= 32, or the call is a no-op):
// fold them onto lanes 0 .. group-1 with shuffles. Returns true for the
// lanes that now hold a sum to pass on.
template <int N>
__device__ __forceinline__ bool fold_lanes(float (&v)[N], int group) {
  if (group > 32 || (group & (group - 1)) != 0) return true;
  for (int off = 16; off >= group; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
  return (threadIdx.x & 31) < group;
}
