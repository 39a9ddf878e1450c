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

// Eight consecutive values of a bf16 or f32 plane as floats (one 16-byte
// load for bf16, two for f32; the address must be 16-byte aligned).
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = bf2f(e[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 a;
  bf16* e = reinterpret_cast<bf16*>(&a);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = f2bf(f[j]);
  *reinterpret_cast<uint4*>(p) = a;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The pixel a 3-tap convolution reads for output pixel p (of npix, in
// (B, H, W) row-major order) at offset `off` rows (axis 0) or columns
// (axis 1), or -1 where that falls off the plane (any |off|, also >= H, W).
__device__ __forceinline__ long long tap_pixel(int p, int npix, int H, int W,
                                               int off, int axis) {
  if (p >= npix) return -1;
  if (axis == 0) {
    const int hh = (p / W) % H + off;
    return (hh >= 0 && hh < H) ? (long long)p + (long long)off * W : -1;
  }
  const int ww = p % W + off;
  return (ww >= 0 && ww < W) ? (long long)p + off : -1;
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
