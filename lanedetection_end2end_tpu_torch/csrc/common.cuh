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

// Element i of a bf16 or f32 array as a float; store v in the array's type
// and return the value as stored.
__device__ __forceinline__ float ldf(const bf16* p, long long i) {
  return bf2f(p[i]);
}
__device__ __forceinline__ float ldf(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float stf(bf16* p, long long i, float v) {
  const bf16 o = f2bf(v);
  p[i] = o;
  return bf2f(o);
}
__device__ __forceinline__ float stf(float* p, long long i, float v) {
  p[i] = v;
  return v;
}

// Loads of activation planes. kCoherent reads through L2 only
// (ld.global.cg): a persistent kernel (nb1d_chain.cu, encoder_fused.cu,
// decoder_fused.cu) rewrites its planes within one launch, so no SM may
// keep a stale line of them in its L1, nor read them through the read-only
// path.
template <bool kCoherent>
__device__ __forceinline__ float load_bf(const bf16* p) {
  if (kCoherent)
    return bf2f(__ushort_as_bfloat16(
        __ldcg(reinterpret_cast<const unsigned short*>(p))));
  return bf2f(*p);
}

// A value of a bf16 or f32 plane as a float, as `load_bf` reads it.
template <bool kCoherent>
__device__ __forceinline__ float load_f(const bf16* p) {
  return load_bf<kCoherent>(p);
}
template <bool kCoherent>
__device__ __forceinline__ float load_f(const float* p) {
  return kCoherent ? __ldcg(p) : *p;
}

// The inference BatchNorm folded to a scale and a shift, then relu.
__device__ __forceinline__ float bn_relu(float a, float mul, float add) {
  return fmaxf(fmaf(a, mul, add), 0.0f);
}

// Two neighbouring bf16 values of a plane as floats, read through L2 only
// (the address must be 4-byte aligned).
__device__ __forceinline__ float2 load_bf2_cg(const bf16* p) {
  const unsigned int u = __ldcg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void store_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

// The stage table of a persistent kernel, passed to it by value: stage s's
// weights at offset w[s] of the bf16 weight buffer, its vectors at v[s] of
// the f32 vector buffer, its dilation d[s]. Read from 3 * N host ints laid
// out as (w offsets, v offsets, dilations).
template <int N>
struct StageTable {
  int w[N];
  int v[N];
  int d[N];
};

// The table in shared memory, copied by thread 0 with constant indices (a
// kernel parameter indexed at run time would be copied to local memory):
// st[s], st[N + s], st[2N + s] = w[s], v[s], d[s]. The caller syncs.
template <int N>
__device__ __forceinline__ void stage_table_to_shared(const StageTable<N>& t,
                                                      int* st) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    st[s] = t.w[s];
    st[N + s] = t.v[s];
    st[2 * N + s] = t.d[s];
  }
}

template <int N>
static inline StageTable<N> read_table(const void* table) {
  StageTable<N> tab;
  const int* t = static_cast<const int*>(table);
  for (int s = 0; s < N; ++s) {
    tab.w[s] = t[s];
    tab.v[s] = t[N + s];
    tab.d[s] = t[2 * N + s];
  }
  return tab;
}

// The grid of a cooperative launch of `kern` with `threads`-thread blocks
// and `smem` bytes of dynamic shared memory: as many blocks as can be
// resident at once (the occupancy at `smem` times the SM count), at most
// `units`. Sets *grid and *per_sm (blocks resident on one SM); returns the
// error of any query (the card lacking cooperative launches included).
template <typename Kernel>
static inline int cooperative_grid(Kernel kern, int threads, int smem,
                                   long long units, int* grid, int* per_sm) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long most = (long long)*per_sm * sms;
  *grid = (int)(units < 1 ? 1 : units < most ? units : most);
  return 0;
}

// Launch `kern` as one cooperative grid (cooperative_grid) on `stream`.
// Returns the launch's error: a card that refuses the launch is an error,
// never a smaller grid or another path.
template <typename Kernel>
static inline int launch_cooperative(Kernel kern, int threads, int smem,
                                     long long units, void** args,
                                     cudaStream_t stream) {
  int grid = 0, per_sm = 0;
  const int rc = cooperative_grid(kern, threads, smem, units, &grid, &per_sm);
  if (rc) return rc;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(grid), dim3(threads), args,
      smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What a persistent kernel's launch gets from the card, for a report:
// info[0..7] = registers a thread, local (spilled) bytes a thread, blocks
// resident on one SM, warps resident on one SM, grid blocks, dynamic
// shared memory bytes a block, threads a block, SMs.
template <typename Kernel>
static inline int cooperative_info(Kernel kern, int threads, int smem,
                                   long long units, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  int grid = 0, per_sm = 0, dev = 0, sms = 0;
  const int rc = cooperative_grid(kern, threads, smem, units, &grid, &per_sm);
  if (rc) return rc;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = per_sm;
  info[3] = per_sm * threads / 32;
  info[4] = grid;
  info[5] = smem;
  info[6] = threads;
  info[7] = sms;
  return 0;
}
