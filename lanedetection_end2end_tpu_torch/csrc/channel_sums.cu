// channel_sums: per-channel sum and sum of squares of an NHWC bf16 or f32
// plane, the train-mode BatchNorm moments of the stride-2 blocks and, on
// the unfused training path, of every NonBottleneck1D block.
//
// Replaces the TPU body `_moments_kernel` (lanedetection_end2end_tpu/ops/
// pallas_packed_conv.py:290), which reduces a lane-packed (H, W*C) plane
// per image and folds the 128 lanes onto C channels with a `sel` matrix,
// carrying the sum across its sequential grid. Here
//
//   out[0, c] = sum_p x[p, c],  out[1, c] = sum_p x[p, c]^2   (f32)
//
// over the npix = B*H*W pixels of a (npix, C) bf16 or f32 tensor, C a
// power of two from 8 to 128.
//
// Bound on the card: one read of the plane, 3 FLOP per value: bytes.
//
// Design: a fixed-order reduction in two launches, no atomics and no zero
// fill, so the sums reproduce themselves bit for bit. A thread keeps one
// 16-byte vector of each pixel it reads (8 bf16 or 4 f32 channels, the
// same ones throughout), neighbouring threads on neighbouring addresses.
// Block b owns the LOADS * THREADS / (vectors a pixel) consecutive pixels
// from b times that (a partition fixed by the shape alone): each thread
// issues its LOADS = 8 16-byte loads at once, then sums them in order in
// f32 registers (the square by one fused multiply-add); the lanes of a
// warp that hold the same channels fold by xor shuffles (a pairwise tree);
// the warps' sums add up in warp order through shared memory, and the
// block writes its 2C sums to its column of `part`. The second launch adds
// the columns in a fixed order, one warp an entry: lane l takes columns l,
// l + 32, ..., then the lanes fold by halves. The sum of a channel is then
// a short sequential run at each level of a tree: over the 262,144 pixels
// of the 16-channel plane, 8 values a thread, a fold of 4 levels (bf16) or
// 3 (f32), 8 warps, 8 or 16 columns a lane and a fold of 5 levels.
// A second launch, not the last block to finish: that would need a counter
// in device memory that persists between calls and an atomic on it; the
// second launch keeps the kernels free of state and of atomics. It is a
// programmatic dependent launch (Hopper): the first kernel lets it start
// once its loads are issued, and it waits in `griddepcontrol.wait` until
// the first grid has finished and its partials are visible, so its launch
// overlaps the first kernel instead of following it.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOADS = 8;  // 16-byte loads in flight a thread
constexpr int MAX_C = 128;

// The 16-byte vector at p as floats: 8 bf16 or 4 f32 values
__device__ __forceinline__ void load16(const bf16* p, float (&f)[8]) {
  load8(p, f);
}
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}

// x: (npix, C) of type T, C a power of two; part: (2C, gridDim.x) f32,
// this block's column of [sums | sums of squares]
template <typename T>
__global__ void __launch_bounds__(THREADS) channel_sums_kernel(
    const T* __restrict__ x, float* __restrict__ part, int npix, int C) {
  constexpr int VE = 16 / sizeof(T);  // values a vector
  __shared__ float red[THREADS / 32][2 * MAX_C];
  const int vpr = C / VE;             // vectors a pixel, a power of two
  const int rpi = THREADS / vpr;      // pixels a round of one load each
  const int v = threadIdx.x % vpr, r = threadIdx.x / vpr;
  const long long p0 = (long long)blockIdx.x * rpi * LOADS + r;
  float f[LOADS][VE];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const long long p = p0 + (long long)u * rpi;
    if (p < npix) {
      load16(x + p * C + v * VE, f[u]);
    } else {
#pragma unroll
      for (int j = 0; j < VE; ++j) f[u][j] = 0.0f;
    }
  }
  // the fold kernel may start now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  float s1[VE], s2[VE];
#pragma unroll
  for (int j = 0; j < VE; ++j) s1[j] = s2[j] = 0.0f;
#pragma unroll
  for (int u = 0; u < LOADS; ++u)
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      s1[j] += f[u][j];
      s2[j] = fmaf(f[u][j], f[u][j], s2[j]);
    }
  // every lane takes part in the shuffles; lanes 0 .. vpr-1 keep the sums
  // of vectors 0 .. vpr-1
  const bool keep = fold_lanes(s1, vpr) & fold_lanes(s2, vpr);
  const int warp = threadIdx.x / 32;
  if (keep) {
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      red[warp][v * VE + j] = s1[j];
      red[warp][C + v * VE + j] = s2[j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) a += red[w][e];
    part[(size_t)e * gridDim.x + blockIdx.x] = a;
  }
}

// out[e] = the sum of row e of part (2C, nblk), in a fixed order: one warp
// an entry, lane l adds columns l, l + 32, ..., then the lanes fold.
// Launched as a dependent of channel_sums_kernel: it first waits for that
// grid to finish.
__global__ void __launch_bounds__(THREADS) channel_sums_fold_kernel(
    const float* __restrict__ part, float* __restrict__ out, int nblk,
    int entries) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int e = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= entries) return;  // the whole warp
  const float* row = part + (size_t)e * nblk;
  float a = 0.0f;
  for (int k = lane; k < nblk; k += 32) a += row[k];
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  if (lane == 0) out[e] = a;
}

template <typename T>
int launch(const void* x, float* part, float* out, int npix, int C,
           cudaStream_t s) {
  const int rpi = THREADS / (C * (int)sizeof(T) / 16);
  const int nblk = grid_1d(npix, rpi * LOADS);
  channel_sums_kernel<T><<<nblk, THREADS, 0, s>>>(static_cast<const T*>(x),
                                                   part, npix, C);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_1d(2 * C, THREADS / 32));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, channel_sums_fold_kernel,
                                 static_cast<const float*>(part), out, nblk,
                                 2 * C);
}

}  // namespace

// x: (npix, C) contiguous, bf16 (f32 == 0) or f32 (f32 == 1), C a power
// of two from 8 to 128; part: (2C, nblk) f32 scratch, nblk = ceil(npix /
// (8 * 256 / (C * bytes a value / 16))) (any contents); out: (2, C) f32,
// written whole (any contents on entry).
LD_API int ld_channel_sums(const void* x, void* part, void* out, int npix,
                           int C, int f32, void* stream) {
  if ((C & (C - 1)) != 0 || C < 8 || C > MAX_C || npix < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  return f32 ? launch<float>(x, pt, o, npix, C, s)
             : launch<bf16>(x, pt, o, npix, C, s);
}
