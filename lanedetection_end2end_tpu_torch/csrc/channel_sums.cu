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
// multiple of 8 up to 128.
//
// Bound on the card: one read of the plane, 3 FLOP per value: bytes.
//
// Design: one pass. A thread keeps the same 8 channels for its whole
// grid-stride walk over the pixels (one 16-byte load per pixel, two for
// f32, neighbouring threads on neighbouring addresses), sums them in f32
// registers; a warp folds the
// lanes that hold the same channels with shuffles, the block folds its
// warps through shared-memory atomics and adds one value per channel and
// moment to `out` with atomicAdd. `out` must be zero before
// the call; the order of the adds, and with it the last bits, changes
// from run to run.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS) channel_sums_kernel(
    const T* __restrict__ x, float* __restrict__ out, int npix, int C) {
  __shared__ float ssum[2 * MAX_C];
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) ssum[i] = 0.0f;
  __syncthreads();
  const int vpr = C / 8;           // 16-byte vectors per pixel
  const int rpi = THREADS / vpr;   // pixels per block iteration
  const int v = threadIdx.x % vpr, rl = threadIdx.x / vpr;
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0f;
  if (rl < rpi) {
    for (long long p = (long long)blockIdx.x * rpi + rl; p < npix;
         p += (long long)gridDim.x * rpi) {
      float f[8];
      load8(x + p * C + v * 8, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += f[j];
        s2[j] += f[j] * f[j];
      }
    }
  }
  // every lane takes part in the shuffles; idle threads carry zeros
  const bool pass = fold_lanes(s1, vpr) & fold_lanes(s2, vpr);
  if (pass && rl < rpi) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicAdd(&ssum[v * 8 + j], s1[j]);
      atomicAdd(&ssum[C + v * 8 + j], s2[j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += THREADS)
    atomicAdd(out + i, ssum[i]);
}

}  // namespace

// x: (npix, C) contiguous, bf16 (f32 == 0) or f32 (f32 == 1); out: (2, C)
// f32, zero on entry.
LD_API int ld_channel_sums(const void* x, void* out, int npix, int C,
                           int f32, void* stream) {
  if (C % 8 != 0 || C < 8 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const int rpi = THREADS / (C / 8);
  const int blocks = min(grid_1d(npix, rpi), 132 * 2);
  auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (f32)
    channel_sums_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(x), o, npix, C);
  else
    channel_sums_kernel<bf16><<<blocks, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), o, npix, C);
  return (int)cudaGetLastError();
}
