// K1 nb1d: one ERFNet NonBottleneck1D block (inference, BatchNorm folded).
//
// Replaces the TPU body `_nb1d_body` (lanedetection_end2end_tpu/ops/
// pallas_nb1d.py:191), which runs the block on a lane-packed (H, W*C) plane
// with block-diagonal / banded / Winograd tap matrices. Those forms exist
// to fill the TPU's 128-lane registers and are not ported: here the block
// is four direct 3-tap convolutions on an NHWC bf16 tensor,
//
//   t1  = relu(conv3x1(x)        + b1)               -> bf16
//   t2  = relu(conv1x3(t1)  * m1 + a1)               -> bf16
//   t1  = relu(conv3x1_d(t2)     + b3)               -> bf16
//   out = relu(conv1x3_d(t1) * m2 + a2 + x)          -> bf16
//
// with bf16 operands, f32 accumulation and the same bf16 rounding points as
// the TPU kernel (pallas_nb1d.py:305-314). Taps that fall off the plane
// (including d >= H or d >= W, where a tap misses the plane entirely) read
// zero.
//
// Bound on the card: at C = 64 and 128 the block does 24*C^2 FLOP per pixel
// against 4 bytes of bf16 in/out per channel, about 6*C FLOP per byte, so
// it sits at or above the H100's ~295 FLOP/byte ridge: the tensor cores
// bound it, not HBM. C = 16 (decoder, 128x256) is memory-bound.
//
// Design: each of the four convolutions is an implicit GEMM
// [pixels x 3C] @ [3C x C], one launch of `conv3tap_kernel` each, one
// 64-pixel tile per block (the tile body is `nb1d.cuh`, which the chain
// kernel `nb1d_chain.cu` shares). The intermediates t1, t2 make a round trip
// through device memory (L2 at these sizes); fusing the four convolutions,
// TMA/wgmma tiling and a persistent kernel over the whole encoder are later
// work.

#include "nb1d.cuh"

namespace {

using nb1d::THREADS;
using nb1d::TP;

template <int C>
__global__ void __launch_bounds__(THREADS) conv3tap_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ mul, const float* __restrict__ add,
    const bf16* __restrict__ res, bf16* __restrict__ out, int npix, int H,
    int W, int d, int axis) {
  extern __shared__ __align__(128) unsigned char smem[];
  nb1d::conv3tap_tile<C, false>(blockIdx.x * TP, x, w, mul, add, res, out,
                                npix, H, W, d, axis, smem);
}

template <int C>
int launch_conv(const bf16* x, const bf16* w, const float* mul,
                const float* add, const bf16* res, bf16* out, int npix, int H,
                int W, int d, int axis, cudaStream_t stream) {
  constexpr int smem = nb1d::smem_bytes<C>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3tap_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  conv3tap_kernel<C><<<grid_1d(npix, TP), THREADS, smem, stream>>>(
      x, w, mul, add, res, out, npix, H, W, d, axis);
  return (int)cudaGetLastError();
}

template <int C>
int launch_block(const bf16* x, const bf16* w, const float* vec, bf16* t1,
                 bf16* t2, bf16* out, int npix, int H, int W, int d,
                 cudaStream_t s) {
  // w: (4, 3, C, C) [conv][tap][ci][co]; vec: (6, C) = b1 m1 a1 b3 m2 a2
  const size_t wc = (size_t)3 * C * C;
  int rc;
  rc = launch_conv<C>(x, w, nullptr, vec, nullptr, t1, npix, H, W, 1, 0, s);
  if (rc) return rc;
  rc = launch_conv<C>(t1, w + wc, vec + C, vec + 2 * C, nullptr, t2, npix, H,
                      W, 1, 1, s);
  if (rc) return rc;
  rc = launch_conv<C>(t2, w + 2 * wc, nullptr, vec + 3 * C, nullptr, t1, npix,
                      H, W, d, 0, s);
  if (rc) return rc;
  return launch_conv<C>(t1, w + 3 * wc, vec + 4 * C, vec + 5 * C, x, out,
                        npix, H, W, d, 1, s);
}

}  // namespace

// x, out, t1, t2: (B, H, W, C) bf16 contiguous; t1/t2 are scratch.
LD_API int ld_nb1d(const void* x, const void* w, const void* vec, void* t1,
                   void* t2, void* out, int B, int H, int W, int C, int d,
                   void* stream) {
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto Wt = static_cast<const bf16*>(w);
  auto V = static_cast<const float*>(vec);
  auto T1 = static_cast<bf16*>(t1);
  auto T2 = static_cast<bf16*>(t2);
  auto O = static_cast<bf16*>(out);
  switch (C) {
    case 16:
      return launch_block<16>(X, Wt, V, T1, T2, O, npix, H, W, d, s);
    case 64:
      return launch_block<64>(X, Wt, V, T1, T2, O, npix, H, W, d, s);
    case 128:
      return launch_block<128>(X, Wt, V, T1, T2, O, npix, H, W, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
