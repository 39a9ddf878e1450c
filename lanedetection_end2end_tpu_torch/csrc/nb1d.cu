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
// Design: the block is two launches of the row tile of `nb1d.cuh` (pass A:
// the two d = 1 convolutions, x -> mid; pass B: the two dilated ones and
// the residual, mid -> out), one tile (R whole rows, or a segment of a
// wide row) per block; t1 stays
// in the tile's shared memory, t2 = mid makes one round trip through
// device memory. The persistent kernels run the same passes with a
// grid-wide barrier in place of the second launch.

#include "nb1d.cuh"

namespace {

using nb1d::THREADS;

template <int C, bool kSeg>
__global__ void __launch_bounds__(THREADS, 2)
    nb1d_pass_kernel(const nb1d::Pass ps) {
  extern __shared__ __align__(128) unsigned char smem[];
  nb1d::pass_tiles<C, kSeg>(ps, false, smem, blockIdx.x, gridDim.x);
}

template <int C, bool kSeg>
int launch_pass_as(const nb1d::Pass& ps, cudaStream_t stream) {
  const int smem = nb1d::smem_bytes<C>(ps.W, ps.d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nb1d_pass_kernel<C, kSeg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  nb1d_pass_kernel<C, kSeg><<<nb1d::tile_count<C>(ps.rows, ps.W), THREADS,
                              smem, stream>>>(ps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_pass(const nb1d::Pass& ps, cudaStream_t stream) {
  return nb1d::seg_rows<C>(ps.W) ? launch_pass_as<C, true>(ps, stream)
                                 : launch_pass_as<C, false>(ps, stream);
}

template <int C>
int launch_block(const bf16* x, const bf16* w, const float* vec, bf16* mid,
                 bf16* out, int B, int H, int W, int d, cudaStream_t s) {
  // w: (4, 3, C, C) [conv][tap][ci][co]; vec: (6, C) = b1 m1 a1 b3 m2 a2
  const int rows = B * H;
  const int rc =
      launch_pass<C>(nb1d::pass_a<C>(x, w, vec, mid, rows, H, W), s);
  if (rc) return rc;
  return launch_pass<C>(nb1d::pass_b<C>(x, mid, w, vec, d, out, rows, H, W),
                        s);
}

}  // namespace

// x, out, mid: (B, H, W, C) bf16 contiguous; mid is scratch.
LD_API int ld_nb1d(const void* x, const void* w, const void* vec, void* mid,
                   void* out, int B, int H, int W, int C, int d,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto Wt = static_cast<const bf16*>(w);
  auto V = static_cast<const float*>(vec);
  auto M = static_cast<bf16*>(mid);
  auto O = static_cast<bf16*>(out);
  switch (C) {
    case 16:
      return launch_block<16>(X, Wt, V, M, O, B, H, W, d, s);
    case 64:
      return launch_block<64>(X, Wt, V, M, O, B, H, W, d, s);
    case 128:
      return launch_block<128>(X, Wt, V, M, O, B, H, W, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
