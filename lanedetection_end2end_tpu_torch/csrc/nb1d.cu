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
// [pixels x 3C] @ [3C x C], one launch of `conv3tap_kernel` each. A block
// of 4 warps owns 64 consecutive pixels (flattened b, h, w) and all C output
// channels; per tap it stages the shifted input rows (64 x C) and the tap's
// weight matrix (C x C) in shared memory and runs bf16 WMMA 16x16x16
// tensor-core products with f32 accumulators in registers. The epilogue
// (scale, shift, residual, relu, bf16 rounding) is applied from shared
// memory. The intermediates t1, t2 make a round trip through device memory
// (L2 at these sizes); fusing the four convolutions, TMA/wgmma tiling and a
// persistent kernel over the whole encoder are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TP = 64;        // pixels (GEMM rows) per block
constexpr int THREADS = 128;  // 4 warps x 16 rows

template <int C>
constexpr int smem_bytes() {
  // A (TP x C+8) + B (C x C+8) bf16 tiles, later aliased by the f32 C tile
  return (TP + C) * (C + 8) * 2 > TP * (C + 4) * 4 ? (TP + C) * (C + 8) * 2
                                                   : TP * (C + 4) * 4;
}

// out[p, co] = relu(sum_t sum_ci x[p + tap_t, ci] * w[t, ci, co] * mul[co]
//                   + add[co] (+ res[p, co]))
// axis 0: taps at rows h-d, h, h+d; axis 1: taps at columns w-d, w, w+d.
// mul == nullptr means a scale of 1; res == nullptr means no residual.
template <int C>
__global__ void __launch_bounds__(THREADS) conv3tap_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ mul, const float* __restrict__ add,
    const bf16* __restrict__ res, bf16* __restrict__ out, int npix, int H,
    int W, int d, int axis) {
  constexpr int LDA = C + 8;  // bf16 pitch of the A and B tiles
  constexpr int LDC = C + 4;  // f32 pitch of the accumulator tile
  constexpr int NF = C / 16;  // 16-wide fragments along ci and co
  constexpr int VPR = C / 8;  // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + TP * LDA;
  float* sC = reinterpret_cast<float*>(smem);

  const int p0 = blockIdx.x * TP;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int t = 0; t < 3; ++t) {
    const int off = (t - 1) * d;
    for (int i = threadIdx.x; i < TP * VPR; i += THREADS) {
      const int r = i / VPR, v = i % VPR;
      const int p = p0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p < npix) {
        long long q = -1;
        if (axis == 0) {
          const int hh = (p / W) % H + off;
          if (hh >= 0 && hh < H) q = (long long)p + (long long)off * W;
        } else {
          const int ww = p % W + off;
          if (ww >= 0 && ww < W) q = (long long)p + off;
        }
        if (q >= 0) val = reinterpret_cast<const uint4*>(x + q * C)[v];
      }
      *reinterpret_cast<uint4*>(sA + r * LDA + v * 8) = val;
    }
    const bf16* wt = w + (size_t)t * C * C;
    for (int i = threadIdx.x; i < C * VPR; i += THREADS) {
      const int r = i / VPR, v = i % VPR;
      *reinterpret_cast<uint4*>(sB + r * LDA + v * 8) =
          reinterpret_cast<const uint4*>(wt + (size_t)r * C)[v];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sA + warp * 16 * LDA + k * 16, LDA);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + k * 16 * LDA + n * 16, LDA);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    __syncthreads();  // tiles are overwritten by the next tap / by sC
  }

#pragma unroll
  for (int n = 0; n < NF; ++n)
    wmma::store_matrix_sync(sC + warp * 16 * LDC + n * 16, acc[n], LDC,
                            wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < TP * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int p = p0 + r;
    if (p >= npix) continue;
    float y = sC[r * LDC + c] * (mul ? mul[c] : 1.0f) + add[c];
    if (res) y += bf2f(res[(size_t)p * C + c]);
    out[(size_t)p * C + c] = f2bf(fmaxf(y, 0.0f));
  }
}

template <int C>
int launch_conv(const bf16* x, const bf16* w, const float* mul,
                const float* add, const bf16* res, bf16* out, int npix, int H,
                int W, int d, int axis, cudaStream_t stream) {
  constexpr int smem = smem_bytes<C>();
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
