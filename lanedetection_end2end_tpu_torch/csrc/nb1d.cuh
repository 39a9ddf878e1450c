// K1's per-tile body: one 64-pixel tile of one 3-tap convolution of an
// ERFNet NonBottleneck1D block (inference, BatchNorm folded), shared by the
// single-block kernel (`nb1d.cu`, one launch per convolution) and, through
// `block_passes`, by the persistent kernels (`nb1d_chain.cu`,
// `encoder_fused.cu`, `decoder_fused.cu`, one cooperative launch each).
// All run this same code on the same inputs, so their outputs are bit for
// bit those of K1 launched block by block.
//
//   out[p, co] = relu(sum_t sum_ci x[p + tap_t, ci] * w[t, ci, co] * mul[co]
//                     + add[co] (+ res[p, co]))
//
// axis 0: taps at rows h-d, h, h+d; axis 1: taps at columns w-d, w, w+d;
// taps off the plane (d >= H or d >= W included) read zero. mul == nullptr
// means a scale of 1; res == nullptr means no residual. A block of 4 warps
// owns 64 consecutive pixels (flattened b, h, w) and all C output channels;
// per tap it stages the shifted input rows (64 x C) and the tap's weight
// matrix (C x C) in shared memory and runs bf16 WMMA 16x16x16 products with
// f32 accumulators in registers; the epilogue (scale, shift, residual, relu,
// bf16 rounding) reads the accumulators back from shared memory.
#pragma once

#include <cooperative_groups.h>
#include <mma.h>

#include "common.cuh"

namespace nb1d {

constexpr int TP = 64;        // pixels (GEMM rows) per tile
constexpr int THREADS = 128;  // 4 warps x 16 rows

template <int C>
constexpr int smem_bytes() {
  // A (TP x C+8) + B (C x C+8) bf16 tiles, later aliased by the f32 C tile
  return (TP + C) * (C + 8) * 2 > TP * (C + 4) * 4 ? (TP + C) * (C + 8) * 2
                                                   : TP * (C + 4) * 4;
}

// One tile, pixels [p0, p0 + TP). Starts by writing shared memory and ends
// after reading it: a caller that runs a second tile in the same block puts
// a __syncthreads() between the two.
template <int C, bool kCoherent>
__device__ __forceinline__ void conv3tap_tile(
    int p0, const bf16* x, const bf16* w, const float* mul, const float* add,
    const bf16* res, bf16* out, int npix, int H, int W, int d, int axis,
    unsigned char* smem) {
  using namespace nvcuda;
  constexpr int LDA = C + 8;  // bf16 pitch of the A and B tiles
  constexpr int LDC = C + 4;  // f32 pitch of the accumulator tile
  constexpr int NF = C / 16;  // 16-wide fragments along ci and co
  constexpr int VPR = C / 8;  // 16-byte vectors per row
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + TP * LDA;
  float* sC = reinterpret_cast<float*>(smem);

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
        if (q >= 0) val = load_vec<kCoherent>(x + q * C + v * 8);
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
    if (res) y += load_bf<kCoherent>(res + (size_t)p * C + c);
    out[(size_t)p * C + c] = f2bf(fmaxf(y, 0.0f));
  }
}

// One whole block inside a persistent cooperative grid: cur -> dst
// through the scratch planes t1 and t2 in four grid-stride passes of the
// grid's blocks over the tiles (K1's four convolutions), with a grid.sync()
// between passes: a tap reads rows up to d away, which other blocks write.
// The caller syncs after the fourth pass. w: (4, 3, C, C) [conv][tap][ci]
// [co]; v: (6, C) = b1 m1 a1 b3 m2 a2; cur is only read.
template <int C>
__device__ __forceinline__ void block_passes(
    cooperative_groups::grid_group& grid, const bf16* cur, const bf16* w,
    const float* v, int d, bf16* t1, bf16* t2, bf16* dst, int npix, int H,
    int W, unsigned char* smem) {
  const int ntiles = (npix + TP - 1) / TP;
  const size_t wc = (size_t)3 * C * C;
  for (int pass = 0; pass < 4; ++pass) {
    const bf16* in = pass == 0 ? cur : pass == 2 ? t2 : t1;
    bf16* o = pass == 1 ? t2 : pass == 3 ? dst : t1;
    const float* mul = pass == 1 ? v + C : pass == 3 ? v + 4 * C : nullptr;
    const float* add = v + (pass == 0   ? 0
                            : pass == 1 ? 2 * C
                            : pass == 2 ? 3 * C
                                        : 5 * C);
    const bf16* res = pass == 3 ? cur : nullptr;
    const int dd = pass < 2 ? 1 : d;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      conv3tap_tile<C, true>(tile * TP, in, w + pass * wc, mul, add, res, o,
                             npix, H, W, dd, pass % 2, smem);
      __syncthreads();  // the next tile overwrites shared memory
    }
    if (pass < 3) grid.sync();
  }
}

}  // namespace nb1d
