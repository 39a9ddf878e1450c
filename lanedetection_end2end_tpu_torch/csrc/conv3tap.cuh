// The 3-tap implicit-GEMM convolution shared by the training kernels in
// bf16: the half blocks (nb_half_fwd.cu, nb_half_bwd.cu) and the single
// convolutions of packed_conv.cu.
//
// It is `conv3tap_kernel` of nb1d.cu (64 pixels x all C output channels per
// block of 4 warps, bf16 WMMA 16x16x16 with f32 accumulators, one tap's
// shifted rows and tap matrix staged in shared memory at a time) with two
// additions the training path needs:
//
//  - a prologue applied while the input rows are staged:
//    z = bf16(relu(x * mul + add)), the BatchNorm-1 normalize that the TPU
//    kernel fuses ahead of half B (pallas_nb_block.py:326-328). Rows off
//    the plane stay zero: the padding is of z, not of x;
//  - a choice of epilogue, which also reduces per-channel f32 sums over
//    the block's 64 pixels and adds them to a global buffer with atomicAdd
//    (blocks run in no order, so nothing can be carried between them as
//    the TPU grid carries its accumulators), and of the output type: bf16,
//    or f32 (the unrounded sums of packed_conv's forward).
//
// A transposed convolution (the input gradient) is this same kernel with
// the tap matrices transposed and their order reversed, which the wrapper
// prepares: dx[q] = sum_t dy[q - (t-1)d] k[t]^T = sum_t' dy[q + (t'-1)d]
// k[2-t']^T.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ldconv {

using namespace nvcuda;

constexpr int TP = 64;        // pixels (GEMM rows) per block
constexpr int THREADS = 128;  // 4 warps x 16 rows

enum Epilogue {
  EPI_BIAS_RELU,  // out = bf16(relu(acc + vec[c]))
  EPI_BIAS,       // out = bf16(acc + vec[c])
  EPI_BIAS_MOM,   // out = bf16(acc + vec[c]); sums += [out, out^2]
  EPI_PLAIN,      // out = bf16(acc)
  EPI_MASK_SUM,   // v = acc * (aux > 0); sums[0] += v; out = bf16(v)
  EPI_PRO_BWD,    // backward of the prologue, aux = x, vec = [mul; add]:
                  // v = acc * (x*mul+add > 0); sums += [v*x, v];
                  // out = bf16(v * mul)
};

template <int C>
__host__ __device__ constexpr int conv_smem_bytes() {
  // A (TP x C+8) + B (C x C+8) bf16 tiles, later aliased by the f32 C
  // tile, then 2*THREADS floats for the channel sums
  return ((TP + C) * (C + 8) * 2 > TP * (C + 4) * 4 ? (TP + C) * (C + 8) * 2
                                                    : TP * (C + 4) * 4) +
         2 * THREADS * 4;
}

// x * mul + add with the product rounded before the sum, never contracted
// into one fused multiply-add: the forward prologue, its recomputation in
// the weight gradient and the relu mask of its backward must agree bit for
// bit with each other (and with the plain version), or an activation at
// the edge of the relu is kept in one place and dropped in another.
__device__ __forceinline__ float bn_affine(float x, float mul, float add) {
  return __fadd_rn(__fmul_rn(x, mul), add);
}

// sA[r] = in[p0 + r + tap offset] for r < ROWS (pitch C+8), zero where the
// tap falls off the plane or p0 + r >= npix. axis 0: the offset counts rows
// of the image, axis 1: columns. With mul != nullptr the prologue
// bf16(relu(x * mul + add)) is applied to what was read.
template <int C, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(bf16* sA, const bf16* in,
                                           const float* mul,
                                           const float* add, int p0,
                                           int npix, int H, int W, int off,
                                           int axis) {
  constexpr int LDA = C + 8;
  constexpr int VPR = C / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    const int r = i / VPR, v = i % VPR;
    const long long q = tap_pixel(p0 + r, npix, H, W, off, axis);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q >= 0) {
      val = reinterpret_cast<const uint4*>(in + q * C)[v];
      if (mul != nullptr) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = v * 8 + j;
          e[j] = f2bf(fmaxf(bn_affine(bf2f(e[j]), mul[c], add[c]), 0.0f));
        }
      }
    }
    *reinterpret_cast<uint4*>(sA + r * LDA + v * 8) = val;
  }
}

__device__ __forceinline__ void store_out(bf16* o, float v) { *o = f2bf(v); }
__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }

// out[p, co] = epilogue(sum_t sum_ci f(in[p + tap_t])[ci] * w[t, ci, co])
// with taps at -d, 0, +d along rows (axis 0) or columns (axis 1); f is the
// prologue when pmul != nullptr; out is bf16 (rounded where the comments
// above say bf16) or f32 (TO = float: not rounded). `sums` is (2, C) f32
// (one row used by EPI_MASK_SUM) and must be zero before the launch.
template <int C, int EPI, typename TO>
__global__ void __launch_bounds__(THREADS) conv3tap_kernel(
    const bf16* __restrict__ in, const bf16* __restrict__ w,
    const float* __restrict__ pmul, const float* __restrict__ padd,
    const float* __restrict__ vec, const bf16* __restrict__ aux,
    TO* __restrict__ out, float* __restrict__ sums, int npix, int H, int W,
    int d, int axis) {
  static_assert(THREADS % C == 0, "a thread owns one channel");
  constexpr int LDA = C + 8;  // bf16 pitch of the A and B tiles
  constexpr int LDC = C + 4;  // f32 pitch of the accumulator tile
  constexpr int NF = C / 16;  // 16-wide fragments along ci and co
  constexpr int VPR = C / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + TP * LDA;
  float* sC = reinterpret_cast<float*>(smem);
  float* sRed = reinterpret_cast<float*>(smem + conv_smem_bytes<C>() -
                                         2 * THREADS * 4);

  const int p0 = blockIdx.x * TP;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int t = 0; t < 3; ++t) {
    stage_rows<C, TP, THREADS>(sA, in, pmul, padd, p0, npix, H, W,
                               (t - 1) * d, axis);
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

  // THREADS % C == 0: every element this thread visits has channel c
  const int c = threadIdx.x % C;
  float s0 = 0.0f, s1 = 0.0f;
  for (int i = threadIdx.x; i < TP * C; i += THREADS) {
    const int r = i / C;
    const int p = p0 + r;
    if (p >= npix) continue;
    const float a = sC[r * LDC + c];
    const size_t idx = (size_t)p * C + c;
    if (EPI == EPI_BIAS_RELU) {
      store_out(out + idx, fmaxf(a + vec[c], 0.0f));
    } else if (EPI == EPI_BIAS) {
      store_out(out + idx, a + vec[c]);
    } else if (EPI == EPI_BIAS_MOM) {
      const float f = bf2f(f2bf(a + vec[c]));  // moments of the rounded value
      store_out(out + idx, f);
      s0 += f;
      s1 += f * f;
    } else if (EPI == EPI_PLAIN) {
      store_out(out + idx, a);
    } else if (EPI == EPI_MASK_SUM) {
      const float v = bf2f(aux[idx]) > 0.0f ? a : 0.0f;
      s0 += v;  // bias gradient from the f32 value, before rounding
      store_out(out + idx, v);
    } else {
      const float x = bf2f(aux[idx]);
      const float v = bn_affine(x, vec[c], vec[C + c]) > 0.0f ? a : 0.0f;
      s0 += v * x;
      s1 += v;
      store_out(out + idx, v * vec[c]);
    }
  }
  if (EPI == EPI_BIAS_MOM || EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD) {
    sRed[threadIdx.x] = s0;
    sRed[THREADS + threadIdx.x] = s1;
    __syncthreads();
    if (threadIdx.x < C) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int k = threadIdx.x; k < THREADS; k += C) {
        a0 += sRed[k];
        a1 += sRed[THREADS + k];
      }
      atomicAdd(sums + threadIdx.x, a0);
      if (EPI != EPI_MASK_SUM) atomicAdd(sums + C + threadIdx.x, a1);
    }
  }
}

template <int C, int EPI, typename TO>
int launch_conv(const bf16* in, const bf16* w, const float* pmul,
                const float* padd, const float* vec, const bf16* aux,
                TO* out, float* sums, int npix, int H, int W, int d,
                int axis, cudaStream_t stream) {
  constexpr int smem = conv_smem_bytes<C>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3tap_kernel<C, EPI, TO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  conv3tap_kernel<C, EPI, TO><<<grid_1d(npix, TP), THREADS, smem, stream>>>(
      in, w, pmul, padd, vec, aux, out, sums, npix, H, W, d, axis);
  return (int)cudaGetLastError();
}

}  // namespace ldconv
