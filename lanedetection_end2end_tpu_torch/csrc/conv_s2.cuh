// The stride-2 pieces shared by the training lane-map kernels
// (downsampler_op.cu, lane_maps_op.cu) and the tensor-core tiles of
// conv_s2_mma.cuh.
//
// The TPU kernels (lanedetection_end2end_tpu/ops/pallas_lanemaps.py) express
// every strided or transposed convolution as matmuls with "lane maps" built
// from the weights; those maps, and the plan / sel / pool / btile matrices
// around them, pack 128 lanes and are not ported. Here one geometry covers
// the ops. A small plane (B, Hs, Ws, .) and a large plane (B, 2Hs, 2Ws, .)
// are tied by a k x k kernel W[cs][cl][ky][kx] (cs a channel of the small
// plane, cl of the large one, which is the layout of both the Conv2d and
// the ConvTranspose2d parameter): tap (ky, kx) ties small pixel (h, w) to
// large pixel (2h + ky - pad, 2w + kx - pad). k = 3, pad = 1 is the
// 3x3/s2/p1 convolution (large -> small) and its transposed convolution
// with output padding 1 (small -> large); k = 2, pad = 0 is the 2x2/s2
// head. Three products follow:
//
//   the large gather: small[h, w, cs] = sum_taps sum_cl large[..] W   (conv
//                 forward, ConvTranspose input gradient)
//   the small gather (`gather_small`): large[Y, X, cl] = sum_taps sum_cs
//                 small[..] W   (the ConvTranspose forward, conv input
//                 gradient; only the taps of the pixel's parity land on it)
//   the weight gradient: dW[cs][cl][ky][kx] = sum_pixels small * large
//                 (written in the parameter's layout)
//
// K8 and K9 run the three products on the tensor cores at the backbone's
// 3x3 shapes (conv_s2_mma.cuh), the first downsampler (cin = 3) on FFMA
// kernels of its own (downsampler_op.cu) and K9's 2x2 head on K10's head
// tile (head_quads.cuh). What is left here: the ops' tags, `gather_small`
// (one thread per output value: the first downsampler's input gradient,
// which no train step asks for) and the backward's head, the dyv fold.
// Every sum over blocks of K8 and K9 (moments, bias and weight
// gradients) goes to the blocks' rows of a partials buffer, and one
// fixed-order fold (fold.cuh) at the end of each entry point adds them:
// they reproduce themselves bit for bit, in bf16 and in float32.
#pragma once

#include "common.cuh"
#include "fold.cuh"

namespace lds2 {

constexpr int EW_THREADS = 256;

// The op a shared kernel runs for, a template argument of the kernels of
// this header and conv_s2_mma.cuh, so a profile's kernel names tell K8
// and K9 apart.
struct op_k8 {};
struct op_k9 {};

static inline int ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return (int)(b < 132 * 8 ? b : 132 * 8);
}

// Large pixel (Y, X), channel cl: the sum over the taps of its parity
// (2h + ky - pad = Y) and over the first CS channels of the small plane.
// sb: image b of the small plane (Hs, Ws, CST), CST >= CS; wt: (k, k, CS,
// CL), both of type T.
template <typename T>
__device__ __forceinline__ float gather_small(const T* __restrict__ sb,
                                              const T* __restrict__ wt,
                                              int Hs, int Ws, int CST, int CS,
                                              int CL, int k, int pad, int Y,
                                              int X, int cl) {
  float acc = 0.0f;
  for (int ky = (Y + pad) & 1; ky < k; ky += 2) {
    const int h = (Y + pad - ky) >> 1;  // an even number, maybe negative
    if (h < 0 || h >= Hs) continue;
    for (int kx = (X + pad) & 1; kx < k; kx += 2) {
      const int w = (X + pad - kx) >> 1;
      if (w < 0 || w >= Ws) continue;
      const T* sp = sb + ((size_t)h * Ws + w) * CST;
      const T* wp = wt + (size_t)((ky * k + kx) * CS) * CL + cl;
      for (int ci = 0; ci < CS; ++ci)
        acc = fmaf(ldf(sp, ci), ldf(wp, (long long)ci * CL), acc);
    }
  }
  return acc;
}

// Every thread of the block holds a partial sum s of channel threadIdx.x %
// C, which holds for a grid-stride walk over a channel-fastest array when
// EW_THREADS % C == 0. Reduce over the block, each channel's threads in
// ascending order, into row[0 .. C) (the block's row of a partials
// buffer). Every thread of the block must call it.
__device__ __forceinline__ void block_channel_sums(float s, int C,
                                                   float* row) {
  __shared__ float red[EW_THREADS];
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < C) {
    float a = 0.0f;
    for (int i = threadIdx.x; i < EW_THREADS; i += C) a += red[i];
    row[threadIdx.x] = a;
  }
}

// The head of every backward: the moment cotangent folded into the output
// gradient in f32, the bias gradient summed from that f32 value, one
// rounding to the plane's type TP (none for float32).
//   f = dy + ds1[c] + 2 * y * ds2[c]   (dmom null: f = dy, y is not read)
//   db[c] = sum f;  out = TP(f)
// dy, y: n values, channel fastest, of the forward's output type T; part:
// the blocks' sums of f, C floats a block (a partials buffer).
template <typename T, typename TP, class Tag>
__global__ void __launch_bounds__(EW_THREADS) dyv_fold_kernel(
    const T* __restrict__ dy, const T* __restrict__ y,
    const float* __restrict__ dmom, TP* __restrict__ out,
    float* __restrict__ part, long long n, int C) {
  const int c = threadIdx.x % C;
  const float ds1 = dmom ? dmom[c] : 0.0f, ds2 = dmom ? dmom[C + c] : 0.0f;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EW_THREADS) {
    float f = ldf(dy, i);
    if (dmom != nullptr) f = f + ds1 + 2.0f * ldf(y, i) * ds2;
    acc += f;
    stf(out, i, f);
  }
  block_channel_sums(acc, C, part + (size_t)blockIdx.x * C);
}

// db ((C,) f32) is written whole by the fold of `pp`, which takes the
// blocks' partials here
template <class Tag, typename T, typename TP>
int launch_dyv_fold(const T* dy, const T* y, const float* dmom, TP* out,
                    float* db, long long n, int C, cudaStream_t s,
                    ldfold::Partials& pp) {
  if (C < 1 || EW_THREADS % C != 0) return (int)cudaErrorInvalidValue;
  float* part = pp.take(ew_blocks(n), C, db);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  dyv_fold_kernel<T, TP, Tag><<<ew_blocks(n), EW_THREADS, 0, s>>>(
      dy, y, dmom, out, part, n, C);
  return (int)cudaGetLastError();
}

}  // namespace lds2
