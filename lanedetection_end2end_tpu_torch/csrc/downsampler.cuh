// K2's device code: an ERFNet DownsamplerBlock (inference, BatchNorm
// folded), shared by the standalone kernel (downsampler.cu, notes there)
// and the whole-encoder kernel (encoder_fused.cu). Both run this code on
// the same inputs, so the fused encoder's planes are bit for bit K2's.
//
//   out[.., co]   = bf16(relu(conv3x3_s2_p1(x)[co] * mul[co] + add[co]))
//   out[.., cc+c] = bf16(relu(maxpool2x2(x)[c]     * mul[..] + add[..]))
//
// with cc = cout - cin conv channels first. Two bodies:
//
//   16 -> 64, 64 -> 128: the tensor-core tile of K8 (conv_s2_mma.cuh,
//     ConvGeo: A row (p, tap) is x at (2h + ky - 1, 2w + kx - 1), N = cc)
//     with the serving epilogue `op_ds_serve` on the accumulators in
//     registers, and the pool channels from the same windows of x;
//   3 -> 16: three input channels do not fill a k16 fragment, so FFMA, one
//     thread per output pixel computing all 16 channels from its 3x3x3
//     window, loaded once (`ds1_pixel`; K8's `ds1_fwd_kernel` does the
//     same for training).
//
// Planes the fused kernel writes in its launch are read through L2 only
// (the ring's cp.async.cg, __ldcg for the pool).
#pragma once

#include "conv_s2_mma.cuh"

namespace ldds {

constexpr int NW = 8;             // warps of the serving tile (256 threads)
constexpr int BM = 16 * NW;       // small-plane pixels a tile
constexpr int D1_CIN = 3, D1_COUT = 16, D1_CC = 13, D1_K = 27;
constexpr int D1_SW = D1_K * D1_CC + 2 * D1_COUT;  // staged floats

// The serving epilogue of the 3x3/s2/p1 tile (x = `large`, N = cc): the
// conv channels bf16(relu(acc * mul + add)), then the pool channels of the
// tile's rows, channel fastest over the block's threads. wt: (3, 3, cin,
// cc) [kh][kw][ci][co]; y: (B, Hs, Ws, cout).
struct op_ds_serve : lds2::ConvGeo<bf16> {
  const bf16* wt;
  const float* mul;
  const float* add;
  bf16* y;
  int cin, cout, cc;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int, float*) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + lds2::tile_row(h);
      if (p >= npix) continue;
      bf16* yr = y + (size_t)p * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = lds2::tile_col(j);
        store_bf2(yr + n, bn_relu(acc[j][2 * h], mul[n], add[n]),
                  bn_relu(acc[j][2 * h + 1], mul[n + 1], add[n + 1]));
      }
    }
    const int rows = 16 * (blockDim.x >> 5), H = 2 * Hs, W = 2 * Ws;
    const size_t col = cin, row = (size_t)W * cin;
    for (int i = threadIdx.x; i < rows * cin; i += blockDim.x) {
      const int p = p0 + i / cin, c = i % cin;
      if (p >= npix) break;
      const lds2::Pix q = lds2::pix_of(p, npix, Hs, Ws);
      const bf16* xp =
          large + (((size_t)q.b * H + 2 * q.h) * W + 2 * q.w) * cin + c;
      const float m =
          fmaxf(fmaxf(load_bf<true>(xp), load_bf<true>(xp + col)),
                fmaxf(load_bf<true>(xp + row), load_bf<true>(xp + row + col)));
      y[(size_t)p * cout + cc + c] = f2bf(bn_relu(m, mul[cc + c], add[cc + c]));
    }
  }
};

// x (B, H, W, cin) -> y (B, H/2, W/2, cout); mul, add: (cout,)
__host__ __device__ inline op_ds_serve ds_op(const bf16* x, const bf16* w,
                                             const float* mul,
                                             const float* add, bf16* y,
                                             int B, int H, int W, int cin,
                                             int cout) {
  op_ds_serve op;
  op.large = x;
  op.Hs = H / 2;
  op.Ws = W / 2;
  op.npix = B * op.Hs * op.Ws;
  op.CL = cin;
  op.wt = w;
  op.mul = mul;
  op.add = add;
  op.y = y;
  op.cin = cin;
  op.cout = cout;
  op.cc = cout - cin;
  return op;
}

// The tiles of one stride-2 pass over a persistent grid's blocks
// (phases = 1 here, 4 for the transposed convolution), each block's
// tiles separated by a barrier. The op lives in shared memory while they
// run, as nb1d.cuh's passes do.
template <int CK, int N, class Op>
__device__ __forceinline__ void s2_pass(const Op& pass, int phases,
                                        unsigned char* smem) {
  __shared__ Op op;
  __syncthreads();  // the block is done with the previous pass's copy
  if (threadIdx.x == 0) op = pass;
  __syncthreads();
  const int ntiles = (op.npix + BM - 1) / BM;
  for (int u = blockIdx.x; u < ntiles * phases; u += gridDim.x) {
    lds2::s2_tile<bf16, CK, N, NW>(op, (u / phases) * BM, u % phases,
                                   reinterpret_cast<bf16*>(smem), nullptr);
    __syncthreads();  // the next tile rewrites the ring
  }
}

// ---- the first downsampler, 3 -> 16 ---------------------------------------

// sw = [w (27 x 13) | mul (16) | add (16)] as floats; w: (3, 3, 3, 13)
__device__ __forceinline__ void ds1_stage(const bf16* w, const float* mul,
                                          const float* add, float* sw) {
  for (int i = threadIdx.x; i < D1_SW; i += blockDim.x)
    sw[i] = i < D1_K * D1_CC     ? bf2f(w[i])
            : i < D1_K * D1_CC + D1_COUT ? mul[i - D1_K * D1_CC]
                                 : add[i - D1_K * D1_CC - D1_COUT];
}

// Output pixel p of (B, H/2, W/2, 16) from x (B, H, W, 3): each conv
// channel's sum over (ky, kx, ci) in order by fmaf, zero taps off the
// plane; the pool window is taps (ky, kx) in {1, 2}^2 of the 3x3 one.
// x is the launch's input, never written in it.
__device__ __forceinline__ void ds1_pixel(int p, const bf16* __restrict__ x,
                                          const float* sw, bf16* out, int H,
                                          int W) {
  const int Ws = W / 2, Hs = H / 2;
  const int w = p % Ws, h = (p / Ws) % Hs, b = p / (Ws * Hs);
  float v[D1_K];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int Y = 2 * h + ky - 1, X = 2 * w + kx - 1;
      const bool ok = Y >= 0 && X >= 0;  // 2h + 1 < H, 2w + 1 < W
      const bf16* xp =
          x + (((size_t)b * H + (ok ? Y : 0)) * W + (ok ? X : 0)) * D1_CIN;
#pragma unroll
      for (int ci = 0; ci < D1_CIN; ++ci)
        v[(3 * ky + kx) * D1_CIN + ci] = ok ? bf2f(xp[ci]) : 0.0f;
    }
  const float* mul = sw + D1_K * D1_CC;
  const float* add = mul + D1_COUT;
  float o[D1_COUT];
#pragma unroll
  for (int co = 0; co < D1_CC; ++co) o[co] = 0.0f;
  // tap by tap, each channel's sum in tap order; one weight row at a time
  // in registers
#pragma unroll
  for (int t = 0; t < D1_K; ++t)
#pragma unroll
    for (int co = 0; co < D1_CC; ++co)
      o[co] = fmaf(v[t], sw[t * D1_CC + co], o[co]);
#pragma unroll
  for (int co = 0; co < D1_CC; ++co) o[co] = bn_relu(o[co], mul[co], add[co]);
#pragma unroll
  for (int c = 0; c < D1_CIN; ++c)
    o[D1_CC + c] = bn_relu(fmaxf(fmaxf(v[12 + c], v[15 + c]),
                                 fmaxf(v[21 + c], v[24 + c])),
                           mul[D1_CC + c], add[D1_CC + c]);
  bf16* op = out + (size_t)p * D1_COUT;
  store8(op, *reinterpret_cast<float(*)[8]>(o));
  store8(op + 8, *reinterpret_cast<float(*)[8]>(o + 8));
}

// The first downsampler as one pass of a persistent grid's threads over
// the output pixels; sw: D1_SW floats of shared memory.
__device__ __forceinline__ void ds1_pass(const bf16* x, const bf16* w,
                                         const float* mul, const float* add,
                                         bf16* out, int B, int H, int W,
                                         float* sw) {
  ds1_stage(w, mul, add, sw);
  __syncthreads();
  const int npix = B * (H / 2) * (W / 2);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < npix;
       p += gridDim.x * blockDim.x)
    ds1_pixel(p, x, sw, out, H, W);
}

}  // namespace ldds
