// The stride-2 pieces shared by the training lane-map kernels
// (downsampler_op.cu, lane_maps_op.cu).
//
// The TPU kernels (lanedetection_end2end_tpu/ops/pallas_lanemaps.py) express
// every strided or transposed convolution as matmuls with "lane maps" built
// from the weights; those maps, and the plan / sel / pool / btile matrices
// around them, pack 128 lanes and are not ported. Here one geometry covers
// all three ops. A small plane (B, Hs, Ws, .) and a large plane (B, 2Hs,
// 2Ws, .) are tied by a k x k kernel W[cs][cl][ky][kx] (cs a channel of the
// small plane, cl of the large one, which is the layout of both the Conv2d
// and the ConvTranspose2d parameter): tap (ky, kx) ties small pixel (h, w)
// to large pixel (2h + ky - pad, 2w + kx - pad). k = 3, pad = 1 is the
// 3x3/s2/p1 convolution (large -> small) and its transposed convolution
// with output_padding 1 (small -> large); k = 2, pad = 0 is the 2x2/s2
// head. Three products follow:
//
//   gather_large: small[h, w, cs] = sum_taps sum_cl large[..] W   (conv
//                 forward, ConvTranspose input gradient)
//   gather_small: large[Y, X, cl] = sum_taps sum_cs small[..] W   (the
//                 ConvTranspose forward, conv input gradient; only the taps
//                 of the pixel's parity land on it)
//   wgrad_s2:     dW[cs][cl][ky][kx] = sum_pixels small * large   (every
//                 weight gradient, written in the parameter's layout)
//
// Operands are of the plane's type, bf16 or float32, sums f32. The first
// two run one thread per output value with the channel fastest, so a warp
// reads one input pixel (a broadcast) and a contiguous run of weights per
// tap: CUDA cores, as the serving kernels K2 / K3 do. The weight gradient
// is a [C x pixels] @ [pixels x C] product per tap, split over pixel tiles,
// on bf16 WMMA for bf16 planes and on FFMA for float32 ones (never TF32,
// whose 10-bit mantissa would miss the float32 bar of 1e-4), added to the
// f32 result with atomicAdd (blocks run in no order, so nothing is carried
// between them as the TPU grid carries its accumulators).
//
// K8 and K9 run the three products on the tensor cores at the backbone's
// stride-2 shapes (conv_s2_mma.cuh), and the first downsampler (cin = 3)
// on kernels of its own (downsampler_op.cu); the pieces here serve
// K9's 2x2 head and the first downsampler's input gradient.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace lds2 {

using namespace nvcuda;

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

// Small pixel (h, w), channel cs: the sum over the taps that land on the
// large plane and over its CL channels. lb: image b of the large plane
// (Hl, Wl, CL); wt: (k, k, CL, CS), both of type T.
template <typename T>
__device__ __forceinline__ float gather_large(const T* __restrict__ lb,
                                              const T* __restrict__ wt,
                                              int Hl, int Wl, int CL, int CS,
                                              int k, int pad, int h, int w,
                                              int cs) {
  float acc = 0.0f;
  for (int ky = 0; ky < k; ++ky) {
    const int Y = 2 * h + ky - pad;
    if (Y < 0 || Y >= Hl) continue;
    for (int kx = 0; kx < k; ++kx) {
      const int X = 2 * w + kx - pad;
      if (X < 0 || X >= Wl) continue;
      const T* lp = lb + ((size_t)Y * Wl + X) * CL;
      const T* wp = wt + (size_t)((ky * k + kx) * CL) * CS + cs;
      for (int ci = 0; ci < CL; ++ci)
        acc = fmaf(ldf(lp, ci), ldf(wp, (long long)ci * CS), acc);
    }
  }
  return acc;
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

// Every thread of the block holds partial sums (s0, s1) of channel
// threadIdx.x % C, which holds for a grid-stride walk over a channel-fastest
// array when EW_THREADS % C == 0. Reduce over the block and add to out0[c]
// and out1[c] (either may be null). Every thread of the block must call it.
__device__ __forceinline__ void block_channel_add(float s0, float s1, int C,
                                                  float* out0, float* out1) {
  __shared__ float red[2 * EW_THREADS];
  red[threadIdx.x] = s0;
  red[EW_THREADS + threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.x < C) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int i = threadIdx.x; i < EW_THREADS; i += C) {
      a0 += red[i];
      a1 += red[EW_THREADS + i];
    }
    if (out0 != nullptr) atomicAdd(out0 + threadIdx.x, a0);
    if (out1 != nullptr) atomicAdd(out1 + threadIdx.x, a1);
  }
}

// The head of every backward: the moment cotangent folded into the output
// gradient in f32, the bias gradient summed from that f32 value, one
// rounding to the plane's type TP (none for float32).
//   f = dy + ds1[c] + 2 * y * ds2[c]   (dmom null: f = dy, y is not read)
//   db[c] += f;  out = TP(f)
// dy, y: n values, channel fastest, of the forward's output type T; db:
// (C,) f32, zero on entry.
template <typename T, typename TP, class Tag>
__global__ void __launch_bounds__(EW_THREADS) dyv_fold_kernel(
    const T* __restrict__ dy, const T* __restrict__ y,
    const float* __restrict__ dmom, TP* __restrict__ out,
    float* __restrict__ db, long long n, int C) {
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
  block_channel_add(acc, 0.0f, C, db, nullptr);
}

template <class Tag, typename T, typename TP>
int launch_dyv_fold(const T* dy, const T* y, const float* dmom, TP* out,
                    float* db, long long n, int C, cudaStream_t s) {
  if (C < 1 || EW_THREADS % C != 0) return (int)cudaErrorInvalidValue;
  dyv_fold_kernel<T, TP, Tag><<<ew_blocks(n), EW_THREADS, 0, s>>>(
      dy, y, dmom, out, db, n, C);
  return (int)cudaGetLastError();
}

// out[b, h, w, cs] = T(gather_large): the input gradient of a transposed
// convolution. large: (B, 2Hs, 2Ws, CL); wt: (k, k, CL, CS); out: (B, Hs,
// Ws, CS); all of type T.
template <typename T, class Tag>
__global__ void __launch_bounds__(EW_THREADS) l2s_kernel(
    const T* __restrict__ large, const T* __restrict__ wt,
    T* __restrict__ out, int B, int Hs, int Ws, int CL, int CS, int k,
    int pad) {
  const long long n = (long long)B * Hs * Ws * CS;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EW_THREADS) {
    const int cs = (int)(i % CS);
    const long long pix = i / CS;
    const int w = (int)(pix % Ws), h = (int)((pix / Ws) % Hs);
    const int b = (int)(pix / ((long long)Ws * Hs));
    const T* lb = large + (size_t)b * 4 * Hs * Ws * CL;
    stf(out, i, gather_large(lb, wt, 2 * Hs, 2 * Ws, CL, CS, k, pad, h, w,
                             cs));
  }
}

template <class Tag, typename T>
int launch_l2s(const T* large, const T* wt, T* out, int B, int Hs, int Ws,
               int CL, int CS, int k, int pad, cudaStream_t s) {
  l2s_kernel<T, Tag>
      <<<ew_blocks((long long)B * Hs * Ws * CS), EW_THREADS, 0, s>>>(
          large, wt, out, B, Hs, Ws, CL, CS, k, pad);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Weight gradient
// ---------------------------------------------------------------------

constexpr int WG_TP = 128;       // small-plane pixels per staged bf16 tile
constexpr int WG32_TP = 64;      // the same for a float32 tile
constexpr int WG_THREADS = 256;  // 8 warps

// Stage TILE small-plane pixels from p0 (of npix) for the tap (ky, kx):
// sS[r][c] = small[p0 + r][c] and sL[r][c] = large[the pixel the tap ties
// to p0 + r][c] (pitches lds, ldl; CSP and CLP columns), zero past the
// plane, past the CS or CL channels and where the tap falls off the large
// plane. small: (B, Hs, Ws, CST); large: (B, 2Hs, 2Ws, CL).
template <int TILE, int CSP, int CLP, typename T>
__device__ __forceinline__ void stage_s2_tile(
    T* sS, int lds, T* sL, int ldl, const T* __restrict__ small,
    const T* __restrict__ large, int p0, int npix, int Hs, int Ws, int CST,
    int CS, int CL, int ky, int kx, int pad) {
  const int Hl = 2 * Hs, Wl = 2 * Ws;
  for (int i = threadIdx.x; i < TILE * CSP; i += WG_THREADS) {
    const int r = i / CSP, c = i % CSP;
    const int p = p0 + r;
    stf(sS, r * lds + c,
        (p < npix && c < CS) ? ldf(small, (long long)p * CST + c) : 0.0f);
  }
  for (int i = threadIdx.x; i < TILE * CLP; i += WG_THREADS) {
    const int r = i / CLP, c = i % CLP;
    const int p = p0 + r;
    float v = 0.0f;
    if (p < npix && c < CL) {
      const int w = p % Ws, h = (p / Ws) % Hs, b = p / (Ws * Hs);
      const int Y = 2 * h + ky - pad, X = 2 * w + kx - pad;
      if (Y >= 0 && Y < Hl && X >= 0 && X < Wl)
        v = ldf(large, (((long long)b * Hl + Y) * Wl + X) * CL + c);
    }
    stf(sL, r * ldl + c, v);
  }
}

template <int CSP, int CLP>
constexpr int wgrad_s2_smem_bytes() {
  // two bf16 tiles (WG_TP x CSP+8, WG_TP x CLP+8), later aliased by 8 f32
  // 16 x (CLP+4) tiles
  return WG_TP * (CSP + CLP + 16) * 2 > 8 * 16 * (CLP + 4) * 4
             ? WG_TP * (CSP + CLP + 16) * 2
             : 8 * 16 * (CLP + 4) * 4;
}

// dW[cs][cl][ky][kx] += sum over the pixel tiles of this block of
// small[p, cs] * large[pixel tied to p by the tap, cl], bf16 operands;
// blockIdx.y is the tap. CSP, CLP: the channel counts padded to the WMMA
// tile (the padding is staged as zeros and never written back). Warp w owns
// the 16 rows cs = 16 * (w % (CSP/16)) and every (8 / (CSP/16))-th 16-pixel
// step. small: (B, Hs, Ws, CST) of which the first CS channels count;
// large: (B, 2Hs, 2Ws, CL); dW: (CS, CL, k, k) f32, zero on entry.
template <int CSP, int CLP, class Tag>
__global__ void __launch_bounds__(WG_THREADS) wgrad_s2_kernel(
    const bf16* __restrict__ small, const bf16* __restrict__ large,
    float* __restrict__ dW, int B, int Hs, int Ws, int CST, int CS, int CL,
    int k, int pad, int tiles_per_block) {
  constexpr int LDS = CSP + 8, LDL = CLP + 8, LDC = CLP + 4;
  constexpr int RG = CSP / 16;  // row groups of 16 small-plane channels
  constexpr int KG = 8 / RG;    // warps sharing a row group split the pixels
  constexpr int NF = CLP / 16;
  static_assert(8 % RG == 0, "CSP in {16, 32, 64, 128}");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sS = reinterpret_cast<bf16*>(smem);
  bf16* sL = sS + WG_TP * LDS;

  const int ky = blockIdx.y / k, kx = blockIdx.y % k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % RG, kg = warp / RG;
  const int npix = B * Hs * Ws;
  const int ntiles = (npix + WG_TP - 1) / WG_TP;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(ntiles, tile0 + tiles_per_block);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int tile = tile0; tile < tile1; ++tile) {
    stage_s2_tile<WG_TP, CSP, CLP>(sS, LDS, sL, LDL, small, large,
                                   tile * WG_TP, npix, Hs, Ws, CST, CS, CL,
                                   ky, kx, pad);
    __syncthreads();
    for (int ks = kg; ks < WG_TP / 16; ks += KG) {
      // (cs, pixel) read column-major from the (pixel, cs) rows
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, sS + ks * 16 * LDS + rg * 16, LDS);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sL + ks * 16 * LDL + n * 16, LDL);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    __syncthreads();  // the tiles are overwritten next
  }

  float* sW = reinterpret_cast<float*>(smem) + warp * 16 * LDC;
#pragma unroll
  for (int n = 0; n < NF; ++n)
    wmma::store_matrix_sync(sW + n * 16, acc[n], LDC, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * CLP; i += 32) {
    const int cs = rg * 16 + i / CLP, cl = i % CLP;
    if (cs < CS && cl < CL)
      atomicAdd(dW + (((size_t)cs * CL + cl) * k + ky) * k + kx,
                sW[(i / CLP) * LDC + cl]);
  }
}

// The same product on float32 operands with FFMA: each of the 16 x 16
// threads keeps a (CSP/16) x (CLP/16) tile of the (cs, cl) result, rows
// and columns interleaved by 16 so neighbouring threads read neighbouring
// shared-memory words, and adds it to dW with atomicAdd at the end.
template <int CSP, int CLP, class Tag>
__global__ void __launch_bounds__(WG_THREADS) wgrad_s2_f32_kernel(
    const float* __restrict__ small, const float* __restrict__ large,
    float* __restrict__ dW, int B, int Hs, int Ws, int CST, int CS, int CL,
    int k, int pad, int tiles_per_block) {
  constexpr int MS = CSP / 16, ML = CLP / 16;
  extern __shared__ __align__(16) float smem32[];
  float* sS = smem32;                  // WG32_TP x CSP
  float* sL = smem32 + WG32_TP * CSP;  // WG32_TP x CLP

  const int ky = blockIdx.y / k, kx = blockIdx.y % k;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int npix = B * Hs * Ws;
  const int ntiles = (npix + WG32_TP - 1) / WG32_TP;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(ntiles, tile0 + tiles_per_block);

  float acc[MS][ML];
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int j = 0; j < ML; ++j) acc[i][j] = 0.0f;

  for (int tile = tile0; tile < tile1; ++tile) {
    stage_s2_tile<WG32_TP, CSP, CLP>(sS, CSP, sL, CLP, small, large,
                                     tile * WG32_TP, npix, Hs, Ws, CST, CS,
                                     CL, ky, kx, pad);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG32_TP; ++r) {
      float a[MS], b[ML];
#pragma unroll
      for (int i = 0; i < MS; ++i) a[i] = sS[r * CSP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < ML; ++j) b[j] = sL[r * CLP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MS; ++i)
#pragma unroll
        for (int j = 0; j < ML; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are overwritten next
  }
#pragma unroll
  for (int i = 0; i < MS; ++i) {
    const int cs = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < ML; ++j) {
      const int cl = tx + 16 * j;
      if (cs < CS && cl < CL)
        atomicAdd(dW + (((size_t)cs * CL + cl) * k + ky) * k + kx,
                  acc[i][j]);
    }
  }
}

// Launch a weight-gradient kernel `kern` (TILE pixels per staged tile,
// `smem` bytes of shared memory) over about 160 blocks across the taps:
// more blocks than SMs, few atomics.
template <typename K, typename T>
int launch_wgrad_s2_kernel(K kern, int smem, int tile, const T* small,
                           const T* large, float* dW, int B, int Hs, int Ws,
                           int CST, int CS, int CL, int k, int pad,
                           cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntiles = (B * Hs * Ws + tile - 1) / tile;
  const int chunks = (160 + k * k - 1) / (k * k);
  const int tpb = (ntiles + chunks - 1) / chunks;
  dim3 grid((ntiles + tpb - 1) / tpb, k * k);
  kern<<<grid, WG_THREADS, smem, s>>>(small, large, dW, B, Hs, Ws, CST, CS,
                                      CL, k, pad, tpb);
  return (int)cudaGetLastError();
}

template <int CSP, int CLP, class Tag>
int launch_wgrad_s2_as(const bf16* small, const bf16* large, float* dW, int B,
                       int Hs, int Ws, int CST, int CS, int CL, int k,
                       int pad, cudaStream_t s) {
  return launch_wgrad_s2_kernel(wgrad_s2_kernel<CSP, CLP, Tag>,
                                wgrad_s2_smem_bytes<CSP, CLP>(), WG_TP, small,
                                large, dW, B, Hs, Ws, CST, CS, CL, k, pad, s);
}

template <int CSP, int CLP, class Tag>
int launch_wgrad_s2_as(const float* small, const float* large, float* dW,
                       int B, int Hs, int Ws, int CST, int CS, int CL, int k,
                       int pad, cudaStream_t s) {
  return launch_wgrad_s2_kernel(wgrad_s2_f32_kernel<CSP, CLP, Tag>,
                                WG32_TP * (CSP + CLP) * 4, WG32_TP, small,
                                large, dW, B, Hs, Ws, CST, CS, CL, k, pad, s);
}

// dW (CS, CL, k, k) f32, zero on entry, += the weight gradient between the
// first CS channels of `small` and the CL of `large`, both bf16 or both f32.
template <class Tag, typename T>
int launch_wgrad_s2(const T* small, const T* large, float* dW, int B, int Hs,
                    int Ws, int CST, int CS, int CL, int k, int pad,
                    cudaStream_t s) {
#define LD_WG(CSP, CLP)                                                      \
  launch_wgrad_s2_as<CSP, CLP, Tag>(small, large, dW, B, Hs, Ws, CST, CS, CL, \
                                    k, pad, s)
  if (CL <= 16 && CS <= 16) return LD_WG(16, 16);
  if (CL <= 16 && CS <= 64) return LD_WG(64, 16);
  if (CL <= 64 && CS <= 64) return LD_WG(64, 64);
  if (CL <= 64 && CS <= 128) return LD_WG(128, 64);
#undef LD_WG
  return (int)cudaErrorInvalidValue;
}

}  // namespace lds2
