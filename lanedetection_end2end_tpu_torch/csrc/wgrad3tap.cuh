// The weight gradient of a 3-tap convolution in bf16, shared by the
// training kernels nb_half_bwd.cu and packed_conv.cu:
//
//   dk[t, ci, co] += sum_p f(in[p + tap_t])[ci] * dy[p, co]
//
// with taps at -d, 0, +d along rows (axis 0) or columns (axis 1) and f the
// BatchNorm prologue of conv3tap.cuh when pmul != nullptr. Per tap a
// [C x pixels] @ [pixels x C] product, split over pixel tiles; each block
// of 8 warps walks its tiles with bf16 WMMA (A read column-major from the
// staged rows, so no transpose is materialized), keeps C x C f32 in
// registers and adds it to the (3, C, C) result with atomicAdd at the end,
// so its last bits depend on the order blocks finish in. dk must be zero
// before the first launch that adds to it.
#pragma once

#include "conv3tap.cuh"

namespace ldconv {

constexpr int WG_TP = 128;       // pixels per staged tile
constexpr int WG_THREADS = 256;  // 8 warps

template <int C>
constexpr int wgrad_smem_bytes() {
  // two bf16 tiles (WG_TP x C+8), later aliased by 8 f32 16 x (C+4) tiles
  return 2 * WG_TP * (C + 8) * 2 > 8 * 16 * (C + 4) * 4
             ? 2 * WG_TP * (C + 8) * 2
             : 8 * 16 * (C + 4) * 4;
}

// dk[t, ci, co] += sum_p f(in[p + tap_t])[ci] * dy[p, co] for the pixel
// tiles of this block; blockIdx.y is the tap. Warp w owns the 16 rows
// ci = 16 * (w % (C/16)) and every (8 / (C/16))-th 16-pixel step.
template <int C>
__global__ void __launch_bounds__(WG_THREADS) wgrad3tap_kernel(
    const bf16* __restrict__ in, const float* __restrict__ pmul,
    const float* __restrict__ padd, const bf16* __restrict__ dy,
    float* __restrict__ dk, int npix, int H, int W, int d, int axis,
    int tiles_per_block) {
  constexpr int LDA = C + 8;
  constexpr int LDC = C + 4;
  constexpr int NF = C / 16;
  constexpr int RG = C / 16;  // row groups of 16 input channels
  constexpr int KG = 8 / RG;  // warps sharing a row group split the pixels
  static_assert(8 % RG == 0, "C in {16, 32, 64, 128}");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sD = sA + WG_TP * LDA;

  const int t = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % RG, kg = warp / RG;
  const int ntiles = (npix + WG_TP - 1) / WG_TP;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(ntiles, tile0 + tiles_per_block);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int tile = tile0; tile < tile1; ++tile) {
    const int p0 = tile * WG_TP;
    stage_rows<C, WG_TP, WG_THREADS>(sA, in, pmul, padd, p0, npix, H, W,
                                     (t - 1) * d, axis);
    stage_rows<C, WG_TP, WG_THREADS>(sD, dy, nullptr, nullptr, p0, npix, H, W,
                                     0, axis);
    __syncthreads();
    for (int ks = kg; ks < WG_TP / 16; ks += KG) {
      // (ci, pixel) read column-major from the (pixel, ci) rows
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, sA + ks * 16 * LDA + rg * 16, LDA);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sD + ks * 16 * LDA + n * 16, LDA);
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
  float* dkt = dk + ((size_t)t * C + rg * 16) * C;
  for (int i = lane; i < 16 * C; i += 32)
    atomicAdd(dkt + i, sW[(i / C) * LDC + i % C]);
}

template <int C>
int launch_wgrad(const bf16* in, const float* pmul, const float* padd,
                 const bf16* dy, float* dk, int npix, int H, int W, int d,
                 int axis, cudaStream_t stream) {
  constexpr int smem = wgrad_smem_bytes<C>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wgrad3tap_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntiles = (npix + WG_TP - 1) / WG_TP;
  // about 64 x 3 blocks: fewer atomics than one block per tile, and still
  // more blocks than SMs
  const int tpb = (ntiles + 63) / 64;
  dim3 grid((ntiles + tpb - 1) / tpb, 3);
  wgrad3tap_kernel<C><<<grid, WG_THREADS, smem, stream>>>(
      in, pmul, padd, dy, dk, npix, H, W, d, axis, tpb);
  return (int)cudaGetLastError();
}

}  // namespace ldconv
