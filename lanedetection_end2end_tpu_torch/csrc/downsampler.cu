// K2 downsampler: ERFNet DownsamplerBlock (inference, BatchNorm folded).
//
// Replaces the TPU body `body_downsampler` (lanedetection_end2end_tpu/ops/
// pallas_backbone.py:155), which expresses the strided convolution through
// translation-invariant "lane map" matmuls on the lane-packed plane. Here it
// is computed directly on NHWC bf16:
//
//   out[.., co]   = relu(conv3x3_s2_p1(x)[co] * mul[co] + add[co])  co < cc
//   out[.., cc+c] = relu(maxpool2x2(x)[c]     * mul[..] + add[..])  c < cin
//
// with cc = cout - cin, the conv channels first (erfnet.py:48-52), the conv
// bias folded into `add` of the conv channels only, f32 accumulation over
// bf16 operands and one bf16 rounding at the output. It runs 3->16 (RGB as
// 3 channels; the TPU's pad to 4 is a lane artifact), 16->64 and 64->128,
// and takes no other shape.
//
// Bound on the card: per output pixel, cc * 9 * cin * 2 FLOP against
// 2*cout bytes out and 4*cin*2 bytes in: ~96 FLOP per byte for 64->128,
// ~54 for 16->64 and ~13 for 3->16, all under the H100's ~295 FLOP/byte
// ridge, so HBM bounds all three.
//
// Design (device code in downsampler.cuh, shared with the whole-encoder
// kernel encoder_fused.cu): 16->64 and 64->128 on the tensor-core tile of
// K8 (conv_s2_mma.cuh), 128 small-plane pixels a block of 8 warps, the
// epilogue in registers; 3->16 on FFMA, one thread per output pixel.

#include "downsampler.cuh"

namespace {

template <int CK, int N>
__global__ void __launch_bounds__(32 * ldds::NW)
    ds_kernel(const ldds::op_ds_serve op) {
  extern __shared__ __align__(128) unsigned char smem[];
  lds2::s2_tile<bf16, CK, N, ldds::NW>(op, blockIdx.x * ldds::BM, 0,
                                       reinterpret_cast<bf16*>(smem),
                                       nullptr);
}

template <int CK, int N>
int launch_ds(const ldds::op_ds_serve& op, cudaStream_t s) {
  constexpr int smem = lds2::GemmTile<bf16, CK, N, ldds::NW>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ds_kernel<CK, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  ds_kernel<CK, N><<<(op.npix + ldds::BM - 1) / ldds::BM, 32 * ldds::NW,
                     smem, s>>>(op);
  return (int)cudaGetLastError();
}

constexpr int D1_THREADS = 256;

// x: (B, H, W, 3); w: (3, 3, 3, 13); out: (B, H/2, W/2, 16)
__global__ void __launch_bounds__(D1_THREADS) ds1_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ mul, const float* __restrict__ add,
    bf16* __restrict__ out, int npix, int H, int W) {
  __shared__ float sw[ldds::D1_SW];
  ldds::ds1_stage(w, mul, add, sw);
  __syncthreads();
  const int p = blockIdx.x * D1_THREADS + threadIdx.x;
  if (p < npix) ldds::ds1_pixel(p, x, sw, out, H, W);
}

}  // namespace

LD_API int ld_downsampler(const void* x, const void* w, const void* mul,
                          const void* add, void* out, int B, int H, int W,
                          int cin, int cout, void* stream) {
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto Wt = static_cast<const bf16*>(w);
  auto M = static_cast<const float*>(mul);
  auto A = static_cast<const float*>(add);
  auto O = static_cast<bf16*>(out);
  if (cin == ldds::D1_CIN && cout == ldds::D1_COUT) {
    const int npix = B * (H / 2) * (W / 2);
    ds1_kernel<<<grid_1d(npix, D1_THREADS), D1_THREADS, 0, s>>>(
        X, Wt, M, A, O, npix, H, W);
    return (int)cudaGetLastError();
  }
  const ldds::op_ds_serve op = ldds::ds_op(X, Wt, M, A, O, B, H, W, cin, cout);
  if (cin == 16 && cout == 64) return launch_ds<16, 48>(op, s);
  if (cin == 64 && cout == 128) return launch_ds<64, 64>(op, s);
  return (int)cudaErrorInvalidValue;
}
