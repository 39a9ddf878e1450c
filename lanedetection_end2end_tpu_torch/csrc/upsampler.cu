// K3 upsampler: ERFNet UpsamplerBlock (inference, BatchNorm folded).
//
// Replaces the TPU body `body_upsampler` (lanedetection_end2end_tpu/ops/
// pallas_backbone.py:250), which folds the column phases of the transposed
// convolution into lane-map matmuls and interleaves the row phases. Here it
// is computed directly on NHWC bf16: ConvTranspose2d(3x3, stride 2,
// padding 1, output_padding 1), then relu(acc * mul + add) with the conv
// bias folded into `add`, f32 accumulation, one bf16 rounding. It runs
// 128->64 and 64->16 and takes no other shape.
//
// Weights are the torch layout (cin, cout, kH, kW) permuted to
// (kH, kW, cin, cout), UNFLIPPED. torch's transposed conv writes x[h] into
// output row y = 2h - 1 + ky, so output row 2h' takes x[h'] * W[ky=1] and
// row 2h'+1 takes x[h'] * W[2] + x[h'+1] * W[0] (the same in columns); the
// flax-kernel form of the same phases is at pallas_backbone.py:207-213.
//
// Bound on the card: 2.25 taps * 2 * cin FLOP per output value on average;
// per output pixel 2*cout bytes out and cin*2/4 bytes in: ~190 FLOP/byte
// for 128->64 and ~72 for 64->16, both under the ~295 FLOP/byte ridge, so
// HBM bounds it.
//
// Design (device code in upsampler.cuh, shared with the whole-decoder
// kernel decoder_fused.cu): the tensor-core tile of K9 (conv_s2_mma.cuh)
// by output parity, blockIdx.y = phase, 128 small-plane pixels a block of
// 8 warps, the epilogue in registers.

#include "upsampler.cuh"

namespace {

template <int CK, int N>
__global__ void __launch_bounds__(32 * ldds::NW)
    us_kernel(const ldus::op_us_serve op) {
  extern __shared__ __align__(128) unsigned char smem[];
  lds2::s2_tile<bf16, CK, N, ldds::NW>(op, blockIdx.x * ldds::BM, blockIdx.y,
                                       reinterpret_cast<bf16*>(smem),
                                       nullptr);
}

template <int CK, int N>
int launch_us(const ldus::op_us_serve& op, cudaStream_t s) {
  constexpr int smem = lds2::GemmTile<bf16, CK, N, ldds::NW>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        us_kernel<CK, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((op.npix + ldds::BM - 1) / ldds::BM, 4);
  us_kernel<CK, N><<<grid, 32 * ldds::NW, smem, s>>>(op);
  return (int)cudaGetLastError();
}

}  // namespace

LD_API int ld_upsampler(const void* x, const void* w, const void* mul,
                        const void* add, void* out, int B, int H, int W,
                        int cin, int cout, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ldus::op_us_serve op = ldus::us_op(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<bf16*>(out), B, H, W, cin, cout);
  if (cin == 128 && cout == 64) return launch_us<128, 64>(op, s);
  if (cin == 64 && cout == 16) return launch_us<64, 16>(op, s);
  return (int)cudaErrorInvalidValue;
}
