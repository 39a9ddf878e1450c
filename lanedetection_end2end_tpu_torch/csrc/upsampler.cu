// K3 upsampler: ERFNet UpsamplerBlock (inference, BatchNorm folded).
//
// Replaces the TPU body `body_upsampler` (lanedetection_end2end_tpu/ops/
// pallas_backbone.py:250), which folds the column phases of the transposed
// convolution into lane-map matmuls and interleaves the row phases. Here it
// is computed directly on NHWC bf16: ConvTranspose2d(3x3, stride 2,
// padding 1, output_padding 1), then relu(acc * mul + add) with the conv
// bias folded into `add`, f32 accumulation, one bf16 rounding.
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
// Design: one thread per output value (pixel, channel), channels fastest;
// the input pixel is a warp broadcast, the weights a coalesced run. CUDA
// cores only: both upsamplers are ~3% of the backbone's FLOP.
// The per-output body is in upsampler.cuh, shared with the
// whole-decoder kernel decoder_fused.cu.

#include "upsampler.cuh"

namespace {

// x: (B, H, W, cin); w: (3, 3, cin, cout); out: (B, 2H, 2W, cout)
__global__ void upsampler_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ w,
                                 const float* __restrict__ mul,
                                 const float* __restrict__ add,
                                 bf16* __restrict__ out, int B, int H, int W,
                                 int cin, int cout) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * (2 * H) * (2 * W) * cout) return;
  ldus::upsampler_values<false, 1>(idx, x, w, mul, add, out, H, W, cin,
                                   cout);
}

}  // namespace

LD_API int ld_upsampler(const void* x, const void* w, const void* mul,
                        const void* add, void* out, int B, int H, int W,
                        int cin, int cout, void* stream) {
  const long long n = (long long)B * (2 * H) * (2 * W) * cout;
  constexpr int threads = 256;
  upsampler_kernel<<<grid_1d(n, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<bf16*>(out), B, H, W, cin, cout);
  return (int)cudaGetLastError();
}
