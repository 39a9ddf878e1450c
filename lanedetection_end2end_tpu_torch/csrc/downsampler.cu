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
// 3 channels; the TPU's pad to 4 is a lane artifact), 16->64 and 64->128.
//
// Bound on the card: per output pixel, cc * 9 * cin * 2 FLOP against
// 2*cout bytes out and 4*cin*2 bytes in: ~96 FLOP per byte for 64->128,
// ~54 for 16->64 and ~13 for 3->16, all under the H100's ~295 FLOP/byte
// ridge, so HBM bounds all three.
//
// Design: one thread per output value (pixel, channel), channels fastest,
// so a warp reads one input pixel (a broadcast) and a contiguous run of
// weights (coalesced, L1/L2 resident) for each tap. CUDA cores, no
// tensor cores: this block is under 3% of the backbone's FLOP.
// The per-output body is in downsampler.cuh, shared with the
// whole-encoder kernel encoder_fused.cu.

#include "downsampler.cuh"

namespace {

// x: (B, H, W, cin); w: (3, 3, cin, cc) [kh][kw][ci][co]; out: (B, H/2,
// W/2, cout)
__global__ void downsampler_kernel(const bf16* __restrict__ x,
                                   const bf16* __restrict__ w,
                                   const float* __restrict__ mul,
                                   const float* __restrict__ add,
                                   bf16* __restrict__ out, int B, int H, int W,
                                   int cin, int cout) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * (H / 2) * (W / 2) * cout) return;
  ldds::downsampler_values<false, 1>(idx, x, w, mul, add, out, H, W, cin,
                                     cout);
}

}  // namespace

LD_API int ld_downsampler(const void* x, const void* w, const void* mul,
                          const void* add, void* out, int B, int H, int W,
                          int cin, int cout, void* stream) {
  const long long n = (long long)B * (H / 2) * (W / 2) * cout;
  constexpr int threads = 256;
  downsampler_kernel<<<grid_1d(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<bf16*>(out), B, H, W, cin, cout);
  return (int)cudaGetLastError();
}
