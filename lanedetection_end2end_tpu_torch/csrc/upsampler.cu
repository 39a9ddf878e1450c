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

#include "common.cuh"

namespace {

// x: (B, H, W, cin); w: (3, 3, cin, cout); out: (B, 2H, 2W, cout)
__global__ void upsampler_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ w,
                                 const float* __restrict__ mul,
                                 const float* __restrict__ add,
                                 bf16* __restrict__ out, int B, int H, int W,
                                 int cin, int cout) {
  const int Ho = 2 * H, Wo = 2 * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Ho * Wo * cout) return;
  const int co = (int)(idx % cout);
  const long long pix = idx / cout;
  const int xo = (int)(pix % Wo);
  const int yo = (int)((pix / Wo) % Ho);
  const int b = (int)(pix / ((long long)Wo * Ho));
  const bf16* xb = x + (size_t)b * H * W * cin;

  // (kernel index, input index) per phase: even -> (1, i); odd -> (2, i),
  // (0, i+1)
  int kys[2], hs[2], nky, kxs[2], ws[2], nkx;
  const int h0 = yo >> 1, w0 = xo >> 1;
  if (yo & 1) {
    kys[0] = 2; hs[0] = h0; kys[1] = 0; hs[1] = h0 + 1; nky = 2;
  } else {
    kys[0] = 1; hs[0] = h0; nky = 1;
  }
  if (xo & 1) {
    kxs[0] = 2; ws[0] = w0; kxs[1] = 0; ws[1] = w0 + 1; nkx = 2;
  } else {
    kxs[0] = 1; ws[0] = w0; nkx = 1;
  }

  float acc = 0.0f;
  for (int i = 0; i < nky; ++i) {
    if (hs[i] >= H) continue;
    for (int j = 0; j < nkx; ++j) {
      if (ws[j] >= W) continue;
      const bf16* xp = xb + ((size_t)hs[i] * W + ws[j]) * cin;
      const bf16* wp = w + (size_t)(kys[i] * 3 + kxs[j]) * cin * cout + co;
      for (int ci = 0; ci < cin; ++ci)
        acc = fmaf(bf2f(xp[ci]), bf2f(wp[(size_t)ci * cout]), acc);
    }
  }
  out[idx] = f2bf(fmaxf(acc * mul[co] + add[co], 0.0f));
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
