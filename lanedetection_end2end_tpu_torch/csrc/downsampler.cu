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

#include "common.cuh"

namespace {

// x: (B, H, W, cin); w: (3, 3, cin, cc) [kh][kw][ci][co]; out: (B, H/2,
// W/2, cout)
__global__ void downsampler_kernel(const bf16* __restrict__ x,
                                   const bf16* __restrict__ w,
                                   const float* __restrict__ mul,
                                   const float* __restrict__ add,
                                   bf16* __restrict__ out, int B, int H, int W,
                                   int cin, int cout) {
  const int Ho = H / 2, Wo = W / 2, cc = cout - cin;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Ho * Wo * cout) return;
  const int co = (int)(idx % cout);
  const long long pix = idx / cout;
  const int wo = (int)(pix % Wo);
  const int ho = (int)((pix / Wo) % Ho);
  const int b = (int)(pix / ((long long)Wo * Ho));
  const bf16* xb = x + (size_t)b * H * W * cin;

  float v;
  if (co < cc) {
    float acc = 0.0f;
    for (int kh = 0; kh < 3; ++kh) {
      const int h = 2 * ho + kh - 1;
      if (h < 0 || h >= H) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int wi = 2 * wo + kw - 1;
        if (wi < 0 || wi >= W) continue;
        const bf16* xp = xb + ((size_t)h * W + wi) * cin;
        const bf16* wp = w + (size_t)(kh * 3 + kw) * cin * cc + co;
        for (int ci = 0; ci < cin; ++ci)
          acc = fmaf(bf2f(xp[ci]), bf2f(wp[(size_t)ci * cc]), acc);
      }
    }
    v = acc;
  } else {
    const int c = co - cc;
    const bf16* xp = xb + ((size_t)(2 * ho) * W + 2 * wo) * cin + c;
    const size_t row = (size_t)W * cin;
    v = fmaxf(fmaxf(bf2f(xp[0]), bf2f(xp[cin])),
              fmaxf(bf2f(xp[row]), bf2f(xp[row + cin])));
  }
  out[idx] = f2bf(fmaxf(v * mul[co] + add[co], 0.0f));
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
