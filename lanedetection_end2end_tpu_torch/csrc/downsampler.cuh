// K2's per-output body: output values of an ERFNet DownsamplerBlock
// (inference, BatchNorm folded), shared by the standalone kernel
// (downsampler.cu, notes there) and the whole-encoder kernel
// (encoder_fused.cu). Both run this code on the same inputs, so the fused
// encoder's planes are bit for bit K2's.
//
//   out[.., co]   = relu(conv3x3_s2_p1(x)[co] * mul[co] + add[co])  co < cc
//   out[.., cc+c] = relu(maxpool2x2(x)[c]     * mul[..] + add[..])  c < cin
//
// kCoherent reads x through L2 only (load_bf, common.cuh): the fused kernel
// writes x earlier in the same launch.
#pragma once

#include "common.cuh"

namespace ldds {

// Output values idx .. idx + NC - 1 of (B, H/2, W/2, cout), channels
// fastest: NC consecutive channels of one pixel (NC divides cout and idx).
// Each value's sum runs over (kh, kw, ci) in the same order whatever NC
// is, so NC = 1 (one thread per value, the standalone kernel) and a wider
// NC (one thread per NC values, the pixel's inputs loaded once for them)
// give the same bits. x: (B, H, W, cin); w: (3, 3, cin, cc)
// [kh][kw][ci][co]; cc = cout - cin.
template <bool kCoherent, int NC>
__device__ __forceinline__ void downsampler_values(
    long long idx, const bf16* x, const bf16* w, const float* mul,
    const float* add, bf16* out, int H, int W, int cin, int cout) {
  const int Ho = H / 2, Wo = W / 2, cc = cout - cin;
  const int co0 = (int)(idx % cout);
  const long long pix = idx / cout;
  const int wo = (int)(pix % Wo);
  const int ho = (int)((pix / Wo) % Ho);
  const int b = (int)(pix / ((long long)Wo * Ho));
  const bf16* xb = x + (size_t)b * H * W * cin;

  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
  if (co0 < cc) {
    for (int kh = 0; kh < 3; ++kh) {
      const int h = 2 * ho + kh - 1;
      if (h < 0 || h >= H) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int wi = 2 * wo + kw - 1;
        if (wi < 0 || wi >= W) continue;
        const bf16* xp = xb + ((size_t)h * W + wi) * cin;
        const bf16* wp = w + (size_t)(kh * 3 + kw) * cin * cc + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = load_bf<kCoherent>(xp + ci);
#pragma unroll
          for (int j = 0; j < NC; ++j)
            if (co0 + j < cc)
              acc[j] = fmaf(xv, bf2f(wp[(size_t)ci * cc + j]), acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int co = co0 + j;
    float v = acc[j];
    if (co >= cc) {
      const int c = co - cc;
      const bf16* xp = xb + ((size_t)(2 * ho) * W + 2 * wo) * cin + c;
      const size_t row = (size_t)W * cin;
      v = fmaxf(fmaxf(load_bf<kCoherent>(xp), load_bf<kCoherent>(xp + cin)),
                fmaxf(load_bf<kCoherent>(xp + row),
                      load_bf<kCoherent>(xp + row + cin)));
    }
    out[idx + j] = f2bf(fmaxf(v * mul[co] + add[co], 0.0f));
  }
}

}  // namespace ldds
