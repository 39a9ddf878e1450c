// K3's per-output body: output values of an ERFNet UpsamplerBlock
// (inference, BatchNorm folded), shared by the standalone kernel
// (upsampler.cu, notes there) and the whole-decoder kernel
// (decoder_fused.cu). Both run this code on the same inputs, so the fused
// decoder's planes are bit for bit K3's.
//
// ConvTranspose2d(3x3, stride 2, padding 1, output_padding 1), then
// relu(acc * mul + add). Weights (kH, kW, cin, cout), unflipped: output row
// 2h' takes x[h'] * W[ky=1], row 2h'+1 takes x[h'] * W[2] + x[h'+1] * W[0]
// (the same in columns).
//
// kCoherent reads x through L2 only (load_bf, common.cuh): the fused kernel
// writes x earlier in the same launch.
#pragma once

#include "common.cuh"

namespace ldus {

// Output values idx .. idx + NC - 1 of (B, 2H, 2W, cout), channels
// fastest: NC consecutive channels of one pixel (NC divides cout and idx).
// Each value's sum runs over the same taps and ci in the same order
// whatever NC is, so NC = 1 (the standalone kernel) and a wider NC (the
// pixel's inputs loaded once for NC values) give the same bits. x: (B, H,
// W, cin); w: (3, 3, cin, cout).
template <bool kCoherent, int NC>
__device__ __forceinline__ void upsampler_values(
    long long idx, const bf16* x, const bf16* w, const float* mul,
    const float* add, bf16* out, int H, int W, int cin, int cout) {
  const int Ho = 2 * H, Wo = 2 * W;
  const int co0 = (int)(idx % cout);
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

  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
  for (int i = 0; i < nky; ++i) {
    if (hs[i] >= H) continue;
    for (int j = 0; j < nkx; ++j) {
      if (ws[j] >= W) continue;
      const bf16* xp = xb + ((size_t)hs[i] * W + ws[j]) * cin;
      const bf16* wp = w + (size_t)(kys[i] * 3 + kxs[j]) * cin * cout + co0;
      for (int ci = 0; ci < cin; ++ci) {
        const float xv = load_bf<kCoherent>(xp + ci);
#pragma unroll
        for (int k = 0; k < NC; ++k)
          acc[k] = fmaf(xv, bf2f(wp[(size_t)ci * cout + k]), acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k)
    out[idx + k] = f2bf(fmaxf(acc[k] * mul[co0 + k] + add[co0 + k], 0.0f));
}

}  // namespace ldus
