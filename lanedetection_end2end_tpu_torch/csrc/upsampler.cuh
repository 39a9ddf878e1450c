// K3's device code: an ERFNet UpsamplerBlock (inference, BatchNorm
// folded), shared by the standalone kernel (upsampler.cu, notes there) and
// the whole-decoder kernel (decoder_fused.cu). Both run this code on the
// same inputs, so the fused decoder's planes are bit for bit K3's.
//
// ConvTranspose2d(3x3, stride 2, padding 1, output_padding 1), then
// bf16(relu(acc * mul + add)), on the tensor-core tile of K9
// (conv_s2_mma.cuh, PhaseGeo): the transposed convolution split by output
// parity (py, px) into four dense convolutions of the small plane with 1,
// 2, 2 and 4 taps (an even output row takes tap ky = 1 at h, an odd one ky
// = 0 at h + 1 and ky = 2 at h; columns alike), their rows interleaved by
// the epilogue `op_us_serve` into the large plane at (2h + py, 2w + px).
// Weights (kH, kW, cin, cout), unflipped: the (9, CK, N) taps-first order
// the tile reads.
#pragma once

#include "downsampler.cuh"

namespace ldus {

// The serving epilogue of the parity-phase tile (x = `small`, N = cout).
// y: (B, 2Hs, 2Ws, cout).
struct op_us_serve : lds2::PhaseGeo<bf16> {
  const bf16* wt;
  const float* mul;
  const float* add;
  bf16* y;
  int cout;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int phase, float*) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + lds2::tile_row(h);
      if (p >= npix) continue;
      const lds2::Pix q = lds2::pix_of(p, npix, Hs, Ws);
      bf16* yr = y + out_pixel(q, p, phase) * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = lds2::tile_col(j);
        store_bf2(yr + n, bn_relu(acc[j][2 * h], mul[n], add[n]),
                  bn_relu(acc[j][2 * h + 1], mul[n + 1], add[n + 1]));
      }
    }
  }
};

// x (B, H, W, cin) -> y (B, 2H, 2W, cout); w: (3, 3, cin, cout)
__host__ __device__ inline op_us_serve us_op(const bf16* x, const bf16* w,
                                             const float* mul,
                                             const float* add, bf16* y,
                                             int B, int H, int W, int cin,
                                             int cout) {
  op_us_serve op;
  op.small = x;
  op.Hs = H;
  op.Ws = W;
  op.npix = B * H * W;
  op.CST = cin;
  op.wt = w;
  op.mul = mul;
  op.add = add;
  op.y = y;
  op.cout = cout;
  return op;
}

}  // namespace ldus
