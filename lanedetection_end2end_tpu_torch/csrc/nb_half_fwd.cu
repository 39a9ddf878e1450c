// K6 / K7 forward: one half of a training NonBottleneck1D block.
//
// Replaces the TPU bodies `_half_a_fwd_kernel` and `_half_b_fwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_nb_block.py:198, :321). On NHWC
// bf16 (B, H, W, C), C in {16, 64, 128}:
//
//   z    = x                                  (half A)
//   z    = bf16(relu(x * mul + add))          (half B: BatchNorm-1 prologue)
//   ymid = bf16(relu(conv3x1_d(z)    + bh))
//   yout = bf16(conv1x3_d(ymid)      + bw)
//   mom  = [sum yout, sum yout^2] per channel, f32, of the rounded yout
//
// Both ymid and yout are written: the backward reads them. bf16 operands,
// f32 accumulation, rounding points as in the TPU kernel (:203-206,
// :326-333). The TPU's (3, 128, 128) block-diagonal `kexp`, its `sel`
// matrix and the banded W-conv are lane-packing devices and are not
// ported: taps are (3, ci, co) and the moments (2, C).
//
// Bound on the card: 12*C^2 FLOP per pixel against 3 planes of bf16
// (x read, ymid and yout written): 2*C FLOP per byte, below the H100's
// ~295 FLOP/byte ridge for every C here, so the bytes bound it.
//
// Design: two launches of the shared implicit-GEMM convolution
// (conv3tap.cuh), the second with the moments epilogue. The intermediate
// ymid is needed by the backward anyway, so its round trip through device
// memory is no extra traffic. `mom` must be zero before the call.

#include "conv3tap.cuh"

using namespace ldconv;

namespace {

template <int C>
int half_fwd(const bf16* x, const bf16* kh, const float* bh, const bf16* kw,
             const float* bw, const float* muladd, bf16* ymid, bf16* yout,
             float* mom, int npix, int H, int W, int d, cudaStream_t s) {
  const float* mul = muladd;
  const float* add = muladd ? muladd + C : nullptr;
  int rc = launch_conv<C, EPI_BIAS_RELU>(x, kh, mul, add, bh, nullptr, ymid,
                                         nullptr, npix, H, W, d, 0, s);
  if (rc) return rc;
  return launch_conv<C, EPI_BIAS_MOM>(ymid, kw, nullptr, nullptr, bw, nullptr,
                                      yout, mom, npix, H, W, d, 1, s);
}

}  // namespace

// x, ymid, yout: (B, H, W, C) bf16 contiguous; kh, kw: (3, C, C) bf16
// [tap][ci][co]; bh, bw: (C,) f32; muladd: (2, C) f32 [mul; add] or null
// (half A); mom: (2, C) f32, zero on entry.
LD_API int ld_nb_half_fwd(const void* x, const void* kh, const void* bh,
                          const void* kw, const void* bw, const void* muladd,
                          void* ymid, void* yout, void* mom, int B, int H,
                          int W, int C, int d, void* stream) {
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
#define LD_ARGS                                                              \
  static_cast<const bf16*>(x), static_cast<const bf16*>(kh),                \
      static_cast<const float*>(bh), static_cast<const bf16*>(kw),          \
      static_cast<const float*>(bw), static_cast<const float*>(muladd),     \
      static_cast<bf16*>(ymid), static_cast<bf16*>(yout),                   \
      static_cast<float*>(mom), npix, H, W, d, s
  switch (C) {
    case 16:
      return half_fwd<16>(LD_ARGS);
    case 64:
      return half_fwd<64>(LD_ARGS);
    case 128:
      return half_fwd<128>(LD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LD_ARGS
}
