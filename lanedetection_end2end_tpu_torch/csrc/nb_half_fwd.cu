// K6 / K7 forward: one half of a training NonBottleneck1D block.
//
// Replaces the TPU bodies `_half_a_fwd_kernel` and `_half_b_fwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_nb_block.py:198, :321). On NHWC
// (B, H, W, C) planes of one dtype T, bf16 or float32, C in {16, 64, 128}:
//
//   z    = x                                  (half A)
//   z    = T(relu(x * mul + add))             (half B: BatchNorm-1 prologue)
//   ymid = T(relu(conv3x1_d(z)    + bh))
//   yout = T(conv1x3_d(ymid)      + bw)
//   mom  = [sum yout, sum yout^2] per channel, f32, of the rounded yout
//
// Both ymid and yout are written: the backward reads them. Operands of
// type T, f32 accumulation, rounding points as in the TPU kernel (:203-206,
// :326-333), which keeps the plane's dtype: in float32 nothing is rounded.
// The TPU's (3, 128, 128) block-diagonal `kexp`, its `sel` matrix and the
// banded W-conv are lane-packing devices and are not ported: taps are
// (3, ci, co) and the moments (2, C).
//
// Bound on the card: 12*C^2 FLOP per pixel against 3 planes (x read, ymid
// and yout written). In bf16 that is 2*C FLOP per byte, below the H100's
// ~295 FLOP/byte ridge for every C here, so the bytes bound it. In float32
// it is C FLOP per byte, taken on the tensor cores as three TF32 products
// per f32 product (3xTF32, 495 / 3 = 165 TFLOP/s, ridge about 49 FLOP per
// byte): the operations bound it for C = 64 and 128, the bytes for C = 16.
//
// Design: two launches of the shared implicit-GEMM convolution (bf16:
// conv3tap.cuh, wgmma in bf16 on persistent blocks; float32:
// conv3tap_f32.cuh, wgmma in 3xTF32; both with a cp.async ring), the
// second with the moments epilogue. The intermediate
// ymid is needed by the backward anyway, so its round trip through device
// memory is no extra traffic. In both dtypes each block writes its sums
// to a partials scratch, which a third launch, fold.cuh's fixed-order
// fold, adds into `mom` (written whole): the moments reproduce themselves
// bit for bit.

#include "conv3tap_f32.cuh"

using namespace ldconv;

namespace {

struct k6k7 {};  // names the fold in a profile

template <typename T, int C>
int half_fwd(const T* x, const T* kh, const float* bh, const T* kw,
             const float* bw, const float* muladd, T* ymid, T* yout,
             float* mom, int npix, int H, int W, int d, cudaStream_t s,
             ldfold::Partials* pp) {
  const float* mul = muladd;
  const float* add = muladd ? muladd + C : nullptr;
  int rc = launch_conv<C, EPI_BIAS_RELU>(x, kh, mul, add, bh, nullptr, ymid,
                                         nullptr, npix, H, W, d, 0, s, pp);
  if (rc) return rc;
  rc = launch_conv<C, EPI_BIAS_MOM>(ymid, kw, nullptr, nullptr, bw, nullptr,
                                    yout, mom, npix, H, W, d, 1, s, pp);
  return rc ? rc : pp->fold<k6k7>(s);
}

template <typename T>
int half_fwd_entry(const void* x, const void* kh, const void* bh,
                   const void* kw, const void* bw, const void* muladd,
                   void* ymid, void* yout, void* mom, void* part, int B,
                   int H, int W, int C, int d, int part_floats,
                   void* stream) {
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
  ldfold::Partials pp(part, part_floats);
#define LD_ARGS                                                              \
  static_cast<const T*>(x), static_cast<const T*>(kh),                      \
      static_cast<const float*>(bh), static_cast<const T*>(kw),             \
      static_cast<const float*>(bw), static_cast<const float*>(muladd),     \
      static_cast<T*>(ymid), static_cast<T*>(yout),                         \
      static_cast<float*>(mom), npix, H, W, d, s, &pp
  switch (C) {
    case 16:
      return half_fwd<T, 16>(LD_ARGS);
    case 64:
      return half_fwd<T, 64>(LD_ARGS);
    case 128:
      return half_fwd<T, 128>(LD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LD_ARGS
}

template <int C>
int fwd_info(int* info) {
  const int rc = conv_info<C, EPI_BIAS_RELU, bf16>(info);
  return rc ? rc : conv_info<C, EPI_BIAS_MOM, bf16>(info + 4);
}

}  // namespace

// x, ymid, yout: (B, H, W, C) bf16 contiguous; kh, kw: (3, C, C) bf16
// [tap][ci][co]; bh, bw: (C,) f32; muladd: (2, C) f32 [mul; add] or null
// (half A); mom: (2, C) f32, written whole (any contents on entry); part:
// f32 scratch of part_floats floats for the blocks' moments
// (ops/nb_block.py::fwd_partials counts them; any contents).
LD_API int ld_nb_half_fwd(const void* x, const void* kh, const void* bh,
                          const void* kw, const void* bw, const void* muladd,
                          void* ymid, void* yout, void* mom, void* part,
                          int B, int H, int W, int C, int d, int part_floats,
                          void* stream) {
  return half_fwd_entry<bf16>(x, kh, bh, kw, bw, muladd, ymid, yout, mom,
                              part, B, H, W, C, d, part_floats, stream);
}

// The same on float32 planes and taps: x, ymid, yout, kh, kw f32.
LD_API int ld_nb_half_fwd_f32(const void* x, const void* kh, const void* bh,
                              const void* kw, const void* bw,
                              const void* muladd, void* ymid, void* yout,
                              void* mom, void* part, int B, int H, int W,
                              int C, int d, int part_floats, void* stream) {
  return half_fwd_entry<float>(x, kh, bh, kw, bw, muladd, ymid, yout, mom,
                               part, B, H, W, C, d, part_floats, stream);
}

// What the card makes of the bf16 tiles of the forward at C (16, 64 or
// 128), for a report (conv3tap.cuh's tile_info: registers, local bytes,
// blocks an SM, shared bytes): info[0..3] the first convolution (prologue,
// bias and relu), info[4..7] the second (bias and moments).
LD_API int ld_nb_half_fwd_info(int C, int* info) {
  switch (C) {
    case 16:
      return fwd_info<16>(info);
    case 64:
      return fwd_info<64>(info);
    case 128:
      return fwd_info<128>(info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
