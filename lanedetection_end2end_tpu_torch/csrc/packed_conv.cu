// K11: one 3-tap convolution of a training NonBottleneck1D block, forward
// and backward, in bf16 and in float32.
//
// Replaces the TPU kernels of lanedetection_end2end_tpu/ops/
// pallas_packed_conv.py: `packed_conv_act` (`_apply_act_kernel` :149, its
// merged backward `_bwd_act_kernel` :167) and `packed_conv` (`_apply_kernel`
// :66 through `_run_apply` :109, `_wgrad_kernel` :81 through `_run_wgrad`
// :129). On NHWC (B, H, W, C) planes, C in {16, 64, 128}, taps (3, ci, co)
// with tap 0 on the row (axis 0, a 3x1 convolution) or column (axis 1, a
// 1x3 convolution) at -d; any d, including d >= H or W, where the shifted
// taps read only zeros:
//
//   packed_conv_act:  y  = [relu](conv(x, k) + b)           in x's dtype
//       backward:     dz = dy * (y > 0)  (dy itself without relu)
//                     db = sum dz (f32);  dx = convT(dz, k) in x's dtype
//                     dk = sum shift_t(x)^T dz (f32)
//   packed_conv:      y  = conv(x, k), f32, no bias
//       backward:     dx = convT(dy, k) in x's dtype, dk as above, with dy
//                     rounded to x's dtype by the caller (as the TPU kernel
//                     casts it)
//
// convT is the same convolution on the transposed taps k[2-t]^T, which the
// caller passes. Operands in the plane's dtype, f32 accumulation, rounding
// where the TPU kernels round.
//
// Bound on the card: a convolution is 6*C^2 FLOP per pixel against two
// planes (x read, y written), its backward 12*C^2 against four (x, dy, y
// read, dx written). In bf16 that is 1.5*C FLOP per byte, under the H100's
// ~295 ridge: the bytes bound it. In f32 the convolution gives 0.75*C FLOP
// per byte, taken on the tensor cores as three TF32 products per f32
// product (3xTF32, 165 TFLOP/s, ridge about 49 FLOP per byte): the
// operations bound it for C = 128, C = 64 sits at the ridge, the bytes
// bound C = 16.
//
// Design: bf16 runs the shared WMMA implicit GEMM (conv3tap.cuh) with a
// bias, bias + relu or f32-output epilogue, and the shared weight gradient
// (wgrad3tap.cuh); f32 runs the 3xTF32 tiles of conv3tap_f32.cuh. The
// backward is up to three launches: `dz_kernel` (the relu mask and the
// bias gradient in one elementwise pass, skipped for packed_conv), the
// transposed convolution and the weight gradient. dk and db are summed
// with f32 atomicAdd, so their last bits change from run to run; both must
// be zero before the call.

#include "conv3tap_f32.cuh"

using namespace ldconv;

namespace {

constexpr int EW_THREADS = 256;

// dz = MASK ? (y > 0 ? dy : 0) : dy, written only with MASK;
// db[c] += sum of dz over the pixels (f32).
template <typename T, int C, bool MASK>
__global__ void __launch_bounds__(EW_THREADS) dz_kernel(
    const T* __restrict__ dy, const T* __restrict__ y, T* __restrict__ dz,
    float* __restrict__ db, int npix) {
  constexpr int VPR = C / 8;
  constexpr int RPI = EW_THREADS / VPR;  // rows per block iteration
  __shared__ float sdb[C];
  for (int i = threadIdx.x; i < C; i += EW_THREADS) sdb[i] = 0.0f;
  __syncthreads();
  const int v = threadIdx.x % VPR;  // this thread's 8 channels never change
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  for (long long p = (long long)blockIdx.x * RPI + threadIdx.x / VPR;
       p < npix; p += (long long)gridDim.x * RPI) {
    const long long off = p * C + v * 8;
    float f[8];
    load8(dy + off, f);
    if (MASK) {
      float m[8];
      load8(y + off, m);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = m[j] > 0.0f ? f[j] : 0.0f;
      store8(dz + off, f);  // exact: f holds values of T
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += f[j];
  }
  if (fold_lanes(acc, VPR)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(&sdb[v * 8 + j], acc[j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += EW_THREADS) atomicAdd(db + i, sdb[i]);
}

// ---- forward ------------------------------------------------------------

// launch_conv and launch_wgrad take bf16 planes (conv3tap.cuh, wgrad3tap.cuh)
// or f32 ones (conv3tap_f32.cuh): the overload follows T.
template <typename T, int C>
int fwd(const T* x, const T* w, const float* bias, void* y, int npix, int H,
        int W, int d, int axis, int act, cudaStream_t s) {
  if (bias == nullptr)  // packed_conv: f32 output, no bias
    return launch_conv<C, EPI_PLAIN>(x, w, nullptr, nullptr, nullptr, nullptr,
                                     static_cast<float*>(y), nullptr, npix, H,
                                     W, d, axis, s);
  T* out = static_cast<T*>(y);
  if (act)
    return launch_conv<C, EPI_BIAS_RELU>(x, w, nullptr, nullptr, bias,
                                         nullptr, out, nullptr, npix, H, W, d,
                                         axis, s);
  return launch_conv<C, EPI_BIAS>(x, w, nullptr, nullptr, bias, nullptr, out,
                                  nullptr, npix, H, W, d, axis, s);
}

// ---- backward ------------------------------------------------------------

template <typename T, int C>
int bwd(const T* x, const T* dy, const T* y, const T* wT, T* dz, T* dx,
        float* dk, float* db, int npix, int H, int W, int d, int axis,
        int act, cudaStream_t s) {
  const T* src = dy;
  if (act || db != nullptr) {
    if (db == nullptr) return (int)cudaErrorInvalidValue;
    constexpr int RPI = EW_THREADS / (C / 8);
    const int blocks = min(grid_1d(npix, RPI), 132 * 8);
    if (act) {
      dz_kernel<T, C, true><<<blocks, EW_THREADS, 0, s>>>(dy, y, dz, db,
                                                          npix);
      src = dz;
    } else {
      dz_kernel<T, C, false><<<blocks, EW_THREADS, 0, s>>>(dy, nullptr,
                                                           nullptr, db, npix);
    }
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  int rc = launch_conv<C, EPI_PLAIN>(src, wT, nullptr, nullptr, nullptr,
                                     nullptr, dx, nullptr, npix, H, W, d,
                                     axis, s);
  if (rc) return rc;
  return launch_wgrad<C>(x, nullptr, nullptr, src, dk, npix, H, W, d, axis, s);
}

}  // namespace

// x: (B, H, W, C) contiguous, bf16 (f32 == 0) or f32 (f32 == 1); w: (3, C,
// C) of the same dtype, [tap][ci][co]; bias: (C,) f32, or null for
// packed_conv, whose y is f32; otherwise y has x's dtype. act: relu.
LD_API int ld_packed_conv_fwd(const void* x, const void* w, const void* bias,
                              void* y, int B, int H, int W, int C, int d,
                              int axis, int f32, int act, void* stream) {
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
#define LD_FWD(T, CC)                                                      \
  fwd<T, CC>(static_cast<const T*>(x), static_cast<const T*>(w), b, y,    \
             npix, H, W, d, axis, act, s)
#define LD_DISPATCH(T)           \
  switch (C) {                   \
    case 16:                     \
      return LD_FWD(T, 16);      \
    case 64:                     \
      return LD_FWD(T, 64);      \
    case 128:                    \
      return LD_FWD(T, 128);     \
    default:                     \
      return (int)cudaErrorInvalidValue; \
  }
  if (f32) {
    LD_DISPATCH(float)
  }
  LD_DISPATCH(bf16)
#undef LD_DISPATCH
#undef LD_FWD
}

// x, dy, dx, and y and dz with act (else null): (B, H, W, C) contiguous of
// one dtype (bf16 or f32, as above; dz is scratch); wT: (3, C, C) of that
// dtype, wT[t] = k[2-t]^T; dk: (3, C, C) f32; db: (C,) f32, or null for
// packed_conv (which passes act = 0). dk and db zero on entry.
LD_API int ld_packed_conv_bwd(const void* x, const void* dy, const void* y,
                              const void* wT, void* dz, void* dx, void* dk,
                              void* db, int B, int H, int W, int C, int d,
                              int axis, int f32, int act, void* stream) {
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
#define LD_BWD(T, CC)                                                       \
  bwd<T, CC>(static_cast<const T*>(x), static_cast<const T*>(dy),           \
             static_cast<const T*>(y), static_cast<const T*>(wT),           \
             static_cast<T*>(dz), static_cast<T*>(dx),                      \
             static_cast<float*>(dk), static_cast<float*>(db), npix, H, W, \
             d, axis, act, s)
#define LD_DISPATCH(T)           \
  switch (C) {                   \
    case 16:                     \
      return LD_BWD(T, 16);      \
    case 64:                     \
      return LD_BWD(T, 64);      \
    case 128:                    \
      return LD_BWD(T, 128);     \
    default:                     \
      return (int)cudaErrorInvalidValue; \
  }
  if (f32) {
    LD_DISPATCH(float)
  }
  LD_DISPATCH(bf16)
#undef LD_DISPATCH
#undef LD_BWD
}
