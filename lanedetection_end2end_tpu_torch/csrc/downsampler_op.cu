// K8 downsampler_op: the training DownsamplerBlock ahead of its BatchNorm,
// forward and backward.
//
// Replaces the TPU bodies `_ds_fwd_kernel` and `_ds_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_lanemaps.py:265, :290; the op at
// :371), which run the strided convolution as lane-map matmuls over the
// three row taps and the pool as a where-chain plus a 0/1 selection matmul.
// Here, on NHWC planes of one type T (bf16 or float32; T(v) rounds to it,
// the identity in float32) with cc = cout - cin conv channels first:
//
//   forward   y[.., co]   = T(conv3x3_s2_p1(x)[co] + bias[co])      co < cc
//             y[.., cc+c] = maxpool2x2(x)[c]
//             mom = [sum y; sum y^2] per channel, of the rounded y
//   backward  dyv = dy + ds1 + 2 * y * ds2 (f32);  dbias = sum dyv[.., :cc]
//             dz = T(dyv)
//             dx = T(convT(dz[.., :cc]) + the pool gradient dz[.., cc:]
//                  at the one element of each window the where-chain picks)
//             dweight[co][ci][kh][kw] = sum_pixels x * dz[.., :cc]
//
// The where-chain, recomputed from x and compared in f32: in each column
// the upper row wins if it is >= the lower; then the left column's winner
// if it is >= the right's. The input gradient sums in f32 and rounds once
// (the TPU kernel rounds each lane map's product and sums in bf16).
//
// Bound on the card: forward reads x and writes y (a quarter of the pixels
// at cout channels); backward reads x, y, dy and writes dx; up to 96 FLOP
// per byte forward in bf16 (64 -> 128), under the ~295 FLOP/byte ridge:
// bytes; in float32 48 FLOP per byte against the ~20 of FFMA: operations
// for 64 -> 128, bytes for the first two.
//
// Design: the pieces of conv_s2.cuh. Forward: one thread per output value,
// channel fastest, a grid-stride walk that keeps each thread on one channel
// so the moments reduce in the block and reach `mom` with one atomicAdd per
// block and channel. Backward: three launches (dyv fold, dx, weight
// gradient); dx is skipped when the caller passes no buffer (the images
// need no gradient). f32 atomics make the last bits of mom, dbias and
// dweight depend on the order blocks finish in. Every f32 output must be
// zero before the call.

#include "conv_s2.cuh"

using namespace lds2;

namespace {

struct PoolPick {
  float value;
  int row, col;  // the element of the 2x2 window that holds it
};

// xp: element (0, 0) of the window for this channel; step to the next
// column is cin, to the next row W * cin.
template <typename T>
__device__ __forceinline__ PoolPick pool_chain(const T* xp, size_t col,
                                               size_t row) {
  const float a00 = ldf(xp, 0), a01 = ldf(xp, col);
  const float a10 = ldf(xp, row), a11 = ldf(xp, row + col);
  const bool up0 = a00 >= a10, up1 = a01 >= a11;
  const float p0 = up0 ? a00 : a10, p1 = up1 ? a01 : a11;
  const bool left = p0 >= p1;
  return {left ? p0 : p1, (left ? up0 : up1) ? 0 : 1, left ? 0 : 1};
}

// x: (B, H, W, cin); wt: (3, 3, cin, cc); y: (B, H/2, W/2, cout);
// mom: (2, cout)
template <typename T>
__global__ void __launch_bounds__(EW_THREADS) ds_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wt,
    const float* __restrict__ bias, T* __restrict__ y,
    float* __restrict__ mom, int B, int H, int W, int cin, int cout) {
  const int Ho = H / 2, Wo = W / 2, cc = cout - cin;
  const long long n = (long long)B * Ho * Wo * cout;
  float s0 = 0.0f, s1 = 0.0f;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EW_THREADS) {
    const int co = (int)(i % cout);
    const long long pix = i / cout;
    const int wo = (int)(pix % Wo), ho = (int)((pix / Wo) % Ho);
    const int b = (int)(pix / ((long long)Wo * Ho));
    const T* xb = x + (size_t)b * H * W * cin;
    float v;
    if (co < cc) {
      v = gather_large(xb, wt, H, W, cin, cc, 3, 1, ho, wo, co) + bias[co];
    } else {
      v = pool_chain(xb + ((size_t)(2 * ho) * W + 2 * wo) * cin + (co - cc),
                     cin, (size_t)W * cin)
              .value;
    }
    const float f = stf(y, i, v);  // moments of the rounded value
    s0 += f;
    s1 += f * f;
  }
  block_channel_add(s0, s1, cout, mom, mom + cout);
}

// dz: (B, H/2, W/2, cout); wt: (3, 3, cc, cin); dx: (B, H, W, cin)
template <typename T>
__global__ void __launch_bounds__(EW_THREADS) ds_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ dz,
    const T* __restrict__ wt, T* __restrict__ dx, int B, int H, int W,
    int cin, int cout) {
  const int Ho = H / 2, Wo = W / 2, cc = cout - cin;
  const long long n = (long long)B * H * W * cin;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EW_THREADS) {
    const int ci = (int)(i % cin);
    const long long pix = i / cin;
    const int wi = (int)(pix % W), hi = (int)((pix / W) % H);
    const int b = (int)(pix / ((long long)W * H));
    const T* dzb = dz + (size_t)b * Ho * Wo * cout;
    float acc = gather_small(dzb, wt, Ho, Wo, cout, cc, cin, 3, 1, hi, wi, ci);
    const int ho = hi >> 1, wo = wi >> 1;
    const T* xp = x + (((size_t)b * H + 2 * ho) * W + 2 * wo) * cin + ci;
    const PoolPick pick = pool_chain(xp, cin, (size_t)W * cin);
    if ((hi & 1) == pick.row && (wi & 1) == pick.col)
      acc += ldf(dzb, ((long long)ho * Wo + wo) * cout + cc + ci);
    stf(dx, i, acc);
  }
}

template <typename T>
int ds_fwd(const void* x, const void* wt, const void* bias, void* y,
           void* mom, int B, int H, int W, int cin, int cout, void* stream) {
  if (cout <= cin || EW_THREADS % cout != 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * (H / 2) * (W / 2) * cout;
  ds_fwd_kernel<T><<<ew_blocks(n), EW_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(mom), B, H, W, cin, cout);
  return (int)cudaGetLastError();
}

template <typename T>
int ds_bwd(const void* x, const void* y, const void* dy, const void* dmom,
           const void* wt, void* dz, void* dx, void* dweight, void* dbias,
           int B, int H, int W, int cin, int cout, void* stream) {
  if (cout <= cin || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int Ho = H / 2, Wo = W / 2, cc = cout - cin;
  const T* xb = static_cast<const T*>(x);
  T* dzb = static_cast<T*>(dz);
  int rc = launch_dyv_fold(static_cast<const T*>(dy),
                           static_cast<const T*>(y),
                           static_cast<const float*>(dmom), dzb,
                           static_cast<float*>(dbias),
                           (long long)B * Ho * Wo * cout, cout, s);
  if (rc) return rc;
  if (dx != nullptr) {
    ds_dx_kernel<T><<<ew_blocks((long long)B * H * W * cin), EW_THREADS, 0,
                      s>>>(xb, dzb, static_cast<const T*>(wt),
                           static_cast<T*>(dx), B, H, W, cin, cout);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return launch_wgrad_s2(static_cast<const T*>(dzb), xb,
                         static_cast<float*>(dweight), B, Ho, Wo, cout, cc,
                         cin, 3, 1, s);
}

}  // namespace

// x: (B, H, W, cin) bf16; wt: (3, 3, cin, cc) bf16 [kh][kw][ci][co];
// bias: (cc,) f32; y: (B, H/2, W/2, cout) bf16; mom: (2, cout) f32, zero on
// entry. 256 % cout == 0.
LD_API int ld_downsampler_op_fwd(const void* x, const void* wt,
                                 const void* bias, void* y, void* mom, int B,
                                 int H, int W, int cin, int cout,
                                 void* stream) {
  return ds_fwd<bf16>(x, wt, bias, y, mom, B, H, W, cin, cout, stream);
}

// The same on float32 planes and taps: x, wt, y f32.
LD_API int ld_downsampler_op_fwd_f32(const void* x, const void* wt,
                                     const void* bias, void* y, void* mom,
                                     int B, int H, int W, int cin, int cout,
                                     void* stream) {
  return ds_fwd<float>(x, wt, bias, y, mom, B, H, W, cin, cout, stream);
}

// x as above; y, dy, dz: (B, H/2, W/2, cout) bf16 (dz scratch); dmom:
// (2, cout) f32; wt: (3, 3, cc, cin) bf16 [kh][kw][co][ci]; dx: (B, H, W,
// cin) bf16 or null (skipped); dweight: (cc, cin, 3, 3) f32 and dbias:
// (cout,) f32 (its first cc entries are the bias gradient), zero on entry.
LD_API int ld_downsampler_op_bwd(const void* x, const void* y, const void* dy,
                                 const void* dmom, const void* wt, void* dz,
                                 void* dx, void* dweight, void* dbias, int B,
                                 int H, int W, int cin, int cout,
                                 void* stream) {
  return ds_bwd<bf16>(x, y, dy, dmom, wt, dz, dx, dweight, dbias, B, H, W,
                      cin, cout, stream);
}

// The same on float32 planes and taps: x, y, dy, wt, dz, dx f32.
LD_API int ld_downsampler_op_bwd_f32(const void* x, const void* y,
                                     const void* dy, const void* dmom,
                                     const void* wt, void* dz, void* dx,
                                     void* dweight, void* dbias, int B,
                                     int H, int W, int cin, int cout,
                                     void* stream) {
  return ds_bwd<float>(x, y, dy, dmom, wt, dz, dx, dweight, dbias, B, H, W,
                       cin, cout, stream);
}
