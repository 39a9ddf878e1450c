// K9 lane_maps_op: the training ConvTranspose ops ahead of their BatchNorm
// (the two upsamplers, 3x3/s2/p1/op1) and the 2x2/s2 output head where the
// e2e tail is not fused, forward and backward.
//
// Replaces the TPU bodies `_fwd_kernel` and `_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_lanemaps.py:83, :100; the op at
// :167), which compute two output row phases with lane-map matmuls (the
// column phases folded into the maps) and interleave them. Here, on NHWC
// bf16 with the ConvTranspose2d parameter (cin, cout, k, k), unflipped:
//
//   forward   y = ConvTranspose(x) + bias, rounded once to bf16 or kept
//             f32, written once at (B, 2H, 2W, cout);
//             mom = [sum y; sum y^2] of the rounded y, when asked for
//   backward  dyv = dy + ds1 + 2 * y * ds2 in f32 (dy alone without
//             moments);  dbias = sum dyv;  dp = bf16(dyv)
//             dx = bf16(stride-2 convolution of dp with the weight)
//             dweight[ci][co][ky][kx] = sum_pixels x * dp
//
// torch's transposed convolution writes x[h] into output row 2h - pad + ky:
// an even output row of the 3x3 op takes one tap, an odd row two, and the
// same in columns (`gather_small` in conv_s2.cuh walks the taps of the
// pixel's parity).
//
// Bound on the card: forward reads x and writes y (four times the pixels);
// backward reads x, y, dy and writes dx; at most ~190 FLOP per byte
// (128 -> 64), under the ~295 FLOP/byte ridge: bytes.
//
// Design: the pieces of conv_s2.cuh. Forward: one thread per output value,
// channel fastest, grid-stride so each thread stays on one channel and the
// moments reduce in the block. Backward: three launches (dyv fold, dx,
// weight gradient). f32 atomics make the last bits of mom, dbias and
// dweight depend on the order blocks finish in. Every f32 output must be
// zero before the call.

#include "conv_s2.cuh"

using namespace lds2;

namespace {

// x: (B, H, W, cin); wt: (k, k, cin, cout); y: (B, 2H, 2W, cout);
// mom: (2, cout) or null
template <typename TOut>
__global__ void __launch_bounds__(EW_THREADS) lm_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wt,
    const float* __restrict__ bias, TOut* __restrict__ y,
    float* __restrict__ mom, int B, int H, int W, int cin, int cout, int k,
    int pad) {
  const int Ho = 2 * H, Wo = 2 * W;
  const long long n = (long long)B * Ho * Wo * cout;
  float s0 = 0.0f, s1 = 0.0f;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EW_THREADS) {
    const int co = (int)(i % cout);
    const long long pix = i / cout;
    const int X = (int)(pix % Wo), Y = (int)((pix / Wo) % Ho);
    const int b = (int)(pix / ((long long)Wo * Ho));
    const bf16* xb = x + (size_t)b * H * W * cin;
    const float v =
        gather_small(xb, wt, H, W, cin, cin, cout, k, pad, Y, X, co) +
        bias[co];
    const float f = stf(y, i, v);  // moments of the value as stored
    s0 += f;
    s1 += f * f;
  }
  if (mom != nullptr) block_channel_add(s0, s1, cout, mom, mom + cout);
}

template <typename TOut>
int lm_fwd(const void* x, const void* wt, const void* bias, void* y,
           void* mom, int B, int H, int W, int cin, int cout, int k, int pad,
           cudaStream_t s) {
  const long long n = (long long)B * 4 * H * W * cout;
  lm_fwd_kernel<TOut><<<ew_blocks(n), EW_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
      static_cast<const float*>(bias), static_cast<TOut*>(y),
      static_cast<float*>(mom), B, H, W, cin, cout, k, pad);
  return (int)cudaGetLastError();
}

bool bad_geometry(int cout, int k, int pad) {
  return EW_THREADS % cout != 0 || !((k == 3 && pad == 1) ||
                                     (k == 2 && pad == 0));
}

}  // namespace

// x: (B, H, W, cin) bf16; wt: (k, k, cin, cout) bf16 [ky][kx][ci][co];
// bias: (cout,) f32; y: (B, 2H, 2W, cout) bf16, or f32 when out_f32;
// mom: (2, cout) f32, zero on entry, or null. 256 % cout == 0.
LD_API int ld_lane_maps_op_fwd(const void* x, const void* wt,
                               const void* bias, void* y, void* mom, int B,
                               int H, int W, int cin, int cout, int k,
                               int pad, int out_f32, void* stream) {
  if (bad_geometry(cout, k, pad)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? lm_fwd<float>(x, wt, bias, y, mom, B, H, W, cin, cout, k,
                                 pad, s)
                 : lm_fwd<bf16>(x, wt, bias, y, mom, B, H, W, cin, cout, k,
                                pad, s);
}

// x as above; y, dy: (B, 2H, 2W, cout) bf16, or f32 when out_f32 (y is read
// only with dmom); dmom: (2, cout) f32 or null; wt: (k, k, cout, cin) bf16
// [ky][kx][co][ci]; dp: (B, 2H, 2W, cout) bf16 scratch; dx: (B, H, W, cin)
// bf16; dweight: (cin, cout, k, k) f32 and dbias: (cout,) f32, zero on
// entry.
LD_API int ld_lane_maps_op_bwd(const void* x, const void* y, const void* dy,
                               const void* dmom, const void* wt, void* dp,
                               void* dx, void* dweight, void* dbias, int B,
                               int H, int W, int cin, int cout, int k,
                               int pad, int out_f32, void* stream) {
  if (bad_geometry(cout, k, pad)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * 4 * H * W * cout;
  const float* dm = static_cast<const float*>(dmom);
  bf16* dpb = static_cast<bf16*>(dp);
  float* db = static_cast<float*>(dbias);
  int rc = out_f32 ? launch_dyv_fold(static_cast<const float*>(dy),
                                     static_cast<const float*>(y), dm, dpb,
                                     db, n, cout, s)
                   : launch_dyv_fold(static_cast<const bf16*>(dy),
                                     static_cast<const bf16*>(y), dm, dpb, db,
                                     n, cout, s);
  if (rc) return rc;
  rc = launch_l2s(dpb, static_cast<const bf16*>(wt), static_cast<bf16*>(dx),
                  B, H, W, cout, cin, k, pad, s);
  if (rc) return rc;
  return launch_wgrad_s2(static_cast<const bf16*>(x), dpb,
                         static_cast<float*>(dweight), B, H, W, cin, cin,
                         cout, k, pad, s);
}
