// K9 lane_maps_op: the training ConvTranspose ops ahead of their BatchNorm
// (the two upsamplers, 3x3/s2/p1/op1) and the 2x2/s2 output head where the
// e2e tail is not fused, forward and backward.
//
// Replaces the TPU bodies `_fwd_kernel` and `_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_lanemaps.py:83, :100; the op at
// :167), which compute two output row phases with lane-map matmuls (the
// column phases folded into the maps) and interleave them. Here, on NHWC
// planes of one type T, bf16 or float32, with the ConvTranspose2d
// parameter (cin, cout, k, k), unflipped:
//
//   forward   y = ConvTranspose(x) + bias, rounded once to bf16 or kept
//             f32 (float32 planes: f32 only), written once at
//             (B, 2H, 2W, cout);
//             mom = [sum y; sum y^2] of the rounded y, when asked for
//   backward  dyv = dy + ds1 + 2 * y * ds2 in f32 (dy alone without
//             moments);  dbias = sum dyv;  dp = T(dyv)
//             dx = T(stride-2 convolution of dp with the weight)
//             dweight[ci][co][ky][kx] = sum_pixels x * dp
//
// torch's transposed convolution writes x[h] into output row 2h - pad + ky:
// an even output row of the 3x3 op takes one tap, an odd row two, and the
// same in columns (`gather_small` in conv_s2.cuh walks the taps of the
// pixel's parity).
//
// Bound on the card: forward reads x and writes y (four times the pixels);
// backward reads x, y, dy and writes dx; at most ~190 FLOP per byte in
// bf16 (128 -> 64), under the ~295 FLOP/byte ridge: bytes; in float32 half
// that, above the ~49 FLOP/byte ridge of three TF32 products (165
// TFLOP/s): operations for the two upsamplers.
//
// Design. The two upsamplers (128 -> 64, 64 -> 16, k = 3) run on the
// tensor cores (conv_s2_mma.cuh): the forward is the transposed
// convolution by output parity (`op_k9_fwd`, N = cout), whose epilogue adds
// the bias, rounds once and reduces the moments in the block, one
// atomicAdd per block and channel; the input gradient the 3x3/s2 implicit
// GEMM over dp (`op_k9_dx`, N = cin); the weight gradient a GEMM per tap.
// The 2x2 head (16 -> 4: an N of 4 would leave the tensor-core tile mostly
// padding, and the plane is bound by its bytes) stays on conv_s2.cuh's
// gathers: one thread per output value, channel fastest, grid-stride so
// each thread stays on one channel. The entries take no other shape.
// Backward: three launches (dyv fold,
// dx, weight gradient). f32 atomics make the last bits of mom, dbias and
// dweight depend on the order blocks finish in. Every f32 output must be
// zero before the call.

#include "conv_s2_mma.cuh"

using namespace lds2;

namespace {

// x: (B, H, W, cin); wt: (k, k, cin, cout); y: (B, 2H, 2W, cout);
// mom: (2, cout) or null
template <typename T, typename TOut>
__global__ void __launch_bounds__(EW_THREADS) lm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wt,
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
    const T* xb = x + (size_t)b * H * W * cin;
    const float v =
        gather_small(xb, wt, H, W, cin, cin, cout, k, pad, Y, X, co) +
        bias[co];
    const float f = stf(y, i, v);  // moments of the value as stored
    s0 += f;
    s1 += f * f;
  }
  if (mom != nullptr) block_channel_add(s0, s1, cout, mom, mom + cout);
}

// The forward on the tensor cores: the transposed convolution of x (the
// small plane, `small` = x) by output parity, bias, one rounding to TOut,
// the moments of the rounded y when mom is given. wt: (3, 3, cin, cout);
// y: (B, 2H, 2W, cout).
template <typename T, typename TOut>
struct op_k9_fwd : PhaseGeo<T> {
  const T* wt;
  const float* bias;
  TOut* y;
  float* mom;
  int cout;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int phase, float* red) const {
    float s0[NT][2], s1[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + tile_row(h);
      if (p >= this->npix) continue;
      const Pix q = pix_of(p, this->npix, this->Hs, this->Ws);
      TOut* yr = y + this->out_pixel(q, p, phase) * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = tile_col(j);
        float f0, f1;
        stf2(yr + n, acc[j][2 * h] + bias[n], acc[j][2 * h + 1] + bias[n + 1],
             f0, f1);
        s0[j][0] += f0;
        s0[j][1] += f1;
        s1[j][0] += f0 * f0;
        s1[j][1] += f1 * f1;
      }
    }
    if (mom == nullptr) return;
    fold_channels(s0, red);
    fold_channels(s1, red + cout);
    __syncthreads();
    flush_moments(red, cout, mom);
  }
};

// The input gradient on the tensor cores: the 3x3/s2/p1 convolution of dp
// (the large plane, `large` = dp), rounded once. wt: (3, 3, cout, cin);
// dx: (B, H, W, cin).
template <typename T>
struct op_k9_dx : ConvGeo<T> {
  const T* wt;
  T* dx;
  int cin;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int, float*) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + tile_row(h);
      if (p >= this->npix) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float f0, f1;
        stf2(dx + (size_t)p * cin + tile_col(j), acc[j][2 * h],
             acc[j][2 * h + 1], f0, f1);
      }
    }
  }
};

template <typename T, typename TOut>
int lm_fwd(const void* x, const void* wt, const void* bias, void* y,
           void* mom, int B, int H, int W, int cin, int cout, int k, int pad,
           cudaStream_t s) {
  if (k == 3) {
    op_k9_fwd<T, TOut> op;
    op.small = static_cast<const T*>(x);
    op.npix = B * H * W;
    op.Hs = H;
    op.Ws = W;
    op.CST = cin;
    op.wt = static_cast<const T*>(wt);
    op.bias = static_cast<const float*>(bias);
    op.y = static_cast<TOut*>(y);
    op.mom = static_cast<float*>(mom);
    op.cout = cout;
    return cin == 128 ? launch_s2_gemm<T, 128, 64>(op, 4, s)
                      : launch_s2_gemm<T, 64, 16>(op, 4, s);
  }
  const long long n = (long long)B * 4 * H * W * cout;
  lm_fwd_kernel<T, TOut><<<ew_blocks(n), EW_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt),
      static_cast<const float*>(bias), static_cast<TOut*>(y),
      static_cast<float*>(mom), B, H, W, cin, cout, k, pad);
  return (int)cudaGetLastError();
}

// k = 3 (pad 1) takes the two upsamplers, on the tensor cores; k = 2 (pad
// 0) the channels the gathers and their 16 x 16 weight-gradient tile take
bool bad_geometry(int cin, int cout, int k, int pad) {
  const bool up = (cin == 128 && cout == 64) || (cin == 64 && cout == 16);
  return EW_THREADS % cout != 0 ||
         !((k == 3 && pad == 1 && up) ||
           (k == 2 && pad == 0 && cin <= 16 && cout <= 16));
}

// dyv fold, input gradient and weight gradient on planes of type T; dy
// and y of type TOut.
template <typename T, typename TOut>
int lm_bwd(const void* x, const void* y, const void* dy, const void* dmom,
           const void* wt, void* dp, void* dx, void* dweight, void* dbias,
           int B, int H, int W, int cin, int cout, int k, int pad,
           cudaStream_t s) {
  const long long n = (long long)B * 4 * H * W * cout;
  T* dpt = static_cast<T*>(dp);
  const T* xt = static_cast<const T*>(x);
  float* dw = static_cast<float*>(dweight);
  int rc = launch_dyv_fold<op_k9>(static_cast<const TOut*>(dy),
                                  static_cast<const TOut*>(y),
                                  static_cast<const float*>(dmom), dpt,
                                  static_cast<float*>(dbias), n, cout, s);
  if (rc) return rc;
  if (k == 2) {
    rc = launch_l2s<op_k9>(static_cast<const T*>(dpt),
                           static_cast<const T*>(wt), static_cast<T*>(dx), B,
                           H, W, cout, cin, k, pad, s);
    if (rc) return rc;
    return launch_wgrad_s2<op_k9>(xt, static_cast<const T*>(dpt), dw, B, H, W,
                                  cin, cin, cout, k, pad, s);
  }
  op_k9_dx<T> op;
  op.large = dpt;
  op.npix = B * H * W;
  op.Hs = H;
  op.Ws = W;
  op.CL = cout;
  op.wt = static_cast<const T*>(wt);
  op.dx = static_cast<T*>(dx);
  op.cin = cin;
  if (cin == 128) {
    rc = launch_s2_gemm<T, 64, 128>(op, 1, s);
    if (rc) return rc;
    return launch_s2_wgrad<T, 128, 64, op_k9>(xt, dpt, dw, B, H, W, cin, cin,
                                              s);
  }
  rc = launch_s2_gemm<T, 16, 64>(op, 1, s);
  if (rc) return rc;
  return launch_s2_wgrad<T, 64, 16, op_k9>(xt, dpt, dw, B, H, W, cin, cin, s);
}

}  // namespace

// x: (B, H, W, cin) bf16; wt: (k, k, cin, cout) bf16 [ky][kx][ci][co];
// bias: (cout,) f32; y: (B, 2H, 2W, cout) bf16, or f32 when out_f32;
// mom: (2, cout) f32, zero on entry, or null. k = 3 (pad 1): (cin, cout)
// is (128, 64) or (64, 16); k = 2 (pad 0): cin, cout <= 16, 256 % cout ==
// 0.
LD_API int ld_lane_maps_op_fwd(const void* x, const void* wt,
                               const void* bias, void* y, void* mom, int B,
                               int H, int W, int cin, int cout, int k,
                               int pad, int out_f32, void* stream) {
  if (bad_geometry(cin, cout, k, pad)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? lm_fwd<bf16, float>(x, wt, bias, y, mom, B, H, W, cin,
                                       cout, k, pad, s)
                 : lm_fwd<bf16, bf16>(x, wt, bias, y, mom, B, H, W, cin,
                                      cout, k, pad, s);
}

// The same on float32 planes and taps (x, wt f32); y is f32, and out_f32
// must be 1.
LD_API int ld_lane_maps_op_fwd_f32(const void* x, const void* wt,
                                   const void* bias, void* y, void* mom,
                                   int B, int H, int W, int cin, int cout,
                                   int k, int pad, int out_f32,
                                   void* stream) {
  if (bad_geometry(cin, cout, k, pad) || !out_f32)
    return (int)cudaErrorInvalidValue;
  return lm_fwd<float, float>(x, wt, bias, y, mom, B, H, W, cin, cout, k,
                              pad, static_cast<cudaStream_t>(stream));
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
  if (bad_geometry(cin, cout, k, pad)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? lm_bwd<bf16, float>(x, y, dy, dmom, wt, dp, dx, dweight,
                                       dbias, B, H, W, cin, cout, k, pad, s)
                 : lm_bwd<bf16, bf16>(x, y, dy, dmom, wt, dp, dx, dweight,
                                      dbias, B, H, W, cin, cout, k, pad, s);
}

// The same on float32 planes and taps: x, y, dy, wt, dp, dx f32, and
// out_f32 must be 1.
LD_API int ld_lane_maps_op_bwd_f32(const void* x, const void* y,
                                   const void* dy, const void* dmom,
                                   const void* wt, void* dp, void* dx,
                                   void* dweight, void* dbias, int B, int H,
                                   int W, int cin, int cout, int k, int pad,
                                   int out_f32, void* stream) {
  if (bad_geometry(cin, cout, k, pad) || !out_f32)
    return (int)cudaErrorInvalidValue;
  return lm_bwd<float, float>(x, y, dy, dmom, wt, dp, dx, dweight, dbias, B,
                              H, W, cin, cout, k, pad,
                              static_cast<cudaStream_t>(stream));
}
