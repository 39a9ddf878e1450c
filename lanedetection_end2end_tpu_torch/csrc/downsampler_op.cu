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
// bytes; in float32 48 FLOP per byte, at the ~49 FLOP/byte ridge of three
// TF32 products (165 TFLOP/s): operations for 64 -> 128, bytes for the
// first two.
//
// Design. The second and third downsamplers (16 -> 64, 64 -> 128) run on
// the tensor cores (conv_s2_mma.cuh): the forward is an implicit GEMM over
// the 3x3/s2 taps of x (`op_k8_fwd`, N = cc) whose epilogue adds the bias,
// rounds once, writes the pool channels from the same windows of x and
// reduces the moments in the block to its row of a partials scratch;
// the input gradient is the transposed convolution by output parity
// (`op_k8_dx`, N = cin), whose epilogue adds the pool gradient at the
// where-chain's pick; the weight gradient a GEMM per tap. The first
// downsampler (cin = 3: a K of 27, a 6- or 12-byte channel run, bound by
// the image's bytes) runs on FFMA kernels of its own that read each 3x3
// window of the image once (`ds1_fwd_kernel`, `ds1_wgrad_kernel`); its
// input gradient, which no train step asks for, on conv_s2.cuh's gather
// (one thread per output value). The entries take no other shape.
// Backward: three launches (dyv fold, dx, weight gradient); dx is skipped
// when the caller passes no buffer (the images need no gradient). No
// atomics: the blocks write their sums (mom; dbias, dweight) to a
// partials scratch in an order fixed inside each block, and a last launch
// of each entry, fold.cuh's fixed-order fold, adds them into the f32
// outputs, which it writes whole: they reproduce themselves bit for bit.

#include "conv_s2_mma.cuh"

using namespace lds2;

namespace {

struct PoolPick {
  float value;
  int row, col;  // the element of the 2x2 window that holds it
};

// The where-chain on the window's values a[row][col].
__device__ __forceinline__ PoolPick pick4(float a00, float a01, float a10,
                                          float a11) {
  const bool up0 = a00 >= a10, up1 = a01 >= a11;
  const float p0 = up0 ? a00 : a10, p1 = up1 ? a01 : a11;
  const bool left = p0 >= p1;
  return {left ? p0 : p1, (left ? up0 : up1) ? 0 : 1, left ? 0 : 1};
}

// xp: element (0, 0) of the window for this channel; step to the next
// column is cin, to the next row W * cin.
template <typename T>
__device__ __forceinline__ PoolPick pool_chain(const T* xp, size_t col,
                                               size_t row) {
  return pick4(ldf(xp, 0), ldf(xp, col), ldf(xp, row), ldf(xp, row + col));
}

// The first downsampler's input gradient (conv_s2.cuh's gather, one thread
// per value): dz: (B, H/2, W/2, cout); wt: (3, 3, cc, cin); dx: (B, H, W,
// cin)
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

// ---- the first downsampler: cin = 3, cout = 16 ----------------------------
//
// A K of 27 and a 12- or 6-byte channel run would leave a tensor-core tile
// mostly padding, and the image's bytes bound this shape; so it runs on
// FFMA, one thread per small pixel (forward) or sixteen (weight gradient),
// each reading the 3x3 window of its pixel once. Its input gradient (the
// images need none) stays on ds_dx_kernel.

constexpr int D1_CIN = 3, D1_COUT = 16, D1_CC = 13, D1_K = 27;

__device__ __forceinline__ float as_stored(const bf16*, float v) {
  return bf2f(f2bf(v));
}
__device__ __forceinline__ float as_stored(const float*, float v) {
  return v;
}

// v[(3 ky + kx) 3 + ci] = x at (2h + ky - 1, 2w + kx - 1), channel ci, zero
// off the plane; x: (B, H, W, 3)
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ x, int b,
                                            int h, int w, int H, int W,
                                            float (&v)[D1_K]) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int Y = 2 * h + ky - 1, X = 2 * w + kx - 1;
      const bool ok = Y >= 0 && X >= 0;  // 2h + 1 < H, 2w + 1 < W
      const T* xp = x + (((size_t)b * H + (ok ? Y : 0)) * W + (ok ? X : 0)) *
                            D1_CIN;
#pragma unroll
      for (int ci = 0; ci < D1_CIN; ++ci)
        v[(3 * ky + kx) * D1_CIN + ci] = ok ? ldf(xp, ci) : 0.0f;
    }
}

// y (B, H/2, W/2, 16) = [T(conv + bias) | maxpool]; the moments of the
// rounded y to the block's row of part (2 x 16 floats a block); wt: (3, 3,
// 3, 13), staged in shared memory
template <typename T>
__global__ void __launch_bounds__(EW_THREADS) ds1_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wt,
    const float* __restrict__ bias, T* __restrict__ y,
    float* __restrict__ part, int B, int H, int W) {
  __shared__ float sw[D1_K * D1_CC + D1_CC];
  __shared__ float red[EW_THREADS / 32][2 * D1_COUT];
  for (int i = threadIdx.x; i < D1_K * D1_CC + D1_CC; i += EW_THREADS)
    sw[i] = i < D1_K * D1_CC ? ldf(wt, i) : bias[i - D1_K * D1_CC];
  __syncthreads();
  const int Hs = H / 2, Ws = W / 2, npix = B * Hs * Ws;
  float s[2 * D1_COUT];
#pragma unroll
  for (int c = 0; c < 2 * D1_COUT; ++c) s[c] = 0.0f;
  for (int p = blockIdx.x * EW_THREADS + threadIdx.x; p < npix;
       p += gridDim.x * EW_THREADS) {
    const int w = p % Ws, h = (p / Ws) % Hs, b = p / (Ws * Hs);
    float v[D1_K], o[D1_COUT];
    load_window(x, b, h, w, H, W, v);
#pragma unroll
    for (int co = 0; co < D1_CC; ++co) {
      float a = 0.0f;
#pragma unroll
      for (int t = 0; t < D1_K; ++t) a = fmaf(v[t], sw[t * D1_CC + co], a);
      o[co] = as_stored(y, a + sw[D1_K * D1_CC + co]);
    }
    // the pool window is taps (ky, kx) in {1, 2}^2 of the 3x3 one
#pragma unroll
    for (int c = 0; c < D1_CIN; ++c)
      o[D1_CC + c] = pick4(v[12 + c], v[15 + c], v[21 + c], v[24 + c]).value;
    T* yp = y + (size_t)p * D1_COUT;
    store8(yp, *reinterpret_cast<float(*)[8]>(o));
    store8(yp + 8, *reinterpret_cast<float(*)[8]>(o + 8));
#pragma unroll
    for (int c = 0; c < D1_COUT; ++c) {
      s[c] += o[c];
      s[D1_COUT + c] += o[c] * o[c];
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 2 * D1_COUT; ++c) {
    float a = s[c];
    for (int off = 16; off >= 1; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) red[warp][c] = a;
  }
  __syncthreads();
  if (threadIdx.x < 2 * D1_COUT) {
    float a = 0.0f;
    for (int k = 0; k < EW_THREADS / 32; ++k) a += red[k][threadIdx.x];
    part[(size_t)blockIdx.x * 2 * D1_COUT + threadIdx.x] = a;
  }
}

// dW (13, 3, 3, 3) = sum_p dz[p][co] * window_p: sixteen threads per small
// pixel, thread co % 16 keeping the 27 sums of its output channel (co < 13;
// the three others read no gradient), the two half-warps folded by a
// shuffle, the 8 warps added in warp order in shared memory, and the block
// writes its sums to its row of part (351 floats a block, in dW's layout).
// dz: (B, H/2, W/2, 16).
template <typename T>
__global__ void __launch_bounds__(EW_THREADS) ds1_wgrad_kernel(
    const T* __restrict__ dz, const T* __restrict__ x,
    float* __restrict__ part, int B, int H, int W) {
  __shared__ float red[EW_THREADS / 32][D1_CC * D1_K];
  const int co = threadIdx.x % 16;
  const int Hs = H / 2, Ws = W / 2, npix = B * Hs * Ws;
  float acc[D1_K];
#pragma unroll
  for (int t = 0; t < D1_K; ++t) acc[t] = 0.0f;
  for (int p = (blockIdx.x * EW_THREADS + threadIdx.x) / 16; p < npix;
       p += gridDim.x * (EW_THREADS / 16)) {
    const int w = p % Ws, h = (p / Ws) % Hs, b = p / (Ws * Hs);
    float v[D1_K];
    load_window(x, b, h, w, H, W, v);
    const float g = co < D1_CC ? ldf(dz, (long long)p * D1_COUT + co) : 0.0f;
#pragma unroll
    for (int t = 0; t < D1_K; ++t) acc[t] = fmaf(g, v[t], acc[t]);
  }
#pragma unroll
  for (int t = 0; t < D1_K; ++t) {
    const float a = acc[t] + __shfl_xor_sync(0xffffffffu, acc[t], 16);
    if ((threadIdx.x & 31) < 16 && co < D1_CC)
      red[threadIdx.x / 32][co * D1_K + t] = a;
  }
  __syncthreads();
  float* row = part + (size_t)blockIdx.x * D1_CC * D1_K;
  for (int i = threadIdx.x; i < D1_CC * D1_K; i += EW_THREADS) {
    const int c = i / D1_K, t = i % D1_K;  // t = (3 ky + kx) 3 + ci
    const int ky = t / 9, kx = (t / 3) % 3, ci = t % 3;
    float a = 0.0f;
    for (int k = 0; k < EW_THREADS / 32; ++k) a += red[k][i];
    row[((c * D1_CIN + ci) * 3 + ky) * 3 + kx] = a;
  }
}

// The forward on the tensor cores: the 3x3/s2/p1 convolution of x (the
// large plane, `large` = x) into the cc conv channels, bias, one rounding,
// the pool channels cc .. cout from the windows of x, and the moments of
// the rounded y to the block's row of `part` (2 cout floats a block).
// wt: (3, 3, cin, cc); y: (B, Hs, Ws, cout).
template <typename T>
struct op_k8_fwd : ConvGeo<T> {
  const T* wt;
  const float* bias;
  T* y;
  float* part;
  int cin, cout, cc;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int, float* red) const {
    const int H = 2 * this->Hs, W = 2 * this->Ws;
    float s0[NT][2], s1[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + tile_row(h);
      if (p >= this->npix) continue;
      T* yr = y + (size_t)p * cout;
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
    fold_channels(s0, red);
    fold_channels(s1, red + cout);
    // the pool channels: thread i keeps channel i % cin (MM_THREADS % cin
    // == 0), the rows ascend with i; its sums at the end of red[]
    const int c = threadIdx.x % cin;
    float q0 = 0.0f, q1 = 0.0f;
    for (int i = threadIdx.x; i < MM_BM * cin; i += MM_THREADS) {
      const int p = p0 + i / cin;
      if (p >= this->npix) break;
      const Pix q = pix_of(p, this->npix, this->Hs, this->Ws);
      const T* xp = this->large +
                    (((size_t)q.b * H + 2 * q.h) * W + 2 * q.w) * cin + c;
      const float f = stf(y, (long long)p * cout + cc + c,
                          pool_chain(xp, cin, (size_t)W * cin).value);
      q0 += f;
      q1 += f * f;
    }
    float* pool = red + MM_RED - 2 * MM_THREADS;
    pool[threadIdx.x] = q0;
    pool[MM_THREADS + threadIdx.x] = q1;
    __syncthreads();
    // channel by channel: the conv channels' warps in warp order, the pool
    // channels' threads in ascending order
    float* row = moment_row(part, cout);
    for (int i = threadIdx.x; i < 2 * cout; i += MM_THREADS) {
      const int m = i / cout, ch = i % cout;
      float a = 0.0f;
      if (ch < cc) {
        a = warp_sum(red, m * cout + ch);
      } else {
        for (int t = ch - cc; t < MM_THREADS; t += cin)
          a += pool[m * MM_THREADS + t];
      }
      row[i] = a;
    }
  }
};

// The input gradient on the tensor cores: the transposed convolution of
// dz's first cc channels (`small` = dz, pitch cout) by output parity, plus
// the pool gradient dz[.., cc + c] at the element of each window the
// where-chain picks, rounded once. wt: (3, 3, cc, cin); dx: (B, H, W, cin).
template <typename T>
struct op_k8_dx : PhaseGeo<T> {
  const T* wt;
  const T* x;
  T* dx;
  int cin, cout, cc;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int phase, float*) const {
    const int py = phase >> 1, px = phase & 1;
    const int H = 2 * this->Hs, W = 2 * this->Ws;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + tile_row(h);
      if (p >= this->npix) continue;
      const Pix q = pix_of(p, this->npix, this->Hs, this->Ws);
      T* dr = dx + this->out_pixel(q, p, phase) * cin;
      const T* xw = x + (((size_t)q.b * H + 2 * q.h) * W + 2 * q.w) * cin;
      const T* gp = this->small + (size_t)p * cout + cc;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = tile_col(j);
        float v[2] = {acc[j][2 * h], acc[j][2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const PoolPick k = pool_chain(xw + n + e, cin, (size_t)W * cin);
          if (k.row == py && k.col == px) v[e] += ldf(gp, n + e);
        }
        float f0, f1;
        stf2(dr + n, v[0], v[1], f0, f1);
      }
    }
  }
};

template <typename T, int CK, int N>
int ds_fwd_mma(const T* x, const T* wt, const float* bias, T* y, float* mom,
               int B, int H, int W, int cin, int cout, cudaStream_t s,
               ldfold::Partials& pp) {
  op_k8_fwd<T> op;
  op.large = x;
  op.npix = B * (H / 2) * (W / 2);
  op.Hs = H / 2;
  op.Ws = W / 2;
  op.CL = cin;
  op.wt = wt;
  op.bias = bias;
  op.y = y;
  op.part = pp.take(grid_1d(op.npix, MM_BM), 2 * cout, mom);
  if (op.part == nullptr) return (int)cudaErrorInvalidValue;
  op.cin = cin;
  op.cout = cout;
  op.cc = cout - cin;
  return launch_s2_gemm<T, CK, N>(op, 1, s);
}

template <typename T, int CK, int N>
int ds_dx_mma(const T* x, const T* dz, const T* wt, T* dx, int B, int H,
              int W, int cin, int cout, cudaStream_t s) {
  op_k8_dx<T> op;
  op.small = dz;
  op.npix = B * (H / 2) * (W / 2);
  op.Hs = H / 2;
  op.Ws = W / 2;
  op.CST = cout;
  op.wt = wt;
  op.x = x;
  op.dx = dx;
  op.cin = cin;
  op.cout = cout;
  op.cc = cout - cin;
  return launch_s2_gemm<T, CK, N>(op, 4, s);
}

// the shapes the kernels take: the config's three downsamplers
bool known_shape(int cin, int cout) {
  return (cin == D1_CIN && cout == D1_COUT) || (cin == 16 && cout == 64) ||
         (cin == 64 && cout == 128);
}

template <typename T>
int ds_fwd_launch(const void* x, const void* wt, const void* bias, void* y,
                  void* mom, int B, int H, int W, int cin, int cout,
                  cudaStream_t s, ldfold::Partials& pp) {
  const T* xt = static_cast<const T*>(x);
  const T* w = static_cast<const T*>(wt);
  const float* b = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  float* m = static_cast<float*>(mom);
  if (cin == 16)
    return ds_fwd_mma<T, 16, 48>(xt, w, b, yt, m, B, H, W, cin, cout, s, pp);
  if (cin == 64)
    return ds_fwd_mma<T, 64, 64>(xt, w, b, yt, m, B, H, W, cin, cout, s, pp);
  const int blocks = ew_blocks((long long)B * (H / 2) * (W / 2));
  float* part = pp.take(blocks, 2 * D1_COUT, m);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  ds1_fwd_kernel<T><<<blocks, EW_THREADS, 0, s>>>(xt, w, b, yt, part, B, H,
                                                  W);
  return (int)cudaGetLastError();
}

template <typename T>
int ds_fwd(const void* x, const void* wt, const void* bias, void* y,
           void* mom, void* part, int B, int H, int W, int cin, int cout,
           int part_floats, void* stream) {
  if (!known_shape(cin, cout) || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  ldfold::Partials pp(part, part_floats);
  const int rc = ds_fwd_launch<T>(x, wt, bias, y, mom, B, H, W, cin, cout,
                                  s, pp);
  return rc ? rc : pp.fold<op_k8>(s);
}

template <typename T>
int ds_bwd_launch(const void* x, const void* y, const void* dy,
                  const void* dmom, const void* wt, void* dz, void* dx,
                  void* dweight, void* dbias, int B, int H, int W, int cin,
                  int cout, cudaStream_t s, ldfold::Partials& pp) {
  const int Ho = H / 2, Wo = W / 2, cc = cout - cin;
  const T* xb = static_cast<const T*>(x);
  T* dzb = static_cast<T*>(dz);
  const T* w = static_cast<const T*>(wt);
  float* dw = static_cast<float*>(dweight);
  int rc = launch_dyv_fold<op_k8>(static_cast<const T*>(dy),
                                  static_cast<const T*>(y),
                                  static_cast<const float*>(dmom), dzb,
                                  static_cast<float*>(dbias),
                                  (long long)B * Ho * Wo * cout, cout, s, pp);
  if (rc) return rc;
  if (dx != nullptr) {
    T* dxt = static_cast<T*>(dx);
    if (cin == 16) {
      rc = ds_dx_mma<T, 48, 16>(xb, dzb, w, dxt, B, H, W, cin, cout, s);
    } else if (cin == 64) {
      rc = ds_dx_mma<T, 64, 64>(xb, dzb, w, dxt, B, H, W, cin, cout, s);
    } else {
      ds_dx_kernel<T><<<ew_blocks((long long)B * H * W * cin), EW_THREADS, 0,
                        s>>>(xb, dzb, w, dxt, B, H, W, cin, cout);
      rc = (int)cudaGetLastError();
    }
    if (rc) return rc;
  }
  if (cin == 16)
    return launch_s2_wgrad<T, 64, 16, op_k8>(dzb, xb, dw, B, Ho, Wo, cout, cc,
                                             s, pp);
  if (cin == 64)
    return launch_s2_wgrad<T, 64, 64, op_k8>(dzb, xb, dw, B, Ho, Wo, cout, cc,
                                             s, pp);
  const int blocks = ew_blocks(16LL * B * Ho * Wo);
  float* part = pp.take(blocks, D1_CC * D1_K, dw);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  ds1_wgrad_kernel<T><<<blocks, EW_THREADS, 0, s>>>(dzb, xb, part, B, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int ds_bwd(const void* x, const void* y, const void* dy, const void* dmom,
           const void* wt, void* dz, void* dx, void* dweight, void* dbias,
           void* part, int B, int H, int W, int cin, int cout,
           int part_floats, void* stream) {
  if (!known_shape(cin, cout) || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  ldfold::Partials pp(part, part_floats);
  const int rc = ds_bwd_launch<T>(x, y, dy, dmom, wt, dz, dx, dweight, dbias,
                                  B, H, W, cin, cout, s, pp);
  return rc ? rc : pp.fold<op_k8>(s);
}

}  // namespace

// x: (B, H, W, cin) bf16; wt: (3, 3, cin, cc) bf16 [kh][kw][ci][co];
// bias: (cc,) f32; y: (B, H/2, W/2, cout) bf16; mom: (2, cout) f32,
// written whole (any contents on entry); part: f32 scratch of part_floats
// floats for the blocks' sums (ops/lanemaps.py::downsampler_partials
// counts them; any contents). (cin, cout) is (3, 16), (16, 64) or (64,
// 128).
LD_API int ld_downsampler_op_fwd(const void* x, const void* wt,
                                 const void* bias, void* y, void* mom,
                                 void* part, int B, int H, int W, int cin,
                                 int cout, int part_floats, void* stream) {
  return ds_fwd<bf16>(x, wt, bias, y, mom, part, B, H, W, cin, cout,
                      part_floats, stream);
}

// The same on float32 planes and taps: x, wt, y f32.
LD_API int ld_downsampler_op_fwd_f32(const void* x, const void* wt,
                                     const void* bias, void* y, void* mom,
                                     void* part, int B, int H, int W,
                                     int cin, int cout, int part_floats,
                                     void* stream) {
  return ds_fwd<float>(x, wt, bias, y, mom, part, B, H, W, cin, cout,
                       part_floats, stream);
}

// x as above; y, dy, dz: (B, H/2, W/2, cout) bf16 (dz scratch); dmom:
// (2, cout) f32; wt: (3, 3, cc, cin) bf16 [kh][kw][co][ci]; dx: (B, H, W,
// cin) bf16 or null (skipped); dweight: (cc, cin, 3, 3) f32 and dbias:
// (cout,) f32 (its first cc entries are the bias gradient), written whole
// (any contents on entry); part: the blocks' sums, as for the forward.
LD_API int ld_downsampler_op_bwd(const void* x, const void* y, const void* dy,
                                 const void* dmom, const void* wt, void* dz,
                                 void* dx, void* dweight, void* dbias,
                                 void* part, int B, int H, int W, int cin,
                                 int cout, int part_floats, void* stream) {
  return ds_bwd<bf16>(x, y, dy, dmom, wt, dz, dx, dweight, dbias, part, B, H,
                      W, cin, cout, part_floats, stream);
}

// The same on float32 planes and taps: x, y, dy, wt, dz, dx f32.
LD_API int ld_downsampler_op_bwd_f32(const void* x, const void* y,
                                     const void* dy, const void* dmom,
                                     const void* wt, void* dz, void* dx,
                                     void* dweight, void* dbias, void* part,
                                     int B, int H, int W, int cin, int cout,
                                     int part_floats, void* stream) {
  return ds_bwd<float>(x, y, dy, dmom, wt, dz, dx, dweight, dbias, part, B,
                       H, W, cin, cout, part_floats, stream);
}
