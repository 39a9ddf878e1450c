// K4 head_rowsums: the 2x2/s2 ConvTranspose output head, the weight-map
// activation, the top-row mask and the separable WLS row sums, fused. The
// device code, shared by the serving entry point (head_rowsums.cu), the
// training forward of K10 (head_rowsums_op.cu) and the head pass of the
// whole-decoder kernel (decoder_fused.cu); its pixel loads and taps also
// serve head_quads.cuh (K10's backward, K9's 2x2 head in lane_maps_op.cu).
//
// Replaces the TPU body `body_head` (lanedetection_end2end_tpu/ops/
// pallas_backbone.py:310) plus the tail of `_decoder_plane_b`
// (lanedetection_end2end_tpu/models/fused_graph.py:287-325). For output row
// r of image b and lane channel c:
//
//   dec[r, w, c] = bias[c] + sum_ci t[r/2, w/2, ci] * K[r%2, w%2, ci, c]
//   w2           = act(dec)^2           ("square": (dec^2)^2)
//   S0[b, r, c]  = sum_w w2,  S1[b, r, c] = sum_w w2 * xs[w]
//
// and S0 = S1 = 0 for rows r < zero_rows. xs is the normalized column
// coordinate of the fitter (ops/wls.py). Output (B, H, 2C) f32 = [S0 | S1].
// The full-resolution logits never reach device memory.
//
// Bound on the card: the input t (B, H/2, W/2, 16) is read once (bf16 when
// serving, bf16 or float32 in training) and only 2C floats per output row
// are written; ~2*16 FLOP per output logit, ~20 FLOP per byte in bf16: HBM
// bounds it (in float32 the two bounds are about equal).
//
// Design: a 2x2/s2 transposed convolution has no overlap, input pixel (h,
// w) alone makes output pixels (2h + i, 2w + j). So a block takes one
// input row (b, h) and makes output rows 2h and 2h + 1 from one read of
// it: each thread loads a pixel's 16 channels with 16-byte loads, forms
// the 2 x 2 output pixels' logits in f32 from the taps in shared memory
// (f32, lanes padded to CT = 1, 2, 4 or 8 with zeros, so the lane loops
// unroll), and keeps the two rows' sums in registers; the sums fold over
// the warp by shuffles and the warps' parts add up in order. A row of S
// belongs to one block: no atomics, and S reproduces itself bit for bit.
// The row body (`head_rows`) is the same for K4, K10's forward and the
// whole decoder, so all three give the same S bit for bit.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace ldhead {

constexpr int MAXC = 8;
constexpr int CIN = 16;  // the head's input channels
constexpr int NQ = 4;    // output pixels of an input pixel, q = 2 i + j
constexpr int THREADS = 256;
// shared memory of the row body: the taps [q][ci][CT] and CT biases, then
// the warps' parts [warp][row][S0, S1][CT] (floats, at CT = MAXC)
constexpr int TAP_FLOATS = NQ * CIN * MAXC + MAXC;
constexpr int PART_FLOATS = (THREADS / 32) * 4 * MAXC;
constexpr int SMEM_BYTES = 4 * (TAP_FLOATS + PART_FLOATS);

// C lanes padded to the row body's unrolled width
__host__ __device__ inline int lane_pad(int C) {
  return C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : MAXC;
}

// activation codes: ACTIVATIONS in ops/activations.py
__device__ __forceinline__ float weight_sq(float v, int act) {
  float a;
  switch (act) {
    case 0: a = v * v; break;                          // square
    case 1: a = 1.0f / (1.0f + expf(-v)); break;       // sigmoid
    case 2: a = fmaxf(v, 0.0f); break;                 // relu
    case 3: a = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v))); break;  // softplus
    case 4: a = fabsf(v); break;                       // abs
    default: a = v; break;                             // none
  }
  return a * a;
}

// v rounded to the planes' type T, as a float
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (std::is_same<T, bf16>::value) return bf2f(f2bf(v));
  return v;
}

// The CIN channels of one pixel of a bf16 or f32 plane as floats, in
// 16-byte loads (the address 16-byte aligned). kCoherent reads through L2
// only (a persistent kernel rewrites its planes within the launch), else
// through the read-only path.
template <bool kCoherent, typename T>
__device__ __forceinline__ void load_pixel(const T* p, float (&f)[CIN]) {
  constexpr int NV = CIN * (int)sizeof(T) / 16;
  uint4 v[NV];
  const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < NV; ++k)
    v[k] = kCoherent ? __ldcg(src + k) : __ldg(src + k);
  const T* e = reinterpret_cast<const T*>(v);
#pragma unroll
  for (int ci = 0; ci < CIN; ++ci) f[ci] = ldf(e, ci);
}

// The taps into shared memory as the row body reads them: taps[(q CIN +
// ci) ct + c] = K[i][j][ci][c] (q = 2 i + j), then the ct biases (zeros
// without kBias: `bias` is not read); lanes c >= C zero. `w` in the serving
// layout (2, 2, CIN, C) of type T (K4, the whole decoder), or kParam: the
// parameter's own (CIN, C, 2, 2) f32, rounded to the planes' type T (K10,
// K9's head). Every thread of the block calls it; the caller syncs before
// reading.
template <typename T, bool kParam, bool kBias = true>
__device__ __forceinline__ void load_taps(const void* w, const float* bias,
                                          int C, float* taps) {
  const int ct = lane_pad(C);
  for (int e = threadIdx.x; e < NQ * CIN * ct + ct; e += blockDim.x) {
    const int c = e % ct, k = e / ct;  // k = q CIN + ci, or NQ CIN: bias
    float v = 0.0f;
    if (c < C) {
      if (k == NQ * CIN)
        v = kBias ? bias[c] : 0.0f;
      else if (kParam)
        v = round_as<T>(static_cast<const float*>(
            w)[((k % CIN) * C + c) * NQ + k / CIN]);
      else
        v = ldf(static_cast<const T*>(w), (long long)k * C + c);
    }
    taps[e] = v;
  }
}

// Output rows 2h and 2h + 1 of S from input row `hrow` = b * H/2 + h of t
// (B, H/2, W/2, CIN), CT lanes (C <= CT, lane_pad) from `taps`
// (load_taps). Thread i takes the input pixels i, i + THREADS, ... of the
// row; per pixel, output column 2w then 2w + 1. part: PART_FLOATS floats
// of shared memory. Ends after reading `part`: a caller that runs a second
// row in the same block puts a __syncthreads() between the two.
template <int CT, typename T, bool kCoherent>
__device__ __forceinline__ void head_rows_ct(int hrow, const T* t,
                                             const float* taps,
                                             const float* xs, float* S,
                                             int H, int W, int C,
                                             int zero_rows, int act,
                                             float* part) {
  const int Hh = H / 2, Wh = W / 2;
  const int b = hrow / Hh, r0 = 2 * (hrow % Hh);
  float s[2][2][CT];  // [row i][S0, S1][lane]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) s[i][0][c] = s[i][1][c] = 0.0f;

  if (r0 + 1 >= zero_rows) {
    const T* trow = t + (size_t)hrow * Wh * CIN;
    for (int w = threadIdx.x; w < Wh; w += THREADS) {
      float x[CIN];
      load_pixel<kCoherent>(trow + (size_t)w * CIN, x);
      const float2 xc =
          make_float2(__ldg(xs + 2 * w), __ldg(xs + 2 * w + 1));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r0 + i < zero_rows) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* tq = taps + (2 * i + j) * CIN * CT;
          float dec[CT];
#pragma unroll
          for (int c = 0; c < CT; ++c) dec[c] = taps[NQ * CIN * CT + c];
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
            for (int c = 0; c < CT; ++c)
              dec[c] = fmaf(x[ci], tq[ci * CT + c], dec[c]);
          const float xcol = j ? xc.y : xc.x;
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float w2 = weight_sq(dec[c], act);
            s[i][0][c] += w2;
            s[i][1][c] += w2 * xcol;
          }
        }
      }
    }
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        for (int o = 16; o > 0; o >>= 1)
          s[i][k][c] += __shfl_down_sync(0xffffffffu, s[i][k][c], o);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int c = 0; c < CT; ++c)
          part[((warp * 2 + i) * 2 + k) * CT + c] = s[i][k][c];
  }
  __syncthreads();
  if (threadIdx.x < 4 * C) {
    const int c = threadIdx.x % C, k = (threadIdx.x / C) % 2;
    const int i = threadIdx.x / (2 * C);
    float v = 0.0f;
    for (int wp = 0; wp < THREADS / 32; ++wp)
      v += part[((wp * 2 + i) * 2 + k) * CT + c];
    S[((size_t)b * H + r0 + i) * 2 * C + k * C + c] = v;
  }
}

// head_rows_ct at CT = lane_pad(C): the same lanes for the same C in every
// caller.
template <typename T, bool kCoherent>
__device__ __forceinline__ void head_rows(int hrow, const T* t,
                                          const float* taps, const float* xs,
                                          float* S, int H, int W, int C,
                                          int zero_rows, int act,
                                          float* part) {
  switch (lane_pad(C)) {
    case 1:
      head_rows_ct<1, T, kCoherent>(hrow, t, taps, xs, S, H, W, C, zero_rows,
                                    act, part);
      break;
    case 2:
      head_rows_ct<2, T, kCoherent>(hrow, t, taps, xs, S, H, W, C, zero_rows,
                                    act, part);
      break;
    case 4:
      head_rows_ct<4, T, kCoherent>(hrow, t, taps, xs, S, H, W, C, zero_rows,
                                    act, part);
      break;
    default:
      head_rows_ct<MAXC, T, kCoherent>(hrow, t, taps, xs, S, H, W, C,
                                       zero_rows, act, part);
  }
}

// t: (B, H/2, W/2, CIN) of type T; w as load_taps<T, kParam> reads it;
// bias: (C,) f32; xs: (W,) f32; S: (B, H, 2C); one block of THREADS
// threads per input row
template <typename T, bool kParam>
__global__ void __launch_bounds__(THREADS) head_rowsums_kernel(
    const T* __restrict__ t, const void* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ xs,
    float* __restrict__ S, int H, int W, int C, int zero_rows, int act) {
  __shared__ __align__(16) float taps[TAP_FLOATS];
  __shared__ float part[PART_FLOATS];
  load_taps<T, kParam>(w, bias, C, taps);
  __syncthreads();
  head_rows<T, false>(blockIdx.x, t, taps, xs, S, H, W, C, zero_rows, act,
                      part);
}

// t: (B, H/2, W/2, cin) of type T (bf16 or f32), cin = CIN, W even; w as
// head_rowsums_kernel<T, kParam> takes it; bias: (C,) f32, C <= MAXC; xs:
// (W,) f32; S: (B, H, 2C) f32.
template <typename T, bool kParam>
int launch_head_rowsums(const void* t, const void* w, const void* bias,
                        const void* xs, void* S, int B, int H, int W, int cin,
                        int C, int zero_rows, int act, void* stream) {
  if (C < 1 || C > MAXC || cin != CIN || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  head_rowsums_kernel<T, kParam><<<B * (H / 2), THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t), w, static_cast<const float*>(bias),
      static_cast<const float*>(xs), static_cast<float*>(S), H, W, C,
      zero_rows, act);
  return (int)cudaGetLastError();
}

}  // namespace ldhead
