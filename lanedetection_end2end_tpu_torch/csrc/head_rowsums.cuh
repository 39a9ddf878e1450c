// K4 head_rowsums: the 2x2/s2 ConvTranspose output head, the weight-map
// activation, the top-row mask and the separable WLS row sums, fused. The
// device code, shared by the serving entry point (head_rowsums.cu) and the
// training forward of K10 (head_rowsums_op.cu).
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
// Bound on the card: the input t (B, H/2, W/2, 16) bf16 is read once and
// only 2C floats per row are written; ~2*16 FLOP per output logit, ~20
// FLOP per byte: HBM bounds it.
//
// Design: one block per output row (b, r); threads stride over the W
// columns, keep per-lane partial sums in registers (C <= 8, unrolled with
// predicates), then reduce with warp shuffles and shared memory. Masked
// rows skip the computation and write zeros.

#pragma once

#include "common.cuh"

namespace ldhead {

constexpr int MAXC = 8;
constexpr int THREADS = 256;

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

// t: (B, H/2, W/2, cin); w: (2, 2, cin, C) [i][j][ci][c]; S: (B, H, 2C)
__global__ void __launch_bounds__(THREADS) head_rowsums_kernel(
    const bf16* __restrict__ t, const bf16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ xs,
    float* __restrict__ S, int H, int W, int cin, int C, int zero_rows,
    int act) {
  const int row = blockIdx.x;  // b * H + r
  const int r = row % H, b = row / H;
  float s0[MAXC], s1[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) s0[c] = s1[c] = 0.0f;

  if (r >= zero_rows) {
    const int Wh = W / 2;
    const bf16* trow = t + ((size_t)b * (H / 2) + (r >> 1)) * Wh * cin;
    for (int col = threadIdx.x; col < W; col += blockDim.x) {
      const bf16* tp = trow + (size_t)(col >> 1) * cin;
      const bf16* wp = w + (size_t)(((r & 1) * 2 + (col & 1)) * cin) * C;
      float dec[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) dec[c] = c < C ? bias[c] : 0.0f;
      for (int ci = 0; ci < cin; ++ci) {
        const float xv = bf2f(tp[ci]);
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) dec[c] = fmaf(xv, bf2f(wp[ci * C + c]), dec[c]);
      }
      const float xc = xs[col];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          const float w2 = weight_sq(dec[c], act);
          s0[c] += w2;
          s1[c] += w2 * xc;
        }
      }
    }
  }

  __shared__ float part[THREADS / 32][2 * MAXC];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    for (int o = 16; o > 0; o >>= 1) {
      s0[c] += __shfl_down_sync(0xffffffffu, s0[c], o);
      s1[c] += __shfl_down_sync(0xffffffffu, s1[c], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      part[warp][c] = s0[c];
      part[warp][MAXC + c] = s1[c];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    const int c = threadIdx.x % C, which = threadIdx.x / C;
    float v = 0.0f;
    for (int k = 0; k < THREADS / 32; ++k) v += part[k][which * MAXC + c];
    S[(size_t)row * 2 * C + which * C + c] = v;
  }
}

// t: (B, H/2, W/2, cin) bf16; w: (2, 2, cin, C) bf16; bias: (C,) f32; xs:
// (W,) f32; S: (B, H, 2C) f32. A row of S belongs to one block, so the
// result has no atomics and reproduces itself bit for bit.
static inline int launch_head_rowsums(const void* t, const void* w,
                                      const void* bias, const void* xs,
                                      void* S, int B, int H, int W, int cin,
                                      int C, int zero_rows, int act,
                                      void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  head_rowsums_kernel<<<B * H, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(t), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(xs),
      static_cast<float*>(S), H, W, cin, C, zero_rows, act);
  return (int)cudaGetLastError();
}

}  // namespace ldhead
