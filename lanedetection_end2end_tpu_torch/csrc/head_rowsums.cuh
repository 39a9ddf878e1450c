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
// Bound on the card: the input t (B, H/2, W/2, 16) is read once (bf16 when
// serving, bf16 or float32 in training) and only 2C floats per row are
// written; ~2*16 FLOP per output logit, ~20 FLOP per byte in bf16: HBM
// bounds it (in float32 the two bounds are about equal).
//
// Design: one block per output row (b, r); threads stride over the W
// columns, keep per-lane partial sums in registers (C <= 8, unrolled with
// predicates), then reduce with warp shuffles and shared memory. Masked
// rows skip the computation and write zeros. The row body (`head_row`) is
// shared with the whole-decoder kernel (decoder_fused.cu), which runs it
// with 128 threads in K4's order of operations.

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

// One row `row` = b * H + r of S, as THREADS threads would compute it,
// run by the NT threads (NT divides THREADS) of the calling block: thread i
// plays the virtual threads i, i + NT, ...; each virtual thread strides
// over the W columns by THREADS, its warp's partial sums fold by shuffles
// into part[virtual warp], and the THREADS/32 parts add up in order. The
// same operations in the same order for any NT, so a row of S is bit for
// bit the same whether 256 threads (head_rowsums_kernel) or the 128 of the
// whole-decoder kernel (decoder_fused.cu) compute it. t: (B, H/2, W/2,
// cin); w: (2, 2, cin, C) [i][j][ci][c], both of type T; S: (B, H, 2C);
// part: THREADS/32 x 2*MAXC floats of shared memory. kCoherent reads t
// through L2 only (load_f, common.cuh): the fused kernel writes t earlier
// in the same launch. Ends after reading `part`: a caller that runs a
// second row in the same block puts a __syncthreads() between the two.
template <int NT, typename T, bool kCoherent>
__device__ __forceinline__ void head_row(
    int row, const T* t, const T* w, const float* bias, const float* xs,
    float* S, int H, int W, int cin, int C, int zero_rows, int act,
    float (*part)[2 * MAXC]) {
  static_assert(THREADS % NT == 0 && NT % 32 == 0, "NT divides THREADS");
  constexpr int V = THREADS / NT;  // virtual threads per thread
  const int r = row % H, b = row / H;
  float s0[V][MAXC], s1[V][MAXC];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) s0[v][c] = s1[v][c] = 0.0f;

  if (r >= zero_rows) {
    const int Wh = W / 2;
    const T* trow = t + ((size_t)b * (H / 2) + (r >> 1)) * Wh * cin;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      for (int col = threadIdx.x + v * NT; col < W; col += THREADS) {
        const T* tp = trow + (size_t)(col >> 1) * cin;
        const T* wp = w + (size_t)(((r & 1) * 2 + (col & 1)) * cin) * C;
        float dec[MAXC];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) dec[c] = c < C ? bias[c] : 0.0f;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = load_f<kCoherent>(tp + ci);
#pragma unroll
          for (int c = 0; c < MAXC; ++c)
            if (c < C) dec[c] = fmaf(xv, ldf(wp, ci * C + c), dec[c]);
        }
        const float xc = xs[col];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < C) {
            const float w2 = weight_sq(dec[c], act);
            s0[v][c] += w2;
            s1[v][c] += w2 * xc;
          }
        }
      }
    }
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      for (int o = 16; o > 0; o >>= 1) {
        s0[v][c] += __shfl_down_sync(0xffffffffu, s0[v][c], o);
        s1[v][c] += __shfl_down_sync(0xffffffffu, s1[v][c], o);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        part[warp + v * (NT / 32)][c] = s0[v][c];
        part[warp + v * (NT / 32)][MAXC + c] = s1[v][c];
      }
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

// t: (B, H/2, W/2, cin); w: (2, 2, cin, C) [i][j][ci][c], both of type T;
// S: (B, H, 2C); one block of THREADS threads per row
template <typename T>
__global__ void __launch_bounds__(THREADS) head_rowsums_kernel(
    const T* __restrict__ t, const T* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ xs,
    float* __restrict__ S, int H, int W, int cin, int C, int zero_rows,
    int act) {
  __shared__ float part[THREADS / 32][2 * MAXC];
  head_row<THREADS, T, false>(blockIdx.x, t, w, bias, xs, S, H, W, cin, C,
                              zero_rows, act, part);
}

// t: (B, H/2, W/2, cin) and w: (2, 2, cin, C) of type T (bf16 or f32);
// bias: (C,) f32; xs: (W,) f32; S: (B, H, 2C) f32. A row of S belongs to
// one block, so the result has no atomics and reproduces itself bit for
// bit.
template <typename T>
int launch_head_rowsums(const void* t, const void* w, const void* bias,
                        const void* xs, void* S, int B, int H, int W, int cin,
                        int C, int zero_rows, int act, void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  head_rowsums_kernel<T><<<B * H, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(xs),
      static_cast<float*>(S), H, W, cin, C, zero_rows, act);
  return (int)cudaGetLastError();
}

}  // namespace ldhead
