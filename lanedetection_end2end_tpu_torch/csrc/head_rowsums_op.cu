// K10 head_rowsums_op: the fused e2e tail of the train step, forward and
// backward: 2x2/s2 ConvTranspose head, square activation, top-row mask and
// the separable WLS row sums.
//
// Replaces the TPU bodies `_hr_fwd_kernel` and `_hr_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_lanemaps.py:455, :471; the op at
// :547), which run the head as lane-map matmuls per row phase and the
// reductions as 0/1 `sel` / `red` matmuls. Here, on NHWC bf16 with the
// parameter (cin, C, 2, 2):
//
//   forward   dec[r, w, c] = bias[c] + sum_ci x[r/2, w/2, ci] K[ci, c, r%2,
//             w%2] in f32, never written;  w2 = (dec^2)^2, zero for rows
//             r < zero_rows;  S[b, r] = [sum_w w2 | sum_w w2 * xs[w]]
//   backward  dec recomputed;
//             ddec = 4 dec^3 (dS0[b, r, c] + xs[w] dS1[b, r, c]), masked
//             rows zero;  dbias = sum ddec (f32);  dp = bf16(ddec)
//             dx = bf16(2x2/s2 convolution of dp with the weight)
//             dweight[ci][c][i][j] = sum_pixels x * dp
//
// The forward is the serving kernel K4 with the square activation
// (head_rowsums.cuh): a row of S belongs to one block, so it has no atomics
// and reproduces itself bit for bit.
//
// Bound on the card: forward reads x once and writes 2C floats per row;
// backward reads x and dS and writes dx; ~20 FLOP per byte: bytes.
//
// Design: backward in three launches. `hr_ddec_kernel`, one thread per
// logit with the lane channel fastest, recomputes dec (cin multiply-adds),
// writes the bf16 gradient plane dp (scratch; the f32 logits are not
// formed) and reduces dbias in the block; then the input and weight
// gradients of conv_s2.cuh on dp. f32 atomics make the last bits of dbias
// and dweight depend on the order blocks finish in; both must be zero
// before the call.

#include "conv_s2.cuh"
#include "head_rowsums.cuh"

using namespace lds2;

namespace {

// x: (B, H/2, W/2, cin); wf: (2, 2, cin, C); dS: (B, H, 2C);
// dp: (B, H, W, C); dbias: (C,)
__global__ void __launch_bounds__(EW_THREADS) hr_ddec_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wf,
    const float* __restrict__ bias, const float* __restrict__ xs,
    const float* __restrict__ dS, bf16* __restrict__ dp,
    float* __restrict__ dbias, int B, int H, int W, int cin, int C,
    int zero_rows) {
  const long long n = (long long)B * H * W * C;
  float s0 = 0.0f;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EW_THREADS) {
    const int c = (int)(i % C);
    const long long pix = i / C;
    const int col = (int)(pix % W), r = (int)((pix / W) % H);
    const int b = (int)(pix / ((long long)W * H));
    float dd = 0.0f;
    if (r >= zero_rows) {
      const bf16* xp =
          x + (((size_t)b * (H / 2) + (r >> 1)) * (W / 2) + (col >> 1)) * cin;
      const bf16* wp = wf + (size_t)(((r & 1) * 2 + (col & 1)) * cin) * C + c;
      float dec = bias[c];
      for (int ci = 0; ci < cin; ++ci)
        dec = fmaf(bf2f(xp[ci]), bf2f(wp[ci * C]), dec);
      const float* g = dS + ((size_t)b * H + r) * 2 * C;
      dd = 4.0f * dec * dec * dec * (g[c] + xs[col] * g[C + c]);
    }
    s0 += dd;  // bias gradient from the f32 value, before rounding
    dp[i] = f2bf(dd);
  }
  block_channel_add(s0, 0.0f, C, dbias, nullptr);
}

}  // namespace

// x: (B, H/2, W/2, cin) bf16; wf: (2, 2, cin, C) bf16 [i][j][ci][c]; bias:
// (C,) f32; xs: (W,) f32; S: (B, H, 2C) f32.
LD_API int ld_head_rowsums_op_fwd(const void* x, const void* wf,
                                  const void* bias, const void* xs, void* S,
                                  int B, int H, int W, int cin, int C,
                                  int zero_rows, void* stream) {
  return ldhead::launch_head_rowsums(x, wf, bias, xs, S, B, H, W, cin, C,
                                     zero_rows, /*act=square*/ 0, stream);
}

// x, wf, bias, xs as above; dS: (B, H, 2C) f32; wt: (2, 2, C, cin) bf16
// [i][j][c][ci]; dp: (B, H, W, C) bf16 scratch; dx: (B, H/2, W/2, cin)
// bf16; dweight: (cin, C, 2, 2) f32 and dbias: (C,) f32, zero on entry.
// C in {1, 2, 4, 8}.
LD_API int ld_head_rowsums_op_bwd(const void* x, const void* dS,
                                  const void* wf, const void* wt,
                                  const void* bias, const void* xs, void* dp,
                                  void* dx, void* dweight, void* dbias, int B,
                                  int H, int W, int cin, int C, int zero_rows,
                                  void* stream) {
  if (C < 1 || C > ldhead::MAXC || EW_THREADS % C != 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* dpb = static_cast<bf16*>(dp);
  hr_ddec_kernel<<<ew_blocks((long long)B * H * W * C), EW_THREADS, 0, s>>>(
      xb, static_cast<const bf16*>(wf), static_cast<const float*>(bias),
      static_cast<const float*>(xs), static_cast<const float*>(dS), dpb,
      static_cast<float*>(dbias), B, H, W, cin, C, zero_rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = launch_l2s(dpb, static_cast<const bf16*>(wt), static_cast<bf16*>(dx),
                  B, H / 2, W / 2, C, cin, 2, 0, s);
  if (rc) return rc;
  return launch_wgrad_s2(xb, dpb, static_cast<float*>(dweight), B, H / 2,
                         W / 2, cin, cin, C, 2, 0, s);
}
