// K10 head_rowsums_op: the fused e2e tail of the train step, forward and
// backward: 2x2/s2 ConvTranspose head, square activation, top-row mask and
// the separable WLS row sums.
//
// Replaces the TPU bodies `_hr_fwd_kernel` and `_hr_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_lanemaps.py:455, :471; the op at
// :547), which run the head as lane-map matmuls per row phase and the
// reductions as 0/1 `sel` / `red` matmuls. Here, on NHWC planes of one
// type T, bf16 or float32, with the parameter K (cin, C, 2, 2) f32 read as
// it lies (rounded to T, as the plain version rounds it):
//
//   forward   dec[r, w, c] = bias[c] + sum_ci x[r/2, w/2, ci] K[ci, c, r%2,
//             w%2] in f32, never written;  w2 = (dec^2)^2, zero for rows
//             r < zero_rows;  S[b, r] = [sum_w w2 | sum_w w2 * xs[w]]
//   backward  dec recomputed;
//             ddec = 4 dec^3 (dS0[b, r, c] + xs[w] dS1[b, r, c]), masked
//             rows zero;  dbias = sum ddec (f32);  dp = T(ddec)
//             dx = T(2x2/s2 convolution of dp with the weight)
//             dweight[ci][c][i][j] = sum_pixels x * dp
//
// The forward is the serving kernel K4 with the square activation
// (head_rowsums.cuh, the taps read from the parameter): a block owns an
// input row and makes both output rows of S from one read of it.
//
// Bound on the card: the forward reads x once and writes 2C floats per
// output row; the backward reads x (and dS, 1/(2 cin) of it) and writes
// dx, about 768 FFMA per input pixel at C = 4, 8: HBM bounds both.
//
// Design of the backward (head_quads.cuh, whose pass K9's 2x2 head runs
// too): the 2x2/s2 transposed convolution has no overlap, so ddec, dx and
// the pixel's share of dweight are local to an input pixel, and the whole
// backward is ONE pass over x that forms no gradient plane. Per pixel: its
// 16 channels, the 2 x 2 quad's C logits in f32 from the taps in shared
// memory, ddec, dbias (f32, in registers), dp = T(ddec) in registers, dx =
// T(sum dp K) written once; each block folds x^T dp for its TILE = 512
// pixels in pixel order into its column of `part`; a second, tiny launch
// (hr_sum_kernel) adds the columns in a fixed order. No atomics, no
// zero-fill, no gradient plane: dweight and dbias reproduce themselves bit
// for bit, and the partition (TILE pixels a block) depends on the shape
// alone.

#include "head_quads.cuh"

using ldhead::CIN;
using ldhead::NQ;
using ldhead::THREADS;

namespace {

// The quads' ddec from dS (B, H, 2C) f32 and the logits recomputed from
// the taps: 4 dec^3 (dS0[b, r, c] + xs[w] dS1[b, r, c]), zero for rows r <
// zero_rows and lanes c >= C.
template <int CT>
struct RowSumsGrad {
  const float* dS;
  const float* xs;
  int H, W, C, zero_rows;
  struct Pixel {
    int r0, b;
    float2 xc;
  };
  struct Row {
    float g0[CT], g1[CT];
  };
  struct Quad {
    float dec[CT];
    float xcol;
  };
  __device__ __forceinline__ Pixel pixel(int p) const {
    const int Hh = H / 2, Wh = W / 2;
    const int w = p % Wh, hb = p / Wh;
    Pixel px;
    px.r0 = 2 * (hb % Hh);
    px.b = hb / Hh;
    px.xc = make_float2(__ldg(xs + 2 * w), __ldg(xs + 2 * w + 1));
    return px;
  }
  __device__ __forceinline__ void row(const Pixel& px, int i, Row& g) const {
    const bool live = px.r0 + i >= zero_rows;
    const float* gp = dS + ((size_t)px.b * H + px.r0 + i) * 2 * C;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      g.g0[c] = live && c < C ? __ldg(gp + c) : 0.0f;
      g.g1[c] = live && c < C ? __ldg(gp + C + c) : 0.0f;
    }
  }
  __device__ __forceinline__ void quad(const Pixel& px, int j,
                                       const float (&xv)[CIN],
                                       const float* taps, const float* tq,
                                       Quad& d) const {
#pragma unroll
    for (int c = 0; c < CT; ++c) d.dec[c] = taps[NQ * CIN * CT + c];
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        d.dec[c] = fmaf(xv[ci], tq[ci * CT + c], d.dec[c]);
    d.xcol = j ? px.xc.y : px.xc.x;
  }
  // lanes c >= C and masked rows: g0 = g1 = 0, so ddec = 0
  __device__ __forceinline__ float dd(const Row& g, const Quad& d,
                                      int c) const {
    return 4.0f * d.dec[c] * d.dec[c] * d.dec[c] * (g.g0[c] + d.xcol * g.g1[c]);
  }
};

// x: (B, H/2, W/2, CIN) of npix pixels; dS: (B, H, 2C) f32; weight: (CIN,
// C, 2, 2) f32; dx: like x; part: (64 CT + CT, gridDim.x) f32, this
// block's column (ldhead::quad_bwd_pass)
// (Two blocks an SM at C <= 4: the 128-register cap costs a few bytes of
// spill, and on an H100 the pass ran faster that way than as one block an
// SM of up to 198 registers.)
template <typename T, int CT>
__global__ void __launch_bounds__(THREADS, CT <= 4 ? 2 : 1) hr_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dS,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ xs, T* __restrict__ dx,
    float* __restrict__ part, int npix, int H, int W, int C,
    int zero_rows) {
  extern __shared__ __align__(16) float sm[];
  ldhead::load_taps<T, true>(weight, bias, C, sm);
  __syncthreads();
  ldhead::quad_bwd_pass<T, CT>(
      x, RowSumsGrad<CT>{dS, xs, H, W, C, zero_rows}, sm, dx, part, npix);
}

// The columns of `part` added in a fixed order (ldhead::sum_columns).
__global__ void __launch_bounds__(THREADS) hr_sum_kernel(
    const float* __restrict__ part, int nblk, int C,
    float* __restrict__ dweight, float* __restrict__ dbias) {
  ldhead::sum_columns(part, nblk, C, dweight, dbias);
}

template <typename T, int CT>
int launch_bwd(const T* x, const float* dS, const float* weight,
               const float* bias, const float* xs, T* dx, float* part,
               float* dweight, float* dbias, int npix, int H, int W, int C,
               int zero_rows, cudaStream_t s) {
  int rc = ldhead::allow_pass_smem(hr_bwd_kernel<T, CT>, CT);
  if (rc) return rc;
  const int nblk = ldhead::pass_blocks(npix);
  hr_bwd_kernel<T, CT><<<nblk, THREADS, ldhead::bwd_smem_bytes(CT), s>>>(
      x, dS, weight, bias, xs, dx, part, npix, H, W, C, zero_rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  hr_sum_kernel<<<ldhead::sum_blocks(CT), THREADS, 0, s>>>(part, nblk, C,
                                                           dweight, dbias);
  return (int)cudaGetLastError();
}

template <typename T>
int hr_bwd(const void* x, const void* dS, const void* weight,
           const void* bias, const void* xs, void* part, void* dx,
           void* dweight, void* dbias, int B, int H, int W, int cin, int C,
           int zero_rows, void* stream) {
  if (C < 1 || C > ldhead::MAXC || cin != CIN || H % 2 || W % 2 || B < 1)
    return (int)cudaErrorInvalidValue;
  auto X = static_cast<const T*>(x);
  auto G = static_cast<const float*>(dS);
  auto K = static_cast<const float*>(weight);
  auto Bi = static_cast<const float*>(bias);
  auto Xs = static_cast<const float*>(xs);
  auto DX = static_cast<T*>(dx);
  auto P = static_cast<float*>(part);
  auto DW = static_cast<float*>(dweight);
  auto DB = static_cast<float*>(dbias);
  const int npix = B * (H / 2) * (W / 2);
  auto s = static_cast<cudaStream_t>(stream);
  switch (ldhead::lane_pad(C)) {
    case 1:
      return launch_bwd<T, 1>(X, G, K, Bi, Xs, DX, P, DW, DB, npix, H, W, C,
                              zero_rows, s);
    case 2:
      return launch_bwd<T, 2>(X, G, K, Bi, Xs, DX, P, DW, DB, npix, H, W, C,
                              zero_rows, s);
    case 4:
      return launch_bwd<T, 4>(X, G, K, Bi, Xs, DX, P, DW, DB, npix, H, W, C,
                              zero_rows, s);
    default:
      return launch_bwd<T, 8>(X, G, K, Bi, Xs, DX, P, DW, DB, npix, H, W, C,
                              zero_rows, s);
  }
}

}  // namespace

// x: (B, H/2, W/2, cin) bf16, cin = 16; weight: (cin, C, 2, 2) f32 (the
// parameter); bias: (C,) f32; xs: (W,) f32; S: (B, H, 2C) f32; C <= 8.
LD_API int ld_head_rowsums_op_fwd(const void* x, const void* weight,
                                  const void* bias, const void* xs, void* S,
                                  int B, int H, int W, int cin, int C,
                                  int zero_rows, void* stream) {
  return ldhead::launch_head_rowsums<bf16, true>(
      x, weight, bias, xs, S, B, H, W, cin, C, zero_rows, /*act=square*/ 0,
      stream);
}

// The same on float32 planes: x f32.
LD_API int ld_head_rowsums_op_fwd_f32(const void* x, const void* weight,
                                      const void* bias, const void* xs,
                                      void* S, int B, int H, int W, int cin,
                                      int C, int zero_rows, void* stream) {
  return ldhead::launch_head_rowsums<float, true>(
      x, weight, bias, xs, S, B, H, W, cin, C, zero_rows, /*act=square*/ 0,
      stream);
}

// x, weight, bias, xs as above; dS: (B, H, 2C) f32; part: (65 C, ceil(B
// H/2 W/2 / 512)) f32 scratch (C in {1, 2, 4, 8}; any contents); dx: (B,
// H/2, W/2, cin) bf16; dweight: (cin, C, 2, 2) f32 and dbias: (C,) f32,
// written whole (any contents on entry). Two launches: the pass over x,
// then the fixed-order sum of its partials.
LD_API int ld_head_rowsums_op_bwd(const void* x, const void* dS,
                                  const void* weight, const void* bias,
                                  const void* xs, void* part, void* dx,
                                  void* dweight, void* dbias, int B, int H,
                                  int W, int cin, int C, int zero_rows,
                                  void* stream) {
  return hr_bwd<bf16>(x, dS, weight, bias, xs, part, dx, dweight, dbias, B,
                      H, W, cin, C, zero_rows, stream);
}

// The same on float32 planes: x, dx f32.
LD_API int ld_head_rowsums_op_bwd_f32(const void* x, const void* dS,
                                      const void* weight, const void* bias,
                                      const void* xs, void* part, void* dx,
                                      void* dweight, void* dbias, int B,
                                      int H, int W, int cin, int C,
                                      int zero_rows, void* stream) {
  return hr_bwd<float>(x, dS, weight, bias, xs, part, dx, dweight, dbias, B,
                       H, W, cin, C, zero_rows, stream);
}
