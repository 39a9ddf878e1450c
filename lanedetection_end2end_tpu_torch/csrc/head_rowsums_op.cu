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
// Design of the backward: the 2x2/s2 transposed convolution has no
// overlap, input pixel (h, w) alone makes output pixels (2h + i, 2w + j),
// so ddec, dx and the pixel's share of dweight are all local to it: the
// whole backward is ONE pass over x, and no gradient plane is formed. A
// block of 256 threads owns TILE = 512 consecutive input pixels, two
// sub-tiles of one pixel a thread. Per pixel: its 16 channels (16-byte
// loads), the 2 x 2 quad's C logits in f32 from the taps in shared memory,
// ddec, dbias (f32, in registers), dp = T(ddec) in registers, dx = T(sum
// dp K) written once. The sub-tile's x and dp go to shared memory, where
// each thread folds x^T dp for its one or two weight-gradient entries in
// pixel order. A block writes its 64 C + C partial sums to its column of
// `part`; a second, tiny launch (hr_sum_kernel) adds the columns in a fixed
// order, one warp an entry. No atomics, no zero-fill, no gradient plane:
// dweight and dbias reproduce themselves bit for bit, and the partition
// (TILE pixels a block) depends on the shape alone.

#include "head_rowsums.cuh"

using ldhead::CIN;
using ldhead::NQ;
using ldhead::THREADS;

namespace {

constexpr int SUB = 2;                   // sub-tiles a block
constexpr int TILE = SUB * THREADS;      // input pixels a block
constexpr int XP = CIN + 4;              // pitch of the staged x, floats

// shared memory of the backward at CT lanes: the taps and biases, the
// sub-tile's x and dp, the warps' dbias parts (floats)
__host__ __device__ constexpr int taps_floats(int ct) {
  return (NQ * CIN * ct + ct + 3) / 4 * 4;
}
__host__ __device__ constexpr int dp_pitch(int ct) { return NQ * ct + 4; }
__host__ __device__ constexpr int bwd_smem_bytes(int ct) {
  return 4 * (taps_floats(ct) + THREADS * (XP + dp_pitch(ct)) +
              (THREADS / 32) * ct);
}

// x: (B, H/2, W/2, CIN) of npix pixels; dS: (B, H, 2C) f32; weight: (CIN,
// C, 2, 2) f32; dx: like x; part: (64 CT + CT, gridDim.x) f32, this
// block's column of the weight-gradient entries o = (ci 4 + q) CT + c
// (q = 2 i + j), then the CT bias entries
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
  constexpr int NO = NQ * CIN * CT;                  // weight entries
  constexpr int OPT = (NO + THREADS - 1) / THREADS;  // entries a thread
  constexpr int DP = dp_pitch(CT);
  float* taps = sm;
  float* xt = sm + taps_floats(CT);
  float* dps = xt + THREADS * XP;
  float* red = dps + THREADS * DP;
  ldhead::load_taps<T, true>(weight, bias, C, taps);
  __syncthreads();

  float acc[OPT], db[CT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int c = 0; c < CT; ++c) db[c] = 0.0f;
  const int Hh = H / 2, Wh = W / 2;
  float* xrow = xt + threadIdx.x * XP;
  float* dprow = dps + threadIdx.x * DP;

#pragma unroll 1
  for (int sub = 0; sub < SUB; ++sub) {
    const int p = (blockIdx.x * SUB + sub) * THREADS + threadIdx.x;
    float xv[CIN];
    if (p < npix) {
      ldhead::load_pixel<false>(x + (size_t)p * CIN, xv);
      const int w = p % Wh, hb = p / Wh;
      const int r0 = 2 * (hb % Hh), b = hb / Hh;
      const float2 xc =
          make_float2(__ldg(xs + 2 * w), __ldg(xs + 2 * w + 1));
      float dxa[CIN];
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) dxa[ci] = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool live = r0 + i >= zero_rows;
        const float* g = dS + ((size_t)b * H + r0 + i) * 2 * C;
        float g0[CT], g1[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          g0[c] = live && c < C ? __ldg(g + c) : 0.0f;
          g1[c] = live && c < C ? __ldg(g + C + c) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = 2 * i + j;
          const float* tq = taps + q * CIN * CT;
          float dec[CT];
#pragma unroll
          for (int c = 0; c < CT; ++c) dec[c] = taps[NQ * CIN * CT + c];
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
            for (int c = 0; c < CT; ++c)
              dec[c] = fmaf(xv[ci], tq[ci * CT + c], dec[c]);
          const float xcol = j ? xc.y : xc.x;
          float dp[CT];
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            // lanes c >= C and masked rows: g0 = g1 = 0, so ddec = 0
            const float dd =
                4.0f * dec[c] * dec[c] * dec[c] * (g0[c] + xcol * g1[c]);
            db[c] += dd;  // the bias gradient from the f32 value
            dp[c] = ldhead::round_as<T>(dd);
            dprow[q * CT + c] = dp[c];
          }
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
            for (int c = 0; c < CT; ++c)
              dxa[ci] = fmaf(dp[c], tq[ci * CT + c], dxa[ci]);
        }
      }
      float lo[8], hi[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) lo[k] = dxa[k], hi[k] = dxa[8 + k];
      store8(dx + (size_t)p * CIN, lo);  // one rounding to T
      store8(dx + (size_t)p * CIN + 8, hi);
    } else {
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) xv[ci] = 0.0f;
#pragma unroll
      for (int e = 0; e < NQ * CT; ++e) dprow[e] = 0.0f;
    }
#pragma unroll
    for (int ci = 0; ci < CIN; ci += 4)
      *reinterpret_cast<float4*>(xrow + ci) =
          make_float4(xv[ci], xv[ci + 1], xv[ci + 2], xv[ci + 3]);
    __syncthreads();  // the sub-tile's x and dp staged
    // this thread's weight-gradient entries: sum over the sub-tile's
    // pixels, in order, of x[ci] dp[q][c]
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      const int o = threadIdx.x + k * THREADS;
      if (o < NO) {
        const float* xo = xt + o / (NQ * CT);
        const float* dpo = dps + o % (NQ * CT);
        float a = acc[k];
#pragma unroll 8
        for (int pp = 0; pp < THREADS; ++pp)
          a = fmaf(xo[pp * XP], dpo[pp * DP], a);
        acc[k] = a;
      }
    }
    __syncthreads();  // the next sub-tile rewrites x and dp
  }

  const int nblk = gridDim.x;
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int o = threadIdx.x + k * THREADS;
    if (o < NO) part[(size_t)o * nblk + blockIdx.x] = acc[k];
  }
  // the bias gradient: fold the warp, then the warps in order
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    for (int off = 16; off > 0; off >>= 1)
      db[c] += __shfl_down_sync(0xffffffffu, db[c], off);
    if (lane == 0) red[warp * CT + c] = db[c];
  }
  __syncthreads();
  if (threadIdx.x < CT) {
    float v = 0.0f;
    for (int wp = 0; wp < THREADS / 32; ++wp) v += red[wp * CT + threadIdx.x];
    part[(size_t)(NO + threadIdx.x) * nblk + blockIdx.x] = v;
  }
}

// The columns of `part` (nblk of them) added in a fixed order, one warp an
// entry: lane l takes columns l, l + 32, ..., then the lanes fold. Writes
// dweight (CIN, C, 2, 2) and dbias (C,) in the parameters' layouts.
__global__ void __launch_bounds__(THREADS) hr_sum_kernel(
    const float* __restrict__ part, int nblk, int C,
    float* __restrict__ dweight, float* __restrict__ dbias) {
  const int ct = ldhead::lane_pad(C), no = NQ * CIN * ct;
  const int o = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (o >= no + ct) return;  // the whole warp
  const float* row = part + (size_t)o * nblk;
  float v = 0.0f;
  for (int k = lane; k < nblk; k += 32) v += row[k];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  const int c = o % ct;
  if (c >= C) return;
  if (o < no)
    dweight[((o / (NQ * ct)) * C + c) * NQ + (o / ct) % NQ] = v;
  else
    dbias[c] = v;
}

template <typename T, int CT>
int launch_bwd(const T* x, const float* dS, const float* weight,
               const float* bias, const float* xs, T* dx, float* part,
               float* dweight, float* dbias, int npix, int H, int W, int C,
               int zero_rows, cudaStream_t s) {
  const int smem = bwd_smem_bytes(CT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hr_bwd_kernel<T, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nblk = (npix + TILE - 1) / TILE;
  hr_bwd_kernel<T, CT><<<nblk, THREADS, smem, s>>>(
      x, dS, weight, bias, xs, dx, part, npix, H, W, C, zero_rows);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int entries = NQ * CIN * CT + CT;
  hr_sum_kernel<<<(entries + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                  s>>>(part, nblk, C, dweight, dbias);
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
