// The 2x2/s2 head's quads, shared by K10's backward (head_rowsums_op.cu)
// and K9's output head (lane_maps_op.cu at k = 2): the one-pass backward
// over the head's input, the fixed-order sum of its per-block partials,
// and the vector loads and stores of an output row's run of lanes.
//
// A 2x2/s2 transposed convolution has no overlap: input pixel (h, w) alone
// makes output pixels (2h + i, 2w + j), its quad q = 2 i + j. So the
// output gradient of a quad, the input gradient and the pixel's share of
// the weight gradient are all local to the pixel, and the whole backward
// is ONE pass over x with no gradient plane. A block of 256 threads owns
// TILE = 512 consecutive input pixels, two sub-tiles of one pixel a
// thread. Per pixel: its 16 channels (16-byte loads); per quad, the f32
// gradient dd of the output before its rounding, from a policy `Grad`
// (K10: 4 dec^3 (dS0 + xs dS1) from the logits recomputed from the taps;
// K9's head: dy as the caller gives it); dbias += dd (f32, in registers);
// dp = T(dd) in registers; dx = T(sum dp K) written once. The sub-tile's
// x and dp go to shared memory, where each thread folds x^T dp for its one
// or two weight-gradient entries in pixel order. A block writes its
// 64 CT + CT partial sums to its column of `part`; a second, tiny launch
// (`sum_columns`) adds the columns in a fixed order, one warp an entry. No
// atomics, no zero fill: dweight and dbias reproduce themselves bit for
// bit, and the partition (TILE pixels a block) depends on the shape alone.
//
// Bound on the card: x read and dx written once (and K9's dy read once),
// about 64 CT FFMA per pixel for dx and as many for the weight gradient:
// HBM bounds it.

#pragma once

#include "head_rowsums.cuh"

namespace ldhead {

constexpr int SUB = 2;               // sub-tiles a block
constexpr int TILE = SUB * THREADS;  // input pixels a block
constexpr int XP = CIN + 4;          // pitch of the staged x, floats

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

// The backward pass over x: (npix, CIN) of type T; `sm`: bwd_smem_bytes(CT)
// of shared memory that starts with the taps (load_taps<T, true>, synced);
// dx: like x; part: (64 CT + CT, gridDim.x) f32, this block's column of
// the weight-gradient entries o = (ci 4 + q) CT + c, then the CT bias
// entries. `grad` gives the quads' output gradients:
//   Pixel pixel(p)                 what the pixel's quads share
//   void row(px, i, Row&)          what output row 2h + i shares
//   void quad(px, j, x, taps, tq, Quad&)   quad q = 2 i + j (tq: its taps)
//   float dd(row, quad, c)         lane c's gradient, f32; zero for c >= C
template <typename T, int CT, class Grad>
__device__ __forceinline__ void quad_bwd_pass(const T* __restrict__ x,
                                              const Grad& grad, float* sm,
                                              T* __restrict__ dx,
                                              float* __restrict__ part,
                                              int npix) {
  constexpr int NO = NQ * CIN * CT;                  // weight entries
  constexpr int OPT = (NO + THREADS - 1) / THREADS;  // entries a thread
  constexpr int DP = dp_pitch(CT);
  float* taps = sm;
  float* xt = sm + taps_floats(CT);
  float* dps = xt + THREADS * XP;
  float* red = dps + THREADS * DP;

  float acc[OPT], db[CT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int c = 0; c < CT; ++c) db[c] = 0.0f;
  float* xrow = xt + threadIdx.x * XP;
  float* dprow = dps + threadIdx.x * DP;

#pragma unroll 1
  for (int sub = 0; sub < SUB; ++sub) {
    const int p = (blockIdx.x * SUB + sub) * THREADS + threadIdx.x;
    float xv[CIN];
    if (p < npix) {
      load_pixel<false>(x + (size_t)p * CIN, xv);
      const typename Grad::Pixel px = grad.pixel(p);
      float dxa[CIN];
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) dxa[ci] = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        typename Grad::Row g;
        grad.row(px, i, g);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = 2 * i + j;
          const float* tq = taps + q * CIN * CT;
          typename Grad::Quad d;
          grad.quad(px, j, xv, taps, tq, d);
          float dp[CT];
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float dd = grad.dd(g, d, c);
            db[c] += dd;  // the bias gradient from the f32 value
            dp[c] = round_as<T>(dd);
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
// dweight (CIN, C, 2, 2) and dbias (C,) in the parameters' layouts. Blocks
// of THREADS threads, sum_blocks(lane_pad(C)) of them.
__device__ __forceinline__ void sum_columns(const float* __restrict__ part,
                                            int nblk, int C,
                                            float* __restrict__ dweight,
                                            float* __restrict__ dbias) {
  const int ct = lane_pad(C), no = NQ * CIN * ct;
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

// blocks of the pass over npix pixels, and of the sum at CT lanes
inline int pass_blocks(int npix) { return (npix + TILE - 1) / TILE; }
inline int sum_blocks(int ct) {
  return (NQ * CIN * ct + ct + THREADS / 32 - 1) / (THREADS / 32);
}

// Allow a pass kernel its bwd_smem_bytes(ct) of shared memory -> 0 or a
// CUDA error.
template <class K>
int allow_pass_smem(K kernel, int ct) {
  const int smem = bwd_smem_bytes(ct);
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// An aligned word of NB bytes
template <int NB> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// N values of a bf16 or f32 array as floats, in vector loads through the
// read-only path: N * sizeof(TO) bytes, a power of two from 2 to 64, the
// address aligned to min(that, 16).
template <int N, typename TO>
__device__ __forceinline__ void load_vec(const TO* p, float (&f)[N]) {
  constexpr int NB = N * (int)sizeof(TO);
  constexpr int WB = NB < 16 ? NB : 16;
  using W = typename Word<WB>::type;
  W w[NB / WB];
#pragma unroll
  for (int k = 0; k < NB / WB; ++k)
    w[k] = __ldg(reinterpret_cast<const W*>(p) + k);
  const TO* e = reinterpret_cast<const TO*>(w);
#pragma unroll
  for (int n = 0; n < N; ++n) f[n] = ldf(e, n);
}

// N floats rounded once to TO and stored in vector stores (as load_vec).
template <int N, typename TO>
__device__ __forceinline__ void store_vec(TO* p, const float (&f)[N]) {
  constexpr int NB = N * (int)sizeof(TO);
  constexpr int WB = NB < 16 ? NB : 16;
  using W = typename Word<WB>::type;
  W w[NB / WB];
  TO* e = reinterpret_cast<TO*>(w);
#pragma unroll
  for (int n = 0; n < N; ++n) stf(e, n, f[n]);
#pragma unroll
  for (int k = 0; k < NB / WB; ++k) reinterpret_cast<W*>(p)[k] = w[k];
}

// The run of an output row that one input pixel's quads of that row make:
// output pixels 2w and 2w + 1, C lanes each, v[j][c] = run[j C + c]. At C
// = CT (a power of two) the run is 2 CT values at an offset that is a
// multiple of 2 CT, so it moves in aligned vectors; at other C (3, 5, 6,
// 7) value by value. Lanes c >= C read as zero and are not written.
template <int CT, typename TO>
__device__ __forceinline__ void load_run(const TO* run, int C,
                                         float (&v)[2][CT]) {
  if (C == CT) {
    float f[2 * CT];
    load_vec<2 * CT>(run, f);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < CT; ++c) v[j][c] = f[j * CT + c];
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        v[j][c] = c < C ? ldf(run, j * C + c) : 0.0f;
  }
}

template <int CT, typename TO>
__device__ __forceinline__ void store_run(TO* run, int C,
                                          const float (&v)[2][CT]) {
  if (C == CT) {
    float f[2 * CT];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < CT; ++c) f[j * CT + c] = v[j][c];
    store_vec<2 * CT>(run, f);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < C) stf(run, j * C + c, v[j][c]);
  }
}

// The quads' output gradient read from the head's output gradient dy
// (B, 2 Hh, 2 Wh, C) of type TO (bf16 or f32), as given: K9's head, whose
// output has no moments and no activation after it.
template <typename TO, int CT>
struct OutputGrad {
  const TO* dy;
  int Wh, C;
  struct Pixel {
    const TO* run;  // output row 2h, column 2w
  };
  struct Row {
    float v[2][CT];
  };
  struct Quad {
    int j;
  };
  __device__ __forceinline__ Pixel pixel(int p) const {
    // output row 2h of image b is row 2 (b Hh + h) = 2 (p / Wh)
    return {dy + ((size_t)2 * (p / Wh) * 2 * Wh + 2 * (p % Wh)) * C};
  }
  __device__ __forceinline__ void row(const Pixel& px, int i, Row& g) const {
    load_run<CT>(px.run + (size_t)i * 2 * Wh * C, C, g.v);
  }
  __device__ __forceinline__ void quad(const Pixel&, int j,
                                       const float (&)[CIN], const float*,
                                       const float*, Quad& d) const {
    d.j = j;
  }
  __device__ __forceinline__ float dd(const Row& g, const Quad& d,
                                      int c) const {
    return g.v[d.j][c];
  }
};

}  // namespace ldhead
