// K1's device code: an ERFNet NonBottleneck1D block (inference, BatchNorm
// folded) as two passes of a row tile on the tensor cores, shared by the
// single-block kernel (`nb1d.cu`, two launches a block) and, through
// `block_passes`, by the persistent kernels (`nb1d_chain.cu`,
// `encoder_fused.cu`, `decoder_fused.cu`: two grid passes a block, one
// grid.sync() between them). All run this same code on the same inputs, so
// their outputs are bit for bit those of K1 launched block by block.
//
//   pass A:  t   = bf16(relu(conv3x1(x)         + b1))     staged rows
//            mid = bf16(relu(conv1x3(t)    * m1 + a1))     -> device memory
//   pass B:  t   = bf16(relu(conv3x1_d(mid)     + b3))     staged rows
//            out = bf16(relu(conv1x3_d(t)  * m2 + a2 + x)) -> device memory
//
// axis 0 (3x1): taps at rows h-d, h, h+d; axis 1 (1x3): columns w-d, w,
// w+d; taps off the plane read zero (a tap entirely off it, d >= H or d >=
// W, is skipped). A tile is MT pixels x all C channels. Rows of W <= MT
// pixels: a tile owns R = MT / W whole rows. Wider rows: a tile owns one
// segment of one row, columns c0 .. c0 + MT - 1 (the last segment of a
// row partial where MT does not divide W). The 1x3 convolution reads only
// its own image row, so a pass runs its 3x1 convolution into rows staged
// in shared memory (bf16, the rounding K1 always had between the two),
// then the 1x3 one from them, with no plane written and no barrier in
// between. The staged rows carry a halo of hd = halo(W, d) columns on each
// side, so the 1x3 taps are offset views of them: zero for whole rows
// (the columns off the plane); for a segment, the 3x1 convolution of the
// columns c0 - hd .. c0 - 1 and c0 + MT .. c0 + MT + hd - 1, computed in a
// first round of the pass's chunks (the halo round: 2 hd <= 32 pixels, on
// the warps whose pixels cover them), zero where they fall off the plane.
// A halo pixel runs the products of the same pixel in the neighbouring
// tile in the same order, so every output is that of the whole-row form
// bit for bit. Only the 3x1 convolution reads rows other tiles write,
// hence one grid-wide barrier a pass.
//
// Products: bf16 mma.sync m16n8k16 with ldmatrix (tc_common.cuh), f32
// accumulators in registers, 8 warps: C = 128 as 2 (pixels) x 4 (channels)
// warps of 32 x 32, C = 64 as 4 x 2 warps of 32 x 32, C = 16 as 8 x 1 of
// 32 x 16 (MT = 64, 128, 256 pixels a tile). K runs in chunks of KC input
// channels of one tap through a ring of STAGES shared-memory stages filled
// by 16-byte cp.async copies: the 3x1 convolution's chunks bring the
// shifted input rows and the tap's weight rows, the 1x3 convolution's only
// weight rows. One barrier a chunk. The epilogues run on the accumulators
// in registers. Weights never depend on the previous pass, so a persistent
// kernel issues the first chunks of the next pass's weights before the
// grid.sync() (`issue_weights`).
#pragma once

#include <cooperative_groups.h>

#include "conv_s2_mma.cuh"

namespace nb1d {

constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 3;     // depth of the cp.async ring

template <int C>
struct Cfg {
  static constexpr int KC = C >= 32 ? 32 : 16;  // channels a chunk
  static constexpr int CPT = C / KC;            // chunks a tap
  static constexpr int WM = 2;                  // m16 tiles a warp
  static constexpr int WN = C >= 64 ? 4 : 2;    // n8 tiles a warp
  static constexpr int NWN = C / (8 * WN);      // warps along channels
  static constexpr int NWM = 8 / NWN;           // warps along pixels
  static constexpr int MT = NWM * 16 * WM;      // pixels a tile
  static constexpr int LDA = KC + 8, LDB = C + 8, LDT = C + 8;  // pitches
  static constexpr int A_ELEMS = MT * LDA, B_ELEMS = KC * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int RING_BYTES = STAGES * STAGE * 2;
  static constexpr int VA = KC / 8, VB = C / 8;  // 16-byte copies a row
  static_assert(NWN * NWM == 8 && CPT * KC == C && WN % 2 == 0 &&
                    NWN * 8 * WN == C,
                "8 warps cover the tile");
};

// Whether a pass on rows of W pixels needs the segments' code (kSeg).
template <int C>
__host__ __device__ inline bool seg_rows(int W) {
  return W > Cfg<C>::MT;
}

// the halo of the staged rows: d columns, none where the 1x3 taps at +-d
// miss the row entirely (d >= W, the taps skipped)
__host__ __device__ inline int halo(int W, int d) { return d < W ? d : 0; }

// The tiles of a pass over `rows` rows of W pixels: R = MT / W whole rows
// each, or one segment of MT columns each where W > MT.
template <int C>
__host__ __device__ inline int tile_count(int rows, int W) {
  constexpr int MT = Cfg<C>::MT;
  if (W > MT) return rows * ((W + MT - 1) / MT);
  const int R = MT / W;
  return (rows + R - 1) / R;
}

// Dynamic shared memory of a pass on rows of W pixels at dilation d: the
// ring, then the staged rows: R rows of W + 2 halo pixels, or one segment
// of MT + 2 halo pixels.
template <int C>
__host__ __device__ inline int smem_bytes(int W, int d) {
  using K = Cfg<C>;
  const int h2 = 2 * halo(W, d);
  const int staged = W > K::MT ? K::MT + h2 : (K::MT / W) * (W + h2);
  return K::RING_BYTES + staged * K::LDT * 2;
}

// One pass: conv0 (axis 0) of `in` with bias b0, relu, bf16 -> staged
// rows; conv1 (axis 1) of them, * mul + add (+ res), relu, bf16 -> out.
// w0, w1: (3, C, C) [tap][ci][co]; planes (rows, W, C) with rows = B * H.
struct Pass {
  const bf16* in;
  const bf16* w0;
  const bf16* w1;
  const float* b0;
  const float* mul;
  const float* add;
  const bf16* res;  // nullptr: no residual
  bf16* out;
  int rows, H, W, d;
};

// pass A of a block (w: (4, 3, C, C), v: (6, C) = b1 m1 a1 b3 m2 a2)
template <int C>
__host__ __device__ inline Pass pass_a(const bf16* x, const bf16* w,
                                       const float* v, bf16* mid, int rows,
                                       int H, int W) {
  return {x, w, w + 3 * C * C, v, v + C, v + 2 * C, nullptr, mid, rows, H, W,
          1};
}

// pass B of the same block, at its dilation d, with the residual x
template <int C>
__host__ __device__ inline Pass pass_b(const bf16* x, const bf16* mid,
                                       const bf16* w, const float* v, int d,
                                       bf16* out, int rows, int H, int W) {
  return {mid, w + 6 * C * C, w + 9 * C * C, v + 3 * C, v + 4 * C, v + 5 * C,
          x, out, rows, H, W, d};
}

// A pass's shape, whole rows (kSeg = false): R rows a tile, the taps of
// each convolution (3, or 1 where the off-centre taps miss the plane), the
// staged rows' halo and width, the chunks of conv0 (nA) and of the pass
// (n), the tiles, the pixels of a tile (RW = R W) and of the plane.
template <bool kSeg>
struct Geo {
  int R, n0, n1, hal, TW, nA, n, ntiles, RW, npix;
  static constexpr int nseg = 1, nH = 0;  // one tile spans whole rows
};

// Segments (kSeg = true): R = 1 and segments of SW = MT columns, nseg to a
// row; nH: the chunks of the halo round (one round of conv0's chunks where
// the segment has a halo, else 0), which nA includes; RW = SW.
template <>
struct Geo<true> {
  int R, n0, n1, hal, TW, nA, n, ntiles, RW, npix, nseg, SW, nH;
};

template <int C, bool kSeg>
__device__ __forceinline__ Geo<kSeg> geo_of(const Pass& ps) {
  constexpr int MT = Cfg<C>::MT;
  Geo<kSeg> g;
  if constexpr (kSeg) {
    g.nseg = (ps.W + MT - 1) / MT;
    g.R = 1;
    g.SW = MT;
  } else {
    g.R = MT / ps.W;
  }
  g.n0 = ps.d < ps.H ? 3 : 1;
  g.n1 = ps.d < ps.W ? 3 : 1;
  g.hal = halo(ps.W, ps.d);
  if constexpr (kSeg) {
    g.TW = MT + 2 * g.hal;
    g.nH = g.hal > 0 ? g.n0 * Cfg<C>::CPT : 0;
    g.nA = g.nH + g.n0 * Cfg<C>::CPT;
  } else {
    g.TW = ps.W + 2 * g.hal;
    g.nA = g.n0 * Cfg<C>::CPT;
  }
  g.n = g.nA + g.n1 * Cfg<C>::CPT;
  g.ntiles = kSeg ? ps.rows * g.nseg : (ps.rows + g.R - 1) / g.R;
  g.RW = kSeg ? MT : g.R * ps.W;
  g.npix = ps.rows * ps.W;
  return g;
}

// the pixels of a staged row's middle: W, or a segment's SW
template <bool kSeg>
__device__ __forceinline__ int staged_width(const Pass& ps,
                                            const Geo<kSeg>& g) {
  if constexpr (kSeg) return g.SW;
  else return ps.W;
}

// The tile functions below take kSeg: false for passes of whole rows
// (nseg = 1, no halo round), true for passes of segments (nseg > 1), so
// that the whole rows' code carries nothing of the segments'. A kernel is
// built with one of the two (`seg_rows`): every NB1D pass of an image has
// rows wider than its tile, or none has.

// In a pass of segments, the plane pixel of row m of tile u's products,
// or -1 where there is none (past the row's end, off the plane). hr: the
// halo round, whose rows m < 2 hal are the segment's halo columns, the
// left ones first. (Whole rows: pixel u RW + m, where m < RW and it lies
// on the plane.)
template <int C, bool kSeg>
__device__ __forceinline__ int seg_pixel(const Pass& ps, const Geo<kSeg>& g,
                                         int u, int m, bool hr) {
  const int c0 = (u % g.nseg) * Cfg<C>::MT;
  const int col =
      hr ? c0 - g.hal + (m < g.hal ? m : m + Cfg<C>::MT) : c0 + m;
  const bool ok = (!hr || m < 2 * g.hal) && col >= 0 && col < ps.W;
  return ok ? (u / g.nseg) * ps.W + col : -1;
}

// The staged pixel that row m of conv0's products fills (halo round: the
// segment's halo columns, 0 .. hal - 1 and MT + hal .. MT + 2 hal - 1)
template <int C, bool kSeg>
__device__ __forceinline__ int staged_pixel(const Pass& ps,
                                            const Geo<kSeg>& g, int m,
                                            bool hr) {
  if (kSeg && hr) return m < g.hal ? m : m + Cfg<C>::MT;
  const int sw = staged_width(ps, g);
  return (m / sw) * g.TW + m % sw + g.hal;
}

// the row or column offset of tap j of a convolution with `taps` taps
__device__ __forceinline__ int tap_offset(int j, int taps, int d) {
  return taps == 3 ? (j - 1) * d : 0;
}

template <int C>
__device__ __forceinline__ bf16* stage(unsigned char* smem, int i) {
  return reinterpret_cast<bf16*>(smem) + (i % STAGES) * Cfg<C>::STAGE;
}

// Chunk i's weight rows (KC x C of one tap) into its ring stage.
template <int C, bool kSeg>
__device__ __forceinline__ void load_b(const Pass& ps, const Geo<kSeg>& g,
                                       int i, unsigned char* smem) {
  using K = Cfg<C>;
  const bool first = i < g.nA;
  const int j0 = kSeg && i < g.nH ? i : i - g.nH;  // conv0's chunk
  const int j = first ? (kSeg ? j0 : i) : i - g.nA;
  const int t = (first ? g.n0 : g.n1) == 3 ? j / K::CPT : 1;
  const bf16* src =
      (first ? ps.w0 : ps.w1) + ((size_t)t * C + (j % K::CPT) * K::KC) * C;
  bf16* sB = stage<C>(smem, i) + K::A_ELEMS;
  for (int e = threadIdx.x; e < K::KC * K::VB; e += THREADS) {
    const int r = e / K::VB, c = e % K::VB;
    ldtc::cp_async16(sB + r * K::LDB + c * 8, src + (size_t)r * C + c * 8,
                     true);
  }
}

// Chunk i < nA's input rows for tile u: the pixel of product row m (u RW
// + m, or seg_pixel) shifted by the tap's rows, KC channels, zero off the
// plane and where there is no pixel.
template <int C, bool kSeg>
__device__ __forceinline__ void load_a(const Pass& ps, const Geo<kSeg>& g,
                                       int i, int u, unsigned char* smem) {
  using K = Cfg<C>;
  const bool hr = kSeg && i < g.nH;
  const int j = kSeg && !hr ? i - g.nH : i;
  const int off = tap_offset(j / K::CPT, g.n0, ps.d);
  const int c0 = (j % K::CPT) * K::KC;
  bf16* sA = stage<C>(smem, i);
  for (int e = threadIdx.x; e < K::MT * K::VA; e += THREADS) {
    const int m = e / K::VA, v = e % K::VA;
    const int p = kSeg ? seg_pixel<C>(ps, g, u, m, hr) : u * g.RW + m;
    const int hh = (p / ps.W) % ps.H + off;
    const bool ok = (kSeg ? p >= 0 : m < g.RW && p < g.npix) && hh >= 0 &&
                    hh < ps.H;
    const bf16* src =
        ok ? ps.in + (long long)(p + off * ps.W) * C + c0 + v * 8 : ps.in;
    ldtc::cp_async16(sA + m * K::LDA + v * 8, src, ok);
  }
}

// acc[mi][nj] += A (this warp's 2 m16 row tiles) @ B (its WN n8 columns
// of the chunk's weight rows, depth k .. k + 15)
template <int C>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][Cfg<C>::WN][4],
                                          const lds2::Mma<bf16>::A (&a)[2],
                                          const bf16* sB, int k, int n0) {
  using K = Cfg<C>;
  using M = lds2::Mma<bf16>;
#pragma unroll
  for (int nj = 0; nj < K::WN; nj += 2) {
    M::B b[2];
    M::load_b2(b, sB, K::LDB, k, n0 + nj * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      M::mma(acc[mi][nj], a[mi], b[0]);
      M::mma(acc[mi][nj + 1], a[mi], b[1]);
    }
  }
}

// One tile u (rows u R .. u R + R - 1, or one segment of a row) of pass
// `ps`. `pre`: the first
// STAGES - 1 chunks' weight rows were issued (issue_weights) as one
// earlier cp.async group. Starts by writing the ring and the staged rows
// and ends after reading them: a caller that runs a second tile in the
// same block puts a __syncthreads() between the two.
template <int C, bool kSeg>
__device__ __forceinline__ void tile(const Pass& ps, const Geo<kSeg>& g,
                                     int u, bool pre, unsigned char* smem) {
  using K = Cfg<C>;
  using M = lds2::Mma<bf16>;
  bf16* T = reinterpret_cast<bf16*>(smem + K::RING_BYTES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / K::NWN, wn = warp % K::NWN;
  const int m0 = wm * 16 * K::WM, n0 = wn * 8 * K::WN;

  auto prologue = [&](int i) {
    if (i < g.n) {
      if (i < g.nA) load_a<C, kSeg>(ps, g, i, u, smem);
      if (!pre) load_b<C, kSeg>(ps, g, i, smem);
    }
    ldtc::cp_async_commit();
  };
  if constexpr (kSeg) {
    // (not unrolled: unrolled, the segments' index arithmetic spills in
    // encoder_fused at 128 registers)
#pragma unroll 1
    for (int i = 0; i < STAGES - 1; ++i) prologue(i);
  } else {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) prologue(i);
  }

  float acc[2][K::WN][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < K::WN; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
  const int gr = lane >> 2, tg = lane & 3;

#pragma unroll 1
  for (int i = 0; i < g.n; ++i) {
    ldtc::cp_async_wait<STAGES - 2>();  // this thread's chunk i landed
    // every thread's chunk i (and the staged rows) visible; every warp
    // done with chunk i - 1, whose stage is refilled next
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < g.n) {
      if (nx < g.nA) load_a<C, kSeg>(ps, g, nx, u, smem);
      load_b<C, kSeg>(ps, g, nx, smem);
    }
    ldtc::cp_async_commit();  // possibly empty: one group per iteration
    const bf16* sB = stage<C>(smem, i) + K::A_ELEMS;
    if (i < g.nA) {
      // (in the halo round only the warps whose rows hold halo columns)
      if (!kSeg || i >= g.nH || m0 < 2 * g.hal) {
        const bf16* sA = stage<C>(smem, i);
#pragma unroll
        for (int k = 0; k < K::KC; k += 16) {
          M::A a[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            M::load_a(a[mi], sA, K::LDA, m0 + mi * 16, k);
          mma_chunk<C>(acc, a, sB, k, n0);
        }
      }
    } else {
      const int j = i - g.nA;
      // this lane's ldmatrix rows of the staged rows, one per m16 tile:
      // pixel m at (row m / SW, column m % SW + halo + the tap's offset);
      // a pixel past the tile's R rows reads pixel 0, its output is never
      // stored
      const bf16* sT[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = m0 + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int sw = staged_width(ps, g);
        const int pix = m < g.RW ? (m / sw) * g.TW + m % sw : 0;
        sT[mi] = T + (pix + g.hal + tap_offset(j / K::CPT, g.n1, ps.d)) *
                         K::LDT +
                 8 * (lane >> 4) + (j % K::CPT) * K::KC;
      }
#pragma unroll
      for (int k = 0; k < K::KC; k += 16) {
        M::A a[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldtc::ldmatrix_x4(a[mi].r, sT[mi] + k);
        mma_chunk<C>(acc, a, sB, k, n0);
      }
    }
    if ((kSeg && i == g.nH - 1) || i == g.nA - 1) {
      // conv0's epilogue, after the halo round and after conv0:
      // bf16(relu(acc + b0)) into the staged rows (read after the next
      // iteration's barrier), zero for a pixel off the plane; then the
      // accumulators start the next round
      const bool hr = kSeg && i < g.nH;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mi * 16 + gr + 8 * h;
          const bool keep = m < (hr ? 2 * g.hal : g.RW);
          // (whole rows: a pixel past the plane fills a staged pixel that
          // no stored output reads)
          const float on =
              !kSeg || seg_pixel<C>(ps, g, u, m, hr) >= 0 ? 1.0f
                                                                  : 0.0f;
          bf16* tr = T + staged_pixel<C, kSeg>(ps, g, m, hr) * K::LDT;
#pragma unroll
          for (int nj = 0; nj < K::WN; ++nj) {
            const int n = n0 + nj * 8 + 2 * tg;
            if (keep)
              store_bf2(tr + n,
                        on * fmaxf(acc[mi][nj][2 * h] + ps.b0[n], 0.0f),
                        on * fmaxf(acc[mi][nj][2 * h + 1] + ps.b0[n + 1],
                                   0.0f));
            acc[mi][nj][2 * h] = acc[mi][nj][2 * h + 1] = 0.0f;
          }
        }
    }
  }
  ldtc::cp_async_wait<0>();

  // conv1's epilogue: bf16(relu(acc * mul + add (+ res))) to the plane
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mi * 16 + gr + 8 * h;
      const int p = kSeg ? seg_pixel<C>(ps, g, u, m, false)
                         : u * g.RW + m;
      if (kSeg ? p < 0 : m >= g.RW || p >= g.npix) continue;
      bf16* o = ps.out + (size_t)p * C;
#pragma unroll
      for (int nj = 0; nj < K::WN; ++nj) {
        const int n = n0 + nj * 8 + 2 * tg;
        float y0 = fmaf(acc[mi][nj][2 * h], ps.mul[n], ps.add[n]);
        float y1 = fmaf(acc[mi][nj][2 * h + 1], ps.mul[n + 1], ps.add[n + 1]);
        if (ps.res != nullptr) {
          const float2 r = load_bf2_cg(ps.res + (size_t)p * C + n);
          y0 += r.x;
          y1 += r.y;
        }
        store_bf2(o + n, fmaxf(y0, 0.0f), fmaxf(y1, 0.0f));
      }
    }
}

// Zero the halo columns of the R staged whole rows (the epilogue writes
// only their W middle columns; a segment's tiles write their halo).
template <int C>
__device__ __forceinline__ void zero_halo(const Geo<false>& g,
                                          unsigned char* smem) {
  using K = Cfg<C>;
  if (g.hal == 0) return;
  bf16* T = reinterpret_cast<bf16*>(smem + K::RING_BYTES);
  const int per_row = 2 * g.hal * K::VB;
  for (int i = threadIdx.x; i < g.R * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) / K::VB, v = i % K::VB;
    const int col = c < g.hal ? c : g.TW - 2 * g.hal + c;
    *reinterpret_cast<uint4*>(T + (r * g.TW + col) * K::LDT + v * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The tiles u0, u0 + ustep, ... of pass `ps`, a barrier after each; `pre`
// as for `tile`, for the first of them; kSeg = seg_rows(W) (the caller's
// choice of code). The pass and its shape live in shared memory while its
// tiles run: read again after each barrier, they hold no registers across
// the tile's loop (a persistent kernel computes them at run time).
template <int C, bool kSeg>
__device__ __forceinline__ void pass_tiles(const Pass& pass, bool pre,
                                           unsigned char* smem, int u0,
                                           int ustep) {
  __shared__ Pass ps;
  __shared__ Geo<kSeg> g;
  __syncthreads();  // the block is done with the previous pass's copy
  if (threadIdx.x == 0) {
    ps = pass;
    g = geo_of<C, kSeg>(pass);
  }
  __syncthreads();
  // (read only after the first tile's barriers)
  if constexpr (!kSeg) zero_halo<C>(g, smem);
  for (int u = u0; u < g.ntiles; u += ustep) {
    tile<C, kSeg>(ps, g, u, pre, smem);
    pre = false;
    __syncthreads();  // the next tile rewrites the ring and the rows
  }
}

// Ahead of a persistent grid's barrier: the weight rows of the first
// STAGES - 1 chunks of this block's first tile of pass `ps`, one cp.async
// group, into the ring (after a barrier: the block is done with it).
// Returns whether the block has a tile in the pass and so issued them.
// kSeg as for pass_tiles.
template <int C, bool kSeg>
__device__ __forceinline__ bool issue_weights(const Pass& ps,
                                              unsigned char* smem) {
  const Geo<kSeg> g = geo_of<C, kSeg>(ps);
  if ((int)blockIdx.x >= g.ntiles) return false;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < g.n) load_b<C, kSeg>(ps, g, i, smem);
  ldtc::cp_async_commit();
  return true;
}

// issue_weights for pass A of the block with weights w on (rows, W, C)
template <int C, bool kSeg>
__device__ __forceinline__ bool issue_block_weights(const bf16* w, int rows,
                                                    int H, int W,
                                                    unsigned char* smem) {
  Pass ps = {};
  ps.w0 = w;
  ps.w1 = w + 3 * C * C;
  ps.rows = rows;
  ps.H = H;
  ps.W = W;
  ps.d = 1;
  return issue_weights<C, kSeg>(ps, smem);
}

// One whole block inside a persistent cooperative grid: pass A (x -> mid),
// its barrier, pass B (mid, x -> dst), with pass B's first weights issued
// before the barrier. The caller puts a barrier after pass B. `pre`: pass
// A's first weights were issued before the caller's last barrier
// (issue_block_weights). w: (4, 3, C, C) [conv][tap][ci][co]; v: (6, C) =
// b1 m1 a1 b3 m2 a2; x is only read. Thread 0 adds its barrier to
// `nsync`. kSeg as for pass_tiles.
template <int C, bool kSeg>
__device__ __forceinline__ void block_passes(
    cooperative_groups::grid_group& grid, const bf16* x, const bf16* w,
    const float* v, int d, bf16* mid, bf16* dst, int rows, int H, int W,
    unsigned char* smem, bool pre, int& nsync) {
  // pass B waits in shared memory while pass A runs, so that nothing of
  // it holds registers across pass A's tiles (pass_tiles' first barrier
  // publishes it)
  __shared__ Pass b;
  __syncthreads();
  if (threadIdx.x == 0) b = pass_b<C>(x, mid, w, v, d, dst, rows, H, W);
  pass_tiles<C, kSeg>(pass_a<C>(x, w, v, mid, rows, H, W), pre, smem,
                      blockIdx.x, gridDim.x);
  const bool pb = issue_weights<C, kSeg>(b, smem);
  grid.sync();
  if (threadIdx.x == 0) ++nsync;
  pass_tiles<C, kSeg>(b, pb, smem, blockIdx.x, gridDim.x);
}

}  // namespace nb1d
