// The weight gradient of a 3-tap convolution in bf16, shared by the
// training kernels nb_half_bwd.cu (K6 / K7) and packed_conv.cu (K11):
//
//   dk[t, ci, co] = sum_p f(in[p + tap_t])[ci] * dy[p, co]
//
// with taps at -d, 0, +d along rows (axis 0) or columns (axis 1) and f the
// BatchNorm prologue of conv3tap.cuh when pmul != nullptr. Replaces, in
// bf16, the weight gradients of the TPU kernels `_half_a_bwd_kernel`,
// `_half_b_bwd_kernel` (lanedetection_end2end_tpu/ops/pallas_nb_block.py:
// 212, :339) and K11's `_wgrad_kernel` (pallas_packed_conv.py:81) and
// merged backward (:167).
//
// Bound. 6*C^2 FLOP per pixel against 4*C bytes (in and dy read): the
// bytes bound it at every C, as the convolution's.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md): 1.287 ms of card time a
// default bf16 train step in 68 launches (`chip_smoke.py --profile`, with
// wgmma at C = 16), against 0.26 ms for their bytes: 20% of the bound.
// It was not broken down apart from conv3tap.cuh's tile, whose clock64
// breakdown put most of a launch in per-thread latency; this one runs
// 16-24 warps an SM. At C = 16,
// mma.sync against the quarter-used wgmma, both on this ring, in one call
// (`tools/prof_conv3tap.py`, two runs each, card time): the backward of
// nb_half_a at (8, 128, 256, 16) 0.0973 / 0.0976 ms against 0.1017 /
// 0.1016, of nb_half_b 0.1106 / 0.1104 against 0.1154 / 0.1154, each
// with two launches of this kernel; so C = 16 runs on mma.sync.
//
// Design. The products are bf16 `wgmma` m64 x C x k16 with both operands in
// shared memory: M = input channels, N = output channels, K = the pixels of
// a tile of conv3tap.cuh's geometry (TileGeo, 64 pixels), A the staged
// input pixels and B the staged dy of the tile, both read MN-major from
// 16-byte column planes (plane_desc: the transposed-A and transposed-B
// forms), so no transpose is written and a tap's view may start at any
// staged pixel. Persistent blocks of warpgroups walk the tiles through
// a ring of STAGES stages filled by 16-byte cp.async (zero fill off the
// plane; the prologue applied in place to the input pixels on the plane by
// the thread that copied them, then a proxy fence). C = 16 and 64: a block
// sums all three taps of its tiles from one staged run of input pixels
// (the tile and d more rows or columns on each side), so the plane and dy
// are read about once; each of three warpgroups sums one tap. At C = 16
// the m64 product would be a quarter used, so the products there are
// mma.sync m16n8k16 with both operands by ldmatrix.trans from the same
// planes, one k16 step of the tile a warp, four partial sums a tap.
// C = 128: three taps of 2 x 64 x 128 f32
// would not fit the registers, so a block takes one tap (blockIdx.y) and
// each warpgroup one m64 half of dk. The block's sums meet in its shared
// memory (at C = 16 the WS warps' partial sums added in warp order); at C
// = 64 the two blocks of a cluster (consecutive blockIdx.x) then add
// theirs through distributed shared memory, each block half the entries,
// in rank order. The sums go out by coalesced stores to the row of a
// partials buffer of the block, or of the cluster (row blockIdx.x /
// CLUSTER, 3 C^2 floats, the taps at their place in it: at C = 128 the
// row holds the three blocks of one blockIdx.x, one tap each), which
// fold.cuh's fixed-order fold adds into dk after the entry point's last
// launch: no atomics, so dk reproduces itself bit for bit. The cluster
// halves the partials where they are largest (264 rows of 3 C^2 at C =
// 64); at C = 16 and 128 a cluster's wait cost more than its smaller fold
// saved, and a block keeps its own row. A launch takes BLOCKS blocks
// (a tap), one wave of the H100 at the tile's two blocks an SM (132 SMs;
// a sixth of them a tap at C = 128, the fewer blocks the fewer partials:
// a third a tap measured slower), fewer when the plane has fewer tiles
// (rounded up to whole clusters); a constant of the shape, never read
// from the card, so that the partition is the same on every card.
#pragma once

#include <cooperative_groups.h>

#include "conv3tap.cuh"

namespace ldconv {

// A block's tile: K = BM pixels a chunk; TAPS taps a block, one a
// warpgroup (C = 16, 64), or one tap and an m64 half of dk rows a
// warpgroup (C = 128). A stage: the staged input pixels in C / 8 column
// planes of XS bf16 (ROWS + 1 rows: the 16-byte pad puts a warp's copies
// in distinct banks) and the tile's dy in C / 8 planes of DS. At the end
// the ring holds the block's dk (TAPS x WS x C x LK f32), each element
// written by one thread; WS = 4 at C = 16, where each warp of a
// warpgroup sums its own k16 step of the tile on mma.sync.
template <int C>
struct WgradTile {
  static constexpr int BLOCKS = C == 128 ? 44 : 264;  // a launch's (a tap's)
  static constexpr int CLUSTER = C == 64 ? 2 : 1;  // blocks a partials row
  static constexpr int BM = 64;                    // pixels a tile
  static constexpr int TAPS = C == 128 ? 1 : 3;    // taps a block sums
  static constexpr int NWG = TAPS == 3 ? 3 : 2;    // warpgroups a block
  static constexpr int THREADS = NWG * 128;
  static constexpr int KS = BM / 16;               // k16 steps a tile
  static constexpr int STAGES = 3;                 // depth of the cp.async ring
  static constexpr int PLANES = C / 8;
  static constexpr int ROWS = TAPS == 3 ? 3 * BM : BM;  // staged input pixels
  static constexpr int XS = (ROWS + 1) * 8;
  static constexpr int DS = (BM + 1) * 8;
  static constexpr int STAGE = PLANES * (XS + DS);  // bf16
  static constexpr int LK = C + 4;                  // pitch of the dk tile
  static constexpr int WS = C == 16 ? 4 : 1;        // partial dk a tap
  static constexpr int SMEM = STAGES * STAGE * 2 > TAPS * WS * C * LK * 4
                                  ? STAGES * STAGE * 2
                                  : TAPS * WS * C * LK * 4;
  static_assert(STAGE % 8 == 0, "stages on 16-byte boundaries");
  static_assert(BLOCKS % CLUSTER == 0 && TAPS * C * C % CLUSTER == 0,
                "whole clusters; a cluster's entries split evenly");
};

// The row of `part` of the block's cluster (3 C^2 floats at part +
// blockIdx.x / CLUSTER * 3 C^2), tap t at t C^2 of it: sum over the
// cluster's blocks, in rank order, of the sum over each block's tiles of
// shift_t(f(in))^T @ dy for its taps (all three, or tap blockIdx.y at C =
// 128); f the prologue when pmul != nullptr. Launched in clusters of
// CLUSTER blocks along x (one block: no cluster).
template <int C>
__global__ void __launch_bounds__(WgradTile<C>::THREADS, 2)
    wgrad3tap_kernel(const bf16* __restrict__ in,
                     const float* __restrict__ pmul,
                     const float* __restrict__ padd,
                     const bf16* __restrict__ dy, float* __restrict__ part,
                     int npix, TileGeo<WgradTile<C>::BM> geo) {
  using T = WgradTile<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sRing = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int wg = warp / 4;
  // this warpgroup's tap of the block's (t) and m64 tile of dk rows (mt)
  const int t = T::TAPS == 3 ? wg : 0, mt = T::TAPS == 3 ? 0 : wg;
  const int t0 = T::TAPS == 1 ? (int)blockIdx.y : 0;  // the block's first tap

  // the staged input pixels of a chunk: the run (or bands) of the three
  // taps, or the tile shifted by tap t0 (its band)
  const int nload = T::TAPS == 3 ? geo.nload() : T::BM;
  const int ntiles = geo.ntiles(npix);
  const int n = (int)blockIdx.x < ntiles
                    ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                    : 0;
  auto stage = [&](int i) { return sRing + (i % T::STAGES) * T::STAGE; };
  auto staged_pixel = [&](int R0, int h0, int c0, int j) {
    return T::TAPS == 3 ? geo.staged_pixel(R0, h0, c0, j)
                        : geo.band_pixel(R0, h0, c0, t0, j);
  };
  auto load_chunk = [&](int i) {
    bf16* sX = stage(i);
    bf16* sD = sX + T::PLANES * T::XS;
    int R0, h0, c0;
    geo.at((int)blockIdx.x + i * (int)gridDim.x, R0, h0, c0);
    for (int e = threadIdx.x; e < nload * T::PLANES; e += T::THREADS) {
      const int j = e / T::PLANES, v = e % T::PLANES;
      const int q = staged_pixel(R0, h0, c0, j);
      cp_async16(sX + v * T::XS + j * 8, q >= 0 ? in + (size_t)q * C + v * 8 : in,
                 q >= 0);
    }
    for (int e = threadIdx.x; e < T::BM * T::PLANES; e += T::THREADS) {
      const int m = e / T::PLANES, v = e % T::PLANES;
      const long long at = geo.pixel(R0, h0, c0, m, C);
      cp_async16(sD + v * T::DS + m * 8, at >= 0 ? dy + at + v * 8 : dy,
                 at >= 0);
    }
  };

  float acc[C / 2];
#pragma unroll
  for (int e = 0; e < C / 2; ++e) acc[e] = 0.0f;

#pragma unroll
  for (int i = 0; i < T::STAGES - 1; ++i) {
    if (i < n) load_chunk(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<T::STAGES - 2>();  // this thread's copies of chunk i landed
    bf16* sX = stage(i);
    const bf16* sD = sX + T::PLANES * T::XS;
    if (pmul != nullptr) {
      // the prologue on the input pixels this thread copied that lie on
      // the plane
      int R0, h0, c0;
      geo.at((int)blockIdx.x + i * (int)gridDim.x, R0, h0, c0);
      for (int e = threadIdx.x; e < nload * T::PLANES; e += T::THREADS) {
        const int j = e / T::PLANES, v = e % T::PLANES;
        if (staged_pixel(R0, h0, c0, j) < 0) continue;
        uint4* p = reinterpret_cast<uint4*>(sX + v * T::XS + j * 8);
        uint4 val = *p;
        bf16* x = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          x[k] = f2bf(fmaxf(bn_affine(bf2f(x[k]), pmul[v * 8 + k],
                                      padd[v * 8 + k]),
                            0.0f));
        *p = val;
      }
    }
    if constexpr (C != 16)
      ldtc::fence_proxy_async();  // the stage's copies reach wgmma's proxy
    __syncthreads();  // chunk i visible; chunk i - 1's stage free
    if (i + T::STAGES - 1 < n) load_chunk(i + T::STAGES - 1);
    cp_async_commit();

    const int base = T::TAPS == 3 ? geo.base(t) : 0;
    if constexpr (C == 16) {
      // k16 step warp % 4 of the tile: A (16 ci x 16 pixels) and B (16
      // pixels x 16 co) by ldmatrix.trans from the column planes, whose
      // 16-byte rows are pixels
      const int ks = warp % 4;
      uint32_t a[4], b[4];
      ldtc::ldmatrix_x4_trans(
          a, sX + lane / 8 % 2 * T::XS +
                 (base + ks * 16 + lane / 16 * 8 + lane % 8) * 8);
      ldtc::ldmatrix_x4_trans(
          b, sD + lane / 16 * T::DS +
                 (ks * 16 + lane / 8 % 2 * 8 + lane % 8) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      ldtc::mma_bf16(*reinterpret_cast<float(*)[4]>(acc), a, b0);
      ldtc::mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 4), a, b1);
    } else {
      ldtc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < T::KS; ++ks)
        WgmmaSS<C, 1>::mma(
            acc,
            plane_desc(sX + mt * 8 * T::XS + (base + ks * 16) * 8, T::XS * 2),
            plane_desc(sD + ks * 16 * 8, T::DS * 2));
      ldtc::wgmma_commit();
      ldtc::wgmma_wait0();
      ldtc::keep(acc);
    }
  }

  // acc[4j + 2h + e]: dk[t0 + t][ci][co], ci = 64 mt + 16 (warp % 4) + g +
  // 8h (wgmma) or g + 8h (mma.sync, a warp's own partial sum), co = 8j +
  // 2tg + e, one thread's alone: the block's dk meets in shared memory,
  // then goes (added to the other blocks' of its cluster) to its row of
  // the partials (coalesced stores)
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* sK = reinterpret_cast<float*>(smem) +
              (t * T::WS + (T::WS > 1 ? warp % 4 : 0)) * C * T::LK;
  const int row0 = C == 16 ? g : mt * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = row0 + 8 * (e / 2);
      if (ci < C) sK[ci * T::LK + 8 * j + 2 * tg + e % 2] = acc[4 * j + e];
    }
  __syncthreads();  // the block's dk in its shared memory
  const float* sAll = reinterpret_cast<const float*>(smem);
  const float* peer[T::CLUSTER] = {sAll};
  int i0 = 0;  // this block's CLUSTER-th of the entries starts here
  constexpr int PER = T::TAPS * C * C / T::CLUSTER;
  if constexpr (T::CLUSTER > 1) {
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    cluster.sync();  // every block's dk in the cluster's shared memory
#pragma unroll
    for (int q = 0; q < T::CLUSTER; ++q)
      peer[q] = cluster.map_shared_rank(sAll, q);
    i0 = (int)cluster.block_rank() * PER;
  }
  float* row = part + ((size_t)blockIdx.x / T::CLUSTER * 3 + t0) * C * C;
  for (int i = i0 + threadIdx.x; i < i0 + PER; i += T::THREADS) {
    const int r = i / C;  // tap r / C, row r % C
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < T::CLUSTER; ++q) {
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < T::WS; ++w)
        a += peer[q][((r / C * T::WS + w) * C + r % C) * T::LK + i % C];
      v += a;
    }
    row[i] = v;
  }
  if constexpr (T::CLUSTER > 1)
    cooperative_groups::this_cluster().sync();  // no block leaves while
                                                // another reads its memory
}

template <int C>
int wgrad_info(int* info) {
  return tile_info(wgrad3tap_kernel<C>, WgradTile<C>::THREADS,
                   WgradTile<C>::SMEM, info);
}

// the blocks (a tap) of a weight gradient over npix pixels of (H, W)
// images: at most BLOCKS, and a tile each at least but for the last
// cluster's, rounded up to whole clusters (ops/nb_block.py counts the
// same, CLUSTER blocks a row of its partials)
template <int C>
int wgrad_grid(int npix, const TileGeo<WgradTile<C>::BM>& geo, int H,
               int W) {
  using T = WgradTile<C>;
  const int ntiles = npix / (H * W) * geo.frb.d * geo.fcb.d;
  const int blocks = ntiles < T::BLOCKS ? ntiles : T::BLOCKS;
  return (blocks + T::CLUSTER - 1) / T::CLUSTER * T::CLUSTER;
}

// dk ((3, C, C) f32) is written whole by the fold of `pp`, which takes the
// blocks' partials here
template <int C>
int launch_wgrad(const bf16* in, const float* pmul, const float* padd,
                 const bf16* dy, float* dk, int npix, int H, int W, int d,
                 int axis, cudaStream_t stream, ldfold::Partials* pp) {
  using T = WgradTile<C>;
  auto kern = wgrad3tap_kernel<C>;
  const int rc = tile_smem(kern, T::SMEM);
  if (rc) return rc;
  if (npix == 0 || pp == nullptr) return (int)cudaErrorInvalidValue;
  const TileGeo<T::BM> geo(H, W, d, axis);
  const int blocks = wgrad_grid<C>(npix, geo, H, W);
  float* part = pp->take(blocks / T::CLUSTER, 3 * C * C, dk);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, T::TAPS == 1 ? 3 : 1);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = T::CLUSTER;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = T::CLUSTER > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, in, pmul, padd, dy, part, npix,
                                 geo);
}

}  // namespace ldconv
