// nb1d_chain: n ERFNet NonBottleneck1D inference blocks of one width, back
// to back, in ONE cooperative launch.
//
// Replaces the TPU kernel `_chain_kernel` (lanedetection_end2end_tpu/ops/
// pallas_nb1d.py:320, entry `nb1d_chain` :334), which keeps one image's
// plane resident in VMEM across the whole chain so that HBM and the
// launcher see one call per chain. On the H100 one image's plane is
// 0.5-1 MB and a block needs three of them (x for the residual, t1, t2):
// more than a block's 227 KB of shared memory. So the planes stay in
// device memory (at batch 8 each is at most 8 MB, and the four that are in
// use fit the 50 MB L2), and the chain is one persistent grid instead:
//
//   for each block b:      (K1's four convolutions, nb1d.cu)
//     t1  = relu(conv3x1(cur)       + b1)
//     t2  = relu(conv1x3(t1)   * m1 + a1)
//     t1  = relu(conv3x1_d(t2)      + b3)
//     dst = relu(conv1x3_d(t1) * m2 + a2 + cur)
//
// Each convolution is one grid-stride pass of the CTAs over 64-pixel
// tiles, running K1's tile body (`nb1d.cuh::block_passes`), and a
// grid.sync() separates the passes: a tap reads rows up to d = 16 away,
// which other CTAs write.
// The block outputs alternate between `a` and `out` so that the last one
// lands in `out`; the caller's x is only read. Same code on the same
// inputs: the output is bit for bit K1's launched block by block.
//
// The grid must be co-resident: it is sized from the occupancy of this
// kernel (after the dynamic shared memory is raised for C = 128) times the
// SM count, capped at the tile count; a launch that the card refuses
// returns its error. Bound: the same work as the chain's blocks under K1,
// plus 4 grid-wide barriers per block in place of 4 launches.

#include <cooperative_groups.h>

#include "nb1d.cuh"

namespace cg = cooperative_groups;

namespace {

using nb1d::THREADS;
using nb1d::TP;

constexpr int MAX_BLOCKS = 16;

struct Dilations {
  int d[MAX_BLOCKS];
};

template <int C>
__global__ void __launch_bounds__(THREADS) nb1d_chain_kernel(
    const bf16* x, const bf16* w, const float* vec, Dilations dil, int n,
    bf16* t1, bf16* t2, bf16* a, bf16* out, int npix, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const bf16* cur = x;
  for (int b = 0; b < n; ++b) {
    bf16* dst = ((n - 1 - b) % 2 == 0) ? out : a;
    nb1d::block_passes<C>(grid, cur, w + (size_t)b * 12 * C * C,
                          vec + (size_t)b * 6 * C, dil.d[b], t1, t2, dst,
                          npix, H, W, smem);
    if (b + 1 < n) grid.sync();
    cur = dst;
  }
}

template <int C>
int launch_chain(const bf16* x, const bf16* w, const float* vec,
                 Dilations dil, int n, bf16* t1, bf16* t2, bf16* a,
                 bf16* out, int npix, int H, int W, cudaStream_t s) {
  void* args[] = {&x, &w, &vec, &dil, &n, &t1, &t2, &a, &out, &npix, &H, &W};
  return launch_cooperative(nb1d_chain_kernel<C>, THREADS,
                            nb1d::smem_bytes<C>(), grid_1d(npix, TP), args,
                            s);
}

}  // namespace

// x, out, t1, t2, a: (B, H, W, C) bf16 contiguous (t1, t2, a scratch);
// w: (n, 4, 3, C, C) bf16; vec: (n, 6, C) f32; dil: n host ints, n <= 16.
LD_API int ld_nb1d_chain(const void* x, const void* w, const void* vec,
                         const void* dil, int n, void* t1, void* t2, void* a,
                         void* out, int B, int H, int W, int C,
                         void* stream) {
  if (n < 1 || n > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  Dilations dd = {};
  for (int i = 0; i < n; ++i) dd.d[i] = static_cast<const int*>(dil)[i];
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto Wt = static_cast<const bf16*>(w);
  auto V = static_cast<const float*>(vec);
  auto T1 = static_cast<bf16*>(t1);
  auto T2 = static_cast<bf16*>(t2);
  auto A = static_cast<bf16*>(a);
  auto O = static_cast<bf16*>(out);
  switch (C) {
    case 16:
      return launch_chain<16>(X, Wt, V, dd, n, T1, T2, A, O, npix, H, W, s);
    case 64:
      return launch_chain<64>(X, Wt, V, dd, n, T1, T2, A, O, npix, H, W, s);
    case 128:
      return launch_chain<128>(X, Wt, V, dd, n, T1, T2, A, O, npix, H, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
