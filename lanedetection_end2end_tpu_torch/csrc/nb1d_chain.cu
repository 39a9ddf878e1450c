// nb1d_chain: n ERFNet NonBottleneck1D inference blocks of one width, back
// to back, in ONE cooperative launch.
//
// Replaces the TPU kernel `_chain_kernel` (lanedetection_end2end_tpu/ops/
// pallas_nb1d.py:320, entry `nb1d_chain` :334), which keeps one image's
// plane resident in VMEM across the whole chain so that HBM and the
// launcher see one call per chain. On the H100 one image's plane is
// 0.5-1 MB and a block needs more than one of them (x for the residual,
// the pass A output): more than a block's 227 KB of shared memory. So the
// planes stay in device memory (at batch 8 each is at most 8 MB, and the
// three in use fit the 50 MB L2), and the chain is one persistent grid:
//
//   for each block b:      (K1's two passes, nb1d.cu)
//     mid = pass A(cur)             conv3x1, conv1x3 at d = 1
//     dst = pass B(mid) + cur       conv3x1_d, conv1x3_d, residual
//
// Each pass is one grid-stride walk of the CTAs over row tiles, running
// K1's tile (`nb1d.cuh::block_passes`), and a grid.sync() separates the
// passes: pass B's 3x1 taps read rows up to d = 16 away, which other CTAs
// write. The first weight chunks of the next pass are issued before each
// barrier. The block outputs alternate between `a` and `out` so that the
// last one lands in `out`; the caller's x is only read. Same code on the
// same inputs: the output is bit for bit K1's launched block by block.
//
// The grid must be co-resident: it is sized from the occupancy of this
// kernel at the largest pass's shared memory times the SM count, capped at
// the tile count; a launch that the card refuses returns its error. Bound:
// the same work as the chain's blocks under K1, plus 2 grid-wide barriers
// per block in place of 2 launches.

#include "nb1d.cuh"

namespace cg = cooperative_groups;

namespace {

using nb1d::THREADS;

constexpr int MAX_BLOCKS = 16;

struct Dilations {
  int d[MAX_BLOCKS];
};

template <int C, bool kSeg>
__global__ void __launch_bounds__(THREADS, 2) nb1d_chain_kernel(
    const bf16* x, const bf16* w, const float* vec, Dilations dil, int n,
    bf16* mid, bf16* a, bf16* out, int rows, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sd[MAX_BLOCKS];  // the dilations, indexed by block
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < MAX_BLOCKS; ++b) sd[b] = dil.d[b];
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const size_t wb = (size_t)12 * C * C;
  bool pre = false;
  int nsync = 0;  // (not reported)
#pragma unroll 1  // one copy of the block's code
  for (int b = 0; b < n; ++b) {
    // block b reads x, then `out` or `a`; the last block writes `out`
    const bool last_out = (n - 1 - b) % 2 == 0;
    const bf16* cur = b == 0 ? x : last_out ? a : out;
    nb1d::block_passes<C, kSeg>(grid, cur, w + b * wb,
                                vec + (size_t)b * 6 * C, sd[b], mid,
                                last_out ? out : a, rows, H, W, smem, pre,
                                nsync);
    if (b + 1 < n) {
      pre = nb1d::issue_block_weights<C, kSeg>(w + (b + 1) * wb, rows, H, W,
                                               smem);
      grid.sync();
    }
  }
}

template <int C>
int launch_chain(const bf16* x, const bf16* w, const float* vec,
                 Dilations dil, int n, bf16* mid, bf16* a, bf16* out,
                 int rows, int H, int W, cudaStream_t s) {
  int smem = nb1d::smem_bytes<C>(W, 1);
#pragma unroll 1  // one copy of the block's code
  for (int b = 0; b < n; ++b) {
    const int need = nb1d::smem_bytes<C>(W, dil.d[b]);
    if (need > smem) smem = need;
  }
  void* args[] = {&x, &w, &vec, &dil, &n, &mid, &a, &out, &rows, &H, &W};
  const long long units = nb1d::tile_count<C>(rows, W);
  if (nb1d::seg_rows<C>(W))
    return launch_cooperative(nb1d_chain_kernel<C, true>, THREADS, smem,
                              units, args, s);
  return launch_cooperative(nb1d_chain_kernel<C, false>, THREADS, smem,
                            units, args, s);
}

}  // namespace

// x, out, mid, a: (B, H, W, C) bf16 contiguous (mid, a scratch); w: (n, 4,
// 3, C, C) bf16; vec: (n, 6, C) f32; dil: n host ints, n <= 16.
LD_API int ld_nb1d_chain(const void* x, const void* w, const void* vec,
                         const void* dil, int n, void* mid, void* a,
                         void* out, int B, int H, int W, int C,
                         void* stream) {
  if (n < 1 || n > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  Dilations dd = {};
  for (int i = 0; i < n; ++i) dd.d[i] = static_cast<const int*>(dil)[i];
  const int rows = B * H;
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto Wt = static_cast<const bf16*>(w);
  auto V = static_cast<const float*>(vec);
  auto M = static_cast<bf16*>(mid);
  auto A = static_cast<bf16*>(a);
  auto O = static_cast<bf16*>(out);
  switch (C) {
    case 16:
      return launch_chain<16>(X, Wt, V, dd, n, M, A, O, rows, H, W, s);
    case 64:
      return launch_chain<64>(X, Wt, V, dd, n, M, A, O, rows, H, W, s);
    case 128:
      return launch_chain<128>(X, Wt, V, dd, n, M, A, O, rows, H, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
