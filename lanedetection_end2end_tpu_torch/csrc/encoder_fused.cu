// encoder_fused: the whole ERFNet encoder (inference, BatchNorm folded) in
// ONE cooperative launch.
//
// Replaces the TPU kernel `_plane_call` as `encoder_fused` uses it
// (lanedetection_end2end_tpu/models/fused_graph.py:178, :191; body
// `_encoder_plane`, :107-143), which runs the whole encoder of one image per
// grid step with every intermediate plane resident in VMEM. On the H100 one
// image's planes (up to 1 MB each, three live at once) do not fit a block's
// 227 KB of shared memory, so, as in nb1d_chain.cu, the planes stay in
// device memory (at batch 8 and 256x512 each is at most 8.4 MB, and the
// four scratch planes fit the 50 MB L2) and the encoder is one persistent
// grid that walks its 55 passes with a grid.sync() between each pair:
//
//   initial downsampler 3 -> 16        1 pass  (K2's body, downsampler.cuh)
//   down1 16 -> 64                     1 pass
//   5 x NB1D-64, d = 1                 4 passes each (K1's tile, nb1d.cuh)
//   down2 64 -> 128                    1 pass
//   8 x NB1D-128, d = 2, 4, 8, 16 x2   4 passes each
//
// A downsampler pass is a grid-stride loop of the threads over groups of 4
// output channels of a pixel (K2's body, each value's sum in K2's order),
// an NB1D pass one of the blocks over 64-pixel tiles. Every pass
// runs the device code of the standalone kernels on the same inputs, so the
// output is bit for bit that of K2 and K1 launched block by block
// (models/fused_graph.py::encoder_blocks). Planes written in the launch are
// read through L2 only (kCoherent = true).
//
// Images: (B, H, W, 3) bf16; enc: (B, H/8, W/8, 128) bf16. The constants
// are one bf16 weight buffer and one f32 vector buffer laid out once by
// `pack_encoder` (ops/backbone_fused.py), with a table of offsets passed by
// value: stage s's weights at wb + w[s], its vectors (a downsampler's mul
// then add, an NB1D block's b1 m1 a1 b3 m2 a2) at vb + v[s], its dilation
// d[s].
//
// Bound on the card: the same operations as K2 and K1 (the NB1D blocks'
// tensor-core work leads), against the image, the constants and enc
// crossing HBM once. The 54 grid-wide barriers take the place of 55
// launches (3 of K2, 13 x 4 of K1).
// The grid is co-resident: the occupancy at the largest dynamic shared
// memory of any pass (the NB1D-128 tile) times the SM count, capped at the
// largest pass's work units. A cooperative launch that the card refuses
// returns its error; there is no fallback to the block sequence.

#include <cooperative_groups.h>

#include "downsampler.cuh"
#include "nb1d.cuh"

namespace cg = cooperative_groups;

namespace {

using nb1d::THREADS;
using nb1d::TP;

constexpr int STAGES = 16;  // initial, down1, 5 x NB1D-64, down2, 8 x NB1D-128
constexpr int NB64 = 2, DOWN2 = 7, NB128 = 8;  // first stage of each group
constexpr int NC_DOWN = 4;  // downsampler channels per thread (16 | cout)

// x (B, H, W, cin) -> out (B, H/2, W/2, cout), one grid-stride pass of
// the threads over groups of NC_DOWN channels of a pixel
__device__ void down_pass(const bf16* x, const bf16* w, const float* v,
                          bf16* out, int B, int H, int W, int cin, int cout) {
  const long long n = (long long)B * (H / 2) * (W / 2) * cout / NC_DOWN;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x; g < n;
       g += (long long)gridDim.x * THREADS)
    ldds::downsampler_values<true, NC_DOWN>(g * NC_DOWN, x, w, v, v + cout,
                                            out, H, W, cin, cout);
}

// p0..p3: scratch planes of 4*B*H*W values each
__global__ void __launch_bounds__(THREADS) encoder_fused_kernel(
    const bf16* img, const bf16* wb, const float* vb, StageTable<STAGES> tab,
    bf16* p0, bf16* p1, bf16* p2, bf16* p3, bf16* out, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  down_pass(img, wb + tab.w[0], vb + tab.v[0], p0, B, H, W, 3, 16);
  grid.sync();
  down_pass(p0, wb + tab.w[1], vb + tab.v[1], p1, B, H / 2, W / 2, 16, 64);
  grid.sync();
  // 5 x NB1D-64 on (B, H/4, W/4, 64): p1 -> p0 -> p1 -> p0 -> p1 -> p0
  const int H4 = H / 4, W4 = W / 4;
  bf16 *cur = p1, *nxt = p0;
  for (int i = NB64; i < DOWN2; ++i) {
    nb1d::block_passes<64>(grid, cur, wb + tab.w[i], vb + tab.v[i], tab.d[i],
                           p2, p3, nxt, B * H4 * W4, H4, W4, smem);
    grid.sync();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  down_pass(cur, wb + tab.w[DOWN2], vb + tab.v[DOWN2], nxt, B, H4, W4, 64,
            128);
  grid.sync();
  // 8 x NB1D-128 on (B, H/8, W/8, 128), alternating between `cur` and
  // `out` so that the last block lands in `out`
  const int H8 = H / 8, W8 = W / 8;
  const bf16* x = nxt;
  for (int i = NB128; i < STAGES; ++i) {
    bf16* dst = (STAGES - 1 - i) % 2 == 0 ? out : cur;
    nb1d::block_passes<128>(grid, x, wb + tab.w[i], vb + tab.v[i], tab.d[i],
                            p2, p3, dst, B * H8 * W8, H8, W8, smem);
    if (i + 1 < STAGES) grid.sync();
    x = dst;
  }
}

}  // namespace

// x: (B, H, W, 3) bf16, H and W multiples of 8; wbuf bf16, vbuf f32 (16-byte
// aligned segments); table: n = 3 * 16 host ints (w offsets, v offsets,
// dilations); scratch: 4 planes of 4*B*H*W bf16; out: (B, H/8, W/8, 128).
LD_API int ld_encoder_fused(const void* x, const void* wbuf, const void* vbuf,
                            const void* table, int n, void* scratch,
                            void* out, int B, int H, int W, void* stream) {
  if (n != 3 * STAGES || H % 8 || W % 8 || B < 1)
    return (int)cudaErrorInvalidValue;
  StageTable<STAGES> tab = read_table<STAGES>(table);
  // work units of the largest pass: the initial downsampler's channel
  // groups per block of threads, or the NB1D-64 tiles
  const long long groups = (long long)B * (H / 2) * (W / 2) * 16 / NC_DOWN;
  long long units = (groups + THREADS - 1) / THREADS;
  const long long tiles64 = ((long long)B * (H / 4) * (W / 4) + TP - 1) / TP;
  if (tiles64 > units) units = tiles64;
  auto X = static_cast<const bf16*>(x);
  auto Wb = static_cast<const bf16*>(wbuf);
  auto Vb = static_cast<const float*>(vbuf);
  const size_t plane = (size_t)4 * B * H * W;
  bf16* P0 = static_cast<bf16*>(scratch);
  bf16 *P1 = P0 + plane, *P2 = P1 + plane, *P3 = P2 + plane;
  auto O = static_cast<bf16*>(out);
  void* args[] = {&X, &Wb, &Vb, &tab, &P0, &P1, &P2, &P3, &O, &B, &H, &W};
  return launch_cooperative(encoder_fused_kernel, THREADS,
                            nb1d::smem_bytes<128>(), units, args,
                            static_cast<cudaStream_t>(stream));
}
