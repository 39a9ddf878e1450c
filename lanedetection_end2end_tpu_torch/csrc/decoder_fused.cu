// decoder_fused: the whole ERFNet decoder, the 2x2 output head, the
// weight-map activation, the top-row mask and the separable WLS row sums
// (inference, BatchNorm folded) in ONE cooperative launch.
//
// Replaces the TPU kernel `_plane_call` as `decoder_fused` uses it
// (lanedetection_end2end_tpu/models/fused_graph.py:178, :334; bodies
// `_decoder_plane_a/_b`, :254-326), which runs the decoder of one image per
// grid step with its planes in VMEM, so that only the (H, 2C) row sums
// leave the chip. As in encoder_fused.cu, the planes stay in device memory
// here (at batch 8 and 256x512 each is 8.4 MB; the four scratch planes fit
// the 50 MB L2) and the decoder is one persistent grid walking 19 passes
// with a grid.sync() between each pair:
//
//   up1 128 -> 64              1 pass  (K3's body, upsampler.cuh, 4
//                                      channels of a pixel per thread)
//   2 x NB1D-64, d = 1         4 passes each (K1's tile, nb1d.cuh)
//   up2 64 -> 16               1 pass
//   2 x NB1D-16, d = 1         4 passes each
//   head + activation + mask + row sums   1 pass (K4's row, head_rowsums.cuh)
//
// The full-resolution logits never reach memory, as in JAX: S (B, H, 2C)
// f32 = [S0 | S1] is all the last pass writes.
//
// Design of the head pass, the choice between K4's 256 threads and the
// NB1D tile's 4 warps: the block keeps 128 threads and K4's reduction
// order. Each thread plays two of K4's virtual threads (`head_row<128>`),
// folds each virtual warp's partial sums by the same shuffles and adds the
// eight warp parts in the same order, so S is bit for bit that of K4 after
// K3 and K1 launched block by block (models/fused_graph.py::
// decoder_blocks), like every plane before it. Planes written in the launch
// are read through L2 only (kCoherent = true).
//
// Constants: one bf16 weight buffer and one f32 vector buffer laid out once
// by `pack_decoder` (ops/backbone_fused.py), with a table of offsets passed
// by value: stage s's weights at wb + w[s], its vectors (an upsampler's mul
// then add; an NB1D block's b1 m1 a1 b3 m2 a2; the head's bias then the
// fitter's column coordinate xs) at vb + v[s].
//
// Bound on the card: the same operations as K3, K1 and K4 (the NB1D-64
// blocks' tensor-core work leads) against enc, the constants and S crossing
// HBM once. The 18 grid-wide barriers take the place of 19 launches (2 of
// K3, 4 x 4 of K1, 1 of K4). Grid: the occupancy at the NB1D-64 tile's
// dynamic shared memory times the SM count, capped at the largest pass's
// work units; a refused cooperative launch returns its error.

#include <cooperative_groups.h>

#include "head_rowsums.cuh"
#include "nb1d.cuh"
#include "upsampler.cuh"

namespace cg = cooperative_groups;

namespace {

using nb1d::THREADS;
using nb1d::TP;

constexpr int STAGES = 7;  // up1, 2 x NB1D-64, up2, 2 x NB1D-16, head
constexpr int NB64 = 1, UP2 = 3, NB16 = 4, HEAD = 6;
constexpr int CIN_HEAD = 16;
constexpr int NC_UP = 4;  // upsampler channels per thread (16 | cout)

// x (B, H, W, cin) -> out (B, 2H, 2W, cout), one grid-stride pass of the
// threads over groups of NC_UP channels of a pixel
__device__ void up_pass(const bf16* x, const bf16* w, const float* v,
                        bf16* out, int B, int H, int W, int cin, int cout) {
  const long long n = (long long)B * (2 * H) * (2 * W) * cout / NC_UP;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x; g < n;
       g += (long long)gridDim.x * THREADS)
    ldus::upsampler_values<true, NC_UP>(g * NC_UP, x, w, v, v + cout, out, H,
                                        W, cin, cout);
}

// enc: (B, h, w, 128); p0..p3: scratch planes of 256*B*h*w values each;
// S: (B, 8h, 2C)
__global__ void __launch_bounds__(THREADS) decoder_fused_kernel(
    const bf16* enc, const bf16* wb, const float* vb, StageTable<STAGES> tab,
    bf16* p0, bf16* p1, bf16* p2, bf16* p3, float* S, int B, int h, int w,
    int C, int zero_rows, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  up_pass(enc, wb + tab.w[0], vb + tab.v[0], p0, B, h, w, 128, 64);
  grid.sync();
  // 2 x NB1D-64 on (B, 2h, 2w, 64): p0 -> p1 -> p0
  const int H4 = 2 * h, W4 = 2 * w;
  bf16 *cur = p0, *nxt = p1;
  for (int i = NB64; i < UP2; ++i) {
    nb1d::block_passes<64>(grid, cur, wb + tab.w[i], vb + tab.v[i], tab.d[i],
                           p2, p3, nxt, B * H4 * W4, H4, W4, smem);
    grid.sync();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  up_pass(cur, wb + tab.w[UP2], vb + tab.v[UP2], nxt, B, H4, W4, 64,
          CIN_HEAD);
  grid.sync();
  // 2 x NB1D-16 on (B, 4h, 4w, 16): p1 -> p0 -> p1
  const int H2 = 4 * h, W2 = 4 * w;
  bf16* t = cur;
  cur = nxt;
  nxt = t;
  for (int i = NB16; i < HEAD; ++i) {
    nb1d::block_passes<16>(grid, cur, wb + tab.w[i], vb + tab.v[i], tab.d[i],
                           p2, p3, nxt, B * H2 * W2, H2, W2, smem);
    grid.sync();
    t = cur;
    cur = nxt;
    nxt = t;
  }
  // head + activation + mask + row sums, one row of S per block at a time
  const int H = 8 * h, W = 8 * w;
  const bf16* hw = wb + tab.w[HEAD];
  const float* bias = vb + tab.v[HEAD];
  auto part = reinterpret_cast<float(*)[2 * ldhead::MAXC]>(smem);
  for (int row = blockIdx.x; row < B * H; row += gridDim.x) {
    ldhead::head_row<THREADS, bf16, true>(row, cur, hw, bias, bias + C, S, H,
                                          W, CIN_HEAD, C, zero_rows, act,
                                          part);
    __syncthreads();  // the next row rewrites `part`
  }
}

}  // namespace

// enc: (B, h, w, 128) bf16; wbuf bf16, vbuf f32 (16-byte aligned
// segments); table: n = 3 * 7 host ints (w offsets, v offsets, dilations);
// scratch: 4 planes of 256*B*h*w bf16; S: (B, 8h, 2C) f32, C <= 8.
LD_API int ld_decoder_fused(const void* enc, const void* wbuf,
                            const void* vbuf, const void* table, int n,
                            void* scratch, void* S, int B, int h, int w,
                            int C, int zero_rows, int act, void* stream) {
  if (n != 3 * STAGES || C < 1 || C > ldhead::MAXC || B < 1)
    return (int)cudaErrorInvalidValue;
  StageTable<STAGES> tab = read_table<STAGES>(table);
  constexpr int smem = nb1d::smem_bytes<64>();
  static_assert(smem >= (int)sizeof(float) * (ldhead::THREADS / 32) * 2 *
                             ldhead::MAXC,
                "the head's warp parts fit the tile memory");
  // work units of the largest pass: up2's channel groups per block of
  // threads, the NB1D-16 tiles, or the rows of S
  const long long groups = (long long)B * (4 * h) * (4 * w) * CIN_HEAD / NC_UP;
  long long units = (groups + THREADS - 1) / THREADS;
  const long long tiles16 = ((long long)B * (4 * h) * (4 * w) + TP - 1) / TP;
  if (tiles16 > units) units = tiles16;
  if ((long long)B * 8 * h > units) units = (long long)B * 8 * h;

  auto E = static_cast<const bf16*>(enc);
  auto Wb = static_cast<const bf16*>(wbuf);
  auto Vb = static_cast<const float*>(vbuf);
  const size_t plane = (size_t)256 * B * h * w;
  bf16* P0 = static_cast<bf16*>(scratch);
  bf16 *P1 = P0 + plane, *P2 = P1 + plane, *P3 = P2 + plane;
  auto Sp = static_cast<float*>(S);
  void* args[] = {&E,  &Wb, &Vb, &tab, &P0, &P1, &P2, &P3,
                  &Sp, &B,  &h,  &w,   &C,  &zero_rows, &act};
  return launch_cooperative(decoder_fused_kernel, THREADS, smem, units, args,
                            static_cast<cudaStream_t>(stream));
}
