// decoder_fused: the whole ERFNet decoder, the 2x2 output head, the
// weight-map activation, the top-row mask and the separable WLS row sums
// (inference, BatchNorm folded) in ONE cooperative launch.
//
// Replaces the TPU kernel `_plane_call` as `decoder_fused` uses it
// (lanedetection_end2end_tpu/models/fused_graph.py:178, :334; bodies
// `_decoder_plane_a/_b`, :254-326), which runs the decoder of one image per
// grid step with its planes in VMEM, so that only the (H, 2C) row sums
// leave the chip. As in encoder_fused.cu, the planes stay in device memory
// here (at batch 8 and 256x512 each is 8.4 MB; the three scratch planes fit
// the 50 MB L2) and the decoder is one persistent grid walking 11 passes
// with a grid.sync() between each pair:
//
//   up1 128 -> 64              1 pass  (K3's tensor-core tile by output
//                                      parity, upsampler.cuh)
//   2 x NB1D-64, d = 1         2 passes each (K1's row tile, nb1d.cuh)
//   up2 64 -> 16               1 pass
//   2 x NB1D-16, d = 1         2 passes each
//   head + activation + mask + row sums   1 pass (K4's row, head_rowsums.cuh)
//
// The full-resolution logits never reach memory, as in JAX: S (B, H, 2C)
// f32 = [S0 | S1] is all the last pass writes. The head pass runs K4's row
// body with K4's 256 threads a row (`head_row<256>`), so S is bit for bit
// that of K4 after K3 and K1 launched block by block (models/fused_graph.
// py::decoder_blocks), like every plane before it. Planes written in the
// launch are read through L2 only. Ahead of the barrier before an NB1D
// pass, each block issues the first weight chunks of its first tile.
//
// Constants: one bf16 weight buffer and one f32 vector buffer laid out once
// by `pack_decoder` (ops/backbone_fused.py), with a table of offsets passed
// by value: stage s's weights at wb + w[s], its vectors (an upsampler's mul
// then add; an NB1D block's b1 m1 a1 b3 m2 a2; the head's bias then the
// fitter's column coordinate xs) at vb + v[s].
//
// Bound on the card: the same operations as K3, K1 and K4 (the NB1D-64
// blocks' tensor-core work leads) against enc, the constants and S crossing
// HBM once. The 10 grid-wide barriers take the place of 11 launches (2 of
// K3, 4 x 2 of K1, 1 of K4); the kernel writes the count it ran to
// `barriers`. Grid: the occupancy at the largest pass's dynamic shared
// memory times the SM count (8 warps a block within 128 registers a
// thread: two blocks an SM), capped at the largest pass's work units; a
// refused cooperative launch returns its error.

#include "head_rowsums.cuh"
#include "nb1d.cuh"
#include "upsampler.cuh"

namespace cg = cooperative_groups;

namespace {

using nb1d::THREADS;
static_assert(THREADS == 32 * ldds::NW && THREADS == ldhead::THREADS,
              "one block size for every pass");

constexpr int STAGES = 7;  // up1, 2 x NB1D-64, up2, 2 x NB1D-16, head
constexpr int NB64 = 1, UP2 = 3, NB16 = 4, HEAD = 6;
constexpr int CIN_HEAD = 16;

// enc: (B, h, w, 128); P0..P2: scratch planes of 256*B*h*w values each;
// S: (B, 8h, 2C); *barriers: the grid barriers run
__global__ void __launch_bounds__(THREADS, 2) decoder_fused_kernel(
    const bf16* enc, const bf16* wb, const float* vb, StageTable<STAGES> tab,
    bf16* P0, bf16* P1, bf16* P2, float* S, int* barriers, int B, int h,
    int w, int C, int zero_rows, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int st[3 * STAGES];  // the stage table: w, v, d offsets
  stage_table_to_shared(tab, st);
  __syncthreads();
  const int* sw = st;
  const int* sv = st + STAGES;
  const int* sd = st + 2 * STAGES;
  __shared__ int nsync;  // grid barriers run, counted by thread 0
  if (threadIdx.x == 0) nsync = 0;
  cg::grid_group grid = cg::this_grid();
  auto sync = [&]() {
    grid.sync();
    if (threadIdx.x == 0) ++nsync;
  };
  const float* v0 = vb + sv[0];
  ldds::s2_pass<128, 64>(
      ldus::us_op(enc, wb + sw[0], v0, v0 + 64, P0, B, h, w, 128, 64), 4,
      smem);
  // 2 x NB1D-64 on (B, 2h, 2w, 64): P0 -> P1 -> P0, pass A outputs in P2
  const int H4 = 2 * h, W4 = 2 * w, H2 = 4 * h, W2 = 4 * w;
  bool pre =
      nb1d::issue_block_weights<64>(wb + sw[NB64], B * H4, H4, W4, smem);
  sync();
#pragma unroll 1  // one copy of the block's code
  for (int i = NB64; i < UP2; ++i) {
    const bool even = (i - NB64) % 2 == 0;
    nb1d::block_passes<64>(grid, even ? P0 : P1, wb + sw[i], vb + sv[i],
                           sd[i], P2, even ? P1 : P0, B * H4, H4, W4, smem,
                           pre, nsync);
    pre = i + 1 < UP2 && nb1d::issue_block_weights<64>(
                             wb + sw[i + 1], B * H4, H4, W4, smem);
    sync();
  }
  const float* v3 = vb + sv[UP2];
  ldds::s2_pass<64, 16>(ldus::us_op(P0, wb + sw[UP2], v3, v3 + CIN_HEAD, P1,
                                    B, H4, W4, 64, CIN_HEAD),
                        4, smem);
  pre = nb1d::issue_block_weights<16>(wb + sw[NB16], B * H2, H2, W2, smem);
  sync();
  // 2 x NB1D-16 on (B, 4h, 4w, 16): P1 -> P0 -> P1
#pragma unroll 1  // one copy of the block's code
  for (int i = NB16; i < HEAD; ++i) {
    const bool even = (i - NB16) % 2 == 0;
    nb1d::block_passes<16>(grid, even ? P1 : P0, wb + sw[i], vb + sv[i],
                           sd[i], P2, even ? P0 : P1, B * H2, H2, W2, smem,
                           pre, nsync);
    pre = i + 1 < HEAD && nb1d::issue_block_weights<16>(
                              wb + sw[i + 1], B * H2, H2, W2, smem);
    sync();
  }
  // head + activation + mask + row sums on P1, one row of S per block at a
  // time
  const int H = 8 * h, W = 8 * w;
  const bf16* hw = wb + sw[HEAD];
  const float* bias = vb + sv[HEAD];
  auto part = reinterpret_cast<float(*)[2 * ldhead::MAXC]>(smem);
  for (int row = blockIdx.x; row < B * H; row += gridDim.x) {
    ldhead::head_row<THREADS, bf16, true>(row, P1, hw, bias, bias + C, S, H,
                                          W, CIN_HEAD, C, zero_rows, act,
                                          part);
    __syncthreads();  // the next row rewrites `part`
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *barriers = nsync;
}

// The launch's shape: dynamic shared memory (the largest pass's) and work
// units (the largest pass's tiles or rows).
int launch_shape(const StageTable<STAGES>& tab, int B, int h, int w,
                 int* smem, long long* units) {
  if (B < 1 || 2 * w > nb1d::Cfg<64>::MT || 4 * w > nb1d::Cfg<16>::MT)
    return (int)cudaErrorInvalidValue;
  auto most = [](int a, int b) { return a > b ? a : b; };
  int s = (int)sizeof(float) * (ldhead::THREADS / 32) * 2 * ldhead::MAXC;
  s = most(s, lds2::GemmTile<bf16, 128, 64, ldds::NW>::SMEM);
  s = most(s, lds2::GemmTile<bf16, 64, 16, ldds::NW>::SMEM);
  for (int i = NB64; i < UP2; ++i)
    s = most(s, nb1d::smem_bytes<64>(2 * w, tab.d[i]));
  for (int i = NB16; i < HEAD; ++i)
    s = most(s, nb1d::smem_bytes<16>(4 * w, tab.d[i]));
  *smem = s;
  long long u = (long long)B * 8 * h;  // the head's rows
  auto more = [&](long long v) { u = v > u ? v : u; };
  const long long pix = (long long)B * h * w;
  more(4 * ((pix + ldds::BM - 1) / ldds::BM));      // up1's tiles x phases
  more(4 * ((4 * pix + ldds::BM - 1) / ldds::BM));  // up2's
  const int R64 = nb1d::Cfg<64>::MT / (2 * w);
  const int R16 = nb1d::Cfg<16>::MT / (4 * w);
  more(((long long)B * 2 * h + R64 - 1) / R64);
  more(((long long)B * 4 * h + R16 - 1) / R16);
  *units = u;
  return 0;
}

}  // namespace

// enc: (B, h, w, 128) bf16, w <= 64; wbuf bf16, vbuf f32 (16-byte aligned
// segments); table: n = 3 * 7 host ints (w offsets, v offsets,
// dilations); scratch: 3 planes of 256*B*h*w bf16; S: (B, 8h, 2C) f32, C
// <= 8; barriers: 1 device int, the grid barriers the launch ran.
LD_API int ld_decoder_fused(const void* enc, const void* wbuf,
                            const void* vbuf, const void* table, int n,
                            void* scratch, void* S, void* barriers, int B,
                            int h, int w, int C, int zero_rows, int act,
                            void* stream) {
  if (n != 3 * STAGES || C < 1 || C > ldhead::MAXC)
    return (int)cudaErrorInvalidValue;
  StageTable<STAGES> tab = read_table<STAGES>(table);
  int smem = 0;
  long long units = 0;
  const int rc = launch_shape(tab, B, h, w, &smem, &units);
  if (rc) return rc;
  auto E = static_cast<const bf16*>(enc);
  auto Wb = static_cast<const bf16*>(wbuf);
  auto Vb = static_cast<const float*>(vbuf);
  const size_t plane = (size_t)256 * B * h * w;
  bf16* P0 = static_cast<bf16*>(scratch);
  bf16 *P1 = P0 + plane, *P2 = P1 + plane;
  auto Sp = static_cast<float*>(S);
  auto N = static_cast<int*>(barriers);
  void* args[] = {&E, &Wb, &Vb, &tab, &P0, &P1,        &P2, &Sp,
                  &N, &B,  &h,  &w,   &C,  &zero_rows, &act};
  return launch_cooperative(decoder_fused_kernel, THREADS, smem, units, args,
                            static_cast<cudaStream_t>(stream));
}

// The launch the card would make for ld_decoder_fused at this shape and
// table: info[0..7] as common.cuh's cooperative_info.
LD_API int ld_decoder_fused_info(void* info, const void* table, int n, int B,
                                 int h, int w) {
  if (n != 3 * STAGES) return (int)cudaErrorInvalidValue;
  StageTable<STAGES> tab = read_table<STAGES>(table);
  int smem = 0;
  long long units = 0;
  const int rc = launch_shape(tab, B, h, w, &smem, &units);
  if (rc) return rc;
  return cooperative_info(decoder_fused_kernel, THREADS, smem, units,
                          static_cast<int*>(info));
}
