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
// three scratch planes fit the 50 MB L2) and the encoder is one persistent
// grid that walks its 29 passes with a grid.sync() between each pair:
//
//   initial downsampler 3 -> 16   1 pass   (FFMA, a thread per pixel)
//   down1 16 -> 64                1 pass   (K2's tensor-core tile)
//   5 x NB1D-64, d = 1            2 passes each (K1's row tile, nb1d.cuh)
//   down2 64 -> 128               1 pass
//   8 x NB1D-128, d = 2, 4, 8, 16 x2   2 passes each
//
// Every pass runs the device code of the standalone kernels K2 and K1
// (downsampler.cuh, nb1d.cuh) on the same inputs, so the output is bit for
// bit that of K2 and K1 launched block by block (models/fused_graph.py::
// encoder_blocks). Planes written in the launch are read through L2 only
// (cp.async.cg, ld.global.cg). Ahead of the barrier before an NB1D pass,
// each block issues the first weight chunks of its first tile of that
// pass.
//
// Images: (B, H, W, 3) bf16; enc: (B, H/8, W/8, 128) bf16; W <= 512 (the
// NB1D row tiles hold whole rows: W/4 <= 128, W/8 <= 64). The constants
// are one bf16 weight buffer and one f32 vector buffer laid out once by
// `pack_encoder` (ops/backbone_fused.py), with a table of offsets passed by
// value: stage s's weights at wb + w[s] (taps-first, the order the tiles
// read), its vectors (a downsampler's mul then add, an NB1D block's b1 m1
// a1 b3 m2 a2) at vb + v[s], its dilation d[s].
//
// Bound on the card: the same operations as K2 and K1 (the NB1D blocks'
// tensor-core work leads), against the image, the constants and enc
// crossing HBM once. The 28 grid-wide barriers take the place of 29
// launches (3 of K2, 13 x 2 of K1); the kernel writes the count it ran to
// `barriers`.
// The grid is co-resident: the occupancy at the largest dynamic shared
// memory of any pass times the SM count, capped at the largest pass's work
// units; every pass keeps 8 warps a block within 128 registers a thread,
// so two blocks share an SM. A cooperative launch that the card refuses
// returns its error; there is no fallback to the block sequence.

#include "downsampler.cuh"
#include "nb1d.cuh"

namespace cg = cooperative_groups;

namespace {

using nb1d::THREADS;
static_assert(THREADS == 32 * ldds::NW, "one block size for every pass");

constexpr int STAGES = 16;  // initial, down1, 5 x NB1D-64, down2, 8 x NB1D-128
constexpr int NB64 = 2, DOWN2 = 7, NB128 = 8;  // first stage of each group

// P0..P2: scratch planes of 4*B*H*W values each; *barriers: the grid
// barriers run
__global__ void __launch_bounds__(THREADS, 2) encoder_fused_kernel(
    const bf16* img, const bf16* wb, const float* vb, StageTable<STAGES> tab,
    bf16* P0, bf16* P1, bf16* P2, bf16* out, int* barriers, int B, int H,
    int W) {
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
  ldds::ds1_pass(img, wb + sw[0], v0, v0 + 16, P0, B, H, W,
                 reinterpret_cast<float*>(smem));
  sync();
  const float* v1 = vb + sv[1];
  ldds::s2_pass<16, 48>(
      ldds::ds_op(P0, wb + sw[1], v1, v1 + 64, P1, B, H / 2, W / 2, 16, 64),
      1, smem);
  // 5 x NB1D-64 on (B, H/4, W/4, 64): P1 -> P0 -> P1 -> P0 -> P1 -> P0,
  // the pass A outputs in P2
  const int H4 = H / 4, W4 = W / 4, H8 = H / 8, W8 = W / 8;
  bool pre =
      nb1d::issue_block_weights<64>(wb + sw[NB64], B * H4, H4, W4, smem);
  sync();
#pragma unroll 1  // one copy of the block's code
  for (int i = NB64; i < DOWN2; ++i) {
    const bool even = (i - NB64) % 2 == 0;
    nb1d::block_passes<64>(grid, even ? P1 : P0, wb + sw[i], vb + sv[i],
                           sd[i], P2, even ? P0 : P1, B * H4, H4, W4, smem,
                           pre, nsync);
    pre = i + 1 < DOWN2 && nb1d::issue_block_weights<64>(
                               wb + sw[i + 1], B * H4, H4, W4, smem);
    sync();
  }
  // (DOWN2 - NB64 = 5 blocks: the last output is in P0)
  const float* v7 = vb + sv[DOWN2];
  ldds::s2_pass<64, 64>(
      ldds::ds_op(P0, wb + sw[DOWN2], v7, v7 + 128, P1, B, H4, W4, 64, 128),
      1, smem);
  pre = nb1d::issue_block_weights<128>(wb + sw[NB128], B * H8, H8, W8, smem);
  sync();
  // 8 x NB1D-128 on (B, H/8, W/8, 128): P1 -> P0 -> out -> P0 -> ... ->
  // out, so that the last block lands in `out`
#pragma unroll 1  // one copy of the block's code
  for (int i = NB128; i < STAGES; ++i) {
    const int k = i - NB128;
    const bf16* x = k == 0 ? P1 : k % 2 ? P0 : out;
    bf16* dst = k % 2 ? out : P0;
    nb1d::block_passes<128>(grid, x, wb + sw[i], vb + sv[i], sd[i], P2, dst,
                            B * H8, H8, W8, smem, pre, nsync);
    if (i + 1 < STAGES) {
      pre = nb1d::issue_block_weights<128>(wb + sw[i + 1], B * H8, H8, W8,
                                           smem);
      sync();
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *barriers = nsync;
}

// The launch's shape: dynamic shared memory (the largest pass's) and work
// units (the largest pass's blocks or tiles). 0 for a plane the kernel
// does not take.
int launch_shape(const StageTable<STAGES>& tab, int B, int H, int W,
                 int* smem, long long* units) {
  if (H % 8 || W % 8 || B < 1 || W / 4 > nb1d::Cfg<64>::MT ||
      W / 8 > nb1d::Cfg<128>::MT)
    return (int)cudaErrorInvalidValue;
  const int H4 = H / 4, W4 = W / 4, H8 = H / 8, W8 = W / 8;
  int s = (int)sizeof(float) * ldds::D1_SW;
  auto most = [](int a, int b) { return a > b ? a : b; };
  s = most(s, lds2::GemmTile<bf16, 16, 48, ldds::NW>::SMEM);
  s = most(s, lds2::GemmTile<bf16, 64, 64, ldds::NW>::SMEM);
  for (int i = NB64; i < DOWN2; ++i)
    s = most(s, nb1d::smem_bytes<64>(W4, tab.d[i]));
  for (int i = NB128; i < STAGES; ++i)
    s = most(s, nb1d::smem_bytes<128>(W8, tab.d[i]));
  *smem = s;
  const long long pix1 = (long long)B * (H / 2) * (W / 2);
  long long u = (pix1 + THREADS - 1) / THREADS;  // initial: a thread a pixel
  auto more = [&](long long v) { u = v > u ? v : u; };
  more((pix1 / 4 + ldds::BM - 1) / ldds::BM);  // down1's tiles
  const int R64 = nb1d::Cfg<64>::MT / W4, R128 = nb1d::Cfg<128>::MT / W8;
  more(((long long)B * H4 + R64 - 1) / R64);
  more(((long long)B * H8 * W8 + ldds::BM - 1) / ldds::BM);  // down2's
  more(((long long)B * H8 + R128 - 1) / R128);
  *units = u;
  return 0;
}

}  // namespace

// x: (B, H, W, 3) bf16, H and W multiples of 8, W <= 512; wbuf bf16, vbuf
// f32 (16-byte aligned segments); table: n = 3 * 16 host ints (w offsets,
// v offsets, dilations); scratch: 3 planes of 4*B*H*W bf16; out: (B, H/8,
// W/8, 128); barriers: 1 device int, the grid barriers the launch ran.
LD_API int ld_encoder_fused(const void* x, const void* wbuf, const void* vbuf,
                            const void* table, int n, void* scratch,
                            void* out, void* barriers, int B, int H, int W,
                            void* stream) {
  if (n != 3 * STAGES) return (int)cudaErrorInvalidValue;
  StageTable<STAGES> tab = read_table<STAGES>(table);
  int smem = 0;
  long long units = 0;
  const int rc = launch_shape(tab, B, H, W, &smem, &units);
  if (rc) return rc;
  auto X = static_cast<const bf16*>(x);
  auto Wb = static_cast<const bf16*>(wbuf);
  auto Vb = static_cast<const float*>(vbuf);
  const size_t plane = (size_t)4 * B * H * W;
  bf16* P0 = static_cast<bf16*>(scratch);
  bf16 *P1 = P0 + plane, *P2 = P1 + plane;
  auto O = static_cast<bf16*>(out);
  auto N = static_cast<int*>(barriers);
  void* args[] = {&X, &Wb, &Vb, &tab, &P0, &P1, &P2, &O, &N, &B, &H, &W};
  return launch_cooperative(encoder_fused_kernel, THREADS, smem, units, args,
                            static_cast<cudaStream_t>(stream));
}

// The launch the card would make for ld_encoder_fused at this shape and
// table: info[0..7] as common.cuh's cooperative_info.
LD_API int ld_encoder_fused_info(void* info, const void* table, int n, int B,
                                 int H, int W) {
  if (n != 3 * STAGES) return (int)cudaErrorInvalidValue;
  StageTable<STAGES> tab = read_table<STAGES>(table);
  int smem = 0;
  long long units = 0;
  const int rc = launch_shape(tab, B, H, W, &smem, &units);
  if (rc) return rc;
  return cooperative_info(encoder_fused_kernel, THREADS, smem, units,
                          static_cast<int*>(info));
}
