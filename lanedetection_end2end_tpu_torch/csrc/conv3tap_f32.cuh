// The 3-tap convolution and its weight gradient in float32, on Hopper's
// tensor cores in 3xTF32 split precision: the float32 counterparts of
// conv3tap.cuh and wgrad3tap.cuh, with the same prologue and epilogues,
// used by nb_half_fwd.cu / nb_half_bwd.cu (K6 / K7) and packed_conv.cu
// (K11). `ldconv::launch_conv` and `ldconv::launch_wgrad` take a float32
// plane here and a bf16 one in the bf16 headers, so a caller templated on
// the plane type calls them alike.
//
// Replaces, in float32, the convolutions and weight gradients of the TPU
// kernels `_half_a_fwd_kernel`, `_half_a_bwd_kernel`, `_half_b_fwd_kernel`
// and `_half_b_bwd_kernel` (lanedetection_end2end_tpu/ops/
// pallas_nb_block.py:198, :212, :321, :339), and of K11's
// (pallas_packed_conv.py:66, :81, :149, :167).
//
// Precision. A TF32 product keeps 10 mantissa bits, about 1e-3 relative,
// and the float32 path is held to 1e-4 of max|plain| against the plain
// PyTorch version in full f32. So every f32 operand a is split on the
// card, hi = tf32(a), lo = tf32(a - hi) (cvt.rna both): the activations
// in the SM as their fragments are read, the convolution's tap matrices
// once a launch into device memory (wsplit_f32_kernel), the weight
// gradient's dy in shared memory. Each product is taken as
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b,
// three TF32 products into the one f32 accumulator, smallest terms first.
// What is lost (lo_a * lo_b, about 2^-22 of the product) is below f32
// rounding. ops/tf32x3.py states the same arithmetic in PyTorch, and the
// CPU tests hold it there.
//
// Bound. A convolution is 6*C^2 f32 FLOP per pixel against 8*C bytes (the
// plane read, the output written); as three TF32 products it runs at most
// at 495 / 3 = 165 TFLOP/s, whose ridge is about 49 FLOP per byte of the
// H100's 3.35 TB/s. The operations bound C = 128 (96 FLOP per byte), C = 64
// sits at the ridge (48) and the bytes bound C = 16 (12): at the train
// step's planes at batch 128 each convolution's bound is about 0.16 ms at
// every C. The weight gradient does the same work per pixel. Legacy
// `mma.sync` TF32 runs well below the rate `wgmma` reaches on this card, so
// the products are `wgmma` instructions (m64 x C x 8, A from registers, B
// from shared memory), issued by warpgroups of 4 warps. The split costs two
// cvt and a subtraction per operand value.
//
// conv3tap_f32_kernel replaces a tile that copied the tap matrices 4 bytes
// at a time into every block for every chunk of K and split them there,
// copied each activation row once for each tap, and ran one block of two
// warpgroups in step per 128 or 256 pixels, one chunk's copies, splits,
// products and epilogue after another: 32% of its bound (PERF.md). Its
// design, by what it does about that:
//  - the tap matrices are split once a launch (wsplit_f32_kernel, a few us,
//    the convolution a programmatic dependent of it) into TF32 hi and lo
//    planes in wgmma's core-matrix order, which the blocks take with bulk
//    copies: resident in shared memory at C = 16 and 64, streamed through
//    a ring of mbarrier stages at C = 128 (384 KB), no thread copying or
//    splitting a weight in the main loop;
//  - a tile is BM pixels of one image (TileGeo, as the bf16 tile's), staged
//    with its halo of d rows or columns once for the three taps, which read
//    offset views of it; the prologue runs once on each staged value; a
//    stage carries 32 input channels (C = 128) or 16 (a whole pixel at C =
//    16), so that the plane is read in runs of 64 or 128 bytes a pixel;
//  - persistent blocks of independent warpgroups, one wave, each walking
//    tiles of its own through a ring of its own: one warpgroup's copies,
//    prologue and splits overlap another's products, and a tile's
//    epilogue the next tile's copies.
// Measured (H100 80GB HBM3, 700 W, tools/prof_conv3tap.py --dtype float32,
// PERF.md): 49.3 ms of card time a default float32 step at batch 128,
// against 67.1 for the former tile; by C, forward + input gradient, 5.0,
// 23.7 and 20.7 ms (16, 64, 128). A clock64 breakdown of the warpgroups'
// loop puts about a fifth of it in issuing the copies, a fifth in reading
// and splitting A's fragments and a sixth in the products' issue.
//
// conv3tap_f32_kernel: an implicit GEMM, M = pixels, N = C output channels,
// K = 3 taps x C input channels, in products of KC input channels of all
// three taps: K is summed chunk by chunk, the three taps in turn within a
// chunk, where the former tile summed it tap by tap, so y and the sums
// agree with the former tile's to rounding, not bit for bit. The epilogues are conv3tap.cuh's without its bf16 roundings;
// each thread holds two adjacent channels of two pixel rows per 8
// channels, and the per-channel sums, kept across a block's tiles, fold
// over the warp with shuffles, over the block's warps in warp order in
// shared memory, and the block writes them to its row of a partials
// buffer, which one fixed-order fold (fold.cuh) adds up after the entry
// point's last launch.
//
// wgrad3tap_f32_kernel (C = 64, 128): dk[t] += shift_t(f(in))^T @ dy,
// M = C input channels, N = C output channels, K = the block's pixels in
// chunks of 32, split over blocks (blockIdx.y is the tap, f the prologue
// when given), through a ring of STAGES shared-memory stages filled by
// cp.async (16-byte copies of the input rows, src-size 0, a zero fill, for
// rows whose tap falls off the plane; 4-byte copies of dy, scattered into
// wgmma's K-major core-matrix layout). Once a chunk lands, each thread
// applies the prologue to its rows that lie on the plane and splits its dy
// values into a hi and a lo copy; one barrier a chunk publishes both. The
// staged input rows are read as the transposed A operand, so no transpose
// is written; dy is B. Its C = 16 specialization does the same on
// mma.sync: wgmma's 64 rows would be a quarter used, and the 16-channel
// plane is bound by its bytes; this tile with its rows 16 .. 63 zero took
// more than twice the mma.sync one's time on the H100 (PERF.md). Each
// block writes its C x C sums (the two warpgroups' halves of the pixel
// steps at C = 64, the 8 warps' at C = 16, added in a fixed order in
// shared memory) to its row of a partials buffer, and the fold adds the
// rows: no atomics, so dk, like every sum here, is bit for bit the same
// from launch to launch, and is written whole.
//
// The block partitions depend on the shape alone: the convolution takes
// one wave of blocks at most, each the groups of NWG tiles dealt to it in
// turn (ops/nb_block.py::conv_rows); the weight gradient takes
// WG_PER_TAP[C] blocks a tap (one wave of the H100: 3, 2 and 1 blocks an
// SM at C = 16, 64, 128), each a run of whole pixel chunks (ops/nb_block.py
// sizes the partials from the same counts).
//
// Each C in {16, 64, 128} has one fixed tile per kernel, which takes any
// d >= 1 (also d >= H or W, where the shifted taps read only zeros) and
// any pixel count: there is no other path, and a launch the card refuses
// returns its error.
#pragma once

#include <stdint.h>

#include "fold.cuh"
#include "tc_common.cuh"
#include "wgrad3tap.cuh"

namespace ldconv32 {

constexpr int THREADS = 256;  // 8 warps, both kernels
constexpr int STAGES = 3;     // depth of the cp.async ring

using ldconv::bn_affine;
using ldconv::EPI_BIAS;
using ldconv::EPI_BIAS_MOM;
using ldconv::EPI_BIAS_RELU;
using ldconv::EPI_MASK_SUM;
using ldconv::EPI_PLAIN;
using ldconv::EPI_PRO_BWD;
using ldconv::sums_of;
using ldtc::cp_async16;
using ldtc::cp_async4;
using ldtc::cp_async_commit;
using ldtc::cp_async_wait;
using ldtc::fence_proxy_async;
using ldtc::keep;
using ldtc::mma_tf32;
using ldtc::split_tf32;
using ldtc::wgmma_commit;
using ldtc::wgmma_fence;
using ldtc::wgmma_wait0;

// ---- PTX -----------------------------------------------------------------

// The B operand of wgmma in shared memory, K-major without swizzle: core
// matrices of 8 rows (n) x 4 tf32 (k), 128 contiguous bytes each, row r at
// byte 16r. For a KB-deep slice, element (n, k) is float
// ((n / 8) * (KB / 4) + k / 4) * 32 + (n % 8) * 4 + k % 4: the 32 values of
// a core matrix are 32 consecutive floats. core_nk<KB>(e) gives the (n, k)
// of float e.
template <int KB>
__device__ __forceinline__ void core_nk(int e, int& n, int& k) {
  const int cm = e >> 5, wd = e & 31;
  n = cm / (KB / 4) * 8 + (wd >> 2);
  k = cm % (KB / 4) * 4 + (wd & 3);
}

// Descriptor of the 8-deep slice of such a B that starts at `p` (core
// matrix (0, k / 4) of the step): the next 4 k 128 bytes on (leading
// offset), the next 8 n KB / 4 * 128 bytes on (stride offset), no swizzle.
template <int KB>
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((KB / 4 * 128) >> 4) << 32);
}

// d (m64 x N, f32) += a (m64 x 8, TF32, registers) @ b (8 x N, TF32, shared
// memory through its descriptor), issued by the 4 warps of a warpgroup;
// with keep_d = 0, d = a @ b (wgmma's scale-d: the accumulator is not
// read, so no other instruction has to zero it).
// Warp w holds rows 16w .. 16w + 15 of a and d; thread (g, tg) = (lane / 4,
// lane % 4) holds a[g][tg], a[g+8][tg], a[g][tg+4], a[g+8][tg+4] and
// d[4j + 2h + e] = d[g + 8h][8j + 2tg + e].
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc,
                                             int keep_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(keep_d)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc,
                                             int keep_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(keep_d)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc,
                                             int keep_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(keep_d)
        : "memory");
  }
};

// acc (MT m64 tiles x N) += the 8-deep step's products of the split
// operands: lo_a hi_b + hi_a lo_b + hi_a hi_b, smallest terms first; with
// keep_acc = 0 the first product starts acc afresh.
template <int N, int MT>
__device__ __forceinline__ void wgmma3(float (&acc)[MT][N / 2],
                                       const uint32_t (&ahi)[MT][4],
                                       const uint32_t (&alo)[MT][4],
                                       uint64_t bhi, uint64_t blo,
                                       int keep_acc = 1) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    Wgmma<N>::mma(acc[mt], alo[mt], bhi, keep_acc);
    Wgmma<N>::mma(acc[mt], ahi[mt], blo);
    Wgmma<N>::mma(acc[mt], ahi[mt], bhi);
  }
}

// The B values this thread copied (floats e = threadIdx.x + j * THREADS of
// the stage's B), split in place: hi where the value was, lo at the same
// place in `lo`.
template <int COPIES>
__device__ __forceinline__ void split_b(float* hi, float* lo) {
#pragma unroll
  for (int j = 0; j < COPIES; ++j) {
    const int e = threadIdx.x + j * THREADS;
    uint32_t h, l;
    split_tf32(hi[e], h, l);
    hi[e] = __uint_as_float(h);
    lo[e] = __uint_as_float(l);
  }
}

// relu(v * mul + add) on four channels, bn_affine's rounding
__device__ __forceinline__ void prologue4(float4* v, float4 mul, float4 add) {
  float4 x = *v;
  x.x = fmaxf(bn_affine(x.x, mul.x, add.x), 0.0f);
  x.y = fmaxf(bn_affine(x.y, mul.y, add.y), 0.0f);
  x.z = fmaxf(bn_affine(x.z, mul.z, add.z), 0.0f);
  x.w = fmaxf(bn_affine(x.w, mul.w, add.w), 0.0f);
  *v = x;
}

// ---- the convolution ------------------------------------------------------

// The tap matrices as wgmma reads them, written once a launch by
// wsplit_f32_kernel: for each chunk cc of KC input channels and tap t, the
// KC x C slice w[t][cc KC + k][n] as a TF32 hi plane and a lo plane (the
// cvt.rna split of split_tf32), each in core_nk<KC>'s K-major core-matrix
// order. Float ((cc * 3 + t) * 2 + h) * KC * C + e of the planes is
// element core_nk<KC>(e) of plane h (0 hi, 1 lo) of tap t in chunk cc, so a
// chunk's three taps are B_CHUNK contiguous floats and all of them
// 6 * C * C.
template <int C, int KC>
__global__ void __launch_bounds__(256)
    wsplit_f32_kernel(const float* __restrict__ w, float* __restrict__ planes) {
  // the convolution may start while this runs (a programmatic dependent
  // launch): it waits for these planes alone
  asm volatile("griddepcontrol.launch_dependents;");
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= 3 * C * C) return;
  const int idx = e % (KC * C), q = e / (KC * C);
  const int t = q % 3, cc = q / 3;
  int n, k;
  core_nk<KC>(idx, n, k);
  uint32_t hi, lo;
  split_tf32(w[((size_t)t * C + cc * KC + k) * C + n], hi, lo);
  float* p = planes + (size_t)(cc * 3 + t) * 2 * KC * C + idx;
  p[0] = __uint_as_float(hi);
  p[KC * C] = __uint_as_float(lo);
}

// A block: NWG warpgroups, persistent, each in step only with itself (a
// named barrier), so that one warpgroup's copies, prologue and splits
// overlap another's products. The block walks groups of NWG tiles
// (warpgroup w of block b takes tiles b NWG + w + k NWG blocks, the bf16
// tile's walk), each tile BM pixels of one image x all C output channels
// (ldconv::TileGeo: 8 rows x BM / 8 columns for the row taps, BM columns of
// a row for the column taps), MT m64 tiles of pixels. A warpgroup's ring
// stage holds KCS input channels of its tile's staged pixels (rows of KCS
// floats, pitch LDA): one run of the tile and d more rows or columns on
// each side, the three taps offset views of it, else three bands of BM
// (TileGeo::nload, base), so each input value is copied, prologued and
// split about once a tap; a tap off the plane is a staged pixel off it,
// which the copy zero-fills and the prologue skips. A stage is U products
// of KC input channels of all three taps. The ring holds as many stages of
// the launch's staged rows as fit, at most MAX_STAGES, at least two. The
// planes of the tap matrices (wsplit_f32_kernel) are resident, one bulk
// copy a block, at C = 16 and 64 (6 KB, 96 KB); at C = 128 (384 KB) they
// stream through B_STAGES stages of one product's B_CHUNK floats shared by
// the warpgroups: thread 0 refills a stage with a bulk copy on its `full`
// mbarrier once every warp has arrived on its `empty` one, done with the
// product it held. A warpgroup's wgmma of one product runs on while it
// reads and splits the next product's fragments, or waits for, prologues
// and publishes its next stage.
template <int C>
struct ConvTile {
  static constexpr int WAVE = 132;              // the H100's SMs
  static constexpr int NWG = C == 16 ? 4 : 2;   // warpgroups a block
  static constexpr int THREADS = NWG * 128;
  static constexpr int MT = C == 64 ? 2 : 1;    // m64 tiles a tile
  static constexpr int BM = 64 * MT;            // pixels a tile
  static constexpr int KC = C == 16 ? 16 : 8;   // input channels a product
  static constexpr int KS = KC / 8;             // 8-deep steps a product
  // input channels a stage: runs of 128 or 64 bytes a pixel
  static constexpr int KCS = C == 128 ? 32 : 16;
  static constexpr int U = KCS / KC;            // products a stage
  static constexpr int CPT = C / KCS;           // stages a tile
  static constexpr int LDA = KCS + 4;  // pitch of the staged rows, in floats
  static constexpr int VPR = KCS / 4;  // 16-byte copies a staged row
  static constexpr int ROWS = 3 * BM;           // staged rows a tile, at most
  static constexpr int B_CHUNK = 6 * KC * C;    // floats of a product's planes
  static constexpr int PLANES = 6 * C * C;      // floats of all of them
  static constexpr bool RESIDENT = C <= 64;
  static constexpr int B_STAGES = 4;  // the streamed planes' stages
  static constexpr int MAX_STAGES = 8;
  static constexpr int BARS = 128;  // bytes: the mbarriers
  static constexpr int W_BYTES = (RESIDENT ? PLANES : B_STAGES * B_CHUNK) * 4;
  static constexpr int SMEM = 232448;            // bytes, the SM's most
  // bytes of a warpgroup's ring, on 128-byte boundaries
  static constexpr int RING = (SMEM - BARS - W_BYTES) / NWG / 128 * 128;
  // floats of a stage of `nload` staged rows: 128-byte boundaries
  __host__ __device__ static constexpr int stage_floats(int nload) {
    return (nload * LDA + 31) & ~31;
  }
  static_assert(8 * (1 + 2 * B_STAGES) <= BARS && W_BYTES % 128 == 0,
                "the mbarriers; the rings on 128-byte boundaries");
  static_assert(128 % VPR == 0 && LDA % 4 == 0, "a thread's channels");
};

// cp_async_wait<n> for a depth n in 0 .. MAX_STAGES - 2 known at run time
// (uniform across the warpgroup)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// out[p, co] = epilogue(sum_t sum_ci f(in[p + tap_t])[ci] * w[t, ci, co]),
// taps at -d, 0, +d along rows (axis 0) or columns (axis 1, `geo`); f is
// the prologue when pmul != nullptr. Arguments and epilogues as
// conv3tap.cuh's conv3tap_kernel, in f32 throughout: nothing is rounded
// to bf16. `planes`: w split by wsplit_f32_kernel. `part` is the partials
// of the sums epilogues, SUMS(EPI) x C floats a block (row blockIdx.x: the
// block's sums over its tiles).
template <int C, int EPI>
__global__ void __launch_bounds__(ConvTile<C>::THREADS, 1)
    conv3tap_f32_kernel(const float* __restrict__ in,
                        const float* __restrict__ planes,
                        const float* __restrict__ pmul,
                        const float* __restrict__ padd,
                        const float* __restrict__ vec,
                        const float* __restrict__ aux,
                        float* __restrict__ out, float* __restrict__ part,
                        int npix, ldconv::TileGeo<ConvTile<C>::BM> geo) {
  using T = ConvTile<C>;
  static_assert(2 * T::stage_floats(T::ROWS) * 4 <= T::RING &&
                    T::THREADS / 32 * 2 * C * 4 <= T::W_BYTES + T::RING,
                "a ring of three stages at least; room for the sums");
  extern __shared__ __align__(128) unsigned char smem[];
  // full[s], empty[s]: stage s of the streamed planes; bar[0]: the resident
  // planes
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bar + 1;
  uint64_t* empty = full + T::B_STAGES;
  float* sW = reinterpret_cast<float*>(smem + T::BARS);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  float* sRing =
      reinterpret_cast<float*>(smem + T::BARS + T::W_BYTES + wg * T::RING);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = (warp % 4) * 16;  // this warp's rows of each m64 tile

  // block b takes the groups of NWG tiles b, b + blocks, ...: chunk i of
  // its walk is chunk i % CPT of group b + (i / CPT) blocks
  const int ntiles = geo.ntiles(npix);
  const int groups = (ntiles + T::NWG - 1) / T::NWG;
  const int b = (int)blockIdx.x, blocks = (int)gridDim.x;
  const int n = (b < groups ? (groups - 1 - b) / blocks + 1 : 0) * T::CPT;
  const int nload = geo.nload();
  const int stage_floats = T::stage_floats(nload);
  const int nst = min(T::MAX_STAGES, T::RING / (stage_floats * 4));

  // this warpgroup's staged rows of chunk i
  auto stage = [&](int i) { return sRing + (i % nst) * stage_floats; };
  // this warpgroup's tile of chunk i: false past the last tile
  auto tile_at = [&](int i, int& R0, int& h0, int& c0) {
    const int tile = (b + i / T::CPT * blocks) * T::NWG + wg;
    if (tile >= ntiles) return false;
    geo.at(tile, R0, h0, c0);
    return true;
  };
  auto load_chunk = [&](int i) {
    int R0, h0, c0;
    if (!tile_at(i, R0, h0, c0)) return;
    float* sA = stage(i);
    const int ch = (i % T::CPT) * T::KCS;
    for (int e = tid; e < nload * T::VPR; e += 128) {
      const int j = e / T::VPR, v = e % T::VPR;
      const int q = geo.staged_pixel(R0, h0, c0, j);
      cp_async16(sA + j * T::LDA + v * 4,
                 q >= 0 ? in + (size_t)q * C + ch + v * 4 : in, q >= 0);
    }
  };
  // the streamed planes of product j (product u of stage i is j = i U +
  // u) into stage j % B_STAGES (thread 0), once every warp is done with
  // product j - B_STAGES there
  const int nprod = n * T::U;
  auto load_planes = [&](int j) {
    const int s = j % T::B_STAGES;
    if (j >= T::B_STAGES)
      ldtc::mbar_wait(empty + s, (j / T::B_STAGES - 1) & 1);
    ldtc::mbar_expect(full + s, T::B_CHUNK * 4);
    ldtc::bulk_copy(sW + s * T::B_CHUNK,
                    planes + (size_t)(j % (C / T::KC)) * T::B_CHUNK,
                    T::B_CHUNK * 4, full + s);
  };

  if (threadIdx.x == 0) {
    ldtc::mbar_init(bar, 1);
    for (int s = 0; s < T::B_STAGES; ++s) {
      ldtc::mbar_init(full + s, 1);
      ldtc::mbar_init(empty + s, T::THREADS / 32);
    }
    ldtc::mbar_init_fence();
  }
  __syncthreads();  // the mbarriers initialized
  // the launch is a programmatic dependent of the weight split: the one
  // thread that copies the planes waits for it, while the others' first
  // copies of pixels are already on their way
  if (threadIdx.x == 0 && n > 0) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (T::RESIDENT) {
      ldtc::mbar_expect(bar, T::PLANES * 4);
      ldtc::bulk_copy(sW, planes, T::PLANES * 4, bar);
    } else {
      for (int j = 0; j < T::B_STAGES - 2 && j < nprod; ++j) load_planes(j);
    }
  }
  // this warpgroup's first nst - 1 chunks, a group each: chunk i + nst -
  // 1 refills the stage of chunk i - 1
  for (int i = 0; i < nst - 1; ++i) {
    if (i < n) load_chunk(i);
    cp_async_commit();
  }
  if (T::RESIDENT && n > 0) ldtc::mbar_wait(bar, 0);

  float acc[T::MT][C / 2] = {};
  float s0[C / 8][2], s1[C / 8][2];  // this thread's channel sums
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
    s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;
  // the A fragments of a product's three taps, in flight with its wgmma
  uint32_t ahi[3][T::KS][T::MT][4] = {}, alo[3][T::KS][T::MT][4] = {};
  int R0 = 0, h0 = 0, c0 = 0;
  bool have = false;  // this warpgroup has a tile in this group

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int cc = i % T::CPT;
    if (cc == 0) have = tile_at(i, R0, h0, c0);
    cp_async_wait_n(nst - 2);  // this thread's copies of chunk i landed
    float* sA = stage(i);
    if (pmul != nullptr && have) {
      // the prologue on the rows this thread copied that lie on the plane
      const int c = cc * T::KCS + (tid % T::VPR) * 4;
      const float4 mul = *reinterpret_cast<const float4*>(pmul + c);
      const float4 add = *reinterpret_cast<const float4*>(padd + c);
      for (int e = tid; e < nload * T::VPR; e += 128) {
        const int j = e / T::VPR;
        if (geo.staged_pixel(R0, h0, c0, j) < 0) continue;
        prologue4(reinterpret_cast<float4*>(sA + j * T::LDA +
                                            (e % T::VPR) * 4),
                  mul, add);
      }
    }
    // every thread's rows of chunk i (and their prologue) visible to the
    // warpgroup, and its reads of chunk i - 1, whose stage is refilled
    // next, done
    ldconv::warpgroup_sync(wg);
    if (i + nst - 1 < n) load_chunk(i + nst - 1);
    cp_async_commit();  // possibly empty: one group per iteration

    // U products of KC channels from the stage, each from the fragments of
    // the three taps: tile pixel m of tap t is staged row geo.base(t) + m.
    // A warpgroup past the last tile multiplies what its stage holds and
    // stores nothing: the wgmma stay out of branches, so the compiler keeps
    // them asynchronous
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const int k = i * T::U + u;  // this product of the walk
      wgmma_wait0();  // this warpgroup's product k - 1: its registers
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) keep(acc[mt]);
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int s = 0; s < T::KS; ++s)
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            keep(ahi[t][s][mt]);
            keep(alo[t][s][mt]);
          }
      if (!T::RESIDENT) {
        // this warp is done with product k - 1's planes; thread 0 refills
        // the stage of product k - 2 once every warp is done with it
        if (k > 0 && lane == 0)
          ldtc::mbar_arrive(empty + (k - 1) % T::B_STAGES);
        if (threadIdx.x == 0 && k + T::B_STAGES - 2 < nprod)
          load_planes(k + T::B_STAGES - 2);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const float* at =
            sA + (geo.base(t) + m0 + g) * T::LDA + u * T::KC + tg;
#pragma unroll
        for (int s = 0; s < T::KS; ++s)
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            const float* a = at + mt * 64 * T::LDA + s * 8;
            split_tf32(a[0], ahi[t][s][mt][0], alo[t][s][mt][0]);
            split_tf32(a[8 * T::LDA], ahi[t][s][mt][1], alo[t][s][mt][1]);
            split_tf32(a[4], ahi[t][s][mt][2], alo[t][s][mt][2]);
            split_tf32(a[8 * T::LDA + 4], ahi[t][s][mt][3],
                       alo[t][s][mt][3]);
          }
      }
      const float* sB =
          sW + (T::RESIDENT ? cc * T::U + u : k % T::B_STAGES) * T::B_CHUNK;
      if (!T::RESIDENT)
        ldtc::mbar_wait(full + k % T::B_STAGES, (k / T::B_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int s = 0; s < T::KS; ++s)  // a tile's first product starts acc
          wgmma3<C>(acc, ahi[t][s], alo[t][s],
                    b_desc<T::KC>(sB + 2 * t * T::KC * C + s * 64),
                    b_desc<T::KC>(sB + (2 * t + 1) * T::KC * C + s * 64),
                    cc + u + t + s > 0);
      wgmma_commit();
    }
    if (cc != T::CPT - 1) continue;

    // the tile's epilogue. acc[mt][4j + 2h + e]: tile pixel m = mt * 64 +
    // m0 + g + 8h, channel 8j + 2tg + e
    wgmma_wait0();
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) keep(acc[mt]);
    if (!have) continue;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = geo.pixel(R0, h0, c0, mt * 64 + m0 + g + 8 * h, C);
        if (p < 0) continue;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int c2 = 8 * j + 2 * tg;
          const size_t base = (size_t)p + c2;
          float2 xa = make_float2(0.0f, 0.0f);
          if (EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD)
            xa = *reinterpret_cast<const float2*>(aux + base);
          const float xv[2] = {xa.x, xa.y};
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c2 + e;
            const float a = acc[mt][4 * j + 2 * h + e];
            if (EPI == EPI_BIAS_RELU) {
              o[e] = fmaxf(a + vec[c], 0.0f);
            } else if (EPI == EPI_BIAS) {
              o[e] = a + vec[c];
            } else if (EPI == EPI_BIAS_MOM) {
              o[e] = a + vec[c];
              s0[j][e] += o[e];
              s1[j][e] += o[e] * o[e];
            } else if (EPI == EPI_PLAIN) {
              o[e] = a;
            } else if (EPI == EPI_MASK_SUM) {
              o[e] = xv[e] > 0.0f ? a : 0.0f;
              s0[j][e] += o[e];
            } else {  // EPI_PRO_BWD: aux = x, vec = [mul; add]
              const float m =
                  bn_affine(xv[e], vec[c], vec[C + c]) > 0.0f ? a : 0.0f;
              s0[j][e] += m * xv[e];
              s1[j][e] += m;
              o[e] = m * vec[c];
            }
          }
          *reinterpret_cast<float2*>(out + base) = make_float2(o[0], o[1]);
        }
      }
  }

  if (sums_of(EPI) > 0) {
    // lanes with equal tg hold the same channels: fold them onto lanes
    // 0..3 (tg = lane there), then sum the warps' rows in shared memory in
    // warp order, into the block's row of the partials
    float red[C / 2];
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[2 * j + e] = s0[j][e];
        red[C / 4 + 2 * j + e] = s1[j][e];
      }
    cp_async_wait<0>();
    __syncthreads();  // the rings and the planes are free
    float* sRed = sW;  // a row of 2C a warp
    if (fold_lanes(red, 4)) {
      float* row = sRed + warp * 2 * C;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * lane + e;
          row[c] = red[2 * j + e];
          row[C + c] = red[C / 4 + 2 * j + e];
        }
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int k = 0; k < T::THREADS / 32; ++k) {
        a0 += sRed[k * 2 * C + threadIdx.x];
        a1 += sRed[k * 2 * C + C + threadIdx.x];
      }
      float* row = part + (size_t)blockIdx.x * sums_of(EPI) * C;
      row[threadIdx.x] = a0;
      if (sums_of(EPI) == 2) row[C + threadIdx.x] = a1;
    }
  }
}

// ---- the weight gradient --------------------------------------------------

// A block's tile of dk[t] (C = 64, 128; C = 16 is specialized below): M = C
// input channels (one m64 tile, or two for C = 128), N = C output
// channels, K = KP pixels a chunk. C = 128: warpgroup w takes m64 tile w;
// C = 64: both take the one tile and split each chunk's 8-pixel steps. The
// block's sums meet in shared memory at the end.
template <int C>
struct WgradTile {
  static constexpr int MT = C == 128 ? 2 : 1;  // m64 tiles of dk rows
  static constexpr int KSPLIT = 2 / MT;        // warpgroups per tile
  static constexpr int KP = 32;                 // pixels a chunk
  static constexpr int KS = KP / 8;             // 8-deep steps a chunk
  static constexpr int LD = C + 8;  // pitch of the X rows, in floats
  static constexpr int LK = C + 8;  // pitch of the summed dk tile
  static constexpr int VPR = C / 4;  // 16-byte copies an X row
  static constexpr int COPIES = KP * VPR / THREADS;
  static constexpr int B_COPIES = KP * C / THREADS;  // 4-byte copies of dy
  static constexpr int X_FLOATS = KP * LD;
  static constexpr int B_FLOATS = KP * C;  // each of B hi and B lo
  static constexpr int STAGE = X_FLOATS + 2 * B_FLOATS;  // floats
  static constexpr int SMEM = STAGES * STAGE * 4;        // bytes
  static_assert(X_FLOATS % 32 == 0 && STAGE % 32 == 0 && KS % KSPLIT == 0,
                "core matrices on 128-byte boundaries");
  static_assert(THREADS % VPR == 0 && COPIES * THREADS == KP * VPR &&
                    B_COPIES * THREADS == KP * C && COPIES * STAGES <= 32,
                "a thread's copies and their validity bits");
  static_assert(C * LK <= STAGES * STAGE && (C == 64 || C == 128),
                "room for dk");
};

// The sum over this block's pixel chunks of shift_t(f(in))^T @ dy, to the
// block's row of `part` (3 C C floats a row, tap t at t C C, [ci][co]);
// blockIdx.y is the tap t, f the prologue when pmul != nullptr.
template <int C>
__global__ void __launch_bounds__(THREADS, C == 128 ? 1 : 2)
    wgrad3tap_f32_kernel(const float* __restrict__ in,
                         const float* __restrict__ pmul,
                         const float* __restrict__ padd,
                         const float* __restrict__ dy,
                         float* __restrict__ part, int npix, int H, int W,
                         int d, int axis, int chunks_per_block) {
  using T = WgradTile<C>;
  extern __shared__ __align__(128) float smem32[];
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int wg = warp / 4;
  // this warp's 16 rows (input channels) of its warpgroup's m64 tile, and
  // the first of the chunk's steps the warpgroup takes
  const int m0 = (T::MT == 2 ? wg * 64 : 0) + (warp % 4) * 16;
  const int s0 = T::KSPLIT == 2 ? wg : 0;
  const int nchunks = (npix + T::KP - 1) / T::KP;
  const int chunk0 = blockIdx.x * chunks_per_block;
  const int n = min(nchunks, chunk0 + chunks_per_block) - chunk0;

  // this thread copies X rows r0 + j * R_STEP, channels v * 4 .. v * 4 + 3;
  // bit s * COPIES + j of `valid`: row j of ring stage s lies on the plane
  constexpr int R_STEP = THREADS / T::VPR;
  const int v = threadIdx.x % T::VPR, r0 = threadIdx.x / T::VPR;
  float4 mul = make_float4(0.0f, 0.0f, 0.0f, 0.0f), add = mul;
  if (pmul != nullptr) {
    mul = *reinterpret_cast<const float4*>(pmul + v * 4);
    add = *reinterpret_cast<const float4*>(padd + v * 4);
  }
  unsigned valid = 0;

  auto stage = [&](int i) { return smem32 + (i % STAGES) * T::STAGE; };
  auto load_chunk = [&](int i) {
    float* sX = stage(i);
    float* sB = sX + T::X_FLOATS;
    const int pc = (chunk0 + i) * T::KP;
    const int shift = (i % STAGES) * T::COPIES;
    valid &= ~(((1u << T::COPIES) - 1) << shift);
#pragma unroll
    for (int j = 0; j < T::COPIES; ++j) {
      const int r = r0 + j * R_STEP;
      const long long q = tap_pixel(pc + r, npix, H, W, (t - 1) * d, axis);
      if (q >= 0) valid |= 1u << (shift + j);
      cp_async16(sX + r * T::LD + v * 4, q >= 0 ? in + q * C + v * 4 : in,
                 q >= 0);
    }
    // dy rows pc .. pc + KP - 1, k = pixel, n = output channel, into core
    // matrices (zero past the last pixel)
#pragma unroll
    for (int j = 0; j < T::B_COPIES; ++j) {
      const int e = threadIdx.x + j * THREADS;
      int nn, k;
      core_nk<T::KP>(e, nn, k);
      const bool ok = pc + k < npix;
      cp_async4(sB + e, ok ? dy + (size_t)(pc + k) * C + nn : dy, ok);
    }
  };

  float acc[1][C / 2];
#pragma unroll
  for (int e = 0; e < C / 2; ++e) acc[0][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_chunk(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk i landed
    float* sX = stage(i);
    float* sBh = sX + T::X_FLOATS;
    float* sBl = sBh + T::B_FLOATS;
    if (pmul != nullptr) {
      const int shift = (i % STAGES) * T::COPIES;
#pragma unroll
      for (int j = 0; j < T::COPIES; ++j)
        if ((valid >> (shift + j)) & 1u)
          prologue4(reinterpret_cast<float4*>(
                        sX + (r0 + j * R_STEP) * T::LD + v * 4),
                    mul, add);
    }
    split_b<T::B_COPIES>(sBh, sBl);
    fence_proxy_async();
    __syncthreads();  // chunk i visible; chunk i - 1's stage free
    if (i + STAGES - 1 < n) load_chunk(i + STAGES - 1);
    cp_async_commit();

    // A[ci][p] = X[p][ci] (the staged rows read transposed)
    constexpr int SW = T::KS / T::KSPLIT;  // steps of this warpgroup
    uint32_t ahi[SW][1][4], alo[SW][1][4];
#pragma unroll
    for (int s = 0; s < SW; ++s) {
      const int k8 = (s * T::KSPLIT + s0) * 8;
      const float* a = sX + (k8 + tg) * T::LD + m0 + g;
      split_tf32(a[0], ahi[s][0][0], alo[s][0][0]);
      split_tf32(a[8], ahi[s][0][1], alo[s][0][1]);
      split_tf32(a[4 * T::LD], ahi[s][0][2], alo[s][0][2]);
      split_tf32(a[4 * T::LD + 8], ahi[s][0][3], alo[s][0][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < SW; ++s) {
      const int k8 = (s * T::KSPLIT + s0) * 8;
      wgmma3<C>(acc, ahi[s], alo[s], b_desc<T::KP>(sBh + k8 * 8),
                b_desc<T::KP>(sBl + k8 * 8));
    }
    wgmma_commit();
    wgmma_wait0();
    keep(acc[0]);
#pragma unroll
    for (int s = 0; s < SW; ++s) {
      keep(ahi[s][0]);
      keep(alo[s][0]);
    }
  }

  // acc[0][4j + 2h + e]: ci = m0 + g + 8h, co = 8j + 2tg + e. At C = 128
  // each (ci, co) is one thread's; at C = 64 warpgroup 0's sums (the even
  // steps) meet warpgroup 1's (the odd ones) in shared memory, in that
  // order. The row goes out in pairs of channels.
  float* row = part + ((size_t)blockIdx.x * 3 + t) * C * C;
  if (T::KSPLIT == 2) {
    cp_async_wait<0>();
    __syncthreads();     // the ring is free
    float* sK = smem32;  // C x LK
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sK[(m0 + g + 8 * (e / 2)) * T::LK + 8 * j + 2 * tg + e % 2] =
              acc[0][4 * j + e];
    }
    __syncthreads();
    if (wg == 0) return;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[0][4 * j + e] =
            sK[(m0 + g + 8 * (e / 2)) * T::LK + 8 * j + 2 * tg + e % 2] +
            acc[0][4 * j + e];
  }
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(row + (m0 + g + 8 * h) * C + 8 * j +
                                 2 * tg) =
          make_float2(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1]);
}

// The weight gradient at C = 16, on mma.sync. wgmma's smallest tile is 64
// rows, four times the 16 of dk, and this plane is bound by its bytes, not
// its products (12 FLOP per byte), so each warp keeps the whole 16 x 16 of
// dk[t] in two m16n8k8 tiles and the 8 warps take turns at the 8-pixel
// steps of a chunk of 128 pixels: X and dy rows arrive through the same
// kind of ring, both split into registers as their fragments are read.
template <>
struct WgradTile<16> {
  static constexpr int C = 16;
  static constexpr int KP = 128;                 // pixels a chunk
  static constexpr int SW = KP / 8 / 8;          // steps of a warp a chunk
  static constexpr int LD = C + 8;               // pitch, in floats
  static constexpr int VPR = C / 4;              // 16-byte copies a row
  static constexpr int COPIES = KP * VPR / THREADS;  // a thread, an operand
  static constexpr int STAGE = 2 * KP * LD;          // floats
  static constexpr int SMEM = STAGES * STAGE * 4;    // bytes
  static_assert(COPIES * THREADS == KP * VPR && COPIES * STAGES <= 32 &&
                    C * LD <= STAGES * STAGE,
                "a thread's copies and their validity bits; room for dk");
};

template <>
__global__ void __launch_bounds__(THREADS)
    wgrad3tap_f32_kernel<16>(const float* __restrict__ in,
                             const float* __restrict__ pmul,
                             const float* __restrict__ padd,
                             const float* __restrict__ dy,
                             float* __restrict__ part, int npix, int H,
                             int W, int d, int axis, int chunks_per_block) {
  using T = WgradTile<16>;
  constexpr int C = T::C;
  extern __shared__ __align__(128) float smem32[];
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int nchunks = (npix + T::KP - 1) / T::KP;
  const int chunk0 = blockIdx.x * chunks_per_block;
  const int n = min(nchunks, chunk0 + chunks_per_block) - chunk0;

  // this thread copies rows r0 + j * R_STEP of X and dy, channels v * 4 ..
  // v * 4 + 3; bit s * COPIES + j of `valid`: X row j of stage s lies on
  // the plane
  constexpr int R_STEP = THREADS / T::VPR;
  const int v = threadIdx.x % T::VPR, r0 = threadIdx.x / T::VPR;
  float4 mul = make_float4(0.0f, 0.0f, 0.0f, 0.0f), add = mul;
  if (pmul != nullptr) {
    mul = *reinterpret_cast<const float4*>(pmul + v * 4);
    add = *reinterpret_cast<const float4*>(padd + v * 4);
  }
  unsigned valid = 0;

  auto stage = [&](int i) { return smem32 + (i % STAGES) * T::STAGE; };
  auto load_chunk = [&](int i) {
    float* sX = stage(i);
    float* sD = sX + T::KP * T::LD;
    const int pc = (chunk0 + i) * T::KP;
    const int shift = (i % STAGES) * T::COPIES;
    valid &= ~(((1u << T::COPIES) - 1) << shift);
#pragma unroll
    for (int j = 0; j < T::COPIES; ++j) {
      const int r = r0 + j * R_STEP, p = pc + r;
      const long long q = tap_pixel(p, npix, H, W, (t - 1) * d, axis);
      if (q >= 0) valid |= 1u << (shift + j);
      cp_async16(sX + r * T::LD + v * 4, q >= 0 ? in + q * C + v * 4 : in,
                 q >= 0);
      cp_async16(sD + r * T::LD + v * 4,
                 p < npix ? dy + (size_t)p * C + v * 4 : dy, p < npix);
    }
  };

  float acc[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_chunk(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk i landed
    float* sX = stage(i);
    if (pmul != nullptr) {
      const int shift = (i % STAGES) * T::COPIES;
#pragma unroll
      for (int j = 0; j < T::COPIES; ++j)
        if ((valid >> (shift + j)) & 1u)
          prologue4(reinterpret_cast<float4*>(
                        sX + (r0 + j * R_STEP) * T::LD + v * 4),
                    mul, add);
    }
    __syncthreads();  // chunk i visible; chunk i - 1's stage free
    if (i + STAGES - 1 < n) load_chunk(i + STAGES - 1);
    cp_async_commit();

    // A[ci][p] = X[p][ci] (the staged rows read transposed), B = dy
    const float* sD = sX + T::KP * T::LD;
#pragma unroll
    for (int s = 0; s < T::SW; ++s) {
      const float* a = sX + ((s * 8 + warp) * 8 + tg) * T::LD + g;
      const float* b = sD + ((s * 8 + warp) * 8 + tg) * T::LD + g;
      uint32_t ahi[4], alo[4];
      split_tf32(a[0], ahi[0], alo[0]);
      split_tf32(a[8], ahi[1], alo[1]);
      split_tf32(a[4 * T::LD], ahi[2], alo[2]);
      split_tf32(a[4 * T::LD + 8], ahi[3], alo[3]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        uint32_t bhi[2], blo[2];
        split_tf32(b[ni * 8], bhi[0], blo[0]);
        split_tf32(b[4 * T::LD + ni * 8], bhi[1], blo[1]);
        mma_tf32(acc[ni], alo, bhi);  // smallest terms first
        mma_tf32(acc[ni], ahi, blo);
        mma_tf32(acc[ni], ahi, bhi);
      }
    }
  }

  // acc[ni][2h + e]: ci = g + 8h, co = ni * 8 + 2tg + e. The 8 warps' sums
  // meet in shared memory, a C x C tile a warp, and thread (ci, co) adds
  // them in warp order to the block's row of `part` (tap t at t C C)
  cp_async_wait<0>();
  __syncthreads();     // the ring is free
  float* sK = smem32 + warp * C * C;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sK[(g + 8 * (e / 2)) * C + ni * 8 + 2 * tg + e % 2] = acc[ni][e];
  __syncthreads();
  static_assert(C * C == THREADS && 8 * C * C <= STAGES * T::STAGE,
                "a thread an entry; room for the warps' tiles");
  float a = 0.0f;
  for (int k = 0; k < THREADS / 32; ++k) a += smem32[k * C * C + threadIdx.x];
  part[((size_t)blockIdx.x * 3 + t) * C * C + threadIdx.x] = a;
}

// ---- launches -------------------------------------------------------------

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the blocks of a convolution over npix pixels of (H, W) images: a
// warpgroup a tile at most, at most one wave, a constant of the shape
// (ops/nb_block.py::conv_rows counts the same, the rows of its sums'
// partials)
template <int C>
int conv_grid_f32(int npix, const ldconv::TileGeo<ConvTile<C>::BM>& geo,
                  int H, int W) {
  using T = ConvTile<C>;
  const int groups =
      (npix / (H * W) * geo.frb.d * geo.fcb.d + T::NWG - 1) / T::NWG;
  return groups < T::WAVE ? groups : T::WAVE;
}

// `sums` ((SUMS(EPI), C) f32) is written whole by the fold of `pp`, which
// takes the blocks' partials here, and the split tap matrices (6 C^2
// floats of its scratch that no fold reads)
template <int C, int EPI>
int launch_conv_f32(const float* in, const float* w, const float* pmul,
                    const float* padd, const float* vec, const float* aux,
                    float* out, float* sums, int npix, int H, int W, int d,
                    int axis, cudaStream_t stream, ldfold::Partials* pp) {
  using T = ConvTile<C>;
  auto kern = conv3tap_f32_kernel<C, EPI>;
  int rc = allow_smem(kern, T::SMEM);
  if (rc) return rc;
  if (npix == 0) return sums_of(EPI) > 0 ? (int)cudaErrorInvalidValue : 0;
  float* planes = pp ? pp->space(T::PLANES) : nullptr;
  if (planes == nullptr) return (int)cudaErrorInvalidValue;
  const ldconv::TileGeo<T::BM> geo(H, W, d, axis);
  const int grid = conv_grid_f32<C>(npix, geo, H, W);
  float* part = nullptr;
  if (sums_of(EPI) > 0) {
    part = pp->take(grid, sums_of(EPI) * C, sums);
    if (part == nullptr) return (int)cudaErrorInvalidValue;
  }
  wsplit_f32_kernel<C, T::KC>
      <<<grid_1d(3 * C * C, 256), 256, 0, stream>>>(w, planes);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, in, (const float*)planes, pmul,
                                 padd, vec, aux, out, part, npix, geo);
}

// What the card makes of the convolution tile at C with epilogue EPI, for
// a report (conv3tap.cuh's tile_info): info[0..3] registers a thread, local
// (spilled) bytes a thread, blocks resident on one SM, dynamic shared
// bytes a block; info[4] its blocks a launch over npix pixels of (H, W)
// images at d and axis.
template <int C, int EPI>
int conv_info_f32(int npix, int H, int W, int d, int axis, int* info) {
  using T = ConvTile<C>;
  const int rc = ldconv::tile_info(conv3tap_f32_kernel<C, EPI>, T::THREADS,
                                   T::SMEM, info);
  if (rc) return rc;
  info[4] = conv_grid_f32<C>(npix, ldconv::TileGeo<T::BM>(H, W, d, axis), H,
                             W);
  return 0;
}

// The same five ints of the bf16 convolution tile (conv3tap.cuh's
// conv_info and conv_grid), so that one report lists both dtypes alike.
template <int C, int EPI>
int conv_info_bf16(int npix, int H, int W, int d, int axis, int* info) {
  using T = ldconv::ConvTile<C>;
  const int rc = ldconv::conv_info<C, EPI, bf16>(info);
  if (rc) return rc;
  info[4] = ldconv::conv_grid<C>(
      npix, ldconv::TileGeo<T::BM>(H, W, d, axis), H, W);
  return 0;
}

// blocks a tap of the weight gradient: one wave of the H100's 132 SMs, a
// third a tap, at the tiles' 3, 2 and 1 blocks an SM
template <int C>
constexpr int wg_per_tap() {
  return C == 16 ? 132 : C == 64 ? 88 : 44;
}

// (blocks a tap, pixel chunks a block) of the weight gradient
template <int C>
void wgrad_split(int npix, int& blocks, int& cpb) {
  const int nchunks = grid_1d(npix, WgradTile<C>::KP);
  cpb = grid_1d(nchunks, wg_per_tap<C>());
  blocks = grid_1d(nchunks, cpb);
}

// dk ((3, C, C) f32) is written whole by the fold of `pp`, which takes the
// blocks' partials here
template <int C>
int launch_wgrad_f32(const float* in, const float* pmul, const float* padd,
                     const float* dy, float* dk, int npix, int H, int W,
                     int d, int axis, cudaStream_t stream,
                     ldfold::Partials* pp) {
  using T = WgradTile<C>;
  auto kern = wgrad3tap_f32_kernel<C>;
  int blocks, cpb;
  wgrad_split<C>(npix, blocks, cpb);
  float* part = pp ? pp->take(blocks, 3 * C * C, dk) : nullptr;
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  int rc = allow_smem(kern, T::SMEM);
  if (rc) return rc;
  kern<<<dim3(blocks, 3), THREADS, T::SMEM, stream>>>(
      in, pmul, padd, dy, part, npix, H, W, d, axis, cpb);
  return (int)cudaGetLastError();
}

}  // namespace ldconv32

namespace ldconv {

// conv3tap.cuh's launch_conv and wgrad3tap.cuh's launch_wgrad on float32
// planes, so that a caller templated on the plane type calls them alike:
// both dtypes sum through the partials of `pp`, folded by the caller's
// pp->fold.
template <int C, int EPI>
int launch_conv(const float* in, const float* w, const float* pmul,
                const float* padd, const float* vec, const float* aux,
                float* out, float* sums, int npix, int H, int W, int d,
                int axis, cudaStream_t stream, ldfold::Partials* pp) {
  return ldconv32::launch_conv_f32<C, EPI>(in, w, pmul, padd, vec, aux, out,
                                           sums, npix, H, W, d, axis, stream,
                                           pp);
}

template <int C>
int launch_wgrad(const float* in, const float* pmul, const float* padd,
                 const float* dy, float* dk, int npix, int H, int W, int d,
                 int axis, cudaStream_t stream, ldfold::Partials* pp) {
  return ldconv32::launch_wgrad_f32<C>(in, pmul, padd, dy, dk, npix, H, W, d,
                                       axis, stream, pp);
}

}  // namespace ldconv
