// The 3-tap implicit-GEMM convolution shared by the training kernels in
// bf16: the half blocks (nb_half_fwd.cu, nb_half_bwd.cu, K6 / K7) and the
// single convolutions of packed_conv.cu (K11). Replaces, in bf16, the
// convolutions of the TPU kernels `_half_a_fwd_kernel`,
// `_half_a_bwd_kernel`, `_half_b_fwd_kernel`, `_half_b_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_nb_block.py:198, :212, :321, :339)
// and of K11's (pallas_packed_conv.py:66, :149, :167).
//
//   out[p, co] = epilogue(sum_t sum_ci f(in[p + tap_t])[ci] * w[t, ci, co])
//
// with taps at -d, 0, +d along rows (axis 0) or columns (axis 1), f the
// BatchNorm-1 prologue z = bf16(relu(x * mul + add)) that the TPU kernel
// fuses ahead of half B (pallas_nb_block.py:326-328) when pmul != nullptr,
// and a choice of epilogue (below) and output type: bf16, or f32 (the
// unrounded sums of packed_conv's forward). A transposed convolution (the
// input gradient) is this same kernel with the tap matrices transposed and
// their order reversed, which the wrapper prepares: dx[q] = sum_t dy[q -
// (t-1)d] k[t]^T = sum_t' dy[q + (t'-1)d] k[2-t']^T.
//
// Bound. 6*C^2 FLOP per pixel against 4*C bytes (the plane read, the
// output written): 1.5*C FLOP per byte, under the H100's ~295 at every C,
// so the bytes bound it (about 5 us a launch at C = 16 and 64, 2.5 us at C
// = 128 on the train step's planes).
//
// Measured (H100 80GB HBM3, 700 W, `chip_smoke.py --profile`; PERF.md):
// 2.490 ms of card time a default bf16 train step in 136 launches (18 us
// each), against 0.52 ms for their bytes by the launch bounds above: 21%
// of the bound, where the design aimed at 40-50%. The products and the
// copies are not what bounds it: builds without the loads, the products,
// the index arithmetic or the stores each kept most of the time, and a
// clock64 breakdown of an instrumented copy put most of a launch in its
// start and in per-thread latency chains, with 8-16 warps an SM to hide
// them.
//
// Design, for Hopper:
//  - products on bf16 `wgmma` m64 x C x k16 with both operands in shared
//    memory: M = pixels, N = C output channels, K = 3 taps x C input
//    channels. A is the staged rows, K-major, in 16-byte column planes
//    (k_desc), so a tap's slice may start at any staged row; B is the tap
//    matrix (3, ci, co), read MN-major (co contiguous, as in device memory)
//    through wgmma's transposed-B form, so no transpose is written;
//  - persistent blocks (one an SM) stage the three tap matrices once;
//    their warpgroups each walk tiles of their own (BM pixels of one
//    image: 8 rows x BM / 8 columns for the row taps, BM columns of a row
//    for the column taps) in a fixed order through a ring of their own,
//    in step only with themselves, so that one's waits overlap another's
//    work;
//  - the ring, filled by 16-byte cp.async (zero fill off the plane),
//    carries K in chunks of KC input channels, so the next chunks' copies
//    are in flight while this one multiplies, across tiles too; it holds
//    as many chunks as the plan's rows allow;
//  - a chunk stages the pixels of all three taps once: the tile and d more
//    rows (axis 0, d <= 8) or columns (axis 1, d <= BM) on each side, the
//    three taps offset views of it, else three bands of BM pixels. Every
//    staged pixel lies in the tile's image (and row, for axis 1), so a tap
//    off the plane is a staged pixel off it: the copy zero-fills it and the
//    BatchNorm prologue of half B, applied in place by the thread that
//    copied the row, skips it (the padding is of z, not of x, and relu(0 *
//    mul + add) would not be zero), then a proxy fence hands the rows to
//    wgmma;
//  - the epilogues in registers from wgmma's accumulator layout, with the
//    rounding points of the plain version; per-channel sums kept per
//    thread across the block's tiles, folded by shuffles, then in warp
//    order in shared memory, then written to the block's row of a
//    partials buffer, which fold.cuh's fixed-order fold adds up after the
//    entry point's last launch: no atomics, so the sums reproduce
//    themselves bit for bit;
//  - a launch takes one wave of the H100 (132 SMs at one block an SM),
//    fewer blocks when the plane has fewer tiles: a constant of the
//    shape, never read from the card, so that the sums' partition (which
//    block takes which tile) is the same on every card; a card that holds
//    fewer blocks at once runs the launch in more waves.
// Each C in {16, 64, 128} has one fixed tile (ConvTile). Any d >= 1 (also
// d >= H or W, where the shifted taps read only zeros) and any pixel count;
// there is no other path, and a launch the card refuses returns its error.
//
// wgrad3tap.cuh holds the weight gradient; conv3tap_f32.cuh the float32
// tiles, which share the Epilogue codes, bn_affine and the launcher names.
#pragma once

#include <stdint.h>

#include "fold.cuh"
#include "tc_common.cuh"

namespace ldconv {

using ldtc::cp_async16;
using ldtc::cp_async_commit;
using ldtc::cp_async_wait;

enum Epilogue {
  EPI_BIAS_RELU,  // out = bf16(relu(acc + vec[c]))
  EPI_BIAS,       // out = bf16(acc + vec[c])
  EPI_BIAS_MOM,   // out = bf16(acc + vec[c]); sums += [out, out^2]
  EPI_PLAIN,      // out = bf16(acc)
  EPI_MASK_SUM,   // v = acc * (aux > 0); sums[0] += v; out = bf16(v)
  EPI_PRO_BWD,    // backward of the prologue, aux = x, vec = [mul; add]:
                  // v = acc * (x*mul+add > 0); sums += [v*x, v];
                  // out = bf16(v * mul)
};

// rows of sums an epilogue keeps: [sum] or [sum; second sum]
__host__ __device__ constexpr int sums_of(int EPI) {
  return EPI == EPI_MASK_SUM ? 1
         : EPI == EPI_BIAS_MOM || EPI == EPI_PRO_BWD ? 2
                                                      : 0;
}

// x * mul + add with the product rounded before the sum, never contracted
// into one fused multiply-add: the forward prologue, its recomputation in
// the weight gradient and the relu mask of its backward must agree bit for
// bit with each other (and with the plain version), or an activation at
// the edge of the relu is kept in one place and dropped in another.
__device__ __forceinline__ float bn_affine(float x, float mul, float add) {
  return __fadd_rn(__fmul_rn(x, mul), add);
}

// n / d and n % d for 0 <= n < 2^31 by a multiply-high, an add and a
// shift (Granlund and Montgomery's round-up method; d >= 1 set on the
// host): the tiles' index arithmetic, which a division by a value known
// only at run time would make a long chain of dependent instructions.
struct FastDiv {
  int d;
  uint32_t m, s;
  FastDiv() = default;
  explicit FastDiv(int divisor) : d(divisor), m(0), s(0) {
    while ((1u << s) < (uint32_t)d) ++s;
    m = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// ---- bf16 wgmma ----------------------------------------------------------

// Descriptor of the k16 slice that starts at `p` (element (k0, 0), k0 a
// multiple of 8) of the tap matrices in shared memory: an operand of N
// columns, MN-major without swizzle, in core matrices of 8 k rows x 8 n (16
// bytes a row, 128 bytes each); element (k, n) at index (k / 8) * 8N + (n
// / 8) * 64 + (k % 8) * 8 + n % 8. The next 8 k lie 16N bytes on (the
// leading offset), the next 8 n 128 bytes on (the stride offset).
template <int N>
__device__ __forceinline__ uint64_t mn_desc(const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)((16 * N) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// Descriptor of an MN-major operand slice laid out in 16-byte column
// planes (8 consecutive m or n of one k a row, k consecutive rows of a
// plane): `p` its first k row in its first plane; the next 8 k lie 128
// bytes on (the leading offset), the next plane `plane_bytes` on (the
// stride offset). Any 8 consecutive rows of a plane form a core matrix, so
// a slice may start at any k.
__device__ __forceinline__ uint64_t plane_desc(const bf16* p,
                                               uint32_t plane_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((plane_bytes >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void store2(bf16* o, float a, float b) {
  store_bf2(o, a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// Descriptor of an m64 x k16 slice of an A operand in shared memory,
// K-major without swizzle, laid out in 16-byte column planes: row r of
// plane k / 8 (input channels k .. k + 7 of one staged pixel) at byte 16r
// of the plane, so that any 8 consecutive rows form a core matrix and a
// slice may start at any row. `p`: the slice's first row in its first
// plane; the next 8 k lie `plane_bytes` on (the leading offset), the next
// 8 rows 128 bytes on (the stride offset).
__device__ __forceinline__ uint64_t k_desc(const bf16* p,
                                           uint32_t plane_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((plane_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (m64 x N, f32) += a (m64 x k16) @ b (k16 x N), both bf16 in shared
// memory through their descriptors: a K-major (TA = 0, k_desc) or MN-major
// (TA = 1, the transposed-A form, plane_desc), b MN-major (the
// transposed-B form); issued by the 4 warps of a warpgroup. Warp w holds
// rows 16w .. 16w + 15 of d; thread (g, tg) = (lane / 4, lane % 4) holds
// d[4j + 2h + e] = d[g + 8h][8j + 2tg + e].
template <int N, int TA>
struct WgmmaSS;

template <int TA>
struct WgmmaSS<16, TA> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TA)
        : "memory");
  }
};

template <int TA>
struct WgmmaSS<64, TA> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA)
        : "memory");
  }
};

template <int TA>
struct WgmmaSS<128, TA> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
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
        : "l"(a), "l"(b), "r"(1), "n"(TA)
        : "memory");
  }
};

// cp_async_wait<n> for a depth n in 1 .. 7 known at run time (uniform
// across the warpgroup)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// the 128 threads of warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ---- tile geometry --------------------------------------------------------

// The tiles of a launch and the pixels a chunk stages for them, shared by
// the convolution and the weight gradient. A tile: BM pixels of one image,
// TH rows x BM / TH columns for the row taps (axis 0), BM columns of one
// row for the column taps (axis 1), numbered by image, block of rows (frb.d
// an image), block of columns (fcb.d); tile pixel m is row m / tw, column
// m % tw of it. A chunk stages the tile's pixels and d more rows (axis 0,
// d <= TH) or columns (axis 1, d <= BM) on each side: one run, tap t the
// view of it from staged row base(t) on; for larger d, three bands of BM,
// the tile shifted by (t-1)d. Every staged pixel lies in the tile's image
// (and row, for axis 1), so a tap off the plane is a staged pixel off it:
// staged_pixel gives -1 and the copy zero-fills it, the BatchNorm prologue
// skips it (the padding is of z, not of x, and relu(0 * mul + add) would
// not be zero).
template <int BM>
struct TileGeo {
  static constexpr int TH = 8;
  static constexpr int LG_BM = BM == 128 ? 7 : 6;
  static_assert(BM == 1 << LG_BM, "BM 64 or 128");
  FastDiv fh, fw, frb, fcb;
  int d, axis;
  TileGeo(int H, int W, int d_, int axis_) : fh(H), fw(W), d(d_), axis(axis_) {
    const int th = axis == 0 ? TH : 1;
    frb = FastDiv((H + th - 1) / th);
    fcb = FastDiv((W + BM / th - 1) / (BM / th));
  }
  __device__ __forceinline__ int lgtw() const {
    return axis == 0 ? LG_BM - 3 : LG_BM;
  }
  __device__ __forceinline__ int ntiles(int npix) const {
    return fh.div(fw.div(npix)) * frb.d * fcb.d;
  }
  __device__ __forceinline__ bool run() const {
    return d <= (axis == 0 ? TH : BM);
  }
  // staged pixels of a chunk
  __device__ __forceinline__ int nload() const {
    return !run() ? 3 * BM : axis == 0 ? (TH + 2 * d) << lgtw() : BM + 2 * d;
  }
  // the staged row tap t's view starts at
  __device__ __forceinline__ int base(int t) const {
    return run() ? t * d * (axis == 0 ? 1 << lgtw() : 1) : t * BM;
  }
  // tile `tile`: its first image row R0 (h0 in its image), first column c0
  __device__ __forceinline__ void at(int tile, int& R0, int& h0,
                                     int& c0) const {
    const int q = fcb.div(tile), b = frb.div(q);
    c0 = (tile - q * fcb.d) << lgtw();
    h0 = (q - b * frb.d) * (axis == 0 ? TH : 1);
    R0 = b * fh.d + h0;
  }
  // the pixel at row r, column col of tile (R0, h0, c0) (either may lie
  // outside it), or -1 off the plane or the tile's image
  __device__ __forceinline__ int tile_pixel(int R0, int h0, int c0, int r,
                                            int col) const {
    col += c0;
    return col >= 0 && col < fw.d && h0 + r >= 0 && h0 + r < fh.d
               ? (R0 + r) * fw.d + col
               : -1;
  }
  // tile pixel m shifted by tap t (band t), or -1 off the plane
  __device__ __forceinline__ int band_pixel(int R0, int h0, int c0, int t,
                                            int m) const {
    const int off = (t - 1) * d;
    return tile_pixel(R0, h0, c0, (m >> lgtw()) + (axis == 0 ? off : 0),
                      (m & ((1 << lgtw()) - 1)) + (axis == 1 ? off : 0));
  }
  // the pixel staged at row j of a chunk of tile (R0, h0, c0), or -1 off
  // the plane. Run: axis 0, row j / tw - d of the tile, column j % tw; axis
  // 1, column j - d of the tile's row. Bands: band j / BM, tile pixel j % BM
  __device__ __forceinline__ int staged_pixel(int R0, int h0, int c0,
                                              int j) const {
    if (!run()) return band_pixel(R0, h0, c0, j / BM, j % BM);
    if (axis == 1) return tile_pixel(R0, h0, c0, 0, j - d);
    return tile_pixel(R0, h0, c0, (j >> lgtw()) - d, j & ((1 << lgtw()) - 1));
  }
  // element 0 of tile pixel m in a plane of C channels, or -1 off the
  // plane
  __device__ __forceinline__ long long pixel(int R0, int h0, int c0, int m,
                                             int C) const {
    const int q = band_pixel(R0, h0, c0, 1, m);
    return q >= 0 ? (long long)q * C : -1;
  }
};

// ---- the convolution ------------------------------------------------------

// A block: the three tap matrices (3*C*C bf16, staged once) and NWG
// warpgroups, each with a ring of its own that walks tiles of its own, in
// step with nothing but itself (a named barrier), so that one warpgroup's
// waits overlap the other's work. A tile: BM pixels of one image x all C
// output channels, MT m64 tiles: TH rows of BM / TH columns for the row
// taps (axis 0), a segment of BM columns of one row for the column taps
// (axis 1); tiles at the plane's edges may be partial. K in chunks of KC
// input channels of all three taps. A stage holds a chunk's staged pixels
// (its rows, for wgmma) in KC / 8 column planes: one run of the tile and d
// more rows (axis 0, d <= TH) or columns (axis 1, d <= BM) on each side,
// the three taps offset views of it, so that each input pixel is staged
// about once; else three bands of BM (tap t: the tile shifted by (t-1)d).
// Since every staged pixel lies in the tile's image, and in its image row
// for axis 1, a tap off the plane is a staged pixel off it, which the copy
// zero-fills and the prologue skips: no other mask. The ring holds
// RING_STAGES stages of the
// most rows; a launch cuts it into as many stages of its plan's rows as
// fit, at most MAX_STAGES. A bf16 tile's outputs (and the aux plane the
// masking epilogues read) pass through a staging tile of the warpgroup,
// so that device memory sees 16-byte accesses of whole runs of the tile's
// pixels.
// One block an SM: C = 128 two warpgroups, 208,896 bytes; C = 64 four,
// 209,408; C = 16 four, 173,184. A launch: at most WAVE blocks.
template <int C>
struct ConvTile {
  static constexpr int WAVE = 132;              // the H100's SMs
  static constexpr int NWG = C == 128 ? 2 : 4;  // warpgroups a block
  static constexpr int THREADS = NWG * 128;
  static constexpr int MT = C == 16 ? 2 : 1;    // m64 tiles a tile
  static constexpr int BM = 64 * MT;            // pixels a tile
  static constexpr int KC = C == 16 ? 16 : 32;  // input channels a chunk
  static constexpr int KS = KC / 16;            // k16 steps a tap and chunk
  static constexpr int CPT = C / KC;            // chunks a tile
  static constexpr int PLANES = KC / 8;         // 16-byte column planes
  static constexpr int ROWS = 3 * BM;           // staged rows a chunk, at most
  static constexpr int W_ELEMS = 3 * C * C;
  static constexpr int RING_STAGES = 3;
  static constexpr int RING = RING_STAGES * ROWS * KC;  // bf16, a warpgroup's
  static constexpr int MAX_STAGES = 8;
  static constexpr int LDO = C + 8;         // pitch of the staged output
  static constexpr int OUT = BM * LDO;      // bf16, a warpgroup's
  static constexpr int SMEM = (W_ELEMS + NWG * (RING + OUT)) * 2 + 2 * C * 4;
  static_assert(W_ELEMS % 64 == 0 && RING % 64 == 0 && OUT % 8 == 0,
                "regions on 16-byte boundaries at least");
  static_assert(RING_STAGES >= 3 && THREADS / 32 * 2 * C * 4 <= SMEM,
                "a ring of three stages at least; room for the sums");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// Arguments as the kernel below; `part` is the partials of the sums
// epilogues, sums_of(EPI) x C floats a block (row blockIdx.x: the block's
// sums over its tiles), null for the others.
template <int C, int EPI, typename TO>
__global__ void __launch_bounds__(ConvTile<C>::THREADS, 1)
    conv3tap_kernel(const bf16* __restrict__ in, const bf16* __restrict__ w,
                    const float* __restrict__ pmul,
                    const float* __restrict__ padd,
                    const float* __restrict__ vec,
                    const bf16* __restrict__ aux, TO* __restrict__ out,
                    float* __restrict__ part, int npix,
                    TileGeo<ConvTile<C>::BM> geo) {
  using T = ConvTile<C>;
  constexpr bool kVec = EPI != EPI_PLAIN && EPI != EPI_MASK_SUM;
  constexpr int NVEC = EPI == EPI_PRO_BWD ? 2 * C : C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  bf16* sRing = sW + T::W_ELEMS + wg * T::RING;
  bf16* sOut = sW + T::W_ELEMS + T::NWG * T::RING + wg * T::OUT;
  float* sVec = reinterpret_cast<float*>(
      smem + (T::W_ELEMS + T::NWG * (T::RING + T::OUT)) * 2);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = (warp % 4) * 16;  // this warp's rows of each m64 tile

  // warpgroup gw of the grid takes tiles gw, gw + slots, ...
  const int ntiles = geo.ntiles(npix);
  const int slots = (int)gridDim.x * T::NWG;
  const int gw = (int)blockIdx.x * T::NWG + wg;
  const int n = (gw < ntiles ? (ntiles - 1 - gw) / slots + 1 : 0) * T::CPT;
  // the ring in stages of nload rows: nst of them, nst - 1 chunks ahead
  const int nload = geo.nload();
  const int plane = nload * 8;  // bf16 from one column plane to the next
  const int stage_elems = nload * T::KC;
  const int nst = min(T::MAX_STAGES, T::RING / stage_elems);

  auto stage = [&](int i) { return sRing + (i % nst) * stage_elems; };
  auto tile_at = [&](int i, int& R0, int& h0, int& c0) {
    geo.at(gw + i / T::CPT * slots, R0, h0, c0);
  };
  auto load_chunk = [&](int i) {
    bf16* sA = stage(i);
    int R0, h0, c0;
    tile_at(i, R0, h0, c0);
    const int ch = (i % T::CPT) * T::KC;
    for (int e = tid; e < nload * T::PLANES; e += 128) {
      const int j = e / T::PLANES, v = e % T::PLANES;
      const int q = geo.staged_pixel(R0, h0, c0, j);
      cp_async16(sA + v * plane + j * 8,
                 q >= 0 ? in + (size_t)q * C + ch + v * 8 : in, q >= 0);
    }
  };

  if (kVec)
    for (int i = threadIdx.x; i < NVEC; i += T::THREADS) sVec[i] = vec[i];
  // the three tap matrices, one group: copy e fills bytes 16e .. 16e + 15
  // of their MN-major layout; then this warpgroup's first chunks, a group
  // each
  for (int e = threadIdx.x; e < T::W_ELEMS / 8; e += T::THREADS) {
    const int r = e % 8, nb = e / 8 % (C / 8), kb = e / 8 / (C / 8) % (C / 8);
    const int t = e / (C * C / 8);
    cp_async16(sW + e * 8, w + ((size_t)t * C + kb * 8 + r) * C + nb * 8,
               true);
  }
  cp_async_commit();
  for (int i = 0; i < nst - 1; ++i) {
    if (i < n) load_chunk(i);
    cp_async_commit();
  }
  cp_async_wait_upto(nst - 1);  // the tap matrices landed: the oldest group
  ldtc::fence_proxy_async();
  __syncthreads();  // the tap matrices and sVec visible to every warpgroup

  float acc[T::MT][C / 2];
  float s0[C / 8][2], s1[C / 8][2];  // this thread's channel sums
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
    s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait_upto(nst - 2);  // this thread's copies of chunk i landed
    bf16* sA = stage(i);
    const int cc = i % T::CPT;
    int R0, h0, c0;
    tile_at(i, R0, h0, c0);
    if (pmul != nullptr) {
      // the prologue on the rows this thread copied that lie on the plane
      for (int e = tid; e < nload * T::PLANES; e += 128) {
        const int j = e / T::PLANES, v = e % T::PLANES;
        if (geo.staged_pixel(R0, h0, c0, j) < 0) continue;
        const int c = cc * T::KC + v * 8;
        uint4* p = reinterpret_cast<uint4*>(sA + v * plane + j * 8);
        uint4 val = *p;
        bf16* x = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          x[k] = f2bf(fmaxf(bn_affine(bf2f(x[k]), pmul[c + k], padd[c + k]),
                            0.0f));
        *p = val;
      }
    }
    // this thread's copies (and prologue) reach wgmma's proxy
    ldtc::fence_proxy_async();
    // every thread's copies of chunk i are visible to the warpgroup, and
    // its wgmma of chunk i - 1 is done, whose stage is refilled next
    warpgroup_sync(wg);
    if (i + nst - 1 < n) load_chunk(i + nst - 1);
    cp_async_commit();  // possibly empty: one group per iteration

    if (cc == 0) {
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int e = 0; e < C / 2; ++e) acc[mt][e] = 0.0f;
    }
    ldtc::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int base = geo.base(t);
#pragma unroll
      for (int ks = 0; ks < T::KS; ++ks)
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
          WgmmaSS<C, 0>::mma(
              acc[mt],
              k_desc(sA + 2 * ks * plane + (base + mt * 64) * 8, plane * 2),
              mn_desc<C>(sW + t * C * C + (cc * T::KC + ks * 16) * C));
    }
    ldtc::wgmma_commit();
    ldtc::wgmma_wait0();
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) ldtc::keep(acc[mt]);
    if (cc != T::CPT - 1) continue;

    // the tile's epilogue. acc[mt][4j + 2h + e]: tile pixel m = mt*64 +
    // m0 + g + 8h (row m / tw, column m % tw of the tile), channel 8j + 2tg
    // + e. A bf16 output (and the aux plane) crosses the staging tile, row
    // m of it (pitch LDO) pixel m, so that device memory sees whole runs of
    // tw pixels; an f32 output (packed_conv's forward, on no path) is stored
    // directly: its staging tile would not fit beside the ring at C = 128
    constexpr bool kStage = sizeof(TO) == 2;
    constexpr bool kAux = EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD;
    constexpr int V = C / 8;  // 16-byte vectors a pixel
    auto pixel_at = [&](int m) { return geo.pixel(R0, h0, c0, m, C); };
    if (kStage && kAux) {
      for (int e = tid; e < T::BM * V; e += 128) {
        const long long at = pixel_at(e / V);
        if (at >= 0)
          *reinterpret_cast<uint4*>(sOut + e / V * T::LDO + e % V * 8) =
              *reinterpret_cast<const uint4*>(aux + at + e % V * 8);
      }
      warpgroup_sync(wg);
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 64 + m0 + g + 8 * hh;
        const long long at = pixel_at(m);
        if (at < 0) continue;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int c0c = 8 * j + 2 * tg;
          const size_t idx = (size_t)at + c0c;
          bf16* so = sOut + m * T::LDO + c0c;
          float xv[2] = {0.0f, 0.0f};
          if (kAux) {
            const float2 x2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(kStage ? so
                                                                : aux + idx));
            xv[0] = x2.x;
            xv[1] = x2.y;
          }
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0c + e;
            const float v = acc[mt][4 * j + 2 * hh + e];
            if (EPI == EPI_BIAS_RELU) {
              o[e] = fmaxf(v + sVec[c], 0.0f);
            } else if (EPI == EPI_BIAS) {
              o[e] = v + sVec[c];
            } else if (EPI == EPI_BIAS_MOM) {
              o[e] = bf2f(f2bf(v + sVec[c]));  // moments of the rounded value
              s0[j][e] += o[e];
              s1[j][e] += o[e] * o[e];
            } else if (EPI == EPI_PLAIN) {
              o[e] = v;
            } else if (EPI == EPI_MASK_SUM) {
              o[e] = xv[e] > 0.0f ? v : 0.0f;
              s0[j][e] += o[e];  // bias gradient from the f32 value
            } else {  // EPI_PRO_BWD: aux = x, vec = [mul; add]
              const float m =
                  bn_affine(xv[e], sVec[c], sVec[C + c]) > 0.0f ? v : 0.0f;
              s0[j][e] += m * xv[e];
              s1[j][e] += m;
              o[e] = m * sVec[c];
            }
          }
          if (kStage)
            store2(so, o[0], o[1]);
          else
            store2(out + idx, o[0], o[1]);
        }
      }
    if (kStage) {
      warpgroup_sync(wg);
      for (int e = tid; e < T::BM * V; e += 128) {
        const long long at = pixel_at(e / V);
        if (at >= 0)
          *reinterpret_cast<uint4*>(out + at + e % V * 8) =
              *reinterpret_cast<const uint4*>(sOut + e / V * T::LDO +
                                              e % V * 8);
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
    __syncthreads();  // the rings and the tap matrices are free
    float* sRed = reinterpret_cast<float*>(smem);  // a row of 2C a warp
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

// ---- launches ---------------------------------------------------------

// Allow `kern` `smem` bytes of dynamic shared memory.
template <typename K>
static inline int tile_smem(K kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// What the card makes of a tile kernel, for a report: info[0..3] =
// registers a thread, local (spilled) bytes a thread, blocks resident on
// one SM, dynamic shared memory bytes a block.
template <typename K>
static inline int tile_info(K kern, int threads, int smem, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = per_sm;
  info[3] = smem;
  return 0;
}

template <int C, int EPI, typename TO>
int conv_info(int* info) {
  return tile_info(conv3tap_kernel<C, EPI, TO>, ConvTile<C>::THREADS,
                   ConvTile<C>::SMEM, info);
}

// the blocks of a convolution over npix pixels of (H, W) images: a
// warpgroup a tile at most, at most one wave (ops/nb_block.py counts the
// same, the rows of its sums' partials)
template <int C>
int conv_grid(int npix, const TileGeo<ConvTile<C>::BM>& geo, int H, int W) {
  using T = ConvTile<C>;
  const int groups =
      (npix / (H * W) * geo.frb.d * geo.fcb.d + T::NWG - 1) / T::NWG;
  return groups < T::WAVE ? groups : T::WAVE;
}

// `sums` ((sums_of(EPI), C) f32) is written whole by the fold of `pp`,
// which takes the blocks' partials here; pp may be null for an epilogue
// without sums
template <int C, int EPI, typename TO>
int launch_conv(const bf16* in, const bf16* w, const float* pmul,
                const float* padd, const float* vec, const bf16* aux,
                TO* out, float* sums, int npix, int H, int W, int d,
                int axis, cudaStream_t stream, ldfold::Partials* pp) {
  using T = ConvTile<C>;
  auto kern = conv3tap_kernel<C, EPI, TO>;
  const int rc = tile_smem(kern, T::SMEM);
  if (rc) return rc;
  if (npix == 0) return sums_of(EPI) > 0 ? (int)cudaErrorInvalidValue : 0;
  const TileGeo<T::BM> geo(H, W, d, axis);
  const int grid = conv_grid<C>(npix, geo, H, W);
  float* part = nullptr;
  if (sums_of(EPI) > 0) {
    part = pp ? pp->take(grid, sums_of(EPI) * C, sums) : nullptr;
    if (part == nullptr) return (int)cudaErrorInvalidValue;
  }
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(in, w, pmul, padd, vec, aux,
                                              out, part, npix, geo);
  return (int)cudaGetLastError();
}

}  // namespace ldconv
