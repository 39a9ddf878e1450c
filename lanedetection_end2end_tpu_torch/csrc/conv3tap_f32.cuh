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
// PyTorch version in full f32. So every f32 operand a is split in the SM,
// never in device memory: hi = tf32(a), lo = tf32(a - hi) (cvt.rna both),
// and each product is taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b,
// three TF32 products into the one f32 accumulator, smallest terms first.
// What is lost (lo_a * lo_b, about 2^-22 of the product) is below f32
// rounding. ops/tf32x3.py states the same arithmetic in PyTorch, and the
// CPU tests hold it there.
//
// Bound. A convolution is 6*C^2 f32 FLOP per pixel against 8*C bytes (the
// plane read, the output written); as three TF32 products it runs at most
// at 495 / 3 = 165 TFLOP/s, whose ridge is about 49 FLOP per byte of the
// H100's 3.35 TB/s. The operations bound C = 128 (96 FLOP per byte), C = 64
// sits at the ridge (48) and the bytes bound C = 16 (12). The weight
// gradient does the same work per pixel. Legacy `mma.sync` TF32 runs well
// below the rate `wgmma` reaches on this card, so the products are
// `wgmma` instructions (m64 x C x 8, A from registers, B from shared
// memory), issued by warpgroups of 4 warps. The split costs two cvt and a
// subtraction per operand value; the tiles split B once per block and
// chunk in shared memory. Measured on the H100, the products are not what
// bounds these tiles: builds without them keep most of the time, spent in
// the copies of A and B, the splits and the epilogue, which overlap little
// (PERF.md).
//
// Both kernels walk K in chunks through a ring of STAGES shared-memory
// stages filled by cp.async (16-byte copies of the A rows, src-size 0, a
// zero fill, for rows whose tap falls off the plane; 4-byte copies of B,
// scattered into wgmma's K-major core-matrix layout), so the copies of the
// next chunks are in flight while this one is multiplied. Once a chunk
// lands, each thread works on what it copied itself: it applies the
// BatchNorm-1 prologue relu(x * mul + add) of half B in place to its A rows
// whose tap lies on the plane (a validity bit per row and tap: the padding
// stays zero, it is padding of z, not of x), and splits its B values into
// a hi and a lo copy. One barrier per chunk publishes both. A is split
// into registers as its fragments are read.
//
// conv3tap_f32_kernel: an implicit GEMM, M = pixels, N = C output channels,
// K = 3 taps x C input channels. A block of two warpgroups computes 128
// pixels (C = 128) or 256 (C = 64, 16) x all C channels, K in chunks of 32
// (C = 128) or 16 input channels of one tap. The epilogues are
// conv3tap.cuh's without its bf16 roundings; each thread holds two adjacent
// channels of two pixel rows per 8 channels, and the per-channel sums fold
// over the warp with shuffles, over the block in shared memory, and reach
// the global buffer with one atomicAdd per block and channel.
//
// wgrad3tap_f32_kernel (C = 64, 128): dk[t] += shift_t(f(in))^T @ dy,
// M = C input channels, N = C output channels, K = the block's pixels in
// chunks of 32, split over blocks (blockIdx.y is the tap, f the prologue
// when given). The staged input rows are read as the transposed A operand,
// so no transpose is written; dy is B. Its C = 16 specialization does the
// same on mma.sync: wgmma's 64 rows would be a quarter used, and the
// 16-channel plane is bound by its bytes; this tile with its rows 16 .. 63
// zero took more than twice the mma.sync one's time on the H100
// (PERF.md). The block's C x C sums meet in
// shared memory and add to dk row by row with f32 atomicAdd (the last bits
// depend on the order blocks finish in; dk must be zero before the
// launch).
//
// Each C in {16, 64, 128} has one fixed tile per kernel, which takes any
// d >= 1 (also d >= H or W, where the shifted taps read only zeros) and
// any pixel count: there is no other path, and a launch the card refuses
// returns its error.
#pragma once

#include <stdint.h>

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
// memory through its descriptor), issued by the 4 warps of a warpgroup.
// Warp w holds rows 16w .. 16w + 15 of a and d; thread (g, tg) = (lane / 4,
// lane % 4) holds a[g][tg], a[g+8][tg], a[g][tg+4], a[g+8][tg+4] and
// d[4j + 2h + e] = d[g + 8h][8j + 2tg + e].
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};

// acc (MT m64 tiles x N) += the 8-deep step's products of the split
// operands: lo_a hi_b + hi_a lo_b + hi_a hi_b, smallest terms first.
template <int N, int MT>
__device__ __forceinline__ void wgmma3(float (&acc)[MT][N / 2],
                                       const uint32_t (&ahi)[MT][4],
                                       const uint32_t (&alo)[MT][4],
                                       uint64_t bhi, uint64_t blo) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    Wgmma<N>::mma(acc[mt], alo[mt], bhi);
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

// A block's tile: BM pixels x all C output channels, two warpgroups, each
// MT m64 tiles of pixels x C channels; K (3 taps x C input channels) in
// chunks of KC input channels. C = 128: 128 pixels (16,384 pixels of the
// 128-channel plane give 128 blocks, one wave of the 132 SMs). C = 64 and
// 16: 256 pixels, two blocks an SM.
template <int C>
struct ConvTile {
  static constexpr int MT = C == 128 ? 1 : 2;    // m64 tiles a warpgroup
  static constexpr int BM = 2 * MT * 64;         // pixels per block
  static constexpr int KC = C == 128 ? 32 : 16;  // input channels a chunk
  static constexpr int KS = KC / 8;              // 8-deep steps a chunk
  static constexpr int CPT = C / KC;             // chunks per tap
  static constexpr int NCHUNK = 3 * CPT;
  static constexpr int LDA = KC + 4;  // pitch of the A rows, in floats
  static constexpr int VPR = KC / 4;  // 16-byte copies an A row
  static constexpr int A_COPIES = BM * VPR / THREADS;
  static constexpr int B_COPIES = KC * C / THREADS;  // 4-byte copies
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int B_FLOATS = KC * C;  // each of B hi and B lo
  static constexpr int STAGE = A_FLOATS + 2 * B_FLOATS;  // floats
  static constexpr int SMEM = STAGES * STAGE * 4;        // bytes
  static_assert(A_FLOATS % 32 == 0 && STAGE % 32 == 0,
                "core matrices on 128-byte boundaries");
  static_assert(THREADS % VPR == 0 && A_COPIES * THREADS == BM * VPR &&
                    B_COPIES * THREADS == KC * C && 3 * A_COPIES <= 32,
                "a thread's copies and their validity bits");
  static_assert(THREADS / 32 * 2 * C <= STAGES * STAGE, "room for the sums");
};

// out[p, co] = epilogue(sum_t sum_ci f(in[p + tap_t])[ci] * w[t, ci, co]),
// taps at -d, 0, +d along rows (axis 0) or columns (axis 1); f is the
// prologue when pmul != nullptr. Arguments and epilogues as
// conv3tap.cuh's conv3tap_kernel, in f32 throughout: nothing is rounded
// to bf16. `sums` is (2, C) (one row used by EPI_MASK_SUM), zero before
// the launch.
template <int C, int EPI>
__global__ void __launch_bounds__(THREADS, C == 128 ? 1 : 2)
    conv3tap_f32_kernel(const float* __restrict__ in,
                        const float* __restrict__ w,
                        const float* __restrict__ pmul,
                        const float* __restrict__ padd,
                        const float* __restrict__ vec,
                        const float* __restrict__ aux,
                        float* __restrict__ out, float* __restrict__ sums,
                        int npix, int H, int W, int d, int axis) {
  using T = ConvTile<C>;
  extern __shared__ __align__(128) float smem32[];
  const int p0 = blockIdx.x * T::BM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  // this warp's 16 rows of each of its warpgroup's m64 tiles start at
  // m0 + mt * 64
  const int m0 = (warp / 4) * T::MT * 64 + (warp % 4) * 16;

  // this thread copies A rows r0 + j * R_STEP, 4 channels at v * 4 of each
  // chunk; bit 3j + t: row j's tap t lies on the plane
  constexpr int R_STEP = THREADS / T::VPR;
  const int v = threadIdx.x % T::VPR, r0 = threadIdx.x / T::VPR;
  const long long step = axis == 0 ? (long long)W * d : d;  // tap to tap
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < T::A_COPIES; ++j)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (tap_pixel(p0 + r0 + j * R_STEP, npix, H, W, (t - 1) * d, axis) >=
          0)
        valid |= 1u << (3 * j + t);

  auto stage = [&](int i) { return smem32 + (i % STAGES) * T::STAGE; };
  auto load_chunk = [&](int i) {
    float* sA = stage(i);
    float* sB = sA + T::A_FLOATS;
    const int t = i / T::CPT, c0 = (i % T::CPT) * T::KC;
#pragma unroll
    for (int j = 0; j < T::A_COPIES; ++j) {
      const int r = r0 + j * R_STEP;
      const bool ok = (valid >> (3 * j + t)) & 1u;
      const float* src =
          ok ? in + ((p0 + r) + (t - 1) * step) * C + c0 + v * 4 : in;
      cp_async16(sA + r * T::LDA + v * 4, src, ok);
    }
    // the chunk's KC x C slice of tap t, k = input channel, n = output
    // channel, into core matrices
    const float* wt = w + ((size_t)t * C + c0) * C;
#pragma unroll
    for (int j = 0; j < T::B_COPIES; ++j) {
      const int e = threadIdx.x + j * THREADS;
      int n, k;
      core_nk<T::KC>(e, n, k);
      cp_async4(sB + e, wt + k * C + n, true);
    }
  };

  float acc[T::MT][C / 2];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int e = 0; e < C / 2; ++e) acc[mt][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < T::NCHUNK) load_chunk(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < T::NCHUNK; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk i landed
    float* sA = stage(i);
    float* sBh = sA + T::A_FLOATS;
    float* sBl = sBh + T::B_FLOATS;
    if (pmul != nullptr) {
      // the prologue on the rows this thread copied, valid ones only
      const int t = i / T::CPT, c = (i % T::CPT) * T::KC + v * 4;
      const float4 mul = *reinterpret_cast<const float4*>(pmul + c);
      const float4 add = *reinterpret_cast<const float4*>(padd + c);
#pragma unroll
      for (int j = 0; j < T::A_COPIES; ++j)
        if ((valid >> (3 * j + t)) & 1u)
          prologue4(reinterpret_cast<float4*>(
                        sA + (r0 + j * R_STEP) * T::LDA + v * 4),
                    mul, add);
    }
    split_b<T::B_COPIES>(sBh, sBl);
    fence_proxy_async();
    // every thread's copies, prologue and splits of chunk i are visible,
    // and every warpgroup is done with chunk i - 1, whose stage is refilled
    // next
    __syncthreads();
    if (i + STAGES - 1 < T::NCHUNK) load_chunk(i + STAGES - 1);
    cp_async_commit();  // possibly empty: one group per iteration

    uint32_t ahi[T::KS][T::MT][4], alo[T::KS][T::MT][4];
#pragma unroll
    for (int s = 0; s < T::KS; ++s)
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const float* a = sA + (m0 + mt * 64 + g) * T::LDA + s * 8 + tg;
        split_tf32(a[0], ahi[s][mt][0], alo[s][mt][0]);
        split_tf32(a[8 * T::LDA], ahi[s][mt][1], alo[s][mt][1]);
        split_tf32(a[4], ahi[s][mt][2], alo[s][mt][2]);
        split_tf32(a[8 * T::LDA + 4], ahi[s][mt][3], alo[s][mt][3]);
      }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < T::KS; ++s)
      wgmma3<C>(acc, ahi[s], alo[s], b_desc<T::KC>(sBh + s * 64),
                b_desc<T::KC>(sBl + s * 64));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) keep(acc[mt]);
#pragma unroll
    for (int s = 0; s < T::KS; ++s)
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        keep(ahi[s][mt]);
        keep(alo[s][mt]);
      }
  }

  // acc[mt][4j + 2h + e]: pixel p0 + m0 + mt*64 + g + 8h, channel
  // 8j + 2tg + e
  float s0[C / 8][2], s1[C / 8][2];
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
    s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + m0 + mt * 64 + g + 8 * h;
      if (p >= npix) continue;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int c0 = 8 * j + 2 * tg;
        const size_t base = (size_t)p * C + c0;
        float2 xa = make_float2(0.0f, 0.0f);
        if (EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD)
          xa = *reinterpret_cast<const float2*>(aux + base);
        const float xv[2] = {xa.x, xa.y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + e;
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
  if (EPI == EPI_BIAS_MOM || EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD) {
    // lanes with equal tg hold the same channels: fold them onto lanes
    // 0..3 (tg = lane there), then sum the 8 warps' rows in shared memory
    float red[C / 2];
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[2 * j + e] = s0[j][e];
        red[C / 4 + 2 * j + e] = s1[j][e];
      }
    cp_async_wait<0>();
    __syncthreads();       // the ring is free
    float* sRed = smem32;  // 8 x 2C
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
      for (int k = 0; k < THREADS / 32; ++k) {
        a0 += sRed[k * 2 * C + threadIdx.x];
        a1 += sRed[k * 2 * C + C + threadIdx.x];
      }
      atomicAdd(sums + threadIdx.x, a0);
      if (EPI != EPI_MASK_SUM) atomicAdd(sums + C + threadIdx.x, a1);
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

// dk[t] += sum over this block's pixel chunks of shift_t(f(in))^T @ dy;
// blockIdx.y is the tap t, f the prologue when pmul != nullptr.
template <int C>
__global__ void __launch_bounds__(THREADS, C == 128 ? 1 : 2)
    wgrad3tap_f32_kernel(const float* __restrict__ in,
                         const float* __restrict__ pmul,
                         const float* __restrict__ padd,
                         const float* __restrict__ dy,
                         float* __restrict__ dk, int npix, int H, int W,
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

  // acc[0][4j + 2h + e]: ci = m0 + g + 8h, co = 8j + 2tg + e. The
  // warpgroups' sums meet in shared memory, which then adds to dk row by
  // row (coalesced atomics)
  cp_async_wait<0>();
  __syncthreads();     // the ring is free
  float* sK = smem32;  // C x LK
  for (int i = threadIdx.x; i < C * C; i += THREADS)
    sK[i / C * T::LK + i % C] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      atomicAdd(sK + (m0 + g + 8 * (e / 2)) * T::LK + 8 * j + 2 * tg + e % 2,
                acc[0][4 * j + e]);
  __syncthreads();
  float* dkt = dk + (size_t)t * C * C;
  for (int i = threadIdx.x; i < C * C; i += THREADS)
    atomicAdd(dkt + i, sK[i / C * T::LK + i % C]);
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
                             float* __restrict__ dk, int npix, int H, int W,
                             int d, int axis, int chunks_per_block) {
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
  // meet in shared memory, which then adds to dk (coalesced atomics)
  cp_async_wait<0>();
  __syncthreads();     // the ring is free
  float* sK = smem32;  // C x LD
  for (int i = threadIdx.x; i < C * C; i += THREADS)
    sK[i / C * T::LD + i % C] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      atomicAdd(sK + (g + 8 * (e / 2)) * T::LD + ni * 8 + 2 * tg + e % 2,
                acc[ni][e]);
  __syncthreads();
  float* dkt = dk + (size_t)t * C * C;
  for (int i = threadIdx.x; i < C * C; i += THREADS)
    atomicAdd(dkt + i, sK[i / C * T::LD + i % C]);
}

// ---- launches -------------------------------------------------------------

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C, int EPI>
int launch_conv_f32(const float* in, const float* w, const float* pmul,
                    const float* padd, const float* vec, const float* aux,
                    float* out, float* sums, int npix, int H, int W, int d,
                    int axis, cudaStream_t stream) {
  using T = ConvTile<C>;
  int rc = allow_smem(conv3tap_f32_kernel<C, EPI>, T::SMEM);
  if (rc) return rc;
  conv3tap_f32_kernel<C, EPI>
      <<<grid_1d(npix, T::BM), THREADS, T::SMEM, stream>>>(
          in, w, pmul, padd, vec, aux, out, sums, npix, H, W, d, axis);
  return (int)cudaGetLastError();
}

template <int C>
int launch_wgrad_f32(const float* in, const float* pmul, const float* padd,
                     const float* dy, float* dk, int npix, int H, int W,
                     int d, int axis, cudaStream_t stream) {
  using T = WgradTile<C>;
  auto kern = wgrad3tap_f32_kernel<C>;
  int rc = allow_smem(kern, T::SMEM);
  if (rc) return rc;
  // one wave: the blocks the card holds at once, a third per tap (the
  // fewer blocks, the fewer atomics into dk)
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = per_sm * sms;
  }
  const int nchunks = (npix + T::KP - 1) / T::KP;
  const int per_tap = slots / 3 > 1 ? slots / 3 : 1;
  const int cpb = (nchunks + per_tap - 1) / per_tap;
  dim3 grid((nchunks + cpb - 1) / cpb, 3);
  kern<<<grid, THREADS, T::SMEM, stream>>>(in, pmul, padd, dy, dk, npix, H,
                                           W, d, axis, cpb);
  return (int)cudaGetLastError();
}

}  // namespace ldconv32

namespace ldconv {

// The float32 overloads of conv3tap.cuh's launch_conv and wgrad3tap.cuh's
// launch_wgrad: the same arguments, every plane f32.
template <int C, int EPI>
int launch_conv(const float* in, const float* w, const float* pmul,
                const float* padd, const float* vec, const float* aux,
                float* out, float* sums, int npix, int H, int W, int d,
                int axis, cudaStream_t stream) {
  return ldconv32::launch_conv_f32<C, EPI>(in, w, pmul, padd, vec, aux, out,
                                           sums, npix, H, W, d, axis,
                                           stream);
}

template <int C>
int launch_wgrad(const float* in, const float* pmul, const float* padd,
                 const float* dy, float* dk, int npix, int H, int W, int d,
                 int axis, cudaStream_t stream) {
  return ldconv32::launch_wgrad_f32<C>(in, pmul, padd, dy, dk, npix, H, W, d,
                                       axis, stream);
}

}  // namespace ldconv
