// The stride-2 products of K8 (downsampler_op.cu) and K9 (lane_maps_op.cu)
// on the tensor cores: one tile family for the three products of
// conv_s2.cuh (see there for the geometry), bf16 products for bf16 planes
// and 3xTF32 for float32 ones (tc_common.cuh: each f32 operand split into
// a TF32 high part and remainder in the SM, lo * hi + hi * lo + hi * hi
// into one f32 accumulator, smallest first; ops/tf32x3.py states the same
// arithmetic in PyTorch).
//
//   s2_tile, an implicit GEMM: M = small-plane pixels, 16 per warp (all N
//   columns each), 64 a block of 4 warps in K8 / K9's s2_gemm_kernel, 128
//   a block of 8 in the serving kernels; N = the output channels; K = taps
//   x CK input channels, in chunks of KC channels of one tap. Two
//   geometries feed its A rows:
//     ConvGeo  - the large gather, the 3x3/s2/p1 convolution (K8 forward, K9
//                input gradient): row (p, tap) is the large plane's pixel
//                (2h + ky - 1, 2w + kx - 1), zero where that is off the
//                plane;
//     PhaseGeo - the small gather, the transposed convolution 3x3/s2/p1/op1
//                (K9 forward, K8 input gradient), split by output parity
//                (py, px) = blockIdx.y into four dense convolutions of the
//                small plane with 1, 2, 2 and 4 taps: an even output row
//                takes tap ky = 1 at h, an odd one ky = 0 at h + 1 and ky =
//                2 at h (columns alike). The epilogue writes row (h, w) of
//                phase (py, px) to the large plane's pixel (2h + py, 2w +
//                px), so the phases interleave there.
//   The op (the kernel's template argument) supplies the geometry and the
//   epilogue, which runs on the accumulators in registers: bias, one
//   rounding to the output type, per-channel moments folded over the warp
//   by shuffles and over the block's warps in warp order in shared memory,
//   written to the block's row of a partials buffer; K8's pool channels
//   and pool gradient.
//
//   s2_wgrad_kernel, a GEMM per tap (blockIdx.y): dW[tap] = small^T (CS x
//   pixels) @ large_tap (pixels x CL), K = pixels in chunks of 32, split
//   over a fixed number of blocks a tap (s2_per_tap: one wave of the
//   H100); the small rows are read as the transposed A operand. Each
//   block writes its CS x CL sums to its row of a partials buffer.
//
//   No atomics: the callers fold the partials in a fixed order (fold.cuh)
//   after their last launch, so the moments and the weight gradients
//   reproduce themselves bit for bit.
//
// Both walk K through a ring of MM_STAGES shared-memory stages filled by
// 16-byte cp.async copies (channel runs are contiguous in NHWC; src-size 0
// zero-fills rows off the plane), so the next chunks' copies are in flight
// while one is multiplied; one barrier per chunk.
//
// mma.sync, not wgmma: one fragment family serves bf16 (m16n8k16, ldmatrix
// with and without .trans) and TF32 (m16n8k8, the operands split as their
// fragments are read), K-major and transposed operands, and the narrow N =
// 16 of two of the shapes. On the H100 these tiles are bound by their
// staging, not their products (PERF.md): builds without the products kept
// all of the bf16 tiles' time and most of the float32 ones'.
//
// The callers fix the shapes that take these tiles: the stride-2 blocks of
// the config's backbone, K8 at 16 -> 64 and 64 -> 128 and K9's two
// upsamplers; the serving K2 and K3 (downsampler.cuh, upsampler.cuh, with
// epilogues of their own: BatchNorm folded, relu, one bf16 rounding) at
// the same four shapes, standalone and inside encoder_fused.cu /
// decoder_fused.cu.
#pragma once

#include "conv_s2.cuh"
#include "tc_common.cuh"

namespace lds2 {

constexpr int MM_THREADS = 128;  // 4 warps
constexpr int MM_BM = 64;        // GEMM rows (small-plane pixels) a block
constexpr int MM_STAGES = 3;     // depth of the cp.async ring
constexpr int MM_KP = 32;        // pixels a chunk of the weight gradient
constexpr int MM_MAXC = 128;     // channels of the block's moment sums
// floats of a block's sums in s2_gemm_kernel: the 4 warps' [sums | second
// sums] of up to MM_MAXC channels each, then two per thread (K8's pool
// channels)
constexpr int MM_RED = (MM_THREADS / 32) * 2 * MM_MAXC + 2 * MM_THREADS;

// ---- fragments -------------------------------------------------------------

template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int KS = 16;  // depth of one product
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  // rows m0 .. m0+15, depth k0 .. k0+15 of A from a [m][k] tile (pitch ld)
  __device__ __forceinline__ static void load_a(A& a, const bf16* s, int ld,
                                                int m0, int k0) {
    const int l = threadIdx.x & 31;
    ldtc::ldmatrix_x4(a.r, s + (m0 + (l & 7) + 8 * ((l >> 3) & 1)) * ld + k0 +
                               8 * (l >> 4));
  }
  // the same from a [k][m] tile: A read transposed
  __device__ __forceinline__ static void load_at(A& a, const bf16* s, int ld,
                                                 int m0, int k0) {
    const int l = threadIdx.x & 31, q = l >> 3;
    ldtc::ldmatrix_x4_trans(
        a.r, s + (k0 + (l & 7) + 8 * (q >> 1)) * ld + m0 + 8 * (q & 1));
  }
  // columns n0 .. n0+7 and n0+8 .. n0+15 of B from a [k][n] tile
  __device__ __forceinline__ static void load_b2(B (&b)[2], const bf16* s,
                                                 int ld, int k0, int n0) {
    const int l = threadIdx.x & 31, q = l >> 3;
    uint32_t r[4];
    ldtc::ldmatrix_x4_trans(
        r, s + (k0 + (l & 7) + 8 * (q & 1)) * ld + n0 + 8 * (q >> 1));
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  __device__ __forceinline__ static void mma(float (&c)[4], const A& a,
                                             const B& b) {
    ldtc::mma_bf16(c, a.r, b.r);
  }
};

template <>
struct Mma<float> {
  static constexpr int KS = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  __device__ __forceinline__ static void load_a(A& a, const float* s, int ld,
                                                int m0, int k0) {
    const int l = threadIdx.x & 31;
    const float* p = s + (m0 + (l >> 2)) * ld + k0 + (l & 3);
    ldtc::split_tf32(p[0], a.hi[0], a.lo[0]);
    ldtc::split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    ldtc::split_tf32(p[4], a.hi[2], a.lo[2]);
    ldtc::split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  __device__ __forceinline__ static void load_at(A& a, const float* s, int ld,
                                                 int m0, int k0) {
    const int l = threadIdx.x & 31;
    const float* p = s + (k0 + (l & 3)) * ld + m0 + (l >> 2);
    ldtc::split_tf32(p[0], a.hi[0], a.lo[0]);
    ldtc::split_tf32(p[8], a.hi[1], a.lo[1]);
    ldtc::split_tf32(p[4 * ld], a.hi[2], a.lo[2]);
    ldtc::split_tf32(p[4 * ld + 8], a.hi[3], a.lo[3]);
  }
  __device__ __forceinline__ static void load_b2(B (&b)[2], const float* s,
                                                 int ld, int k0, int n0) {
    const int l = threadIdx.x & 31;
    const float* p = s + (k0 + (l & 3)) * ld + n0 + (l >> 2);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      ldtc::split_tf32(p[8 * t], b[t].hi[0], b[t].lo[0]);
      ldtc::split_tf32(p[4 * ld + 8 * t], b[t].hi[1], b[t].lo[1]);
    }
  }
  // three TF32 products, smallest terms first
  __device__ __forceinline__ static void mma(float (&c)[4], const A& a,
                                             const B& b) {
    ldtc::mma_tf32(c, a.lo, b.hi);
    ldtc::mma_tf32(c, a.hi, b.lo);
    ldtc::mma_tf32(c, a.hi, b.hi);
  }
};

// ---- geometry --------------------------------------------------------------

// small-plane pixel p of (B, Hs, Ws); `in` is false past the last one
struct Pix {
  int b, h, w;
  bool in;
};

__device__ __forceinline__ Pix pix_of(int p, int npix, int Hs, int Ws) {
  Pix q;
  q.in = p < npix;
  const int pp = q.in ? p : 0;
  q.w = pp % Ws;
  q.h = (pp / Ws) % Hs;
  q.b = pp / (Ws * Hs);
  return q;
}

// The large gather: A row (p, tap t = 3 ky + kx) is the large plane (B, 2Hs,
// 2Ws, CL) at (2h + ky - 1, 2w + kx - 1); the output row is p itself.
template <typename T>
struct ConvGeo {
  const T* large;
  int npix, Hs, Ws, CL;
  __device__ __forceinline__ int taps(int) const { return 9; }
  __device__ __forceinline__ int tap_index(int t, int) const { return t; }
  __device__ __forceinline__ const T* a_src(const Pix& q, int t, int,
                                            bool& ok) const {
    const int Y = 2 * q.h + t / 3 - 1, X = 2 * q.w + t % 3 - 1;
    ok = q.in && Y >= 0 && Y < 2 * Hs && X >= 0 && X < 2 * Ws;
    return ok ? large + (((size_t)q.b * 2 * Hs + Y) * 2 * Ws + X) * CL
              : large;
  }
  __device__ __forceinline__ size_t out_pixel(const Pix&, int p, int) const {
    return (size_t)p;
  }
};

// The small gather by output parity: phase = 2 py + px; along one axis parity
// 0 has the tap k = 1 at offset 0, parity 1 the taps k = 0 at offset +1
// and k = 2 at offset 0. A row (p, t) is the small plane (B, Hs, Ws, CST)
// at (h + dh, w + dw), zero past its edge; the output row is the large
// plane's pixel (2h + py, 2w + px).
template <typename T>
struct PhaseGeo {
  const T* small;
  int npix, Hs, Ws, CST;
  __device__ __forceinline__ static int ntap(int par) { return par ? 2 : 1; }
  __device__ __forceinline__ int taps(int phase) const {
    return ntap(phase >> 1) * ntap(phase & 1);
  }
  __device__ __forceinline__ int tap_index(int t, int phase) const {
    const int nx = ntap(phase & 1), iy = t / nx, ix = t % nx;
    const int ky = (phase >> 1) ? 2 * iy : 1, kx = (phase & 1) ? 2 * ix : 1;
    return 3 * ky + kx;
  }
  __device__ __forceinline__ const T* a_src(const Pix& q, int t, int phase,
                                            bool& ok) const {
    const int nx = ntap(phase & 1), iy = t / nx, ix = t % nx;
    const int hh = q.h + ((phase >> 1) ? 1 - iy : 0);
    const int ww = q.w + ((phase & 1) ? 1 - ix : 0);
    ok = q.in && hh < Hs && ww < Ws;
    return ok ? small + (((size_t)q.b * Hs + hh) * Ws + ww) * CST : small;
  }
  __device__ __forceinline__ size_t out_pixel(const Pix& q, int,
                                              int phase) const {
    return ((size_t)q.b * 2 * Hs + 2 * q.h + (phase >> 1)) * 2 * Ws +
           2 * q.w + (phase & 1);
  }
};

// ---- epilogue pieces -------------------------------------------------------

// The GEMM row (from the block's first) and column of this thread's
// accumulator acc[j][2h + e] in s2_gemm_kernel: row tile_row(h), column
// tile_col(j) + e.
__device__ __forceinline__ int tile_row(int h) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int tile_col(int j) {
  return 8 * j + 2 * (threadIdx.x & 3);
}

// Store two neighbouring values in the output's type; return them as
// stored.
__device__ __forceinline__ void stf2(float* p, float a, float b, float& ra,
                                     float& rb) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
  ra = a;
  rb = b;
}
__device__ __forceinline__ void stf2(bf16* p, float a, float b, float& ra,
                                     float& rb) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
  ra = __low2float(v);
  rb = __high2float(v);
}

// Per-thread sums s[j][e] of channel 8j + 2tg + e (the accumulator's
// columns), folded over the 8 lanes that hold the same channels by xor
// shuffles and written to this warp's slot of red[] in shared memory
// (warp w's sums at red + w * 2 MM_MAXC).
template <int NT>
__device__ __forceinline__ void fold_channels(float (&s)[NT][2], float* red) {
  const int lane = threadIdx.x & 31;
  float* slot = red + (threadIdx.x >> 5) * 2 * MM_MAXC;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = s[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) slot[8 * j + 2 * lane + e] = v;
    }
}

// After a barrier: entry c of the warps' slots, added in warp order
__device__ __forceinline__ float warp_sum(const float* red, int c) {
  float a = 0.0f;
#pragma unroll
  for (int w = 0; w < MM_THREADS / 32; ++w) a += red[w * 2 * MM_MAXC + c];
  return a;
}

// This block's row of a moments partials buffer (2C floats a row; the
// rows of phase blockIdx.y follow those of the phases before it)
__device__ __forceinline__ float* moment_row(float* part, int C) {
  return part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * C;
}

// ---- the implicit GEMM -----------------------------------------------------

// One tile of NW warps: BM = 16 NW GEMM rows (a warp's 16 rows take all N
// columns), K walked in chunks of KC channels of one tap.
template <typename T, int CK, int N, int NW = 4>
struct GemmTile {
  static constexpr int THREADS = 32 * NW;
  static constexpr int BM = 16 * NW;
  static constexpr int EPV = 16 / (int)sizeof(T);  // elements a copy
  static constexpr int KC = CK % 32 == 0 ? 32 : 16;  // channels a chunk
  static constexpr int CPT = CK / KC;                // chunks a tap
  static constexpr int LDA = KC + EPV;  // pitches, 16 bytes of padding
  static constexpr int LDB = N + 8;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = KC * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM = MM_STAGES * STAGE * (int)sizeof(T);
  static constexpr int VA = KC / EPV, VB = N / EPV;  // copies a row
  static constexpr int RPT = BM * VA / THREADS;      // A rows a thread
  static constexpr int NT = N / 8;
  static_assert(CK % KC == 0 && KC % Mma<T>::KS == 0 && NT % 2 == 0 &&
                    THREADS % VA == 0 && RPT * THREADS == BM * VA &&
                    N <= MM_MAXC,
                "a tile the block can stage");
};

// out = op's epilogue of sum_taps sum_c A(p, tap)[c] * wt[tap][c][n] for
// the BM rows p0 .. p0 + BM - 1 and phase `phase`, computed by the
// block's 32 NW threads through the ring in `smem` (G::SMEM bytes); op.wt
// is taps-first (9, CK, N) of type T; `red` is the op's shared memory for
// block sums (MM_RED floats, or nullptr for an op that keeps none).
// The tile function of K8 and K9 (s2_gemm_kernel, 4 warps) and of the
// serving kernels' stride-2 passes (downsampler.cuh, upsampler.cuh: 8
// warps, standalone and inside the fused kernels): each output's sum runs
// over the same chunks in the same order whatever NW is. Starts by
// writing `smem` and ends after reading it: a caller that runs a second
// tile in the same block puts a __syncthreads() between the two.
template <typename T, int CK, int N, int NW, class Op>
__device__ __forceinline__ void s2_tile(const Op& op, int p0, int phase,
                                        T* smem, float* red) {
  using G = GemmTile<T, CK, N, NW>;
  using M = Mma<T>;
  const int warp = threadIdx.x >> 5;
  const int nchunks = op.taps(phase) * G::CPT;

  // this thread copies A rows r0 + j * (THREADS / VA), 16 bytes at v
  const int v = threadIdx.x % G::VA, r0 = threadIdx.x / G::VA;
  Pix rows[G::RPT];
#pragma unroll
  for (int j = 0; j < G::RPT; ++j)
    rows[j] = pix_of(p0 + r0 + j * (G::THREADS / G::VA), op.npix, op.Hs,
                     op.Ws);

  auto stage = [&](int i) { return smem + (i % MM_STAGES) * G::STAGE; };
  auto load_chunk = [&](int i) {
    T* sA = stage(i);
    T* sB = sA + G::A_ELEMS;
    const int t = i / G::CPT, c0 = (i % G::CPT) * G::KC;
#pragma unroll
    for (int j = 0; j < G::RPT; ++j) {
      bool ok;
      const T* src = op.a_src(rows[j], t, phase, ok);
      ldtc::cp_async16(
          sA + (r0 + j * (G::THREADS / G::VA)) * G::LDA + v * G::EPV,
          ok ? src + c0 + v * G::EPV : src, ok);
    }
    const T* wt = op.wt + ((size_t)op.tap_index(t, phase) * CK + c0) * N;
    for (int e = threadIdx.x; e < G::KC * G::VB; e += G::THREADS) {
      const int r = e / G::VB, c = e % G::VB;
      ldtc::cp_async16(sB + r * G::LDB + c * G::EPV, wt + r * N + c * G::EPV,
                       true);
    }
  };

  float acc[G::NT][4];
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < MM_STAGES - 1; ++i) {
    if (i < nchunks) load_chunk(i);
    ldtc::cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < nchunks; ++i) {
    ldtc::cp_async_wait<MM_STAGES - 2>();  // this thread's chunk i landed
    // every thread's chunk i is visible, and every warp is done with chunk
    // i - 1, whose stage is refilled next
    __syncthreads();
    if (i + MM_STAGES - 1 < nchunks) load_chunk(i + MM_STAGES - 1);
    ldtc::cp_async_commit();  // possibly empty: one group per iteration
    const T* sA = stage(i);
    const T* sB = sA + G::A_ELEMS;
#pragma unroll
    for (int k = 0; k < G::KC; k += M::KS) {
      typename M::A a;
      M::load_a(a, sA, G::LDA, warp * 16, k);
#pragma unroll
      for (int j = 0; j < G::NT; j += 2) {
        typename M::B b[2];
        M::load_b2(b, sB, G::LDB, k, j * 8);
        M::mma(acc[j], a, b[0]);
        M::mma(acc[j + 1], a, b[1]);
      }
    }
  }
  ldtc::cp_async_wait<0>();
  op.epilogue(acc, p0, phase, red);
}

// K8 / K9's kernel: one 4-warp tile of 64 rows per block, phase blockIdx.y.
template <typename T, int CK, int N, class Op>
__global__ void __launch_bounds__(MM_THREADS) s2_gemm_kernel(const Op op) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float red[MM_RED];  // the block's moment sums
  s2_tile<T, CK, N, MM_THREADS / 32>(op, blockIdx.x * MM_BM, blockIdx.y,
                                     reinterpret_cast<T*>(smem_raw), red);
}

template <typename T, int CK, int N, class Op>
int launch_s2_gemm(const Op& op, int phases, cudaStream_t s) {
  using G = GemmTile<T, CK, N>;
  auto kern = s2_gemm_kernel<T, CK, N, Op>;
  if (G::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((op.npix + MM_BM - 1) / MM_BM, phases);
  kern<<<grid, MM_THREADS, G::SMEM, s>>>(op);
  return (int)cudaGetLastError();
}

// ---- the weight gradient ---------------------------------------------------

template <typename T, int MP, int CL>
struct WgradTile {
  static constexpr int EPV = 16 / (int)sizeof(T);
  static constexpr int LDA = MP + 8, LDB = CL + 8;  // pitches
  static constexpr int A_ELEMS = MM_KP * LDA, B_ELEMS = MM_KP * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM = MM_STAGES * STAGE * (int)sizeof(T);
  static constexpr int VA = MP / EPV, VB = CL / EPV;  // copies a row
  static constexpr int MT = MP / 64;  // m16 row groups a warp (4 warps)
  static constexpr int NT = CL / 8;
  static_assert(MP % 64 == 0 && NT % 2 == 0 && MM_KP % Mma<T>::KS == 0,
                "a tile the block can stage");
};

// The sum over the block's pixel chunks of small[p][cs] * large[tap pixel
// of p][cl], tap = blockIdx.y = 3 ky + kx, to the block's row of `part`
// (CS CL 9 floats a row, in dW's layout (CS, CL, 3, 3): entry (cs CL + cl)
// 9 + tap). small: (B, Hs, Ws, CST), its first MP >= CS channels staged
// (rows MP past CS are products never written); large: (B, 2Hs, 2Ws, CL).
// `Tag` names the op in a profile.
template <typename T, int MP, int CL, class Tag>
__global__ void __launch_bounds__(MM_THREADS) s2_wgrad_kernel(
    const T* __restrict__ small, const T* __restrict__ large,
    float* __restrict__ part, int npix, int Hs, int Ws, int CST, int CS,
    int chunks_per_block) {
  using G = WgradTile<T, MP, CL>;
  using M = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tap = blockIdx.y, ky = tap / 3, kx = tap % 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = (npix + MM_KP - 1) / MM_KP;
  const int chunk0 = blockIdx.x * chunks_per_block;
  const int n = min(nchunks, chunk0 + chunks_per_block) - chunk0;

  auto stage = [&](int i) { return smem + (i % MM_STAGES) * G::STAGE; };
  auto load_chunk = [&](int i) {
    T* sA = stage(i);
    T* sB = sA + G::A_ELEMS;
    const int pc = (chunk0 + i) * MM_KP;
    for (int e = threadIdx.x; e < MM_KP * G::VA; e += MM_THREADS) {
      const int r = e / G::VA, c = e % G::VA, p = pc + r;
      const bool ok = p < npix;
      ldtc::cp_async16(sA + r * G::LDA + c * G::EPV,
                       ok ? small + (size_t)p * CST + c * G::EPV : small, ok);
    }
    for (int e = threadIdx.x; e < MM_KP * G::VB; e += MM_THREADS) {
      const int r = e / G::VB, c = e % G::VB;
      const Pix q = pix_of(pc + r, npix, Hs, Ws);
      const int Y = 2 * q.h + ky - 1, X = 2 * q.w + kx - 1;
      const bool ok = q.in && Y >= 0 && Y < 2 * Hs && X >= 0 && X < 2 * Ws;
      ldtc::cp_async16(
          sB + r * G::LDB + c * G::EPV,
          ok ? large + (((size_t)q.b * 2 * Hs + Y) * 2 * Ws + X) * CL +
                   c * G::EPV
             : large,
          ok);
    }
  };

  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < MM_STAGES - 1; ++i) {
    if (i < n) load_chunk(i);
    ldtc::cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    ldtc::cp_async_wait<MM_STAGES - 2>();
    __syncthreads();  // chunk i visible; chunk i - 1's stage free
    if (i + MM_STAGES - 1 < n) load_chunk(i + MM_STAGES - 1);
    ldtc::cp_async_commit();
    const T* sA = stage(i);
    const T* sB = sA + G::A_ELEMS;
#pragma unroll
    for (int k = 0; k < MM_KP; k += M::KS) {
      typename M::A a[G::MT];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
        M::load_at(a[mt], sA, G::LDA, (warp * G::MT + mt) * 16, k);
#pragma unroll
      for (int j = 0; j < G::NT; j += 2) {
        typename M::B b[2];
        M::load_b2(b, sB, G::LDB, k, j * 8);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          M::mma(acc[mt][j], a[mt], b[0]);
          M::mma(acc[mt][j + 1], a[mt], b[1]);
        }
      }
    }
  }
  ldtc::cp_async_wait<0>();

  // acc[mt][j][2h + e]: cs = (warp MT + mt) 16 + g + 8h, cl = 8j + 2tg + e
  const int g = lane >> 2, tg = lane & 3;
  float* row = part + (size_t)blockIdx.x * CS * CL * 9;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cs = (warp * G::MT + mt) * 16 + g + 8 * h;
      if (cs >= CS) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * j + 2 * tg + e;
          row[((size_t)cs * CL + cl) * 9 + tap] = acc[mt][j][2 * h + e];
        }
    }
}

// Blocks a tap of the weight gradient: a ninth of one wave of the H100's
// 132 SMs at the blocks an SM holds of each instantiation (f32 64x16: 6,
// 64x64: 4, 128x64: 2; bf16 8, 6, 4). A constant, so that the partition,
// and with it the order of the sums, depends on the shape alone
// (ops/lanemaps.py keeps the same table).
template <typename T, int MP, int CL>
constexpr int s2_per_tap() {
  return (sizeof(T) == 4 ? (MP == 128 ? 2 : CL == 16 ? 6 : 4)
                         : (MP == 128 ? 4 : CL == 16 ? 8 : 6)) *
         132 / 9;
}

// dW (CS, CL, 3, 3) f32, written whole by the fold of `pp`, which takes
// the blocks' partials here: the weight gradient between the first CS <=
// MP channels of `small` (pitch CST) and the CL of `large`, over
// s2_per_tap blocks a tap, each a run of whole pixel chunks.
template <typename T, int MP, int CL, class Tag>
int launch_s2_wgrad(const T* small, const T* large, float* dW, int B, int Hs,
                    int Ws, int CST, int CS, cudaStream_t s,
                    ldfold::Partials& pp) {
  using G = WgradTile<T, MP, CL>;
  if (CS > MP || CST < MP) return (int)cudaErrorInvalidValue;
  auto kern = s2_wgrad_kernel<T, MP, CL, Tag>;
  if (G::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const int npix = B * Hs * Ws;
  const int nchunks = (npix + MM_KP - 1) / MM_KP;
  const int cpb = (nchunks + s2_per_tap<T, MP, CL>() - 1) /
                  s2_per_tap<T, MP, CL>();
  const int blocks = (nchunks + cpb - 1) / cpb;
  float* part = pp.take(blocks, CS * CL * 9, dW);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  kern<<<dim3(blocks, 9), MM_THREADS, G::SMEM, s>>>(small, large, part, npix,
                                                    Hs, Ws, CST, CS, cpb);
  return (int)cudaGetLastError();
}

}  // namespace lds2
