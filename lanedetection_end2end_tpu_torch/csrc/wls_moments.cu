// K12 wls_moments: the moments of the general-homography WLS fit,
//
//   m[b*Cw + c, k] = sum_n w[b, n, c]^2 * basis[n, k]        (all f32)
//
// Replaces the TPU kernel `_moments_kernel` (lanedetection_end2end_tpu/ops/
// pallas_wls.py:36, entry `wls_moments` :80), which streams N through VMEM
// and carries the (BC, K) block across its sequential grid. w is read in the
// engine's own layout, (B, N, Cw) with the lanes innermost, so the masked
// weight maps (B, H, W, C) need no transpose; a (BC, N) input is Cw = 1.
//
// Bound on the card: bytes. At 256x512, batch 8, order 3, w is 16.8 MB and
// the basis 10.5 MB against 0.17 GFLOP: 8.1 us at 3.35 TB/s. The products
// stay on the CUDA cores in f32 FFMA (about 2.5 us of the card's FFMA
// rate): TF32 tensor cores keep 10 mantissa bits, too few for the fit's
// 1e-4 bar.
//
// Design: a streaming pass whose copies overlap its products, then a
// fixed-order fold, so that the moments are bit for bit the same from
// launch to launch (no atomics).
//  1. `wls_stream_kernel`: a grid of about two CTAs per SM of the H100
//     (CTAS in all, split over the groups of 32 rows), each CTA a
//     contiguous range of N in tiles of TILE pixels. For every tile one
//     thread issues TMA 1-D bulk copies (csrc/tc_common.cuh) of
//     w[b, n0:n0+TILE, :] for the CTA's 32 / Cw images (TILE * Cw * 4
//     contiguous bytes each) and of basis[n0:n0+TILE, :] (TILE * K * 4
//     bytes) into a ring of STAGES shared-memory stages, each on its own
//     mbarrier, so the next tiles' bytes are in flight while one is
//     multiplied. Lane l of every warp owns row l (image l / Cw, lane l %
//     Cw), warp j the pixels j, j + 8, ... of a tile: it squares w as it
//     reads it and keeps KP sums in registers, reading the basis row as
//     broadcast float4s (K a multiple of 4; else as floats). Each image's
//     run sits at a pitch of TILE * Cw + max(Cw, 4) floats, so the 32
//     lanes' reads fall in distinct banks for Cw >= 4. A tile whose copies
//     break TMA's rules (a source or size not a multiple of 16 bytes: w
//     rows of N * Cw floats not a multiple of 4, a last tile of odd
//     length) is copied by every thread with 4-byte cp.async instead, in
//     the same stage, when its turn comes: there is no second path. At
//     the end the 8 warps' sums add in warp order through shared memory,
//     and the CTA writes its (32, K) block to row `chunk` of the partials.
//  2. ldfold::fold_rows_kernel (csrc/fold.cuh), a programmatic dependent
//     launch: the chunks' rows added in a fixed order.

#include "fold.cuh"
#include "tc_common.cuh"

namespace {

struct wls_tag {};  // names the fold in a profile

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;   // pixels a stage
constexpr int STAGES = 3;   // depth of the ring
constexpr int ROWS = 32;    // rows (b, c) per CTA, one per lane
constexpr int KMAX = 32;
constexpr int CTAS = 264;   // two CTAs per SM of the H100's 132

// floats of one image's run in a stage: TILE * Cw + a pad that spreads the
// lanes over the banks, a multiple of 4 (16-byte aligned runs)
__host__ __device__ __forceinline__ int pitch_of(int Cw) {
  return TILE * Cw + (Cw > 4 ? Cw : 4);
}
__host__ __device__ __forceinline__ int stage_floats(int Cw, int K) {
  return ROWS / Cw * pitch_of(Cw) + (TILE * K + 3) / 4 * 4;
}

// w: (B, N, Cw) f32; basis: (N, K) f32; part: (chunks, B * Cw, K) f32, the
// CTA (chunk, group) writing its 32 rows of row `chunk`; tiles_per_chunk
// tiles of TILE pixels a chunk. V4: K == KP (float4 reads of the basis).
template <int KP, bool V4>
__global__ void __launch_bounds__(THREADS) wls_stream_kernel(
    const float* __restrict__ w, const float* __restrict__ basis,
    float* __restrict__ part, int B, int N, int Cw, int K,
    int tiles_per_chunk) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int imgs = ROWS / Cw, pitch = pitch_of(Cw);
  const int sf = stage_floats(Cw, K);
  const int R = B * Cw;
  const int chunk = blockIdx.x, b0 = blockIdx.y * imgs;
  const int nimg = min(imgs, B - b0);  // images of this group
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lb = lane / Cw, c = lane % Cw;
  const int ntiles = (N + TILE - 1) / TILE;
  const int t_begin = chunk * tiles_per_chunk;
  const int nt = max(0, min(ntiles, t_begin + tiles_per_chunk) - t_begin);

  // tile i of this CTA: its first pixel, its pixels, whether TMA takes it
  auto tile_n0 = [&](int i) { return (t_begin + i) * TILE; };
  auto tile_cnt = [&](int i) { return min(TILE, N - tile_n0(i)); };
  auto bulk_ok = [&](int i) {
    const long long n0 = tile_n0(i), cnt = tile_cnt(i);
    return ((long long)N * Cw) % 4 == 0 && (n0 * Cw) % 4 == 0 &&
           (cnt * Cw) % 4 == 0 && (n0 * K) % 4 == 0 && (cnt * K) % 4 == 0;
  };
  // thread 0: the copies of tile i into its stage, or, for a tile TMA
  // cannot take, the arrival alone (its bytes come by cp.async later)
  auto issue = [&](int i) {
    const int s = i % STAGES;
    float* sW = smem + s * sf;
    float* sB = sW + imgs * pitch;
    if (!bulk_ok(i)) {
      ldtc::mbar_arrive(&full[s]);
      return;
    }
    const int n0 = tile_n0(i), cnt = tile_cnt(i);
    const unsigned wb = (unsigned)cnt * Cw * 4, bb = (unsigned)cnt * K * 4;
    ldtc::fence_proxy_async();  // the stage's earlier writes came by cp.async
    ldtc::mbar_expect(&full[s], nimg * wb + bb);
    for (int li = 0; li < nimg; ++li)
      ldtc::bulk_copy(sW + li * pitch, w + ((size_t)(b0 + li) * N + n0) * Cw,
                      wb, &full[s]);
    ldtc::bulk_copy(sB, basis + (size_t)n0 * K, bb, &full[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) ldtc::mbar_init(&full[s], 1);
    ldtc::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES && i < nt; ++i) issue(i);
  // the fold may launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");

  float acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0f;

  for (int i = 0; i < nt; ++i) {
    const int s = i % STAGES;
    float* sW = smem + s * sf;
    float* sB = sW + imgs * pitch;
    const int n0 = tile_n0(i), cnt = tile_cnt(i);
    ldtc::mbar_wait(&full[s], (i / STAGES) & 1);
    if (!bulk_ok(i)) {
      for (int e = threadIdx.x; e < nimg * cnt * Cw; e += THREADS) {
        const int li = e / (cnt * Cw), j = e % (cnt * Cw);
        ldtc::cp_async4(sW + li * pitch + j,
                        w + ((size_t)(b0 + li) * N + n0) * Cw + j, true);
      }
      for (int e = threadIdx.x; e < cnt * K; e += THREADS)
        ldtc::cp_async4(sB + e, basis + (size_t)n0 * K + e, true);
      ldtc::cp_async_commit();
      ldtc::cp_async_wait<0>();
      __syncthreads();
    }
    const float* wrow = sW + lb * pitch + c;
    for (int p = warp; p < cnt; p += WARPS) {
      const float v = wrow[p * Cw];
      const float w2 = v * v;
      if (V4) {
        const float4* brow = reinterpret_cast<const float4*>(sB + p * KP);
#pragma unroll
        for (int j = 0; j < KP / 4; ++j) {
          const float4 q = brow[j];
          acc[4 * j + 0] += w2 * q.x;
          acc[4 * j + 1] += w2 * q.y;
          acc[4 * j + 2] += w2 * q.z;
          acc[4 * j + 3] += w2 * q.w;
        }
      } else {
        const float* brow = sB + p * K;
#pragma unroll
        for (int k = 0; k < KP; ++k)
          if (k < K) acc[k] += w2 * brow[k];
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && i + STAGES < nt) issue(i + STAGES);
  }

  // the warps' sums in warp order, through the (now idle) ring
  float* sRed = smem;  // WARPS x ROWS x KP
#pragma unroll
  for (int k = 0; k < KP; ++k) sRed[(warp * ROWS + lane) * KP + k] = acc[k];
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * K; e += THREADS) {
    const int lr = e / K, k = e % K;
    const int r = blockIdx.y * ROWS + lr;
    if (lr / Cw >= nimg) continue;
    float a = 0.0f;
    for (int j = 0; j < WARPS; ++j) a += sRed[(j * ROWS + lr) * KP + k];
    part[((size_t)chunk * R + r) * K + k] = a;
  }
}

template <int KP, bool V4>
int launch_stream(const float* w, const float* basis, float* part, int B,
                  int N, int Cw, int K, int chunks, int groups,
                  int tiles_per_chunk, cudaStream_t s) {
  auto kern = wls_stream_kernel<KP, V4>;
  const int smem = max(STAGES * stage_floats(Cw, K), WARPS * ROWS * KP) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(chunks, groups), THREADS, smem, s>>>(w, basis, part, B, N, Cw,
                                                   K, tiles_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (B, N, Cw) f32, Cw dividing 32; basis: (N, K) f32, K <= 32 (both
// 16-byte aligned); part: (chunks, B*Cw, K) f32 scratch (any contents),
// chunks = ceil(tiles / ceil(tiles / min(tiles, CTAS / groups))) with
// tiles = ceil(N / 128), groups = ceil(B*Cw / 32); out: (B*Cw, K) f32,
// written whole (any contents on entry).
LD_API int ld_wls_moments(const void* w, const void* basis, void* part,
                          void* out, int B, int N, int Cw, int K, int chunks,
                          void* stream) {
  if (Cw < 1 || ROWS % Cw || K < 1 || K > KMAX || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (N + TILE - 1) / TILE;
  const int groups = grid_1d((long long)B * Cw, ROWS);
  const int per = max(1, CTAS / groups);
  const int tpc = grid_1d(tiles, min(tiles, per));
  if (chunks != grid_1d(tiles, tpc)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto Wp = static_cast<const float*>(w);
  auto Bp = static_cast<const float*>(basis);
  auto P = static_cast<float*>(part);
  const int KP = (K + 3) / 4 * 4;
  int rc;
  switch (KP / 4 * 2 + (K == KP)) {
#define LD_CASE(q)                                                          \
  case 2 * q:                                                               \
    rc = launch_stream<4 * q, false>(Wp, Bp, P, B, N, Cw, K, chunks,        \
                                     groups, tpc, s);                       \
    break;                                                                  \
  case 2 * q + 1:                                                           \
    rc = launch_stream<4 * q, true>(Wp, Bp, P, B, N, Cw, K, chunks, groups, \
                                    tpc, s);                                \
    break;
    LD_CASE(1) LD_CASE(2) LD_CASE(3) LD_CASE(4)
    LD_CASE(5) LD_CASE(6) LD_CASE(7) LD_CASE(8)
#undef LD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  ldfold::Partials pp(part, (long long)chunks * B * Cw * K);
  if (pp.take(chunks, B * Cw * K, static_cast<float*>(out)) == nullptr)
    return (int)cudaErrorInvalidValue;
  return pp.fold<wls_tag>(s);
}
