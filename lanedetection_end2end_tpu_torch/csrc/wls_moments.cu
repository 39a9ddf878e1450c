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
// stay on the CUDA cores in f32 FFMA: TF32 tensor cores keep 10 mantissa
// bits, too few for the fit's 1e-4 bar.
//
// Design, two passes with a fixed summation order, so that the moments are
// bit for bit the same from launch to launch (no atomics):
//  1. `wls_partial_kernel`: grid (chunks of N, groups of 32 rows). A CTA
//     stages 128 pixels at a time of its 32 rows of w (squared as they
//     load) and of the basis (zero-padded to KP columns) in shared
//     memory. Lane l of every warp owns row l, warp j the pixels j, j + 8,
//     ... of the tile, and accumulates KP sums in registers, reading the
//     basis row as broadcast float4s. The 8 warps' sums are added in warp
//     order and written to partial (chunks, R, K).
//  2. `wls_sum_kernel`: one thread per (row, k) adds the chunks in order.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;  // pixels staged per step
constexpr int ROWS = 32;   // rows (b, c) per CTA, one per lane
constexpr int KMAX = 32;
// staged w (ROWS / Cw images of TILE * Cw + Cw floats) + basis tile, later
// aliased by the warps' sums
constexpr int SMEM_TILES = ROWS * TILE + ROWS + TILE * KMAX;
constexpr int SMEM_RED = WARPS * ROWS * KMAX;
constexpr int SMEM = SMEM_TILES > SMEM_RED ? SMEM_TILES : SMEM_RED;

template <int KP>
__global__ void __launch_bounds__(THREADS) wls_partial_kernel(
    const float* __restrict__ w, const float* __restrict__ basis,
    float* __restrict__ partial, int B, int N, int Cw, int K, int per_chunk) {
  __shared__ __align__(16) float smem[SMEM];
  const int pitch = TILE * Cw + Cw;  // per image; keeps the 32 lanes'
                                     // reads in 32 distinct banks
  const int imgs = ROWS / Cw;
  float* sW = smem;
  float* sB = smem + imgs * pitch;  // imgs * pitch = ROWS * TILE + ROWS
  float* sRed = smem;

  const int R = B * Cw;
  const int r0 = blockIdx.y * ROWS, b0 = blockIdx.y * imgs;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lb = lane / Cw, c = lane % Cw;
  const int n_begin = blockIdx.x * per_chunk;
  const int n_end = min(N, n_begin + per_chunk);

  float acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0f;

  for (int n0 = n_begin; n0 < n_end; n0 += TILE) {
    const int cnt = min(TILE, n_end - n0);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < imgs * TILE * Cw; i += THREADS) {
      const int li = i / (TILE * Cw), j = i % (TILE * Cw);
      const int b = b0 + li;
      float v = 0.0f;
      if (b < B && j / Cw < cnt) v = w[((size_t)b * N + n0) * Cw + j];
      sW[li * pitch + j] = v * v;
    }
    for (int i = threadIdx.x; i < TILE * KP; i += THREADS) {
      const int p = i / KP, k = i % KP;
      sB[i] = (p < cnt && k < K) ? basis[(size_t)(n0 + p) * K + k] : 0.0f;
    }
    __syncthreads();
    const float* wrow = sW + lb * pitch + c;
    for (int p = warp; p < cnt; p += WARPS) {
      const float w2 = wrow[p * Cw];
      const float4* brow = reinterpret_cast<const float4*>(sB + p * KP);
#pragma unroll
      for (int j = 0; j < KP / 4; ++j) {
        const float4 q = brow[j];
        acc[4 * j + 0] += w2 * q.x;
        acc[4 * j + 1] += w2 * q.y;
        acc[4 * j + 2] += w2 * q.z;
        acc[4 * j + 3] += w2 * q.w;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int k = 0; k < KP; ++k) sRed[(warp * ROWS + lane) * KP + k] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * K; i += THREADS) {
    const int lr = i / K, k = i % K;
    const int r = r0 + lr;
    if (r >= R) continue;
    float s = 0.0f;
    for (int j = 0; j < WARPS; ++j) s += sRed[(j * ROWS + lr) * KP + k];
    partial[((size_t)blockIdx.x * R + r) * K + k] = s;
  }
}

__global__ void wls_sum_kernel(const float* __restrict__ partial,
                               float* __restrict__ out, int chunks, int RK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= RK) return;
  float s = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) s += partial[(size_t)ch * RK + i];
  out[i] = s;
}

template <int KP>
int launch_partial(const float* w, const float* basis, float* partial, int B,
                   int N, int Cw, int K, int chunks, int per_chunk,
                   cudaStream_t s) {
  const dim3 grid(chunks, grid_1d((long long)B * Cw, ROWS));
  wls_partial_kernel<KP><<<grid, THREADS, 0, s>>>(w, basis, partial, B, N,
                                                   Cw, K, per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (B, N, Cw) f32, Cw dividing 32; basis: (N, K) f32, K <= 32;
// partial: (chunks, B*Cw, K) f32 scratch; out: (B*Cw, K) f32.
LD_API int ld_wls_moments(const void* w, const void* basis, void* partial,
                          void* out, int B, int N, int Cw, int K, int chunks,
                          void* stream) {
  if (Cw < 1 || ROWS % Cw || K < 1 || K > KMAX || chunks < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto Wp = static_cast<const float*>(w);
  auto Bp = static_cast<const float*>(basis);
  auto P = static_cast<float*>(partial);
  const int per_chunk = (grid_1d(N, chunks) + TILE - 1) / TILE * TILE;
  int rc;
  switch ((K + 3) / 4) {
#define LD_CASE(q)                                                    \
  case q:                                                             \
    rc = launch_partial<4 * q>(Wp, Bp, P, B, N, Cw, K, chunks,        \
                               per_chunk, s);                         \
    break;
    LD_CASE(1) LD_CASE(2) LD_CASE(3) LD_CASE(4)
    LD_CASE(5) LD_CASE(6) LD_CASE(7) LD_CASE(8)
#undef LD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  const int RK = B * Cw * K;
  wls_sum_kernel<<<grid_1d(RK, 256), 256, 0, s>>>(
      P, static_cast<float*>(out), chunks, RK);
  return (int)cudaGetLastError();
}
