// The 3-tap convolution and its weight gradient in float32, on CUDA cores
// (FFMA) with f32 accumulation: the float32 counterparts of conv3tap.cuh
// and wgrad3tap.cuh, used by packed_conv.cu.
//
// No tensor cores: TF32 keeps a 10-bit mantissa, about 1e-3 relative per
// product, and the float32 path is held to 1e-4 of max|plain| against the
// plain PyTorch version in full f32. On the H100 these tiles are bound by
// the 67 TFLOP/s of FFMA for C = 64 and 128 (a 128-channel convolution is
// 2*3*128 = 768 FLOP per output value), by the bytes for C = 16.
//
// conv3tap_f32_kernel: a block of 256 threads computes 64 pixels x all C
// output channels. Per tap it stages the 64 shifted input rows (zero where
// the tap falls off the plane) and the C x C tap matrix in shared memory;
// each thread keeps a (pixels x channels) register tile of sums, 1 x 4 for
// C = 16, 2 x 8 for C = 64, 4 x 8 for C = 128, and walks the C input
// channels with one FFMA per tile element.
//
// wgrad3tap_f32_kernel: dk[t] += shift_t(in)^T @ dy over the pixel tiles
// of the block (blockIdx.y is the tap); each of the 16 x 16 threads keeps
// a (C/16) x (C/16) tile of the C x C result, rows and columns interleaved
// by 16 so neighbouring threads read neighbouring shared-memory words, and
// adds it to dk with atomicAdd at the end (the last bits depend on the
// order blocks finish in; dk must be zero before the launch).
#pragma once

#include "common.cuh"

namespace ldconv32 {

constexpr int TP = 64;        // pixels per block of the convolution
constexpr int THREADS = 256;  // threads per block, both kernels
constexpr int WG_TP = 64;     // pixels per staged tile of the weight gradient

enum Epilogue32 {
  E32_PLAIN,      // out = acc
  E32_BIAS,       // out = acc + bias[c]
  E32_BIAS_RELU,  // out = relu(acc + bias[c])
};

template <int C>
struct Tile {
  static constexpr int CPT = C >= 64 ? 8 : 4;     // channels per thread
  static constexpr int NCG = C / CPT;             // channel groups
  static constexpr int RSTEP = THREADS / NCG;     // pixel stride of a thread
  static constexpr int PPT = TP / RSTEP;          // pixels per thread
  static constexpr int LDA = C + 1;               // pitch of the input rows
  static_assert(THREADS % NCG == 0 && TP % RSTEP == 0 && PPT >= 1,
                "C in {16, 32, 64, 128}");
};

template <int C>
constexpr int conv_f32_smem_bytes() {
  return (TP * Tile<C>::LDA + C * C) * 4;
}

template <int C>
constexpr int wgrad_f32_smem_bytes() {
  return 2 * WG_TP * C * 4;
}

// s[r * lda + c] = in[tap_pixel(p0 + r) * C + c] for r < ROWS, zero where
// the tap falls off the plane.
template <int C, int ROWS>
__device__ __forceinline__ void stage_rows_f32(float* s, int lda,
                                               const float* in, int p0,
                                               int npix, int H, int W,
                                               int off, int axis) {
  constexpr int VPR = C / 4;  // float4 per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, v = i % VPR;
    const long long q = tap_pixel(p0 + r, npix, H, W, off, axis);
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q >= 0) val = reinterpret_cast<const float4*>(in + q * C)[v];
    float* dst = s + r * lda + v * 4;
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
}

// out[p, co] = epilogue(sum_t sum_ci in[p + tap_t, ci] * w[t, ci, co]),
// taps at -d, 0, +d along rows (axis 0) or columns (axis 1).
template <int C, int EPI>
__global__ void __launch_bounds__(THREADS) conv3tap_f32_kernel(
    const float* __restrict__ in, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int npix, int H,
    int W, int d, int axis) {
  using T = Tile<C>;
  extern __shared__ __align__(16) float smem32[];
  float* sA = smem32;                // TP x LDA
  float* sW = smem32 + TP * T::LDA;  // C x C, 16-byte aligned (TP % 4 == 0)
  const int p0 = blockIdx.x * TP;
  const int tc = threadIdx.x % T::NCG, tp = threadIdx.x / T::NCG;

  float acc[T::PPT][T::CPT];
#pragma unroll
  for (int i = 0; i < T::PPT; ++i)
#pragma unroll
    for (int j = 0; j < T::CPT; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < 3; ++t) {
    stage_rows_f32<C, TP>(sA, T::LDA, in, p0, npix, H, W, (t - 1) * d, axis);
    const float4* wt = reinterpret_cast<const float4*>(w + (size_t)t * C * C);
    for (int i = threadIdx.x; i < C * C / 4; i += THREADS)
      reinterpret_cast<float4*>(sW)[i] = wt[i];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      float a[T::PPT], b[T::CPT];
#pragma unroll
      for (int i = 0; i < T::PPT; ++i)
        a[i] = sA[(tp + i * T::RSTEP) * T::LDA + k];
#pragma unroll
      for (int j = 0; j < T::CPT; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(sW + k * C + tc * T::CPT + j);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::PPT; ++i)
#pragma unroll
        for (int j = 0; j < T::CPT; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are overwritten by the next tap
  }

#pragma unroll
  for (int i = 0; i < T::PPT; ++i) {
    const int p = p0 + tp + i * T::RSTEP;
    if (p >= npix) continue;
    float* o = out + (size_t)p * C + tc * T::CPT;
#pragma unroll
    for (int j = 0; j < T::CPT; j += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = acc[i][j + u];
        if (EPI != E32_PLAIN) v[u] += bias[tc * T::CPT + j + u];
        if (EPI == E32_BIAS_RELU) v[u] = fmaxf(v[u], 0.0f);
      }
      *reinterpret_cast<float4*>(o + j) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS) wgrad3tap_f32_kernel(
    const float* __restrict__ in, const float* __restrict__ dy,
    float* __restrict__ dk, int npix, int H, int W, int d, int axis,
    int tiles_per_block) {
  constexpr int MT = C / 16;  // rows and columns of dk per thread
  extern __shared__ __align__(16) float smem32[];
  float* sX = smem32;           // WG_TP x C, shifted input rows
  float* sD = smem32 + WG_TP * C;  // WG_TP x C, output gradient rows
  const int t = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (npix + WG_TP - 1) / WG_TP;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(ntiles, tile0 + tiles_per_block);

  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.0f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int p0 = tile * WG_TP;
    stage_rows_f32<C, WG_TP>(sX, C, in, p0, npix, H, W, (t - 1) * d, axis);
    stage_rows_f32<C, WG_TP>(sD, C, dy, p0, npix, H, W, 0, axis);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG_TP; ++r) {
      float a[MT], b[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = sX[r * C + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MT; ++j) b[j] = sD[r * C + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are overwritten next
  }
  float* dkt = dk + (size_t)t * C * C;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
      atomicAdd(dkt + (ty + 16 * i) * C + tx + 16 * j, acc[i][j]);
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C, int EPI>
int launch_conv_f32(const float* in, const float* w, const float* bias,
                    float* out, int npix, int H, int W, int d, int axis,
                    cudaStream_t stream) {
  constexpr int smem = conv_f32_smem_bytes<C>();
  int rc = allow_smem(conv3tap_f32_kernel<C, EPI>, smem);
  if (rc) return rc;
  conv3tap_f32_kernel<C, EPI><<<grid_1d(npix, TP), THREADS, smem, stream>>>(
      in, w, bias, out, npix, H, W, d, axis);
  return (int)cudaGetLastError();
}

template <int C>
int launch_wgrad_f32(const float* in, const float* dy, float* dk, int npix,
                     int H, int W, int d, int axis, cudaStream_t stream) {
  constexpr int smem = wgrad_f32_smem_bytes<C>();
  int rc = allow_smem(wgrad3tap_f32_kernel<C>, smem);
  if (rc) return rc;
  const int ntiles = (npix + WG_TP - 1) / WG_TP;
  // about 128 x 3 blocks: a few waves of the 132 SMs, few atomics
  const int tpb = (ntiles + 127) / 128;
  dim3 grid((ntiles + tpb - 1) / tpb, 3);
  wgrad3tap_f32_kernel<C><<<grid, THREADS, smem, stream>>>(
      in, dy, dk, npix, H, W, d, axis, tpb);
  return (int)cudaGetLastError();
}

}  // namespace ldconv32
