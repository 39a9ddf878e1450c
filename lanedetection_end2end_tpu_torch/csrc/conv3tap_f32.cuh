// The 3-tap convolution and its weight gradient in float32, on CUDA cores
// (FFMA) with f32 accumulation: the float32 counterparts of conv3tap.cuh
// and wgrad3tap.cuh, with the same prologue and epilogues, used by
// packed_conv.cu (K11) and nb_half_fwd.cu / nb_half_bwd.cu (K6 / K7).
// `ldconv::launch_conv` and `ldconv::launch_wgrad` take a float32 plane
// here and a bf16 one in the bf16 headers, so a caller templated on the
// plane type calls them alike.
//
// No tensor cores: TF32 keeps a 10-bit mantissa, about 1e-3 relative per
// product, and the float32 path is held to 1e-4 of max|plain| against the
// plain PyTorch version in full f32. On the H100 these tiles are bound by
// the 67 TFLOP/s of FFMA for C = 64 and 128 (a 128-channel convolution is
// 2*3*128 = 768 FLOP per output value), by the bytes for C = 16.
//
// conv3tap_f32_kernel: a block of 256 threads computes 64 pixels x all C
// output channels. Per tap it stages the 64 shifted input rows (zero where
// the tap falls off the plane; with the BatchNorm-1 prologue
// relu(x * mul + add) applied as they are read, the padding staying zero)
// and the C x C tap matrix in shared memory; each thread keeps a (pixels x
// channels) register tile of sums, 1 x 4 for C = 16, 2 x 8 for C = 64,
// 4 x 8 for C = 128, and walks the C input channels with one FFMA per tile
// element. The epilogues are conv3tap.cuh's, without its bf16 roundings;
// their per-channel sums fold over the warp with shuffles, over the block
// in shared memory, and reach the global buffer with one atomicAdd per
// block and channel.
//
// wgrad3tap_f32_kernel: dk[t] += shift_t(f(in))^T @ dy over the pixel tiles
// of the block (blockIdx.y is the tap, f the prologue when given); each of
// the 16 x 16 threads keeps a (C/16) x (C/16) tile of the C x C result,
// rows and columns interleaved by 16 so neighbouring threads read
// neighbouring shared-memory words, and adds it to dk with atomicAdd at
// the end (the last bits depend on the order blocks finish in; dk must be
// zero before the launch).
#pragma once

#include "wgrad3tap.cuh"

namespace ldconv32 {

constexpr int TP = 64;        // pixels per block of the convolution
constexpr int THREADS = 256;  // threads per block, both kernels
constexpr int WG_TP = 64;     // pixels per staged tile of the weight gradient

using ldconv::bn_affine;
using ldconv::EPI_BIAS;
using ldconv::EPI_BIAS_MOM;
using ldconv::EPI_BIAS_RELU;
using ldconv::EPI_MASK_SUM;
using ldconv::EPI_PLAIN;
using ldconv::EPI_PRO_BWD;

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

// s[r * lda + c] = f(in[tap_pixel(p0 + r) * C + c]) for r < ROWS, zero
// where the tap falls off the plane; f is the prologue relu(x * mul + add)
// when mul != nullptr, else the identity.
template <int C, int ROWS>
__device__ __forceinline__ void stage_rows_f32(float* s, int lda,
                                               const float* in,
                                               const float* mul,
                                               const float* add, int p0,
                                               int npix, int H, int W,
                                               int off, int axis) {
  constexpr int VPR = C / 4;  // float4 per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, v = i % VPR;
    const long long q = tap_pixel(p0 + r, npix, H, W, off, axis);
    float val[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (q >= 0) {
      const float4 a = reinterpret_cast<const float4*>(in + q * C)[v];
      val[0] = a.x, val[1] = a.y, val[2] = a.z, val[3] = a.w;
      if (mul != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          val[j] = fmaxf(bn_affine(val[j], mul[v * 4 + j], add[v * 4 + j]),
                         0.0f);
      }
    }
    float* dst = s + r * lda + v * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = val[j];
  }
}

// out[p, co] = epilogue(sum_t sum_ci f(in[p + tap_t])[ci] * w[t, ci, co]),
// taps at -d, 0, +d along rows (axis 0) or columns (axis 1); f is the
// prologue when pmul != nullptr. Arguments and epilogues as
// conv3tap.cuh's conv3tap_kernel, in f32 throughout: nothing is rounded
// to bf16. `sums` is (2, C) (one row used by EPI_MASK_SUM), zero before
// the launch.
template <int C, int EPI>
__global__ void __launch_bounds__(THREADS) conv3tap_f32_kernel(
    const float* __restrict__ in, const float* __restrict__ w,
    const float* __restrict__ pmul, const float* __restrict__ padd,
    const float* __restrict__ vec, const float* __restrict__ aux,
    float* __restrict__ out, float* __restrict__ sums, int npix, int H,
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
    stage_rows_f32<C, TP>(sA, T::LDA, in, pmul, padd, p0, npix, H, W,
                          (t - 1) * d, axis);
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

  // THREADS % NCG == 0: every pixel this thread visits has the channels
  // c0 .. c0 + CPT - 1
  const int c0 = tc * T::CPT;
  float s0[T::CPT], s1[T::CPT];
#pragma unroll
  for (int j = 0; j < T::CPT; ++j) s0[j] = s1[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < T::PPT; ++i) {
    const int p = p0 + tp + i * T::RSTEP;
    if (p >= npix) continue;
    const size_t base = (size_t)p * C + c0;
#pragma unroll
    for (int j = 0; j < T::CPT; j += 4) {
      float xa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD) {
        const float4 a = *reinterpret_cast<const float4*>(aux + base + j);
        xa[0] = a.x, xa[1] = a.y, xa[2] = a.z, xa[3] = a.w;
      }
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + j + u;
        const float a = acc[i][j + u];
        if (EPI == EPI_BIAS_RELU) {
          v[u] = fmaxf(a + vec[c], 0.0f);
        } else if (EPI == EPI_BIAS) {
          v[u] = a + vec[c];
        } else if (EPI == EPI_BIAS_MOM) {
          v[u] = a + vec[c];
          s0[j + u] += v[u];
          s1[j + u] += v[u] * v[u];
        } else if (EPI == EPI_PLAIN) {
          v[u] = a;
        } else if (EPI == EPI_MASK_SUM) {
          v[u] = xa[u] > 0.0f ? a : 0.0f;
          s0[j + u] += v[u];
        } else {  // EPI_PRO_BWD: aux = x, vec = [mul; add]
          const float m =
              bn_affine(xa[u], vec[c], vec[C + c]) > 0.0f ? a : 0.0f;
          s0[j + u] += m * xa[u];
          s1[j + u] += m;
          v[u] = m * vec[c];
        }
      }
      *reinterpret_cast<float4*>(out + base + j) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (EPI == EPI_BIAS_MOM || EPI == EPI_MASK_SUM || EPI == EPI_PRO_BWD) {
    // lanes of a warp with equal tc hold the same channels: fold them onto
    // lanes 0 .. NCG-1 (tc = lane there), then sum the 8 warps' rows in
    // shared memory, which the tiles no longer need
    float red[2 * T::CPT];
#pragma unroll
    for (int j = 0; j < T::CPT; ++j) red[j] = s0[j], red[T::CPT + j] = s1[j];
    float* sRed = smem32;  // (THREADS / 32) x 2C
    if (fold_lanes(red, T::NCG)) {
      float* row = sRed + (threadIdx.x / 32) * 2 * C;
#pragma unroll
      for (int j = 0; j < T::CPT; ++j) {
        row[c0 + j] = red[j];
        row[C + c0 + j] = red[T::CPT + j];
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

template <int C>
__global__ void __launch_bounds__(THREADS) wgrad3tap_f32_kernel(
    const float* __restrict__ in, const float* __restrict__ pmul,
    const float* __restrict__ padd, const float* __restrict__ dy,
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
    stage_rows_f32<C, WG_TP>(sX, C, in, pmul, padd, p0, npix, H, W,
                             (t - 1) * d, axis);
    stage_rows_f32<C, WG_TP>(sD, C, dy, nullptr, nullptr, p0, npix, H, W, 0,
                             axis);
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
int launch_conv_f32(const float* in, const float* w, const float* pmul,
                    const float* padd, const float* vec, const float* aux,
                    float* out, float* sums, int npix, int H, int W, int d,
                    int axis, cudaStream_t stream) {
  constexpr int smem = conv_f32_smem_bytes<C>();
  static_assert(smem >= (THREADS / 32) * 2 * C * 4, "room for the sums");
  int rc = allow_smem(conv3tap_f32_kernel<C, EPI>, smem);
  if (rc) return rc;
  conv3tap_f32_kernel<C, EPI><<<grid_1d(npix, TP), THREADS, smem, stream>>>(
      in, w, pmul, padd, vec, aux, out, sums, npix, H, W, d, axis);
  return (int)cudaGetLastError();
}

template <int C>
int launch_wgrad_f32(const float* in, const float* pmul, const float* padd,
                     const float* dy, float* dk, int npix, int H, int W,
                     int d, int axis, cudaStream_t stream) {
  constexpr int smem = wgrad_f32_smem_bytes<C>();
  int rc = allow_smem(wgrad3tap_f32_kernel<C>, smem);
  if (rc) return rc;
  const int ntiles = (npix + WG_TP - 1) / WG_TP;
  // about 128 x 3 blocks: a few waves of the 132 SMs, few atomics
  const int tpb = (ntiles + 127) / 128;
  dim3 grid((ntiles + tpb - 1) / tpb, 3);
  wgrad3tap_f32_kernel<C><<<grid, THREADS, smem, stream>>>(
      in, pmul, padd, dy, dk, npix, H, W, d, axis, tpb);
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
