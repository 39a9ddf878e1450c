// K6 / K7 backward: one half of a training NonBottleneck1D block.
//
// Replaces the TPU bodies `_half_a_bwd_kernel` and `_half_b_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_nb_block.py:212, :339), in their
// order and with their rounding points (products in the plane's dtype T,
// bf16 or float32, f32 sums, the bias gradients summed from the f32 values
// before rounding; in float32 nothing is rounded):
//
//   dyv   = dyout + ds1 + 2 * yout * ds2        f32: the moment cotangent
//   dbw   = sum dyv;   dy = T(dyv)
//   dkw[t] = shift_t(ymid)^T @ dy
//   dmid  = convT_1x3_d(dy, kw) * (ymid > 0);  dbh = sum dmid;  -> T
//   dkh[t] = shift_t(z)^T @ dmid                z = x (A) or the recomputed
//                                               prologue T(relu(x*mul+add))
//   dz    = convT_3x1_d(dmid, kh)
//   half A: dx = T(dz)
//   half B: dz *= (x*mul+add > 0); dmul = sum dz*x; dadd = sum dz;
//           dx = T(dz * mul)
//
// Bound on the card: the two input gradients and the two weight gradients
// are 24*C^2 FLOP per pixel against 5 planes (x, ymid, yout, dyout read, dx
// written). In bf16 that is 2.4*C FLOP per byte, so the bytes bound it for
// C <= 64 and the operations roughly match them at C = 128. In float32 it
// is 1.2*C FLOP per byte, on the tensor cores in 3xTF32 (165 TFLOP/s,
// ridge about 49 FLOP per byte): the operations bound it for C = 64 and
// 128, the bytes for C = 16.
//
// Design: five launches. (1) `dyv_kernel`, one elementwise pass with a
// per-channel reduction. (2, 4) the weight gradient (bf16: wgrad3tap.cuh's
// bf16 wgmma over pixel chunks; float32: conv3tap_f32.cuh's 3xTF32 wgmma;
// both mma.sync at C = 16). (3, 5) the shared convolution (conv3tap.cuh
// or conv3tap_f32.cuh) on transposed taps with the masking epilogues.
// In both dtypes every block writes its sums (dbw, dkw, dbh, dkh, dmul and
// dadd) to its row of a partials scratch, over a block partition fixed by
// the shape, and a sixth launch, fold.cuh's fixed-order fold, adds them
// into the outputs, which it writes whole: they reproduce themselves bit
// for bit.

#include "conv3tap_f32.cuh"

using namespace ldconv;

namespace {

constexpr int EW_THREADS = 256;

// out = T(dy + ds1[c] + 2 * y * ds2[c]); the f32 values summed over the
// block's pixels (a grid-stride walk), lanes by xor shuffles, warps in
// warp order, to the block's row of db (C floats a block, a partials
// buffer).
template <typename T, int C>
__global__ void __launch_bounds__(EW_THREADS) dyv_kernel(
    const T* __restrict__ dy, const T* __restrict__ y,
    const float* __restrict__ dmom, T* __restrict__ out,
    float* __restrict__ db, int npix) {
  constexpr int VPR = C / 8;
  constexpr int RPI = EW_THREADS / VPR;  // rows per block iteration
  __shared__ float sdb[EW_THREADS / 32][C];
  const int v = threadIdx.x % VPR;  // this thread's 8 channels never change
  float ds1[8], ds2[8], acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ds1[j] = dmom[v * 8 + j];
    ds2[j] = dmom[C + v * 8 + j];
    acc[j] = 0.0f;
  }
  for (long long p = (long long)blockIdx.x * RPI + threadIdx.x / VPR;
       p < npix; p += (long long)gridDim.x * RPI) {
    const long long off = p * C + v * 8;
    float a[8], b[8], o[8];
    load8(dy + off, a);
    load8(y + off, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = a[j] + ds1[j] + 2.0f * b[j] * ds2[j];
      acc[j] += f;
      o[j] = f;
    }
    store8(out + off, o);  // rounded to T
  }
  if (fold_lanes(acc, VPR)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sdb[threadIdx.x / 32][v * 8 + j] = acc[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += EW_THREADS) {
    float a = 0.0f;
    for (int k = 0; k < EW_THREADS / 32; ++k) a += sdb[k][i];
    db[(size_t)blockIdx.x * C + i] = a;
  }
}

struct k6k7 {};  // names the fold in a profile

// pp: the partials of every sum, folded at the end
template <typename T, int C>
int half_bwd(const T* x, const float* muladd, const T* ymid, const T* yout,
             const T* dyout, const float* dmom, const T* khT, const T* kwT,
             T* dyv, T* dmid, T* dx, float* dkh, float* dbh, float* dkw,
             float* dbw, float* dmuladd, int npix, int H, int W, int d,
             cudaStream_t s, ldfold::Partials* pp) {
  const float* mul = muladd;
  const float* add = muladd ? muladd + C : nullptr;
  constexpr int RPI = EW_THREADS / (C / 8);
  const int blocks = min(grid_1d(npix, RPI), 132 * 8);
  float* rows = pp->take(blocks, C, dbw);
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  dyv_kernel<T, C><<<blocks, EW_THREADS, 0, s>>>(dyout, yout, dmom, dyv,
                                                 rows, npix);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = launch_wgrad<C>(ymid, nullptr, nullptr, dyv, dkw, npix, H, W, d, 1, s,
                       pp);
  if (rc) return rc;
  rc = launch_conv<C, EPI_MASK_SUM>(dyv, kwT, nullptr, nullptr, nullptr, ymid,
                                    dmid, dbh, npix, H, W, d, 1, s, pp);
  if (rc) return rc;
  rc = launch_wgrad<C>(x, mul, add, dmid, dkh, npix, H, W, d, 0, s, pp);
  if (rc) return rc;
  if (muladd == nullptr)
    rc = launch_conv<C, EPI_PLAIN>(dmid, khT, nullptr, nullptr, nullptr,
                                   nullptr, dx, nullptr, npix, H, W, d, 0, s,
                                   pp);
  else
    rc = launch_conv<C, EPI_PRO_BWD>(dmid, khT, nullptr, nullptr, muladd, x,
                                     dx, dmuladd, npix, H, W, d, 0, s, pp);
  return rc ? rc : pp->fold<k6k7>(s);
}

template <typename T>
int half_bwd_entry(const void* x, const void* muladd, const void* ymid,
                   const void* yout, const void* dyout, const void* dmom,
                   const void* khT, const void* kwT, void* dyv, void* dmid,
                   void* dx, void* dkh, void* dbh, void* dkw, void* dbw,
                   void* dmuladd, void* part, int B, int H, int W, int C,
                   int d, int part_floats, void* stream) {
  const int npix = B * H * W;
  auto s = static_cast<cudaStream_t>(stream);
  ldfold::Partials pp(part, part_floats);
#define LD_ARGS                                                              \
  static_cast<const T*>(x), static_cast<const float*>(muladd),              \
      static_cast<const T*>(ymid), static_cast<const T*>(yout),             \
      static_cast<const T*>(dyout), static_cast<const float*>(dmom),        \
      static_cast<const T*>(khT), static_cast<const T*>(kwT),               \
      static_cast<T*>(dyv), static_cast<T*>(dmid), static_cast<T*>(dx),     \
      static_cast<float*>(dkh), static_cast<float*>(dbh),                   \
      static_cast<float*>(dkw), static_cast<float*>(dbw),                   \
      static_cast<float*>(dmuladd), npix, H, W, d, s, &pp
  switch (C) {
    case 16:
      return half_bwd<T, 16>(LD_ARGS);
    case 64:
      return half_bwd<T, 64>(LD_ARGS);
    case 128:
      return half_bwd<T, 128>(LD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LD_ARGS
}

template <int C>
int bwd_info(int* info) {
  int rc = conv_info<C, EPI_MASK_SUM, bf16>(info);
  if (!rc) rc = conv_info<C, EPI_PLAIN, bf16>(info + 4);
  if (!rc) rc = conv_info<C, EPI_PRO_BWD, bf16>(info + 8);
  return rc ? rc : wgrad_info<C>(info + 12);
}

}  // namespace

// x, ymid, yout, dyout, dyv, dmid, dx: (B, H, W, C) bf16 contiguous (dyv,
// dmid scratch); muladd: (2, C) f32 [mul; add] or null (half A); dmom:
// (2, C) f32; khT, kwT: (3, C, C) bf16, khT[t] = kh[2-t]^T; dkh, dkw:
// (3, C, C) f32; dbh, dbw: (C,) f32; dmuladd: (2, C) f32 [dmul; dadd] or
// null. The f32 outputs are written whole (any contents on entry); part:
// f32 scratch of part_floats floats for the blocks' sums
// (ops/nb_block.py::bwd_partials counts them; any contents).
LD_API int ld_nb_half_bwd(const void* x, const void* muladd, const void* ymid,
                          const void* yout, const void* dyout,
                          const void* dmom, const void* khT, const void* kwT,
                          void* dyv, void* dmid, void* dx, void* dkh,
                          void* dbh, void* dkw, void* dbw, void* dmuladd,
                          void* part, int B, int H, int W, int C, int d,
                          int part_floats, void* stream) {
  return half_bwd_entry<bf16>(x, muladd, ymid, yout, dyout, dmom, khT, kwT,
                              dyv, dmid, dx, dkh, dbh, dkw, dbw, dmuladd,
                              part, B, H, W, C, d, part_floats, stream);
}

// The same on float32 planes and taps: every bf16 argument above f32.
LD_API int ld_nb_half_bwd_f32(const void* x, const void* muladd,
                              const void* ymid, const void* yout,
                              const void* dyout, const void* dmom,
                              const void* khT, const void* kwT, void* dyv,
                              void* dmid, void* dx, void* dkh, void* dbh,
                              void* dkw, void* dbw, void* dmuladd,
                              void* part, int B, int H, int W, int C, int d,
                              int part_floats, void* stream) {
  return half_bwd_entry<float>(x, muladd, ymid, yout, dyout, dmom, khT, kwT,
                               dyv, dmid, dx, dkh, dbh, dkw, dbw, dmuladd,
                               part, B, H, W, C, d, part_floats, stream);
}

// What the card makes of the bf16 tiles of the backward at C (16, 64 or
// 128), for a report (conv3tap.cuh's tile_info: registers, local bytes,
// blocks an SM, shared bytes): info[0..3] the convolution with the relu
// mask, [4..7] the plain one (half A's dx), [8..11] the one with the
// prologue's backward (half B's dx), [12..15] the weight gradient.
LD_API int ld_nb_half_bwd_info(int C, int* info) {
  switch (C) {
    case 16:
      return bwd_info<16>(info);
    case 64:
      return bwd_info<64>(info);
    case 128:
      return bwd_info<128>(info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
