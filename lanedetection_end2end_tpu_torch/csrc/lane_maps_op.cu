// K9 lane_maps_op: the training ConvTranspose ops ahead of their BatchNorm
// (the two upsamplers, 3x3/s2/p1/op1) and the 2x2/s2 output head where the
// e2e tail is not fused, forward and backward.
//
// Replaces the TPU bodies `_fwd_kernel` and `_bwd_kernel`
// (lanedetection_end2end_tpu/ops/pallas_lanemaps.py:83, :100; the op at
// :167), which compute two output row phases with lane-map matmuls (the
// column phases folded into the maps) and interleave them. Here, on NHWC
// planes of one type T, bf16 or float32, with the ConvTranspose2d
// parameter (cin, cout, k, k), unflipped:
//
//   forward   y = ConvTranspose(x) + bias, rounded once to bf16 or kept
//             f32 (float32 planes: f32 only), written once at
//             (B, 2H, 2W, cout);
//             mom = [sum y; sum y^2] of the rounded y, when asked for
//             (the upsamplers only)
//   backward  dyv = dy + ds1 + 2 * y * ds2 in f32 (dy alone without
//             moments);  dbias = sum dyv;  dp = T(dyv)
//             dx = T(stride-2 convolution of dp with the weight)
//             dweight[ci][co][ky][kx] = sum_pixels x * dp
//
// torch's transposed convolution writes x[h] into output row 2h - pad + ky:
// an even output row of the 3x3 op takes one tap, an odd row two, and the
// same in columns; the 2x2 head's input pixel (h, w) alone makes output
// pixels (2h + i, 2w + j).
//
// Bound on the card: forward reads x and writes y (four times the pixels);
// backward reads x, y, dy and writes dx; at most ~190 FLOP per byte in
// bf16 (128 -> 64), under the ~295 FLOP/byte ridge: bytes; in float32 half
// that, above the ~49 FLOP/byte ridge of three TF32 products (165
// TFLOP/s): operations for the two upsamplers. The head (16 -> cout <= 8)
// does 32 cout FLOP per input pixel a direction against 32 + 16 cout bytes
// and more: bytes.
//
// Design. The two upsamplers (128 -> 64, 64 -> 16, k = 3) run on the
// tensor cores (conv_s2_mma.cuh): the forward is the transposed
// convolution by output parity (`op_k9_fwd`, N = cout), whose epilogue adds
// the bias, rounds once and reduces the moments in the block, in a fixed
// order, to the block's row of a partials scratch; the input gradient the
// 3x3/s2 implicit GEMM over dp (`op_k9_dx`, N = cin); the weight gradient
// a GEMM per tap. Their backward is three launches (dyv fold, dx, weight
// gradient). Each entry ends in fold.cuh's fixed-order fold of the blocks'
// partials into mom, or dbias and dweight, which it writes whole: no
// atomics, so they reproduce themselves bit for bit.
//
// The 2x2 head (cin 16, cout 1-8, no moments) is K10's head tile
// (head_rowsums.cuh, head_quads.cuh): pixel-local, so one pass over x each
// way, on FFMA (an N of cout would leave a tensor-core tile mostly
// padding, and the head is bound by its bytes). Forward, one launch
// (`lm_head_fwd_kernel`): a thread per input pixel, its 16 channels in
// 16-byte loads, the quad's cout values bias + sum x K in f32 from the taps
// in shared memory (the parameter rounded to T), rounded once, written as
// the two runs of 2 cout values of output rows 2h and 2h + 1 in aligned
// vector stores (16 bytes where cout allows). Backward, two launches: the
// pass of K10's backward (`lm_head_bwd_kernel`, ldhead::quad_bwd_pass)
// with the quads' gradient read from dy as it is (`OutputGrad`: the dbias
// sum from its f32 value, dp = T(dy) in registers, dx written once, x^T dp
// folded per block of 512 pixels in pixel order), then the fixed-order sum
// of the blocks' partials (`lm_head_sum_kernel`). No atomics, no zero
// fill, no dp plane: the head's dweight and dbias reproduce themselves bit
// for bit.

#include "conv_s2_mma.cuh"
#include "head_quads.cuh"

using namespace lds2;

namespace {

using ldhead::CIN;

// K9's head forward. x: (npix, CIN) of type T, W input pixels a row;
// weight: the parameter (CIN, C, 2, 2) f32; bias: (C,) f32; y: (B, 2H, 2W,
// C) of type TOut. One thread per input pixel.
template <typename T, typename TOut, int CT>
__global__ void __launch_bounds__(ldhead::THREADS) lm_head_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, TOut* __restrict__ y, int npix, int W,
    int C) {
  __shared__ __align__(16) float taps[ldhead::TAP_FLOATS];
  ldhead::load_taps<T, true>(weight, bias, C, taps);
  __syncthreads();
  const int p = blockIdx.x * ldhead::THREADS + threadIdx.x;
  if (p >= npix) return;
  float xv[CIN];
  ldhead::load_pixel<false>(x + (size_t)p * CIN, xv);
  // output row 2h of image b is row 2 (b H + h) = 2 (p / W), column 2w
  TOut* run = y + ((size_t)2 * (p / W) * 2 * W + 2 * (p % W)) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v[2][CT];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* tq = taps + (2 * i + j) * CIN * CT;
#pragma unroll
      for (int c = 0; c < CT; ++c) v[j][c] = taps[ldhead::NQ * CIN * CT + c];
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
        for (int c = 0; c < CT; ++c)
          v[j][c] = fmaf(xv[ci], tq[ci * CT + c], v[j][c]);
    }
    ldhead::store_run<CT>(run + (size_t)i * 2 * W * C, C, v);
  }
}

// K9's head backward pass (ldhead::quad_bwd_pass with the quads' gradient
// read from dy). x: (npix, CIN) of type T; dy: (B, 2H, 2W, C) of type
// TOut; weight: the parameter (CIN, C, 2, 2) f32; dx: like x; part: (64 CT
// + CT, gridDim.x) f32. (Two blocks an SM at C <= 4, as K10's pass.)
template <typename T, typename TOut, int CT>
__global__ void __launch_bounds__(ldhead::THREADS, CT <= 4 ? 2 : 1)
    lm_head_bwd_kernel(const T* __restrict__ x, const TOut* __restrict__ dy,
                       const float* __restrict__ weight, T* __restrict__ dx,
                       float* __restrict__ part, int npix, int W, int C) {
  extern __shared__ __align__(16) float sm[];
  ldhead::load_taps<T, true, false>(weight, nullptr, C, sm);
  __syncthreads();
  ldhead::quad_bwd_pass<T, CT>(x, ldhead::OutputGrad<TOut, CT>{dy, W, C}, sm,
                               dx, part, npix);
}

// The columns of `part` added in a fixed order (ldhead::sum_columns).
__global__ void __launch_bounds__(ldhead::THREADS) lm_head_sum_kernel(
    const float* __restrict__ part, int nblk, int C,
    float* __restrict__ dweight, float* __restrict__ dbias) {
  ldhead::sum_columns(part, nblk, C, dweight, dbias);
}

template <typename T, typename TOut, int CT>
int head_fwd(const void* x, const void* weight, const void* bias, void* y,
             int npix, int W, int C, cudaStream_t s) {
  lm_head_fwd_kernel<T, TOut, CT>
      <<<(npix + ldhead::THREADS - 1) / ldhead::THREADS, ldhead::THREADS, 0,
         s>>>(static_cast<const T*>(x), static_cast<const float*>(weight),
              static_cast<const float*>(bias), static_cast<TOut*>(y), npix,
              W, C);
  return (int)cudaGetLastError();
}

template <typename T, typename TOut, int CT>
int head_bwd(const void* x, const void* dy, const void* weight, void* part,
             void* dx, void* dweight, void* dbias, int npix, int W, int C,
             cudaStream_t s) {
  int rc = ldhead::allow_pass_smem(lm_head_bwd_kernel<T, TOut, CT>, CT);
  if (rc) return rc;
  const int nblk = ldhead::pass_blocks(npix);
  float* pt = static_cast<float*>(part);
  lm_head_bwd_kernel<T, TOut, CT>
      <<<nblk, ldhead::THREADS, ldhead::bwd_smem_bytes(CT), s>>>(
          static_cast<const T*>(x), static_cast<const TOut*>(dy),
          static_cast<const float*>(weight), static_cast<T*>(dx), pt, npix, W,
          C);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  lm_head_sum_kernel<<<ldhead::sum_blocks(CT), ldhead::THREADS, 0, s>>>(
      pt, nblk, C, static_cast<float*>(dweight), static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

// The head at CT = lane_pad(C) lanes, forward or backward
#define LD_HEAD_CT(CALL)              \
  switch (ldhead::lane_pad(cout)) {   \
    case 1: return CALL(1);           \
    case 2: return CALL(2);           \
    case 4: return CALL(4);           \
    default: return CALL(8);          \
  }

// The forward on the tensor cores: the transposed convolution of x (the
// small plane, `small` = x) by output parity, bias, one rounding to TOut,
// the moments of the rounded y to the block's row of `part` (2 cout floats
// a block; rows phase by phase) when part is given. wt: (3, 3, cin, cout);
// y: (B, 2H, 2W, cout).
template <typename T, typename TOut>
struct op_k9_fwd : PhaseGeo<T> {
  const T* wt;
  const float* bias;
  TOut* y;
  float* part;
  int cout;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int phase, float* red) const {
    float s0[NT][2], s1[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + tile_row(h);
      if (p >= this->npix) continue;
      const Pix q = pix_of(p, this->npix, this->Hs, this->Ws);
      TOut* yr = y + this->out_pixel(q, p, phase) * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = tile_col(j);
        float f0, f1;
        stf2(yr + n, acc[j][2 * h] + bias[n], acc[j][2 * h + 1] + bias[n + 1],
             f0, f1);
        s0[j][0] += f0;
        s0[j][1] += f1;
        s1[j][0] += f0 * f0;
        s1[j][1] += f1 * f1;
      }
    }
    if (part == nullptr) return;
    fold_channels(s0, red);
    fold_channels(s1, red + cout);
    __syncthreads();
    float* row = moment_row(part, cout);
    for (int c = threadIdx.x; c < 2 * cout; c += MM_THREADS)
      row[c] = warp_sum(red, c);
  }
};

// The input gradient on the tensor cores: the 3x3/s2/p1 convolution of dp
// (the large plane, `large` = dp), rounded once. wt: (3, 3, cout, cin);
// dx: (B, H, W, cin).
template <typename T>
struct op_k9_dx : ConvGeo<T> {
  const T* wt;
  T* dx;
  int cin;

  template <int NT>
  __device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int p0,
                                           int, float*) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + tile_row(h);
      if (p >= this->npix) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float f0, f1;
        stf2(dx + (size_t)p * cin + tile_col(j), acc[j][2 * h],
             acc[j][2 * h + 1], f0, f1);
      }
    }
  }
};

template <typename T, typename TOut>
int lm_fwd(const void* x, const void* wt, const void* bias, void* y,
           void* mom, void* part, int B, int H, int W, int cin, int cout,
           int k, int part_floats, cudaStream_t s) {
  if (k == 2) {
#define LD_FWD(CT) \
  head_fwd<T, TOut, CT>(x, wt, bias, y, B * H * W, W, cout, s)
    LD_HEAD_CT(LD_FWD)
#undef LD_FWD
  }
  op_k9_fwd<T, TOut> op;
  op.small = static_cast<const T*>(x);
  op.npix = B * H * W;
  op.Hs = H;
  op.Ws = W;
  op.CST = cin;
  op.wt = static_cast<const T*>(wt);
  op.bias = static_cast<const float*>(bias);
  op.y = static_cast<TOut*>(y);
  op.cout = cout;
  ldfold::Partials pp(part, part_floats);
  op.part = nullptr;
  if (mom != nullptr) {
    op.part = pp.take(4 * grid_1d(op.npix, MM_BM), 2 * cout,
                      static_cast<float*>(mom));
    if (op.part == nullptr) return (int)cudaErrorInvalidValue;
  }
  const int rc = cin == 128 ? launch_s2_gemm<T, 128, 64>(op, 4, s)
                            : launch_s2_gemm<T, 64, 16>(op, 4, s);
  return rc ? rc : pp.fold<op_k9>(s);
}

// k = 3 (pad 1) takes the two upsamplers, on the tensor cores, with or
// without moments; k = 2 (pad 0) the head: cin = ldhead::CIN, cout 1 to
// ldhead::MAXC, no moments (`mom` the forward's moments or the backward's
// moment cotangent, null or not)
bool bad_geometry(int cin, int cout, int k, int pad, const void* mom) {
  if (k == 2)
    return pad != 0 || cin != CIN || cout < 1 || cout > ldhead::MAXC ||
           mom != nullptr;
  const bool up = (cin == 128 && cout == 64) || (cin == 64 && cout == 16);
  return k != 3 || pad != 1 || !up;
}

// The k = 3 backward's launches, their sums taken from pp.
template <typename T, typename TOut>
int lm_bwd_launch(const void* x, const void* y, const void* dy,
                  const void* dmom, const void* wt, void* scratch, void* dx,
                  void* dweight, void* dbias, int B, int H, int W, int cin,
                  int cout, cudaStream_t s, ldfold::Partials& pp) {
  const long long n = (long long)B * 4 * H * W * cout;
  T* dpt = static_cast<T*>(scratch);
  const T* xt = static_cast<const T*>(x);
  float* dw = static_cast<float*>(dweight);
  int rc = launch_dyv_fold<op_k9>(static_cast<const TOut*>(dy),
                                  static_cast<const TOut*>(y),
                                  static_cast<const float*>(dmom), dpt,
                                  static_cast<float*>(dbias), n, cout, s,
                                  pp);
  if (rc) return rc;
  op_k9_dx<T> op;
  op.large = dpt;
  op.npix = B * H * W;
  op.Hs = H;
  op.Ws = W;
  op.CL = cout;
  op.wt = static_cast<const T*>(wt);
  op.dx = static_cast<T*>(dx);
  op.cin = cin;
  if (cin == 128) {
    rc = launch_s2_gemm<T, 64, 128>(op, 1, s);
    if (rc) return rc;
    return launch_s2_wgrad<T, 128, 64, op_k9>(xt, dpt, dw, B, H, W, cin, cin,
                                              s, pp);
  }
  rc = launch_s2_gemm<T, 16, 64>(op, 1, s);
  if (rc) return rc;
  return launch_s2_wgrad<T, 64, 16, op_k9>(xt, dpt, dw, B, H, W, cin, cin, s,
                                           pp);
}

// dyv fold, input gradient and weight gradient on planes of type T; dy
// and y of type TOut. At k = 2 `wt` is the parameter and `scratch` the
// pass's partial sums (the entries' comments); at k = 3 `part` holds the
// blocks' sums, folded at the end.
template <typename T, typename TOut>
int lm_bwd(const void* x, const void* y, const void* dy, const void* dmom,
           const void* wt, void* scratch, void* dx, void* dweight,
           void* dbias, void* part, int B, int H, int W, int cin, int cout,
           int k, int part_floats, cudaStream_t s) {
  if (k == 2) {
#define LD_BWD(CT)                                                       \
  head_bwd<T, TOut, CT>(x, dy, wt, scratch, dx, dweight, dbias, B * H * W, \
                        W, cout, s)
    LD_HEAD_CT(LD_BWD)
#undef LD_BWD
  }
  ldfold::Partials pp(part, part_floats);
  const int rc = lm_bwd_launch<T, TOut>(x, y, dy, dmom, wt, scratch, dx,
                                        dweight, dbias, B, H, W, cin, cout, s,
                                        pp);
  return rc ? rc : pp.fold<op_k9>(s);
}

}  // namespace

// x: (B, H, W, cin) bf16; y: (B, 2H, 2W, cout) bf16, or f32 when out_f32;
// bias: (cout,) f32. k = 3 (pad 1): (cin, cout) is (128, 64) or (64, 16);
// wt: (3, 3, cin, cout) bf16 [ky][kx][ci][co]; mom: (2, cout) f32, written
// whole (any contents on entry), or null; part: f32 scratch of part_floats
// floats for the blocks' moments (ops/lanemaps.py::lane_maps_partials
// counts them; any contents; unused without mom). k = 2 (pad 0): cin =
// 16, cout 1-8; wt: the parameter (cin, cout, 2, 2) f32 as it lies; mom
// null.
LD_API int ld_lane_maps_op_fwd(const void* x, const void* wt,
                               const void* bias, void* y, void* mom,
                               void* part, int B, int H, int W, int cin,
                               int cout, int k, int pad, int out_f32,
                               int part_floats, void* stream) {
  if (bad_geometry(cin, cout, k, pad, mom)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? lm_fwd<bf16, float>(x, wt, bias, y, mom, part, B, H, W,
                                       cin, cout, k, part_floats, s)
                 : lm_fwd<bf16, bf16>(x, wt, bias, y, mom, part, B, H, W,
                                      cin, cout, k, part_floats, s);
}

// The same on float32 planes (x f32; at k = 3 wt f32); y is f32, and
// out_f32 must be 1.
LD_API int ld_lane_maps_op_fwd_f32(const void* x, const void* wt,
                                   const void* bias, void* y, void* mom,
                                   void* part, int B, int H, int W, int cin,
                                   int cout, int k, int pad, int out_f32,
                                   int part_floats, void* stream) {
  if (bad_geometry(cin, cout, k, pad, mom) || !out_f32)
    return (int)cudaErrorInvalidValue;
  return lm_fwd<float, float>(x, wt, bias, y, mom, part, B, H, W, cin, cout,
                              k, part_floats,
                              static_cast<cudaStream_t>(stream));
}

// x as above; dy: (B, 2H, 2W, cout) bf16, or f32 when out_f32; dx: (B, H,
// W, cin) bf16; dweight: (cin, cout, k, k) f32 and dbias: (cout,) f32,
// written whole (any contents on entry). k = 3: y like dy, read only with
// dmom; dmom: (2, cout) f32 or null; wt: (3, 3, cout, cin) bf16
// [ky][kx][co][ci]; scratch: dp, (B, 2H, 2W, cout) bf16; part: f32
// scratch of part_floats floats for the blocks' sums (ops/lanemaps.py::
// lane_maps_partials counts them; any contents). k = 2: y and dmom null;
// wt: the parameter (cin, cout, 2, 2) f32 as it lies; scratch: the pass's
// partial sums, (65 ct, ceil(B H W / 512)) f32 (ct = cout padded to 1, 2,
// 4 or 8; any contents); part unused (null, 0).
LD_API int ld_lane_maps_op_bwd(const void* x, const void* y, const void* dy,
                               const void* dmom, const void* wt,
                               void* scratch, void* dx, void* dweight,
                               void* dbias, void* part, int B, int H, int W,
                               int cin, int cout, int k, int pad, int out_f32,
                               int part_floats, void* stream) {
  if (bad_geometry(cin, cout, k, pad, dmom))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? lm_bwd<bf16, float>(x, y, dy, dmom, wt, scratch, dx,
                                       dweight, dbias, part, B, H, W, cin,
                                       cout, k, part_floats, s)
                 : lm_bwd<bf16, bf16>(x, y, dy, dmom, wt, scratch, dx,
                                      dweight, dbias, part, B, H, W, cin,
                                      cout, k, part_floats, s);
}

// The same on float32 planes: x, y, dy, dx f32 (at k = 3 wt and dp f32),
// and out_f32 must be 1.
LD_API int ld_lane_maps_op_bwd_f32(const void* x, const void* y,
                                   const void* dy, const void* dmom,
                                   const void* wt, void* scratch, void* dx,
                                   void* dweight, void* dbias, void* part,
                                   int B, int H, int W, int cin, int cout,
                                   int k, int pad, int out_f32,
                                   int part_floats, void* stream) {
  if (bad_geometry(cin, cout, k, pad, dmom) || !out_f32)
    return (int)cudaErrorInvalidValue;
  return lm_bwd<float, float>(x, y, dy, dmom, wt, scratch, dx, dweight,
                              dbias, part, B, H, W, cin, cout, k,
                              part_floats, static_cast<cudaStream_t>(stream));
}
