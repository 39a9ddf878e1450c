// Fixed-order sums across blocks: how the training kernels (K6-K9 and
// K11, in bf16 and in float32) sum their weight gradients, bias gradients
// and moments, and K12 its moments, with no atomics, so that those sums
// reproduce themselves bit for bit from launch to launch.
//
// A kernel whose blocks each hold a partial sum of the same outputs writes
// them, block b to row b of a partials buffer (rows x entries f32, `part +
// b * entries`), in an order fixed inside the block (lanes by xor
// shuffles, warps in warp order through shared memory, never shared-memory
// atomics). The block partition is fixed by the shape alone. One launch of
// `fold_rows_kernel` then adds the rows of every partials buffer an entry
// point queued (a `Partials` plan, up to MAX_SEGS buffers), each entry in
// this order:
//
//   G = row_groups(rows, entries), a power of two;
//   s[g] = sum over rows b = g, g + G, g + 2G, ... in ascending order of
//          part[b][e]                                   (g = 0 .. G-1)
//   then for h = G/2, G/4, .., 1: s[g] = s[g] + s[g + h] for g < h;
//   out[e] = s[0]
//
// (thread (g, e) of a block adds its rows in turn, at most about four, or
// sixteen in a segment of many entries; the G sums meet in a pairwise
// tree in shared memory). ops/fold.py
// writes the same order in PyTorch, and the CPU tests hold it there.
//
// The fold is a programmatic dependent launch (Hopper): it may start
// while the entry point's last kernel runs and waits in
// `griddepcontrol.wait` until that grid has finished and its writes are
// visible. The entry point's earlier kernels finished before its last one
// started (plain stream order), so one fold at the end of an entry point
// adds the partials of all its launches. Bound: the partials' bytes, read
// once, from L2 where they were just written.
#pragma once

#include "common.cuh"

namespace ldfold {

constexpr int THREADS = 256;
constexpr int MAX_SEGS = 6;

// The row groups of a fold over `rows` rows of `entries` entries: the
// least power of two that leaves a thread at most four rows, at most
// THREADS (a block folds THREADS / row_groups entries). A segment of at
// least WIDE_ENTRIES entries has blocks enough to fill the card: there a
// thread takes up to sixteen rows (four loads in flight at a time) and a
// block at least 8 entries of a row (whole 32-byte sectors), so that
// fewer blocks read the same bytes.
constexpr int WIDE_ENTRIES = 1024;
__host__ __device__ __forceinline__ int row_groups(int rows, int entries) {
  const bool wide = entries >= WIDE_ENTRIES;
  const int per = wide ? (rows + 15) / 16 : (rows + 3) / 4;
  const int most = wide ? 32 : THREADS;
  int g = 1;
  while (g < per && g < most) g *= 2;
  return g;
}

// rows x entries partial sums at part (row b at part + b * entries), whose
// fold goes to out[0 .. entries)
struct Seg {
  const float* part;
  float* out;
  int rows, entries;
};

struct Plan {
  Seg seg[MAX_SEGS];
  int first[MAX_SEGS + 1];  // the first block of each segment's fold
  int n;
};

// `Tag` names the op in a profile (the op tags of conv_s2.cuh, ...).
template <class Tag>
__global__ void __launch_bounds__(THREADS)
    fold_rows_kernel(const __grid_constant__ Plan plan) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float red[THREADS];
  int s = 0;
  while (s + 1 < plan.n && (int)blockIdx.x >= plan.first[s + 1]) ++s;
  const Seg& sg = plan.seg[s];
  const int ng = row_groups(sg.rows, sg.entries), ep = THREADS / ng;
  const int g = threadIdx.x / ep;
  const int e = ((int)blockIdx.x - plan.first[s]) * ep + threadIdx.x % ep;
  float a = 0.0f;
  if (e < sg.entries) {
#pragma unroll 4
    for (int b = g; b < sg.rows; b += ng)
      a += __ldcg(sg.part + (size_t)b * sg.entries + e);
  }
  red[threadIdx.x] = a;
  __syncthreads();
  for (int h = ng / 2; h > 0; h /= 2) {
    if (g < h) red[threadIdx.x] += red[threadIdx.x + h * ep];
    __syncthreads();
  }
  if (g == 0 && e < sg.entries) sg.out[e] = red[threadIdx.x];
}

// The partials of one entry point's launches: a scratch buffer handed out
// in turn (`take`), and the plan of their fold, launched once at the end
// (`fold`).
struct Partials {
  float* base;     // the scratch, `cap` floats (any contents)
  long long cap;
  long long used = 0;
  Plan plan = {};

  Partials(void* scratch, long long floats)
      : base(static_cast<float*>(scratch)), cap(floats) {}

  // rows x entries floats of the scratch, whose fold goes to out; null
  // when the scratch or the plan is full
  float* take(int rows, int entries, float* out) {
    const long long n = (long long)rows * entries;
    if (base == nullptr || used + n > cap || plan.n == MAX_SEGS ||
        rows < 1 || entries < 1)
      return nullptr;
    float* p = base + used;
    used += n;
    plan.seg[plan.n++] = {p, out, rows, entries};
    return p;
  }

  // n floats of the scratch that no fold reads (a launch's own operands,
  // such as the split tap matrices of conv3tap_f32.cuh); null when the
  // scratch is full. Every earlier request was a multiple of 4 floats, so
  // the floats start on a 16-byte boundary of the scratch.
  float* space(long long n) {
    if (base == nullptr || used + n > cap || n < 1 || used % 4 != 0)
      return nullptr;
    float* p = base + used;
    used += n;
    return p;
  }

  // one launch that folds every buffer taken, as a programmatic dependent
  // of the last kernel on `s`; nothing when none was taken
  template <class Tag>
  int fold(cudaStream_t s) {
    int blocks = 0;
    for (int i = 0; i < plan.n; ++i) {
      plan.first[i] = blocks;
      blocks += grid_1d(plan.seg[i].entries,
                        THREADS / row_groups(plan.seg[i].rows,
                                             plan.seg[i].entries));
    }
    plan.first[plan.n] = blocks;
    if (blocks == 0) return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = s;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, fold_rows_kernel<Tag>, plan);
  }
};

}  // namespace ldfold
