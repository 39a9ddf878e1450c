// Tensor-core and copy primitives shared by the 3-tap tiles (conv3tap.cuh,
// wgrad3tap.cuh in bf16, conv3tap_f32.cuh in float32: K6, K7, K11), the
// stride-2 tiles (conv_s2_mma.cuh: K8, K9) and the NB1D row tile
// (nb1d.cuh): asynchronous 16- and 4-byte copies into shared memory
// (deferred in a debug build, see below), the 3xTF32 split of an f32
// operand, the warp-level mma.sync products with the ldmatrix loads of
// their bf16 fragments, and the fences and waits of wgmma.
//
// Fragments of one warp's m16 x n8 product (thread (g, tg) = (lane / 4,
// lane % 4)): the accumulator c[2h + e] is row g + 8h, column 2tg + e. TF32
// (k8): a[0..3] = a[g][tg], a[g+8][tg], a[g][tg+4], a[g+8][tg+4]; b[0..1] =
// b[tg][g], b[tg+4][g]. bf16 (k16): each register holds two k-neighbours,
// a[0..3] = a[g][2tg..], a[g+8][2tg..], a[g][2tg+8..], a[g+8][2tg+8..];
// b[0..1] = b[2tg..][g], b[2tg+8..][g].
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace ldtc {

// ---- bulk copies (TMA) on an mbarrier ------------------------------------
//
// A 1-D bulk copy moves `bytes` contiguous bytes from global to shared
// memory through the Tensor Memory Accelerator and reports them to a
// shared-memory mbarrier (complete_tx). Source and destination 16-byte
// aligned, bytes a multiple of 16. One thread arms the barrier with the
// bytes its phase waits for (`mbar_expect`), issues the copies, and every
// thread that reads the data waits for the phase (`mbar_wait`); a phase
// that carries no copy completes on the arrival alone (`mbar_arrive`).
// (These copies are not deferred by the debug build below.)

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
}

// the inits visible to the async proxy (then a __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on `bar` and add `bytes` to the transactions its phase awaits
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

#ifndef LD_DEFER_CP_ASYNC

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
// (src-size 0: nothing is read; src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, or 4 zero bytes where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#else  // LD_DEFER_CP_ASYNC

// The deferred-copy debug build (-DLD_DEFER_CP_ASYNC, ops/_build.py's
// "defer" variant). It makes the contract of cp.async literal: a copy's
// data is in shared memory only after its group's wait. An issue writes
// poison (all bits set: NaN as f32 and as bf16) into the destination at
// once and queues the copy in this thread's queue; a commit closes a
// group; wait<N> performs, in issue order, the copies of every committed
// group but the N newest. A read of a stage before its wait so reads NaN
// every time, where the hardware's copy has usually landed. The queue
// lives in global memory, one per thread of the launch (a fresh launch,
// told by %gridid, starts it empty); a full queue or a thread past
// DEFER_THREADS traps, no copy is ever dropped. Sources are read through
// L2 (ld.global.cg), as cp.async.cg reads them.
namespace defer {

constexpr int DEPTH = 64;  // copies in flight a thread
// threads a launch: the train step's largest grids at 256x512, batch 8
// (K8's dx and K9's forward, 4 parity phases on the 64x128 plane)
constexpr long long DEFER_THREADS = 1 << 19;

struct Copy {
  unsigned long long src;
  unsigned dst;   // shared-memory address
  unsigned meta;  // group << 8 | zero-fill << 7 | bytes
};
struct Queue {
  unsigned long long grid;  // %gridid of the launch that owns the queue
  int head, tail;           // copies issued / performed so far
  int groups;               // groups committed so far
  int pad;
  Copy c[DEPTH];
};
__device__ Queue queues[DEFER_THREADS];

__device__ __forceinline__ Queue& mine() {
  const unsigned long long block =
      blockIdx.x + (unsigned long long)gridDim.x *
                       (blockIdx.y + (unsigned long long)gridDim.y *
                                         blockIdx.z);
  const unsigned long long t =
      block * (blockDim.x * blockDim.y * blockDim.z) + threadIdx.x +
      blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  if (t >= (unsigned long long)DEFER_THREADS) __trap();
  Queue& q = queues[t];
  unsigned long long grid;
  asm volatile("mov.u64 %0, %%gridid;\n" : "=l"(grid));
  if (q.grid != grid) {
    q.grid = grid;
    q.head = q.tail = q.groups = 0;
  }
  return q;
}

__device__ __forceinline__ void store16(unsigned s, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(s),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void store4(unsigned s, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(s), "r"(v) : "memory");
}

__device__ __forceinline__ void issue(void* dst, const void* src, int bytes,
                                      bool valid) {
  Queue& q = mine();
  if (q.tail - q.head >= DEPTH || q.groups >= (1 << 24)) __trap();
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  Copy& c = q.c[q.tail % DEPTH];
  c.src = (unsigned long long)src;
  c.dst = s;
  c.meta = (unsigned)q.groups << 8 | (valid ? 0u : 128u) | (unsigned)bytes;
  ++q.tail;
  if (bytes == 16)
    store16(s, make_uint4(~0u, ~0u, ~0u, ~0u));
  else
    store4(s, ~0u);
}

__device__ __forceinline__ void perform(const Copy& c) {
  const bool zero = c.meta & 128u;
  if ((c.meta & 127u) == 16)
    store16(c.dst, zero ? make_uint4(0u, 0u, 0u, 0u)
                        : __ldcg(reinterpret_cast<const uint4*>(c.src)));
  else
    store4(c.dst, zero ? 0u : __ldcg(reinterpret_cast<const unsigned*>(c.src)));
}

}  // namespace defer

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  defer::issue(dst, src, 16, valid);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  defer::issue(dst, src, 4, valid);
}

__device__ __forceinline__ void cp_async_commit() { ++defer::mine().groups; }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  defer::Queue& q = defer::mine();
  while (q.head < q.tail) {
    const defer::Copy c = q.c[q.head % defer::DEPTH];
    if ((int)(c.meta >> 8) >= q.groups - N) break;
    defer::perform(c);
    ++q.head;
  }
}

#endif  // LD_DEFER_CP_ASYNC

// a = hi + lo, both TF32 (round to nearest, ties away). The low 13 bits of
// a cvt's result are unspecified, so hi is masked before the subtraction,
// which is then exact.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  hi &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
}

// c += a @ b on one 16 x 8 x 8 TF32 tile of one warp (f32 accumulation)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a @ b on one 16 x 8 x 16 bf16 tile of one warp (f32 accumulation)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i gets
// matrix i's row lane / 4, elements 2 (lane % 4) and + 1, or with .trans
// its column lane / 4, rows 2 (lane % 4) and + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// ---- wgmma (sm_90a) ----

// Shared-memory writes of the generic proxy (stores, and cp.async copies
// once waited for) become visible to wgmma, which reads its shared-memory
// operands through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an in-flight wgmma reads or writes, pinned at this point: the
// compiler may neither reuse them nor read them before the wait above.
template <int K>
__device__ __forceinline__ void keep(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void keep(uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}


}  // namespace ldtc
