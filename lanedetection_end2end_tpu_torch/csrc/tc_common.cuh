// Tensor-core and copy primitives shared by the float32 3-tap tiles
// (conv3tap_f32.cuh: K6, K7, K11) and the stride-2 tiles (conv_s2_mma.cuh:
// K8, K9): asynchronous 16-byte copies into shared memory, the 3xTF32
// split of an f32 operand, and the warp-level mma.sync products with the
// ldmatrix loads of their bf16 fragments.
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

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
// (src-size 0: nothing is read; src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
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

}  // namespace ldtc
