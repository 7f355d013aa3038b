// Double-precision products on Hopper's FP64 tensor cores (DMMA) through
// `mma.sync`, and the cp.async copies that feed them: the building block
// of the float64 forms of K1 (kmeans_accumulate.cu's DMMA assignment)
// and K2 (gram_dmma.cuh's Gram).
//
// The f64 `mma.sync` shapes (PTX ISA; CuTe's SM80_8x8x4_F64F64F64F64_TN
// and SM90_16x8x{4,8,16}_F64F64F64F64_TN name the same layouts):
//   m8n8k4   (sm_80 on)  A 8x4 one double a thread, B 4x8 one, C 8x8 two;
//   m16n8k4  (sm_90)     A 16x4 two, B 4x8 one, C 16x8 four;
//   m16n8k8  (sm_90)     A 16x8 four, B 8x8 two, C 16x8 four;
//   m16n8k16 (sm_90)     A 16x16 eight, B 16x8 four, C 16x8 four.
// With g = lane / 4 and t = lane % 4, every shape keeps the accumulator
// of the 8x8 quarter q (rows 8q + g) in c[2q], c[2q + 1] at columns
// 2t, 2t + 1, reads A's element (8h + g, 4s + t) from register 2s + h
// and B's element (4s + t, g) from register s.  So a warp's operands
// can be loaded once as "m8 fragments", one double a thread per 8 rows
// (or 8 columns) and 4 of depth, and any shape consumes them: `mma16x8`
// below takes a shape's depth steps of a 16 x 8 output at once.
//
// Each instruction sums its products in the tensor core's own fixed
// order, so a product's bits depend on the shape and the depth order
// and on nothing else: two launches give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dmma {

// The depth the kernels' products take: m16n8k4.  On an H100 the three
// sm_90 shapes run at the FP64 tensor cores' full rate and m8n8k4 at
// half of it; in the kernels m16n8k4 beat m16n8k8
// (tools/dmma_probe.py measures each shape).
constexpr int KU = 4;

__device__ __forceinline__ void mma_m8n8k4(double& c0, double& c1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void mma_m16n8k4(double (&c)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

__device__ __forceinline__ void mma_m16n8k8(double (&c)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void mma_m16n8k16(double (&c)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// c (a 16 x 8 output, rows 8q + g in c[2q], c[2q + 1]) += A B over
// SHAPE_KU of depth (4, 8 or 16; 0: 4 by two m8n8k4): a[2s + h] is the m8
// fragment of rows 8h.. at depth step s, b[s] B's at step s.
template <int SHAPE_KU = KU>
__device__ __forceinline__ void mma16x8(double (&c)[4], const double* a, const double* b) {
  if constexpr (SHAPE_KU == 0) {
    mma_m8n8k4(c[0], c[1], a[0], b[0]);
    mma_m8n8k4(c[2], c[3], a[1], b[0]);
  } else if constexpr (SHAPE_KU == 4) {
    mma_m16n8k4(c, a, b);
  } else if constexpr (SHAPE_KU == 8) {
    mma_m16n8k8(c, a, b);
  } else {
    static_assert(SHAPE_KU == 16, "SHAPE_KU is 0, 4, 8 or 16");
    mma_m16n8k16(c, a, b);
  }
}

// -- cp.async: global to shared, zero-filled where the source is not valid

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC doubles (1 or 2) from src to shared dst, or zeros when !valid
// (src is then not read).
template <int VEC>
__device__ __forceinline__ void copy_async(double* dst, const double* src, bool valid) {
  const int bytes = valid ? 8 * VEC : 0;
  if constexpr (VEC == 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace dmma
