// Tensor-core and asynchronous-copy primitives for the port's kernels, as
// thin wrappers over PTX (sm_80 and later; built here for sm_90a).
//
// mma_bf16: D (16 x 8, fp32) += A (16 x 16, bf16, row-major) * B (16 x 8,
// bf16, "col": k contiguous for each n), one warp, operands in registers.
// With g = lane / 4 and q = lane % 4 a thread holds
//   A: a[0] = A[g][2q, 2q+1], a[1] = A[g+8][2q, 2q+1],
//      a[2] = A[g][2q+8, 2q+9], a[3] = A[g+8][2q+8, 2q+9]
//   B: b0 = B[2q, 2q+1][g], b1 = B[2q+8, 2q+9][g]
//   D: d[0], d[1] = D[g][2q, 2q+1], d[2], d[3] = D[g+8][2q, 2q+1]
// each 32-bit register packing two bf16, the lower index in the low half.
//
// ldmatrix_x4 / ldmatrix_x4_trans: four 8 x 8 bf16 matrices from shared
// memory; lanes 8j..8j+7 give the addresses (16-byte aligned) of the 8 rows
// of matrix j, and register j of every thread receives its share of matrix
// j in the layout above (row g, columns 2q, 2q+1), transposed for _trans.
//
// cp_async16: 16 bytes from global to shared memory without passing through
// registers; `bytes` (0 or 16) of them are read and the rest zero-filled.
// Both addresses 16-byte aligned. cp_async_commit closes a group of copies;
// cp_async_wait<N> waits until at most N groups are still in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cpc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Two floats as one register of two bf16, `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace cpc
