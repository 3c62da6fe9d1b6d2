// Hopper (sm_90a) primitives shared by the port's TMA + wgmma kernels
// (infonce_allsteps.cu, conv_pyramid.cu), as thin wrappers over PTX.
//
// mbarriers: init, arrive (release), arrive with expected transaction
// bytes, a parity wait that the whole warp leaves together.
// TMA: cp.async.bulk.tensor loads of a 2-D or 3-D box into shared memory,
// completing an mbarrier's transactions; the map comes from
// cuTensorMapEncodeTiled, which `tensor_map_encoder` fetches from the
// driver through the runtime (no -lcuda; <cuda.h> for the types).
// setmaxnreg: a warpgroup hands registers to another.
// stmatrix: four 8 x 8 bf16 matrices from registers to shared memory.
// wgmma: fence, commit, wait; the shared-memory descriptors of a
// 128-byte-swizzled operand (desc_sw128) and of an operand without swizzle
// (desc_plain); m64n128k16 and m64n64k16 products, bf16 in, fp32 sums.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace cpc {

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   cpc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrives on the barrier (release: the thread's writes before it are
// visible to a thread whose wait sees the phase complete).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          cpc::smem_addr(bar))
      : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1;\n}\n" ::"r"(cpc::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at (c0 along D, c1 along the vectors) of the 2-D map into
// shared memory at dst (1 024-byte aligned), zero-filled outside the
// tensor; completes `bar`'s transactions.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(cpc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(cpc::smem_addr(bar))
      : "memory");
}

// Waits until the phase of parity `parity` has completed; every lane of the
// warp calls it, and leaves it together (wgmma wants the warp converged).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = cpc::smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
  __syncwarp();
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Makes this thread's writes to shared memory visible to wgmma's reads
// (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending groups of this warpgroup's wgmma are in
// flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pins the registers in place around asynchronous wgmma: the compiler
// neither reads them before the wait nor moves writes past the issue.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The descriptor of a 128-byte-swizzled operand at shared address `saddr`
// (an atom of 8 vectors x 128 bytes, 1 024-byte aligned, or 32-byte steps
// into one along K). Both byte offsets are 1 024: the stride between 8-vector
// groups, K-major, and between 8-deep groups of K, MN-major; the other
// offset is unused at a width of one panel.
__device__ __forceinline__ uint64_t desc_sw128(unsigned saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (m64 x n128, fp32) = (scale_d ? d : 0) + A . B over 16 of K; A and B
// K-major in shared memory (descriptors a, b).
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64 x n64, fp32) = (scale_d ? d : 0) + A . B over 16 of K; A and B
// K-major in shared memory (descriptors a, b).
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64 x n64, fp32) = (scale_d ? d : 0) + A . B over 16 of K; A in
// registers (the m16n8k16 A fragment of the thread's warp, rows 16 x warp),
// B MN-major in shared memory (descriptor b).
__device__ __forceinline__ void wgmma_m64n64_rs_mn(float (&d)[32],
                                                     const unsigned (&a)[4],
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const unsigned a = cpc::smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// TMA: the box at (c0, c1, c2) of the 3-D map into shared memory at dst
// (1 024-byte aligned with a 128-byte swizzle), zero-filled outside the
// tensor (negative coordinates included); completes `bar`'s transactions.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(cpc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(cpc::smem_addr(bar))
      : "memory");
}

// The descriptor of a K-major operand without swizzle at shared address
// `saddr` (16-byte aligned): core matrices of 8 rows x 16 bytes, a row's
// 16 bytes contiguous; `k_stride` bytes between the two core matrices of a
// k16 step along K (the leading byte offset), 128 between 8-row groups
// along M (the stride byte offset), so that rows are 16 bytes apart and an
// operand may start at any row.
__device__ __forceinline__ uint64_t desc_plain(unsigned saddr,
                                               unsigned k_stride) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((k_stride & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// Four 8 x 8 bf16 matrices from registers to shared memory, the inverse of
// ldmatrix_x4 (mma.cuh): lanes 8j..8j+7 give the addresses (16-byte
// aligned) of the 8 rows of matrix j, and register j of every thread holds
// its share of matrix j (row lane / 4, columns 2 (lane % 4), +1).
__device__ __forceinline__ void stmatrix_x4(unsigned saddr,
                                            const unsigned (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(saddr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Sets *encode to cuTensorMapEncodeTiled (fetched once); returns 0 or a
// cudaError_t.
inline int tensor_map_encoder(EncodeTiled* encode) {
  static EncodeTiled fn_cached = nullptr;
  if (fn_cached == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    fn_cached = reinterpret_cast<EncodeTiled>(fn);
  }
  *encode = fn_cached;
  return 0;
}

}  // namespace cpc
