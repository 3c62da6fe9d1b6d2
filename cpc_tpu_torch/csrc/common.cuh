// Helpers shared by the port's kernels (gru_scan.cu, infonce_fused.cu).
//
// to_f32 / from_f32: wire dtype <-> fp32, rounding to nearest even as
// torch's .to() does.
//
// tile_mm: one 64 x 64 output tile of a product contracted over `depth`
// rows, on 256 threads (16 x 16, each holding 4 x 4 fp32 accumulators),
// staged through shared memory 16 rows at a time. The operands are
// functors a(r, m) and b(r, n) that read one element (and return 0 outside
// the problem), so each kernel states its own layout, offsets and masks.
// kAContigR / kBContigR say along which index an operand is contiguous in
// memory; the staging loop then walks that index fastest across threads,
// so neighbouring threads read neighbouring addresses. This is a plain
// SIMT fp32 product, right first: wgmma, TMA and a multi-stage pipeline are
// later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cpc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kTile = 64;          // output tile edge
constexpr int kDepth = 16;         // contraction rows staged per pass
constexpr int kTileThreads = 256;  // 16 x 16 threads

// Shared staging buffers of one tile_mm; the +1 column keeps both staging
// orders free of bank conflicts.
struct TileSmem {
  float a[kDepth][kTile + 1];
  float b[kDepth][kTile + 1];
};

// acc[i][j] += sum_{r < depth} a(r, ty*4 + i) * b(r, tx*4 + j), with
// tx = threadIdx.x % 16, ty = threadIdx.x / 16. Every thread of the block
// must call it (it synchronises).
template <bool kAContigR, bool kBContigR, class A, class B>
__device__ __forceinline__ void tile_mm(int depth, const A& a, const B& b,
                                        float (&acc)[4][4], TileSmem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int r0 = 0; r0 < depth; r0 += kDepth) {
#pragma unroll
    for (int e = tid; e < kDepth * kTile; e += kTileThreads) {
      const int ra = kAContigR ? e % kDepth : e / kTile;
      const int ma = kAContigR ? e / kDepth : e % kTile;
      s.a[ra][ma] = (r0 + ra < depth) ? a(r0 + ra, ma) : 0.f;
      const int rb = kBContigR ? e % kDepth : e / kTile;
      const int nb = kBContigR ? e / kDepth : e % kTile;
      s.b[rb][nb] = (r0 + rb < depth) ? b(r0 + rb, nb) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = s.a[r][ty * 4 + i];
        bv[i] = s.b[r][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace cpc
