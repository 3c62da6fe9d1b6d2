// Helpers shared by the port's kernels (gru_scan.cu, infonce_fused.cu,
// infonce_same_step.cu, infonce_allsteps.cu).
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
//
// score_tile: the 64 x 64 tile of scores rows . cols^T contracted over D,
// through tile_mm; the three InfoNCE sources state their layouts as functors
// that give a row's or a column's pointer (nullptr outside the problem).
//
// RowStats: the running softmax statistics (max, sum, positive score, first
// argmax) of the rows a thread holds, folded in tile by tile over a sweep
// of column tiles; TileRowStats is its form for tile_mm's thread layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

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

// acc[i][j] = row(ty*4 + i) . col(tx*4 + j) over D elements of type T.
// row(m) and col(n) return the vector's pointer, or nullptr for a zero
// vector (outside the problem).
template <typename T, class RowPtr, class ColPtr>
__device__ __forceinline__ void score_tile(const RowPtr& row,
                                           const ColPtr& col, int D,
                                           float (&acc)[4][4], TileSmem& s) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  tile_mm<true, true>(
      D,
      [&](int d, int m) -> float {
        const T* q = row(m);
        return q ? to_f32(q[d]) : 0.f;
      },
      [&](int d, int n) -> float {
        const T* q = col(n);
        return q ? to_f32(q[d]) : 0.f;
      },
      acc, s);
}

// x rounded to the wire dtype and back: what a product sees of an fp32
// value that crosses it as an operand of type T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Running softmax statistics of the kRows rows a thread holds in a score
// tile. The kLanes threads that share a row (neighbouring lanes of one
// warp, aligned to kLanes) share max, best and best_c; each keeps its own
// part of the sum l and of the positive score s_lab, which finish() adds up
// in a fixed order. Ties of the argmax go to the lowest column: within a
// tile by the compares below, across tiles because a later tile must be
// strictly greater.
template <int kRows, int kLanes>
struct RowStats {
  float m[kRows], l[kRows], s_lab[kRows], best[kRows];
  int best_c[kRows];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = best[i] = -INFINITY;
      l[i] = s_lab[i] = 0.f;
      best_c[i] = 0;
    }
  }

  // Folds into row i the scores s of this thread at columns col, ascending;
  // columns >= n_cols are outside the problem; label is the row's positive
  // column. Every thread of the warp must call it, and the kLanes threads
  // of the row must hold at least one column < n_cols between them.
  template <int kVals>
  __device__ __forceinline__ void update_row(int i, const float (&s_in)[kVals],
                                             const int (&col)[kVals],
                                             int n_cols, int label) {
    float s[kVals], tmax = -INFINITY;
    int targ = INT_MAX;
#pragma unroll
    for (int j = 0; j < kVals; ++j) {
      s[j] = col[j] < n_cols ? s_in[j] : -INFINITY;
      if (s[j] > tmax) {
        tmax = s[j];
        targ = col[j];
      }
      if (col[j] == label) s_lab[i] += s_in[j];
    }
#pragma unroll
    for (int off = kLanes / 2; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, tmax, off);
      const int oc = __shfl_xor_sync(0xffffffffu, targ, off);
      if (ov > tmax || (ov == tmax && oc < targ)) {
        tmax = ov;
        targ = oc;
      }
    }
    if (tmax > best[i]) {
      best[i] = tmax;
      best_c[i] = targ;
    }
    const float m_new = fmaxf(m[i], tmax);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kVals; ++j) sum += expf(s[j] - m_new);
    l[i] = l[i] * expf(m[i] - m_new) + sum;
    m[i] = m_new;
  }

  // After the sweep: l and s_lab summed over the row's threads; every
  // thread of the row then holds the row's totals.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int off = kLanes / 2; off >= 1; off >>= 1) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
        s_lab[i] += __shfl_xor_sync(0xffffffffu, s_lab[i], off);
      }
  }

  __device__ __forceinline__ float lse(int i) const {
    return m[i] + logf(l[i]);
  }
};

// The statistics of tile_mm's thread layout: rows ty*4 + i, and the 16
// threads tx = 0..15 of a row hold 4 neighbouring columns each.
struct TileRowStats : RowStats<4, 16> {
  // Folds in the tile at columns [c0, c0 + 64) of n_cols; label[i] is the
  // positive column of row i. c0 < n_cols.
  __device__ __forceinline__ void update(const float (&acc)[4][4], int c0,
                                         int n_cols, const int (&label)[4]) {
    const int cbase = c0 + (threadIdx.x % 16) * 4;
    const int col[4] = {cbase, cbase + 1, cbase + 2, cbase + 3};
#pragma unroll
    for (int i = 0; i < 4; ++i) update_row(i, acc[i], col, n_cols, label[i]);
  }
};

}  // namespace cpc
