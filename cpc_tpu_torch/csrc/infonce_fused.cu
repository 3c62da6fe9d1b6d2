// Fused prediction heads + same-step InfoNCE, forward and backward, for
// Hopper (sm_90a), bound to Python with ctypes
// (cpc_tpu_torch/ops/infonce_fused.py; built by cpc_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of cpc_tpu/ops/infonce_fused.py: `_fwd_kernel`
// (launched by `_pallas_fwd`) and `_bwd_kernel` (launched by `_bwd_rule`).
// The heads product p = c_tm @ W, and the folds of dp into dc and dW, stay
// plain matrix products outside, as the JAX package leaves them to XLA.
//
// Inputs: p (T, B, K*D) and z (T, C, D) in the wire dtype (bf16 or fp32),
// and `shift`. For target step tau and head k, the prediction rows are
// p[t, :, kD:(k+1)D] with t = clamp(tau-1-k, 0, T-1), as the Pallas index map
// clamps; they score against the C candidates z[tau] in fp32. Row b's
// positive is column shift + b; argmax ties go to the first maximum, as
// jnp.argmax. Outputs are tau-indexed, flat row r = k*B + b:
//
// FORWARD: nll, correct and the row log-sum-exp lse, each (T, K*B) fp32.
// Rows outside the window (tau = 0, t >= T-K) are computed on the clamped
// block and masked by the caller, as in the JAX package.
//
// BACKWARD, given g_nll (T, K*B) fp32 and the forward's lse:
//   delta[tau, r, c] = (exp(s - lse) - onehot) * g_nll * valid(tau, k),
//   valid = 0 <= tau-1-k < T-K;
//   dz[tau] = sum_k delta[tau, k]^T p_k        (T, C, D) fp32
//   dp_k[tau] = delta[tau, k] z[tau]           (K, T, B, D) in p's dtype
// Using the saved lse, softmax is one exp per score, with no second sweep
// over the columns for the max and sum. Out-of-window rows get delta = 0, so
// their dp is exact zeros, as the Pallas validity mask makes it.
//
// What bounds the pair on this card: bytes. At tpu_fast (T = 128, B = C =
// 64, K = 12, D = 512) p is 100.7 MB of bf16 and z 8.4 MB, 0.033 ms at
// 3.35 TB/s for the forward and twice that for the backward, against 6.4
// GFLOP of scores: 0.0065 ms at the bf16 tensor-core peak.
//
// Two routes, named by `heads_route` in the wrapper; neither gives way to
// the other, and a route that cannot launch returns an error.
//
// "simt" (the fp32 wire, the parity configuration, and bf16 shapes that
// 16-byte copies do not fit): every product on the fp32 SIMT pipe through
// cpc::tile_mm. The forward is one block per (tau, k, 64-row tile); the
// backward is three launches with an fp32 scratch of delta (T*K*B*C floats):
// heads_delta_kernel (recomputes the scores, writes delta),
// heads_dz_kernel (per (tau, C tile, D tile), contracts over the K*B rows)
// and heads_dp_kernel (per (tau, k, B tile, D tile), contracts over C).
//
// "mma" (bf16 inputs, D % 8 == 0, 16-byte aligned operands: the training
// path): mma.sync m16n8k16 with fp32 sums, operands staged by cp.async
// through a ring of kStages slabs (a slab: the 64-deep slice of D of the
// block's 128 rows and of one 64-column tile of z[tau]). A block is 8 warps;
// warp w owns rows 16w..16w+15 of the block's 128, whatever head they are:
// rows are addressed one pointer each, so B = 16 wastes no fragment.
//   heads_fwd_mma_kernel: one block per (tau, 128 flat rows of K*B), the
//   blocks of one tau next to each other. z[tau]'s tile is staged once for
//   all the heads of the block; C is swept in 64-column tiles (only the
//   16-column groups that hold candidates are multiplied), so C is
//   unbounded. The running max, sum, positive score and first argmax of a
//   row stay in the registers of its quad (cpc::RowStats, quad shuffles).
//   Each slab's product is summed from zero and added to the row's scores.
//   At tpu_fast: 768 blocks, two an SM, three slabs (72 KB) in flight each.
//   heads_bwd_mma_kernel: ONE launch, no scratch. One block per (tau, chunk
//   of kHalves x 64 columns of D), the chunk-blocks of one tau next to each
//   other, so the second read of p comes from L2. For each group of 128
//   rows the block recomputes the scores over the whole of D, forms delta in
//   registers, then for each 64-wide half of its chunk: dp = delta z[tau]
//   (delta as the A fragments of the scores' registers; z's slab read
//   transposed by ldmatrix), stored at once, head by head; and dz[tau][:,
//   half] += delta^T p (delta parked once in shared memory and read back
//   transposed by ldmatrix, p's slab transposed). dz's accumulator stays in
//   the registers of the block that owns it (C <= 64), or, for C > 64, is
//   added into dz in global memory by its one owner thread in a fixed
//   order. No sum crosses blocks: no atomics, the same bits every run.
//   delta is fp32, as the TPU kernel keeps it; it enters each product as
//   kTerms = 3 bf16 terms, each the rounding of what the terms before it
//   left, so a term is off by about 2^-26 of itself. One bf16 rounding
//   (2^-9) is a different result; two terms (2^-18) flip the bf16 rounding
//   of dp, and of dz on its way into the encoder, 6-7x as often as fp32
//   sums do, and move a tpu_fast step's grad_norm 1.8e-5 from plain
//   (chip_smoke.py phase 5 holds the flip shares). p and z are bf16 on the
//   wire, so their side is exact. Each product is summed from zero (over 64
//   columns for dp, 128 rows for dz) and joins its running sum by an
//   ordinary add: the tensor core's adder truncates (ROADMAP C4).
//   At tpu_fast with kHalves = 4: 256 blocks, one an SM (176 KB of shared
//   memory). The scores are recomputed D / 256 = 2 times: 12.9 GFLOP, and
//   dp and dz 19.3 each with three terms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "mma.cuh"

namespace {

using cpc::from_f32;
using cpc::kTile;
using cpc::kTileThreads;
using cpc::TileSmem;
using cpc::tile_mm;
using cpc::to_f32;

// The scores of one (tau, k, row tile) against columns [c0, c0 + 64):
// acc[i][j] = p[t, b0 + ty*4 + i, kD:(k+1)D] . z[tau, c0 + tx*4 + j].
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ p_blk,
                                           const T* __restrict__ z_blk,
                                           size_t kd, int b0, int batch,
                                           int c0, int pool, int D,
                                           float (&acc)[4][4], TileSmem& s) {
  cpc::score_tile<T>(
      [&](int m) -> const T* {
        const int b = b0 + m;
        return b < batch ? p_blk + static_cast<size_t>(b) * kd : nullptr;
      },
      [&](int n) -> const T* {
        const int c = c0 + n;
        return c < pool ? z_blk + static_cast<size_t>(c) * D : nullptr;
      },
      D, acc, s);
}

// ---------------------------------------------------------------------
// The SIMT route (source note above).

// Grid (T*K, ceil(B / 64)); block kTileThreads.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    heads_nll_fwd_kernel(const T* __restrict__ p, const T* __restrict__ z,
                         float* __restrict__ nll, float* __restrict__ cor,
                         float* __restrict__ lse, int steps, int batch,
                         int pool, int K, int D, int shift) {
  __shared__ TileSmem smem;
  __shared__ float ss[kTile][kTile + 1];
  const int tau = blockIdx.x / K, k = blockIdx.x % K;
  const int b0 = blockIdx.y * kTile;
  int t = tau - 1 - k;
  t = t < 0 ? 0 : (t > steps - 1 ? steps - 1 : t);
  const size_t kd = static_cast<size_t>(K) * D;
  const T* p_blk = p + static_cast<size_t>(t) * batch * kd +
                   static_cast<size_t>(k) * D;
  const T* z_blk = z + static_cast<size_t>(tau) * pool * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row = threadIdx.x;
  const int b = b0 + row;
  const bool owner = row < kTile && b < batch;
  const int label = shift + b;

  float m = -INFINITY, l = 0.f, s_lab = 0.f, best = -INFINITY;
  int best_c = 0;
  for (int c0 = 0; c0 < pool; c0 += kTile) {
    float acc[4][4];
    score_tile(p_blk, z_blk, kd, b0, batch, c0, pool, D, acc, smem);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ss[ty * 4 + i][tx * 4 + j] = acc[i][j];
    __syncthreads();
    if (owner) {
      const int n_cols = pool - c0 < kTile ? pool - c0 : kTile;
      for (int c = 0; c < n_cols; ++c) {
        const float s = ss[row][c];
        if (s > m) {  // online log-sum-exp
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
        if (s > best) {  // strict: the first maximum wins
          best = s;
          best_c = c0 + c;
        }
        if (c0 + c == label) s_lab = s;
      }
    }
    __syncthreads();
  }
  if (owner) {
    const size_t o = static_cast<size_t>(tau) * K * batch +
                     static_cast<size_t>(k) * batch + b;
    const float lse_v = m + logf(l);
    nll[o] = lse_v - s_lab;
    cor[o] = best_c == label ? 1.f : 0.f;
    lse[o] = lse_v;
  }
}

// Backward pass 1. Grid (T*K, ceil(B / 64)). delta (T, K, B, C) fp32.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    heads_delta_kernel(const float* __restrict__ g,
                       const float* __restrict__ lse, const T* __restrict__ p,
                       const T* __restrict__ z, float* __restrict__ delta,
                       int steps, int batch, int pool, int K, int D, int shift,
                       int tp) {
  __shared__ TileSmem smem;
  const int tau = blockIdx.x / K, k = blockIdx.x % K;
  const int b0 = blockIdx.y * kTile;
  const int t = tau - 1 - k;
  float* out = delta + (static_cast<size_t>(tau) * K + k) * batch * pool;
  if (t < 0 || t >= tp) {  // out of window: exact zeros (block-uniform)
    for (size_t e = threadIdx.x; e < static_cast<size_t>(kTile) * pool;
         e += kTileThreads) {
      const int bb = b0 + static_cast<int>(e / pool);
      if (bb < batch) out[static_cast<size_t>(bb) * pool + e % pool] = 0.f;
    }
    return;
  }
  const size_t kd = static_cast<size_t>(K) * D;
  const T* p_blk = p + static_cast<size_t>(t) * batch * kd +
                   static_cast<size_t>(k) * D;
  const T* z_blk = z + static_cast<size_t>(tau) * pool * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int c0 = 0; c0 < pool; c0 += kTile) {
    float acc[4][4];
    score_tile(p_blk, z_blk, kd, b0, batch, c0, pool, D, acc, smem);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bb = b0 + ty * 4 + i;
      if (bb >= batch) continue;
      const size_t o = static_cast<size_t>(tau) * K * batch +
                       static_cast<size_t>(k) * batch + bb;
      const float row_lse = lse[o], row_g = g[o];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c >= pool) continue;
        const float soft = expf(acc[i][j] - row_lse);
        out[static_cast<size_t>(bb) * pool + c] =
            (soft - (c == shift + bb ? 1.f : 0.f)) * row_g;
      }
    }
  }
}

// Backward pass 2. Grid (T, ceil(C / 64), ceil(D / 64)).
// dz[tau, c, d] = sum_{k, b} delta[tau, k, b, c] * p[tau-1-k, b, kD + d].
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    heads_dz_kernel(const float* __restrict__ delta, const T* __restrict__ p,
                    float* __restrict__ dz, int batch, int pool, int K, int D,
                    int tp) {
  __shared__ TileSmem smem;
  const int tau = blockIdx.x;
  const int c0 = blockIdx.y * kTile, d0 = blockIdx.z * kTile;
  const size_t kd = static_cast<size_t>(K) * D;
  const float* dl = delta + static_cast<size_t>(tau) * K * batch * pool;
  float acc[4][4] = {};
  tile_mm<false, false>(
      K * batch,
      [&](int r, int m) -> float {  // r = k*B + b
        const int c = c0 + m;
        return c < pool ? dl[static_cast<size_t>(r) * pool + c] : 0.f;
      },
      [&](int r, int n) -> float {
        const int d = d0 + n, k = r / batch, b = r % batch;
        const int t = tau - 1 - k;
        if (d >= D || t < 0 || t >= tp) return 0.f;
        return to_f32(p[(static_cast<size_t>(t) * batch + b) * kd +
                        static_cast<size_t>(k) * D + d]);
      },
      acc, smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (c < pool && d < D)
        dz[(static_cast<size_t>(tau) * pool + c) * D + d] = acc[i][j];
    }
  }
}

// Backward pass 3. Grid (T*K, ceil(B / 64), ceil(D / 64)); dp (K, T, B, D).
// dp[k, tau, b, d] = sum_c delta[tau, k, b, c] * z[tau, c, d].
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    heads_dp_kernel(const float* __restrict__ delta, const T* __restrict__ z,
                    T* __restrict__ dp, int steps, int batch, int pool, int K,
                    int D, int tp) {
  __shared__ TileSmem smem;
  const int tau = blockIdx.x / K, k = blockIdx.x % K;
  const int b0 = blockIdx.y * kTile, d0 = blockIdx.z * kTile;
  T* out = dp + (static_cast<size_t>(k) * steps + tau) * batch * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t = tau - 1 - k;
  float acc[4][4] = {};
  if (t >= 0 && t < tp) {  // block-uniform
    const float* dl = delta + (static_cast<size_t>(tau) * K + k) * batch * pool;
    const T* z_blk = z + static_cast<size_t>(tau) * pool * D;
    tile_mm<true, false>(
        pool,
        [&](int c, int m) -> float {
          const int b = b0 + m;
          return b < batch ? dl[static_cast<size_t>(b) * pool + c] : 0.f;
        },
        [&](int c, int n) -> float {
          const int d = d0 + n;
          return d < D ? to_f32(z_blk[static_cast<size_t>(c) * D + d]) : 0.f;
        },
        acc, smem);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (b < batch && d < D)
        out[static_cast<size_t>(b) * D + d] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------
// The bf16 wire on the tensor cores (source note above).

using bf16_t = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kMmaThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows of a block (a row group)
constexpr int kCols = 64;           // a column tile of z[tau]
constexpr int kSlab = 64;           // depth of a slab, along D
constexpr int kPad = kSlab + 8;     // a slab row: 64 bf16 and 8 of padding,
                                    // which keeps ldmatrix off bank conflicts
constexpr int kStages = 4;          // slabs in the ring, the one in use
                                    // included
// The backward's 64-wide chunks of D a block: 4 (256 columns, dz's
// accumulator 64 registers a thread; 2 chunks measured 32-47 % slower), and
// the bf16 terms delta enters its products as: 3 (source note above)
constexpr int kHalves = 4;
constexpr int kTerms = 3;

struct Geo {
  int T, B, C, K, D, Tp, shift;
};

// What a block knows of its (up to) kRows rows: the row's vector in p (or
// nullptr outside the problem), its dp offset, lse, g_nll * valid and
// positive column.
struct Rows {
  const bf16_t* ptr[kRows];
  size_t out[kRows];
  float lse[kRows], coef[kRows];
  int label[kRows];
};

struct Slabs {
  alignas(16) bf16_t p[kRows][kPad];
  alignas(16) bf16_t z[kCols][kPad];
};

struct FwdSmem {
  Slabs ring[kStages];
  Rows rows;
};

struct BwdSmem {
  Slabs ring[kStages];
  alignas(16) bf16_t delta[kTerms][kRows][kPad];  // the row group's terms
  Rows rows[kStages];  // of the units the ring reaches into
};

extern __shared__ __align__(16) unsigned char heads_smem[];

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Which part of a 64-wide half of dz[tau]'s tile a warp forms: 16 columns
// of the tile from cw, and `pairs` pairs of 8-wide n-tiles of D from dw.
// With nq <= 2 16-column groups of candidates (C <= 32), the half's 64
// columns of D go to 4 warps each, so that 4 or 8 warps work, not 2 or 4.
struct DzPart {
  int cw, dw, pairs;
};

__device__ __forceinline__ DzPart dz_part(int nq, int warp) {
  const int dsplit = nq <= 2 ? 4 : 2;  // groups of the half's columns of D
  const int cgroups = kWarps / dsplit;
  return {(warp % cgroups) * 16, (warp / cgroups) * (kSlab / dsplit),
          4 / dsplit};
}

// Threads 0..kRows-1 fill `rw` for flat rows [r0, r0 + kRows) of target
// step tau; lse and gn are nullptr in the forward. No synchronisation.
__device__ __forceinline__ void load_rows(Rows& rw, int tau, int r0,
                                          const bf16_t* p, const float* lse,
                                          const float* gn, const Geo& g) {
  const int m = threadIdx.x;
  if (m >= kRows) return;
  const int r = r0 + m;
  if (r < g.K * g.B) {
    const int k = r / g.B, b = r % g.B;
    const int t = tau - 1 - k;
    const int tc = t < 0 ? 0 : (t > g.T - 1 ? g.T - 1 : t);
    rw.ptr[m] = p + (static_cast<size_t>(tc) * g.B + b) * g.K * g.D +
                static_cast<size_t>(k) * g.D;
    rw.out[m] = ((static_cast<size_t>(k) * g.T + tau) * g.B + b) * g.D;
    rw.label[m] = g.shift + b;
    const size_t o = static_cast<size_t>(tau) * g.K * g.B + r;
    rw.lse[m] = lse ? lse[o] : 0.f;
    rw.coef[m] = gn ? gn[o] * (t >= 0 && t < g.Tp ? 1.f : 0.f) : 0.f;
  } else {
    rw.ptr[m] = nullptr;
    rw.out[m] = 0;
    rw.label[m] = -1;
    rw.lse[m] = rw.coef[m] = 0.f;
  }
}

// Starts the copies of elements [k0, k0 + 64) of the first n_rows16 rows
// and of the first n_cols16 columns of the tile zc (n_cols of them in the
// problem) into `s`, zero-filling beyond D and outside the problem. `safe`
// is any valid 16-byte aligned address, named where nothing is read.
__device__ __forceinline__ void stage(Slabs& s, const Rows& rw, int n_rows16,
                                      const bf16_t* zc, int n_cols,
                                      int n_cols16, int k0, int D,
                                      const bf16_t* safe) {
  for (int e = threadIdx.x; e < n_rows16 * 8; e += kMmaThreads) {
    const int row = e >> 3, c = (e & 7) * 8;
    const bf16_t* q = rw.ptr[row];
    const bool in = q != nullptr && k0 + c < D;
    cpc::cp_async16(&s.p[row][c], in ? q + k0 + c : safe, in ? 16 : 0);
  }
  for (int e = threadIdx.x; e < n_cols16 * 8; e += kMmaThreads) {
    const int col = e >> 3, c = (e & 7) * 8;
    const bool in = col < n_cols && k0 + c < D;
    cpc::cp_async16(&s.z[col][c],
                    in ? zc + static_cast<size_t>(col) * D + k0 + c : safe,
                    in ? 16 : 0);
  }
}

// Before the work on job q: starts the copies of job q + kStages - 1
// (`fetch` stages nothing past the last job, and always closes a group, so
// the count of groups in flight stays the same), waits for job q's, and
// makes them visible to the block.
template <class Fetch>
__device__ __forceinline__ void next_job(int q, const Fetch& fetch) {
  fetch(q + kStages - 1);
  cpc::cp_async_wait<kStages - 1>();
  __syncthreads();
}

// s (this warp's 16 rows x 64 columns) += the slab's product, summed from
// zero, over the first nq 16-column groups.
__device__ __forceinline__ void score_mma(const Slabs& sl, int nq,
                                          float (&s)[8][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float t[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    cpc::ldmatrix_x4(a,
                     &sl.p[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // two 8-column tiles a load
      if (np >= nq) break;            // block-uniform
      unsigned b[4];
      cpc::ldmatrix_x4(b, &sl.z[np * 16 + lane % 8 + (lane / 16) * 8]
                               [kk * 16 + ((lane / 8) % 2) * 8]);
      cpc::mma_bf16(t[2 * np], a, b[0], b[1]);
      cpc::mma_bf16(t[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += t[nt][e];
}

// Grid (T * n_rb); block kMmaThreads; dynamic shared memory FwdSmem.
__global__ void __launch_bounds__(kMmaThreads, 2)
    heads_fwd_mma_kernel(const bf16_t* __restrict__ p,
                         const bf16_t* __restrict__ z,
                         float* __restrict__ nll, float* __restrict__ cor,
                         float* __restrict__ lse, Geo g, int n_rb) {
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(heads_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tau = blockIdx.x / n_rb;
  const int r0 = (blockIdx.x % n_rb) * kRows;
  const int KB = g.K * g.B;
  const int n_rows = KB - r0 < kRows ? KB - r0 : kRows;
  const int KC = (g.D + kSlab - 1) / kSlab;
  const int n_ct = (g.C + kCols - 1) / kCols;
  const int total = n_ct * KC;
  const bf16_t* zt = z + static_cast<size_t>(tau) * g.C * g.D;
  load_rows(sm.rows, tau, r0, p, nullptr, nullptr, g);
  __syncthreads();
  auto fetch = [&](int q) {
    if (q < total) {
      const int c0 = (q / KC) * kCols;
      const int nc = g.C - c0 < kCols ? g.C - c0 : kCols;
      stage(sm.ring[q % kStages], sm.rows, round16(n_rows),
            zt + static_cast<size_t>(c0) * g.D, nc, round16(nc),
            (q % KC) * kSlab, g.D, z);
    }
    cpc::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) fetch(q);
  const bool active = warp * 16 < n_rows;  // warp-uniform
  const int row[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  const int label[2] = {sm.rows.label[row[0]], sm.rows.label[row[1]]};
  cpc::RowStats<2, 4> st;
  st.init();
  int q = 0;
  for (int ct = 0; ct < n_ct; ++ct) {
    const int c0 = ct * kCols;
    const int nc = g.C - c0 < kCols ? g.C - c0 : kCols;
    const int nq = round16(nc) / 16;
    float s[8][4] = {};
    for (int kc = 0; kc < KC; ++kc, ++q) {
      next_job(q, fetch);
      if (active) score_mma(sm.ring[q % kStages], nq, s);
      __syncthreads();
    }
    if (!active) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the thread's two rows
      float v[16];
      int col[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[nt * 2 + e] = s[nt][h * 2 + e];
          col[nt * 2 + e] = c0 + nt * 8 + (lane % 4) * 2 + e;
        }
      st.update_row(h, v, col, g.C, label[h]);
    }
  }
  st.finish();
  if (active && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= n_rows) continue;
      const size_t o = static_cast<size_t>(tau) * KB + r0 + row[h];
      const float row_lse = st.lse(h);
      nll[o] = row_lse - st.s_lab[h];
      cor[o] = st.best_c[h] == label[h] ? 1.f : 0.f;
      lse[o] = row_lse;
    }
  }
}

// Grid (T * n_dc); block kMmaThreads; dynamic shared memory BwdSmem.
// kOneTile: C <= 64, dz's accumulator in registers; else C is swept in
// 64-column tiles and dz is added in global memory by its owner thread.
//
// The block's work is a list of units, each a (row group, pass, column
// tile), and a unit is a list of jobs on one slab each: KC score jobs, then
// the product jobs (one per 64-wide half of the chunk; with more than one
// column tile one half per pass, so that dp's sum over the tiles stays in
// registers and dp is rounded once).
template <bool kOneTile>
__global__ void __launch_bounds__(kMmaThreads, 1)
    heads_bwd_mma_kernel(const float* __restrict__ gn,
                         const float* __restrict__ lse,
                         const bf16_t* __restrict__ p,
                         const bf16_t* __restrict__ z, float* __restrict__ dz,
                         bf16_t* __restrict__ dp, Geo g, int n_dc) {
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(heads_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qd = lane % 4, gr = lane / 4;
  const int tau = blockIdx.x / n_dc;
  const int d0 = (blockIdx.x % n_dc) * kSlab * kHalves;
  const int left = (g.D - d0 + kSlab - 1) / kSlab;
  const int nh = left < kHalves ? left : kHalves;
  const int KB = g.K * g.B;
  const int n_rg = (KB + kRows - 1) / kRows;
  const int n_ct = kOneTile ? 1 : (g.C + kCols - 1) / kCols;
  const int KC = (g.D + kSlab - 1) / kSlab;
  const int n_pass = kOneTile ? 1 : nh;
  const int n_prod = kOneTile ? nh : 1;
  const int jobs = KC + n_prod;
  const int units = n_rg * n_pass * n_ct;
  const int total = units * jobs;
  const bf16_t* zt = z + static_cast<size_t>(tau) * g.C * g.D;
  auto unit_rg = [&](int u) { return u / (n_pass * n_ct); };
  auto fetch = [&](int q) {
    if (q < total) {
      const int u = q / jobs, j = q % jobs;
      const int rg = unit_rg(u), ct = u % n_ct, pass = (u / n_ct) % n_pass;
      const int n_rows = KB - rg * kRows < kRows ? KB - rg * kRows : kRows;
      const int c0 = ct * kCols;
      const int nc = g.C - c0 < kCols ? g.C - c0 : kCols;
      const int k0 =
          j < KC ? j * kSlab : d0 + (kOneTile ? j - KC : pass) * kSlab;
      stage(sm.ring[q % kStages], sm.rows[u % kStages], round16(n_rows),
            zt + static_cast<size_t>(c0) * g.D, nc, round16(nc), k0, g.D, z);
    }
    cpc::cp_async_commit();
  };
  for (int u = 0; u < kStages - 1 && u < units; ++u) {
    load_rows(sm.rows[u], tau, unit_rg(u) * kRows, p, lse, gn, g);
  }
  __syncthreads();
  for (int q = 0; q < kStages - 1; ++q) fetch(q);

  float dzacc[kHalves][4][4] = {};
  float dpacc[8][4] = {};
  int q = 0;
  for (int u = 0; u < units; ++u) {
    const int ahead = u + kStages - 1;  // the farthest unit the ring reaches
    if (ahead < units) {
      load_rows(sm.rows[ahead % kStages], tau, unit_rg(ahead) * kRows, p, lse,
                gn, g);
      __syncthreads();
    }
    const Rows& rw = sm.rows[u % kStages];
    const int rg = unit_rg(u), ct = u % n_ct, pass = (u / n_ct) % n_pass;
    const int n_rows = KB - rg * kRows < kRows ? KB - rg * kRows : kRows;
    const int nr16 = round16(n_rows) / 16;
    const int c0 = ct * kCols;
    const int nc = g.C - c0 < kCols ? g.C - c0 : kCols;
    const int nq = round16(nc) / 16;
    const bool active = warp < nr16;  // warp-uniform
    float s[8][4] = {};
    for (int kc = 0; kc < KC; ++kc, ++q) {
      next_job(q, fetch);
      if (active) score_mma(sm.ring[q % kStages], nq, s);
      __syncthreads();
    }
    // delta as kTerms bf16 terms, each the rounding of what the terms
    // before it left: A fragments, and parked for dz's transposed read
    unsigned dt[kTerms][4][4] = {};
    if (active) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * nq) break;  // block-uniform
        float term[kTerms][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = warp * 16 + gr + (e / 2) * 8;
          const int c = c0 + nt * 8 + qd * 2 + (e & 1);
          float d = c < g.C ? (expf(s[nt][e] - rw.lse[m]) -
                               (c == rw.label[m] ? 1.f : 0.f)) *
                                  rw.coef[m]
                            : 0.f;
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            term[i][e] = cpc::round_to<bf16_t>(d);
            d -= term[i][e];  // exact
          }
        }
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned v =
                cpc::pack_bf16(term[i][2 * h], term[i][2 * h + 1]);
            dt[i][nt / 2][(nt % 2) * 2 + h] = v;
            const int m = warp * 16 + gr + h * 8, c = nt * 8 + qd * 2;
            *reinterpret_cast<unsigned*>(&sm.delta[i][m][c]) = v;
          }
      }
    }
#pragma unroll
    for (int hj = 0; hj < kHalves; ++hj) {
      if (hj >= n_prod) break;  // block-uniform
      next_job(q, fetch);
      const Slabs& sl = sm.ring[q % kStages];
      const int dh0 = d0 + (kOneTile ? hj : pass) * kSlab;
      if (active) {  // dp = delta z[tau] over the tile's columns
        float t[8][4] = {};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nq) break;  // block-uniform
#pragma unroll
          for (int dpr = 0; dpr < 4; ++dpr) {
            unsigned b[4];
            cpc::ldmatrix_x4_trans(
                b, &sl.z[ks * 16 + lane % 16][dpr * 16 + (lane / 16) * 8]);
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
              cpc::mma_bf16(t[2 * dpr], dt[i][ks], b[0], b[1]);
              cpc::mma_bf16(t[2 * dpr + 1], dt[i][ks], b[2], b[3]);
            }
          }
        }
        if (!kOneTile) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpacc[nt][e] += t[nt][e];
              t[nt][e] = dpacc[nt][e];
            }
        }
        if (kOneTile || ct == n_ct - 1) {  // dp of these rows is whole
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = warp * 16 + gr + h * 8;
            if (m >= n_rows) continue;
            bf16_t* dst = dp + rw.out[m];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int d = dh0 + nt * 8 + qd * 2;
              if (d < g.D) {  // D is even: the pair is inside, 4-byte aligned
                *reinterpret_cast<__nv_bfloat162*>(dst + d) =
                    __floats2bfloat162_rn(t[nt][2 * h], t[nt][2 * h + 1]);
              }
            }
          }
          if (!kOneTile) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) dpacc[nt][e] = 0.f;
          }
        }
      }
      // dz[tau][tile, half] += delta^T p; this thread's part: columns
      // cw + gr (+8) of the tile, 2 * pairs n-tiles of 8 from dw
      const DzPart pt = dz_part(nq, warp);
      if (pt.cw < nq * 16) {  // warp-uniform
        float t[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < kRows / 16; ++ks) {
          if (ks >= nr16) break;  // block-uniform
          unsigned a[kTerms][4];
          const int ar = ks * 16 + (lane / 16) * 8 + lane % 8;
          const int ac = pt.cw + ((lane / 8) % 2) * 8;
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            cpc::ldmatrix_x4_trans(a[i], &sm.delta[i][ar][ac]);
          }
#pragma unroll
          for (int dpr = 0; dpr < 2; ++dpr) {
            if (dpr >= pt.pairs) break;  // block-uniform
            unsigned b[4];
            const int bc = pt.dw + dpr * 16 + (lane / 16) * 8;
            cpc::ldmatrix_x4_trans(b, &sl.p[ks * 16 + lane % 16][bc]);
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
              cpc::mma_bf16(t[2 * dpr], a[i], b[0], b[1]);
              cpc::mma_bf16(t[2 * dpr + 1], a[i], b[2], b[3]);
            }
          }
        }
        if (kOneTile) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dzacc[hj][j][e] += t[j][e];
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + pt.cw + gr + h * 8;
            if (c >= g.C) continue;
            float* row = dz + (static_cast<size_t>(tau) * g.C + c) * g.D;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int d = dh0 + pt.dw + j * 8 + qd * 2;
              if (j >= 2 * pt.pairs || d >= g.D) continue;
              float2* a = reinterpret_cast<float2*>(row + d);
              const float2 was = rg == 0 ? make_float2(0.f, 0.f) : *a;
              *a = make_float2(was.x + t[j][2 * h], was.y + t[j][2 * h + 1]);
            }
          }
        }
      }
      __syncthreads();
      ++q;
    }
  }
  if (kOneTile) {
    const DzPart pt = dz_part(round16(g.C) / 16, warp);
#pragma unroll
    for (int hj = 0; hj < kHalves; ++hj) {
      if (hj >= nh) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = pt.cw + gr + h * 8;
        if (c >= g.C) continue;
        float* row = dz + (static_cast<size_t>(tau) * g.C + c) * g.D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + hj * kSlab + pt.dw + j * 8 + qd * 2;
          if (j < 2 * pt.pairs && d < g.D) {
            *reinterpret_cast<float2*>(row + d) =
                make_float2(dzacc[hj][j][2 * h], dzacc[hj][j][2 * h + 1]);
          }
        }
      }
    }
  }
}

bool grid_ok(long long x, long long y, long long z) {
  return x >= 1 && x <= 2147483647LL && y >= 1 && y <= 65535 && z >= 1 &&
         z <= 65535;
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

constexpr int kRouteSimt = 0, kRouteMma = 1;

// Whether cp.async's 16 bytes fit the operands: D a multiple of 8 elements
// (so is every row's offset) and both pointers 16-byte aligned.
bool mma_ok(int D, const void* p, const void* z) {
  return D % 8 == 0 && reinterpret_cast<size_t>(p) % 16 == 0 &&
         reinterpret_cast<size_t>(z) % 16 == 0;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int launch_fwd_mma(const void* p, const void* z, float* nll, float* cor,
                   float* lse, const Geo& g, cudaStream_t s) {
  const int n_rb = (g.K * g.B + kRows - 1) / kRows;
  if (!grid_ok(static_cast<long long>(g.T) * n_rb, 1, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_smem(heads_fwd_mma_kernel, sizeof(FwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_fwd_mma_kernel<<<g.T * n_rb, kMmaThreads, sizeof(FwdSmem), s>>>(
      static_cast<const bf16_t*>(p), static_cast<const bf16_t*>(z), nll, cor,
      lse, g, n_rb);
  return static_cast<int>(cudaGetLastError());
}

template <bool kOneTile>
int launch_bwd_mma(const float* gn, const float* lse, const void* p,
                   const void* z, float* dz, void* dp, const Geo& g,
                   cudaStream_t s) {
  const int n_dc = (g.D + kSlab * kHalves - 1) / (kSlab * kHalves);
  if (!grid_ok(static_cast<long long>(g.T) * n_dc, 1, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = heads_bwd_mma_kernel<kOneTile>;
  const size_t smem = sizeof(BwdSmem);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g.T * n_dc, kMmaThreads, smem, s>>>(
      gn, lse, static_cast<const bf16_t*>(p), static_cast<const bf16_t*>(z),
      dz, static_cast<bf16_t*>(dp), g, n_dc);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_mma(const float* gn, const float* lse, const void* p,
                   const void* z, float* dz, void* dp, const Geo& g,
                   cudaStream_t s) {
  return g.C <= kCols ? launch_bwd_mma<true>(gn, lse, p, z, dz, dp, g, s)
                      : launch_bwd_mma<false>(gn, lse, p, z, dz, dp, g, s);
}

}  // namespace

extern "C" {

// Launches the forward on `stream` of `device` and returns
// cudaGetLastError() (0 on success). p (T, B, K*D) and z (T, C, D) in bf16
// (bf16 != 0) or fp32; nll, cor, lse (T, K*B) fp32. route: 0 the SIMT
// kernel, 1 the tensor-core kernel (bf16 only, mma_ok), else an error.
// Does not synchronise.
int heads_nll_fwd(const void* p, const void* z, void* nll, void* cor,
                  void* lse, int steps, int batch, int pool, int K, int D,
                  int shift, int bf16, int route, int device, void* stream) {
  if (steps < 1 || batch < 1 || pool < 1 || K < 1 || D < 1 ||
      (route != kRouteSimt && route != kRouteMma) ||
      (route == kRouteMma && !(bf16 && mma_ok(D, p, z))) ||
      !grid_ok(static_cast<long long>(steps) * K, tiles(batch), 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* n = static_cast<float*>(nll);
  float* c = static_cast<float*>(cor);
  float* l = static_cast<float*>(lse);
  if (route == kRouteMma) {
    const Geo g{steps, batch, pool, K, D, steps - K, shift};
    return launch_fwd_mma(p, z, n, c, l, g, s);
  }
  const dim3 grid(steps * K, tiles(batch));
  if (bf16) {
    heads_nll_fwd_kernel<__nv_bfloat16><<<grid, kTileThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p),
        static_cast<const __nv_bfloat16*>(z), n, c, l, steps, batch, pool, K,
        D, shift);
  } else {
    heads_nll_fwd_kernel<float><<<grid, kTileThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(z), n, c, l,
        steps, batch, pool, K, D, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream` and returns the first launch error (0
// on success). g, lse (T, K*B) fp32; p, z as the forward; tp = T - K.
// Outputs dz (T, C, D) fp32 and dp (K, T, B, D) in p's dtype. route 0: the
// SIMT kernels, three launches through the scratch delta (T, K, B, C) fp32;
// route 1: the tensor-core kernel, one launch, `delta` unused (may be
// null). Does not synchronise.
int heads_nll_bwd(const void* g, const void* lse, const void* p,
                  const void* z, void* delta, void* dz, void* dp, int steps,
                  int batch, int pool, int K, int D, int shift, int tp,
                  int bf16, int route, int device, void* stream) {
  if (steps < 1 || batch < 1 || pool < 1 || K < 1 || D < 1 ||
      (route != kRouteSimt && route != kRouteMma) ||
      (route == kRouteMma && !(bf16 && mma_ok(D, p, z))) ||
      !grid_ok(static_cast<long long>(steps) * K, tiles(batch), tiles(D)) ||
      !grid_ok(steps, tiles(pool), tiles(D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* lf = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dzf = static_cast<float*>(dz);
  if (route == kRouteMma) {
    const Geo geo{steps, batch, pool, K, D, tp, shift};
    return launch_bwd_mma(gf, lf, p, z, dzf, dp, geo, s);
  }
  const dim3 g1(steps * K, tiles(batch));
  const dim3 g2(steps, tiles(pool), tiles(D));
  const dim3 g3(steps * K, tiles(batch), tiles(D));
  if (bf16) {
    using B16 = __nv_bfloat16;
    const B16* pb = static_cast<const B16*>(p);
    const B16* zb = static_cast<const B16*>(z);
    heads_delta_kernel<B16><<<g1, kTileThreads, 0, s>>>(
        gf, lf, pb, zb, dl, steps, batch, pool, K, D, shift, tp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    heads_dz_kernel<B16><<<g2, kTileThreads, 0, s>>>(dl, pb, dzf, batch, pool,
                                                     K, D, tp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    heads_dp_kernel<B16><<<g3, kTileThreads, 0, s>>>(
        dl, zb, static_cast<B16*>(dp), steps, batch, pool, K, D, tp);
  } else {
    const float* pf = static_cast<const float*>(p);
    const float* zf = static_cast<const float*>(z);
    heads_delta_kernel<float><<<g1, kTileThreads, 0, s>>>(
        gf, lf, pf, zf, dl, steps, batch, pool, K, D, shift, tp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    heads_dz_kernel<float><<<g2, kTileThreads, 0, s>>>(dl, pf, dzf, batch,
                                                       pool, K, D, tp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    heads_dp_kernel<float><<<g3, kTileThreads, 0, s>>>(
        dl, zf, static_cast<float*>(dp), steps, batch, pool, K, D, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
