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
#include "infonce_mma.cuh"

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
// The bf16 wire on the tensor cores (source note above): the bodies are
// cpc::nce::fwd_mma and bwd_mma (infonce_mma.cuh) over this addressing.

using cpc::nce::bf16_t;
using cpc::nce::kCols;
using cpc::nce::kHalves;
using cpc::nce::kMmaThreads;
using cpc::nce::kRows;
using cpc::nce::kSlab;

// p (T, B, K*D), rows clamped to 0..T-1 as the Pallas index map clamps;
// z (T, C, D); dz (T, C, D) fp32; dp (K, T, B, D).
struct HeadsAddr : cpc::nce::MmaGeo {
  static constexpr int kFirstTau = 0;
  static constexpr bool kNullRows = false;  // clamped, never null
  const bf16_t* p;
  const bf16_t* z;
  size_t z_cs;
  float* dz;
  bf16_t* dp;

  __device__ __forceinline__ cpc::nce::RowRef row(int tau, int k,
                                                  int b) const {
    const int t = tau - 1 - k;
    const int tc = t < 0 ? 0 : (t > T - 1 ? T - 1 : t);
    return {p + (static_cast<size_t>(tc) * B + b) * K * D +
                static_cast<size_t>(k) * D,
            ((static_cast<size_t>(k) * T + tau) * B + b) * D,
            t >= 0 && t < Tp};
  }
  __device__ __forceinline__ const bf16_t* column(int tau, int c0) const {
    return z + static_cast<size_t>(tau) * C * D + static_cast<size_t>(c0) * D;
  }
  __device__ __forceinline__ float2* dz_at(int tau, int c, int d) const {
    return reinterpret_cast<float2*>(
        dz + (static_cast<size_t>(tau) * C + c) * D + d);
  }
  __device__ __forceinline__ void store_dz(int tau, int c, int d, float x,
                                           float y) const {
    *dz_at(tau, c, d) = make_float2(x, y);
  }
  __device__ __forceinline__ void add_dz(int tau, int c, int d, float x,
                                         float y, bool first, bool) const {
    float2* a = dz_at(tau, c, d);
    const float2 was = first ? make_float2(0.f, 0.f) : *a;
    *a = make_float2(was.x + x, was.y + y);
  }
  __device__ __forceinline__ void finish(int, int, int) const {}
};

// Grid (T * n_rb); block kMmaThreads; dynamic shared memory FwdSmem.
__global__ void __launch_bounds__(kMmaThreads, 2)
    heads_fwd_mma_kernel(const __grid_constant__ HeadsAddr a,
                         float* __restrict__ nll, float* __restrict__ cor,
                         float* __restrict__ lse, int n_rb) {
  cpc::nce::fwd_mma(a, nll, cor, lse, n_rb);
}

// Grid (T * n_dc); block kMmaThreads; dynamic shared memory BwdSmem.
template <bool kOneTile>
__global__ void __launch_bounds__(kMmaThreads, 1)
    heads_bwd_mma_kernel(const __grid_constant__ HeadsAddr a,
                         const float* __restrict__ gn,
                         const float* __restrict__ lse, int n_dc) {
  cpc::nce::bwd_mma<kOneTile>(a, gn, lse, n_dc);
}

bool grid_ok(long long x, long long y, long long z) {
  return x >= 1 && x <= 2147483647LL && y >= 1 && y <= 65535 && z >= 1 &&
         z <= 65535;
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

using cpc::nce::kRouteMma;
using cpc::nce::kRouteSimt;
using cpc::nce::mma_ok;

int launch_fwd_mma(const HeadsAddr& a, float* nll, float* cor, float* lse,
                   cudaStream_t s) {
  const int n_rb = (a.K * a.B + kRows - 1) / kRows;
  if (!grid_ok(static_cast<long long>(a.T) * n_rb, 1, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(cpc::nce::FwdSmem);
  const cudaError_t err = cpc::nce::allow_smem(heads_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_fwd_mma_kernel<<<a.T * n_rb, kMmaThreads, smem, s>>>(a, nll, cor,
                                                             lse, n_rb);
  return static_cast<int>(cudaGetLastError());
}

template <bool kOneTile>
int launch_bwd_mma(const HeadsAddr& a, const float* gn, const float* lse,
                   cudaStream_t s) {
  const int n_dc = (a.D + kSlab * kHalves - 1) / (kSlab * kHalves);
  if (!grid_ok(static_cast<long long>(a.T) * n_dc, 1, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = heads_bwd_mma_kernel<kOneTile>;
  const size_t smem = sizeof(cpc::nce::BwdSmem);
  const cudaError_t err = cpc::nce::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.T * n_dc, kMmaThreads, smem, s>>>(a, gn, lse, n_dc);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_mma(const HeadsAddr& a, const float* gn, const float* lse,
                   cudaStream_t s) {
  return a.C <= kCols ? launch_bwd_mma<true>(a, gn, lse, s)
                      : launch_bwd_mma<false>(a, gn, lse, s);
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
    const HeadsAddr a{{steps, batch, pool, K, D, steps - K, shift},
                      static_cast<const bf16_t*>(p),
                      static_cast<const bf16_t*>(z),
                      static_cast<size_t>(D),
                      nullptr,
                      nullptr};
    return launch_fwd_mma(a, n, c, l, s);
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
    const HeadsAddr a{{steps, batch, pool, K, D, tp, shift},
                      static_cast<const bf16_t*>(p),
                      static_cast<const bf16_t*>(z),
                      static_cast<size_t>(D),
                      dzf,
                      static_cast<bf16_t*>(dp)};
    return launch_bwd_mma(a, gf, lf, s);
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
