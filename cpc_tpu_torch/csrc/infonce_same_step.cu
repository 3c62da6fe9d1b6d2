// Same-step InfoNCE on materialized predictions, forward and backward, for
// Hopper (sm_90a), bound to Python with ctypes
// (cpc_tpu_torch/ops/infonce_cuda.py; built by cpc_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of cpc_tpu/ops/infonce_pallas.py: `_fwd_kernel`
// (launched by `_pallas_fwd`) and `_bwd_kernel` (launched by `_bwd_rule`).
//
// Inputs: preds (B, Tp, K, D), Tp = T - K, and the candidate pool z (C, T, D),
// in the wire dtype (bf16 or fp32), and `shift`. Both are read through their
// batch and time strides (the last axes contiguous), so the caller neither
// transposes preds to (Tp, K, B, D) nor z to (T, C, D), as the TPU wrapper
// had to for its block specs, and preds may be the window [:, :Tp] of a
// longer array. For target step tau = 1..T-1 and head k the prediction rows
// are preds[:, t, k] with t = tau-1-k; they score against the C candidates
// z[:, tau] in fp32. Row b's positive is column shift + b; argmax ties go to
// the first maximum, as jnp.argmax. Outputs are indexed by ti = tau - 1, flat
// row k*B + b, as the TPU kernel's.
//
// FORWARD, same_step_fwd_kernel: nll, correct and the row log-sum-exp lse,
// each (T-1, K*B) fp32. One block per (tau, k, 64-row tile): (T-1)*K = 1 524
// blocks at tpu_fast (T = 128, K = 12, B = C = 64, D = 512) for 132 SMs. The
// TPU kernel tiled K so that its (KG*B, C) score block fit VMEM; here a block
// sweeps C in 64-column tiles and keeps running statistics per row
// (cpc::TileRowStats), so neither K, B nor C is bounded. Blocks outside the
// window (t < 0 or t >= Tp) write zeros, which the caller's mask drops.
//
// BACKWARD, given g (T-1, K*B) fp32 and the forward's lse:
//   delta[ti, k, b, c] = (exp(s - lse) - onehot) * g, in fp32;
//   dz[:, tau] = sum_k delta[ti, k]^T preds[:, tau-1-k, k]   (C, T, D)
//   dpreds[:, t, k] = delta[t+k, k] z[:, t+k+1]             (B, Tp, K, D)
// with p and z upcast to fp32 for the two products, as the TPU kernel does,
// and both outputs rounded once to the wire dtype. dz[:, tau] sums over all
// K heads, and the TPU grid walked the K tiles in order into one resident
// block; CUDA blocks run in parallel, so the backward is three passes on
// full grids with no atomics: same_step_delta_kernel (per (tau, k, row
// tile); writes delta to an fp32 scratch of (T-1)*K*B*C floats, 25 MB at
// tpu_fast), same_step_dz_kernel (per (tau, C tile, D tile), contracts over
// the valid K*B rows; tau = 0 is never a target and gets zeros) and
// same_step_dp_kernel (per (t, k, B tile, D tile), contracts over C and
// writes dpreds in place, with no un-permuting gather). Using the saved lse,
// softmax is one exp per score.
//
// What bounds it on this card: memory, in principle (preds is 91 MB in bf16
// at tpu_fast, read once forward, read and written backward), but the
// products, 6.4 GFLOP forward and 19.2 GFLOP backward, run on the SIMT fp32
// pipe through cpc::tile_mm, which is what the time follows until the
// products move to tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

using cpc::from_f32;
using cpc::kTile;
using cpc::kTileThreads;
using cpc::TileRowStats;
using cpc::TileSmem;
using cpc::tile_mm;
using cpc::to_f32;

// Shapes and strides (in elements) shared by the four kernels.
struct Geo {
  int T, B, C, K, D, Tp, shift;
  long long p_sb, p_st;  // preds: batch and time strides
  long long z_sc, z_st;  // z: candidate and time strides
};

template <typename T>
__device__ __forceinline__ const T* pred_row(const T* p, const Geo& g, int b,
                                             int t, int k) {
  return p + b * g.p_sb + t * g.p_st + static_cast<long long>(k) * g.D;
}

// The scores of rows b0.. of (t, k) against candidates c0.. of step tau.
template <typename T>
__device__ __forceinline__ void scores(const T* p, const T* z, const Geo& g,
                                       int t, int k, int tau, int b0, int c0,
                                       float (&acc)[4][4], TileSmem& s) {
  cpc::score_tile<T>(
      [&](int m) -> const T* {
        return b0 + m < g.B ? pred_row(p, g, b0 + m, t, k) : nullptr;
      },
      [&](int n) -> const T* {
        return c0 + n < g.C ? z + (c0 + n) * g.z_sc + tau * g.z_st : nullptr;
      },
      g.D, acc, s);
}

// Grid ((T-1)*K, ceil(B / 64)); block kTileThreads.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    same_step_fwd_kernel(const T* __restrict__ p, const T* __restrict__ z,
                         float* __restrict__ nll, float* __restrict__ cor,
                         float* __restrict__ lse, Geo g) {
  __shared__ TileSmem smem;
  const int ti = blockIdx.x / g.K, k = blockIdx.x % g.K;
  const int b0 = blockIdx.y * kTile;
  const int t = ti - k;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t o = (static_cast<size_t>(ti) * g.K + k) * g.B;
  if (t < 0 || t >= g.Tp) {  // out of window (block-uniform)
    const int b = b0 + threadIdx.x;
    if (threadIdx.x < kTile && b < g.B) {
      nll[o + b] = cor[o + b] = lse[o + b] = 0.f;
    }
    return;
  }
  int label[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) label[i] = g.shift + b0 + ty * 4 + i;
  TileRowStats st;
  st.init();
  for (int c0 = 0; c0 < g.C; c0 += kTile) {
    float acc[4][4];
    scores(p, z, g, t, k, ti + 1, b0, c0, acc, smem);
    st.update(acc, c0, g.C, label);
  }
  st.finish();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty * 4 + i;
      if (b >= g.B) continue;
      const float row_lse = st.lse(i);
      nll[o + b] = row_lse - st.s_lab[i];
      cor[o + b] = st.best_c[i] == label[i] ? 1.f : 0.f;
      lse[o + b] = row_lse;
    }
  }
}

// Backward pass 1. Grid ((T-1)*K, ceil(B / 64)); delta (T-1, K, B, C) fp32.
// Blocks outside the window write nothing: passes 2 and 3 do not read them.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    same_step_delta_kernel(const float* __restrict__ gn,
                           const float* __restrict__ lse,
                           const T* __restrict__ p, const T* __restrict__ z,
                           float* __restrict__ delta, Geo g) {
  __shared__ TileSmem smem;
  const int ti = blockIdx.x / g.K, k = blockIdx.x % g.K;
  const int b0 = blockIdx.y * kTile;
  const int t = ti - k;
  if (t < 0 || t >= g.Tp) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t o = (static_cast<size_t>(ti) * g.K + k) * g.B;
  float* out = delta + o * g.C;
  for (int c0 = 0; c0 < g.C; c0 += kTile) {
    float acc[4][4];
    scores(p, z, g, t, k, ti + 1, b0, c0, acc, smem);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty * 4 + i;
      if (b >= g.B) continue;
      const float row_lse = lse[o + b], row_g = gn[o + b];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c >= g.C) continue;
        out[static_cast<size_t>(b) * g.C + c] =
            (expf(acc[i][j] - row_lse) - (c == g.shift + b ? 1.f : 0.f)) *
            row_g;
      }
    }
  }
}

// Backward pass 2. Grid (T, ceil(C / 64), ceil(D / 64)); dz (C, T, D).
// dz[c, tau, d] = sum_{k, b} delta[tau-1, k, b, c] * preds[b, tau-1-k, k, d].
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    same_step_dz_kernel(const float* __restrict__ delta,
                        const T* __restrict__ p, T* __restrict__ dz, Geo g) {
  __shared__ TileSmem smem;
  const int tau = blockIdx.x, ti = tau - 1;
  const int c0 = blockIdx.y * kTile, d0 = blockIdx.z * kTile;
  float acc[4][4] = {};
  if (tau > 0) {  // block-uniform; step 0 is never a target
    const float* dl = delta + static_cast<size_t>(ti) * g.K * g.B * g.C;
    tile_mm<false, false>(
        g.K * g.B,
        [&](int r, int m) -> float {  // r = k*B + b
          const int c = c0 + m, t = ti - r / g.B;
          if (c >= g.C || t < 0 || t >= g.Tp) return 0.f;
          return dl[static_cast<size_t>(r) * g.C + c];
        },
        [&](int r, int n) -> float {
          const int d = d0 + n, k = r / g.B, t = ti - k;
          if (d >= g.D || t < 0 || t >= g.Tp) return 0.f;
          return to_f32(pred_row(p, g, r % g.B, t, k)[d]);
        },
        acc, smem);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (c < g.C && d < g.D)
        dz[(static_cast<size_t>(c) * g.T + tau) * g.D + d] =
            from_f32<T>(acc[i][j]);
    }
  }
}

// Backward pass 3. Grid (Tp*K, ceil(B / 64), ceil(D / 64)); dp (B, Tp, K, D).
// dp[b, t, k, d] = sum_c delta[t+k, k, b, c] * z[c, t+k+1, d].
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    same_step_dp_kernel(const float* __restrict__ delta,
                        const T* __restrict__ z, T* __restrict__ dp, Geo g) {
  __shared__ TileSmem smem;
  const int t = blockIdx.x / g.K, k = blockIdx.x % g.K;
  const int b0 = blockIdx.y * kTile, d0 = blockIdx.z * kTile;
  const int ti = t + k;
  const float* dl = delta + (static_cast<size_t>(ti) * g.K + k) * g.B * g.C;
  const T* z_tau = z + (ti + 1) * g.z_st;
  float acc[4][4] = {};
  tile_mm<true, false>(
      g.C,
      [&](int c, int m) -> float {
        const int b = b0 + m;
        return b < g.B ? dl[static_cast<size_t>(b) * g.C + c] : 0.f;
      },
      [&](int c, int n) -> float {
        const int d = d0 + n;
        return d < g.D ? to_f32(z_tau[c * g.z_sc + d]) : 0.f;
      },
      acc, smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (b < g.B && d < g.D)
        dp[((static_cast<size_t>(b) * g.Tp + t) * g.K + k) * g.D + d] =
            from_f32<T>(acc[i][j]);
    }
  }
}

bool grid_ok(long long x, long long y, long long z) {
  return x >= 1 && x <= 2147483647LL && y >= 1 && y <= 65535 && z >= 1 &&
         z <= 65535;
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

bool geo_ok(const Geo& g) {
  return g.T >= 2 && g.B >= 1 && g.C >= 1 && g.K >= 1 && g.D >= 1 &&
         g.Tp == g.T - g.K && g.Tp >= 1 &&
         grid_ok(static_cast<long long>(g.T - 1) * g.K, tiles(g.B),
                 tiles(g.D)) &&
         grid_ok(g.T, tiles(g.C), tiles(g.D));
}

template <typename T>
int launch_fwd(const void* p, const void* z, float* nll, float* cor,
               float* lse, const Geo& g, cudaStream_t s) {
  const dim3 grid((g.T - 1) * g.K, tiles(g.B));
  same_step_fwd_kernel<T><<<grid, kTileThreads, 0, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(z), nll, cor, lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* gn, const float* lse, const void* p,
               const void* z, float* delta, void* dz, void* dp, const Geo& g,
               cudaStream_t s) {
  const T* pt = static_cast<const T*>(p);
  const T* zt = static_cast<const T*>(z);
  cudaError_t err;
  same_step_delta_kernel<T>
      <<<dim3((g.T - 1) * g.K, tiles(g.B)), kTileThreads, 0, s>>>(
          gn, lse, pt, zt, delta, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  same_step_dz_kernel<T>
      <<<dim3(g.T, tiles(g.C), tiles(g.D)), kTileThreads, 0, s>>>(
          delta, pt, static_cast<T*>(dz), g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  same_step_dp_kernel<T>
      <<<dim3(g.Tp * g.K, tiles(g.B), tiles(g.D)), kTileThreads, 0, s>>>(
          delta, zt, static_cast<T*>(dp), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` of `device` and returns
// cudaGetLastError() (0 on success). p is preds (B, Tp, K, D) with batch and
// time strides p_sb, p_st (elements; the last two axes contiguous), z the
// pool (C, T, D) with strides z_sc, z_st, both bf16 (bf16 != 0) or fp32;
// nll, cor, lse (T-1, K*B) fp32. Does not synchronise.
int same_step_nll_fwd(const void* p, const void* z, void* nll, void* cor,
                      void* lse, int T, int B, int C, int K, int D, int shift,
                      long long p_sb, long long p_st, long long z_sc,
                      long long z_st, int bf16, int device, void* stream) {
  const Geo g{T, B, C, K, D, T - K, shift, p_sb, p_st, z_sc, z_st};
  if (!geo_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* n = static_cast<float*>(nll);
  float* c = static_cast<float*>(cor);
  float* l = static_cast<float*>(lse);
  return bf16 ? launch_fwd<__nv_bfloat16>(p, z, n, c, l, g, s)
              : launch_fwd<float>(p, z, n, c, l, g, s);
}

// Launches the backward's three kernels on `stream` and returns the first
// launch error (0 on success). g, lse (T-1, K*B) fp32; p, z and the strides
// as the forward. Outputs, contiguous and in p's dtype: dz (C, T, D) and
// dp (B, Tp, K, D); scratch delta (T-1, K, B, C) fp32. Does not synchronise.
int same_step_nll_bwd(const void* g_nll, const void* lse, const void* p,
                      const void* z, void* delta, void* dz, void* dp, int T,
                      int B, int C, int K, int D, int shift, long long p_sb,
                      long long p_st, long long z_sc, long long z_st,
                      int bf16, int device, void* stream) {
  const Geo g{T, B, C, K, D, T - K, shift, p_sb, p_st, z_sc, z_st};
  if (!geo_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gn = static_cast<const float*>(g_nll);
  const float* lf = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return bf16 ? launch_bwd<__nv_bfloat16>(gn, lf, p, z, dl, dz, dp, g, s)
              : launch_bwd<float>(gn, lf, p, z, dl, dz, dp, g, s);
}

}  // extern "C"
