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
// row k*B + b, as the TPU kernel's:
//
// FORWARD: nll, correct and the row log-sum-exp lse, each (T-1, K*B) fp32,
// exact zeros on rows outside the window (t < 0 or t >= Tp), which the
// caller's mask drops.
//
// BACKWARD, given g (T-1, K*B) fp32 and the forward's lse:
//   delta[ti, k, b, c] = (exp(s - lse) - onehot) * g, in fp32, 0 outside
//   the window;
//   dz[:, tau] = sum_k delta[ti, k]^T preds[:, tau-1-k, k]   (C, T, D)
//   dpreds[:, t, k] = delta[t+k, k] z[:, t+k+1]             (B, Tp, K, D)
// both rounded once to the wire dtype, with dz[:, 0] = 0 (step 0 is never a
// target). Using the saved lse, softmax is one exp per score. Each valid
// (t, k) row belongs to exactly one tau, so dpreds is written in place, each
// row once, with no un-permuting gather.
//
// What bounds the pair on this card: bytes. At tpu_fast (T = 128, B = C =
// 64, K = 12, D = 512) preds is 91 MB of bf16 and z 8.4 MB: 0.030 ms at
// 3.35 TB/s for the forward, twice that for the backward, which reads
// preds and writes dpreds, against 6.4 GFLOP of scores, 0.0065 ms at the
// bf16 tensor-core peak. The "mma" route runs at about 2x that bound
// forward and 6x backward on an H100 (4x at T = 1 024, B = C = 16), where
// the backward's time goes to its per-job ring waits and block barriers
// around a few tensor-core products each, not to bytes.
//
// Two routes, named by `same_step_route` in the wrapper; neither gives way
// to the other, and a route that cannot launch returns an error.
//
// "simt" (the fp32 wire, the parity configuration, and bf16 rows that
// 16-byte copies do not fit): every product on the fp32 SIMT pipe through
// cpc::tile_mm. same_step_fwd_kernel is one block per (tau, k, 64-row tile)
// that sweeps C in 64-column tiles with running row statistics
// (cpc::TileRowStats). The backward is three launches around an fp32 delta
// scratch of (T-1)*K*B*C floats (25 MB at tpu_fast), written once and read
// twice: same_step_delta_kernel (per (tau, k, row tile)),
// same_step_dz_kernel (per (tau, C tile, D tile), contracts over the valid
// K*B rows; tau = 0 gets zeros) and same_step_dp_kernel (per (t, k, B tile,
// D tile), contracts over C). The time follows the SIMT products: 6.4 GFLOP
// forward, 19.2 backward.
//
// "mma" (bf16, D % 8 == 0, the base pointers and the four strides
// multiples of 8 elements: the training path): the fused heads' tensor-core
// kernels (infonce_fused.cu's note gives the design; the bodies are
// cpc::nce::fwd_mma and bwd_mma of infonce_mma.cuh), over a row table of
// preds. A block's 128 flat rows r = k*B + b of one tau are one pointer
// each, preds + b*p_sb + t*p_st + k*D, or null outside the window: a null
// row is zero-filled by the copies, never offset (at t = -1, row b = 0
// would lie before the allocation; at t >= Tp a contiguous preds runs past
// its end), and gets delta = 0 by a `where`, whatever its g and lse.
// Candidates are read through z's candidate and time strides.
//   same_step_fwd_mma_kernel: one block per (tau, 128 flat rows), 8 warps
//   of 16 rows, mma.sync m16n8k16 with fp32 sums, a cp.async ring of
//   64-deep slabs; at tpu_fast 762 blocks.
//   same_step_bwd_mma_kernel: ONE launch, no scratch of delta. One block per
//   (tau, 256 columns of D); scores recomputed over the whole of D per
//   128-row group, delta formed in registers and entering both products as
//   3 bf16 terms (C9); dpreds stored at the row's own offset; dz[:, tau]'s
//   chunk kept in the owning block's registers for C <= 64 and rounded once
//   to bf16, or for C > 64 summed over the row groups in an fp32 (C, T, D)
//   scratch by its one owner thread in a fixed order and rounded once by
//   the last group: no atomics, the same bits every run. The blocks of
//   tau = 1 also zero dz[:, 0]. At tpu_fast 254 blocks, one an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "infonce_mma.cuh"

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

// ---------------------------------------------------------------------
// The bf16 wire on the tensor cores (source note above): the bodies are
// cpc::nce::fwd_mma and bwd_mma (infonce_mma.cuh) over this addressing.

using cpc::nce::bf16_t;
using cpc::nce::kCols;
using cpc::nce::kHalves;
using cpc::nce::kMmaThreads;
using cpc::nce::kRows;
using cpc::nce::kSlab;

// preds (B, Tp, K, D) through its batch and time strides, a row outside the
// window null (never offset: at t = -1 or t >= Tp the address may lie
// outside the allocation); z (C, T, D) through its candidate and time
// strides; dz (C, T, D) in bf16, with dz32 its fp32 sum over the row
// groups when C > 64; dp (B, Tp, K, D) contiguous.
struct SameStepAddr : cpc::nce::MmaGeo {
  static constexpr int kFirstTau = 1;  // step 0 is never a target
  static constexpr bool kNullRows = true;  // outside the window
  const bf16_t* p;
  const bf16_t* z;
  size_t z_cs;
  long long p_sb, p_st, z_st;
  bf16_t* dz;
  float* dz32;
  bf16_t* dp;

  __device__ __forceinline__ cpc::nce::RowRef row(int tau, int k,
                                                  int b) const {
    const int t = tau - 1 - k;
    if (t < 0 || t >= Tp) return {nullptr, 0, false};
    return {p + b * p_sb + t * p_st + static_cast<long long>(k) * D,
            ((static_cast<size_t>(b) * Tp + t) * K + k) * D, true};
  }
  __device__ __forceinline__ const bf16_t* column(int tau, int c0) const {
    return z + c0 * z_cs + tau * z_st;
  }
  __device__ __forceinline__ size_t dz_at(int tau, int c, int d) const {
    return (static_cast<size_t>(c) * T + tau) * D + d;
  }
  __device__ __forceinline__ void store_dz(int tau, int c, int d, float x,
                                           float y) const {
    *reinterpret_cast<__nv_bfloat162*>(dz + dz_at(tau, c, d)) =
        __floats2bfloat162_rn(x, y);
  }
  // summed in fp32 by the owner thread, in row-group order, and rounded
  // once, by the last group
  __device__ __forceinline__ void add_dz(int tau, int c, int d, float x,
                                         float y, bool first,
                                         bool last) const {
    float2* acc = reinterpret_cast<float2*>(dz32 + dz_at(tau, c, d));
    const float2 was = first ? make_float2(0.f, 0.f) : *acc;
    const float2 now = make_float2(was.x + x, was.y + y);
    if (last) {
      store_dz(tau, c, d, now.x, now.y);
    } else {
      *acc = now;
    }
  }
  // dz[:, 0] = 0 exactly, over the block's columns of D, by the blocks of
  // the first target step
  __device__ __forceinline__ void finish(int tau, int d0, int width) const {
    if (tau != kFirstTau) return;
    const int pairs = width / 2;
    for (int e = threadIdx.x; e < C * pairs; e += kMmaThreads) {
      const int c = e / pairs, d = d0 + (e % pairs) * 2;
      if (d < D) store_dz(0, c, d, 0.f, 0.f);
    }
  }
};

// Grid ((T-1) * n_rb); block kMmaThreads; dynamic shared memory FwdSmem.
__global__ void __launch_bounds__(kMmaThreads, 2)
    same_step_fwd_mma_kernel(const __grid_constant__ SameStepAddr a,
                             float* __restrict__ nll, float* __restrict__ cor,
                             float* __restrict__ lse, int n_rb) {
  cpc::nce::fwd_mma(a, nll, cor, lse, n_rb);
}

// Grid ((T-1) * n_dc); block kMmaThreads; dynamic shared memory BwdSmem.
template <bool kOneTile>
__global__ void __launch_bounds__(kMmaThreads, 1)
    same_step_bwd_mma_kernel(const __grid_constant__ SameStepAddr a,
                             const float* __restrict__ gn,
                             const float* __restrict__ lse, int n_dc) {
  cpc::nce::bwd_mma<kOneTile>(a, gn, lse, n_dc);
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

using cpc::nce::kRouteMma;
using cpc::nce::kRouteSimt;

// The mma route's condition (same_step_route in the wrapper): bf16, and
// cp.async's 16 bytes fit every row: D, the base pointers and the four
// strides multiples of 8 elements.
bool mma_ok(const Geo& g, const void* p, const void* z, int bf16) {
  return bf16 && cpc::nce::mma_ok(g.D, p, z) && g.p_sb % 8 == 0 &&
         g.p_st % 8 == 0 && g.z_sc % 8 == 0 && g.z_st % 8 == 0;
}

bool route_ok(int route, const Geo& g, const void* p, const void* z,
              int bf16) {
  return route == kRouteSimt || (route == kRouteMma && mma_ok(g, p, z, bf16));
}

SameStepAddr mma_addr(const Geo& g, const void* p, const void* z) {
  return {{g.T, g.B, g.C, g.K, g.D, g.Tp, g.shift},
          static_cast<const bf16_t*>(p),
          static_cast<const bf16_t*>(z),
          static_cast<size_t>(g.z_sc),
          g.p_sb,
          g.p_st,
          g.z_st,
          nullptr,
          nullptr,
          nullptr};
}

template <typename T>
int launch_fwd(const void* p, const void* z, float* nll, float* cor,
               float* lse, const Geo& g, cudaStream_t s) {
  const dim3 grid((g.T - 1) * g.K, tiles(g.B));
  same_step_fwd_kernel<T><<<grid, kTileThreads, 0, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(z), nll, cor, lse, g);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_mma(const SameStepAddr& a, float* nll, float* cor, float* lse,
                   cudaStream_t s) {
  const int n_rb = (a.K * a.B + kRows - 1) / kRows;
  if (!grid_ok(static_cast<long long>(a.T - 1) * n_rb, 1, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(cpc::nce::FwdSmem);
  const cudaError_t err =
      cpc::nce::allow_smem(same_step_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  same_step_fwd_mma_kernel<<<(a.T - 1) * n_rb, kMmaThreads, smem, s>>>(
      a, nll, cor, lse, n_rb);
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

template <bool kOneTile>
int launch_bwd_mma(const SameStepAddr& a, const float* gn, const float* lse,
                   cudaStream_t s) {
  const int n_dc = (a.D + kSlab * kHalves - 1) / (kSlab * kHalves);
  if (!grid_ok(static_cast<long long>(a.T - 1) * n_dc, 1, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = same_step_bwd_mma_kernel<kOneTile>;
  const size_t smem = sizeof(cpc::nce::BwdSmem);
  const cudaError_t err = cpc::nce::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(a.T - 1) * n_dc, kMmaThreads, smem, s>>>(a, gn, lse, n_dc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` of `device` and returns
// cudaGetLastError() (0 on success). p is preds (B, Tp, K, D) with batch and
// time strides p_sb, p_st (elements; the last two axes contiguous), z the
// pool (C, T, D) with strides z_sc, z_st, both bf16 (bf16 != 0) or fp32;
// nll, cor, lse (T-1, K*B) fp32. route: 0 the SIMT kernel, 1 the
// tensor-core kernel (bf16 and mma_ok only), else an error. Does not
// synchronise.
int same_step_nll_fwd(const void* p, const void* z, void* nll, void* cor,
                      void* lse, int T, int B, int C, int K, int D, int shift,
                      long long p_sb, long long p_st, long long z_sc,
                      long long z_st, int bf16, int route, int device,
                      void* stream) {
  const Geo g{T, B, C, K, D, T - K, shift, p_sb, p_st, z_sc, z_st};
  if (!geo_ok(g) || !route_ok(route, g, p, z, bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* n = static_cast<float*>(nll);
  float* c = static_cast<float*>(cor);
  float* l = static_cast<float*>(lse);
  if (route == kRouteMma) return launch_fwd_mma(mma_addr(g, p, z), n, c, l, s);
  return bf16 ? launch_fwd<__nv_bfloat16>(p, z, n, c, l, g, s)
              : launch_fwd<float>(p, z, n, c, l, g, s);
}

// Launches the backward on `stream` and returns the first launch error (0
// on success). g, lse (T-1, K*B) fp32; p, z, the strides and route as the
// forward. Outputs, contiguous and in p's dtype: dz (C, T, D) and dp
// (B, Tp, K, D). route 0: three SIMT kernels through the scratch delta
// (T-1, K, B, C) fp32; route 1: one tensor-core kernel, with the scratch
// dz32 (C, T, D) fp32 when C > 64 (else unused, may be null). A scratch the
// route needs and does not get is an error. Does not synchronise.
int same_step_nll_bwd(const void* g_nll, const void* lse, const void* p,
                      const void* z, void* delta, void* dz32, void* dz,
                      void* dp, int T, int B, int C, int K, int D, int shift,
                      long long p_sb, long long p_st, long long z_sc,
                      long long z_st, int bf16, int route, int device,
                      void* stream) {
  const Geo g{T, B, C, K, D, T - K, shift, p_sb, p_st, z_sc, z_st};
  const bool scratch = route == kRouteMma ? C <= kCols || dz32 != nullptr
                                          : delta != nullptr;
  if (!geo_ok(g) || !route_ok(route, g, p, z, bf16) || !scratch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gn = static_cast<const float*>(g_nll);
  const float* lf = static_cast<const float*>(lse);
  if (route == kRouteMma) {
    SameStepAddr a = mma_addr(g, p, z);
    a.dz = static_cast<bf16_t*>(dz);
    a.dz32 = static_cast<float*>(dz32);
    a.dp = static_cast<bf16_t*>(dp);
    return C <= kCols ? launch_bwd_mma<true>(a, gn, lf, s)
                      : launch_bwd_mma<false>(a, gn, lf, s);
  }
  float* dl = static_cast<float*>(delta);
  return bf16 ? launch_bwd<__nv_bfloat16>(gn, lf, p, z, dl, dz, dp, g, s)
              : launch_bwd<float>(gn, lf, p, z, dl, dz, dp, g, s);
}

}  // extern "C"
