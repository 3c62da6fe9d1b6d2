// GRU recurrence, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes (cpc_tpu_torch/ops/gru_cuda.py; built by
// cpc_tpu_torch/ops/_build.py).
//
// FORWARD. Replaces the TPU kernel cpc_tpu/ops/gru_pallas.py::_fwd_kernel,
// which `_fwd` launches through `gru_scan`.
//
// For t = 0..T-1 and every batch row b it computes
//   hp = round(h) @ wh + bh            product accumulated in fp32
//   r  = sigmoid(xr + hr),  z = sigmoid(xz + hz)
//   n  = tanh(xn + r * hn)
//   h  = (1 - z) * n + z * h           h carried in fp32
//   out[t, b] = h rounded to the wire dtype
// where round(.) rounds h to wh's dtype (the identity for fp32), the gate
// order is torch.nn.GRU's r, z, n, and the gates run in fp32 whatever the
// wire dtype. The rounded output never feeds back into the recurrence.
//
// Design. Batch rows are independent, so each block owns kRows rows and runs
// the whole loop over T itself; nothing is shared between blocks. Thread i
// owns hidden unit i: it keeps h[i] of its rows in fp32 registers and
// computes columns i, H+i and 2H+i of h @ wh, so a warp reads 32 consecutive
// entries of a wh row (coalesced) and every wh load serves kRows rows. The
// rounded h of all units sits in shared memory, double-buffered, so one
// barrier per step separates the reads of step t from the writes of t+1.
//
// What bounds it on this card: the loop over T is serial, and every step
// reads all of wh (H x 3H: 393 KB in bf16 at H = 256) from L2 in every
// block, about (B / kRows) * T * |wh| bytes in all. That is more than one
// SM's 227 KB of shared memory, so wh cannot stay resident in one block;
// splitting it over a thread-block cluster, or wgmma over a tile of rows,
// is later work.
//
// BACKWARD. Replaces cpc_tpu/ops/gru_pallas.py::_bwd_kernel, which
// `_bwd_rule` launches. Two passes:
//
// 1. gru_scan_bwd_kernel, the recurrence reversed, with the forward's
//    layout (a block owns kRows batch rows and loops t = T-1..0, thread i
//    owns unit i). Per step, as the Pallas kernel: h_prev is the forward's
//    rounded output of step t-1 (round(h0) at t = 0); the gates are
//    recomputed from round(h_prev) @ wh + bh; dh (fp32 registers) gains
//    g[t]; dr_pre, dz_pre, dn_pre and dhn = dn_pre * r follow; dxproj[t]
//    is (dr_pre, dz_pre, dn_pre) in the wire dtype; dhp[t] =
//    (dr_pre, dz_pre, dhn) goes to an fp32 scratch (T, B, 3H) and to shared
//    memory; and dh = dh * z + dhp @ wh^T in fp32. That last product reads
//    wh by ROWS; the wrapper passes a transposed copy wht (3H, H), so that a
//    warp again reads 32 consecutive entries. Two barriers per step.
// 2. dwh = sum_{t,b} h_prev^T dhp and dbh = sum_{t,b} dhp are reductions
//    over all T*B rows, i.e. across the blocks of pass 1. The TPU kernel
//    kept them resident because its grid is serial; here gru_bwd_reduce
//    _kernel computes per-split partials (the T*B rows cut into S splits,
//    64 x 64 output tiles, fp32) and gru_bwd_finish_kernel sums the S
//    partials in a fixed order and rounds dwh to wh's dtype. No atomics:
//    the result does not depend on scheduling.
//
// What bounds the backward: pass 1 is serial in T like the forward and
// reads wh and wht (2 x 393 KB in bf16) from L2 every step in every block,
// twice the forward's traffic. Pass 2 is 2 * T*B * H * 3H flops (3.2 GFLOP
// at the slice) on the SIMT fp32 pipe; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

using cpc::from_f32;
using cpc::to_f32;

constexpr int kRows = 2;          // batch rows per block
constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// xproj (T, B, 3H), wh (H, 3H) in T; bh (3H,), h0 (B, H) fp32;
// out (T, B, H) in T. All contiguous.
template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
    gru_scan_fwd_kernel(const T* __restrict__ xproj, const T* __restrict__ wh,
                        const float* __restrict__ bh,
                        const float* __restrict__ h0, T* __restrict__ out,
                        int steps, int batch, int hidden) {
  extern __shared__ float h_smem[];  // [2][kRows][hidden], rounded h
  const int i = threadIdx.x;
  const bool active = i < hidden;
  const int b0 = blockIdx.x * kRows;
  const size_t h3 = 3 * static_cast<size_t>(hidden);

  float h[kRows];
  float bhr = 0.f, bhz = 0.f, bhn = 0.f;
  if (active) {
    bhr = bh[i];
    bhz = bh[hidden + i];
    bhn = bh[2 * hidden + i];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    h[r] = (active && b < batch) ? h0[static_cast<size_t>(b) * hidden + i]
                                 : 0.f;
    if (active) h_smem[r * hidden + i] = to_f32(from_f32<T>(h[r]));
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* h_cur = h_smem + (t & 1) * kRows * hidden;
    float* h_next = h_smem + ((t + 1) & 1) * kRows * hidden;
    if (active) {
      float acc_r[kRows], acc_z[kRows], acc_n[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_n[r] = 0.f;
      const T* w = wh + i;
#pragma unroll 4
      for (int k = 0; k < hidden; ++k, w += h3) {
        const float wr = to_f32(w[0]);
        const float wz = to_f32(w[hidden]);
        const float wn = to_f32(w[2 * hidden]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = h_cur[r * hidden + k];
          acc_r[r] = fmaf(hk, wr, acc_r[r]);
          acc_z[r] = fmaf(hk, wz, acc_z[r]);
          acc_n[r] = fmaf(hk, wn, acc_n[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        if (b < batch) {
          const size_t row = static_cast<size_t>(t) * batch + b;
          const T* xp = xproj + row * h3;
          const float rg = sigmoid(to_f32(xp[i]) + (acc_r[r] + bhr));
          const float zg = sigmoid(to_f32(xp[hidden + i]) + (acc_z[r] + bhz));
          const float ng =
              tanhf(to_f32(xp[2 * hidden + i]) + rg * (acc_n[r] + bhn));
          h[r] = (1.0f - zg) * ng + zg * h[r];
          out[row * hidden + i] = from_f32<T>(h[r]);
        }
        h_next[r * hidden + i] = to_f32(from_f32<T>(h[r]));
      }
    }
    __syncthreads();
  }
}

// Pass 1 of the backward. xproj, g (T, B, 3H) / (T, B, H), hs (T, B, H),
// wh (H, 3H), wht = wh^T (3H, H), all in T; bh (3H,), h0 (B, H) fp32.
// Writes dxproj (T, B, 3H) in T, dhp (T, B, 3H) fp32, dh0 (B, H) fp32.
template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
    gru_scan_bwd_kernel(const T* __restrict__ xproj, const T* __restrict__ wh,
                        const T* __restrict__ wht,
                        const float* __restrict__ bh,
                        const float* __restrict__ h0,
                        const T* __restrict__ hs, const T* __restrict__ g,
                        T* __restrict__ dxproj, float* __restrict__ dhp,
                        float* __restrict__ dh0, int steps, int batch,
                        int hidden) {
  extern __shared__ float smem[];
  float* hprev_s = smem;                    // [kRows][hidden]
  float* dhp_s = smem + kRows * hidden;     // [kRows][3 * hidden]
  const int i = threadIdx.x;
  const bool active = i < hidden;
  const int b0 = blockIdx.x * kRows;
  const size_t h3 = 3 * static_cast<size_t>(hidden);

  float bhr = 0.f, bhz = 0.f, bhn = 0.f;
  if (active) {
    bhr = bh[i];
    bhz = bh[hidden + i];
    bhn = bh[2 * hidden + i];
  }
  float dh[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dh[r] = 0.f;

  for (int t = steps - 1; t >= 0; --t) {
    // h_{t-1} as the forward emitted it: rounded to the wire dtype
    float hprev[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      hprev[r] = 0.f;
      if (active && b < batch) {
        hprev[r] =
            t == 0 ? to_f32(from_f32<T>(h0[static_cast<size_t>(b) * hidden + i]))
                   : to_f32(hs[(static_cast<size_t>(t - 1) * batch + b) *
                                   hidden + i]);
      }
      if (active) hprev_s[r * hidden + i] = hprev[r];
    }
    __syncthreads();

    if (active) {
      float acc_r[kRows], acc_z[kRows], acc_n[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_n[r] = 0.f;
      const T* w = wh + i;
#pragma unroll 4
      for (int k = 0; k < hidden; ++k, w += h3) {
        const float wr = to_f32(w[0]);
        const float wz = to_f32(w[hidden]);
        const float wn = to_f32(w[2 * hidden]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = hprev_s[r * hidden + k];
          acc_r[r] = fmaf(hk, wr, acc_r[r]);
          acc_z[r] = fmaf(hk, wz, acc_z[r]);
          acc_n[r] = fmaf(hk, wn, acc_n[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        float* ds = dhp_s + r * h3;
        if (b >= batch) {
          ds[i] = ds[hidden + i] = ds[2 * hidden + i] = 0.f;
          continue;
        }
        const size_t row = static_cast<size_t>(t) * batch + b;
        const T* xp = xproj + row * h3;
        const float rg = sigmoid(to_f32(xp[i]) + (acc_r[r] + bhr));
        const float zg = sigmoid(to_f32(xp[hidden + i]) + (acc_z[r] + bhz));
        const float hn = acc_n[r] + bhn;
        const float ng = tanhf(to_f32(xp[2 * hidden + i]) + rg * hn);

        const float d = dh[r] + to_f32(g[row * hidden + i]);  // dL/dh_t
        const float dz = d * (hprev[r] - ng);
        const float dn_pre = d * (1.0f - zg) * (1.0f - ng * ng);
        const float dhn = dn_pre * rg;
        const float dr_pre = dn_pre * hn * rg * (1.0f - rg);
        const float dz_pre = dz * zg * (1.0f - zg);

        T* dx = dxproj + row * h3;
        dx[i] = from_f32<T>(dr_pre);
        dx[hidden + i] = from_f32<T>(dz_pre);
        dx[2 * hidden + i] = from_f32<T>(dn_pre);
        float* dp = dhp + row * h3;
        dp[i] = ds[i] = dr_pre;
        dp[hidden + i] = ds[hidden + i] = dz_pre;
        dp[2 * hidden + i] = ds[2 * hidden + i] = dhn;
        dh[r] = d * zg;
      }
    }
    __syncthreads();

    if (active) {
      // dh += dhp @ wh^T: thread i walks column i of wht, coalesced
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* w = wht + i;
#pragma unroll 4
      for (size_t j = 0; j < h3; ++j, w += hidden) {
        const float wv = to_f32(*w);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(dhp_s[r * h3 + j], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh[r] += acc[r];
    }
    // No barrier here: the next step first writes hprev_s, whose last
    // reader (the product above the previous barrier) is done, and writes
    // dhp_s only after its own first barrier.
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (active && b < batch) dh0[static_cast<size_t>(b) * hidden + i] = dh[r];
  }
}

// Pass 2: partial dwh and dbh of one split of the T*B rows. Grid
// (ceil(3H / 64), ceil(H / 64), splits); split s covers rows
// [s * chunk, min(T*B, (s+1) * chunk)). Row t*B + b of h_prev is
// round(h0[b]) for t = 0 and hs[t-1, b] after.
template <typename T>
__global__ void __launch_bounds__(cpc::kTileThreads)
    gru_bwd_reduce_kernel(const T* __restrict__ hs,
                          const float* __restrict__ h0,
                          const float* __restrict__ dhp,
                          float* __restrict__ pdwh, float* __restrict__ pdbh,
                          int steps, int batch, int hidden, int chunk) {
  __shared__ cpc::TileSmem smem;
  const int h3 = 3 * hidden;
  const int n0 = blockIdx.x * cpc::kTile;
  const int m0 = blockIdx.y * cpc::kTile;
  const int split = blockIdx.z;
  const long long rows = static_cast<long long>(steps) * batch;
  const long long r0 = static_cast<long long>(split) * chunk;
  const int depth =
      static_cast<int>(rows - r0 < chunk ? (rows > r0 ? rows - r0 : 0) : chunk);

  auto hprev = [&](int r, int m) -> float {
    const long long row = r0 + r;
    const int k = m0 + m;
    if (k >= hidden) return 0.f;
    if (row < batch) return to_f32(from_f32<T>(h0[row * hidden + k]));
    return to_f32(hs[(row - batch) * hidden + k]);
  };
  auto grad = [&](int r, int n) -> float {
    const int j = n0 + n;
    return j < h3 ? dhp[(r0 + r) * h3 + j] : 0.f;
  };
  float acc[4][4] = {};
  cpc::tile_mm<false, false>(depth, hprev, grad, acc, smem);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = pdwh + static_cast<size_t>(split) * hidden * h3;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = m0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = n0 + tx * 4 + c;
      if (k < hidden && j < h3) out[static_cast<size_t>(k) * h3 + j] = acc[a][c];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < cpc::kTile) {
    const int j = n0 + threadIdx.x;
    if (j < h3) {
      float sum = 0.f;
      for (int r = 0; r < depth; ++r) sum += dhp[(r0 + r) * h3 + j];
      pdbh[static_cast<size_t>(split) * h3 + j] = sum;
    }
  }
}

// Pass 2b: sums the partials of all splits in split order; dwh in T.
template <typename T>
__global__ void gru_bwd_finish_kernel(const float* __restrict__ pdwh,
                                      const float* __restrict__ pdbh,
                                      T* __restrict__ dwh,
                                      float* __restrict__ dbh, int hidden,
                                      int splits) {
  const long long n_w = 3LL * hidden * hidden;
  const int h3 = 3 * hidden;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n_w + h3; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    if (e < n_w) {
      for (int p = 0; p < splits; ++p) sum += pdwh[p * n_w + e];
      dwh[e] = from_f32<T>(sum);
    } else {
      const long long j = e - n_w;
      for (int p = 0; p < splits; ++p) sum += pdbh[p * h3 + j];
      dbh[j] = sum;
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* xproj, const void* wh, const void* wht,
                       const float* bh, const float* h0, const void* hs,
                       const void* g, void* dxproj, float* dhp, float* dh0,
                       float* pdwh, float* pdbh, void* dwh, float* dbh,
                       int steps, int batch, int hidden, int splits,
                       cudaStream_t s) {
  const int threads = (hidden + 31) / 32 * 32;
  const size_t smem = 4 * kRows * static_cast<size_t>(hidden) * sizeof(float);
  gru_scan_bwd_kernel<T><<<(batch + kRows - 1) / kRows, threads, smem, s>>>(
      static_cast<const T*>(xproj), static_cast<const T*>(wh),
      static_cast<const T*>(wht), bh, h0, static_cast<const T*>(hs),
      static_cast<const T*>(g), static_cast<T*>(dxproj), dhp, dh0, steps,
      batch, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(steps) * batch;
  const int chunk = static_cast<int>((rows + splits - 1) / splits);
  const dim3 grid((3 * hidden + cpc::kTile - 1) / cpc::kTile,
                  (hidden + cpc::kTile - 1) / cpc::kTile, splits);
  gru_bwd_reduce_kernel<T><<<grid, cpc::kTileThreads, 0, s>>>(
      static_cast<const T*>(hs), h0, dhp, pdwh, pdbh, steps, batch, hidden,
      chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 3LL * hidden * hidden + 3LL * hidden;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256
                                                              : 4096);
  gru_bwd_finish_kernel<T><<<blocks, 256, 0, s>>>(
      pdwh, pdbh, static_cast<T*>(dwh), dbh, hidden, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gru_scan_max_hidden() { return kMaxHidden; }

const char* cpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the recurrence on `stream` of `device` and returns
// cudaGetLastError() (0 on success). bf16 != 0 selects the bf16 wire dtype,
// 0 the fp32 one. Does not synchronise.
int gru_scan_fwd(const void* xproj, const void* wh, const void* bh,
                 const void* h0, void* out, int steps, int batch, int hidden,
                 int bf16, int device, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1 || hidden > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (hidden + 31) / 32 * 32;
  const dim3 grid((batch + kRows - 1) / kRows);
  const size_t smem = 2 * kRows * static_cast<size_t>(hidden) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bh32 = static_cast<const float*>(bh);
  const float* h032 = static_cast<const float*>(h0);
  if (bf16) {
    gru_scan_fwd_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(xproj),
        static_cast<const __nv_bfloat16*>(wh), bh32, h032,
        static_cast<__nv_bfloat16*>(out), steps, batch, hidden);
  } else {
    gru_scan_fwd_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(xproj), static_cast<const float*>(wh), bh32,
        h032, static_cast<float*>(out), steps, batch, hidden);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward's three kernels on `stream` and returns the first
// launch error (0 on success). Inputs as gru_scan_fwd, plus wht = wh^T
// (3H, H) in the wire dtype, hs (T, B, H) and g (T, B, H) in the wire dtype.
// Outputs: dxproj (T, B, 3H) wire dtype, dh0 (B, H) fp32, dwh (H, 3H) wire
// dtype, dbh (3H,) fp32. Scratch: dhp (T, B, 3H) fp32, pdwh (splits, H, 3H)
// and pdbh (splits, 3H) fp32. Does not synchronise.
int gru_scan_bwd(const void* xproj, const void* wh, const void* wht,
                 const void* bh, const void* h0, const void* hs,
                 const void* g, void* dxproj, void* dhp, void* dh0,
                 void* pdwh, void* pdbh, void* dwh, void* dbh, int steps,
                 int batch, int hidden, int splits, int bf16, int device,
                 void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1 || hidden > kMaxHidden ||
      splits < 1 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bh32 = static_cast<const float*>(bh);
  const float* h032 = static_cast<const float*>(h0);
  float* dhp32 = static_cast<float*>(dhp);
  float* dh032 = static_cast<float*>(dh0);
  float* pw = static_cast<float*>(pdwh);
  float* pb = static_cast<float*>(pdbh);
  float* db = static_cast<float*>(dbh);
  err = bf16 ? launch_bwd<__nv_bfloat16>(xproj, wh, wht, bh32, h032, hs, g,
                                         dxproj, dhp32, dh032, pw, pb, dwh, db,
                                         steps, batch, hidden, splits, s)
             : launch_bwd<float>(xproj, wh, wht, bh32, h032, hs, g, dxproj,
                                 dhp32, dh032, pw, pb, dwh, db, steps, batch,
                                 hidden, splits, s);
  return static_cast<int>(err);
}

}  // extern "C"
