// All-steps InfoNCE: every prediction scored against every latent of the
// pool, forward and backward, for Hopper (sm_90a), bound to Python with
// ctypes (cpc_tpu_torch/ops/infonce_allsteps_cuda.py; built by
// cpc_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of cpc_tpu/ops/infonce_allsteps_pallas.py:
// `_fwd_kernel` (launched by `_fwd`), and `_dp_kernel` and `_dz_kernel`
// (launched by `_bwd_rule`).
//
// Inputs: preds (B, Tp, K, D), read through its batch and time strides (the
// last axes contiguous, so it may be the window [:, :Tp] of a longer array
// and is never transposed), and the pool z_flat (N, D), N = C*T, contiguous,
// both in the wire dtype (bf16_t or fp32), and `shift`. Row
// r = (t*K + k)*B + i is preds[i, t, k]; there are R = Tp*K*B of them. Its
// positive is column (shift + i)*T + t + k + 1. Scores are fp32; argmax ties
// go to the lowest column, as jnp.argmax over the whole row.
//
// The (R, N) score matrix (89 088 x 8 192 at tpu_fast: T = 128, B = C = 64,
// K = 12, D = 512) is never stored, forward or backward: each kernel
// recomputes the tiles it needs.
//
// Each kernel exists twice. The fp32 wire, which is the parity
// configuration, and bf16 shapes that 16-byte copies do not fit, run the
// products on the SIMT fp32 pipe through cpc::tile_mm (the kernels right
// below). The bf16 wire of the training path runs them on the tensor cores
// (the *_mma_kernel kernels further down, with their own note). The
// decomposition is the same:
//
// FORWARD, allsteps_fwd_kernel: nll, correct, lse, each (R,) fp32. One block
// per 64-row tile (1 392 at tpu_fast) sweeps the N columns in 64-column
// tiles, keeping running statistics per row (cpc::RowStats). The TPU kernel
// carried them in scratch across a sequential grid axis; here the sweep is
// a loop inside the block.
//
// BACKWARD, given g (R,) fp32 and the forward's lse:
//   delta[r, n] = (exp(s - lse) - onehot) * g, in fp32, and with a bf16 wire
//   rounded to bf16, as the TPU kernels round it before the second product;
//   dpreds[r] = sum_n delta[r, n] z[n]     allsteps_dp_kernel, (B, Tp, K, D)
//   dz[n] = sum_r delta[r, n] preds[r]     allsteps_dz_kernel, (N, D)
// with fp32 sums; both outputs rounded once to the wire dtype. The dP
// kernel owns a row tile and sweeps the columns; the dZ kernel owns a
// column tile and sweeps the rows, as the TPU grid did serially into one
// resident accumulator, so no sum crosses blocks: no atomics, and the same
// result every run. Each keeps its output tile, 64 rows by a few 64-wide
// chunks of D, in registers: a block recomputes one score tile, forms
// delta, and feeds it to one product per chunk. D beyond those chunks goes
// to more blocks (gridDim.y), each recomputing the scores. In the SIMT
// kernels a block owns kChunks = 8 chunks (16 accumulators a thread each)
// and delta passes through shared memory.
//
// What bounds it on this card: operations. 2*R*N*D = 0.75 TFLOP forward,
// and the scores again plus two such products backward, at tpu_fast,
// against 91 MB of preds. The SIMT kernels reach about 13 TFLOP/s and the
// mma.sync kernels about 140 (H100 80GB HBM3, 700 W), of the 989 the card
// has for bf16: what is left is wgmma with TMA, a wider swept tile, and a
// backward that shares one recompute between dP and dZ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "mma.cuh"

namespace {

using cpc::from_f32;
using cpc::kTile;
using cpc::kTileThreads;
using cpc::round_to;
using cpc::TileRowStats;
using cpc::TileSmem;
using cpc::tile_mm;
using cpc::to_f32;

constexpr int kChunks = 8;  // 64-wide chunks of D a backward block owns

struct Geo {
  long long R;  // rows, Tp*K*B
  int N, T, B, K, D, Tp, shift;
  long long p_sb, p_st;  // preds: batch and time strides, in elements
};

// What a block knows of 64 vectors of one operand. Rows of preds carry
// their lse, cotangent and positive column; columns of the pool carry
// lse = 0, g = 1 and their own index, so that
//   delta = (exp(s - x.lse - y.lse) - (x.key == y.key)) * x.g * y.g
// reads the same whichever side the rows are on. Outside the problem
// ptr = nullptr (a zero vector) and g = 0, so delta = 0.
template <typename T>
struct Side {
  const T* ptr[kTile];
  long long out[kTile];  // offset of the vector's gradient in its output
  float lse[kTile], g[kTile];
  int key[kTile];
};

// Threads 0..63 fill `s` for rows [r0, r0 + 64); lse and gn may be nullptr
// (forward). No synchronisation.
template <typename T>
__device__ __forceinline__ void load_row_side(Side<T>& s, long long r0,
                                              const T* p, const float* lse,
                                              const float* gn, const Geo& g) {
  const int m = threadIdx.x;
  if (m >= kTile) return;
  const long long r = r0 + m;
  if (r < g.R) {
    const int i = static_cast<int>(r % g.B);
    const long long tk = r / g.B;
    const int k = static_cast<int>(tk % g.K), t = static_cast<int>(tk / g.K);
    s.ptr[m] = p + i * g.p_sb + t * g.p_st + static_cast<long long>(k) * g.D;
    s.out[m] = ((static_cast<long long>(i) * g.Tp + t) * g.K + k) * g.D;
    s.key[m] = (g.shift + i) * g.T + t + k + 1;
    s.lse[m] = lse ? lse[r] : 0.f;
    s.g[m] = gn ? gn[r] : 0.f;
  } else {
    s.ptr[m] = nullptr;
    s.out[m] = 0;
    s.key[m] = -1;
    s.lse[m] = s.g[m] = 0.f;
  }
}

// Threads 0..63 fill `s` for pool columns [c0, c0 + 64). No synchronisation.
template <typename T>
__device__ __forceinline__ void load_col_side(Side<T>& s, long long c0,
                                              const T* z, const Geo& g) {
  const int m = threadIdx.x;
  if (m >= kTile) return;
  const long long n = c0 + m;
  const bool in = n < g.N;
  s.ptr[m] = in ? z + n * g.D : nullptr;
  s.out[m] = n * g.D;
  s.key[m] = in ? static_cast<int>(n) : -2;
  s.lse[m] = 0.f;
  s.g[m] = in ? 1.f : 0.f;
}

template <typename T>
__device__ __forceinline__ void scores(const Side<T>& rows, const T* z,
                                       int c0, const Geo& g,
                                       float (&acc)[4][4], TileSmem& s) {
  cpc::score_tile<T>(
      [&](int m) -> const T* { return rows.ptr[m]; },
      [&](int n) -> const T* {
        return c0 + n < g.N ? z + static_cast<size_t>(c0 + n) * g.D : nullptr;
      },
      g.D, acc, s);
}

// delta of the thread's 4 x 4 scores into ds[row][column]. Columns beyond N
// and rows beyond R (g = 0) give 0. With a bf16 wire delta is rounded to
// bf16. Ends with __syncthreads().
template <typename T>
__device__ __forceinline__ void park_delta(const float (&acc)[4][4],
                                           const Side<T>& rows, int c0,
                                           int N,
                                           float (&ds)[kTile][kTile + 1]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      const float d =
          (expf(acc[i][j] - rows.lse[m]) - (c == rows.key[m] ? 1.f : 0.f)) *
          rows.g[m];
      ds[m][tx * 4 + j] = c < N ? round_to<T>(d) : 0.f;
    }
  }
  __syncthreads();
}

// Grid (ceil(R / 64)); block kTileThreads.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    allsteps_fwd_kernel(const T* __restrict__ p, const T* __restrict__ z,
                        float* __restrict__ nll, float* __restrict__ cor,
                        float* __restrict__ lse, Geo g) {
  __shared__ TileSmem smem;
  __shared__ Side<T> rows;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  load_row_side(rows, r0, p, nullptr, nullptr, g);
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int label[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) label[i] = rows.key[ty * 4 + i];
  TileRowStats st;
  st.init();
  for (int c0 = 0; c0 < g.N; c0 += kTile) {
    float acc[4][4];
    scores(rows, z, c0, g, acc, smem);
    st.update(acc, c0, g.N, label);
  }
  st.finish();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = r0 + ty * 4 + i;
      if (r >= g.R) continue;
      const float row_lse = st.lse(i);
      nll[r] = row_lse - st.s_lab[i];
      cor[r] = st.best_c[i] == label[i] ? 1.f : 0.f;
      lse[r] = row_lse;
    }
  }
}

// Grid (ceil(R / 64), ceil(D / (64 * kChunks))); dp (B, Tp, K, D) contiguous.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    allsteps_dp_kernel(const float* __restrict__ gn,
                       const float* __restrict__ lse, const T* __restrict__ p,
                       const T* __restrict__ z, T* __restrict__ dp, Geo g) {
  __shared__ TileSmem smem;
  __shared__ Side<T> rows;
  __shared__ float ds[kTile][kTile + 1];
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const int dbase = blockIdx.y * kTile * kChunks;
  load_row_side(rows, r0, p, lse, gn, g);
  __syncthreads();
  float out[kChunks][4][4] = {};
  for (int c0 = 0; c0 < g.N; c0 += kTile) {
    float acc[4][4];
    scores(rows, z, c0, g, acc, smem);
    park_delta<T>(acc, rows, c0, g.N, ds);
    const T* z_blk = z + static_cast<size_t>(c0) * g.D;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int d0 = dbase + ch * kTile;
      if (d0 >= g.D) break;  // block-uniform
      tile_mm<true, false>(
          kTile,
          [&](int c, int m) -> float { return ds[m][c]; },
          [&](int c, int n) -> float {
            return (c0 + c < g.N && d0 + n < g.D)
                       ? to_f32(z_blk[static_cast<size_t>(c) * g.D + d0 + n])
                       : 0.f;
          },
          out[ch], smem);
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      if (r0 + m >= g.R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dbase + ch * kTile + tx * 4 + j;
        if (d < g.D) dp[rows.out[m] + d] = from_f32<T>(out[ch][i][j]);
      }
    }
}

// Grid (ceil(N / 64), ceil(D / (64 * kChunks))); dz (N, D) contiguous.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    allsteps_dz_kernel(const float* __restrict__ gn,
                       const float* __restrict__ lse, const T* __restrict__ p,
                       const T* __restrict__ z, T* __restrict__ dz, Geo g) {
  __shared__ TileSmem smem;
  __shared__ Side<T> rows;
  __shared__ float ds[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile;
  const int dbase = blockIdx.y * kTile * kChunks;
  float out[kChunks][4][4] = {};
  for (long long r0 = 0; r0 < g.R; r0 += kTile) {
    load_row_side(rows, r0, p, lse, gn, g);
    __syncthreads();
    float acc[4][4];
    scores(rows, z, c0, g, acc, smem);
    park_delta<T>(acc, rows, c0, g.N, ds);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int d0 = dbase + ch * kTile;
      if (d0 >= g.D) break;  // block-uniform
      tile_mm<false, false>(
          kTile,
          [&](int r, int m) -> float { return ds[r][m]; },
          [&](int r, int n) -> float {
            const T* q = rows.ptr[r];
            return (q && d0 + n < g.D) ? to_f32(q[d0 + n]) : 0.f;
          },
          out[ch], smem);
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c >= g.N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dbase + ch * kTile + tx * 4 + j;
        if (d < g.D)
          dz[static_cast<size_t>(c) * g.D + d] = from_f32<T>(out[ch][i][j]);
      }
    }
}

// ---------------------------------------------------------------------
// The bf16 wire on the tensor cores (mma.sync m16n8k16, fp32 sums).
//
// One block is 4 warps and owns 64 vectors of one operand (its X side: 64
// prediction rows for the forward and dP, 64 pool columns for dZ), 16 to a
// warp, and sweeps the other operand (the Y side) in tiles of 64 vectors.
// A tile's work is a list of jobs, each on one 64 x 64 bf16 slab of X and
// of Y in shared memory: D/64 score jobs (S += X Y^T over a 64-deep slice
// of D; a warp's S, 16 x 64, is whole rows of the tile, so the softmax
// statistics need no exchange between warps), then for the backward up to
// kMmaChunks product jobs (out[:, 64-chunk of D] += delta Y, with Y's slab
// read transposed by ldmatrix). delta never leaves registers: the S
// fragments of two neighbouring 8-column tiles are, rounded to bf16, the A
// fragment of one 16-deep product step. For dZ the block computes S^T (X =
// columns), so that delta^T is again the A operand. The slabs sit in a ring
// of kStages buffers: cp.async brings in job q + kStages - 1 while the
// warps work on job q.
// kMmaChunks * 64 = 256 columns of D is what a thread's registers hold
// (128 fp32); D beyond that goes to gridDim.y, which recomputes S.
//
// cp.async moves 16 bytes, so this path needs D, the strides and the
// pointers to be multiples of 8 elements; other shapes, and the fp32 wire,
// take the SIMT kernels above.

using bf16_t = __nv_bfloat16;
using cpc::RowStats;

constexpr int kMmaThreads = 128;    // 4 warps x 16 vectors of the X side
constexpr int kSlab = kTile + 8;    // a slab row: 64 bf16 and 8 of padding,
                                    // which keeps ldmatrix off bank conflicts
constexpr int kMmaChunks = 4;       // 64-wide chunks of D a backward block owns
constexpr int kStages = 2;          // slabs in flight, the one in use
                                    // included; 3 measured no faster

template <bool kRows>
__device__ __forceinline__ void load_side(Side<bf16_t>& s, long long v0,
                                          const bf16_t* p, const bf16_t* z,
                                          const float* lse, const float* gn,
                                          const Geo& g) {
  if (kRows) {
    load_row_side(s, v0, p, lse, gn, g);
  } else {
    load_col_side(s, v0, z, g);
  }
}

// Starts the copy of elements [k0, k0 + 64) of the side's 64 vectors into
// `dst`, zero-filling beyond D and for vectors outside the problem. `safe`
// is any valid 16-byte aligned address, named where nothing is read.
__device__ __forceinline__ void stage(bf16_t (&dst)[kTile][kSlab],
                                      const Side<bf16_t>& side, int k0, int D,
                                      const bf16_t* safe) {
  for (int e = threadIdx.x; e < kTile * 8; e += kMmaThreads) {
    const int row = e >> 3, c = (e & 7) * 8;
    const bf16_t* q = side.ptr[row];
    const bool in = q != nullptr && k0 + c < D;
    cpc::cp_async16(&dst[row][c], in ? q + k0 + c : safe, in ? 16 : 0);
  }
}

// The block's shared memory: the ring of slabs, the X side, and the Y sides
// of the tiles the ring reaches into.
struct MmaSmem {
  alignas(16) bf16_t xs[kStages][kTile][kSlab];
  alignas(16) bf16_t ys[kStages][kTile][kSlab];
  Side<bf16_t> xm, ym[kStages];
};
static_assert(sizeof(MmaSmem) <= 48 * 1024,
              "more stages need dynamic shared memory");

// Before the work on job q: starts the copies of job q + kStages - 1
// (`fetch` stages nothing past the last job, and always closes a group, so
// the count of groups in flight stays the same), waits for job q's, and
// makes them visible to the block.
template <class Fetch>
__device__ __forceinline__ void next_job(long long q, const Fetch& fetch) {
  fetch(q + kStages - 1);
  cpc::cp_async_wait<kStages - 1>();
  __syncthreads();
}

// s (16 x 64 of this warp) += X[warp's 16 vectors] . Y[64 vectors]^T over
// the 64-deep slabs xt, yt.
__device__ __forceinline__ void score_mma(const bf16_t (&xt)[kTile][kSlab],
                                          const bf16_t (&yt)[kTile][kSlab],
                                          float (&s)[8][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    cpc::ldmatrix_x4(a, &xt[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // two 8-column tiles a load
      unsigned b[4];
      cpc::ldmatrix_x4(b, &yt[np * 16 + lane % 8 + (lane / 16) * 8]
                             [kk * 16 + ((lane / 8) % 2) * 8]);
      cpc::mma_bf16(s[2 * np], a, b[0], b[1]);
      cpc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// o (16 x 64 of this warp) += delta (16 x 64, as A fragments) . Y[64
// vectors][64-chunk of D], the slab yt read transposed. The tensor core's
// fp32 adder truncates, which over the thousands of steps of a sweep pulls
// a sum towards zero (7e-5 of the gradient norm at tpu_fast, measured), so
// the tile's product is summed from zero and joins the running sum by an
// ordinary rounded add.
__device__ __forceinline__ void product_mma(const bf16_t (&yt)[kTile][kSlab],
                                            const unsigned (&delta)[4][4],
                                            float (&o)[8][4]) {
  const int lane = threadIdx.x % 32;
  float t[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      unsigned b[4];
      cpc::ldmatrix_x4_trans(
          b, &yt[ks * 16 + lane % 16][dp * 16 + (lane / 16) * 8]);
      cpc::mma_bf16(t[2 * dp], delta[ks], b[0], b[1]);
      cpc::mma_bf16(t[2 * dp + 1], delta[ks], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] += t[nt][e];
}

// Grid (ceil(R / 64)); block kMmaThreads.
__global__ void __launch_bounds__(kMmaThreads)
    allsteps_fwd_mma_kernel(const bf16_t* __restrict__ p,
                            const bf16_t* __restrict__ z,
                            float* __restrict__ nll, float* __restrict__ cor,
                            float* __restrict__ lse, Geo g) {
  __shared__ MmaSmem sm;
  Side<bf16_t>& xm = sm.xm;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const int KC = (g.D + kTile - 1) / kTile;
  const int n_tiles = (g.N + kTile - 1) / kTile;
  const long long total = static_cast<long long>(n_tiles) * KC;
  load_row_side(xm, r0, p, nullptr, nullptr, g);
  for (int it = 0; it < kStages - 1 && it < n_tiles; ++it) {
    load_col_side(sm.ym[it], static_cast<long long>(it) * kTile, z, g);
  }
  __syncthreads();
  auto fetch = [&](long long q) {
    if (q < total) {
      const int it = static_cast<int>(q / KC), kc = static_cast<int>(q % KC);
      stage(sm.xs[q % kStages], xm, kc * kTile, g.D, z);
      stage(sm.ys[q % kStages], sm.ym[it % kStages], kc * kTile, g.D, z);
    }
    cpc::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) fetch(q);
  const int row[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  const int label[2] = {xm.key[row[0]], xm.key[row[1]]};
  RowStats<2, 4> st;
  st.init();
  long long q = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int ahead = it + kStages - 1;  // the farthest tile the ring reaches
    if (ahead < n_tiles) {
      load_col_side(sm.ym[ahead % kStages],
                    static_cast<long long>(ahead) * kTile, z, g);
      __syncthreads();
    }
    float s[8][4] = {};
    for (int kc = 0; kc < KC; ++kc, ++q) {
      next_job(q, fetch);
      score_mma(sm.xs[q % kStages], sm.ys[q % kStages], s);
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the thread's two rows
      float v[16];
      int col[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[nt * 2 + e] = s[nt][h * 2 + e];
          col[nt * 2 + e] = it * kTile + nt * 8 + (lane % 4) * 2 + e;
        }
      st.update_row(h, v, col, g.N, label[h]);
    }
  }
  st.finish();
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + row[h];
      if (r >= g.R) continue;
      const float row_lse = st.lse(h);
      nll[r] = row_lse - st.s_lab[h];
      cor[r] = st.best_c[h] == label[h] ? 1.f : 0.f;
      lse[r] = row_lse;
    }
  }
}

// The backward of one block: X = rows (dP, kOwnRows) or columns (dZ);
// out = dp (B, Tp, K, D) or dz (N, D), contiguous.
// Grid (ceil(|X| / 64), ceil(D / (64 * kMmaChunks))); block kMmaThreads.
template <bool kOwnRows>
__device__ __forceinline__ void bwd_mma_body(const float* __restrict__ gn,
                                             const float* __restrict__ lse,
                                             const bf16_t* __restrict__ p,
                                             const bf16_t* __restrict__ z,
                                             bf16_t* __restrict__ out,
                                             const Geo& g) {
  __shared__ MmaSmem sm;
  Side<bf16_t>& xm = sm.xm;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long x0 = static_cast<long long>(blockIdx.x) * kTile;
  const int dbase = blockIdx.y * kTile * kMmaChunks;
  const int left = (g.D - dbase + kTile - 1) / kTile;
  const int nch = left < kMmaChunks ? left : kMmaChunks;
  const int KC = (g.D + kTile - 1) / kTile;
  const int jobs = KC + nch;
  const long long ny = kOwnRows ? g.N : g.R;
  const long long n_tiles = (ny + kTile - 1) / kTile;
  const long long total = n_tiles * jobs;
  load_side<kOwnRows>(xm, x0, p, z, lse, gn, g);
  for (int it = 0; it < kStages - 1 && it < n_tiles; ++it) {
    load_side<!kOwnRows>(sm.ym[it], static_cast<long long>(it) * kTile, p, z,
                         lse, gn, g);
  }
  __syncthreads();
  auto fetch = [&](long long q) {
    if (q < total) {
      const long long it = q / jobs;
      const int j = static_cast<int>(q % jobs);
      const Side<bf16_t>& y = sm.ym[it % kStages];
      if (j < KC) {
        stage(sm.xs[q % kStages], xm, j * kTile, g.D, z);
        stage(sm.ys[q % kStages], y, j * kTile, g.D, z);
      } else {
        stage(sm.ys[q % kStages], y, dbase + (j - KC) * kTile, g.D, z);
      }
    }
    cpc::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) fetch(q);
  const int row[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  float acc[kMmaChunks][8][4] = {};
  long long q = 0;
  for (long long it = 0; it < n_tiles; ++it) {
    const long long ahead = it + kStages - 1;  // the farthest tile in the ring
    if (ahead < n_tiles) {
      load_side<!kOwnRows>(sm.ym[ahead % kStages], ahead * kTile, p, z, lse,
                           gn, g);
      __syncthreads();
    }
    float s[8][4] = {};
    for (int kc = 0; kc < KC; ++kc, ++q) {
      next_job(q, fetch);
      score_mma(sm.xs[q % kStages], sm.ys[q % kStages], s);
      __syncthreads();
    }
    // delta, rounded to bf16, as the A fragments of the product
    const Side<bf16_t>& y = sm.ym[it % kStages];
    unsigned delta[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xi = row[e / 2], yj = nt * 8 + (lane % 4) * 2 + (e & 1);
        d[e] = (expf(s[nt][e] - xm.lse[xi] - y.lse[yj]) -
                (xm.key[xi] == y.key[yj] ? 1.f : 0.f)) *
               (xm.g[xi] * y.g[yj]);
      }
      delta[nt / 2][(nt % 2) * 2] = cpc::pack_bf16(d[0], d[1]);
      delta[nt / 2][(nt % 2) * 2 + 1] = cpc::pack_bf16(d[2], d[3]);
    }
#pragma unroll
    for (int ch = 0; ch < kMmaChunks; ++ch) {
      if (ch >= nch) break;  // block-uniform
      next_job(q, fetch);
      product_mma(sm.ys[q % kStages], delta, acc[ch]);
      __syncthreads();
      ++q;
    }
  }
#pragma unroll
  for (int ch = 0; ch < kMmaChunks; ++ch)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (x0 + row[h] >= (kOwnRows ? g.R : static_cast<long long>(g.N))) {
        continue;
      }
      bf16_t* dst = out + xm.out[row[h]];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = dbase + ch * kTile + nt * 8 + (lane % 4) * 2;
        if (d < g.D) {  // D is even: the pair is inside, and 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
              acc[ch][nt][h * 2], acc[ch][nt][h * 2 + 1]);
        }
      }
    }
}

__global__ void __launch_bounds__(kMmaThreads)
    allsteps_dp_mma_kernel(const float* __restrict__ gn,
                           const float* __restrict__ lse,
                           const bf16_t* __restrict__ p,
                           const bf16_t* __restrict__ z,
                           bf16_t* __restrict__ dp, Geo g) {
  bwd_mma_body<true>(gn, lse, p, z, dp, g);
}

__global__ void __launch_bounds__(kMmaThreads)
    allsteps_dz_mma_kernel(const float* __restrict__ gn,
                           const float* __restrict__ lse,
                           const bf16_t* __restrict__ p,
                           const bf16_t* __restrict__ z,
                           bf16_t* __restrict__ dz, Geo g) {
  bwd_mma_body<false>(gn, lse, p, z, dz, g);
}

// Whether cp.async's 16 bytes fit the operands.
bool mma_ok(const Geo& g, const void* p, const void* z) {
  return g.D % 8 == 0 && g.p_sb % 8 == 0 && g.p_st % 8 == 0 &&
         reinterpret_cast<size_t>(p) % 16 == 0 &&
         reinterpret_cast<size_t>(z) % 16 == 0;
}

int tiles(long long n, int tile) {
  const long long x = (n + tile - 1) / tile;
  return x > 2147483647LL ? -1 : static_cast<int>(x);
}

bool geo_ok(const Geo& g) {
  return g.T >= 2 && g.B >= 1 && g.K >= 1 && g.D >= 1 && g.N >= 1 &&
         g.Tp == g.T - g.K && g.Tp >= 1 &&
         g.R == static_cast<long long>(g.Tp) * g.K * g.B &&
         tiles(g.R, kTile) >= 1 && tiles(g.D, kTile * kChunks) <= 65535;
}

template <typename T>
int launch_fwd(const void* p, const void* z, float* nll, float* cor,
               float* lse, const Geo& g, cudaStream_t s) {
  allsteps_fwd_kernel<T><<<tiles(g.R, kTile), kTileThreads, 0, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(z), nll, cor, lse, g);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_mma(const void* p, const void* z, float* nll, float* cor,
                   float* lse, const Geo& g, cudaStream_t s) {
  allsteps_fwd_mma_kernel<<<tiles(g.R, kTile), kMmaThreads, 0, s>>>(
      static_cast<const bf16_t*>(p), static_cast<const bf16_t*>(z), nll, cor,
      lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* gn, const float* lse, const void* p,
               const void* z, void* dp, void* dz, const Geo& g,
               cudaStream_t s) {
  const T* pt = static_cast<const T*>(p);
  const T* zt = static_cast<const T*>(z);
  const int dy = tiles(g.D, kTile * kChunks);
  allsteps_dp_kernel<T><<<dim3(tiles(g.R, kTile), dy), kTileThreads, 0, s>>>(
      gn, lse, pt, zt, static_cast<T*>(dp), g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  allsteps_dz_kernel<T><<<dim3(tiles(g.N, kTile), dy), kTileThreads, 0, s>>>(
      gn, lse, pt, zt, static_cast<T*>(dz), g);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_mma(const float* gn, const float* lse, const void* p,
                   const void* z, void* dp, void* dz, const Geo& g,
                   cudaStream_t s) {
  const bf16_t* pt = static_cast<const bf16_t*>(p);
  const bf16_t* zt = static_cast<const bf16_t*>(z);
  const int dy = tiles(g.D, kTile * kMmaChunks);
  allsteps_dp_mma_kernel<<<dim3(tiles(g.R, kTile), dy), kMmaThreads, 0, s>>>(
      gn, lse, pt, zt, static_cast<bf16_t*>(dp), g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  allsteps_dz_mma_kernel<<<dim3(tiles(g.N, kTile), dy), kMmaThreads, 0, s>>>(
      gn, lse, pt, zt, static_cast<bf16_t*>(dz), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward on `stream` of `device` and returns
// cudaGetLastError() (0 on success). p is preds (B, Tp, K, D) with batch and
// time strides p_sb, p_st (elements; the last two axes contiguous), z the
// pool (C*T, D) contiguous, both bf16 (bf16 != 0) or fp32; nll, cor, lse
// (Tp*K*B,) fp32. Does not synchronise.
int allsteps_nll_fwd(const void* p, const void* z, void* nll, void* cor,
                     void* lse, int T, int B, int C, int K, int D, int shift,
                     long long p_sb, long long p_st, int bf16, int device,
                     void* stream) {
  if (T <= K || static_cast<long long>(C) * T > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{static_cast<long long>(T - K) * K * B, C * T, T, B, K, D,
              T - K, shift, p_sb, p_st};
  if (!geo_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* n = static_cast<float*>(nll);
  float* c = static_cast<float*>(cor);
  float* l = static_cast<float*>(lse);
  if (!bf16) return launch_fwd<float>(p, z, n, c, l, g, s);
  return mma_ok(g, p, z) ? launch_fwd_mma(p, z, n, c, l, g, s)
                         : launch_fwd<__nv_bfloat16>(p, z, n, c, l, g, s);
}

// Launches the backward's two kernels on `stream` and returns the first
// launch error (0 on success). g, lse (Tp*K*B,) fp32; p, z and the strides
// as the forward. Outputs, contiguous and in p's dtype: dp (B, Tp, K, D) and
// dz (C*T, D). Does not synchronise.
int allsteps_nll_bwd(const void* g_nll, const void* lse, const void* p,
                     const void* z, void* dp, void* dz, int T, int B, int C,
                     int K, int D, int shift, long long p_sb, long long p_st,
                     int bf16, int device, void* stream) {
  if (T <= K || static_cast<long long>(C) * T > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{static_cast<long long>(T - K) * K * B, C * T, T, B, K, D,
              T - K, shift, p_sb, p_st};
  if (!geo_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gn = static_cast<const float*>(g_nll);
  const float* lf = static_cast<const float*>(lse);
  if (!bf16) return launch_bwd<float>(gn, lf, p, z, dp, dz, g, s);
  return mma_ok(g, p, z)
             ? launch_bwd_mma(gn, lf, p, z, dp, dz, g, s)
             : launch_bwd<__nv_bfloat16>(gn, lf, p, z, dp, dz, g, s);
}

}  // extern "C"
