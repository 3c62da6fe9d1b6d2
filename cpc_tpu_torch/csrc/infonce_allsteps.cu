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
// and is never transposed or copied), and the pool z_flat (N, D), N = C*T,
// contiguous, both in the wire dtype (bf16_t or fp32), and `shift`. Row
// r = (t*K + k)*B + i is preds[i, t, k]; there are R = Tp*K*B of them. Its
// positive is column (shift + i)*T + t + k + 1. Scores are fp32; argmax ties
// go to the lowest column, as jnp.argmax over the whole row.
//
// The (R, N) score matrix (89 088 x 8 192 at tpu_fast: T = 128, B = C = 64,
// K = 12, D = 512) is never stored, forward or backward: each kernel
// recomputes the tiles it needs.
//
// FORWARD: nll, correct, lse, each (R,) fp32. A block owns a tile of rows
// and sweeps the N columns in tiles, keeping running statistics per row
// (cpc::RowStats). The TPU kernel carried them in scratch across a
// sequential grid axis; here the sweep is a loop inside the block.
//
// BACKWARD, given g (R,) fp32 and the forward's lse:
//   delta[r, n] = (exp(s - lse) - onehot) * g, in fp32, and with a bf16 wire
//   rounded once to bf16, as the TPU kernels round it before the second
//   product;
//   dpreds[r] = sum_n delta[r, n] z[n]     the dP pass, (B, Tp, K, D)
//   dz[n] = sum_r delta[r, n] preds[r]     the dZ pass, (N, D)
// with fp32 sums; both outputs rounded once to the wire dtype. The dP pass
// owns row tiles and sweeps the columns; the dZ pass owns column tiles and
// sweeps the rows (it computes S^T, so that delta^T is again the left
// operand). No sum crosses blocks except dZ's row groups (below), which are
// added in a fixed order: no atomics, the same result every run.
//
// Two routes, chosen in Python (`allsteps_route`) and passed in; a route
// that cannot launch returns an error, and neither gives way to the other.
//
// "simt": the fp32 wire, which is the parity configuration, and bf16 shapes
// that 16-byte copies do not fit (or D > 576). Products on the SIMT fp32
// pipe through cpc::tile_mm: allsteps_fwd_kernel, allsteps_dp_kernel,
// allsteps_dz_kernel, each block 64 vectors by up to 512 of D (gridDim.y
// covers more D, recomputing the scores).
//
// "wgmma": the bf16 wire of the training path (D % 8 == 0, D <= 576,
// 16-byte aligned pointers and strides). What bounds it on this card:
// operations. 2*R*N*D = 0.747 TFLOP a pass over the scores at tpu_fast
// (3.26 at (R, N) = (194 304, 16 384)) against 91 MB of preds: 0.76 ms a
// pass at the card's 989 TFLOP/s. The design, for the tensor cores' rate:
// - Every product is `wgmma` (m64nNk16, bf16 in, fp32 sums), B always, and
//   A for the scores, from shared memory in the 128-byte-swizzled layout
//   its descriptors read: panels of 64 of D (128 bytes a vector), 8 vectors
//   an atom of 1 024 bytes, chunk c of vector v at v*128 + ((c ^ (v & 7))*16).
// - A block is two consumer warpgroups and a producer warpgroup (384
//   threads), of which one warp works; setmaxnreg gives each consumer
//   thread 232 registers and each producer thread 40. The block's own
//   vectors are copied once (cp.async, through preds' strides) and stay
//   resident in shared memory for the whole sweep. The producer streams the
//   swept operand through a ring with TMA (`cp.async.bulk.tensor`, 2-D
//   maps of 64 x rows boxes, zero outside the matrix, so ragged edges need
//   no mask): a slot's full barrier completes on the bytes that landed, and
//   each consumer warp marks it empty once its wgmma have read it. The
//   producer never waits for a copy: a producer that marked a slot full
//   only after its own cp.async.wait_group would hold every slot for a
//   round trip through itself (PERF.md §6 "PR 9").
// - Forward, allsteps_fwd_wgmma_kernel: 128 rows a block (64 a warpgroup),
//   128 x D resident (128 KB at D = 512), columns swept 128 at a time in
//   slots of one panel (16 KB, a ring of kFwdStages = 4). A warpgroup's
//   64 x 128 scores sum in registers over D's panels, wgmma one panel ahead
//   of the slot it releases. Row statistics are cpc::RowStats on wgmma's
//   accumulator layout (a quad of lanes holds a row): max, sum, the
//   positive's score and the first argmax need no exchange between warps.
// - Backward, allsteps_dp_wgmma_kernel / allsteps_dz_wgmma_kernel: 64 owned
//   vectors a block (64 x D resident), swept 64 at a time, a whole 64 x D
//   tile a slot (2 slots): the tile is the scores' B and, read MN-major, the
//   product's B, so it comes from L2 once. Each warpgroup computes the
//   64 x 64 scores (S^T for dZ), forms delta in registers, rounds it to bf16
//   A fragments (as FA3 does for P.V) and feeds them to its products over
//   its own 256 of D (4 chunks of 64; a block covers 512 of D, gridDim.y
//   more, each recomputing the scores). So a pass computes the scores twice
//   at D = 512, 4.5 TFLOP for the backward at tpu_fast in all. dZ's swept
//   rows are read from a contiguous (R, D) copy of preds in row order
//   (the wrapper's, for the TMA map: 0.12 ms at tpu_fast).
//   ROADMAP C4: the tensor core's fp32 adder truncates, which over a sweep
//   of thousands of tiles pulls a sum towards zero (7e-5 of the gradient
//   norm at tpu_fast, measured), so each tile's product is summed from zero
//   in its own 32 registers and joins the running sum by an ordinary add.
//   Registers a consumer thread: running sums 4 x 32, the tile's product 32
//   (the scores' 32 are dead by then), delta 16, of 232; ptxas reports 168
//   (the launch's count, before setmaxnreg) and no spills
//   (build/kernels/*.log).
// - dZ fills the card: its 64-column tiles (128 at tpu_fast) are fewer than
//   the SMs, so the rows are split into G contiguous groups of row tiles
//   (`allsteps_route` picks G so that the blocks cover every SM: 2 at
//   tpu_fast, 1 where the columns alone do). Block (column tile, D part,
//   group) writes its fp32 partial to a scratch of G x N x D floats, and
//   allsteps_dz_finish_kernel adds the G partials in group order and rounds
//   once to bf16: no atomics, the same bits every run.
// Shared memory: forward 1 KB + 128 x D x 2 + 64 KB (193 KB at D = 512);
// backward 1 KB + 3 x 64 x D x 2 (193 KB). One block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
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
// The "wgmma" route (see the note at the top).

using bf16_t = __nv_bfloat16;
using cpc::RowStats;

constexpr int kPanel = 64;        // bf16 of D in one 128-byte panel row
constexpr int kRowBytes = 128;    // bytes of a vector in one panel
constexpr int kMaxPanels = 9;     // D <= 576: what shared memory holds
constexpr int kConsumers = 2;     // consumer warpgroups a block
constexpr int kWThreads = (kConsumers + 1) * 128;  // and a producer warpgroup
constexpr int kProducerWarp = kConsumers * 4;      // its one working warp
constexpr int kConsumerWarps = kConsumers * 4;
// Registers a thread once the block has split (setmaxnreg): the launch
// gives each of the 384 threads 168; the producer warpgroup hands 128 of
// its 168 x 128 to the consumers, 2 x 128 x 64.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kFwdRows = 128;     // forward: rows a block, 64 a warpgroup
constexpr int kFwdCols = 128;     // forward: columns a swept tile
constexpr int kFwdStages = 4;     // forward ring: (column tile, panel) slots
constexpr int kFwdSlot = kFwdCols * kRowBytes;
constexpr int kBwdVecs = 64;      // backward: owned and swept vectors a tile
constexpr int kBwdStages = 2;     // backward ring: whole swept tiles
constexpr int kBwdChunks = 4;     // 64-wide chunks of D a warpgroup owns
constexpr int kBwdPart = kConsumers * kBwdChunks * kPanel;  // D a block: 512

using cpc::align_1024;
using cpc::desc_sw128;
using cpc::EncodeTiled;
using cpc::fence_async_smem;
using cpc::fence_barrier_init;
using cpc::fence_regs;
using cpc::mbar_arrive;
using cpc::mbar_arrive_tx;
using cpc::mbar_init;
using cpc::mbar_wait;
using cpc::setmaxnreg_dec;
using cpc::setmaxnreg_inc;
using cpc::tma_load;
using cpc::wgmma_commit;
using cpc::wgmma_fence;
using cpc::wgmma_m64n128_ss;
using cpc::wgmma_m64n64_rs_mn;
using cpc::wgmma_m64n64_ss;
using cpc::wgmma_wait;

// Row r's (i, t, k) and what follows from them.
struct RowAt {
  const bf16_t* ptr;  // preds[i, t, k]
  long long out;      // offset of dpreds[i, t, k] in the contiguous output
  int key;            // its positive column
};

__device__ __forceinline__ RowAt row_at(long long r, const bf16_t* p,
                                        const Geo& g) {
  const int i = static_cast<int>(r % g.B);
  const long long tk = r / g.B;
  const int k = static_cast<int>(tk % g.K), t = static_cast<int>(tk / g.K);
  return {p + i * g.p_sb + t * g.p_st + static_cast<long long>(k) * g.D,
          ((static_cast<long long>(i) * g.Tp + t) * g.K + k) * g.D,
          (g.shift + i) * g.T + t + k + 1};
}

// Copies the block's `vecs` own vectors (pointers xptr, nullptr outside the
// problem) into the panels at xs with every thread of the block, 16 bytes a
// copy, neighbouring threads along a vector, zero beyond D; then makes them
// visible to wgmma. `safe` is any valid 16-byte aligned address, named where
// nothing is read. Ends with __syncthreads().
__device__ __forceinline__ void stage_own(unsigned char* xs, int vecs,
                                          const bf16_t* const* xptr, int D,
                                          const bf16_t* safe) {
  const int per = ((D + kPanel - 1) / kPanel) * 8;  // chunks a vector
  for (int e = threadIdx.x; e < vecs * per; e += kWThreads) {
    const int v = e / per, c = e % per, ch = c & 7;
    const bool in = xptr[v] != nullptr && c * 8 < D;
    cpc::cp_async16(xs + (c >> 3) * vecs * kRowBytes + v * kRowBytes +
                        ((ch ^ (v & 7)) << 4),
                    in ? xptr[v] + c * 8 : safe, in ? 16 : 0);
  }
  cpc::cp_async_commit();
  cpc::cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
}

// The producer warp's loop over `jobs` slots of a ring of kStages: once the
// consumers' kConsumerWarps arrivals have marked a slot empty, fill(q, slot)
// starts job q's TMA copies and arrives on the slot's full barrier, whose
// phase completes when the copies' bytes have landed. The producer never
// waits for a copy.
template <int kStages, class Fill>
__device__ __forceinline__ void produce(int jobs, uint64_t* empty,
                                        const Fill& fill) {
  for (int q = 0; q < jobs; ++q) {
    const int s = q % kStages;
    if (q >= kStages) mbar_wait(&empty[s], ((q / kStages) - 1) & 1);
    fill(q, s);
  }
}

// A consumer warp is done with a slot (its wgmma reading it have completed).
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
  __syncwarp();
}

// Grid (ceil(R / 128)); block kWThreads; dynamic shared memory
// fwd_smem_bytes(D).
__global__ void __launch_bounds__(kWThreads, 1)
    allsteps_fwd_wgmma_kernel(const bf16_t* __restrict__ p,
                              const bf16_t* __restrict__ z,
                              float* __restrict__ nll,
                              float* __restrict__ cor,
                              float* __restrict__ lse, Geo g,
                              const __grid_constant__ CUtensorMap zmap) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kFwdStages], empty[kFwdStages];
  __shared__ const bf16_t* xptr[kFwdRows];
  unsigned char* xs = align_1024(smem_raw);
  const int KC = (g.D + kPanel - 1) / kPanel;
  unsigned char* ring = xs + KC * kFwdRows * kRowBytes;
  const long long r0 = static_cast<long long>(blockIdx.x) * kFwdRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < kFwdRows) {
    xptr[tid] = r0 + tid < g.R ? row_at(r0 + tid, p, g).ptr : nullptr;
  }
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  stage_own(xs, kFwdRows, xptr, g.D, z);
  const int n_tiles = (g.N + kFwdCols - 1) / kFwdCols;
  const int jobs = n_tiles * KC;

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    produce<kFwdStages>(jobs, empty, [&](int q, int s) {
      if (lane == 0) {  // slot: 128 columns x one panel of D
        mbar_arrive_tx(&full[s], kFwdSlot);
        tma_load(ring + s * kFwdSlot, &zmap, (q % KC) * kPanel,
                 (q / KC) * kFwdCols, &full[s]);
      }
    });
    return;
  }

  // a consumer: warpgroup wg owns rows 64*wg.., the thread rows[h] below
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, lw = warp % 4;
  long long row[2];
  int label[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + wg * 64 + lw * 16 + lane / 4 + 8 * h;
    label[h] = row[h] < g.R ? row_at(row[h], p, g).key : -1;
  }
  RowStats<2, 4> st;
  st.init();
  const unsigned xa = cpc::smem_addr(xs) + wg * 64 * kRowBytes;
  const unsigned ra = cpc::smem_addr(ring);
  float acc[64] = {};
  int q = 0;
  for (int j = 0; j < n_tiles; ++j) {
    for (int pnl = 0; pnl < KC; ++pnl, ++q) {
      const int s = q % kFwdStages;
      mbar_wait(&full[s], (q / kFwdStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128_ss(
            acc, desc_sw128(xa + pnl * kFwdRows * kRowBytes + kk * 32),
            desc_sw128(ra + s * kFwdSlot + kk * 32), pnl > 0 || kk > 0);
      }
      wgmma_commit();
      if (pnl > 0) {
        wgmma_wait<1>();
        release(&empty[(q - 1) % kFwdStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(&empty[(q - 1) % kFwdStages]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the thread's two rows
      float v[32];
      int col[32];
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[jn * 2 + e] = acc[jn * 4 + h * 2 + e];
          col[jn * 2 + e] = j * kFwdCols + jn * 8 + (lane % 4) * 2 + e;
        }
      st.update_row(h, v, col, g.N, label[h]);
    }
  }
  st.finish();
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= g.R) continue;
      const float row_lse = st.lse(h);
      nll[row[h]] = row_lse - st.s_lab[h];
      cor[row[h]] = st.best_c[h] == label[h] ? 1.f : 0.f;
      lse[row[h]] = row_lse;
    }
  }
}

// The backward of one block: it owns 64 vectors X (rows of preds for dP,
// kOwnRows; columns of the pool for dZ) and sweeps tiles of 64 vectors Y of
// the other operand: all column tiles for dP, the row tiles of its group
// for dZ. Writes dp (B, Tp, K, D) bf16 for dP, its group's fp32 partial
// part[group] (N, D) for dZ. Grid (ceil(|X| / 64), D parts x groups); block
// kWThreads; dynamic shared memory bwd_smem_bytes(D).
template <bool kOwnRows>
__device__ __forceinline__ void bwd_wgmma_body(
    const float* __restrict__ gn, const float* __restrict__ lse,
    const bf16_t* __restrict__ p, const bf16_t* __restrict__ z,
    bf16_t* __restrict__ dp, float* __restrict__ part, const Geo& g,
    int groups, const CUtensorMap* ymap) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kBwdStages], empty[kBwdStages];
  __shared__ const bf16_t* xptr[kBwdVecs];
  // the swept vectors' lse, g and key, a slot each; columns of the pool
  // carry lse = 0, g = 1 and their own index, rows of preds theirs, so that
  //   delta = (exp(s - x.lse - y.lse) - (x.key == y.key)) * (x.g * y.g)
  // reads the same whichever side the rows are on (and equals the plain
  // version's (exp(s - lse) - onehot) * g bit for bit); outside the problem
  // a zero vector with g = 0.
  __shared__ float y_lse[kBwdStages][kBwdVecs], y_g[kBwdStages][kBwdVecs];
  __shared__ int y_key[kBwdStages][kBwdVecs];
  unsigned char* xs = align_1024(smem_raw);
  const int KC = (g.D + kPanel - 1) / kPanel;
  const int tile_bytes = KC * kBwdVecs * kRowBytes;
  unsigned char* ring = xs + tile_bytes;
  const long long x0 = static_cast<long long>(blockIdx.x) * kBwdVecs;
  const int d_parts = (g.D + kBwdPart - 1) / kBwdPart;
  const int dpart = blockIdx.y % d_parts, group = blockIdx.y / d_parts;
  const long long n_x = kOwnRows ? g.R : g.N;
  long long y_lo = 0, y_hi = (g.N + kBwdVecs - 1) / kBwdVecs;
  if (!kOwnRows) {
    const long long row_tiles = (g.R + kBwdVecs - 1) / kBwdVecs;
    y_lo = group * row_tiles / groups;
    y_hi = (group + 1) * row_tiles / groups;
  }
  const int jobs = static_cast<int>(y_hi - y_lo);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < kBwdVecs) {
    const long long v = x0 + tid;
    xptr[tid] = v >= n_x ? nullptr
                : kOwnRows ? row_at(v, p, g).ptr
                           : z + static_cast<size_t>(v) * g.D;
  }
  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes, after the side arrays
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  stage_own(xs, kBwdVecs, xptr, g.D, z);

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    produce<kBwdStages>(jobs, empty, [&](int q, int s) {
      const long long v0 = (y_lo + q) * kBwdVecs;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // vectors lane and lane + 32
        const int m = lane + 32 * h;
        const long long v = v0 + m;
        if (!kOwnRows) {  // Y = rows of preds
          const bool in = v < g.R;
          y_lse[s][m] = in ? lse[v] : 0.f;
          y_g[s][m] = in ? gn[v] : 0.f;
          y_key[s][m] = in ? row_at(v, p, g).key : -1;
        } else {  // Y = columns of the pool
          const bool in = v < g.N;
          y_lse[s][m] = 0.f;
          y_g[s][m] = in ? 1.f : 0.f;
          y_key[s][m] = in ? static_cast<int>(v) : -2;
        }
      }
      if (lane == 0) {  // slot: the 64 vectors of the tile, all D's panels
        mbar_arrive_tx(&full[s], tile_bytes);
        for (int pnl = 0; pnl < KC; ++pnl) {
          tma_load(ring + s * tile_bytes + pnl * kBwdVecs * kRowBytes, ymap,
                   pnl * kPanel, static_cast<int>(v0), &full[s]);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    });
    return;
  }

  // a consumer: both warpgroups hold the scores of all 64 X vectors (rows
  // 16*lw + lane/4 + 8h of the thread) and own 256 of D each for the product
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, lw = warp % 4;
  float x_lse[2], x_g[2];
  int x_key[2];
  long long xv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xv[h] = x0 + lw * 16 + lane / 4 + 8 * h;
    const bool in = xv[h] < n_x;
    if (kOwnRows) {
      x_lse[h] = in ? lse[xv[h]] : 0.f;
      x_g[h] = in ? gn[xv[h]] : 0.f;
      x_key[h] = in ? row_at(xv[h], p, g).key : -1;
    } else {
      x_lse[h] = 0.f;
      x_g[h] = in ? 1.f : 0.f;
      x_key[h] = in ? static_cast<int>(xv[h]) : -2;
    }
  }
  const int dbase = dpart * kBwdPart + wg * kBwdChunks * kPanel;
  const int left = (g.D - dbase + kPanel - 1) / kPanel;
  const int nch = left < 0 ? 0 : (left < kBwdChunks ? left : kBwdChunks);
  const unsigned xa = cpc::smem_addr(xs);
  const unsigned ra = cpc::smem_addr(ring);
  float run[kBwdChunks][32];
#pragma unroll
  for (int c = 0; c < kBwdChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) run[c][i] = 0.f;

  for (int q = 0; q < jobs; ++q) {
    const int s = q % kBwdStages;
    const unsigned slot = ra + s * tile_bytes;
    mbar_wait(&full[s], (q / kBwdStages) & 1);
    // the 64 x 64 scores (S^T for dZ), summed over D's panels
    float sc[32];
    fence_regs(sc);
    wgmma_fence();
    for (int pnl = 0; pnl < KC; ++pnl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned off = pnl * kBwdVecs * kRowBytes + kk * 32;
        wgmma_m64n64_ss(sc, desc_sw128(xa + off), desc_sw128(slot + off),
                        pnl > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // delta, rounded to bf16, as the A fragments of the product: the
    // accumulators of n8 tiles 2kk and 2kk+1 are the fragment of K-step kk
    unsigned dl[4][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, y = jn * 8 + (lane % 4) * 2 + (e & 1);
        d[e] = (expf(sc[jn * 4 + e] - x_lse[h] - y_lse[s][y]) -
                (x_key[h] == y_key[s][y] ? 1.f : 0.f)) *
               (x_g[h] * y_g[s][y]);
      }
      dl[jn / 2][(jn % 2) * 2] = cpc::pack_bf16(d[0], d[1]);
      dl[jn / 2][(jn % 2) * 2 + 1] = cpc::pack_bf16(d[2], d[3]);
    }
    // out[:, chunk c] += delta . Y[:, chunk c], Y's panel read MN-major;
    // summed from zero a tile, then added (ROADMAP C4)
#pragma unroll
    for (int c = 0; c < kBwdChunks; ++c) {
      if (c >= nch) break;  // warpgroup-uniform
      const unsigned panel = slot + (dbase / kPanel + c) * kBwdVecs * kRowBytes;
      float t[32];
      fence_regs(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64_rs_mn(t, dl[kk], desc_sw128(panel + kk * 16 * kRowBytes),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) run[c][i] += t[i];
    }
    release(&empty[s]);
  }

#pragma unroll
  for (int c = 0; c < kBwdChunks; ++c) {
    if (c >= nch) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (xv[h] >= n_x) continue;
      const long long base =
          kOwnRows ? row_at(xv[h], p, g).out
                   : (static_cast<long long>(group) * g.N + xv[h]) * g.D;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int d = dbase + c * kPanel + jn * 8 + (lane % 4) * 2;
        if (d >= g.D) continue;  // D % 8 == 0: the pair is inside
        const float a = run[c][jn * 4 + h * 2], b = run[c][jn * 4 + h * 2 + 1];
        if (kOwnRows) {
          *reinterpret_cast<__nv_bfloat162*>(dp + base + d) =
              __floats2bfloat162_rn(a, b);
        } else {
          *reinterpret_cast<float2*>(part + base + d) = make_float2(a, b);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
    allsteps_dp_wgmma_kernel(const float* __restrict__ gn,
                             const float* __restrict__ lse,
                             const bf16_t* __restrict__ p,
                             const bf16_t* __restrict__ z,
                             bf16_t* __restrict__ dp, Geo g,
                             const __grid_constant__ CUtensorMap zmap) {
  bwd_wgmma_body<true>(gn, lse, p, z, dp, nullptr, g, 1, &zmap);
}

__global__ void __launch_bounds__(kWThreads, 1)
    allsteps_dz_wgmma_kernel(const float* __restrict__ gn,
                             const float* __restrict__ lse,
                             const bf16_t* __restrict__ p,
                             const bf16_t* __restrict__ z,
                             float* __restrict__ part, Geo g, int groups,
                             const __grid_constant__ CUtensorMap rowmap) {
  bwd_wgmma_body<false>(gn, lse, p, z, nullptr, part, g, groups, &rowmap);
}

// dz = bf16(part[0] + part[1] + ... + part[groups - 1]), added in that
// order; n4 = N*D / 4 (D % 8 == 0).
__global__ void __launch_bounds__(256)
    allsteps_dz_finish_kernel(const float4* __restrict__ part,
                              __nv_bfloat162* __restrict__ dz, long long n4,
                              int groups) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * 256) {
    float4 a = part[i];
    for (int q = 1; q < groups; ++q) {
      const float4 b = part[q * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    dz[2 * i] = __floats2bfloat162_rn(a.x, a.y);
    dz[2 * i + 1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

// Whether the wgmma route's copies and shared memory fit the operands:
// 16-byte copies (D, the strides and the pointers multiples of 8 elements)
// and at most kMaxPanels panels of D.
bool wgmma_ok(const Geo& g, const void* p, const void* z) {
  return g.D % 8 == 0 && g.D <= kMaxPanels * kPanel && g.p_sb % 8 == 0 &&
         g.p_st % 8 == 0 && reinterpret_cast<size_t>(p) % 16 == 0 &&
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

int panels(int D) { return (D + kPanel - 1) / kPanel; }

// Dynamic shared memory: 1 KB to align the panels to 1 024 bytes, the own
// vectors, the ring.
int fwd_smem_bytes(int D) {
  return 1024 + panels(D) * (kFwdRows * kRowBytes) + kFwdStages * kFwdSlot;
}

int bwd_smem_bytes(int D) {
  return 1024 + (1 + kBwdStages) * panels(D) * kBwdVecs * kRowBytes;
}

// The TMA map of a contiguous (rows, D) bf16 matrix, read in boxes of
// `box_rows` vectors by one 64-wide panel of D, 128-byte swizzled (the
// layout of the wgmma descriptors), zero outside the matrix.
int vector_map(CUtensorMap* map, const void* base, long long rows, int D,
               int box_rows) {
  EncodeTiled encode = nullptr;
  const int found = cpc::tensor_map_encoder(&encode);
  if (found) return found;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kPanel, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <class Kernel>
int allow_smem(Kernel* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int launch_fwd(const void* p, const void* z, float* nll, float* cor,
               float* lse, const Geo& g, cudaStream_t s) {
  allsteps_fwd_kernel<T><<<tiles(g.R, kTile), kTileThreads, 0, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(z), nll, cor, lse, g);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_wgmma(const void* p, const void* z, float* nll, float* cor,
                     float* lse, const Geo& g, cudaStream_t s) {
  const int smem = fwd_smem_bytes(g.D);
  CUtensorMap zmap;
  int err = vector_map(&zmap, z, g.N, g.D, kFwdCols);
  if (err) return err;
  err = allow_smem(allsteps_fwd_wgmma_kernel, smem);
  if (err) return err;
  allsteps_fwd_wgmma_kernel<<<tiles(g.R, kFwdRows), kWThreads, smem, s>>>(
      static_cast<const bf16_t*>(p), static_cast<const bf16_t*>(z), nll, cor,
      lse, g, zmap);
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

int launch_bwd_wgmma(const float* gn, const float* lse, const void* p,
                     const void* z, const void* rows, void* dp, void* dz,
                     float* part, int groups, const Geo& g, cudaStream_t s) {
  const bf16_t* pt = static_cast<const bf16_t*>(p);
  const bf16_t* zt = static_cast<const bf16_t*>(z);
  const int smem = bwd_smem_bytes(g.D);
  const int d_parts = tiles(g.D, kBwdPart);
  CUtensorMap zmap, rowmap;
  int err = vector_map(&zmap, z, g.N, g.D, kBwdVecs);
  if (err) return err;
  err = vector_map(&rowmap, rows, g.R, g.D, kBwdVecs);
  if (err) return err;
  err = allow_smem(allsteps_dp_wgmma_kernel, smem);
  if (err) return err;
  err = allow_smem(allsteps_dz_wgmma_kernel, smem);
  if (err) return err;
  allsteps_dp_wgmma_kernel<<<dim3(tiles(g.R, kBwdVecs), d_parts), kWThreads,
                             smem, s>>>(gn, lse, pt, zt,
                                        static_cast<bf16_t*>(dp), g, zmap);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  allsteps_dz_wgmma_kernel<<<dim3(tiles(g.N, kBwdVecs), d_parts * groups),
                             kWThreads, smem, s>>>(gn, lse, pt, zt, part, g,
                                                   groups, rowmap);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n4 = static_cast<long long>(g.N) * g.D / 4;
  const long long blocks = (n4 + 255) / 256;
  allsteps_dz_finish_kernel<<<static_cast<int>(blocks < 65535 ? blocks
                                                               : 65535),
                              256, 0, s>>>(
      reinterpret_cast<const float4*>(part),
      static_cast<__nv_bfloat162*>(dz), n4, groups);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kRouteSimt = 0, kRouteWgmma = 1;  // allsteps_route's names

}  // namespace

extern "C" {

// Launches the forward on `stream` of `device` and returns
// cudaGetLastError() (0 on success). p is preds (B, Tp, K, D) with batch and
// time strides p_sb, p_st (elements; the last two axes contiguous), z the
// pool (C*T, D) contiguous, both bf16 (bf16 != 0) or fp32; nll, cor, lse
// (Tp*K*B,) fp32. route: 0 the SIMT kernel, 1 the wgmma kernel (bf16 that
// wgmma_ok takes; anything else is cudaErrorInvalidValue). Does not
// synchronise.
int allsteps_nll_fwd(const void* p, const void* z, void* nll, void* cor,
                     void* lse, int T, int B, int C, int K, int D, int shift,
                     long long p_sb, long long p_st, int bf16, int route,
                     int device, void* stream) {
  if (T <= K || static_cast<long long>(C) * T > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{static_cast<long long>(T - K) * K * B, C * T, T, B, K, D,
              T - K, shift, p_sb, p_st};
  if (!geo_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wgmma = route == kRouteWgmma;
  if ((route != kRouteSimt && !wgmma) ||
      (wgmma && !(bf16 && wgmma_ok(g, p, z)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* n = static_cast<float*>(nll);
  float* c = static_cast<float*>(cor);
  float* l = static_cast<float*>(lse);
  if (wgmma) return launch_fwd_wgmma(p, z, n, c, l, g, s);
  return bf16 ? launch_fwd<__nv_bfloat16>(p, z, n, c, l, g, s)
              : launch_fwd<float>(p, z, n, c, l, g, s);
}

// Launches the backward's kernels on `stream` and returns the first launch
// error (0 on success). g, lse (Tp*K*B,) fp32; p, z and the strides as the
// forward. Outputs, contiguous and in p's dtype: dp (B, Tp, K, D) and dz
// (C*T, D). route as the forward; the wgmma route also takes `groups`, the
// dZ pass's row groups (1 <= groups <= ceil(R / 64)), part, a scratch of
// groups x C*T x D fp32, and rows, preds as a contiguous (R, D) matrix in
// row order (what its TMA map reads). Does not synchronise.
int allsteps_nll_bwd(const void* g_nll, const void* lse, const void* p,
                     const void* z, void* dp, void* dz, void* part,
                     const void* rows, int T,
                     int B, int C, int K, int D, int shift, long long p_sb,
                     long long p_st, int bf16, int route, int groups,
                     int device, void* stream) {
  if (T <= K || static_cast<long long>(C) * T > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{static_cast<long long>(T - K) * K * B, C * T, T, B, K, D,
              T - K, shift, p_sb, p_st};
  if (!geo_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wgmma = route == kRouteWgmma;
  if ((route != kRouteSimt && !wgmma) ||
      (wgmma && !(bf16 && wgmma_ok(g, p, z) && part != nullptr &&
                  rows != nullptr && reinterpret_cast<size_t>(rows) % 16 == 0 &&
                  groups >= 1 && groups <= tiles(g.R, kBwdVecs) &&
                  static_cast<long long>(tiles(g.D, kBwdPart)) * groups <=
                      65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gn = static_cast<const float*>(g_nll);
  const float* lf = static_cast<const float*>(lse);
  if (wgmma) {
    return launch_bwd_wgmma(gn, lf, p, z, rows, dp, dz,
                            static_cast<float*>(part), groups, g, s);
  }
  return bf16 ? launch_bwd<__nv_bfloat16>(gn, lf, p, z, dp, dz, g, s)
              : launch_bwd<float>(gn, lf, p, z, dp, dz, g, s);
}

}  // extern "C"
