// Causal flash attention, forward and backward, for Hopper (sm_90a), bound
// to Python with ctypes (cpc_tpu_torch/ops/attention_cuda.py; built by
// cpc_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of cpc_tpu/ops/attention_pallas.py: `_fwd_kernel`
// (launched by `_flash_fwd`), and `_dq_kernel` and `_dkv_kernel` (launched by
// `_flash_bwd_rule`).
//
// Inputs: q, k, v and, backward, dO: (B, T, H, Dh) in the wire dtype (bf16
// or fp32), each read through its own batch, time and head strides (the
// last axis contiguous), which is the layout the projections produce, so
// heads are never folded into a transposed copy. Outputs o, dq, dk, dv are
// (B, T, H, Dh) contiguous in the wire dtype; lse and dres = rowsum(dO * O)
// are (B*H, T) fp32.
//
//   S = Q K^T * scale (fp32, scale after the product), -1e30 where
//       col > row; softmax statistics in fp32
//   forward:   o = softmax(S) V, lse = max + log(sum)
//   backward:  P = exp(S - lse), dS = P * (dO V^T - dres) * scale,
//              dQ = dS K, dV = P^T dO, dK = dS^T Q
// Q K^T takes the inputs as they are; the other four products (and P V)
// take their operands rounded to p_dtype (fp32: not rounded; bf16: the
// 'flash16' mode), with fp32 sums. The (T, T) scores are never stored.
//
// The TPU kernels pad T to their 128-wide tiles, fold heads into a leading
// grid axis, and carry max, sum and the output tile in scratch across a
// sequential k-fastest (or q-fastest) grid. Here a block owns 64 query rows
// (forward, dQ) or 64 key rows (dK/dV) of one (batch, head), sweeps the
// other axis in 64-wide tiles only as far as the diagonal (forward, dQ) or
// from it (dK/dV) in a loop of its own, keeps its statistics and output
// tile in registers, and masks the ragged edge of T by bounds. No sum
// crosses blocks: no atomics, the same result every run.
//
// Each kernel exists twice. fp32 inputs run every product on the SIMT fp32
// pipe through cpc::tile_mm (Dh <= 128; TF32 would drop mantissa bits the
// reference keeps). bf16 inputs run on the tensor cores (the *_mma_kernel
// kernels further down, with their own note) when Dh is 16, 32 or 64 and
// 16-byte copies fit the strides: Q K^T and dO V^T always, and under bf16 P
// ('flash16') the other products too; under fp32 P ('flash') those have no
// exact tensor-core form and stay on the SIMT pipe inside the same kernels.
// Other bf16 shapes take the SIMT kernels.
//
// What bounds it on this card: at the transformer preset (B*H = 512,
// T = 128, Dh = 32) the four tensors of a forward are 4 MB each and the
// causal products about 0.3 GFLOP, so the least time is a few
// microseconds, by bytes; launch latency and the fill of 132 SMs by 1 024
// short blocks decide the time, not the products. At long T the work grows
// as T^2 and operations bound it. Left for later: wgmma with TMA, a
// backward that shares one recompute of P between dQ and dK/dV, and for
// T = 128 one block per (batch, head) that keeps K and V resident.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16_t = __nv_bfloat16;
using cpc::from_f32;
using cpc::kTile;
using cpc::kTileThreads;
using cpc::round_to;
using cpc::TileSmem;
using cpc::tile_mm;
using cpc::to_f32;

constexpr float kNeg = -1e30f;  // a masked score
constexpr int kMaxChunks = 2;   // 64-wide chunks of Dh the SIMT kernels hold

struct Strides {
  long long b, t, h;  // batch, time, head, in elements
};

struct Geo {
  int B, T, H, Dh, n_tiles;
  float scale;
  Strides q, k, v, g;  // g: the cotangent dO
};

// A block's (batch, head) and tile. Later q tiles sweep more k tiles and
// earlier k tiles more q tiles, so the long blocks are scheduled first.
struct Where {
  int b, h, bh, tile;
};

template <bool kHeavyLast>
__device__ __forceinline__ Where where(const Geo& g) {
  const int bh = blockIdx.x / g.n_tiles, t = blockIdx.x % g.n_tiles;
  return {bh / g.H, bh % g.H, bh, kHeavyLast ? g.n_tiles - 1 - t : t};
}

template <typename T>
__device__ __forceinline__ const T* head(const T* x, const Strides& s,
                                         const Where& w) {
  return x + w.b * s.b + w.h * s.h;
}

// Offset of row t of the block's (batch, head) in a contiguous
// (B, T, H, Dh) output.
__device__ __forceinline__ size_t out_row(const Geo& g, const Where& w,
                                          int t) {
  return ((static_cast<size_t>(w.b) * g.T + t) * g.H + w.h) * g.Dh;
}

// An element as a post-softmax product sees it: rounded to bf16 when
// p_dtype is bf16 (a no-op for a bf16 element).
template <bool kRound, typename T>
__device__ __forceinline__ float operand(T x) {
  return kRound ? round_to<bf16_t>(to_f32(x)) : to_f32(x);
}

template <bool kRound>
__device__ __forceinline__ float rounded(float x) {
  return kRound ? round_to<bf16_t>(x) : x;
}

// acc[i][j] = x[x0 + ty*4 + i] . y[y0 + tx*4 + j] over Dh, rows at or beyond
// T reading as zero; xs, ys the time strides.
template <bool kRound, typename T>
__device__ __forceinline__ void dot_tile(const T* x, long long xs, int x0,
                                         const T* y, long long ys, int y0,
                                         const Geo& g, float (&acc)[4][4],
                                         TileSmem& s) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  tile_mm<true, true>(
      g.Dh,
      [&](int d, int m) -> float {
        return x0 + m < g.T ? operand<kRound>(x[(x0 + m) * xs + d]) : 0.f;
      },
      [&](int d, int n) -> float {
        return y0 + n < g.T ? operand<kRound>(y[(y0 + n) * ys + d]) : 0.f;
      },
      acc, s);
}

// out[ch] (64 x 64-chunk of Dh) += w^T-or-w (64 x 64, in shared memory) .
// y[y0 .. y0 + 64)[chunk]: with kTransposed out[m][n] += sum_c w[c][m]
// y[c][n] (dV, dK: the block's columns are the output rows), else
// out[m][n] += sum_c w[m][c] y[c][n] (o, dQ).
template <bool kTransposed, bool kRound, int kChunks, typename T>
__device__ __forceinline__ void weighted_rows(
    const float (&w)[kTile][kTile + 1], const T* y, long long ys, int y0,
    const Geo& g, float (&out)[kChunks][4][4], TileSmem& s) {
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    const int d0 = ch * kTile;
    if (d0 >= g.Dh) break;  // block-uniform
    auto b = [&](int c, int n) -> float {
      return (y0 + c < g.T && d0 + n < g.Dh)
                 ? operand<kRound>(y[(y0 + c) * ys + d0 + n])
                 : 0.f;
    };
    if (kTransposed) {
      tile_mm<false, false>(
          kTile, [&](int c, int m) -> float { return w[c][m]; }, b, out[ch],
          s);
    } else {
      tile_mm<true, false>(
          kTile, [&](int c, int m) -> float { return w[m][c]; }, b, out[ch],
          s);
    }
  }
}

// The thread's 4 x 4 of an output tile, rows r0 + ty*4 + i < T, into the
// contiguous (B, T, H, Dh) array `dst`; `div[i]` divides row i.
template <int kChunks, typename T>
__device__ __forceinline__ void store_rows(T* dst, const Geo& g,
                                           const Where& w, int r0,
                                           const float (&out)[kChunks][4][4],
                                           const float (&div)[4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r >= g.T) continue;
      T* row = dst + out_row(g, w, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = ch * kTile + tx * 4 + j;
        if (d < g.Dh) row[d] = from_f32<T>(out[ch][i][j] / div[i]);
      }
    }
}

// Grid (B*H*n_tiles); block kTileThreads. Rows ty*4 + i of the tile are
// shared by the 16 neighbouring lanes tx = 0..15.
template <typename T, bool kRound, int kChunks>
__global__ void __launch_bounds__(kTileThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Geo g) {
  __shared__ TileSmem smem;
  __shared__ float ps[kTile][kTile + 1];
  const Where w = where<true>(g);
  const T* qb = head(q, g.q, w);
  const T* kb = head(k, g.k, w);
  const T* vb = head(v, g.v, w);
  const int row0 = w.tile * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float m[4], l[4], out[kChunks][4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  for (int jt = 0; jt <= w.tile; ++jt) {
    const int col0 = jt * kTile;
    float acc[4][4];
    dot_tile<false>(qb, g.q.t, row0, kb, g.k.t, col0, g, acc, smem);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx * 4 + j;
        acc[i][j] = (col <= row && col < g.T) ? acc[i][j] * g.scale : kNeg;
        tmax = fmaxf(tmax, acc[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(acc[i][j] - m_new);
        sum += p;
        ps[ty * 4 + i][tx * 4 + j] = rounded<kRound>(p);
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row's sum
      m[i] = m_new;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[ch][i][j] *= corr;
    }
    __syncthreads();
    weighted_rows<false, kRound>(ps, vb, g.v.t, col0, g, out, smem);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    }
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < g.T) {
      lse[static_cast<size_t>(w.bh) * g.T + row] = m[i] + logf(l[i]);
    }
  }
  store_rows(o, g, w, row0, out, l);
}

// P and dS of the thread's 4 x 4 of a tile: acc holds Q K^T and dp holds
// dO V^T on entry; on exit acc = P and dp = dS. Rows at or beyond T (which
// have no lse) and masked positions give 0.
__device__ __forceinline__ void p_and_ds(float (&acc)[4][4],
                                         float (&dp)[4][4], int row0,
                                         int col0, const float* lse,
                                         const float* dres, const Geo& g) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    const bool in = row < g.T;
    const float row_lse = in ? lse[row] : 0.f;
    const float row_dres = in ? dres[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      const float p =
          (in && col <= row) ? expf(acc[i][j] * g.scale - row_lse) : 0.f;
      acc[i][j] = p;
      dp[i][j] = p * (dp[i][j] - row_dres) * g.scale;
    }
  }
}

// The thread's 4 x 4 into a shared 64 x 64, rounded to p_dtype. Ends with
// __syncthreads().
template <bool kRound>
__device__ __forceinline__ void park(const float (&x)[4][4],
                                     float (&dst)[kTile][kTile + 1]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[ty * 4 + i][tx * 4 + j] = rounded<kRound>(x[i][j]);
    }
  __syncthreads();
}

// Grid (B*H*n_tiles); block kTileThreads.
template <typename T, bool kRound, int kChunks>
__global__ void __launch_bounds__(kTileThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dres, T* __restrict__ dq,
                    Geo g) {
  __shared__ TileSmem smem;
  __shared__ float ds[kTile][kTile + 1];
  const Where w = where<true>(g);
  const T* qb = head(q, g.q, w);
  const T* kb = head(k, g.k, w);
  const T* vb = head(v, g.v, w);
  const T* gb = head(dO, g.g, w);
  const float* lse_b = lse + static_cast<size_t>(w.bh) * g.T;
  const float* dres_b = dres + static_cast<size_t>(w.bh) * g.T;
  const int row0 = w.tile * kTile;
  float out[kChunks][4][4] = {};
  for (int jt = 0; jt <= w.tile; ++jt) {
    const int col0 = jt * kTile;
    float acc[4][4], dp[4][4];
    dot_tile<false>(qb, g.q.t, row0, kb, g.k.t, col0, g, acc, smem);
    dot_tile<kRound>(gb, g.g.t, row0, vb, g.v.t, col0, g, dp, smem);
    p_and_ds(acc, dp, row0, col0, lse_b, dres_b, g);
    park<kRound>(dp, ds);
    weighted_rows<false, kRound>(ds, kb, g.k.t, col0, g, out, smem);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(dq, g, w, row0, out, one);
}

// Grid (B*H*n_tiles); block kTileThreads. The block's tile is 64 key rows,
// which are the columns of the score tiles it recomputes.
template <typename T, bool kRound, int kChunks>
__global__ void __launch_bounds__(kTileThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ dres, T* __restrict__ dk,
                     T* __restrict__ dv, Geo g) {
  __shared__ TileSmem smem;
  __shared__ float ps[kTile][kTile + 1];
  __shared__ float ds[kTile][kTile + 1];
  const Where w = where<false>(g);
  const T* qb = head(q, g.q, w);
  const T* kb = head(k, g.k, w);
  const T* vb = head(v, g.v, w);
  const T* gb = head(dO, g.g, w);
  const float* lse_b = lse + static_cast<size_t>(w.bh) * g.T;
  const float* dres_b = dres + static_cast<size_t>(w.bh) * g.T;
  const int col0 = w.tile * kTile;
  float out_k[kChunks][4][4] = {}, out_v[kChunks][4][4] = {};
  for (int it = w.tile; it < g.n_tiles; ++it) {
    const int row0 = it * kTile;
    float acc[4][4], dp[4][4];
    dot_tile<false>(qb, g.q.t, row0, kb, g.k.t, col0, g, acc, smem);
    dot_tile<kRound>(gb, g.g.t, row0, vb, g.v.t, col0, g, dp, smem);
    p_and_ds(acc, dp, row0, col0, lse_b, dres_b, g);
    park<kRound>(acc, ps);
    park<kRound>(dp, ds);
    weighted_rows<true, kRound>(ps, gb, g.g.t, row0, g, out_v, smem);
    weighted_rows<true, kRound>(ds, qb, g.q.t, row0, g, out_k, smem);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(dk, g, w, col0, out_k, one);
  store_rows(dv, g, w, col0, out_v, one);
}

// ---------------------------------------------------------------------
// bf16 inputs on the tensor cores (mma.sync m16n8k16, fp32 sums), Dh = kDh
// in {16, 32, 64}.
//
// One block is 4 warps and owns 64 rows of one operand, 16 to a warp (the
// X side: query rows for the forward and dQ, key rows for dK/dV), and
// sweeps the other side (Y) in tiles of 64 rows. X's tiles pass through
// shared memory once and stay in registers as A fragments (Q; Q and dO; K
// and V). Each Y tile is two 64 x kDh bf16 slabs in shared memory (K and V,
// or Q and dO) in a ring of two: cp.async brings in tile j + 1 while the
// warps work on tile j. A warp's score tile, 16 x 64, is whole rows (or,
// for dK/dV, S^T: whole key rows), so the softmax statistics need no
// exchange between warps.
//
// Q K^T and dO V^T multiply bf16 values under either p_dtype (a bf16 element
// cast to fp32 is itself, and a product of two is exact in fp32), so both
// always run on the tensor cores. The other products, P V, dS K, P^T dO and
// dS^T Q, have an fp32 operand (P or dS), and the two p_dtypes part there
// (Acc below):
//   * bf16 P ('flash16'): P and dS never leave registers. The fp32
//     fragments of two neighbouring 8-column tiles are, rounded to bf16, the
//     A fragment of one 16-deep step of the next product, whose B operand is
//     a Y slab read transposed by ldmatrix. The tensor core's fp32 adder
//     truncates, so no sum is carried in the mma's registers across the
//     sweep: each tile's product is summed from zero and joins the running
//     sum by an ordinary rounded add (product_mma).
//   * fp32 P ('flash'): no tensor-core form is exact, so the warp parks its
//     16 x 64 of P or dS in shared memory and each lane sums one column of
//     the output (two for Dh = 64) over the slab on the SIMT fp32 pipe.

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows of the X side
constexpr int kWarps = kMmaThreads / 32;
constexpr int kPark = kTile + 4;  // a parked row: 16-byte aligned, and the
                                  // 8 rows a warp writes at once 2-way on
                                  // the banks at worst

// Two slabs of a Y tile, and the ring of two tiles. A slab row is kDh bf16
// and 8 of padding, which keeps ldmatrix off bank conflicts.
template <int kDh>
struct MmaSmem {
  alignas(16) bf16_t a[2][kTile][kDh + 8];
  alignas(16) bf16_t b[2][kTile][kDh + 8];
  float lse[2][kTile], dres[2][kTile];  // of a tile's query rows (dK/dV)
};

// Starts the copy of rows [r0, r0 + 64) of x into dst, zero-filling rows at
// or beyond T. x itself is the valid, aligned address named where nothing
// is read.
template <int kDh>
__device__ __forceinline__ void stage_rows(bf16_t (&dst)[kTile][kDh + 8],
                                           const bf16_t* x, long long xs,
                                           int r0, int T) {
  constexpr int kVec = kDh / 8;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kTile * kVec; e += kMmaThreads) {
    const int row = e / kVec, c = (e % kVec) * 8;
    const bool in = r0 + row < T;
    cpc::cp_async16(&dst[row][c], in ? x + (r0 + row) * xs + c : x,
                    in ? 16 : 0);
  }
}

// The warp's 16 rows of a slab as A fragments, one per 16-deep step of Dh.
template <int kDh>
__device__ __forceinline__ void load_a(unsigned (&a)[kDh / 16][4],
                                       const bf16_t (&t)[kTile][kDh + 8]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    cpc::ldmatrix_x4(a[kk],
                     &t[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
  }
}

// s (16 x 64 of this warp) = A (16 x kDh) . Y (64 x kDh)^T.
template <int kDh>
__device__ __forceinline__ void score_mma(const unsigned (&a)[kDh / 16][4],
                                          const bf16_t (&yt)[kTile][kDh + 8],
                                          float (&s)[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // two 8-column tiles a load
      unsigned b[4];
      cpc::ldmatrix_x4(b, &yt[np * 16 + lane % 8 + (lane / 16) * 8]
                             [kk * 16 + ((lane / 8) % 2) * 8]);
      cpc::mma_bf16(s[2 * np], a[kk], b[0], b[1]);
      cpc::mma_bf16(s[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// o (16 x kDh of this warp) += W (16 x 64, as A fragments) . Y (64 x kDh),
// the slab read transposed; summed from zero, then added.
template <int kDh>
__device__ __forceinline__ void product_mma(
    const unsigned (&wa)[4][4], const bf16_t (&yt)[kTile][kDh + 8],
    float (&o)[kDh / 8][4]) {
  const int lane = threadIdx.x % 32;
  float t[kDh / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int dp = 0; dp < kDh / 16; ++dp) {
      unsigned b[4];
      cpc::ldmatrix_x4_trans(
          b, &yt[ks * 16 + lane % 16][dp * 16 + (lane / 16) * 8]);
      cpc::mma_bf16(t[2 * dp], wa[ks], b[0], b[1]);
      cpc::mma_bf16(t[2 * dp + 1], wa[ks], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] += t[nt][e];
}

// A warp's running output tile, 16 rows x kDh, and its product with a
// 16 x 64 fragment tile w of fp32 weights (P or dS). Row scalars (a
// rescaling, a divisor) come as the thread's two fragment rows: [0] for row
// lane / 4 of the warp's 16, [1] for that row + 8.
template <int kDh, bool kExact>
struct Acc;

// bf16 P: the output in the mma's fragment layout.
template <int kDh>
struct Acc<kDh, false> {
  struct Scratch {};  // nothing leaves registers
  float o[kDh / 8][4] = {};

  __device__ __forceinline__ void scale(const float (&c)[2], Scratch&) {
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= c[e / 2];
  }

  __device__ __forceinline__ void add(const float (&w)[8][4],
                                      const bf16_t (&yt)[kTile][kDh + 8],
                                      Scratch&) {
    unsigned a[4][4];  // w rounded to bf16, as A fragments
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      a[nt / 2][(nt % 2) * 2] = cpc::pack_bf16(w[nt][0], w[nt][1]);
      a[nt / 2][(nt % 2) * 2 + 1] = cpc::pack_bf16(w[nt][2], w[nt][3]);
    }
    product_mma<kDh>(a, yt, o);
  }

  // Into the contiguous (B, T, H, Dh) array, rows r0 + (the warp's 16) < T.
  __device__ __forceinline__ void store(bf16_t* dst, const Geo& g,
                                        const Where& w, int r0,
                                        const float (&div)[2], Scratch&) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * 16 + lane / 4 + h * 8;
      if (r >= g.T) continue;
      bf16_t* row = dst + out_row(g, w, r);
#pragma unroll
      for (int nt = 0; nt < kDh / 8; ++nt) {
        // Dh is even: the pair is 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + (lane % 4) * 2) =
            __floats2bfloat162_rn(o[nt][h * 2] / div[h],
                                  o[nt][h * 2 + 1] / div[h]);
      }
    }
  }
};

// fp32 P: lane l holds column l (and l + 32 for Dh = 64) of all 16 rows.
template <int kDh>
struct Acc<kDh, true> {
  static constexpr int kCols = (kDh + 31) / 32;
  struct Scratch {  // of one warp, in shared memory
    alignas(16) float w[16][kPark];
    float row[16];
  };
  float o[16][kCols] = {};

  // The thread's two row scalars to all 16 rows of the warp, in s.row.
  __device__ __forceinline__ void share(const float (&v)[2], Scratch& s) {
    const int lane = threadIdx.x % 32;
    __syncwarp();  // the last readers of s.row are done
    if (lane % 4 == 0) {
      s.row[lane / 4] = v[0];
      s.row[lane / 4 + 8] = v[1];
    }
    __syncwarp();
  }

  __device__ __forceinline__ void scale(const float (&c)[2], Scratch& s) {
    share(c, s);
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < kCols; ++i) o[r][i] *= s.row[r];
  }

  __device__ __forceinline__ void add(const float (&w)[8][4],
                                      const bf16_t (&yt)[kTile][kDh + 8],
                                      Scratch& s) {
    const int lane = threadIdx.x % 32;
    __syncwarp();  // the last readers of s.w are done
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(
            &s.w[lane / 4 + h * 8][nt * 8 + (lane % 4) * 2]) =
            make_float2(w[nt][h * 2], w[nt][h * 2 + 1]);
      }
    __syncwarp();
    for (int c0 = 0; c0 < kTile; c0 += 4) {
      float y[4][kCols];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int d = lane + 32 * i;
          y[j][i] = d < kDh ? __bfloat162float(yt[c0 + j][d]) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 wr = *reinterpret_cast<const float4*>(&s.w[r][c0]);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          o[r][i] = fmaf(wr.x, y[0][i], o[r][i]);
          o[r][i] = fmaf(wr.y, y[1][i], o[r][i]);
          o[r][i] = fmaf(wr.z, y[2][i], o[r][i]);
          o[r][i] = fmaf(wr.w, y[3][i], o[r][i]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(bf16_t* dst, const Geo& g,
                                        const Where& w, int r0,
                                        const float (&div)[2], Scratch& s) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    share(div, s);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int t = r0 + warp * 16 + r;
      if (t >= g.T) continue;
      bf16_t* row = dst + out_row(g, w, t);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        if (d < kDh) row[d] = __float2bfloat16(o[r][i] / s.row[r]);
      }
    }
  }
};

// A block's dynamic shared memory: the ring and each warp's scratch.
template <int kDh, bool kExact>
struct BlockSmem {
  MmaSmem<kDh> ring;
  typename Acc<kDh, kExact>::Scratch scratch[kWarps];
};

extern __shared__ __align__(16) unsigned char flash_smem[];

template <int kDh, bool kExact>
__device__ __forceinline__ BlockSmem<kDh, kExact>& block_smem() {
  return *reinterpret_cast<BlockSmem<kDh, kExact>*>(flash_smem);
}

// The X side's two tiles (xa, and xb unless nullptr) through ring slot 1
// into A fragments. Ends with the slot free again.
template <int kDh>
__device__ __forceinline__ void load_x(MmaSmem<kDh>& sm, const bf16_t* xa,
                                       long long xas, const bf16_t* xb,
                                       long long xbs, int r0, int T,
                                       unsigned (&fa)[kDh / 16][4],
                                       unsigned (&fb)[kDh / 16][4]) {
  stage_rows<kDh>(sm.a[1], xa, xas, r0, T);
  if (xb != nullptr) stage_rows<kDh>(sm.b[1], xb, xbs, r0, T);
  cpc::cp_async_commit();
  cpc::cp_async_wait<0>();
  __syncthreads();
  load_a<kDh>(fa, sm.a[1]);
  if (xb != nullptr) load_a<kDh>(fb, sm.b[1]);
  __syncthreads();
}

// Grid (B*H*n_tiles); block kMmaThreads; dynamic shared memory
// sizeof(BlockSmem<kDh, kExact>).
template <int kDh, bool kExact>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16_t* __restrict__ q,
                         const bf16_t* __restrict__ k,
                         const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                         float* __restrict__ lse, Geo g) {
  BlockSmem<kDh, kExact>& bs = block_smem<kDh, kExact>();
  MmaSmem<kDh>& sm = bs.ring;
  const Where w = where<true>(g);
  const bf16_t* qb = head(q, g.q, w);
  const bf16_t* kb = head(k, g.k, w);
  const bf16_t* vb = head(v, g.v, w);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto& scratch = bs.scratch[warp];
  const int row0 = w.tile * kTile;
  const int row[2] = {row0 + warp * 16 + lane / 4,
                      row0 + warp * 16 + lane / 4 + 8};
  unsigned qa[kDh / 16][4];
  load_x<kDh>(sm, qb, g.q.t, nullptr, 0, row0, g.T, qa, qa);
  auto fetch = [&](int jt) {
    if (jt <= w.tile) {
      stage_rows<kDh>(sm.a[jt % 2], kb, g.k.t, jt * kTile, g.T);
      stage_rows<kDh>(sm.b[jt % 2], vb, g.v.t, jt * kTile, g.T);
    }
    cpc::cp_async_commit();  // always: the count of groups stays in step
  };
  fetch(0);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  Acc<kDh, kExact> out;
  for (int jt = 0; jt <= w.tile; ++jt) {
    fetch(jt + 1);
    cpc::cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    score_mma<kDh>(qa, sm.a[jt % 2], s);
    const bool diag = jt == w.tile;  // the only tile the mask can touch
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jt * kTile + nt * 8 + (lane % 4) * 2 + (e & 1);
        const bool keep = !diag || (col <= row[e / 2] && col < g.T);
        s[nt][e] = keep ? s[nt][e] * g.scale : kNeg;
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the thread's two rows
      float tmax = kNeg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        tmax = fmaxf(tmax, fmaxf(s[nt][h * 2], s[nt][h * 2 + 1]));
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[h], tmax);
      corr[h] = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nt][h * 2 + e] - m_new);
          s[nt][h * 2 + e] = p;
          sum += p;
        }
      l[h] = l[h] * corr[h] + sum;  // this thread's share of the row's sum
      m[h] = m_new;
    }
    out.scale(corr, scratch);
    out.add(s, sm.b[jt % 2], scratch);
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (lane % 4 == 0 && row[h] < g.T) {
      lse[static_cast<size_t>(w.bh) * g.T + row[h]] = m[h] + logf(l[h]);
    }
  }
  out.store(o, g, w, row0, l, scratch);
}

// Grid (B*H*n_tiles); block kMmaThreads; dynamic shared memory
// sizeof(BlockSmem<kDh, kExact>).
template <int kDh, bool kExact>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const bf16_t* __restrict__ q,
                        const bf16_t* __restrict__ k,
                        const bf16_t* __restrict__ v,
                        const bf16_t* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ dres,
                        bf16_t* __restrict__ dq, Geo g) {
  BlockSmem<kDh, kExact>& bs = block_smem<kDh, kExact>();
  MmaSmem<kDh>& sm = bs.ring;
  const Where w = where<true>(g);
  const bf16_t* qb = head(q, g.q, w);
  const bf16_t* kb = head(k, g.k, w);
  const bf16_t* vb = head(v, g.v, w);
  const bf16_t* gb = head(dO, g.g, w);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto& scratch = bs.scratch[warp];
  const int row0 = w.tile * kTile;
  const int row[2] = {row0 + warp * 16 + lane / 4,
                      row0 + warp * 16 + lane / 4 + 8};
  float row_lse[2], row_dres[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < g.T;
    const size_t at = static_cast<size_t>(w.bh) * g.T + row[h];
    row_lse[h] = in ? lse[at] : 0.f;
    row_dres[h] = in ? dres[at] : 0.f;
  }
  unsigned qa[kDh / 16][4], ga[kDh / 16][4];
  load_x<kDh>(sm, qb, g.q.t, gb, g.g.t, row0, g.T, qa, ga);
  auto fetch = [&](int jt) {
    if (jt <= w.tile) {
      stage_rows<kDh>(sm.a[jt % 2], kb, g.k.t, jt * kTile, g.T);
      stage_rows<kDh>(sm.b[jt % 2], vb, g.v.t, jt * kTile, g.T);
    }
    cpc::cp_async_commit();
  };
  fetch(0);
  Acc<kDh, kExact> out;
  for (int jt = 0; jt <= w.tile; ++jt) {
    fetch(jt + 1);
    cpc::cp_async_wait<1>();
    __syncthreads();
    float s[8][4], dp[8][4];
    score_mma<kDh>(qa, sm.a[jt % 2], s);
    score_mma<kDh>(ga, sm.b[jt % 2], dp);
    const bool diag = jt == w.tile;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = jt * kTile + nt * 8 + (lane % 4) * 2 + (e & 1);
        const bool keep = row[h] < g.T && (!diag || col <= row[h]);
        const float p = keep ? expf(s[nt][e] * g.scale - row_lse[h]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - row_dres[h]) * g.scale;
      }
    out.add(dp, sm.a[jt % 2], scratch);  // dQ += dS K
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  out.store(dq, g, w, row0, one, scratch);
}

// Grid (B*H*n_tiles); block kMmaThreads; dynamic shared memory
// sizeof(BlockSmem<kDh, kExact>). The block owns 64 key rows and computes
// S^T, so that P^T and dS^T are again the left operands.
template <int kDh, bool kExact>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const bf16_t* __restrict__ q,
                         const bf16_t* __restrict__ k,
                         const bf16_t* __restrict__ v,
                         const bf16_t* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ dres,
                         bf16_t* __restrict__ dk, bf16_t* __restrict__ dv,
                         Geo g) {
  BlockSmem<kDh, kExact>& bs = block_smem<kDh, kExact>();
  MmaSmem<kDh>& sm = bs.ring;
  const Where w = where<false>(g);
  const bf16_t* qb = head(q, g.q, w);
  const bf16_t* kb = head(k, g.k, w);
  const bf16_t* vb = head(v, g.v, w);
  const bf16_t* gb = head(dO, g.g, w);
  const float* lse_b = lse + static_cast<size_t>(w.bh) * g.T;
  const float* dres_b = dres + static_cast<size_t>(w.bh) * g.T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto& scratch = bs.scratch[warp];
  const int col0 = w.tile * kTile;
  const int col[2] = {col0 + warp * 16 + lane / 4,
                      col0 + warp * 16 + lane / 4 + 8};
  unsigned ka[kDh / 16][4], va[kDh / 16][4];
  load_x<kDh>(sm, kb, g.k.t, vb, g.v.t, col0, g.T, ka, va);
  // tile `it` of the query rows sits in ring slot (it - w.tile) % 2
  auto fetch = [&](int it) {
    if (it < g.n_tiles) {
      const int slot = (it - w.tile) % 2;
      stage_rows<kDh>(sm.a[slot], qb, g.q.t, it * kTile, g.T);
      stage_rows<kDh>(sm.b[slot], gb, g.g.t, it * kTile, g.T);
      if (threadIdx.x < kTile) {
        const int r = it * kTile + threadIdx.x;
        sm.lse[slot][threadIdx.x] = r < g.T ? lse_b[r] : 0.f;
        sm.dres[slot][threadIdx.x] = r < g.T ? dres_b[r] : 0.f;
      }
    }
    cpc::cp_async_commit();
  };
  fetch(w.tile);
  Acc<kDh, kExact> out_k, out_v;
  for (int it = w.tile; it < g.n_tiles; ++it) {
    const int slot = (it - w.tile) % 2;
    fetch(it + 1);
    cpc::cp_async_wait<1>();
    __syncthreads();
    float s[8][4], dp[8][4];
    score_mma<kDh>(ka, sm.a[slot], s);   // S^T = K Q^T
    score_mma<kDh>(va, sm.b[slot], dp);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + (lane % 4) * 2 + (e & 1);  // query row in tile
        const int qrow = it * kTile + r;
        // key <= query < T; a query row at or beyond T contributes nothing
        const bool keep = qrow < g.T && col[e / 2] <= qrow;
        const float p =
            keep ? expf(s[nt][e] * g.scale - sm.lse[slot][r]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sm.dres[slot][r]) * g.scale;
      }
    out_v.add(s, sm.b[slot], scratch);   // dV += P^T dO
    out_k.add(dp, sm.a[slot], scratch);  // dK += dS^T Q
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  out_k.store(dk, g, w, col0, one, scratch);
  out_v.store(dv, g, w, col0, one, scratch);
}

// ---------------------------------------------------------------------
// Launchers.

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

bool strides_ok(const Strides& s) {
  return s.b % 8 == 0 && s.t % 8 == 0 && s.h % 8 == 0;
}

// Whether cp.async's 16 bytes fit every operand and Dh has an mma kernel.
bool mma_ok(const Geo& g, bool backward, const void* q, const void* k,
            const void* v, const void* dO) {
  return (g.Dh == 16 || g.Dh == 32 || g.Dh == 64) && strides_ok(g.q) &&
         strides_ok(g.k) && strides_ok(g.v) && aligned16(q) && aligned16(k) &&
         aligned16(v) && (!backward || (strides_ok(g.g) && aligned16(dO)));
}

// Fills g and returns the number of blocks, or -1 for what no kernel takes.
long long make_geo(Geo& g, int B, int T, int H, int Dh, float scale) {
  if (B < 1 || T < 1 || H < 1 || Dh < 1 || Dh > kMaxChunks * kTile) return -1;
  g.B = B;
  g.T = T;
  g.H = H;
  g.Dh = Dh;
  g.n_tiles = (T + kTile - 1) / kTile;
  g.scale = scale;
  const long long blocks = static_cast<long long>(B) * H * g.n_tiles;
  return blocks > 2147483647LL ? -1 : blocks;
}

// Runs the SIMT instantiation of Launch for (bf16, p_bf16, Dh). A bf16
// element is its own rounding, so bf16 inputs take kRound = false.
template <template <typename, bool, int> class Launch, typename... Args>
int simt_dispatch(bool bf16, bool p_bf16, int Dh, Args... args) {
  const bool two = Dh > kTile;
  if (bf16) {
    return two ? Launch<bf16_t, false, 2>::run(args...)
               : Launch<bf16_t, false, 1>::run(args...);
  }
  if (p_bf16) {
    return two ? Launch<float, true, 2>::run(args...)
               : Launch<float, true, 1>::run(args...);
  }
  return two ? Launch<float, false, 2>::run(args...)
             : Launch<float, false, 1>::run(args...);
}

template <typename T, bool kRound, int kChunks>
struct FwdSimt {
  static int run(const void* q, const void* k, const void* v, void* o,
                 float* lse, const Geo& g, int blocks, cudaStream_t s) {
    flash_fwd_kernel<T, kRound, kChunks><<<blocks, kTileThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, g);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, bool kRound, int kChunks>
struct DqSimt {
  static int run(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* dres, void* dq, const Geo& g,
                 int blocks, cudaStream_t s) {
    flash_dq_kernel<T, kRound, kChunks><<<blocks, kTileThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, dres,
        static_cast<T*>(dq), g);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, bool kRound, int kChunks>
struct DkvSimt {
  static int run(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* dres, void* dk, void* dv,
                 const Geo& g, int blocks, cudaStream_t s) {
    flash_dkv_kernel<T, kRound, kChunks><<<blocks, kTileThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, dres,
        static_cast<T*>(dk), static_cast<T*>(dv), g);
    return static_cast<int>(cudaGetLastError());
  }
};

// Launches an mma kernel with its dynamic shared memory, which above 48 KB
// has to be asked for first.
template <class Kernel, class... Args>
int launch_mma(Kernel kernel, size_t smem, int blocks, cudaStream_t s,
               Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kMmaThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh, bool kExact>
struct FwdMma {
  static int run(const void* q, const void* k, const void* v, void* o,
                 float* lse, const Geo& g, int blocks, cudaStream_t s) {
    return launch_mma(
        flash_fwd_mma_kernel<kDh, kExact>, sizeof(BlockSmem<kDh, kExact>),
        blocks, s, static_cast<const bf16_t*>(q),
        static_cast<const bf16_t*>(k), static_cast<const bf16_t*>(v),
        static_cast<bf16_t*>(o), lse, g);
  }
};

template <int kDh, bool kExact>
struct DqMma {
  static int run(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* dres, void* dq, const Geo& g,
                 int blocks, cudaStream_t s) {
    return launch_mma(
        flash_dq_mma_kernel<kDh, kExact>, sizeof(BlockSmem<kDh, kExact>),
        blocks, s, static_cast<const bf16_t*>(q),
        static_cast<const bf16_t*>(k), static_cast<const bf16_t*>(v),
        static_cast<const bf16_t*>(dO), lse, dres, static_cast<bf16_t*>(dq),
        g);
  }
};

template <int kDh, bool kExact>
struct DkvMma {
  static int run(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* dres, void* dk, void* dv,
                 const Geo& g, int blocks, cudaStream_t s) {
    return launch_mma(
        flash_dkv_mma_kernel<kDh, kExact>, sizeof(BlockSmem<kDh, kExact>),
        blocks, s, static_cast<const bf16_t*>(q),
        static_cast<const bf16_t*>(k), static_cast<const bf16_t*>(v),
        static_cast<const bf16_t*>(dO), lse, dres, static_cast<bf16_t*>(dk),
        static_cast<bf16_t*>(dv), g);
  }
};

// Runs the mma instantiation of Launch for (Dh in {16, 32, 64}, p_bf16).
template <template <int, bool> class Launch, typename... Args>
int mma_dispatch(int Dh, bool p_bf16, Args... args) {
  if (Dh == 16) {
    return p_bf16 ? Launch<16, false>::run(args...)
                  : Launch<16, true>::run(args...);
  }
  if (Dh == 32) {
    return p_bf16 ? Launch<32, false>::run(args...)
                  : Launch<32, true>::run(args...);
  }
  return p_bf16 ? Launch<64, false>::run(args...)
                : Launch<64, true>::run(args...);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` of `device` and returns
// cudaGetLastError() (0 on success); none synchronises. q, k, v, dO are
// (B, T, H, Dh) with batch, time and head strides *_sb, *_st, *_sh in
// elements and the last axis contiguous, bf16 (bf16 != 0) or fp32; p_bf16
// != 0 rounds the operands of the post-softmax products to bf16. o, dq, dk,
// dv are (B, T, H, Dh) contiguous in the same dtype; lse and dres (B*H, T)
// fp32.

int flash_attn_fwd(const void* q, long long q_sb, long long q_st,
                   long long q_sh, const void* k, long long k_sb,
                   long long k_st, long long k_sh, const void* v,
                   long long v_sb, long long v_st, long long v_sh, void* o,
                   void* lse, int B, int T, int H, int Dh, float scale,
                   int bf16, int p_bf16, int device, void* stream) {
  Geo g{};
  const long long blocks = make_geo(g, B, T, H, Dh, scale);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  g.q = {q_sb, q_st, q_sh};
  g.k = {k_sb, k_st, k_sh};
  g.v = {v_sb, v_st, v_sh};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int n = static_cast<int>(blocks);
  if (bf16 && mma_ok(g, false, q, k, v, nullptr)) {
    return mma_dispatch<FwdMma>(Dh, p_bf16 != 0, q, k, v, o, l, g, n, s);
  }
  return simt_dispatch<FwdSimt>(bf16 != 0, p_bf16 != 0, Dh, q, k, v, o, l, g,
                                n, s);
}

int flash_attn_dq(const void* q, long long q_sb, long long q_st,
                  long long q_sh, const void* k, long long k_sb,
                  long long k_st, long long k_sh, const void* v,
                  long long v_sb, long long v_st, long long v_sh,
                  const void* dO, long long g_sb, long long g_st,
                  long long g_sh, const void* lse, const void* dres, void* dq,
                  int B, int T, int H, int Dh, float scale, int bf16,
                  int p_bf16, int device, void* stream) {
  Geo g{};
  const long long blocks = make_geo(g, B, T, H, Dh, scale);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  g.q = {q_sb, q_st, q_sh};
  g.k = {k_sb, k_st, k_sh};
  g.v = {v_sb, v_st, v_sh};
  g.g = {g_sb, g_st, g_sh};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(dres);
  const int n = static_cast<int>(blocks);
  if (bf16 && mma_ok(g, true, q, k, v, dO)) {
    return mma_dispatch<DqMma>(Dh, p_bf16 != 0, q, k, v, dO, l, r, dq, g, n,
                               s);
  }
  return simt_dispatch<DqSimt>(bf16 != 0, p_bf16 != 0, Dh, q, k, v, dO, l, r,
                               dq, g, n, s);
}

int flash_attn_dkv(const void* q, long long q_sb, long long q_st,
                   long long q_sh, const void* k, long long k_sb,
                   long long k_st, long long k_sh, const void* v,
                   long long v_sb, long long v_st, long long v_sh,
                   const void* dO, long long g_sb, long long g_st,
                   long long g_sh, const void* lse, const void* dres,
                   void* dk, void* dv, int B, int T, int H, int Dh,
                   float scale, int bf16, int p_bf16, int device,
                   void* stream) {
  Geo g{};
  const long long blocks = make_geo(g, B, T, H, Dh, scale);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  g.q = {q_sb, q_st, q_sh};
  g.k = {k_sb, k_st, k_sh};
  g.v = {v_sb, v_st, v_sh};
  g.g = {g_sb, g_st, g_sh};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(dres);
  const int n = static_cast<int>(blocks);
  if (bf16 && mma_ok(g, true, q, k, v, dO)) {
    return mma_dispatch<DkvMma>(Dh, p_bf16 != 0, q, k, v, dO, l, r, dk, dv,
                                g, n, s);
  }
  return simt_dispatch<DkvSimt>(bf16 != 0, p_bf16 != 0, Dh, q, k, v, dO, l,
                                r, dk, dv, g, n, s);
}

}  // extern "C"
