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
// sequential grid; dQ and dK/dV are two kernels there because a grid step
// may only revisit the output block of the step before it. None of that
// binds here. The kernels of this file, by what they take:
//
// 1. bf16 inputs, bf16 P ('flash16', every transformer preset's path),
//    Dh in {16, 32, 64}, 16-byte aligned rows: `flash_fwd_tiled_kernel` and
//    `flash_bwd_onepass_kernel` (+ `flash_bwd_finish_kernel`), on the tensor
//    cores (mma.sync m16n8k16, fp32 sums).
//
//    What bounds them on this card. With Dh = 32 a score costs 128
//    tensor-core operations and one exponential: per 64 x 64 tile an SM
//    spends about as long on the 4 096 ex2 (16 a clock), on the fragment
//    loads from shared memory (a warp of 16 rows loads the whole K and V
//    tile for itself, 8 KB), on the scalar work on the scores and on the
//    mma themselves, and mma.sync lets a warp overlap little of it, so the
//    time is nearer the sum of the four than their largest. At T = 128 the
//    work is a few microseconds and launch and latency decide.
//
//    Forward: a block owns 16 query rows a warp: 8 warps and the whole head
//    up to T = 128 ("resident": Q, K and V in shared memory from one round
//    of copies, K/V tile 1 still in flight while tile 0 is multiplied), 4
//    warps beyond ("tiled"), with the K/V tiles of 64 rows in a cp.async
//    ring of 3 and one block barrier a tile. Q rides in the first group of
//    copies. The blocks with the longest sweeps of all heads are scheduled
//    first. Scores stay raw products; statistics are kept in units of log2,
//    so a probability is one fused multiply-add and one ex2.approx
//    (relative error 2**-22; lse agrees with the plain version to 1e-6).
//    The row's max is taken on the raw products, which needs scale > 0:
//    the launcher refuses any other.
//    The mask is applied on the warp's diagonal tile only, of which it
//    computes just the columns up to its last row. Every tile's P V is
//    summed from zero and added to the running output by an ordinary
//    multiply-add (the tensor core's fp32 adder truncates).
//
//    Backward, one pass: a block of 8 warps owns 128 key rows of one
//    (batch, head), K and V in shared memory and as A fragments in
//    registers, and sweeps the query tiles (64 rows, with their dO, lse and
//    dres, in a ring of two) from its diagonal on. Per tile pair it forms
//    S^T and dP^T once, P^T and dS^T once, and adds P^T dO into dV and
//    dS^T Q into dK in registers: 5 products and one exponential a score,
//    where the pair of dQ and dK/dV kernels does 7 and 2. dS^T is also
//    parked in shared memory as bf16, and after the pair's one block
//    barrier the 8 warps multiply it (read transposed by ldmatrix) with the
//    key tile into the pair's 64 x Dh share of dQ.
//
//    How dQ's sum stays ordered, without atomics. dQ of a query tile is a
//    sum over key tiles. Every element of the block's running dQ is read
//    and written by one thread only, the same for every key tile, in the
//    rising order of the block's key tiles. On the resident route one block
//    owns a whole (batch, head) and keeps dQ of the head in fp32 in its
//    shared memory (T = 1 024, Dh = 32: 128 KB of the 227 KB a block may
//    have), so nothing crosses blocks. On the split route (long T with few
//    heads, or a head whose dQ does not fit) a head's key tiles are dealt
//    to `groups` blocks in a zigzag that balances the causal work; each
//    adds into its own fp32 partial of dQ in scratch the wrapper allocates,
//    and `flash_bwd_finish_kernel` adds the partials in group order and
//    rounds once. Two runs give the same bits on either route. Where two
//    blocks' shared memory fits an SM (the preset's T = 128, the split
//    route) the kernel is built to 128 registers a thread by taking a tile's
//    query rows in two halves one after the other.
//
// 2. bf16 inputs, fp32 P ('flash'): the `*_mma_kernel` kernels further
//    down, with their own note: the scores on the tensor cores, the other
//    products on the SIMT pipe; dQ and dK/dV as two kernels, which also
//    serve 'flash16' through `flash_attn_dq` and `flash_attn_dkv` and where
//    rows are not 16-byte aligned.
//
// 3. fp32 inputs, and bf16 inputs with another Dh up to 128: the SIMT
//    kernels `flash_fwd_kernel`, `flash_dq_kernel`, `flash_dkv_kernel`,
//    every product on the fp32 pipe through cpc::tile_mm (TF32 would drop
//    mantissa bits the reference keeps). They keep expf.
//
// Left for later: wgmma with the K/V tiles read by the hardware (no
// fragment loads) and a producer warp, so that the exponentials of one
// tile overlap the products of the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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
// in {16, 32, 64}: the forward, dQ and dK/dV kernels under fp32 P ('flash'),
// and under bf16 P the dQ and dK/dV kernels. (The 'flash16' path proper
// runs the kernels after these.)
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
// bf16 inputs with bf16 P ('flash16'): the tiled forward and the one-pass
// backward (item 1 of the source note at the top of the file).

constexpr int kRows = 128;  // key rows of a backward block
constexpr int kStages = 3;  // the forward's ring of K/V tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxSmem = 232448;  // what a block may ask for on sm_90

// 2**x. The statistics of these kernels are kept in units of log2, so a
// probability is one ex2.approx (relative error 2**-22) and no range
// reduction.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Starts the copy of rows [r0, r0 + kN) of x into dst by kThreads threads,
// zero-filling rows at or beyond T.
template <int kDh, int kN, int kThreads>
__device__ __forceinline__ void stage(bf16_t (*dst)[kDh + 8], const bf16_t* x,
                                      long long xs, int r0, int T) {
  constexpr int kVec = kDh / 8;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kN * kVec; e += kThreads) {
    const int row = e / kVec, c = (e % kVec) * 8;
    const bool in = r0 + row < T;
    cpc::cp_async16(&dst[row][c], in ? x + (r0 + row) * xs + c : x,
                    in ? 16 : 0);
  }
}

// Rows [r, r + 16) of a slab as A fragments, one per 16-deep step of Dh.
template <int kDh>
__device__ __forceinline__ void load_a_rows(unsigned (&a)[kDh / 16][4],
                                            bf16_t (*t)[kDh + 8], int r) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    cpc::ldmatrix_x4(a[kk], &t[r + lane % 16][kk * 16 + (lane / 16) * 8]);
  }
}

template <int kDh, int kBlockRows>
struct FwdSmem {
  alignas(16) bf16_t q[kBlockRows][kDh + 8];
  alignas(16) bf16_t k[kStages][kTile][kDh + 8];
  alignas(16) bf16_t v[kStages][kTile][kDh + 8];
};

// Grid (B*H*ceil(T / kBlockRows)), kBlockRows = 16 kWarps query rows a
// block; block 32 kWarps threads; dynamic shared memory
// sizeof(FwdSmem<kDh, kBlockRows>).
template <int kDh, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_tiled_kernel(const bf16_t* __restrict__ q,
                           const bf16_t* __restrict__ k,
                           const bf16_t* __restrict__ v,
                           bf16_t* __restrict__ o, float* __restrict__ lse,
                           Geo g) {
  constexpr int kThreads = kWarps * 32, kBlockRows = kWarps * 16;
  FwdSmem<kDh, kBlockRows>& sm =
      *reinterpret_cast<FwdSmem<kDh, kBlockRows>*>(flash_smem);
  // the longest sweeps of all heads first, the short ones fill the tail
  const int n_qt = (g.T + kBlockRows - 1) / kBlockRows, heads = g.B * g.H;
  const int bh = blockIdx.x % heads, qt = n_qt - 1 - blockIdx.x / heads;
  const Where w{bh / g.H, bh % g.H, bh, qt};
  const bf16_t* qb = head(q, g.q, w);
  const bf16_t* kb = head(k, g.k, w);
  const bf16_t* vb = head(v, g.v, w);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = qt * kBlockRows;
  const int wrow0 = row0 + warp * 16;  // the warp's first row
  const int row[2] = {wrow0 + lane / 4, wrow0 + lane / 4 + 8};
  // the last tile of the block's sweep, and of the warp's
  const int last = min((row0 + kBlockRows - 1) / kTile, g.n_tiles - 1);
  const int mine = min(wrow0 / kTile, last);
  const float c2 = g.scale * kLog2e;
  auto fetch = [&](int jt) {
    if (jt <= last) {
      stage<kDh, kTile, kThreads>(sm.k[jt % kStages], kb, g.k.t, jt * kTile,
                                  g.T);
      stage<kDh, kTile, kThreads>(sm.v[jt % kStages], vb, g.v.t, jt * kTile,
                                  g.T);
    }
    cpc::cp_async_commit();  // always: the count of groups stays in step
  };
  // Q rides in the first group with K and V of tile 0: one wait in front
  // of the first product
  stage<kDh, kBlockRows, kThreads>(sm.q, qb, g.q.t, row0, g.T);
#pragma unroll
  for (int jt = 0; jt < kStages - 1; ++jt) fetch(jt);
  unsigned qa[kDh / 16][4];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // m in units of log2
  float out[kDh / 8][4] = {};
  // One tile of the sweep: the first 16 kNp of its 64 columns (all of them
  // but on the warp's diagonal tile, whose other columns lie above the
  // diagonal of all the warp's rows).
  auto tile = [&](int jt, auto width) {
    constexpr int kNp = decltype(width)::value;  // pairs of 8-column tiles
    bf16_t(*kt)[kDh + 8] = sm.k[jt % kStages];
    bf16_t(*vt)[kDh + 8] = sm.v[jt % kStages];
    float s[2 * kNp][4] = {};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kNp; ++np) {  // two 8-column tiles a load
        unsigned b[4];
        cpc::ldmatrix_x4(b, &kt[np * 16 + lane % 8 + (lane / 16) * 8]
                               [kk * 16 + ((lane / 8) % 2) * 8]);
        cpc::mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        cpc::mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
    // The mask touches the warp's diagonal tile only. A column at or
    // beyond T lies above the diagonal of every row below T, and rows at
    // or beyond T are not stored.
    if (jt == mine) {
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = jt * kTile + nt * 8 + (lane % 4) * 2 + (e & 1);
          if (col > row[e / 2]) s[nt][e] = kNeg;
        }
    }
    // s holds the raw products; c2 > 0 (the launcher refuses another), so
    // the row's max is taken on them, and a probability is one fused
    // multiply-add and one ex2: 2**(s c2 - m), m = max (s c2)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the thread's two rows
      float tmax = kNeg;
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt) {
        tmax = fmaxf(tmax, fmaxf(s[nt][h * 2], s[nt][h * 2 + 1]));
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[h], tmax * c2);
      corr[h] = ex2(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[nt][h * 2 + e], c2, -m_new));
          s[nt][h * 2 + e] = p;
          sum += p;
        }
      l[h] = l[h] * corr[h] + sum;  // this thread's share of the row's sum
      m[h] = m_new;
    }
    // P V of this tile, summed from zero, then added to the rescaled sum
    float t[kDh / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kNp; ++ks) {
      const unsigned pa[4] = {
          cpc::pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          cpc::pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          cpc::pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          cpc::pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDh / 16; ++dp) {
        unsigned b[4];
        cpc::ldmatrix_x4_trans(
            b, &vt[ks * 16 + lane % 16][dp * 16 + (lane / 16) * 8]);
        cpc::mma_bf16(t[2 * dp], pa, b[0], b[1]);
        cpc::mma_bf16(t[2 * dp + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[nt][e] = out[nt][e] * corr[e / 2] + t[nt][e];
      }
  };
  for (int jt = 0; jt <= last; ++jt) {
    cpc::cp_async_wait<kStages - 2>();  // tile jt has landed
    __syncthreads();  // ... for every warp, and tile jt - 1 is read out
    fetch(jt + kStages - 1);  // into the slot of tile jt - 1
    if (jt == 0) load_a_rows<kDh>(qa, sm.q, warp * 16);
    if (jt > mine) continue;  // above the diagonal for all the warp's rows
    // of its diagonal tile the warp needs the columns up to its last row
    const int pairs = jt == mine ? (wrow0 % kTile) / 16 + 1 : 4;
    switch (pairs) {  // straight-line code for each width: warp-uniform
      case 1: tile(jt, std::integral_constant<int, 1>{}); break;
      case 2: tile(jt, std::integral_constant<int, 2>{}); break;
      case 3: tile(jt, std::integral_constant<int, 3>{}); break;
      default: tile(jt, std::integral_constant<int, 4>{}); break;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row[h] >= g.T) continue;
    if (lane % 4 == 0) {
      lse[static_cast<size_t>(bh) * g.T + row[h]] = m[h] * kLn2 + logf(sum);
    }
    bf16_t* dst = o + out_row(g, w, row[h]);
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(out[nt][h * 2] / sum,
                                out[nt][h * 2 + 1] / sum);
    }
  }
}

// The one-pass backward's static shared memory; on the resident route the
// head's dQ, fp32 (ceil(T / 64) * 64, kDh), follows it.
template <int kDh>
struct BwdSmem {
  alignas(16) bf16_t k[kRows][kDh + 8];      // the block's key tile
  alignas(16) bf16_t v[kRows][kDh + 8];
  alignas(16) bf16_t q[2][kTile][kDh + 8];   // ring of query tiles
  alignas(16) bf16_t g[2][kTile][kDh + 8];   // ... and of their dO
  alignas(16) bf16_t ds[2][kRows][kTile + 8];  // dS^T of a tile pair
  float lse[2][kTile], dres[2][kTile];  // of a query tile; lse in log2 units
};

// Grid (B*H*max(groups, 1)); block 256 threads: 8 warps of 16 key rows;
// dynamic shared memory sizeof(BwdSmem<kDh>) and, with partial == nullptr
// (the resident route, groups 1), the head's dQ after it. kTwoBlocks holds
// the registers to 128 a thread, for the launches whose shared memory lets
// two blocks share an SM. On the split
// route block (bh, grp) owns the key tiles grp, 2 groups - 1 - grp,
// 2 groups + grp, ... and adds into its own partial of dQ,
// partial[grp][bh] (ceil(T / 64) * 64, kDh) fp32, of which it writes the
// rows from 128 grp on.
template <int kDh, bool kTwoBlocks>
__global__ void __launch_bounds__(256, kTwoBlocks ? 2 : 1)
    flash_bwd_onepass_kernel(const bf16_t* __restrict__ q,
                             const bf16_t* __restrict__ k,
                             const bf16_t* __restrict__ v,
                             const bf16_t* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ dres,
                             bf16_t* __restrict__ dq, bf16_t* __restrict__ dk,
                             bf16_t* __restrict__ dv, float* partial,
                             int groups, Geo g) {
  constexpr int kThreads = 256;
  constexpr int kNt = kDh / 16;  // 8-column tiles of dQ a warp makes
  BwdSmem<kDh>& sm = *reinterpret_cast<BwdSmem<kDh>*>(flash_smem);
  const int bh = blockIdx.x / groups, grp = blockIdx.x % groups;
  const Where w{bh / g.H, bh % g.H, bh, 0};
  const bf16_t* qb = head(q, g.q, w);
  const bf16_t* kb = head(k, g.k, w);
  const bf16_t* vb = head(v, g.v, w);
  const bf16_t* gb = head(dO, g.g, w);
  const float* lse_b = lse + static_cast<size_t>(bh) * g.T;
  const float* dres_b = dres + static_cast<size_t>(bh) * g.T;
  const int n_kt = (g.T + kRows - 1) / kRows;
  const size_t t_pad = static_cast<size_t>(g.n_tiles) * kTile;
  // the block's own sum of dQ: every element is read and written by one
  // thread only, the same for every key tile, in the order of the tiles
  float* acc =
      partial == nullptr
          ? reinterpret_cast<float*>(flash_smem + sizeof(BwdSmem<kDh>))
          : partial + (static_cast<size_t>(grp) * g.B * g.H + bh) * t_pad * kDh;
  const float c2 = g.scale * kLog2e;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, q4 = lane % 4;
  // of a tile pair's dQ (64 x kDh) the warp makes query rows [qr, qr + 16)
  // by columns [d0, d0 + kDh / 2)
  const int qr = (warp % 4) * 16, d0 = (warp / 4) * (kDh / 2);
  for (int n = 0;; ++n) {
    const int J = (n / 2) * 2 * groups + (n % 2 ? 2 * groups - 1 - grp : grp);
    if (J >= n_kt) break;  // the tiles come in rising order
    const int key0 = J * kRows, i0 = 2 * J;  // i0: the first query tile
    auto fetch = [&](int it) {  // query tile `it` into ring slot it % 2
      if (it < g.n_tiles) {
        const int slot = it % 2;
        stage<kDh, kTile, kThreads>(sm.q[slot], qb, g.q.t, it * kTile, g.T);
        stage<kDh, kTile, kThreads>(sm.g[slot], gb, g.g.t, it * kTile, g.T);
        if (threadIdx.x < kTile) {
          const int r = it * kTile + threadIdx.x;
          sm.lse[slot][threadIdx.x] = r < g.T ? lse_b[r] * kLog2e : 0.f;
          sm.dres[slot][threadIdx.x] = r < g.T ? dres_b[r] : 0.f;
        }
      }
      cpc::cp_async_commit();
    };
    __syncthreads();  // the last key tile's readers of k and the ring
    stage<kDh, kRows, kThreads>(sm.k, kb, g.k.t, key0, g.T);
    stage<kDh, kRows, kThreads>(sm.v, vb, g.v.t, key0, g.T);
    fetch(i0);  // one group with K and V: one wait in front of the products
    fetch(i0 + 1);
    cpc::cp_async_wait<1>();
    __syncthreads();
    unsigned ka[kDh / 16][4], va[kDh / 16][4];
    load_a_rows<kDh>(ka, sm.k, warp * 16);
    load_a_rows<kDh>(va, sm.v, warp * 16);
    const int key[2] = {key0 + warp * 16 + gr, key0 + warp * 16 + gr + 8};
    float out_k[kDh / 8][4] = {}, out_v[kDh / 8][4] = {};
    for (int it = i0; it < g.n_tiles; ++it) {
      const int slot = it % 2, qrow0 = it * kTile;
      // on the block's first query tile the upper 64 keys are all masked
      const bool live = key0 + warp * 16 < qrow0 + kTile;
      if (live) {
        // masks only at the diagonal and on the ragged last tile
        const bool edge = it <= i0 + 1 || it == g.n_tiles - 1;
        // The tile's 64 query rows in two halves: with kTwoBlocks one
        // after the other, so that two blocks' registers fit an SM; else
        // unrolled, for the compiler to interleave.
#pragma unroll(kTwoBlocks ? 1 : 2)
        for (int c0 = 0; c0 < kTile; c0 += kTile / 2) {
          float s[4][4] = {}, dp[4][4] = {};
#pragma unroll
          for (int kk = 0; kk < kDh / 16; ++kk) {
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              const int r = c0 + np * 16 + lane % 8 + (lane / 16) * 8;
              const int c = kk * 16 + ((lane / 8) % 2) * 8;
              unsigned b[4];
              cpc::ldmatrix_x4(b, &sm.q[slot][r][c]);  // S^T = K Q^T
              cpc::mma_bf16(s[2 * np], ka[kk], b[0], b[1]);
              cpc::mma_bf16(s[2 * np + 1], ka[kk], b[2], b[3]);
              cpc::ldmatrix_x4(b, &sm.g[slot][r][c]);  // dP^T = V dO^T
              cpc::mma_bf16(dp[2 * np], va[kk], b[0], b[1]);
              cpc::mma_bf16(dp[2 * np + 1], va[kk], b[2], b[3]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int r = c0 + nt * 8 + q4 * 2;  // the thread's two query rows
            const float2 r_lse = *reinterpret_cast<const float2*>(
                &sm.lse[slot][r]);
            const float2 r_dres = *reinterpret_cast<const float2*>(
                &sm.dres[slot][r]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qrow = qrow0 + r + (e & 1);
              // key <= query < T; a query row at or beyond T gives nothing
              const bool keep = !edge || (qrow < g.T && key[e / 2] <= qrow);
              const float p =
                  keep ? ex2(fmaf(s[nt][e], c2,
                                  -((e & 1) ? r_lse.y : r_lse.x)))
                       : 0.f;
              s[nt][e] = p;
              dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? r_dres.y : r_dres.x)) *
                          g.scale;
            }
          }
          unsigned pa[2][4], da[2][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            pa[nt / 2][(nt % 2) * 2] = cpc::pack_bf16(s[nt][0], s[nt][1]);
            pa[nt / 2][(nt % 2) * 2 + 1] = cpc::pack_bf16(s[nt][2], s[nt][3]);
            da[nt / 2][(nt % 2) * 2] = cpc::pack_bf16(dp[nt][0], dp[nt][1]);
            da[nt / 2][(nt % 2) * 2 + 1] =
                cpc::pack_bf16(dp[nt][2], dp[nt][3]);
          }
          // dV += P^T dO, dK += dS^T Q over the half's 32 query rows, each
          // summed from zero, then added
          float tv[kDh / 8][4] = {}, tk[kDh / 8][4] = {};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int dd = 0; dd < kDh / 16; ++dd) {
              const int r = c0 + ks * 16 + lane % 16;
              const int c = dd * 16 + (lane / 16) * 8;
              unsigned b[4];
              cpc::ldmatrix_x4_trans(b, &sm.g[slot][r][c]);
              cpc::mma_bf16(tv[2 * dd], pa[ks], b[0], b[1]);
              cpc::mma_bf16(tv[2 * dd + 1], pa[ks], b[2], b[3]);
              cpc::ldmatrix_x4_trans(b, &sm.q[slot][r][c]);
              cpc::mma_bf16(tk[2 * dd], da[ks], b[0], b[1]);
              cpc::mma_bf16(tk[2 * dd + 1], da[ks], b[2], b[3]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              out_v[nt][e] += tv[nt][e];
              out_k[nt][e] += tk[nt][e];
            }
          // dS^T (the warp's 16 keys x 32 queries) for the dQ product
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            *reinterpret_cast<unsigned*>(
                &sm.ds[slot][warp * 16 + gr][c0 + nt * 8 + q4 * 2]) =
                da[nt / 2][(nt % 2) * 2];
            *reinterpret_cast<unsigned*>(
                &sm.ds[slot][warp * 16 + gr + 8][c0 + nt * 8 + q4 * 2]) =
                da[nt / 2][(nt % 2) * 2 + 1];
          }
        }
      }
      cpc::cp_async_wait<0>();  // query tile it + 1 has landed
      __syncthreads();  // ... and dS^T is whole, and tile `it` is read out
      fetch(it + 2);    // into the slot of tile `it`
      // dQ[it] (+)= dS K over the block's keys: A is dS^T read transposed,
      // B the key tile read transposed; summed from zero, then added
      float t[kNt][4] = {};
      const int ks_end = it == i0 ? 4 : 8;
      for (int ks = 0; ks < ks_end; ++ks) {
        unsigned a[4];
        cpc::ldmatrix_x4_trans(
            a, &sm.ds[slot][ks * 16 + lane % 8 + (lane / 16) * 8]
                     [qr + ((lane / 8) % 2) * 8]);
        if constexpr (kNt == 1) {  // Dh = 16: one load holds both halves
          unsigned b[4];
          cpc::ldmatrix_x4_trans(b,
                                 &sm.k[ks * 16 + lane % 16][(lane / 16) * 8]);
          cpc::mma_bf16(t[0], a, d0 ? b[2] : b[0], d0 ? b[3] : b[1]);
        } else {
#pragma unroll
          for (int dp = 0; dp < kNt / 2; ++dp) {
            unsigned b[4];
            cpc::ldmatrix_x4_trans(
                b, &sm.k[ks * 16 + lane % 16]
                        [d0 + dp * 16 + (lane / 16) * 8]);
            cpc::mma_bf16(t[2 * dp], a, b[0], b[1]);
            cpc::mma_bf16(t[2 * dp + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* at = reinterpret_cast<float2*>(
              acc + (qrow0 + qr + gr + h * 8) * kDh + d0 + nt * 8 + q4 * 2);
          float2 sum = make_float2(t[nt][h * 2], t[nt][h * 2 + 1]);
          if (n > 0) {  // the block's first key tile starts the sum
            const float2 was = *at;
            sum.x += was.x;
            sum.y += was.y;
          }
          *at = sum;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= g.T) continue;
      const size_t at = out_row(g, w, key[h]);
#pragma unroll
      for (int nt = 0; nt < kDh / 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + nt * 8 + q4 * 2) =
            __floats2bfloat162_rn(out_k[nt][h * 2], out_k[nt][h * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + nt * 8 + q4 * 2) =
            __floats2bfloat162_rn(out_v[nt][h * 2], out_v[nt][h * 2 + 1]);
      }
    }
  }
  if (partial != nullptr) return;  // flash_bwd_finish_kernel adds the groups
  __syncthreads();
  for (int e = threadIdx.x; e < g.T * (kDh / 2); e += kThreads) {
    const int row = e / (kDh / 2), c = (e % (kDh / 2)) * 2;
    const float2 x = *reinterpret_cast<const float2*>(acc + row * kDh + c);
    *reinterpret_cast<__nv_bfloat162*>(dq + out_row(g, w, row) + c) =
        __floats2bfloat162_rn(x.x, x.y);
  }
}

// dq = the groups' partial sums of the split route added in group order,
// rounded once. One thread a pair of columns; group grp holds rows from
// 128 grp on. Grid (ceil(B*T*H*Dh / 2 / 256)); block 256.
__global__ void __launch_bounds__(256)
    flash_bwd_finish_kernel(const float* __restrict__ partial,
                            bf16_t* __restrict__ dq, int groups, Geo g) {
  const long long pairs = static_cast<long long>(g.B) * g.T * g.H * g.Dh / 2;
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= pairs) return;
  const int half = g.Dh / 2;
  const int c = static_cast<int>(e % half) * 2;
  const int h = static_cast<int>(e / half % g.H);
  const int t = static_cast<int>(e / half / g.H % g.T);
  const int b = static_cast<int>(e / half / g.H / g.T);
  const size_t t_pad = static_cast<size_t>(g.n_tiles) * kTile;
  const size_t heads = static_cast<size_t>(g.B) * g.H;
  const size_t at = ((static_cast<size_t>(b) * g.H + h) * t_pad + t) * g.Dh + c;
  float2 sum = *reinterpret_cast<const float2*>(partial + at);
  const int last = min(groups - 1, t / kRows);
  for (int grp = 1; grp <= last; ++grp) {
    const float2 x = *reinterpret_cast<const float2*>(
        partial + grp * heads * t_pad * g.Dh + at);
    sum.x += x.x;
    sum.y += x.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dq + e * 2) =
      __floats2bfloat162_rn(sum.x, sum.y);
}

// Nothing: the time of its launch, at a grid, block and shared memory of
// one of the kernels above, is the floor under that kernel's time.
__global__ void flash_empty_kernel() {}

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
int launch_mma(Kernel kernel, size_t smem, int blocks, int threads,
               cudaStream_t s, Args... args) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The forward under fp32 P; bf16 P has the tiled forward.
template <int kDh>
int run_fwd_exact(const void* q, const void* k, const void* v, void* o,
                  float* lse, const Geo& g, int blocks, cudaStream_t s) {
  return launch_mma(
      flash_fwd_mma_kernel<kDh, true>, sizeof(BlockSmem<kDh, true>), blocks,
      kMmaThreads, s, static_cast<const bf16_t*>(q),
      static_cast<const bf16_t*>(k), static_cast<const bf16_t*>(v),
      static_cast<bf16_t*>(o), lse, g);
}

template <int kDh, bool kExact>
struct DqMma {
  static int run(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* dres, void* dq, const Geo& g,
                 int blocks, cudaStream_t s) {
    return launch_mma(
        flash_dq_mma_kernel<kDh, kExact>, sizeof(BlockSmem<kDh, kExact>),
        blocks, kMmaThreads, s, static_cast<const bf16_t*>(q),
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
        blocks, kMmaThreads, s, static_cast<const bf16_t*>(q),
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

// A kernel's launch: blocks, threads a block, bytes of dynamic shared
// memory. The launchers and `flash_attn_launch_shape` take it from the same
// functions.
struct LaunchShape {
  long long blocks;
  int threads;
  size_t smem;
};

// f(std::integral_constant<int, Dh>) for Dh in {16, 32, 64}.
template <class F>
auto for_head_dim(int Dh, F f) {
  if (Dh == 16) return f(std::integral_constant<int, 16>{});
  if (Dh == 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

// The tiled forward's warps a block: 8, the whole head in one block
// ("resident"), up to T = 128; 4 beyond ("tiled").
constexpr int kResidentWarps = 8, kTiledWarps = 4;

bool fwd_resident(const Geo& g) { return g.T <= kResidentWarps * 16; }

template <int kDh, int kWarps>
LaunchShape fwd_tiled_shape(const Geo& g) {
  constexpr int kBlockRows = kWarps * 16;
  return {static_cast<long long>(g.B) * g.H *
              ((g.T + kBlockRows - 1) / kBlockRows),
          kWarps * 32, sizeof(FwdSmem<kDh, kBlockRows>)};
}

template <int kDh>
LaunchShape fwd_shape(const Geo& g) {
  return fwd_resident(g) ? fwd_tiled_shape<kDh, kResidentWarps>(g)
                         : fwd_tiled_shape<kDh, kTiledWarps>(g);
}

template <int kDh>
int run_fwd_tiled(const void* q, const void* k, const void* v, void* o,
                  float* lse, const Geo& g, cudaStream_t s) {
  const LaunchShape at = fwd_shape<kDh>(g);
  auto launch = [&](auto kernel) {
    return launch_mma(kernel, at.smem, static_cast<int>(at.blocks),
                      at.threads, s, static_cast<const bf16_t*>(q),
                      static_cast<const bf16_t*>(k),
                      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o),
                      lse, g);
  };
  return fwd_resident(g)
             ? launch(flash_fwd_tiled_kernel<kDh, kResidentWarps>)
             : launch(flash_fwd_tiled_kernel<kDh, kTiledWarps>);
}

// The one-pass backward's launch on the resident route (groups == 0: the
// head's dQ follows BwdSmem) or the split route (groups blocks a head).
template <int kDh>
LaunchShape bwd_onepass_shape(const Geo& g, int groups) {
  const size_t head_dq =
      static_cast<size_t>(g.n_tiles) * kTile * kDh * sizeof(float);
  return {static_cast<long long>(g.B) * g.H * (groups == 0 ? 1 : groups), 256,
          sizeof(BwdSmem<kDh>) + (groups == 0 ? head_dq : 0)};
}

// The one-pass backward on the resident route (groups == 0: dQ of the head
// in the block's shared memory) or the split route (groups >= 1 partial
// sums in `partial`, then the finishing kernel).
template <int kDh>
int run_bwd_onepass(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* dres,
                    void* dq, void* dk, void* dv, float* partial, int groups,
                    const Geo& g, cudaStream_t s) {
  const bool resident = groups == 0;
  if (resident != (partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaunchShape at = bwd_onepass_shape<kDh>(g, groups);
  const size_t smem = at.smem;
  const int per_head = resident ? 1 : groups;
  if (at.blocks > 2147483647LL || per_head > (g.T + kRows - 1) / kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // two blocks an SM where their shared memory (and 1 KB each that the
  // system keeps) fits its 228 KB, at the head widths where 128 registers
  // a thread do not spill
  const bool two = kDh <= 32 && 2 * (smem + 1024) <= 228 * 1024;
  auto launch = [&](auto kernel) {
    return launch_mma(
        kernel, smem, static_cast<int>(at.blocks), at.threads, s,
        static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
        static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(dO), lse,
        dres, static_cast<bf16_t*>(dq), static_cast<bf16_t*>(dk),
        static_cast<bf16_t*>(dv), partial, per_head, g);
  };
  int err = two ? launch(flash_bwd_onepass_kernel<kDh, true>)
                : launch(flash_bwd_onepass_kernel<kDh, false>);
  if (err != 0 || resident) return err;
  const long long pairs = static_cast<long long>(g.B) * g.T * g.H * kDh / 2;
  flash_bwd_finish_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256,
                            0, s>>>(partial, static_cast<bf16_t*>(dq), groups,
                                    g);
  return static_cast<int>(cudaGetLastError());
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
    if (p_bf16) {  // the tiled forward takes the row's max before scaling
      if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
      return for_head_dim(Dh, [&](auto dh) {
        return run_fwd_tiled<decltype(dh)::value>(q, k, v, o, l, g, s);
      });
    }
    return for_head_dim(Dh, [&](auto dh) {
      return run_fwd_exact<decltype(dh)::value>(q, k, v, o, l, g, n, s);
    });
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

// The one-pass backward: dq, dk and dv from one sweep. bf16 inputs with
// bf16 P, Dh in {16, 32, 64}, 16-byte aligned operands; anything else is
// cudaErrorInvalidValue. groups == 0: the resident route (partial null);
// groups >= 1: the split route, `partial` (groups, B*H, ceil(T / 64) * 64,
// Dh) fp32 scratch, and a second launch that adds the groups.
int flash_attn_bwd(const void* q, long long q_sb, long long q_st,
                   long long q_sh, const void* k, long long k_sb,
                   long long k_st, long long k_sh, const void* v,
                   long long v_sb, long long v_st, long long v_sh,
                   const void* dO, long long g_sb, long long g_st,
                   long long g_sh, const void* lse, const void* dres,
                   void* dq, void* dk, void* dv, void* partial, int groups,
                   int B, int T, int H, int Dh, float scale, int bf16,
                   int p_bf16, int device, void* stream) {
  Geo g{};
  if (make_geo(g, B, T, H, Dh, scale) < 0 || groups < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.q = {q_sb, q_st, q_sh};
  g.k = {k_sb, k_st, k_sh};
  g.v = {v_sb, v_st, v_sh};
  g.g = {g_sb, g_st, g_sh};
  if (!bf16 || !p_bf16 || !mma_ok(g, true, q, k, v, dO)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(dres);
  float* p = static_cast<float*>(partial);
  return for_head_dim(Dh, [&](auto dh) {
    return run_bwd_onepass<decltype(dh)::value>(q, k, v, dO, l, r, dq, dk, dv,
                                                p, groups, g, s);
  });
}

// out[0..2] = blocks, threads a block and bytes of dynamic shared memory of
// the launch `flash_attn_fwd` (backward == 0) or `flash_attn_bwd` with these
// `groups` (its first kernel) makes for bf16 inputs with bf16 P at these
// sizes. Launches nothing.
int flash_attn_launch_shape(int backward, int B, int T, int H, int Dh,
                            int groups, int* out) {
  Geo g{};
  if (make_geo(g, B, T, H, Dh, 1.f) < 0 || groups < 0 || out == nullptr ||
      !(Dh == 16 || Dh == 32 || Dh == 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaunchShape at = for_head_dim(Dh, [&](auto dh) {
    constexpr int kDh = decltype(dh)::value;
    return backward ? bwd_onepass_shape<kDh>(g, groups) : fwd_shape<kDh>(g);
  });
  if (at.blocks > 2147483647LL || at.smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = static_cast<int>(at.blocks);
  out[1] = at.threads;
  out[2] = static_cast<int>(at.smem);
  return 0;
}

// An empty kernel at the given grid, block and dynamic shared memory: the
// launch floor under a kernel of that shape.
int flash_attn_empty(int blocks, int threads, int smem, int device,
                     void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_mma(flash_empty_kernel, static_cast<size_t>(smem), blocks,
                    threads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
