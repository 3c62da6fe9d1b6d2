// GRU recurrence, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes (cpc_tpu_torch/ops/gru_cuda.py; built by
// cpc_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels cpc_tpu/ops/gru_pallas.py::_fwd_kernel (launched
// by `_fwd` through `gru_scan`) and ::_bwd_kernel (launched by `_bwd_rule`).
//
// WHAT IS COMPUTED. Forward, for t = 0..T-1 and every batch row b:
//   hp = round(h) @ wh + bh            product accumulated in fp32
//   r  = sigmoid(xr + hr),  z = sigmoid(xz + hz)
//   n  = tanh(xn + r * hn)
//   h  = (1 - z) * n + z * h           h carried in fp32
//   out[t, b] = h rounded to the wire dtype
// where round(.) rounds h to wh's dtype (the identity for fp32), the gate
// order is torch.nn.GRU's r, z, n, and the gates run in fp32 whatever the
// wire dtype. The rounded output never feeds back into the recurrence.
// Backward, as the Pallas kernel: h_{t-1} is the forward's rounded output of
// step t-1 (round(h0) at t = 0); the gates are recomputed from
// round(h_{t-1}) @ wh + bh; dh (fp32) gains g[t]; dr_pre, dz_pre, dn_pre and
// dhn = dn_pre * r follow; dxproj[t] = (dr_pre, dz_pre, dn_pre) in the wire
// dtype; dhp[t] = (dr_pre, dz_pre, dhn) in fp32; dh = dh * z + dhp @ wh^T in
// fp32; dwh = sum_{t,b} h_{t-1}^T dhp and dbh = sum_{t,b} dhp in fp32.
//
// WHAT BOUNDS IT. Neither bytes nor operations: T steps that each wait for
// the one before. A step's product is small (B x H x 3H: 25 MFLOP at
// (B, H) = (64, 256)), so a step costs what it takes to get the operands to
// the arithmetic and h from the units that made it to the units that need
// it. Measured on an H100 80GB HBM3 at 700 W, (T, B, H) = (128, 64, 256) in
// bf16 (chip_smoke.py): forward 3.9 us a step, of which the exchange and the
// cluster barrier alone are 1.1 us (gru_exchange_probe_kernel); the
// backward's recurrence 4.3 us a step. No atomics and fixed summation
// orders: two runs are bit-identical.
//
// TWO ROUTES, chosen by the caller from H alone (gru_cuda.py::gru_route).
//
// RESIDENT (H = 32, 64, 128 or 256: every preset). A thread-block cluster of
// C = H / 32 blocks owns a tile of kBt batch rows (8, or 16) for all T
// steps; block c owns the hidden units [32 c, 32 c + 32), one per lane, and
// the thread of warp w and lane l the tile's rows [w kBt / 8, (w + 1) kBt / 8)
// of unit 32 c + l: their h, or dh, stays in its fp32 registers.
//
//   Forward (gru_fwd_resident_kernel). The block keeps the 3 x 32 columns of
//   wh of its units (gates r, z, n) in shared memory for the whole launch,
//   so wh is read from device memory once a block, not once a step: H x 96
//   values, 48 KB in bf16 and 96 KB in fp32 at H = 256. They are laid out
//   [k / 4][gate][unit][k % 4], so a lane reads four consecutive k of its
//   column in one 8- or 16-byte load and a warp's load is contiguous.
//   round(h) of all H units of the tile's rows sits in shared memory as
//   fp32, double-buffered, read four k at a time as one broadcast. The
//   product (split_product) splits the CONTRACTION over the 8 warps: warp w
//   multiplies k in [w H / 8, (w + 1) H / 8) for all kBt rows, so a load of
//   wh serves every row and a thread has 3 kBt independent chains of fmaf;
//   the partial sums go through shared memory and the owner of (row, unit)
//   adds the 8 of them in warp order. (Each warp taking its own rows over
//   the whole contraction was slower: every warp then read the whole slice
//   and a thread had only 6 chains.) The owner applies the gates, writes
//   out[t] from registers and stores round(h) into the next-step buffer of
//   EVERY block of the cluster through distributed shared memory
//   (cluster.map_shared_rank). One cluster barrier a step (arrive.release /
//   wait.acquire) separates these stores from the next step's reads; with
//   two buffers a fast block cannot overwrite what a slow one still reads,
//   because it cannot pass the barrier in between without it. xproj[t + 1]
//   is loaded into registers before step t's product (a thread consumes
//   exactly the elements it loads, 2 bytes each in bf16, below cp.async's
//   4-byte minimum), so no device-memory latency sits on the chain. The
//   product runs on the fp32 pipe in both wire dtypes; 8 rows a cluster
//   (64 blocks at B = 64) measured faster than 16.
//
//   Backward, three stages, only the second serial:
//   1. gru_gates_kernel, a full grid: the gates of all T*B rows at once,
//      (T*B x H) @ (H x 3H) through cpc::tile_mm with h_{t-1} read from hs
//      and round(h0), then r, z, n and hn in fp32 to a scratch
//      (T*B, 4, H). None of this depends on the reversed recurrence.
//   2. gru_bwd_resident_kernel, clusters laid out as in the forward. Block
//      c keeps ROWS [32 c, 32 c + 32) of wh resident ([j / 4][unit][j % 4]),
//      because dh[b, i] = sum_j dhp[b, j] wh[i, j] reads row i; no
//      transposed copy of wh is made. Per step: d = dh + g[t]; the five
//      gate gradients from stage 1's scratch; dxproj[t] and the fp32
//      dhp[t] scratch written; the block's 3 x 32 entries of dhp stored
//      into the double-buffered (kBt x 3H) fp32 dhp tile of every block of
//      the cluster; one cluster barrier; then (kBt x 3H) @ (3H x 32)
//      through split_product on the fp32 pipe, fp32 x fp32 as the Pallas
//      kernel's (dhp is not split into bf16 terms). The next step's inputs
//      are loaded into registers before the barrier.
//   3. gru_bwd_reduce_kernel and gru_bwd_finish_kernel: dwh and dbh as
//      sums over all T*B rows, per-split partials (64 x 64 output tiles,
//      fp32) summed in a fixed order and rounded to wh's dtype.
//
// STREAMED (any other H up to 1024, e.g. 40, 512, 1024, whose slice of wh
// does not fit a block or is not a whole number of warps). Each block owns
// kRows = 2 batch rows and loops over T alone; thread i owns hidden unit i
// and reads all of wh from L2 in every step (gru_scan_fwd_kernel,
// gru_scan_bwd_kernel, which recomputes the gates inside its loop and walks
// row i of wh for dhp @ wh^T). (B / 2) * T * |wh| bytes of L2 reads: slow,
// and kept for the shapes the resident route does not take; stage 3 is
// shared.
//
// Rows beyond `batch` in the last tile are masked: they load nothing, store
// nothing to device memory and exchange zeros. B = 1 and T = 1 are ordinary
// cases. A route that cannot launch (cudaOccupancyMaxActiveClusters < 1)
// returns the error; there is no fallback from one route to the other.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using cpc::from_f32;
using cpc::round_to;
using cpc::to_f32;

constexpr int kRows = 2;          // streamed route: batch rows per block
constexpr int kMaxHidden = 1024;  // streamed route: one thread per unit

constexpr int kUnits = 32;        // resident route: units per block, one a lane
constexpr int kResThreads = 256;  // resident route: 8 warps share the rows
constexpr int kResWarps = kResThreads / 32;
constexpr int kMaxCluster = 8;    // the portable maximum

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive elements at p (aligned to their total size) as fp32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// out[r][g] = sum_{k < depth} a[(row0 + r) * depth + k] * W[k][g][lane] for
// the kBt / 8 rows and kG columns that a thread owns, with the contraction
// split over the block's 8 warps: warp w sums k in [w depth / 8,
// (w + 1) depth / 8), ascending, for ALL kBt rows (so one load of W serves
// kBt rows and a thread has kBt * kG independent chains of fmaf), writes its
// partial sums to red [8][kBt][kG][32], and after a block barrier the owner
// adds the 8 partials in warp order. w points at this lane's first four
// values of W, stored [depth / 4][kG][kUnits][4]; a (fp32, rows of `depth`,
// 16-byte aligned) at the tile's first row. depth % 32 == 0. Every thread of
// the block must call it; red may be reused after the next barrier.
template <typename T, int kBt, int kG>
__device__ __forceinline__ void split_product(
    const T* __restrict__ w, const float* __restrict__ a, int depth,
    float* __restrict__ red, int warp, int lane, int row0,
    float (&out)[kBt / kResWarps][kG]) {
  float acc[kBt][kG];
#pragma unroll
  for (int r = 0; r < kBt; ++r)
#pragma unroll
    for (int g = 0; g < kG; ++g) acc[r][g] = 0.f;
  const int chunk4 = depth / (4 * kResWarps);
#pragma unroll(kG == 1 ? 2 : 1)
  for (int k4 = warp * chunk4; k4 < (warp + 1) * chunk4; ++k4) {
    float wv[kG][4];
#pragma unroll
    for (int g = 0; g < kG; ++g)
      load4(w + static_cast<size_t>(k4 * kG + g) * kUnits * 4, wv[g]);
#pragma unroll
    for (int r = 0; r < kBt; ++r) {
      float av[4];
      load4(a + r * depth + k4 * 4, av);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          acc[r][g] = fmaf(av[e], wv[g][e], acc[r][g]);
    }
  }
#pragma unroll
  for (int r = 0; r < kBt; ++r)
#pragma unroll
    for (int g = 0; g < kG; ++g)
      red[((warp * kBt + r) * kG + g) * kUnits + lane] = acc[r][g];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBt / kResWarps; ++r)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < kResWarps; ++v)
        sum += red[((v * kBt + row0 + r) * kG + g) * kUnits + lane];
      out[r][g] = sum;
    }
}

// ------------------------------------------------------------- resident route
// Forward. xproj (T, B, 3H), wh (H, 3H) in T; bh (3H,), h0 (B, H) fp32;
// out (T, B, H) in T. Grid: tiles * C blocks in clusters of C = H / 32.
// Dynamic shared memory: h [2][kBt][H] and the partial sums [8][kBt][96],
// fp32, then H * 96 of T.
template <typename T, int kBt>
__global__ void __launch_bounds__(kResThreads)
    gru_fwd_resident_kernel(const T* __restrict__ xproj,
                            const T* __restrict__ wh,
                            const float* __restrict__ bh,
                            const float* __restrict__ h0, T* __restrict__ out,
                            int steps, int batch, int hidden) {
  constexpr int kR = kBt / kResWarps;
  extern __shared__ float4 res_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float* hbuf = reinterpret_cast<float*>(res_smem);
  float* red = hbuf + 2 * kBt * hidden;
  T* ws = reinterpret_cast<T*>(red + kResWarps * kBt * 3 * kUnits);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b0 = (blockIdx.x / nblk) * kBt;
  const int row0 = warp * kR;            // this warp's first row of the tile
  const int u = rank * kUnits + lane;    // this lane's hidden unit
  const size_t h3 = 3 * static_cast<size_t>(hidden);

  for (int e = threadIdx.x; e < hidden * 3 * kUnits; e += kResThreads) {
    const int ul = e % kUnits, g = (e / kUnits) % 3, k = e / (3 * kUnits);
    ws[(((k / 4) * 3 + g) * kUnits + ul) * 4 + k % 4] =
        wh[k * h3 + g * hidden + rank * kUnits + ul];
  }
  for (int e = threadIdx.x; e < kBt * hidden; e += kResThreads) {
    const int b = b0 + e / hidden;
    hbuf[e] = b < batch
                  ? round_to<T>(h0[static_cast<size_t>(b) * hidden + e % hidden])
                  : 0.f;
  }
  const float bhr = bh[u], bhz = bh[hidden + u], bhn = bh[2 * hidden + u];
  float h[kR], xr[kR], xz[kR], xn[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int b = b0 + row0 + r;
    h[r] = xr[r] = xz[r] = xn[r] = 0.f;
    if (b < batch) {
      h[r] = h0[static_cast<size_t>(b) * hidden + u];
      const T* xp = xproj + static_cast<size_t>(b) * h3;
      xr[r] = to_f32(xp[u]);
      xz[r] = to_f32(xp[hidden + u]);
      xn[r] = to_f32(xp[2 * hidden + u]);
    }
  }
  // every block of the cluster runs and has filled its buffers before any
  // peer stores into them
  cluster.sync();

  for (int t = 0; t < steps; ++t) {
    const float* hcur = hbuf + (t & 1) * kBt * hidden;
    float* hnext = hbuf + ((t + 1) & 1) * kBt * hidden;
    float nxr[kR], nxz[kR], nxn[kR];  // xproj[t + 1], in flight over the product
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int b = b0 + row0 + r;
      nxr[r] = nxz[r] = nxn[r] = 0.f;
      if (t + 1 < steps && b < batch) {
        const T* xp = xproj + (static_cast<size_t>(t + 1) * batch + b) * h3;
        nxr[r] = to_f32(xp[u]);
        nxz[r] = to_f32(xp[hidden + u]);
        nxn[r] = to_f32(xp[2 * hidden + u]);
      }
    }
    float acc[kR][3];
    split_product<T, kBt, 3>(ws + lane * 4, hcur, hidden, red, warp, lane,
                             row0, acc);
    float hr[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int b = b0 + row0 + r;
      const float rg = sigmoid(xr[r] + (acc[r][0] + bhr));
      const float zg = sigmoid(xz[r] + (acc[r][1] + bhz));
      const float ng = tanhf(xn[r] + rg * (acc[r][2] + bhn));
      h[r] = (1.0f - zg) * ng + zg * h[r];
      const T hw = from_f32<T>(h[r]);
      hr[r] = to_f32(hw);
      if (b < batch)
        out[(static_cast<size_t>(t) * batch + b) * hidden + u] = hw;
    }
    // round(h) of this block's units into every block's next-step buffer,
    // each block starting with itself so the peers are not hit in step
    for (int p = 0; p < nblk; ++p) {
      float* dst = cluster.map_shared_rank(hnext, (rank + p) % nblk);
#pragma unroll
      for (int r = 0; r < kR; ++r) dst[(row0 + r) * hidden + u] = hr[r];
    }
    // also the barrier after the last step: no block exits while a peer can
    // still store into it
    cluster.sync();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      xr[r] = nxr[r];
      xz[r] = nxz[r];
      xn[r] = nxn[r];
    }
  }
}

// Row t*B + b of h_{t-1}: round(h0[b]) for t = 0 and hs[t-1, b] after.
template <typename T>
__device__ __forceinline__ float h_prev_at(const T* __restrict__ hs,
                                           const float* __restrict__ h0,
                                           long long row, int batch,
                                           int hidden, int k) {
  if (row < batch) return round_to<T>(h0[row * hidden + k]);
  return to_f32(hs[(row - batch) * hidden + k]);
}

// Backward, stage 1: r, z, n and hn = h_{t-1} @ wh_n + bh_n of all T*B rows,
// fp32, to gates (T*B, 4, H). Grid (ceil(T*B / 64), ceil(H / 64)).
template <typename T>
__global__ void __launch_bounds__(cpc::kTileThreads)
    gru_gates_kernel(const T* __restrict__ xproj, const T* __restrict__ wh,
                     const float* __restrict__ bh,
                     const float* __restrict__ h0, const T* __restrict__ hs,
                     float* __restrict__ gates, int steps, int batch,
                     int hidden) {
  __shared__ cpc::TileSmem smem;
  const size_t h3 = 3 * static_cast<size_t>(hidden);
  const long long rows = static_cast<long long>(steps) * batch;
  const long long m0 = static_cast<long long>(blockIdx.x) * cpc::kTile;
  const int n0 = blockIdx.y * cpc::kTile;

  auto hprev = [&](int k, int m) -> float {
    const long long row = m0 + m;
    return row < rows ? h_prev_at(hs, h0, row, batch, hidden, k) : 0.f;
  };
  float acc[3][4][4] = {};
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    auto w = [&](int k, int n) -> float {
      const int j = n0 + n;
      return j < hidden ? to_f32(wh[k * h3 + g * hidden + j]) : 0.f;
    };
    cpc::tile_mm<true, false>(hidden, hprev, w, acc[g], smem);
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = m0 + ty * 4 + a;
    if (row >= rows) continue;
    const T* xp = xproj + row * h3;
    float* out = gates + row * 4 * hidden;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = n0 + tx * 4 + c;
      if (j >= hidden) continue;
      const float rg = sigmoid(to_f32(xp[j]) + (acc[0][a][c] + bh[j]));
      const float zg =
          sigmoid(to_f32(xp[hidden + j]) + (acc[1][a][c] + bh[hidden + j]));
      const float hn = acc[2][a][c] + bh[2 * hidden + j];
      out[j] = rg;
      out[hidden + j] = zg;
      out[2 * hidden + j] = tanhf(to_f32(xp[2 * hidden + j]) + rg * hn);
      out[3 * hidden + j] = hn;
    }
  }
}

// What a step of the reversed recurrence reads for one (row, unit).
struct BwdStepIn {
  float r, z, n, hn, g, hprev;
};

template <typename T>
__device__ __forceinline__ BwdStepIn load_bwd_step(
    const float* __restrict__ gates, const float* __restrict__ h0,
    const T* __restrict__ hs, const T* __restrict__ g, int t, int b, int u,
    int batch, int hidden) {
  BwdStepIn in = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (t < 0 || b >= batch) return in;
  const long long row = static_cast<long long>(t) * batch + b;
  const float* q = gates + row * 4 * hidden + u;
  in.r = q[0];
  in.z = q[hidden];
  in.n = q[2 * hidden];
  in.hn = q[3 * hidden];
  in.g = to_f32(g[row * hidden + u]);
  in.hprev = h_prev_at(hs, h0, row, batch, hidden, u);
  return in;
}

// Backward, stage 2: the recurrence reversed. wh (H, 3H), hs, g (T, B, H) in
// T; gates (T*B, 4, H), h0 (B, H) fp32. Writes dxproj (T, B, 3H) in T, dhp
// (T, B, 3H) fp32, dh0 (B, H) fp32. Grid and clusters as the forward.
// Dynamic shared memory: dhp [2][kBt][3H] and the partial sums [8][kBt][32],
// fp32, then 32 * 3H of T.
template <typename T, int kBt>
__global__ void __launch_bounds__(kResThreads)
    gru_bwd_resident_kernel(const T* __restrict__ wh,
                            const float* __restrict__ gates,
                            const float* __restrict__ h0,
                            const T* __restrict__ hs, const T* __restrict__ g,
                            T* __restrict__ dxproj, float* __restrict__ dhp,
                            float* __restrict__ dh0, int steps, int batch,
                            int hidden) {
  constexpr int kR = kBt / kResWarps;
  extern __shared__ float4 res_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h3 = 3 * hidden;
  float* dbuf = reinterpret_cast<float*>(res_smem);
  float* red = dbuf + 2 * kBt * h3;
  T* ws = reinterpret_cast<T*>(red + kResWarps * kBt * kUnits);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b0 = (blockIdx.x / nblk) * kBt;
  const int row0 = warp * kR;
  const int u = rank * kUnits + lane;

  for (int e = threadIdx.x; e < kUnits * h3; e += kResThreads) {
    const int ul = e / h3, j = e % h3;
    ws[((j / 4) * kUnits + ul) * 4 + j % 4] =
        wh[static_cast<size_t>(rank * kUnits + ul) * h3 + j];
  }
  float dh[kR];
  BwdStepIn in[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    dh[r] = 0.f;
    in[r] = load_bwd_step(gates, h0, hs, g, steps - 1, b0 + row0 + r, u, batch,
                          hidden);
  }
  cluster.sync();

  for (int t = steps - 1; t >= 0; --t) {
    float* dcur = dbuf + (t & 1) * kBt * h3;
    float dr_pre[kR], dz_pre[kR], dhn[kR], dhz[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int b = b0 + row0 + r;
      const float rg = in[r].r, zg = in[r].z, ng = in[r].n, hn = in[r].hn;
      const float d = dh[r] + in[r].g;  // dL/dh_t
      const float dz = d * (in[r].hprev - ng);
      const float dn_pre = d * (1.0f - zg) * (1.0f - ng * ng);
      dhn[r] = dn_pre * rg;
      dr_pre[r] = dn_pre * hn * rg * (1.0f - rg);
      dz_pre[r] = dz * zg * (1.0f - zg);
      dhz[r] = d * zg;
      if (b < batch) {
        const size_t row = static_cast<size_t>(t) * batch + b;
        T* dx = dxproj + row * h3;
        dx[u] = from_f32<T>(dr_pre[r]);
        dx[hidden + u] = from_f32<T>(dz_pre[r]);
        dx[2 * hidden + u] = from_f32<T>(dn_pre);
        float* dp = dhp + row * h3;
        dp[u] = dr_pre[r];
        dp[hidden + u] = dz_pre[r];
        dp[2 * hidden + u] = dhn[r];
      }
    }
    for (int p = 0; p < nblk; ++p) {
      float* dst = cluster.map_shared_rank(dcur, (rank + p) % nblk);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float* ds = dst + (row0 + r) * h3;
        ds[u] = dr_pre[r];
        ds[hidden + u] = dz_pre[r];
        ds[2 * hidden + u] = dhn[r];
      }
    }
    // step t-1's inputs, in flight over the barrier and the product
#pragma unroll
    for (int r = 0; r < kR; ++r)
      in[r] = load_bwd_step(gates, h0, hs, g, t - 1, b0 + row0 + r, u, batch,
                            hidden);
    cluster.sync();
    float acc[kR][1];
    split_product<T, kBt, 1>(ws + lane * 4, dcur, h3, red, warp, lane, row0,
                             acc);
#pragma unroll
    for (int r = 0; r < kR; ++r) dh[r] = dhz[r] + acc[r][0];
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int b = b0 + row0 + r;
    if (b < batch) dh0[static_cast<size_t>(b) * hidden + u] = dh[r];
  }
  // no barrier: the peers' last stores came before step 0's barrier
}

// The serial floor of the resident forward, measured: its exchange (round(h)
// of 32 units x kBt rows stored into every block of the cluster) and its
// cluster barrier, `steps` times, without the product and the gates.
template <int kBt>
__global__ void __launch_bounds__(kResThreads)
    gru_exchange_probe_kernel(float* __restrict__ sink, int steps,
                              int hidden) {
  constexpr int kR = kBt / kResWarps;
  extern __shared__ float4 res_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float* hbuf = reinterpret_cast<float*>(res_smem);
  const int lane = threadIdx.x % 32, row0 = (threadIdx.x / 32) * kR;
  const int u = rank * kUnits + lane;
  for (int e = threadIdx.x; e < 2 * kBt * hidden; e += kResThreads)
    hbuf[e] = 0.f;
  float v = static_cast<float>(threadIdx.x);
  cluster.sync();
  for (int t = 0; t < steps; ++t) {
    float* hnext = hbuf + ((t + 1) & 1) * kBt * hidden;
    for (int p = 0; p < nblk; ++p) {
      float* dst = cluster.map_shared_rank(hnext, (rank + p) % nblk);
#pragma unroll
      for (int r = 0; r < kR; ++r) dst[(row0 + r) * hidden + u] = v;
    }
    cluster.sync();
    // the next step's value depends on what a peer stored in this one
    v = 0.5f * v + hnext[row0 * hidden + (u + kUnits) % hidden];
  }
  sink[blockIdx.x * kResThreads + threadIdx.x] = v;
}

// Launches `kernel` on `clusters` clusters of `cluster_size` blocks of
// kResThreads threads with `smem` bytes of dynamic shared memory each.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int clusters,
                            int cluster_size, size_t smem, cudaStream_t s,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster_size);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The cluster size of the resident route for `hidden`, or 0 if it does not
// take that width.
int resident_cluster(int hidden) {
  const int c = hidden / kUnits;
  const bool pow2 = c > 0 && (c & (c - 1)) == 0;
  return (hidden % kUnits == 0 && pow2 && c <= kMaxCluster) ? c : 0;
}

template <typename T, int kBt>
cudaError_t launch_fwd_resident(const void* xproj, const void* wh,
                                const float* bh, const float* h0, void* out,
                                int steps, int batch, int hidden,
                                cudaStream_t s) {
  const size_t smem =
      (2 * kBt * hidden + kResWarps * kBt * 3 * kUnits) * sizeof(float) +
      static_cast<size_t>(hidden) * 3 * kUnits * sizeof(T);
  return launch_clusters(gru_fwd_resident_kernel<T, kBt>,
                         (batch + kBt - 1) / kBt, resident_cluster(hidden),
                         smem, s, static_cast<const T*>(xproj),
                         static_cast<const T*>(wh), bh, h0,
                         static_cast<T*>(out), steps, batch, hidden);
}

// -------------------------------------------------------------- streamed route
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

// The streamed backward's recurrence. xproj, g (T, B, 3H) / (T, B, H),
// hs (T, B, H), wh (H, 3H), all in T; bh (3H,), h0 (B, H) fp32.
// Writes dxproj (T, B, 3H) in T, dhp (T, B, 3H) fp32, dh0 (B, H) fp32.
template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
    gru_scan_bwd_kernel(const T* __restrict__ xproj, const T* __restrict__ wh,
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
        hprev[r] = h_prev_at(hs, h0, static_cast<long long>(t) * batch + b,
                             batch, hidden, i);
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
      // dh += dhp @ wh^T: thread i walks row i of wh. Neighbouring threads
      // read rows 3H apart, so a warp's load is not coalesced; a row's
      // 32-byte sectors stay in L1 for the next elements.
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* w = wh + i * h3;
#pragma unroll 4
      for (size_t j = 0; j < h3; ++j) {
        const float wv = to_f32(w[j]);
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

// ------------------------------------------------- stage 3, both routes
// Partial dwh and dbh of one split of the T*B rows. Grid
// (ceil(3H / 64), ceil(H / 64), splits); split s covers rows
// [s * chunk, min(T*B, (s+1) * chunk)).
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
    const int k = m0 + m;
    return k < hidden ? h_prev_at(hs, h0, r0 + r, batch, hidden, k) : 0.f;
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

// Sums the partials of all splits in split order; dwh in T.
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

template <typename T, int kBt>
cudaError_t launch_bwd_resident(const T* xproj, const T* wh, const float* bh,
                                const float* h0, const T* hs, const T* g,
                                T* dxproj, float* dhp, float* dh0,
                                float* gates, int steps, int batch, int hidden,
                                cudaStream_t s) {
  const long long rows = static_cast<long long>(steps) * batch;
  const dim3 grid(static_cast<unsigned>((rows + cpc::kTile - 1) / cpc::kTile),
                  (hidden + cpc::kTile - 1) / cpc::kTile);
  gru_gates_kernel<T><<<grid, cpc::kTileThreads, 0, s>>>(
      xproj, wh, bh, h0, hs, gates, steps, batch, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem =
      (2 * kBt * 3 * hidden + kResWarps * kBt * kUnits) * sizeof(float) +
      static_cast<size_t>(kUnits) * 3 * hidden * sizeof(T);
  return launch_clusters(gru_bwd_resident_kernel<T, kBt>,
                         (batch + kBt - 1) / kBt, resident_cluster(hidden),
                         smem, s, wh, static_cast<const float*>(gates), h0, hs,
                         g, dxproj, dhp, dh0, steps, batch, hidden);
}

// The backward of either route: the recurrence (with stage 1 before it on
// the resident route), then stage 3.
template <typename T>
cudaError_t launch_bwd(const void* xproj_, const void* wh_, const float* bh,
                       const float* h0, const void* hs_, const void* g_,
                       void* dxproj_, float* dhp, float* dh0, float* pdwh,
                       float* pdbh, void* dwh, float* dbh, float* gates,
                       int steps, int batch, int hidden, int splits,
                       int tile_rows, cudaStream_t s) {
  const T* xproj = static_cast<const T*>(xproj_);
  const T* wh = static_cast<const T*>(wh_);
  const T* hs = static_cast<const T*>(hs_);
  const T* g = static_cast<const T*>(g_);
  T* dxproj = static_cast<T*>(dxproj_);
  cudaError_t err;
  if (tile_rows == 16) {
    err = launch_bwd_resident<T, 16>(xproj, wh, bh, h0, hs, g, dxproj, dhp,
                                     dh0, gates, steps, batch, hidden, s);
  } else if (tile_rows == 8) {
    err = launch_bwd_resident<T, 8>(xproj, wh, bh, h0, hs, g, dxproj, dhp, dh0,
                                    gates, steps, batch, hidden, s);
  } else {
    const int threads = (hidden + 31) / 32 * 32;
    const size_t smem = 4 * kRows * static_cast<size_t>(hidden) * sizeof(float);
    gru_scan_bwd_kernel<T><<<(batch + kRows - 1) / kRows, threads, smem, s>>>(
        xproj, wh, bh, h0, hs, g, dxproj, dhp, dh0, steps, batch, hidden);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(steps) * batch;
  const int chunk = static_cast<int>((rows + splits - 1) / splits);
  const dim3 grid((3 * hidden + cpc::kTile - 1) / cpc::kTile,
                  (hidden + cpc::kTile - 1) / cpc::kTile, splits);
  gru_bwd_reduce_kernel<T><<<grid, cpc::kTileThreads, 0, s>>>(
      hs, h0, dhp, pdwh, pdbh, steps, batch, hidden, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 3LL * hidden * hidden + 3LL * hidden;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256
                                                              : 4096);
  gru_bwd_finish_kernel<T><<<blocks, 256, 0, s>>>(
      pdwh, pdbh, static_cast<T*>(dwh), dbh, hidden, splits);
  return cudaGetLastError();
}

// tile_rows is 0 for the streamed route, else the resident route's rows a
// cluster (8 or 16), which `hidden` must allow.
bool valid_route(int tile_rows, int hidden) {
  if (tile_rows == 0) return hidden <= kMaxHidden;
  return (tile_rows == 8 || tile_rows == 16) && resident_cluster(hidden) > 0;
}

}  // namespace

extern "C" {

int gru_scan_max_hidden() { return kMaxHidden; }

const char* cpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the recurrence on `stream` of `device` and returns the launch's
// error (0 on success). tile_rows: 0 for the streamed route, 8 or 16 batch
// rows a cluster for the resident one. bf16 != 0 selects the bf16 wire
// dtype, 0 the fp32 one. Does not synchronise.
int gru_scan_fwd(const void* xproj, const void* wh, const void* bh,
                 const void* h0, void* out, int steps, int batch, int hidden,
                 int tile_rows, int bf16, int device, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1 ||
      !valid_route(tile_rows, hidden)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bh32 = static_cast<const float*>(bh);
  const float* h032 = static_cast<const float*>(h0);
  if (tile_rows == 16) {
    err = bf16 ? launch_fwd_resident<__nv_bfloat16, 16>(
                     xproj, wh, bh32, h032, out, steps, batch, hidden, s)
               : launch_fwd_resident<float, 16>(xproj, wh, bh32, h032, out,
                                                steps, batch, hidden, s);
    return static_cast<int>(err);
  }
  if (tile_rows == 8) {
    err = bf16 ? launch_fwd_resident<__nv_bfloat16, 8>(
                     xproj, wh, bh32, h032, out, steps, batch, hidden, s)
               : launch_fwd_resident<float, 8>(xproj, wh, bh32, h032, out,
                                               steps, batch, hidden, s);
    return static_cast<int>(err);
  }
  const int threads = (hidden + 31) / 32 * 32;
  const dim3 grid((batch + kRows - 1) / kRows);
  const size_t smem = 2 * kRows * static_cast<size_t>(hidden) * sizeof(float);
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

// Launches the backward's kernels on `stream` and returns the first launch
// error (0 on success). Inputs as gru_scan_fwd, plus hs (T, B, H) and g
// (T, B, H) in the wire dtype. Outputs: dxproj (T, B, 3H) wire dtype, dh0
// (B, H) fp32, dwh (H, 3H) wire dtype, dbh (3H,) fp32. Scratch: dhp
// (T, B, 3H) fp32, pdwh (splits, H, 3H) and pdbh (splits, 3H) fp32, and on
// the resident route gates (T*B, 4, H) fp32. Does not synchronise.
int gru_scan_bwd(const void* xproj, const void* wh, const void* bh,
                 const void* h0, const void* hs, const void* g, void* dxproj,
                 void* dhp, void* dh0, void* pdwh, void* pdbh, void* dwh,
                 void* dbh, void* gates, int steps, int batch, int hidden,
                 int splits, int tile_rows, int bf16, int device,
                 void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1 ||
      !valid_route(tile_rows, hidden) || splits < 1 || splits > 65535) {
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
  float* gt = static_cast<float*>(gates);
  err = bf16 ? launch_bwd<__nv_bfloat16>(xproj, wh, bh32, h032, hs, g, dxproj,
                                         dhp32, dh032, pw, pb, dwh, db, gt,
                                         steps, batch, hidden, splits,
                                         tile_rows, s)
             : launch_bwd<float>(xproj, wh, bh32, h032, hs, g, dxproj, dhp32,
                                 dh032, pw, pb, dwh, db, gt, steps, batch,
                                 hidden, splits, tile_rows, s);
  return static_cast<int>(err);
}

// Runs the resident forward's exchange and cluster barrier `steps` times on
// one cluster, without its product (the measured serial floor). sink holds
// at least 8 * 256 floats.
int gru_exchange_probe(void* sink, int steps, int hidden, int tile_rows,
                       int device, void* stream) {
  if (steps < 1 || tile_rows == 0 || !valid_route(tile_rows, hidden)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(tile_rows) * hidden *
                      sizeof(float);
  float* out = static_cast<float*>(sink);
  err = tile_rows == 16
            ? launch_clusters(gru_exchange_probe_kernel<16>, 1,
                              resident_cluster(hidden), smem, s, out, steps,
                              hidden)
            : launch_clusters(gru_exchange_probe_kernel<8>, 1,
                              resident_cluster(hidden), smem, s, out, steps,
                              hidden);
  return static_cast<int>(err);
}

}  // extern "C"
