// The tensor-core InfoNCE kernels on the bf16 wire, shared by the fused
// heads (infonce_fused.cu, "mma" route) and the same-step pair on
// materialized predictions (infonce_same_step.cu, "mma" route). The two
// compute one function: prediction rows of target step tau score against
// the C candidates of step tau, softmax, positive at column shift + b,
// first argmax; backward delta = (softmax - onehot) * g, dz = delta^T p,
// dp = delta z. They differ only in how a prediction row is addressed,
// where a candidate column lies and where dz and dp go. Each file states
// that as an addressing policy, and `fwd_mma` and `bwd_mma` below are the
// kernels' bodies over it (the design is in infonce_fused.cu's note).
//
// An addressing policy `Addr` derives from MmaGeo and has
//   kFirstTau          the first target step with blocks (0 or 1); the row
//                      outputs and inputs (nll, correct, lse, g) are
//                      (T - kFirstTau, K*B) fp32, row tau - kFirstTau;
//   p, z               the operands (bf16), z also the `safe` address that
//                      a zero-filling copy names;
//   z_cs               the element stride between two candidates of a step;
//   row(tau, k, b)     the RowRef of prediction row (k, b) of step tau: its
//                      vector in p (nullptr: never read, zero-filled, delta
//                      0, nothing written), its offset in dp, and whether it
//                      lies in the window (delta is multiplied by 0 if not);
//   kNullRows          whether row() may return nullptr for a row of the
//                      problem (false keeps those tests out of the code);
//   column(tau, c0)    the vector of candidate c0 of step tau;
//   dp                 dp's base (bf16); row(...).out indexes it;
//   store_dz(tau, c, d, x, y)               dz[tau][c][d, d+1] = (x, y);
//   add_dz(tau, c, d, x, y, first, last)    the same, summed over the row
//                      groups by the one thread that owns (c, d): first and
//                      last say whether this is the first and last group;
//   finish(tau, d0, width)  the block's last writes (after its dz).
//
// CPC_DELTA_TERMS (default 3) is the number of bf16 terms delta enters its
// products as; a build with 2 is the deliberately worse kernel that
// chip_smoke.py holds its flip shares against.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "mma.cuh"

#ifndef CPC_DELTA_TERMS
#define CPC_DELTA_TERMS 3
#endif

namespace cpc {
namespace nce {

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
// the bf16 terms delta enters its products as: 3 (infonce_fused.cu's note)
constexpr int kHalves = 4;
constexpr int kTerms = CPC_DELTA_TERMS;

struct MmaGeo {
  int T, B, C, K, D, Tp, shift;
};

struct RowRef {
  const bf16_t* ptr;
  size_t out;
  bool valid;
};

// What a block knows of its (up to) kRows rows: the row's vector in p (or
// nullptr: not read), its dp offset, lse, g_nll * valid and positive
// column.
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

__device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

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
// step tau; lse and gn are nullptr in the forward. A row that is not read
// takes neither its lse nor its g. No synchronisation.
template <class Addr>
__device__ __forceinline__ void load_rows(Rows& rw, const Addr& a, int tau,
                                          int r0, const float* lse,
                                          const float* gn) {
  const int m = threadIdx.x;
  if (m >= kRows) return;
  const int r = r0 + m;
  if (r < a.K * a.B) {
    const int k = r / a.B, b = r % a.B;
    const RowRef row = a.row(tau, k, b);
    rw.ptr[m] = row.ptr;
    rw.out[m] = row.out;
    rw.label[m] = a.shift + b;
    const size_t o =
        static_cast<size_t>(tau - Addr::kFirstTau) * a.K * a.B + r;
    const bool read = !Addr::kNullRows || row.ptr != nullptr;
    rw.lse[m] = lse && read ? lse[o] : 0.f;
    rw.coef[m] = gn && read ? gn[o] * (row.valid ? 1.f : 0.f) : 0.f;
  } else {
    rw.ptr[m] = nullptr;
    rw.out[m] = 0;
    rw.label[m] = -1;
    rw.lse[m] = rw.coef[m] = 0.f;
  }
}

// Starts the copies of elements [k0, k0 + 64) of the first n_rows16 rows
// and of the first n_cols16 columns from zc (n_cols of them in the problem,
// zs elements apart) into `s`, zero-filling beyond D and outside the
// problem. A null row is never offset. `safe` is any valid 16-byte aligned
// address, named where nothing is read.
__device__ __forceinline__ void stage(Slabs& s, const Rows& rw, int n_rows16,
                                      const bf16_t* zc, size_t zs, int n_cols,
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
    cpc::cp_async16(&s.z[col][c], in ? zc + col * zs + k0 + c : safe,
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

// d as kTerms bf16 terms (entry e of each), each the rounding of what the
// terms before it left; the subtraction is exact.
__device__ __forceinline__ void split_terms(float d, float (&term)[kTerms][4],
                                            int e) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    term[i][e] = cpc::round_to<bf16_t>(d);
    d -= term[i][e];
  }
}

// The forward's body. Grid ((T - kFirstTau) * n_rb); block kMmaThreads;
// dynamic shared memory FwdSmem.
template <class Addr>
__device__ __forceinline__ void fwd_mma(const Addr& a, float* nll, float* cor,
                                        float* lse, int n_rb) {
  extern __shared__ __align__(16) unsigned char nce_smem[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(nce_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tau = blockIdx.x / n_rb + Addr::kFirstTau;
  const int r0 = (blockIdx.x % n_rb) * kRows;
  const int KB = a.K * a.B;
  const int n_rows = KB - r0 < kRows ? KB - r0 : kRows;
  const int KC = (a.D + kSlab - 1) / kSlab;
  const int n_ct = (a.C + kCols - 1) / kCols;
  const int total = n_ct * KC;
  load_rows(sm.rows, a, tau, r0, nullptr, nullptr);
  __syncthreads();
  auto fetch = [&](int q) {
    if (q < total) {
      const int c0 = (q / KC) * kCols;
      const int nc = a.C - c0 < kCols ? a.C - c0 : kCols;
      stage(sm.ring[q % kStages], sm.rows, round16(n_rows),
            a.column(tau, c0), a.z_cs, nc, round16(nc), (q % KC) * kSlab, a.D,
            a.z);
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
    const int nc = a.C - c0 < kCols ? a.C - c0 : kCols;
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
      st.update_row(h, v, col, a.C, label[h]);
    }
  }
  st.finish();
  if (active && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= n_rows) continue;
      const size_t o = static_cast<size_t>(tau - Addr::kFirstTau) * KB + r0 +
                       row[h];
      // a row that is not read: exact zeros
      const bool read = !Addr::kNullRows || sm.rows.ptr[row[h]] != nullptr;
      const float row_lse = st.lse(h);
      nll[o] = read ? row_lse - st.s_lab[h] : 0.f;
      cor[o] = read && st.best_c[h] == label[h] ? 1.f : 0.f;
      lse[o] = read ? row_lse : 0.f;
    }
  }
}

// The backward's body. Grid ((T - kFirstTau) * n_dc); block kMmaThreads;
// dynamic shared memory BwdSmem. kOneTile: C <= 64, dz's accumulator in
// registers; else C is swept in 64-column tiles and dz is summed over the
// row groups through add_dz by its owner thread.
//
// The block's work is a list of units, each a (row group, pass, column
// tile), and a unit is a list of jobs on one slab each: KC score jobs, then
// the product jobs (one per 64-wide half of the chunk; with more than one
// column tile one half per pass, so that dp's sum over the tiles stays in
// registers and dp is rounded once).
template <bool kOneTile, class Addr>
__device__ __forceinline__ void bwd_mma(const Addr& a, const float* gn,
                                        const float* lse, int n_dc) {
  extern __shared__ __align__(16) unsigned char nce_smem[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(nce_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qd = lane % 4, gr = lane / 4;
  bf16_t* __restrict__ const dp = a.dp;
  const int tau = blockIdx.x / n_dc + Addr::kFirstTau;
  const int d0 = (blockIdx.x % n_dc) * kSlab * kHalves;
  const int left = (a.D - d0 + kSlab - 1) / kSlab;
  const int nh = left < kHalves ? left : kHalves;
  const int KB = a.K * a.B;
  const int n_rg = (KB + kRows - 1) / kRows;
  const int n_ct = kOneTile ? 1 : (a.C + kCols - 1) / kCols;
  const int KC = (a.D + kSlab - 1) / kSlab;
  const int n_pass = kOneTile ? 1 : nh;
  const int n_prod = kOneTile ? nh : 1;
  const int jobs = KC + n_prod;
  const int units = n_rg * n_pass * n_ct;
  const int total = units * jobs;
  auto unit_rg = [&](int u) { return u / (n_pass * n_ct); };
  auto fetch = [&](int q) {
    if (q < total) {
      const int u = q / jobs, j = q % jobs;
      const int rg = unit_rg(u), ct = u % n_ct, pass = (u / n_ct) % n_pass;
      const int n_rows = KB - rg * kRows < kRows ? KB - rg * kRows : kRows;
      const int c0 = ct * kCols;
      const int nc = a.C - c0 < kCols ? a.C - c0 : kCols;
      const int k0 =
          j < KC ? j * kSlab : d0 + (kOneTile ? j - KC : pass) * kSlab;
      stage(sm.ring[q % kStages], sm.rows[u % kStages], round16(n_rows),
            a.column(tau, c0), a.z_cs, nc, round16(nc), k0, a.D, a.z);
    }
    cpc::cp_async_commit();
  };
  for (int u = 0; u < kStages - 1 && u < units; ++u) {
    load_rows(sm.rows[u], a, tau, unit_rg(u) * kRows, lse, gn);
  }
  __syncthreads();
  for (int q = 0; q < kStages - 1; ++q) fetch(q);

  float dzacc[kHalves][4][4] = {};
  float dpacc[8][4] = {};
  int q = 0;
  for (int u = 0; u < units; ++u) {
    const int ahead = u + kStages - 1;  // the farthest unit the ring reaches
    if (ahead < units) {
      load_rows(sm.rows[ahead % kStages], a, tau, unit_rg(ahead) * kRows, lse,
                gn);
      __syncthreads();
    }
    const Rows& rw = sm.rows[u % kStages];
    const int rg = unit_rg(u), ct = u % n_ct, pass = (u / n_ct) % n_pass;
    const int n_rows = KB - rg * kRows < kRows ? KB - rg * kRows : kRows;
    const int nr16 = round16(n_rows) / 16;
    const int c0 = ct * kCols;
    const int nc = a.C - c0 < kCols ? a.C - c0 : kCols;
    const int nq = round16(nc) / 16;
    const bool active = warp < nr16;  // warp-uniform
    float s[8][4] = {};
    for (int kc = 0; kc < KC; ++kc, ++q) {
      next_job(q, fetch);
      if (active) score_mma(sm.ring[q % kStages], nq, s);
      __syncthreads();
    }
    // delta as kTerms bf16 terms: A fragments, and parked for dz's
    // transposed read. A row that is not read gets delta = 0 (a `where`:
    // its g and lse are whatever the caller passed)
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
          const bool read = !Addr::kNullRows || rw.ptr[m] != nullptr;
          const float d = c < a.C && read
                              ? (expf(s[nt][e] - rw.lse[m]) -
                                 (c == rw.label[m] ? 1.f : 0.f)) *
                                    rw.coef[m]
                              : 0.f;
          split_terms(d, term, e);
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
            if (m >= n_rows || (Addr::kNullRows && rw.ptr[m] == nullptr)) {
              continue;
            }
            bf16_t* dst = dp + rw.out[m];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int d = dh0 + nt * 8 + qd * 2;
              if (d < a.D) {  // D is even: the pair is inside, 4-byte aligned
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
          unsigned af[kTerms][4];
          const int ar = ks * 16 + (lane / 16) * 8 + lane % 8;
          const int ac = pt.cw + ((lane / 8) % 2) * 8;
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            cpc::ldmatrix_x4_trans(af[i], &sm.delta[i][ar][ac]);
          }
#pragma unroll
          for (int dpr = 0; dpr < 2; ++dpr) {
            if (dpr >= pt.pairs) break;  // block-uniform
            unsigned b[4];
            const int bc = pt.dw + dpr * 16 + (lane / 16) * 8;
            cpc::ldmatrix_x4_trans(b, &sl.p[ks * 16 + lane % 16][bc]);
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
              cpc::mma_bf16(t[2 * dpr], af[i], b[0], b[1]);
              cpc::mma_bf16(t[2 * dpr + 1], af[i], b[2], b[3]);
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
            if (c >= a.C) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int d = dh0 + pt.dw + j * 8 + qd * 2;
              if (j >= 2 * pt.pairs || d >= a.D) continue;
              a.add_dz(tau, c, d, t[j][2 * h], t[j][2 * h + 1], rg == 0,
                       rg == n_rg - 1);
            }
          }
        }
      }
      __syncthreads();
      ++q;
    }
  }
  if (kOneTile) {
    const DzPart pt = dz_part(round16(a.C) / 16, warp);
#pragma unroll
    for (int hj = 0; hj < kHalves; ++hj) {
      if (hj >= nh) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = pt.cw + gr + h * 8;
        if (c >= a.C) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + hj * kSlab + pt.dw + j * 8 + qd * 2;
          if (j < 2 * pt.pairs && d < a.D) {
            a.store_dz(tau, c, d, dzacc[hj][j][2 * h],
                       dzacc[hj][j][2 * h + 1]);
          }
        }
      }
    }
  }
  a.finish(tau, d0, nh * kSlab);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Whether cp.async's 16 bytes fit the operands: D a multiple of 8 elements
// (so is every row's offset) and both pointers 16-byte aligned.
inline bool mma_ok(int D, const void* p, const void* z) {
  return D % 8 == 0 && reinterpret_cast<size_t>(p) % 16 == 0 &&
         reinterpret_cast<size_t>(z) % 16 == 0;
}

constexpr int kRouteSimt = 0, kRouteMma = 1;

}  // namespace nce
}  // namespace cpc
