// The conv encoder's pyramid of strided Conv1d + ReLU layers, forward, for
// Hopper (sm_90a), bound to Python with ctypes
// (cpc_tpu_torch/ops/conv_cuda.py; built by cpc_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel of cpc_tpu/ops/conv_pallas.py: the body
// `_make_kernel` launched by `_pallas_forward` (`fused_conv_encoder`).
//
// The function: x (B, S) -> z (B, T_L, C_L). Layer i is a Conv1d of kernel
// k_i and stride s_i with flax's SAME padding (t_out = ceil(t_in / s), total
// padding max((t_out - 1) s + k - t_in, 0), `pad` = total / 2 of it on the
// left), then bias and ReLU. Operands are in the compute dtype (bf16 or
// fp32), sums and the bias add in fp32, and each layer's output is rounded
// once to the compute dtype. Activations are (B, T, C), channels
// contiguous; weights arrive packed (C_out, k, C_in). Input rows outside
// [0, t_in) read as zero, which is the SAME padding; no length has to
// divide a tile or a stride (the TPU kernel needed s | k and T_L % tile ==
// 0).
//
// The cut. The TPU kernel kept the whole pyramid of one (batch row, time
// tile) in its fast memory. An SM's 227 KB does not hold that with the
// weights, so here the forward is L - 1 launches:
//   * layers 1 and 2 in one kernel (`kFused`). Layer 1 contracts only k_1
//     taps of one input channel, so a block that owns a tile of layer-2
//     outputs makes the layer-1 rows it needs from the waveform, a slab of
//     channels at a time, straight into the shared-memory A operand of
//     layer 2's product. Layer 1's output (268 MB at tpu_fast, 69 % of all
//     intermediate bytes) never exists in device memory. A generated row
//     whose index is outside [0, T_1) is set to zero after bias and ReLU:
//     it is layer 2's padding, not relu(bias).
//   * one launch of the other kernel for each of layers 3..L, reading the
//     previous layer's (B, T, C) output (67, 34 and 17 MB at tpu_fast).
//   * a pyramid of one layer runs the SIMT kernel on the waveform (C_in = 1
//     is no operand for 16-byte copies).
//
// Two routes, chosen in Python (`pyramid_route`), which also makes each
// launch's plan (grid, tile, ring stages, shared memory, the tap table)
// and passes it in; a launcher checks the plan against what it can run and
// returns an error otherwise. Neither route gives way to the other.
//
// "simt": fp32 (the parity configuration), and bf16 shapes the wgmma
// kernels do not take. Products on the SIMT fp32 pipe through cpc::tile_mm
// (64 x 64 tiles; the fused one computes a layer-1 value where tile_mm asks
// for an element of A).
//
// "wgmma": bf16 with every C_in (of layers 2..L) and C_out a multiple of 8
// and 16-byte aligned pointers. What bounds it on this card: operations
// first. tpu_fast at batch 64 is 398 GFLOP (layer 2 alone 275, layers 3-5
// 69, 34 and 17) against 21.5 MB that must move: 0.40 ms at 989 TFLOP/s.
// Then L2, for the streamed operands (below). The design:
// - Every product is `wgmma` m64n128k16 (bf16 in, fp32 sums). A block owns
//   128 output rows (t) of one batch row by 128 output channels; two
//   consumer warpgroups own 64 rows each, and a producer warpgroup
//   (setmaxnreg: 104 registers a thread for it, 200 for a consumer) keeps a
//   ring of `stages` slots full with TMA through mbarriers: a slot's full
//   barrier completes on its bytes, each consumer warp marks it empty once
//   the wgmma reading it have completed. Grid (C_out / 128, T_out / 128, B),
//   the channel tiles fastest, so that the blocks that read the same input
//   rows run together.
// - The contraction runs over (slab of 64 input channels, tap) jobs. B is
//   the weight tile of a job, 128 channels x 64 of C_in, a TMA box of the
//   packed weights seen as the 3-D tensor {C_in, k, C_out}, in the
//   128-byte-swizzled layout the descriptors read; channels past C_in or
//   C_out arrive as zeros.
// - Layers 3..L: A is TMA'd too. Input row s t + j - pad of tap j is row
//   u = t + floor((j - pad) / s) of phase p = (j - pad) mod s, and phase p
//   of the (B, T_in, C_in) input is a 3-D map: base in + p C_in, dims
//   {C_in, ceil((T_in - p) / s), B}, strides {s C_in, T_in C_in} elements.
//   So each tap's A tile is one box at (c0, t0 + floor((j - pad) / s), b),
//   and rows before 0 or past the end and channels past C_in arrive as
//   zeros: the SAME padding and the ragged edges, with no mask in the
//   kernel. A phase with no rows (T_in <= p) gets a row coordinate far out
//   of range from the plan, so its box is all zeros. A slot holds the A and
//   B tiles of one job (32 KB). Each input row is read k / s times (2x at
//   tpu_fast's layers 3-5).
// - Layers 1 + 2: A is made in shared memory. The block holds its window
//   of the waveform and layer 1's weights; three warps of the producer
//   warpgroup (the fourth issues TMA) form a slab's layer-1 rows as
//   mma.sync m16n8k16 products of waveform frames (16 rows x k_1 taps, zero
//   past k_1 <= 16) with layer 1's weights, add the bias, round to bf16,
//   apply ReLU and the row mask and store them with stmatrix into one of
//   two slab buffers, while the consumers multiply the other: the
//   generation is off the consumers' path except for the first slab. It
//   is still what bounds the kernel: with no generation at all it runs at
//   470 TFLOP/s (PERF.md §6). A cluster of the 4 blocks that need the
//   same slab, each making a quarter and copying it to the others with
//   cp.async.bulk, was slower than each making its own.
//   Tap j of layer 2 reads local layer-1 rows l = s m + j, m = 0..127; the
//   slab keeps row l at slot (l mod s) RP + l / s (RP = 128 + (k - 1) / s),
//   so that a tap's rows are 128 consecutive slots, starting (l / s) slots
//   into their phase's run. For j >= s that start is not on an 8-row
//   boundary of the 128-byte swizzle pattern, so the slab is kept WITHOUT
//   swizzle: core matrices of 8 rows x 16 bytes, each 8-channel chunk of
//   the slab a column of 16-byte rows (chunk c of slot r at c (rows_a 16)
//   + 16 r), which a descriptor reads from any row (`cpc::desc_plain`); a
//   swizzled descriptor on the same slab read no faster.
// - ROADMAP C4: the tensor core's fp32 adder truncates, so the products of
//   at most kFlushSteps k16 steps (whole slabs) are summed from zero in
//   their own 64 registers and join the running sum by an ordinary add.
// Budgets of the 128 x 128 tile (tpu_fast, per the source's constants):
//   (a) weight bytes from L2 per FLOP: 1 / 128 (a 16 KB tile per 2.1 MFLOP;
//       4.7 TB/s of L2 at 600 TFLOP/s) for layer 2; layers 3..L stream A as
//       well: 1 / 64 (9.4 TB/s at 600). No TMA multicast (a cluster along
//       M) yet: it would halve the weights' share.
//   (b) registers: a consumer thread holds 64 running sums and 64 sums of
//       the current slabs (2 x 64 x 128 fp32 a warpgroup), of its 200;
//       ptxas's counts are in build/kernels/*.log.
//   (c) layer-1 regeneration: C_out / 128 = 4 blocks make each layer-1
//       row, 17.7 GFLOP of 16-padded mma.sync on the generator warps at
//       tpu_fast (4.4 made once).
// Shared memory: fused 1 KB + stages x 16 KB + 2 x rows_a x 128 + 16 + the
// window + layer 1's weights and bias (226 KB at tpu_fast, 5 stages);
// layers 3..L 1 KB + stages x 32 KB (193 KB, 6 stages). One block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
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

// One launch: the product of a layer, with layer 1 in front of it when
// fused.
struct Geo {
  int B;
  int T_in, Cin;  // rows and channels the product reads (layer 1's output
                  // when fused)
  int T_out, Cout, k, s, pad;
  int S, k1, s1, pad1;  // fused: the waveform's length, and layer 1
};

// ---------------------------------------------------------------------
// SIMT fp32 products. Grid (ceil(Cout / 64), ceil(T_out / 64), B); block
// kTileThreads; dynamic shared memory: the block's waveform window as fp32
// when fused.
//
// in: the previous layer's output (B, T_in, Cin), or the waveform (B, S)
// when fused; w (Cout, k, Cin); w1 (Cin, k1) and b1 (Cin,): layer 1.

template <typename T, bool kFused>
__global__ void __launch_bounds__(kTileThreads)
    pyramid_simt_kernel(const T* __restrict__ in, const T* __restrict__ w1,
                        const T* __restrict__ b1, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out,
                        Geo g) {
  extern __shared__ float x_window[];
  __shared__ TileSmem sm;
  const int n0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  const size_t b = blockIdx.z;
  const int r0 = g.s * t0 - g.pad;  // the tile's first input row
  if (kFused) {
    const int nx = ((kTile - 1) * g.s + g.k - 1) * g.s1 + g.k1;
    const long long x0 = static_cast<long long>(g.s1) * r0 - g.pad1;
    const T* xb = in + b * g.S;
    for (int i = threadIdx.x; i < nx; i += kTileThreads) {
      const long long gi = x0 + i;
      x_window[i] = (gi >= 0 && gi < g.S) ? to_f32(xb[gi]) : 0.f;
    }
    __syncthreads();
  }
  const int depth = g.k * g.Cin;
  const T* inb = kFused ? in : in + b * g.T_in * g.Cin;
  float acc[4][4] = {};
  // A[m][r], r = tap * Cin + channel: input row s (t0 + m) + tap - pad
  auto a = [&](int r, int m) -> float {
    const int j = r / g.Cin, c = r - j * g.Cin;
    const int l = g.s * m + j;
    const int ti = r0 + l;
    if (ti < 0 || ti >= g.T_in) return 0.f;
    if (kFused) {
      const float* xw = x_window + g.s1 * l;
      const T* wc = w1 + static_cast<size_t>(c) * g.k1;
      float sum = 0.f;
      for (int i = 0; i < g.k1; ++i) sum = fmaf(xw[i], to_f32(wc[i]), sum);
      return round_to<T>(fmaxf(sum + to_f32(b1[c]), 0.f));
    }
    return to_f32(inb[static_cast<size_t>(ti) * g.Cin + c]);
  };
  auto bw = [&](int r, int n) -> float {
    return n0 + n < g.Cout
               ? to_f32(w[static_cast<size_t>(n0 + n) * depth + r])
               : 0.f;
  };
  tile_mm<true, true>(depth, a, bw, acc, sm);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= g.T_out) continue;
    T* row = out + (b * g.T_out + t) * g.Cout;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = n0 + tx * 4 + jn;
      if (n < g.Cout) {
        row[n] = from_f32<T>(fmaxf(acc[i][jn] + to_f32(bias[n]), 0.f));
      }
    }
  }
}

// ---------------------------------------------------------------------
// The "wgmma" route (see the note at the top).

constexpr int kWBM = 128;       // output rows a block, 64 a warpgroup
constexpr int kWBN = 128;       // output channels a block
constexpr int kSlab = 64;       // input channels a slab: 128 bytes of bf16
constexpr int kRowBytes = 128;  // a row of a slab
constexpr int kWThreads = 384;  // 2 consumer warpgroups and a producer one
constexpr int kConsumerWarps = 8;
constexpr int kGenWarps = 3;  // producer warps 1..3: layer 1 (fused)
// Registers a thread once the block has split: 2 x 200 + 104 = 504 = 3 x
// 168, what the launch gave each of the 384 threads (ptxas's count): an
// increase waits until decreases have freed its registers, so a split
// beyond the launch's registers would never return.
constexpr int kProducerRegs = 104, kConsumerRegs = 200;
constexpr int kMinStages = 2, kMaxStages = 8;
constexpr int kMaxPhases = 8;   // strides of layers 3..L
constexpr int kMaxTaps = 32;    // kernel widths of layers 2..L
constexpr int kFlushSteps = 32;  // k16 steps summed before an ordinary add

// The TMA maps of one launch: each phase of the input (layers 3..L), and
// the packed weights.
struct alignas(64) Maps {
  CUtensorMap a[kMaxPhases];
  CUtensorMap w;
};

// The plan's tap table: tap j's phase and row offset. Layers 3..L: the
// phase's map and the row coordinate t0 + row[j] (floor((j - pad) / s), or
// far out of range for a phase with no rows); layers 1 + 2: the slab slot
// phase[j] RP + row[j] (phase j mod s, row j / s).
struct Taps {
  int phase[kMaxTaps];
  int row[kMaxTaps];
};

__host__ __device__ inline int rows_per_phase(const Geo& g) {
  return kWBM + (g.k - 1) / g.s;
}

// Layer-1 rows of a fused block's slab, and the waveform samples behind
// them.
__host__ __device__ inline int slab_rows(const Geo& g) {
  return g.s * rows_per_phase(g);
}

__host__ __device__ inline int window_samples(const Geo& g) {
  return (slab_rows(g) - 1) * g.s1 + g.k1;
}

// Bytes of a fused block's waveform window, and of layer 1's weights
// (Cin x k1) and bias (Cin), each rounded up to 16.
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t layer1_bytes(const Geo& g) {
  return round16(static_cast<size_t>(window_samples(g)) * 2) +
         round16(static_cast<size_t>(g.Cin) * g.k1 * 2) +
         round16(static_cast<size_t>(g.Cin) * 2);
}

__host__ __device__ inline size_t slot_bytes(bool fused) {
  return static_cast<size_t>(fused ? kWBN : kWBM + kWBN) * kRowBytes;
}

size_t wgmma_smem_bytes(const Geo& g, bool fused, int stages) {
  size_t bytes = 1024 + stages * slot_bytes(fused);
  if (fused) {
    bytes += 2 * static_cast<size_t>(slab_rows(g)) * kRowBytes + 16 +
             layer1_bytes(g);
  }
  return bytes;
}

// A consumer warp is done with a slot (its wgmma reading it have
// completed).
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) cpc::mbar_arrive(bar);
  __syncwarp();
}

// relu(lo), relu(hi) rounded to bf16 in one instruction, lo in the low
// half: the same bits as rounding first and taking the ReLU after.
__device__ __forceinline__ unsigned relu_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ unsigned pack_bits(unsigned short lo,
                                              unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// Generator warp `gw` (of kGenWarps) fills its row groups of the slab of
// layer-1 channels [c0, c0 + 64) at `as` (layer-1 rows r0 + l, l <
// slab_rows, at their slots; chunk-major without swizzle) from the window xs
// of the waveform (xs[i] is sample s1 r0 - pad1 + i, zero outside the
// snippet) and layer 1's weights w1b (Cin, k1) and bias b1b, all in shared
// memory as bf16 bits. A group is 16 rows x 64 channels: 8 mma.sync
// products, the bias, one rounding to bf16 with the ReLU (one cvt a pair),
// and 4 stmatrix stores of two 8-channel chunks each; rows past the slab go
// to the 16 bytes at `trash`. No synchronisation inside.
__device__ __forceinline__ void make_layer1_slab(
    unsigned char* as, unsigned char* trash, const unsigned short* xs,
    const unsigned short* w1b, const unsigned short* b1b, int c0, int r0,
    int gw, const Geo& g) {
  const int lane = threadIdx.x % 32, gq = lane / 4, q = lane % 4;
  const int RP = rows_per_phase(g), rows_a = slab_rows(g);
  constexpr int kTiles = kSlab / 8;  // 8-channel tiles = chunks of the slab
  unsigned bw[kTiles][2];
  float bias0[kTiles], bias1[kTiles];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int c = c0 + nt * 8 + gq;  // B[tap][c]: taps 2q, 2q+1, +8
    unsigned short v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tap = 2 * q + (e & 1) + (e / 2) * 8;
      v[e] = (c < g.Cin && tap < g.k1)
                 ? w1b[static_cast<size_t>(c) * g.k1 + tap]
                 : static_cast<unsigned short>(0);
    }
    bw[nt][0] = pack_bits(v[0], v[1]);
    bw[nt][1] = pack_bits(v[2], v[3]);
    const int cb = c0 + nt * 8 + 2 * q;  // D's columns 2q, 2q+1
    bias0[nt] = cb < g.Cin ? __uint_as_float(b1b[cb] << 16) : 0.f;
    bias1[nt] = cb + 1 < g.Cin ? __uint_as_float(b1b[cb + 1] << 16) : 0.f;
  }
  // a block at the snippet's edge holds rows outside [0, T_1): layer 2's
  // padding, zero after bias and ReLU
  const bool edge = r0 < 0 || r0 + rows_a > g.T_in;
  const unsigned chunk = static_cast<unsigned>(rows_a) * 16;
  const unsigned as_a = cpc::smem_addr(as), trash_a = cpc::smem_addr(trash);
  const int groups = (rows_a + 15) / 16;
  for (int grp = gw; grp < groups; grp += kGenWarps) {
    const int l[2] = {grp * 16 + gq, grp * 16 + gq + 8};
    // A[row][tap] = frame of the row: xs[s1 row + tap]
    unsigned a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = l[e & 1], tap = 2 * q + (e / 2) * 8;
      const unsigned short* f = xs + g.s1 * row + tap;
      const bool in = row < rows_a;
      a[e] = pack_bits(in && tap < g.k1 ? f[0] : static_cast<unsigned short>(0),
                       in && tap + 1 < g.k1 ? f[1]
                                            : static_cast<unsigned short>(0));
    }
    bool live[2] = {true, true};
    if (edge) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        live[h] = r0 + l[h] >= 0 && r0 + l[h] < g.T_in;
      }
    }
    // this lane's stmatrix row: matrix lane / 8 is (chunk lane / 16, rows
    // 8 ((lane / 8) % 2)..) of the group
    const int ls = grp * 16 + lane % 16;
    const unsigned dst =
        ls < rows_a ? as_a + ((ls % g.s) * RP + ls / g.s) * 16 +
                          (lane / 16) * chunk
                    : trash_a;
#pragma unroll
    for (int np = 0; np < kTiles / 2; ++np) {
      unsigned r[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * np + half;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        cpc::mma_bf16(d, a, bw[nt][0], bw[nt][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned v =
              relu_bf16x2(d[2 * h] + bias0[nt], d[2 * h + 1] + bias1[nt]);
          r[2 * half + h] = live[h] ? v : 0u;
        }
      }
      cpc::stmatrix_x4(dst == trash_a ? dst : dst + 2 * np * chunk, r);
    }
  }
}

// Grid (ceil(Cout / 128), ceil(T_out / 128), B); block kWThreads; dynamic
// shared memory wgmma_smem_bytes(g, kFused, stages).
// in: the previous layer's output (B, T_in, Cin) through maps.a, or the
// waveform x (B, S) when fused; the weights (Cout, k, Cin) through maps.w;
// w1 (Cin, k1) and b1 (Cin,): layer 1 (fused).
template <bool kFused>
__global__ void __launch_bounds__(kWThreads, 1)
    pyramid_wgmma_kernel(const bf16_t* __restrict__ x,
                         const bf16_t* __restrict__ w1,
                         const bf16_t* __restrict__ b1,
                         const bf16_t* __restrict__ bias,
                         bf16_t* __restrict__ out, Geo g, int stages,
                         const __grid_constant__ Taps taps,
                         const __grid_constant__ Maps maps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ uint64_t a_full[2], a_empty[2];
  unsigned char* ring = cpc::align_1024(smem_raw);
  const int slot = static_cast<int>(slot_bytes(kFused));
  const int w_off = kFused ? 0 : kWBM * kRowBytes;  // B's tile in a slot
  const int rows_a = slab_rows(g);
  unsigned char* abuf = ring + stages * slot;  // fused: [2][rows_a x 128]
  // fused: 16 bytes for the generator's rows past a slab, the window, then
  // layer 1's w1 and b1
  unsigned char* trash = abuf + 2 * rows_a * kRowBytes;
  unsigned short* xs = reinterpret_cast<unsigned short*>(trash + 16);
  unsigned short* w1s = xs + round16(window_samples(g) * 2) / 2;
  unsigned short* b1s = w1s + round16(static_cast<size_t>(g.Cin) * g.k1 * 2) / 2;
  const int n0 = blockIdx.x * kWBN, t0 = blockIdx.y * kWBM;
  const int b = blockIdx.z;
  const int r0 = g.s * t0 - g.pad;  // the tile's first input row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slabs = (g.Cin + kSlab - 1) / kSlab;

  if (kFused) {
    const int nx = window_samples(g);
    const long long x0 = static_cast<long long>(g.s1) * r0 - g.pad1;
    const unsigned short* xb =
        reinterpret_cast<const unsigned short*>(x) +
        static_cast<size_t>(b) * g.S;
    for (int i = tid; i < nx; i += kWThreads) {
      const long long gi = x0 + i;
      xs[i] = (gi >= 0 && gi < g.S) ? xb[gi] : static_cast<unsigned short>(0);
    }
    const unsigned short* w1g = reinterpret_cast<const unsigned short*>(w1);
    for (int i = tid; i < g.Cin * g.k1; i += kWThreads) w1s[i] = w1g[i];
    const unsigned short* b1g = reinterpret_cast<const unsigned short*>(b1);
    for (int i = tid; i < g.Cin; i += kWThreads) b1s[i] = b1g[i];
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      cpc::mbar_init(&full[s], 1);
      cpc::mbar_init(&empty[s], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      cpc::mbar_init(&a_full[i], kGenWarps);
      cpc::mbar_init(&a_empty[i], kConsumerWarps);
    }
    cpc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    cpc::setmaxnreg_dec<kProducerRegs>();
    const int pw = warp - kConsumerWarps;
    if (pw == 0) {  // TMA: job q = slab k + tap, into slot q % stages
      const int jobs = slabs * g.k;
      for (int q = 0; q < jobs; ++q) {
        const int s = q % stages;
        if (q >= stages) cpc::mbar_wait(&empty[s], ((q / stages) - 1) & 1);
        if (lane == 0) {
          const int c0 = (q / g.k) * kSlab, j = q % g.k;
          unsigned char* dst = ring + s * slot;
          cpc::mbar_arrive_tx(&full[s], slot);
          if (!kFused) {
            cpc::tma_load_3d(dst, &maps.a[taps.phase[j]], c0,
                             t0 + taps.row[j], b, &full[s]);
          }
          cpc::tma_load_3d(dst + w_off, &maps.w, c0, j, n0, &full[s]);
        }
        __syncwarp();
      }
    } else if (kFused) {  // layer 1, one slab buffer ahead of the products
      for (int sl = 0; sl < slabs; ++sl) {
        const int buf = sl & 1;
        if (sl >= 2) cpc::mbar_wait(&a_empty[buf], ((sl >> 1) - 1) & 1);
        make_layer1_slab(abuf + buf * rows_a * kRowBytes, trash, xs, w1s,
                         b1s, sl * kSlab, r0, pw - 1, g);
        cpc::fence_async_smem();  // the stores, visible to wgmma
        release(&a_full[buf]);
      }
    }
  } else {
    // a consumer: warpgroup wg owns output rows t0 + 64 wg ..
    cpc::setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4, lw = warp % 4;
    const int RP = rows_per_phase(g);
    const unsigned ring_a = cpc::smem_addr(ring);
    const unsigned abuf_a = cpc::smem_addr(abuf);
    const unsigned chunk = static_cast<unsigned>(rows_a) * 16;
    const int slab_steps = g.k * (kSlab / 16);
    const int flush_every =
        slab_steps >= kFlushSteps ? 1 : kFlushSteps / slab_steps;  // slabs
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    int q = 0;
    for (int sl = 0; sl < slabs; ++sl) {
      const int buf = sl & 1;
      if (kFused) cpc::mbar_wait(&a_full[buf], (sl >> 1) & 1);
      const bool fresh = sl % flush_every == 0;  // part starts from zero
      for (int j = 0; j < g.k; ++j, ++q) {
        const int s = q % stages;
        cpc::mbar_wait(&full[s], (q / stages) & 1);
        const unsigned sa = ring_a + s * slot;
        const unsigned a_rows =
            abuf_a + buf * rows_a * kRowBytes +
            (taps.phase[j] * RP + taps.row[j] + wg * 64) * 16;
        cpc::fence_regs(part);
        cpc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk) {
          const uint64_t da =
              kFused ? cpc::desc_plain(a_rows + 2 * kk * chunk, chunk)
                     : cpc::desc_sw128(sa + wg * 64 * kRowBytes + kk * 32);
          cpc::wgmma_m64n128_ss(part, da,
                                cpc::desc_sw128(sa + w_off + kk * 32),
                                !fresh || j > 0 || kk > 0);
        }
        cpc::wgmma_commit();
        if (j > 0) {
          cpc::wgmma_wait<1>();
          release(&empty[(q - 1) % stages]);
        }
      }
      cpc::wgmma_wait<0>();
      cpc::fence_regs(part);
      release(&empty[(q - 1) % stages]);
      if (kFused) release(&a_empty[buf]);
      if ((sl + 1) % flush_every == 0 || sl + 1 == slabs) {
        // an ordinary add; the next slabs' products are summed from zero
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    }

    // bias, ReLU, one rounding; thread rows lane/4 + 8h of its warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wg * 64 + lw * 16 + lane / 4 + 8 * h;
      if (t >= g.T_out) continue;
      bf16_t* row = out + (static_cast<size_t>(b) * g.T_out + t) * g.Cout;
#pragma unroll
      for (int jn = 0; jn < kWBN / 8; ++jn) {
        const int n = n0 + jn * 8 + (lane % 4) * 2;
        if (n >= g.Cout) continue;  // Cout % 8 == 0: the pair is inside
        *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(
            fmaxf(acc[jn * 4 + h * 2] + __bfloat162float(bias[n]), 0.f),
            fmaxf(acc[jn * 4 + h * 2 + 1] + __bfloat162float(bias[n + 1]),
                  0.f));
      }
    }
  }
}

// ---------------------------------------------------------------------
// Host side.

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kRouteSimt = 0, kRouteWgmma = 1;  // pyramid_route's names
constexpr int kEmptyRow = -(1 << 30);  // the row offset of an empty phase
// The plan, as the wrapper packs it: route, grid x, y, z, tile rows,
// channels, stages, dynamic shared memory bytes, taps n, then n pairs
// (phase, row offset).
constexpr int kPlanHead = 9;

bool geo_ok(const Geo& g, bool fused) {
  if (g.B < 1 || g.B > 65535 || g.T_in < 1 || g.Cin < 1 || g.T_out < 1 ||
      g.Cout < 1 || g.k < 1 || g.s < 1 || g.pad < 0 ||
      tiles(g.T_out, kTile) > 65535) {
    return false;
  }
  // the SIMT kernels index a row's contraction and a window with ints
  if (static_cast<long long>(g.k) * g.Cin > 2147483647LL) return false;
  if (fused && (g.S < 1 || g.k1 < 1 || g.s1 < 1 || g.pad1 < 0)) return false;
  return true;
}

size_t simt_smem_bytes(const Geo& g, bool fused) {
  if (!fused) return 0;
  return (static_cast<size_t>((kTile - 1) * g.s + g.k - 1) * g.s1 + g.k1) *
         sizeof(float);
}

// Whether `plan` (length n) is the one this launcher runs for g: the grid,
// tile and shared memory it would compute, and for "wgmma" the tap table.
bool plan_ok(const int* plan, int n, const Geo& g, bool fused, int route) {
  if (plan == nullptr || n < kPlanHead || plan[0] != route) return false;
  const bool w = route == kRouteWgmma;
  const int tm = w ? kWBM : kTile, tn = w ? kWBN : kTile;
  if (plan[1] != tiles(g.Cout, tn) || plan[2] != tiles(g.T_out, tm) ||
      plan[3] != g.B || plan[4] != tm || plan[5] != tn) {
    return false;
  }
  const int stages = plan[6];
  if (!w) {
    return stages == 0 && plan[7] == static_cast<int>(simt_smem_bytes(g, fused)) &&
           plan[8] == 0 && n == kPlanHead &&
           simt_smem_bytes(g, fused) + sizeof(TileSmem) <= kMaxSmem;
  }
  if (stages < kMinStages || stages > kMaxStages ||
      wgmma_smem_bytes(g, fused, stages) > kMaxSmem ||
      plan[7] != static_cast<int>(wgmma_smem_bytes(g, fused, stages)) ||
      plan[8] != g.k || g.k > kMaxTaps || n != kPlanHead + 2 * g.k) {
    return false;
  }
  for (int j = 0; j < g.k; ++j) {
    int phase, row;
    if (fused) {
      phase = j % g.s;
      row = j / g.s;
    } else {
      const int jp = j - g.pad;
      phase = ((jp % g.s) + g.s) % g.s;
      row = phase < g.T_in ? (jp - phase) / g.s : kEmptyRow;
    }
    if (plan[kPlanHead + 2 * j] != phase || plan[kPlanHead + 2 * j + 1] != row) {
      return false;
    }
  }
  return true;
}

// Whether the wgmma kernels take these operands (16-byte TMA strides and
// addresses, 64-row phase maps, layer 1 in one k16 step).
bool wgmma_ok(const Geo& g, bool fused, const void* in, const void* w) {
  return g.Cin % 8 == 0 && g.Cout % 8 == 0 && aligned16(w) &&
         (fused ? g.k1 <= 16 : (g.s <= kMaxPhases && aligned16(in)));
}

// A bf16 tensor of up to three dims (innermost first; strides of dims 1, 2
// in elements), read in boxes, 128-byte swizzled, zero outside.
int map_3d(cpc::EncodeTiled encode, CUtensorMap* map, const void* base,
           const long long (&dims)[3], const long long (&strides)[2],
           const int (&box)[3]) {
  const cuuint64_t d[3] = {static_cast<cuuint64_t>(dims[0]),
                           static_cast<cuuint64_t>(dims[1]),
                           static_cast<cuuint64_t>(dims[2])};
  const cuuint64_t st[2] = {static_cast<cuuint64_t>(strides[0]) * 2,
                            static_cast<cuuint64_t>(strides[1]) * 2};
  const cuuint32_t bx[3] = {static_cast<cuuint32_t>(box[0]),
                            static_cast<cuuint32_t>(box[1]),
                            static_cast<cuuint32_t>(box[2])};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), d,
      st, bx, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool kFused>
int launch_wgmma(const void* in, const void* w1, const void* b1,
                 const void* w, const void* bias, void* out, const Geo& g,
                 const int* plan, cudaStream_t s) {
  cpc::EncodeTiled encode = nullptr;
  int err = cpc::tensor_map_encoder(&encode);
  if (err) return err;
  Maps maps;
  err = map_3d(encode, &maps.w, w, {g.Cin, g.k, g.Cout},
               {g.Cin, static_cast<long long>(g.k) * g.Cin}, {kSlab, 1, kWBN});
  if (err) return err;
  if (!kFused) {
    const bf16_t* base = static_cast<const bf16_t*>(in);
    for (int p = 0; p < g.s; ++p) {
      const int pe = p < g.T_in ? p : 0;  // an empty phase: any valid map
      err = map_3d(encode, &maps.a[p], base + static_cast<size_t>(pe) * g.Cin,
                   {g.Cin, (g.T_in - pe + g.s - 1) / g.s, g.B},
                   {static_cast<long long>(g.s) * g.Cin,
                    static_cast<long long>(g.T_in) * g.Cin},
                   {kSlab, kWBM, 1});
      if (err) return err;
    }
  }
  Taps taps{};
  for (int j = 0; j < g.k; ++j) {
    taps.phase[j] = plan[kPlanHead + 2 * j];
    taps.row[j] = plan[kPlanHead + 2 * j + 1];
  }
  const int stages = plan[6], smem = plan[7];
  auto kernel = pyramid_wgmma_kernel<kFused>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  kernel<<<dim3(plan[1], plan[2], plan[3]), kWThreads, smem, s>>>(
      static_cast<const bf16_t*>(in), static_cast<const bf16_t*>(w1),
      static_cast<const bf16_t*>(b1), static_cast<const bf16_t*>(bias),
      static_cast<bf16_t*>(out), g, stages, taps, maps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFused>
int launch_simt(const void* in, const void* w1, const void* b1, const void* w,
                const void* bias, void* out, const Geo& g, cudaStream_t s) {
  const size_t smem = simt_smem_bytes(g, kFused);
  auto kernel = pyramid_simt_kernel<T, kFused>;
  if (smem + sizeof(TileSmem) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(tiles(g.Cout, kTile), tiles(g.T_out, kTile), g.B),
           kTileThreads, smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFused>
int launch(const void* in, const void* w1, const void* b1, const void* w,
           const void* bias, void* out, const Geo& g, int bf16,
           const int* plan, int plan_len, int device, void* stream) {
  if (!geo_ok(g, kFused) || plan == nullptr || plan_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int route = plan[0];
  const bool wgmma = route == kRouteWgmma;
  if ((route != kRouteSimt && !wgmma) ||
      !plan_ok(plan, plan_len, g, kFused, route) ||
      (wgmma && !(bf16 && wgmma_ok(g, kFused, in, w)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) return launch_wgmma<kFused>(in, w1, b1, w, bias, out, g, plan, s);
  return bf16 ? launch_simt<bf16_t, kFused>(in, w1, b1, w, bias, out, g, s)
              : launch_simt<float, kFused>(in, w1, b1, w, bias, out, g, s);
}

}  // namespace

extern "C" {

// One layer, launched on `stream` of `device`; returns cudaGetLastError()
// (0 on success). in (B, T_in, Cin), w (Cout, k, Cin), bias (Cout,), out
// (B, T_out, Cout), all contiguous and bf16 (bf16 != 0) or fp32; `pad` is
// the left SAME padding. out = relu(conv(in) + bias). plan (plan_len ints):
// the launch `pyramid_route` planned (route, grid, tile, stages, shared
// memory, taps); a plan this launcher would not make, or a "wgmma" plan for
// operands the kernels do not take, is cudaErrorInvalidValue. Does not
// synchronise.
int conv_pyramid_layer(const void* in, const void* w, const void* bias,
                       void* out, int B, int T_in, int Cin, int T_out,
                       int Cout, int k, int s, int pad, int bf16,
                       const int* plan, int plan_len, int device,
                       void* stream) {
  const Geo g{B, T_in, Cin, T_out, Cout, k, s, pad, 0, 0, 0, 0};
  return launch<false>(in, nullptr, nullptr, w, bias, out, g, bf16, plan,
                       plan_len, device, stream);
}

// Layers 1 and 2 in one launch. x (B, S); w1 (C1, k1) and b1 (C1,): layer 1,
// whose output (B, T1, C1) is never stored; w2 (C2, k2, C1), b2 (C2,); out
// (B, T2, C2). Otherwise as conv_pyramid_layer.
int conv_pyramid_fused(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int B, int S,
                       int k1, int s1, int pad1, int T1, int C1, int k2,
                       int s2, int pad2, int T2, int C2, int bf16,
                       const int* plan, int plan_len, int device,
                       void* stream) {
  const Geo g{B, T1, C1, T2, C2, k2, s2, pad2, S, k1, s1, pad1};
  return launch<true>(x, w1, b1, w2, b2, out, g, bf16, plan, plan_len,
                      device, stream);
}

}  // extern "C"
