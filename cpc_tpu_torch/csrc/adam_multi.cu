// The optimizer's update over every leaf at once, for Hopper (sm_90a),
// bound to Python with ctypes (cpc_tpu_torch/ops/adam_cuda.py; built by
// cpc_tpu_torch/ops/_build.py).
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's chain,
// which XLA fuses on its own. The port ran it as tensor code, leaf by leaf
// (ops/adam_cuda.py::adam_multi_reference): some 17 launches a leaf without
// the clip and 24 with it, 256 at tpu_fast's 15 leaves and 1 154 at
// transformer_fast's 48, each costing the host far more than the card.
//
// WHAT IS COMPUTED. optax's clip_by_global_norm -> Adam or AdamW -> -lr:
//   adam_multi_sumsq_kernel   per block, the sum of g^2 over one chunk of
//                             one leaf, into partials[block];
//   adam_multi_norm_kernel    one block: norm = sqrt(sum of the partials);
//   adam_multi_update_kernel  per element, in place on p, mu and nu:
//     g  = norm < clip ? g : (g / norm) * clip     (when the clip is on)
//     mu = mu * b1 + (1 - b1) * g
//     nu = nu * b2 + (1 - b2) * (g * g)
//     u  = (mu / bc1) / (sqrt(nu / bc2) + eps)
//     u  = u + wd * p                              (AdamW)
//     p  = p - lr * u
// lr, bc1 = 1 - b1^count and bc2 = 1 - b2^count are read from the device row
// of Optimizer.scalars, the norm from a device scalar (this pair's, or one
// the caller computed, as parallel/tp.py does over shards), so the host
// reads nothing back and a CUDA graph can hold the launches. Every
// operation is the tensor code's, in its order, each rounded once by an
// explicit __f*_rn intrinsic so that nvcc contracts nothing into an FMA;
// each scalar is passed as PyTorch rounds it (the fp32 of the Python float,
// 1 - b1 and 1 - b2 taken in double first). Given the same norm, the
// update equals the tensor code bit for bit. The norm sums in a fixed order
// (each block's threads, then its warps, then the partials by index), with
// no atomics: two runs give the same bits, and it is within float rounding
// of the tensor code's sum of per-leaf sums.
//
// WHAT BOUNDS IT. Bytes: the update reads p, g, mu and nu and writes p, mu
// and nu, 28 bytes a parameter, and the sum reads g, 4 bytes: at about 8.5
// M parameters (transformer_fast) 0.071 + 0.010 ms at 3.35 TB/s. Far under
// the ridge point; the tensor code's cost was its launches and its 13
// passes over memory a leaf.
//
// DESIGN. The leaves travel by value in the kernel's parameters (Leaves:
// the four pointers, the element count and the first block of each leaf,
// at most kMaxLeaves a launch within CUDA's 4 KB of parameters); a caller
// with more leaves makes more launches (adam_cuda.py::plan_launches, which
// also numbers the partials). Block b of a launch takes chunk
// b - block_start[leaf] of the leaf whose blocks hold b: kChunk elements,
// 4 float4 a thread, all loads issued before the arithmetic. A leaf whose
// four pointers are 16-byte aligned is read and written in 16-byte
// vectors, its last n % 4 elements one by one; any other leaf (a view of a
// data-parallel flat buffer at an odd offset) one element at a time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // float4 a thread a chunk
constexpr int kChunk = 4096;     // elements a block: adam_cuda.py::CHUNK
constexpr int kMaxLeaves = 87;   // adam_cuda.py::MAX_LEAVES
constexpr int kNormThreads = 1024;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];  // [n_leaves]: the launch's blocks
  int n_leaves;
};

// The hyperparameters, each as PyTorch rounds it (see the note above).
struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, clip, wd;
  int clip_on, wd_on;
};

static_assert(sizeof(Leaves) + sizeof(Hyper) + 2 * sizeof(void*) <= 4096,
              "the update kernel's parameters exceed CUDA's 4 KB");
static_assert(kChunk == kThreads * kVec * 4, "a chunk is whole float4s");

// The leaf whose blocks hold block b: the last with block_start <= b (an
// empty leaf has no blocks; the planner leaves those out).
__device__ __forceinline__ int leaf_of(const Leaves& t, int b) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.block_start[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's sum of v, in a fixed order: lanes by xor, then warps by
// index. Every thread of the block must call it; thread 0 gets the sum.
template <int kBlock>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_sumsq_kernel(const Leaves t, float* __restrict__ partials,
                            int block_base) {
  const int leaf = leaf_of(t, blockIdx.x);
  const long long lo =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kChunk;
  const long long hi = min(lo + kChunk, t.n[leaf]);
  const float* __restrict__ g = t.g[leaf] + lo;
  const int len = static_cast<int>(hi - lo);
  const int nv = aligned16(t.g[leaf]) ? len / 4 : 0;
  float acc = 0.f;
  float4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < nv ? reinterpret_cast<const float4*>(g)[i]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    acc = __fmaf_rn(v[j].x, v[j].x, acc);
    acc = __fmaf_rn(v[j].y, v[j].y, acc);
    acc = __fmaf_rn(v[j].z, v[j].z, acc);
    acc = __fmaf_rn(v[j].w, v[j].w, acc);
  }
  for (int i = 4 * nv + threadIdx.x; i < len; i += kThreads) {
    acc = __fmaf_rn(g[i], g[i], acc);
  }
  const float total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[block_base + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kNormThreads)
    adam_multi_norm_kernel(const float* __restrict__ partials, int blocks,
                           float* __restrict__ norm) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kNormThreads) {
    acc = __fadd_rn(acc, partials[i]);
  }
  const float total = block_sum<kNormThreads>(acc);
  if (threadIdx.x == 0) *norm = __fsqrt_rn(total);
}

// One step's scalars, as every thread of a block holds them.
struct Step {
  float lr, bc1, bc2, norm;
  bool clipped;
};

__device__ __forceinline__ float adam_element(float p, float g, float& mu,
                                              float& nu, const Hyper& h,
                                              const Step& s) {
  if (s.clipped) g = __fmul_rn(__fdiv_rn(g, s.norm), h.clip);
  mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(g, h.one_minus_b1));
  nu = __fadd_rn(__fmul_rn(nu, h.b2),
                 __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  float u = __fdiv_rn(__fdiv_rn(mu, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.bc2)), h.eps));
  if (h.wd_on) u = __fadd_rn(u, __fmul_rn(p, h.wd));
  return __fsub_rn(p, __fmul_rn(s.lr, u));
}

__device__ __forceinline__ void adam_vec(float4& p, const float4& g,
                                         float4& mu, float4& nu,
                                         const Hyper& h, const Step& s) {
  p.x = adam_element(p.x, g.x, mu.x, nu.x, h, s);
  p.y = adam_element(p.y, g.y, mu.y, nu.y, h, s);
  p.z = adam_element(p.z, g.z, mu.z, nu.z, h, s);
  p.w = adam_element(p.w, g.w, mu.w, nu.w, h, s);
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_update_kernel(const Leaves t, const Hyper h,
                             const float* __restrict__ norm,
                             const float* __restrict__ scalars) {
  const int leaf = leaf_of(t, blockIdx.x);
  const long long lo =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kChunk;
  const long long hi = min(lo + kChunk, t.n[leaf]);
  float* __restrict__ p = t.p[leaf] + lo;
  const float* __restrict__ g = t.g[leaf] + lo;
  float* __restrict__ mu = t.mu[leaf] + lo;
  float* __restrict__ nu = t.nu[leaf] + lo;
  Step s;
  s.lr = scalars[0];
  s.bc1 = scalars[1];
  s.bc2 = scalars[2];
  s.norm = h.clip_on ? *norm : 1.f;
  // torch.where(norm < clip, g, ...): a NaN norm takes the scaled branch
  s.clipped = h.clip_on && !(s.norm < h.clip);
  const int len = static_cast<int>(hi - lo);
  const bool vec = aligned16(t.p[leaf]) && aligned16(t.g[leaf]) &&
                   aligned16(t.mu[leaf]) && aligned16(t.nu[leaf]);
  const int nv = vec ? len / 4 : 0;
  float4 pv[kVec], gv[kVec], mv[kVec], vv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < nv) {
      pv[j] = reinterpret_cast<const float4*>(p)[i];
      gv[j] = reinterpret_cast<const float4*>(g)[i];
      mv[j] = reinterpret_cast<const float4*>(mu)[i];
      vv[j] = reinterpret_cast<const float4*>(nu)[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < nv) {
      adam_vec(pv[j], gv[j], mv[j], vv[j], h, s);
      reinterpret_cast<float4*>(p)[i] = pv[j];
      reinterpret_cast<float4*>(mu)[i] = mv[j];
      reinterpret_cast<float4*>(nu)[i] = vv[j];
    }
  }
  for (int i = 4 * nv + threadIdx.x; i < len; i += kThreads) {
    float m = mu[i], v = nu[i];
    p[i] = adam_element(p[i], g[i], m, v, h, s);
    mu[i] = m;
    nu[i] = v;
  }
}

// The launch's leaf table from the caller's arrays: pointers as 64-bit
// ints, element counts, and count + 1 block starts.
int fill_leaves(Leaves& t, const long long* g, const long long* p,
                const long long* mu, const long long* nu, const long long* n,
                const int* block_start, int count) {
  if (count < 1 || count > kMaxLeaves || block_start[0] != 0) return 0;
  t.n_leaves = count;
  for (int i = 0; i < count; ++i) {
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.p[i] = p ? reinterpret_cast<float*>(p[i]) : nullptr;
    t.mu[i] = mu ? reinterpret_cast<float*>(mu[i]) : nullptr;
    t.nu[i] = nu ? reinterpret_cast<float*>(nu[i]) : nullptr;
    t.n[i] = n[i];
    t.block_start[i] = block_start[i];
    // a leaf's blocks must cover its chunks, no more and no fewer
    const long long chunks = (n[i] + kChunk - 1) / kChunk;
    if (n[i] < 1 || block_start[i + 1] - block_start[i] != chunks) return 0;
  }
  t.block_start[count] = block_start[count];
  return block_start[count];
}

}  // namespace

extern "C" {

// partials[block_base + b] = the sum of squares of block b's chunk, for the
// `count` leaves of one launch: g and n (element counts) `count` long,
// block_start count + 1 long. Returns the launch's error (0 on success).
// Does not synchronise.
int adam_multi_sumsq(const long long* g, const long long* n,
                     const int* block_start, int count, int block_base,
                     void* partials, int device, void* stream) {
  Leaves t;
  const int blocks =
      fill_leaves(t, g, nullptr, nullptr, nullptr, n, block_start, count);
  if (blocks < 1 || block_base < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_multi_sumsq_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(partials), block_base);
  return static_cast<int>(cudaGetLastError());
}

// *norm = sqrt(partials[0] + ... + partials[blocks - 1]), summed in a fixed
// order. Does not synchronise.
int adam_multi_norm(const void* partials, int blocks, void* norm, int device,
                    void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_multi_norm_kernel<<<1, kNormThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), blocks, static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}

// The update of one launch's `count` leaves, in place on p, mu and nu.
// scalars: the device row (lr, bc1, bc2); norm: a device scalar, read only
// when clip_on. Does not synchronise.
int adam_multi_update(const long long* g, const long long* p,
                      const long long* mu, const long long* nu,
                      const long long* n, const int* block_start, int count,
                      const void* norm, const void* scalars, float b1,
                      float one_minus_b1, float b2, float one_minus_b2,
                      float eps, float clip, float wd, int clip_on, int wd_on,
                      int device, void* stream) {
  Leaves t;
  const int blocks = fill_leaves(t, g, p, mu, nu, n, block_start, count);
  if (blocks < 1 || (clip_on && norm == nullptr) || scalars == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, clip, wd,
                clip_on, wd_on};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_multi_update_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t, h, static_cast<const float*>(norm),
      static_cast<const float*>(scalars));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
