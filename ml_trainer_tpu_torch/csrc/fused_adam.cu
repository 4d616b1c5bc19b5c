// The sharded data-parallel update's optimizer tail for Hopper (sm_90a):
// K4, unscale + squared sum, and K5, clip + Adam + parameter write, both
// float32 and elementwise, each ONE launch over a list of leaves (a
// replica's whole list of leaf shards in the sharded step; a list of one
// leaf for the per-leaf wrappers).
//
// Replaces: ml_trainer_tpu/ops/kernels/fused_adam.py::_unscale_pallas
// (pl.pallas_call at ops/kernels/fused_adam.py:132) and ::_adam_kernel,
// launched by _adam_pallas (pl.pallas_call at ops/kernels/fused_adam.py:241).
// The JAX trainer calls them per leaf inside one jitted program; here the
// loop over leaves is inside the kernel.
//
// The work table.  Every leaf is cut into chunks of `chunk` elements (a
// multiple of 4; the wrapper's CHUNK), and one block takes one chunk: the
// grid is the list's total chunk count, so the largest and the smallest
// leaf share one launch.  Leaf l owns chunks [chunk0[l], chunk0[l + 1]);
// a block finds its leaf by a binary search of that prefix (uniform across
// the block: broadcast reads).  The table (pointers, sizes, the prefix)
// travels in the kernel's parameter space as one __grid_constant__ struct,
// so nothing is copied to the device and nothing synchronises.  Kernel
// parameters of up to 32,764 bytes need CUDA 12.1 or later on sm_70+, in
// nvcc and in the installed NVIDIA software (release 530 or later).  A
// list longer than a table is several launches of the same kernel, in
// leaf order (the wrapper's groups).  The 16-byte vector path is decided
// per leaf, from its own pointers: a chunk starts a multiple of 4 elements
// into its leaf, so an aligned leaf gives aligned chunks; an unaligned
// leaf takes the scalar loop alone.
//
// K4 computes out = g / denom (an IEEE division, __fdiv_rn, not a multiply
// by the reciprocal: bitwise the plain version) and, per leaf, the float32
// sum of out * out.  denom is an immediate or a float32 scalar on the
// device.  The sums are deterministic, with no float atomics:
//   pass 1: thread t of a chunk's block accumulates its elements in order
//           (float4 t, t + 256, ... then the scalar tail t, t + 256, ...),
//           a warp-shuffle tree and the 8 warps in order give partials[c];
//   pass 2: one block; warp w takes leaves w, w + 32, ...; lane j adds the
//           leaf's partials j, j + 32, ... in chunk order, a shuffle tree
//           gives the leaf's sum; then thread 0 adds the leaves' sums in
//           leaf order into sq[0] (sharded leaves) or sq[1] (replicated),
//           the order of the trainer's per-leaf adds and of the JAX
//           trainer; `accumulate` continues from the previous group's sq.
// With compute_sq = 0 only pass 1 runs, and it writes no partials.
//
// K5 computes, per element, the chain of the JAX kernel (fused_adam.py:
// 199-216), each operation its own float32 rounding (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so the compiler cannot contract an FMA that the
// plain PyTorch version (one kernel per operation) does not have:
//   g *= factor                      (only with has_factor)
//   mu' = (1 - B1) * g + B1 * mu
//   nu' = (1 - B2) * (g * g) + B2 * nu
//   u   = (mu' / bc1) / (sqrt(nu' / bc2 + EPS_ROOT) + EPS)
//   u   = (step_size * u) * lr_scale
//   p'  = p + u
// The five scalars come from a device array [bc1, bc2, step_size,
// lr_scale, factor] (the JAX kernel's SMEM row), built once per list, so
// the step reads nothing back to the host.  The constants are the double
// values converted to float, as PyTorch converts a Python float
// multiplying a float32 tensor.
//
// What bounds them on this card: bytes.  K4 reads 4 and writes 4 bytes per
// element for 2 flops; K5 reads g, p, mu, nu and writes p', mu', nu', u,
// 32 bytes for ~15 flops.  Over one replica's list in the 2-replica GPT-2
// 124M step (81.9 M elements) the least times are 0.196 ms (K4) and 0.782
// ms (K5) at 3.35 TB/s.  Launched once per leaf, the 148 leaves' small
// shards sat at the launch floor (a 384-element shard's bound is 0.01 us);
// one launch per list pays that floor once.  Inside a block, each thread
// issues its next four (K4) or two (K5) float4 loads of every input before
// it computes, so enough bytes are in flight to cover DRAM latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a chunk's block
constexpr int kSumThreads = 1024;  // K4's pass 2: 32 warps, a warp a leaf
constexpr int kUnscaleLeaves = 512;  // table capacities (the wrapper's
constexpr int kAdamLeaves = 256;     // K4_MAX_LEAVES / K5_MAX_LEAVES)

constexpr float kB1 = (float)0.9;
constexpr float kB2 = (float)0.999;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kOneMinusB2 = (float)(1.0 - 0.999);
constexpr float kEps = (float)1e-8;
constexpr float kEpsRoot = (float)0.0;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The leaf that owns chunk c: the largest l < n_leaves with chunk0[l] <= c
// (an empty leaf owns no chunk and is passed over).
__device__ __forceinline__ int find_leaf(const int* chunk0, int n_leaves, int c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A warp's values added by a shuffle tree; the sum is valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// ------------------------------------------------------------------ K4
struct UnscaleTable {
  const float* g[kUnscaleLeaves];
  float* out[kUnscaleLeaves];
  long long n[kUnscaleLeaves];
  int chunk0[kUnscaleLeaves + 1];
  unsigned char sharded[kUnscaleLeaves];
};

__global__ void __launch_bounds__(kThreads)
unscale_sqsum_list_kernel(const __grid_constant__ UnscaleTable t, int n_leaves,
                          long long chunk, const float* __restrict__ denom_ptr,
                          float denom_imm, float* __restrict__ partials,
                          int compute_sq) {
  constexpr int kUnroll = 4;
  __shared__ float smem[kThreads / 32];
  const int c = blockIdx.x;
  const int l = find_leaf(t.chunk0, n_leaves, c);
  const long long lo = (long long)(c - t.chunk0[l]) * chunk;
  const long long rest = t.n[l] - lo;
  const int len = (int)(rest < chunk ? rest : chunk);
  const float* __restrict__ g = t.g[l] + lo;
  float* __restrict__ out = t.out[l] + lo;
  const float d = denom_ptr != nullptr ? *denom_ptr : denom_imm;
  float acc = 0.f;
  int done = 0;
  if (aligned16(t.g[l]) && aligned16(t.out[l])) {
    const int n4 = len / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int base = threadIdx.x; base < n4; base += kUnroll * kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) v[u] = __ldg(g4 + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          float4 q;
          q.x = __fdiv_rn(v[u].x, d);
          q.y = __fdiv_rn(v[u].y, d);
          q.z = __fdiv_rn(v[u].z, d);
          q.w = __fdiv_rn(v[u].w, d);
          o4[i] = q;
          acc = __fadd_rn(acc, __fmul_rn(q.x, q.x));
          acc = __fadd_rn(acc, __fmul_rn(q.y, q.y));
          acc = __fadd_rn(acc, __fmul_rn(q.z, q.z));
          acc = __fadd_rn(acc, __fmul_rn(q.w, q.w));
        }
      }
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    const float q = __fdiv_rn(__ldg(g + i), d);
    out[i] = q;
    acc = __fadd_rn(acc, __fmul_rn(q, q));
  }
  if (!compute_sq) return;
  const float w = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) s = __fadd_rn(s, smem[k]);
    partials[c] = s;
  }
}

__global__ void __launch_bounds__(kSumThreads)
sum_leaves_kernel(const __grid_constant__ UnscaleTable t, int n_leaves,
                  const float* __restrict__ partials, float* __restrict__ leaf_sq,
                  float* __restrict__ sq, int accumulate) {
  __shared__ float sums[kUnscaleLeaves];
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < n_leaves; l += kSumThreads / 32) {
    float acc = 0.f;
    const int end = t.chunk0[l + 1];
#pragma unroll 8
    for (int c = t.chunk0[l] + lane; c < end; c += 32) acc = __fadd_rn(acc, partials[c]);
    acc = warp_sum(acc);
    if (lane == 0) {
      sums[l] = acc;
      leaf_sq[l] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float loc = accumulate ? sq[0] : 0.f;
    float rep = accumulate ? sq[1] : 0.f;
    for (int l = 0; l < n_leaves; ++l) {
      if (t.sharded[l]) loc = __fadd_rn(loc, sums[l]);
      else rep = __fadd_rn(rep, sums[l]);
    }
    sq[0] = loc;
    sq[1] = rep;
  }
}

// ------------------------------------------------------------------ K5
struct AdamScalars {
  float bc1, bc2, step, lr_scale, factor;
};

__device__ __forceinline__ void adam_one(float g, float p, float mu, float nu,
                                         const AdamScalars& s, int has_factor,
                                         float& p_o, float& mu_o, float& nu_o,
                                         float& u_o) {
  if (has_factor) g = __fmul_rn(g, s.factor);
  const float mu_n = __fadd_rn(__fmul_rn(kOneMinusB1, g), __fmul_rn(kB1, mu));
  const float nu_n = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(g, g)), __fmul_rn(kB2, nu));
  const float mu_hat = __fdiv_rn(mu_n, s.bc1);
  const float nu_hat = __fdiv_rn(nu_n, s.bc2);
  float u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(nu_hat, kEpsRoot)), kEps));
  u = __fmul_rn(s.step, u);
  u = __fmul_rn(u, s.lr_scale);
  p_o = __fadd_rn(p, u);
  mu_o = mu_n;
  nu_o = nu_n;
  u_o = u;
}

struct AdamTable {
  const float* in[4][kAdamLeaves];  // g, p, mu, nu
  float* out[4][kAdamLeaves];       // p', mu', nu', u
  long long n[kAdamLeaves];
  int chunk0[kAdamLeaves + 1];
};

__global__ void __launch_bounds__(kThreads)
fused_adam_list_kernel(const __grid_constant__ AdamTable t, int n_leaves,
                       long long chunk, const float* __restrict__ scalars,
                       int has_factor) {
  constexpr int kUnroll = 2;
  AdamScalars s;
  s.bc1 = scalars[0];
  s.bc2 = scalars[1];
  s.step = scalars[2];
  s.lr_scale = scalars[3];
  s.factor = scalars[4];
  const int c = blockIdx.x;
  const int l = find_leaf(t.chunk0, n_leaves, c);
  const long long lo = (long long)(c - t.chunk0[l]) * chunk;
  const long long rest = t.n[l] - lo;
  const int len = (int)(rest < chunk ? rest : chunk);
  const float* __restrict__ g = t.in[0][l] + lo;
  const float* __restrict__ p = t.in[1][l] + lo;
  const float* __restrict__ mu = t.in[2][l] + lo;
  const float* __restrict__ nu = t.in[3][l] + lo;
  float* __restrict__ p_out = t.out[0][l] + lo;
  float* __restrict__ mu_out = t.out[1][l] + lo;
  float* __restrict__ nu_out = t.out[2][l] + lo;
  float* __restrict__ u_out = t.out[3][l] + lo;
  bool vec = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) vec = vec && aligned16(t.in[k][l]) && aligned16(t.out[k][l]);
  int done = 0;
  if (vec) {
    const int n4 = len / 4;
    for (int base = threadIdx.x; base < n4; base += kUnroll * kThreads) {
      float4 gv[kUnroll], pv[kUnroll], mv[kUnroll], nv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          gv[u] = __ldg(reinterpret_cast<const float4*>(g) + i);
          pv[u] = __ldg(reinterpret_cast<const float4*>(p) + i);
          mv[u] = __ldg(reinterpret_cast<const float4*>(mu) + i);
          nv[u] = __ldg(reinterpret_cast<const float4*>(nu) + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          float4 po, mo, no, uo;
          adam_one(gv[u].x, pv[u].x, mv[u].x, nv[u].x, s, has_factor, po.x, mo.x, no.x, uo.x);
          adam_one(gv[u].y, pv[u].y, mv[u].y, nv[u].y, s, has_factor, po.y, mo.y, no.y, uo.y);
          adam_one(gv[u].z, pv[u].z, mv[u].z, nv[u].z, s, has_factor, po.z, mo.z, no.z, uo.z);
          adam_one(gv[u].w, pv[u].w, mv[u].w, nv[u].w, s, has_factor, po.w, mo.w, no.w, uo.w);
          reinterpret_cast<float4*>(p_out)[i] = po;
          reinterpret_cast<float4*>(mu_out)[i] = mo;
          reinterpret_cast<float4*>(nu_out)[i] = no;
          reinterpret_cast<float4*>(u_out)[i] = uo;
        }
      }
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    adam_one(__ldg(g + i), __ldg(p + i), __ldg(mu + i), __ldg(nu + i), s, has_factor,
             p_out[i], mu_out[i], nu_out[i], u_out[i]);
  }
}

}  // namespace

// K4 over one group of leaves.  g, out: n_leaves device pointers each (as
// 64-bit integers); n: the leaves' sizes; chunk0: n_leaves + 1 chunk
// offsets from 0 (chunk0[n_leaves] blocks); sharded: one flag per leaf.
// partials: chunk0[n_leaves] floats of scratch, leaf_sq: n_leaves floats,
// sq: 2 floats [sharded sum, replicated sum] (all three used only with
// compute_sq; with accumulate, sq is added to, else overwritten).
// denom_ptr may be NULL, then denom is used.  Returns a cudaError_t.
extern "C" int unscale_sqsum_list_f32(const void* g, const void* out, const void* n,
                                      const void* chunk0, const void* sharded,
                                      int n_leaves, long long chunk,
                                      const void* denom_ptr, float denom,
                                      void* partials, void* leaf_sq, void* sq,
                                      int compute_sq, int accumulate, void* stream) {
  if (n_leaves <= 0 || n_leaves > kUnscaleLeaves || chunk <= 0 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* gp = static_cast<const unsigned long long*>(g);
  const auto* op = static_cast<const unsigned long long*>(out);
  const auto* c0 = static_cast<const int*>(chunk0);
  UnscaleTable t{};
  for (int l = 0; l < n_leaves; ++l) {
    t.g[l] = reinterpret_cast<const float*>(gp[l]);
    t.out[l] = reinterpret_cast<float*>(op[l]);
    t.n[l] = static_cast<const long long*>(n)[l];
    t.sharded[l] = static_cast<const unsigned char*>(sharded)[l];
  }
  for (int l = 0; l <= n_leaves; ++l) t.chunk0[l] = c0[l];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c0[n_leaves] > 0) {
    unscale_sqsum_list_kernel<<<c0[n_leaves], kThreads, 0, st>>>(
        t, n_leaves, chunk, static_cast<const float*>(denom_ptr), denom,
        static_cast<float*>(partials), compute_sq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!compute_sq) return 0;
  sum_leaves_kernel<<<1, kSumThreads, 0, st>>>(
      t, n_leaves, static_cast<const float*>(partials), static_cast<float*>(leaf_sq),
      static_cast<float*>(sq), accumulate);
  return static_cast<int>(cudaGetLastError());
}

// K5 over one group of leaves.  ptrs: 8 x n_leaves device pointers (as
// 64-bit integers), kind-major: g, p, mu, nu, p_out, mu_out, nu_out, u_out;
// n, chunk0 as for K4.  scalars: five floats on the device, [bc1, bc2,
// step_size, lr_scale, factor]; the outputs must not alias the inputs.
extern "C" int fused_adam_list_f32(const void* ptrs, const void* n, const void* chunk0,
                                   int n_leaves, long long chunk, const void* scalars,
                                   int has_factor, void* stream) {
  if (n_leaves <= 0 || n_leaves > kAdamLeaves || chunk <= 0 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const unsigned long long*>(ptrs);
  const auto* c0 = static_cast<const int*>(chunk0);
  AdamTable t{};
  for (int l = 0; l < n_leaves; ++l) {
    for (int k = 0; k < 4; ++k) {
      t.in[k][l] = reinterpret_cast<const float*>(p[k * n_leaves + l]);
      t.out[k][l] = reinterpret_cast<float*>(p[(4 + k) * n_leaves + l]);
    }
    t.n[l] = static_cast<const long long*>(n)[l];
  }
  for (int l = 0; l <= n_leaves; ++l) t.chunk0[l] = c0[l];
  if (c0[n_leaves] == 0) return 0;
  fused_adam_list_kernel<<<c0[n_leaves], kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      t, n_leaves, chunk, static_cast<const float*>(scalars), has_factor);
  return static_cast<int>(cudaGetLastError());
}
