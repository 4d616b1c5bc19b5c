// The sharded data-parallel update's optimizer tail for Hopper (sm_90a):
// K4, unscale + squared sum, and K5, clip + Adam + parameter write, both
// float32 and elementwise over one leaf shard.
//
// Replaces: ml_trainer_tpu/ops/kernels/fused_adam.py::_unscale_pallas
// (pl.pallas_call at ops/kernels/fused_adam.py:132) and ::_adam_kernel,
// launched by _adam_pallas (pl.pallas_call at ops/kernels/fused_adam.py:241).
//
// K4 computes out = g / denom (an IEEE division, not a multiply by the
// reciprocal) and sq = sum(out * out) in float32.  denom is either an
// immediate or a float32 scalar on the device (a loss-scaled denominator is
// a device value).  The sum is deterministic: each block reduces its
// grid-stride share with warp shuffles and shared memory into partials[b],
// then a second one-block pass adds the partials in block order.  There
// are no float atomics, so repeated runs give the same bits.
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
// lr_scale, factor] (the JAX kernel's SMEM row), so the step reads nothing
// back to the host.  The constants are the double values converted to
// float, as PyTorch converts a Python float multiplying a float32 tensor.
//
// What bounds them on this card: bytes.  K4 reads 4 and writes 4 bytes per
// element for 2 flops; K5 reads g, p, mu, nu and writes p', mu', nu', u,
// 32 bytes for ~15 flops.  At GPT-2 124M's tok_embed (38.6 M elements) the
// least times are 0.092 ms (K4) and 0.369 ms (K5) at 3.35 TB/s.
//
// What the design does about it: a grid-stride loop over the flattened
// leaf, 16-byte (float4) loads and stores when every pointer is 16-byte
// aligned, with a scalar loop for the ragged tail; about 16 blocks of 256
// threads per SM in flight, enough loads to cover DRAM latency.  One launch
// per leaf shard, as the JAX kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride cap
constexpr int kSqBlocks = 1024;        // K4 partials (the wrapper's buffer)

constexpr float kB1 = (float)0.9;
constexpr float kB2 = (float)0.999;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kOneMinusB2 = (float)(1.0 - 0.999);
constexpr float kEps = (float)1e-8;
constexpr float kEpsRoot = (float)0.0;

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ------------------------------------------------------------------ K4
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s = __fadd_rn(s, smem[w]);
  }
  return s;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
unscale_sqsum_kernel(const float* __restrict__ g, const float* __restrict__ denom_ptr,
                     float denom_imm, float* __restrict__ out,
                     float* __restrict__ partials, long long n, int compute_sq,
                     int vec) {
  __shared__ float smem[kThreads / 32];
  const float d = denom_ptr != nullptr ? *denom_ptr : denom_imm;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      float4 v = g4[i];
      v.x = __fdiv_rn(v.x, d);
      v.y = __fdiv_rn(v.y, d);
      v.z = __fdiv_rn(v.z, d);
      v.w = __fdiv_rn(v.w, d);
      o4[i] = v;
      if (compute_sq) {
        acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
        acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
        acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
        acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float v = __fdiv_rn(g[i], d);
    out[i] = v;
    if (compute_sq) acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  if (!compute_sq) return;
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// One block adds the partials in block order: thread t sums blocks t,
// t + 256, ..., then the block reduction adds the threads in a fixed tree.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int blocks,
                    float* __restrict__ sq_out) {
  __shared__ float smem[kThreads / 32];
  float acc = 0.f;
  for (int b = threadIdx.x; b < blocks; b += kThreads) acc = __fadd_rn(acc, partials[b]);
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) *sq_out = s;
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

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const float* __restrict__ scalars, const float* __restrict__ g,
                  const float* __restrict__ p, const float* __restrict__ mu,
                  const float* __restrict__ nu, float* __restrict__ p_out,
                  float* __restrict__ mu_out, float* __restrict__ nu_out,
                  float* __restrict__ u_out, long long n, int has_factor, int vec) {
  AdamScalars s;
  s.bc1 = scalars[0];
  s.bc2 = scalars[1];
  s.step = scalars[2];
  s.lr_scale = scalars[3];
  s.factor = scalars[4];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const float4 pv = reinterpret_cast<const float4*>(p)[i];
      const float4 mv = reinterpret_cast<const float4*>(mu)[i];
      const float4 nv = reinterpret_cast<const float4*>(nu)[i];
      float4 po, mo, no, uo;
      adam_one(gv.x, pv.x, mv.x, nv.x, s, has_factor, po.x, mo.x, no.x, uo.x);
      adam_one(gv.y, pv.y, mv.y, nv.y, s, has_factor, po.y, mo.y, no.y, uo.y);
      adam_one(gv.z, pv.z, mv.z, nv.z, s, has_factor, po.z, mo.z, no.z, uo.z);
      adam_one(gv.w, pv.w, mv.w, nv.w, s, has_factor, po.w, mo.w, no.w, uo.w);
      reinterpret_cast<float4*>(p_out)[i] = po;
      reinterpret_cast<float4*>(mu_out)[i] = mo;
      reinterpret_cast<float4*>(nu_out)[i] = no;
      reinterpret_cast<float4*>(u_out)[i] = uo;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    adam_one(g[i], p[i], mu[i], nu[i], s, has_factor, p_out[i], mu_out[i],
             nu_out[i], u_out[i]);
  }
}

}  // namespace

// K4.  partials: kSqBlocks floats of scratch; sq_out: one float (written
// only with compute_sq).  denom_ptr may be NULL, then denom is used.
extern "C" int unscale_sqsum_f32(const void* g, const void* denom_ptr, float denom,
                                 void* out, void* partials, void* sq_out,
                                 long long n, int compute_sq, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int vec = aligned16(g) && aligned16(out);
  long long blocks = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > kSqBlocks) blocks = kSqBlocks;
  unscale_sqsum_kernel<<<(int)blocks, kThreads, 0, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(denom_ptr), denom,
      static_cast<float*>(out), static_cast<float*>(partials), n, compute_sq, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !compute_sq) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, st>>>(static_cast<const float*>(partials),
                                              (int)blocks, static_cast<float*>(sq_out));
  return static_cast<int>(cudaGetLastError());
}

// K5.  scalars: five floats on the device, [bc1, bc2, step_size, lr_scale,
// factor]; the outputs must not alias the inputs.
extern "C" int fused_adam_f32(const void* scalars, const void* g, const void* p,
                              const void* mu, const void* nu, void* p_out,
                              void* mu_out, void* nu_out, void* u_out, long long n,
                              int has_factor, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(g) && aligned16(p) && aligned16(mu) && aligned16(nu) &&
                  aligned16(p_out) && aligned16(mu_out) && aligned16(nu_out) &&
                  aligned16(u_out);
  const int blocks = grid_for(vec ? (n + 3) / 4 : n);
  fused_adam_kernel<<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scalars), static_cast<const float*>(g),
      static_cast<const float*>(p), static_cast<const float*>(mu),
      static_cast<const float*>(nu), static_cast<float*>(p_out),
      static_cast<float*>(mu_out), static_cast<float*>(nu_out),
      static_cast<float*>(u_out), n, has_factor, vec);
  return static_cast<int>(cudaGetLastError());
}
