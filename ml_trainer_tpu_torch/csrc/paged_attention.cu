// Paged-attention decode (S == 1) for Hopper (sm_90a), float32.
//
// Replaces: ml_trainer_tpu/ops/kernels/paged_attention.py::_paged_kernel,
// launched by _paged_attention_pallas (pl.pallas_call at
// ops/kernels/paged_attention.py:152).
//
// Computes, per (row b, head h), the one-query attention
//   out[b,h] = softmax_{pos < len_b}((q[b,h] . K[pos]) * scale) . V[pos]
// where position pos lives in pool page table[b, pos / page] at offset
// pos % page; pools are [N, H, page, D], page 0 is the trash page, and
// len_b = lengths[b] (>= 1; clamped to [1, P*page] here).  Positions at
// or past len_b carry weight exactly 0 in the JAX reference (an added
// finfo.min bias), so they are skipped, pages wholly past it included.
//
// What bounds it on this card: bytes.  Each live position's K and V row
// (2 * D * 4 bytes) is read once for 2 * 2 * D flops: ~0.5 flop per
// byte, far below the ~20 flop/byte where fp32 compute would bind.  The
// least time is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it: one block per (b, h); the block loads
// its own table row (the index loads the TPU got from scalar prefetch)
// and streams the pages straight from the pool, never materializing
// pool[table].  D/4 threads cover one position's row with 16-byte loads
// (coalesced along D), and each thread group keeps four positions' loads
// in flight.  Scores and weights live in shared memory; the softmax is
// taken in f32 over the live positions only.  At decode batch 8 the grid
// is only B*H = 96 blocks, fewer than the 132 SMs: splitting long rows
// over several blocks (split-K) is later work.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Block-wide reduction (max or sum) of one float per thread.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? scratch[lane] : (kMax ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       int heads, int pages, int page_size, float scale) {
  constexpr int C = D / 4;              // float4 chunks per row = lanes per position
  constexpr int NG = kThreads / C;      // positions handled side by side
  extern __shared__ float smem[];
  const int L = pages * page_size;
  const int L4 = (L + 3) / 4 * 4;                      // keeps red 16-byte aligned
  float* sc = smem;                                    // [L] scores / weights
  float4* red = reinterpret_cast<float4*>(smem + L4);  // [NG][C] partial outputs
  int* tbl = reinterpret_cast<int*>(red + NG * C);    // [pages]
  __shared__ float scratch[kThreads / 32];

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int g = tid / C, c = tid % C;
  const int len = min(max(lengths[b], 1), L);
  const int live_pages = (len + page_size - 1) / page_size;
  for (int i = tid; i < live_pages; i += kThreads) tbl[i] = table[b * pages + i];

  const float4 qv = reinterpret_cast<const float4*>(q)[(size_t)blockIdx.x * C + c];
  const float4* k4 = reinterpret_cast<const float4*>(k_pool);
  const float4* v4 = reinterpret_cast<const float4*>(v_pool);
  __syncthreads();

  // Row offset (in float4 units) of position pos in the pools.
  auto row_of = [&](int pos) -> size_t {
    const int page = tbl[pos / page_size];
    return (((size_t)page * heads + h) * page_size + pos % page_size) * C;
  };

  // -- scores: q . k * scale over the live positions ------------------
  float local_max = -INFINITY;
  // Loop bounds are block-uniform (the position is base + g + u*NG), so
  // every lane of a warp reaches the group shuffles together.
  for (int base = 0; base < len; base += NG * kUnroll) {
    float4 kk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + g + u * NG;
      kk[u] = pos < len ? k4[row_of(pos) + c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = dot4(qv, kk[u]);
#pragma unroll
      for (int o = C / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      const int pos = base + g + u * NG;
      if (pos < len) {
        d *= scale;
        if (c == 0) sc[pos] = d;
        local_max = fmaxf(local_max, d);
      }
    }
  }
  const float mx = block_reduce<true>(local_max, scratch);
  __syncthreads();

  // -- weights ---------------------------------------------------------
  float local_sum = 0.f;
  for (int pos = tid; pos < len; pos += kThreads) {
    const float p = expf(sc[pos] - mx);
    sc[pos] = p;
    local_sum += p;
  }
  const float total = block_reduce<false>(local_sum, scratch);
  __syncthreads();

  // -- weighted sum of V ---------------------------------------------
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = 0; base < len; base += NG * kUnroll) {
    float4 vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + g + u * NG;
      vv[u] = pos < len ? v4[row_of(pos) + c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + g + u * NG;
      const float p = pos < len ? sc[pos] : 0.f;
      acc.x = fmaf(p, vv[u].x, acc.x);
      acc.y = fmaf(p, vv[u].y, acc.y);
      acc.z = fmaf(p, vv[u].z, acc.z);
      acc.w = fmaf(p, vv[u].w, acc.w);
    }
  }
  red[g * C + c] = acc;
  __syncthreads();
  if (g == 0) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < NG; ++i) {
      const float4 r = red[i * C + c];
      s.x += r.x; s.y += r.y; s.z += r.z; s.w += r.w;
    }
    const float inv = 1.f / total;
    reinterpret_cast<float4*>(out)[(size_t)blockIdx.x * C + c] =
        make_float4(s.x * inv, s.y * inv, s.z * inv, s.w * inv);
  }
}

template <int D>
int launch(const float* q, const float* kp, const float* vp, const int* table,
           const int* lengths, float* out, int batch, int heads, int pages,
           int page_size, float scale, cudaStream_t st) {
  constexpr int C = D / 4;
  const size_t smem = (size_t)((pages * page_size + 3) / 4 * 4) * sizeof(float) +
                      (size_t)kThreads * sizeof(float4) +
                      (size_t)pages * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static_assert(kThreads % C == 0, "threads must cover whole rows");
  paged_attention_kernel<D><<<batch * heads, kThreads, smem, st>>>(
      q, kp, vp, table, lengths, out, heads, pages, page_size, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* lengths, void* out, int batch,
                                   int heads, int pages, int page_size, int d,
                                   float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k_pool);
  const float* vp = static_cast<const float*>(v_pool);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* of = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(qf, kp, vp, tb, ln, of, batch, heads, pages, page_size, scale, st);
    case 64:
      return launch<64>(qf, kp, vp, tb, ln, of, batch, heads, pages, page_size, scale, st);
    case 128:
      return launch<128>(qf, kp, vp, tb, ln, of, batch, heads, pages, page_size, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
