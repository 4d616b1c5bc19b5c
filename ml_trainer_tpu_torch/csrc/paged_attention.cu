// Paged-attention decode (S == 1) for Hopper (sm_90a), float32
// (paged_attention_f32) and bfloat16 (paged_attention_bf16, below).
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
// What the design does about it: the positions of each (b, h) are split
// over blocks, so that a decode batch puts hundreds of blocks on the 132
// SMs instead of one block per (b, h).  The grid is (B*H, S): block
// (bh, s) owns positions [s*split, (s+1)*split), split <= 64 chosen by
// the wrapper from the static shapes (whole pages at page 16).  A block
// whose first position is at or past len_b exits at once.  A live block
// loads its own table entries and issues every K and V load of its split
// at once, 16 bytes a thread straight into registers (D/4 lanes cover one
// position's row, coalesced along D; at most 64 positions x D x 8 bytes a
// block), so the scores are taken on K while V is still landing and no
// shared memory grows with the context.  It reduces its split to the
// local max m_s, l_s = sum exp(s - m_s) and acc_s = sum exp(s - m_s) v,
// writes them to the workspace and takes a ticket (split_merge.cuh); the
// last of the row's ceil(len_b / split) live blocks copies them back into
// shared memory (all copies of a chunk in flight at once) and merges them
// in split order:  m = max m_s,
//   out = sum acc_s e^(m_s - m) / sum l_s e^(m_s - m).
// Split 0 always holds position 0, so m is finite and a dead split is
// never read.  A row with one live split writes its output directly.  No
// float atomics: two calls give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplit = 64;    // positions a block owns, at most
constexpr int kMergeChunk = 64;  // partials per merge chunk

using split_merge::cp_async16;
using split_merge::cp_async_wait_all;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       float4* __restrict__ part_acc,   // [B*H, S, D/4]
                       float2* __restrict__ part_ml,    // [B*H, S] (m_s, l_s)
                       unsigned int* __restrict__ tickets,  // [B*H], zero
                       int heads, int pages, int page_size, int split,
                       float scale) {
  constexpr int C = D / 4;            // float4 chunks per row = lanes per position
  constexpr int G = kThreads / C;     // positions side by side
  constexpr int PT = kMaxSplit / G;   // positions per thread, at most
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % C == 0 && 32 % C == 0, "lane groups within warps");
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];
  __shared__ float4 red_acc[G][C];
  __shared__ __align__(16) float4 merge_acc[kMergeChunk][C];
  __shared__ float2 merge_ml[kThreads];
  __shared__ float merge_w[kMergeChunk], merge_l[kMergeChunk];

  const int bh = blockIdx.x, s = blockIdx.y, n_splits = gridDim.y;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, g = tid / C, c = tid % C;
  const int L = pages * page_size;
  const int p0 = s * split;
  const int len = min(max(__ldg(lengths + b), 1), L);

  // Table entries of this thread's positions, loaded without waiting for
  // len (every index below L is a valid table entry).
  int page[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = g + i * G, pos = p0 + j;
    page[i] = (j < split && pos < L)
                  ? __ldg(table + (size_t)b * pages + pos / page_size) : 0;
  }
  if (p0 >= len) return;  // a wholly dead split: no work, no ticket
  const int n = min(split, len - p0);   // live positions of this split
  const int live = (len + split - 1) / split;

  const float4* k4 = reinterpret_cast<const float4*>(k_pool);
  const float4* v4 = reinterpret_cast<const float4*>(v_pool);
  float4 kk[PT], vv[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = g + i * G, pos = p0 + j;
    if (j < n) {
      const size_t row =
          (((size_t)page[i] * heads + h) * page_size + pos % page_size) * C + c;
      kk[i] = __ldg(k4 + row);
      vv[i] = __ldg(v4 + row);
    } else {
      kk[i] = vv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float4 qv = __ldg(reinterpret_cast<const float4*>(q) + (size_t)bh * C + c);

  // -- scores and the split's max ---------------------------------------
  float sc[PT];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    float d = dot4(qv, kk[i]);
#pragma unroll
    for (int o = C / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    sc[i] = g + i * G < n ? d * scale : -INFINITY;
    mx = fmaxf(mx, sc[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid % 32 == 0) red_max[tid / 32] = mx;
  __syncthreads();
  float m = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[w]);

  // -- weights, their sum and the weighted sum of V -----------------------
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const float p = g + i * G < n ? expf(sc[i] - m) : 0.f;
    lsum += p;
    acc.x = fmaf(p, vv[i].x, acc.x);
    acc.y = fmaf(p, vv[i].y, acc.y);
    acc.z = fmaf(p, vv[i].z, acc.z);
    acc.w = fmaf(p, vv[i].w, acc.w);
  }
  // Every lane of a group holds the same weights: count them once.
  if (c != 0) lsum = 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  if (tid % 32 == 0) red_sum[tid / 32] = lsum;
  red_acc[g][c] = acc;
  __syncthreads();

  float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (tid < C) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += red_sum[w];
#pragma unroll 8
    for (int i = 0; i < G; ++i) {
      const float4 r = red_acc[i][tid];
      tot.x += r.x; tot.y += r.y; tot.z += r.z; tot.w += r.w;
    }
  }
  float4* out4 = reinterpret_cast<float4*>(out) + (size_t)bh * C;
  if (live == 1) {  // the whole row in this block: no partial, no ticket
    if (tid < C)
      out4[tid] = make_float4(tot.x / l, tot.y / l, tot.z / l, tot.w / l);
    return;
  }
  const size_t base = (size_t)bh * n_splits;
  if (tid < C) part_acc[(base + s) * C + tid] = tot;
  if (tid == 0) part_ml[base + s] = make_float2(m, l);
  if (!split_merge::last_ticket(tickets + bh, (unsigned int)live)) return;

  // -- the merge, in split order ------------------------------------------
  // The row's acc partials come back from L2 kMergeChunk splits at a time,
  // every copy of a chunk in flight at once (cp.async); the first chunk's
  // copies overlap the pass that takes m = max m_s (exact in any order).
  const float4* acc_parts = part_acc + base * C;
  auto stage = [&](int t0) {
    const int nt = min(kMergeChunk, live - t0);
    for (int i = tid; i < nt * C; i += kThreads)
      cp_async16(&merge_acc[i / C][i % C], acc_parts + (size_t)t0 * C + i, 16);
  };
  stage(0);
  float mm = -INFINITY;
  for (int t = tid; t < live; t += kThreads) {
    const float2 ml = __ldcg(part_ml + base + t);
    if (t < kThreads) merge_ml[t] = ml;
    mm = fmaxf(mm, ml.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  if (tid % 32 == 0) red_max[tid / 32] = mm;
  __syncthreads();
  mm = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red_max[w]);

  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int t0 = 0; t0 < live; t0 += kMergeChunk) {
    const int nt = min(kMergeChunk, live - t0);
    if (tid < nt) {
      const int t = t0 + tid;
      const float2 ml = t < kThreads ? merge_ml[t] : __ldcg(part_ml + base + t);
      merge_w[tid] = expf(ml.x - mm);
      merge_l[tid] = ml.y;
    }
    cp_async_wait_all();
    __syncthreads();
    if (tid < C) {
      for (int i = 0; i < nt; ++i) {
        const float w = merge_w[i];
        const float4 a = merge_acc[i][tid];
        num.x = fmaf(a.x, w, num.x);
        num.y = fmaf(a.y, w, num.y);
        num.z = fmaf(a.z, w, num.z);
        num.w = fmaf(a.w, w, num.w);
        den = fmaf(merge_l[i], w, den);
      }
    }
    __syncthreads();
    if (t0 + kMergeChunk < live) stage(t0 + kMergeChunk);
  }
  if (tid < C)
    out4[tid] = make_float4(num.x / den, num.y / den, num.z / den, num.w / den);
}

template <int D>
int launch(const float* q, const float* kp, const float* vp, const int* table,
           const int* lengths, float* out, float* workspace,
           unsigned int* tickets, int batch, int heads, int pages,
           int page_size, int split, float scale, cudaStream_t st) {
  const long long L = (long long)pages * page_size;
  const long long n_splits = (L + split - 1) / split;
  if (n_splits > 65535 ||
      (n_splits > 1 && (workspace == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The workspace: acc partials [B*H, S, D] then (m, l) pairs [B*H, S].
  const size_t parts = (size_t)batch * heads * n_splits;
  float4* part_acc = reinterpret_cast<float4*>(workspace);
  float2* part_ml = workspace == nullptr
                        ? nullptr
                        : reinterpret_cast<float2*>(workspace + parts * D);
  const dim3 grid(batch * heads, (unsigned int)n_splits);
  paged_attention_kernel<D><<<grid, kThreads, 0, st>>>(
      q, kp, vp, table, lengths, out, part_acc, part_ml, tickets, heads,
      pages, page_size, split, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bfloat16: q and the pools in bf16, the output in bf16.
//
// The JAX function in bf16 (the same _paged_kernel on bf16 pools): f32
// scores from the widened q and k, the masked softmax over the row's
// whole live length, the NORMALISED weights exp(s - m) / l rounded to
// bf16 and widened again, the product with the widened V in f32, and one
// rounding of the output.  The weights' rounding needs the row's final
// m and l before any PV product, which the f32 kernel's split never has
// (its blocks only ever hold partial sums of exp(s - m_s)).  So the bf16
// kernel runs the splits of a row as one thread block cluster: grid
// (B*H, S) with cluster (1, S, 1), S = ceil(P*page / split) <= 16 (up to
// 8 portable; 9-16 with the non-portable cluster size), split <= 128
// positions.  Block s loads its positions' K and V rows at once (16
// bytes a thread: D/8 lanes a position, coalesced along D), takes the
// scores and its (m_s, l_s = sum exp(s - m_s)), and publishes them in its
// shared memory; after one cluster barrier every block reads the S pairs
// from distributed shared memory and forms the same m = max m_s and
// l = sum_s l_s e^(m_s - m) in split order (so all blocks hold the same
// bits), rounds its own weights bf16(exp(s - m) / l), and sums w * v over
// its positions in f32.  After a second cluster barrier block 0 adds the
// S partials [D] from distributed shared memory in split order and rounds
// once to bf16; a third keeps every block's shared memory alive until
// block 0 has read it.  A split wholly past len_b loads no K/V and
// contributes (m, l) = (-inf, 0) and a zero partial.  No workspace, no
// ticket, no atomics: two calls give the same bits.
//
// What bounds it: bytes, as the f32 kernel (the live K/V at 2 bytes a
// value over 3.35 TB/s).

constexpr int kMaxSplitBf16 = 128;   // positions a block owns, at most
constexpr int kMaxClusterBf16 = 16;  // splits of a row (blocks of a cluster)
constexpr int kPortableCluster = 8;

__device__ __forceinline__ void widen8(uint4 v, float* f) {
  // bf16 -> f32 is exact: the bf16 bits are the float's high half.
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16);
  f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16);
  f[7] = __uint_as_float(v.w & 0xffff0000u);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_bf16_kernel(const uint4* __restrict__ q,
                            const uint4* __restrict__ k_pool,
                            const uint4* __restrict__ v_pool,
                            const int* __restrict__ table,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int heads,
                            int pages, int page_size, int split,
                            float scale) {
  constexpr int C = D / 8;            // 16-byte chunks per row = lanes per position
  constexpr int G = kThreads / C;     // positions side by side
  constexpr int PT = kMaxSplitBf16 / G;  // positions per thread, at most
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % C == 0 && 32 % C == 0, "lane groups within warps");
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];
  __shared__ float2 ml_own;                   // this block's (m_s, l_s)
  __shared__ float2 ml_all[kMaxClusterBf16];  // every split's, in order
  __shared__ __align__(16) float red_acc[G][D];
  __shared__ float part[D];                   // this block's sum of w v

  const int bh = blockIdx.x, s = blockIdx.y, n_splits = gridDim.y;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, g = tid / C, c = tid % C;
  const int L = pages * page_size;
  const int p0 = s * split;

  // Table entries of this thread's positions, loaded without waiting for
  // len (every index below L is a valid table entry).
  int page[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = g + i * G, pos = p0 + j;
    page[i] = (j < split && pos < L)
                  ? __ldg(table + (size_t)b * pages + pos / page_size) : 0;
  }
  const int len = min(max(__ldg(lengths + b), 1), L);
  const int n = max(0, min(split, len - p0));  // live positions; 0: dead split

  uint4 kk[PT], vv[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = g + i * G, pos = p0 + j;
    if (j < n) {
      const size_t row =
          (((size_t)page[i] * heads + h) * page_size + pos % page_size) * C + c;
      kk[i] = __ldg(k_pool + row);
      vv[i] = __ldg(v_pool + row);
    } else {
      kk[i] = vv[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float qf[8];
  widen8(__ldg(q + (size_t)bh * C + c), qf);

  // -- scores and the split's max ---------------------------------------
  float sc[PT];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    float kf[8];
    widen8(kk[i], kf);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) d = fmaf(qf[e], kf[e], d);
#pragma unroll
    for (int o = C / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    sc[i] = g + i * G < n ? d * scale : -INFINITY;
    mx = fmaxf(mx, sc[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid % 32 == 0) red_max[tid / 32] = mx;
  __syncthreads();
  float m_s = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_s = fmaxf(m_s, red_max[w]);

  // -- the split's l_s = sum exp(s - m_s), published --------------------
  float lsum = 0.f;
#pragma unroll
  for (int i = 0; i < PT; ++i)
    if (g + i * G < n) lsum += expf(sc[i] - m_s);
  if (c != 0) lsum = 0.f;  // every lane of a group holds the same scores
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  if (tid % 32 == 0) red_sum[tid / 32] = lsum;
  __syncthreads();
  if (tid == 0) {
    float l_s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l_s += red_sum[w];
    ml_own = make_float2(m_s, l_s);
  }

  // -- the row's m and l, the same bits in every block --------------------
  cg::cluster_group cluster = cg::this_cluster();
  if (n_splits > 1) {
    cluster.sync();  // every block's (m_s, l_s) published
    if (tid < n_splits) ml_all[tid] = *cluster.map_shared_rank(&ml_own, tid);
  } else {
    __syncthreads();
    if (tid == 0) ml_all[0] = ml_own;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = 0; t < n_splits; ++t) m = fmaxf(m, ml_all[t].x);
  float l = 0.f;  // a dead split adds 0 * e^(-inf) = 0
  for (int t = 0; t < n_splits; ++t) l += ml_all[t].y * expf(ml_all[t].x - m);

  // -- the normalised weights rounded to bf16, then w v in f32 ----------
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    if (g + i * G < n) {
      const float w = __bfloat162float(
          __float2bfloat16_rn(__fdiv_rn(expf(sc[i] - m), l)));
      float vf[8];
      widen8(vv[i], vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
    }
  }
  float4* dst = reinterpret_cast<float4*>(&red_acc[g][8 * c]);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  float tot = 0.f;
  if (tid < D) {
    for (int i = 0; i < G; ++i) tot += red_acc[i][tid];
  }
  __nv_bfloat16* orow = out + (size_t)bh * D;
  if (n_splits == 1) {  // the whole row in this block
    if (tid < D) orow[tid] = __float2bfloat16_rn(tot);
    return;
  }
  if (tid < D) part[tid] = tot;

  // -- block 0 adds the S partials in split order -------------------------
  cluster.sync();  // every partial published
  if (s == 0 && tid < D) {
    float sum = 0.f;
    for (int t = 0; t < n_splits; ++t)
      sum += cluster.map_shared_rank(part, t)[tid];
    orow[tid] = __float2bfloat16_rn(sum);
  }
  cluster.sync();  // block 0 has read every partial: the blocks may exit
}

template <int D>
int launch_bf16(const void* q, const void* kp, const void* vp,
                const int* table, const int* lengths, __nv_bfloat16* out,
                int batch, int heads, int pages, int page_size, int split,
                float scale, cudaStream_t st) {
  const long long L = (long long)pages * page_size;
  const long long n_splits = (L + split - 1) / split;
  if (n_splits > kMaxClusterBf16) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_attention_bf16_kernel<D>;
  if (n_splits > kPortableCluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * heads, (unsigned int)n_splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = (unsigned int)n_splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = n_splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint4*>(q), static_cast<const uint4*>(kp),
      static_cast<const uint4*>(vp), table, lengths, out, heads, pages,
      page_size, split, scale);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// workspace: (D + 2) * batch * heads * ceil(pages * page_size / split)
// floats and tickets: batch * heads zeroed counters, both unused (may be
// NULL) when one split covers the table.  split: positions per block, 1-64.
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* lengths, void* out,
                                   void* workspace, void* tickets, int batch,
                                   int heads, int pages, int page_size, int d,
                                   int split, float scale, void* stream) {
  if (split < 1 || split > kMaxSplit || batch < 1 || heads < 1 || pages < 1 ||
      page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k_pool);
  const float* vp = static_cast<const float*>(v_pool);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* of = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(qf, kp, vp, tb, ln, of, ws, tk, batch, heads, pages,
                        page_size, split, scale, st);
    case 64:
      return launch<64>(qf, kp, vp, tb, ln, of, ws, tk, batch, heads, pages,
                        page_size, split, scale, st);
    case 128:
      return launch<128>(qf, kp, vp, tb, ln, of, ws, tk, batch, heads, pages,
                         page_size, split, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 q, pools and out.  split: positions per block, 1-128, with at most
// 16 splits of a row (a thread block cluster; more than 8 needs the
// non-portable cluster size).
extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* table,
                                    const void* lengths, void* out, int batch,
                                    int heads, int pages, int page_size, int d,
                                    int split, float scale, void* stream) {
  if (split < 1 || split > kMaxSplitBf16 || batch < 1 || heads < 1 ||
      pages < 1 || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_bf16<32>(q, k_pool, v_pool, tb, ln, ob, batch, heads,
                             pages, page_size, split, scale, st);
    case 64:
      return launch_bf16<64>(q, k_pool, v_pool, tb, ln, ob, batch, heads,
                             pages, page_size, split, scale, st);
    case 128:
      return launch_bf16<128>(q, k_pool, v_pool, tb, ln, ob, batch, heads,
                              pages, page_size, split, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
