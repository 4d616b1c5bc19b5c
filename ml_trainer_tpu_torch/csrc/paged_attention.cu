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

#include <cuda_runtime.h>
#include <math.h>

#include "split_merge.cuh"

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
