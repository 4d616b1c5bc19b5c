// Int8 weight-quantized matmul (the decode projections) for Hopper
// (sm_90a): float32 or bfloat16 activations, int8 weights, f32
// per-column scales.
//
// Replaces: ml_trainer_tpu/ops/kernels/int8_matmul.py::_int8_kernel,
// launched by _int8_pallas (pl.pallas_call at
// ops/kernels/int8_matmul.py:78).
//
// Computes, for x [M, K] f32, w [K, N] int8 (N contiguous), scale [N] and
// an optional bias [N]:
//   out[m, n] = (sum_k x[m, k] * float(w[k, n])) * scale[n]  (+ bias[n])
// The int8 -> f32 conversion is exact and the sum is taken in f32 over the
// full K; the scale multiplies the finished sum and the bias is added
// after it, each as its own f32 rounding (__fmul_rn / __fadd_rn, so the
// compiler cannot contract them into one FMA), which is the plain
// version's order.  With bfloat16 x and out (int8_matmul_bf16, a bf16
// model's decode step) x is widened exactly as it is staged, the sum is
// the same f32 sum, and the epilogue rounds twice as the JAX package's
// _quant_dense does: out = bf16(bf16(sum * scale) + bf16(bias)), the add
// taken in f32 on the two bf16 values and rounded once more.
//
// What bounds it on this card: bytes.  In decode M is the batch (8), so
// every weight byte feeds 2 * M = 16 flops: the weights (K * N bytes)
// dominate the traffic, and the least time is about K * N / 3.35 TB/s
// (0.56 us for GPT-2's qkv, 768 x 2304).
//
// What the design does about it: the grid is column tiles x K slices, so
// that the narrow projections (N = 768) still spread over the SMs.  Block
// (t, s) owns 32 output columns and `slice` rows of K (a multiple of 64,
// chosen by the wrapper from the static shapes: 256 or 384 at GPT-2's).  It
// issues every weight load of its slice at once, 16-byte cp.async copies of
// 16 int8 columns, together with its x slice [<= 8, slice], and waits on one
// barrier (a slice past 512 rows goes in chunks of 512).  Each of its 128
// threads then owns 4 columns x 8 rows and one of 16 interleaved 4-row
// groups of the slice, converts each weight once (a byte permute into a
// float's mantissa, exact) and uses it for all 8 rows; the 16 partial sums
// of an output are added by warp shuffles and then across the 4 warps in a
// fixed order.  A larger M loops over passes of 8 rows (the weights stay in
// shared memory).  The S <= 8 slices of a column tile run as one thread
// block cluster: each block stores its partial sums [8, 32] into block 0's
// shared memory (distributed shared memory), one cluster barrier publishes
// them, and block 0 adds the S partials in slice order, then applies the
// scale and the bias.  No workspace, no second pass, no atomics: repeated
// runs give the same bits.  With one slice the block finishes the output
// itself.  Ragged M, N and K are masked (zero-filled); the 16-byte copies
// are used only when N % 16 == 0 (K % 4 == 0 for x) and the base is 16-byte
// aligned, else 4-byte copies (4 columns when N % 4 == 0, one float of x)
// or, for the weights, byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "split_merge.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kTileN = 32;                     // output columns per block
constexpr int kQuads = kTileN / 4;             // threads across a tile row
constexpr int kLanesK = kThreads / kQuads;     // 4-row groups side by side
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                       // rows of x per pass
constexpr int kMaxSlice = 512;                 // K rows staged at once
constexpr int kSliceStep = 4 * kLanesK;        // slice is a multiple of 64
constexpr int kMaxCluster = 8;                 // slices of a tile, at most
static_assert(kLanesK == 4 * kWarps, "4 k-lanes per warp");

using split_merge::cp_async16;
using split_merge::cp_async4;
using split_merge::cp_async_wait_all;

// The cluster barrier in its two halves: a block may store into another
// block's shared memory only once that block has started, which the first
// arrive (at the top of the kernel) and wait (before the first store) show.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared-memory row of K row r of the slice.  A warp's 4 k-lanes read rows
// 4 apart at once; flipping the low two bits by (r / 4) % 4 puts those
// rows in four different 8-bank groups (a permutation within each 4 rows).
__device__ __forceinline__ int w_row(int r) { return r ^ ((r >> 2) & 3); }

// Byte c of v as a float, exactly, without the int-to-float conversion
// unit (slower at Hopper than the FP32 and integer pipes): with its sign bit
// flipped the int8 b reads as b + 128, which the byte permute puts into the
// mantissa of 2^23; taking 2^23 + 128 away leaves b.
__device__ __forceinline__ float w_at(uint32_t v, int c) {
  const uint32_t f = __byte_perm(v ^ 0x80808080u, 0x4B000000u, 0x7650 | c);
  return __fsub_rn(__int_as_float(f), 8388736.0f);
}

__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t h) {
  return __uint_as_float(h << 16);  // exact
}

// The epilogue: the finished f32 sum v of output (m, n), scaled, plus the
// bias, stored in the output's type (see the header for the roundings).
__device__ __forceinline__ void store_out(float* out, size_t o, float v,
                                          float sc, const float* bias, int n) {
  float y = __fmul_rn(v, sc);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  out[o] = y;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t o,
                                          float v, float sc,
                                          const float* bias, int n) {
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(v, sc));
  if (bias != nullptr)
    y = __float2bfloat16_rn(__fadd_rn(
        __bfloat162float(y), __bfloat162float(__float2bfloat16_rn(bias[n]))));
  out[o] = y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int M, int K, int N, int slice, int vec_w, int vec_x) {
  __shared__ __align__(16) int8_t w_s[kMaxSlice * kTileN];
  __shared__ __align__(16) float x_s[kRows * kMaxSlice];
  __shared__ __align__(16) float red[kWarps][kRows][kTileN];
  // Block 0 of a cluster: the partial sums of every slice, by slice.
  __shared__ __align__(16) float parts[kMaxCluster][kRows * kTileN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = tid % kQuads, kl = tid / kQuads;
  const int n_base = blockIdx.x * kTileN, k0 = blockIdx.y * slice;
  const int n_slices = gridDim.y;
  const int kn = min(slice, K - k0);   // live rows of K in this slice
  if (n_slices > 1) cluster_arrive();

  // The slice's rows in chunks of at most kMaxSlice (one chunk at GPT-2's
  // shapes, whose weights then stay staged for every pass of 8 rows); the
  // rows of a chunk are a multiple of 64, those past K zero-filled.
  const int chunk = min(slice, kMaxSlice);
  const int n_chunks = (max(kn, 1) + chunk - 1) / chunk;
  auto chunk_rows = [&](int c0) {
    const int left = max(kn - c0, 0);
    return min(chunk, (left + kSliceStep - 1) / kSliceStep * kSliceStep);
  };
  // -- weights: every load of the chunk at c0 in flight at once -----------
  auto stage_w = [&](int c0) {
    const int rows = chunk_rows(c0), live = kn - c0;
    if (vec_w == 16) {
      for (int i = tid; i < 2 * rows; i += kThreads) {
        const int r = i / 2, n0 = n_base + 16 * (i % 2);
        const bool ok = r < live && n0 < N;   // N % 16 == 0: whole chunks
        cp_async16(w_s + w_row(r) * kTileN + 16 * (i % 2),
                   ok ? w + (size_t)(k0 + c0 + r) * N + n0 : w, ok ? 16 : 0);
      }
    } else if (vec_w == 4) {  // N % 4 == 0: 4 columns a copy
      for (int i = tid; i < rows * kQuads; i += kThreads) {
        const int r = i / kQuads, n = n_base + 4 * (i % kQuads);
        const bool ok = r < live && n < N;
        cp_async4(w_s + w_row(r) * kTileN + 4 * (i % kQuads),
                  ok ? w + (size_t)(k0 + c0 + r) * N + n : w, ok ? 4 : 0);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < rows * kTileN; i += kThreads) {
        const int r = i / kTileN, n = n_base + i % kTileN;
        w_s[w_row(r) * kTileN + i % kTileN] =
            (r < live && n < N) ? w[(size_t)(k0 + c0 + r) * N + n] : (int8_t)0;
      }
    }
  };
  // -- x rows m0 .. m0+7 of the chunk at c0, zero past M and K -------------
  auto stage_x = [&](int m0, int c0) {
    const int rows = chunk_rows(c0), live = kn - c0;
    if constexpr (sizeof(T) == 2) {
      // bf16: loads widened into the f32 staging rows (they run while the
      // weights' copies are in flight), 8 values a load when vec_x.
      const uint16_t* xh = reinterpret_cast<const uint16_t*>(x);
      if (vec_x) {
        for (int i = tid; i < kRows * rows / 8; i += kThreads) {
          const int r = i / (rows / 8), kk = 8 * (i % (rows / 8));
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (m0 + r < M && kk < live)  // K % 8 == 0: whole chunks
            v = __ldg(reinterpret_cast<const uint4*>(
                xh + (size_t)(m0 + r) * K + k0 + c0 + kk));
          float4* dst = reinterpret_cast<float4*>(x_s + r * kMaxSlice + kk);
          dst[0] = make_float4(bf16_bits_to_f32(v.x & 0xffffu),
                               bf16_bits_to_f32(v.x >> 16),
                               bf16_bits_to_f32(v.y & 0xffffu),
                               bf16_bits_to_f32(v.y >> 16));
          dst[1] = make_float4(bf16_bits_to_f32(v.z & 0xffffu),
                               bf16_bits_to_f32(v.z >> 16),
                               bf16_bits_to_f32(v.w & 0xffffu),
                               bf16_bits_to_f32(v.w >> 16));
        }
      } else {
        for (int i = tid; i < kRows * rows; i += kThreads) {
          const int r = i / rows, kk = i % rows;
          x_s[r * kMaxSlice + kk] =
              (m0 + r < M && kk < live)
                  ? bf16_bits_to_f32(xh[(size_t)(m0 + r) * K + k0 + c0 + kk])
                  : 0.f;
        }
      }
    } else if (vec_x) {
      for (int i = tid; i < kRows * rows / 4; i += kThreads) {
        const int r = i / (rows / 4), kk = 4 * (i % (rows / 4));
        const bool ok = m0 + r < M && kk < live;   // K % 4 == 0: whole chunks
        cp_async16(x_s + r * kMaxSlice + kk,
                   ok ? x + (size_t)(m0 + r) * K + k0 + c0 + kk : x,
                   ok ? 16 : 0);
      }
    } else {  // one float a copy
      for (int i = tid; i < kRows * rows; i += kThreads) {
        const int r = i / rows, kk = i % rows;
        const bool ok = m0 + r < M && kk < live;
        cp_async4(x_s + r * kMaxSlice + kk,
                  ok ? x + (size_t)(m0 + r) * K + k0 + c0 + kk : x, ok ? 4 : 0);
      }
    }
  };

  for (int m0 = 0; m0 < M; m0 += kRows) {
    // -- this thread's 4 columns x 8 rows over its 4-row groups ----------
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (m0 > 0 || ch > 0) __syncthreads();  // the last readers are done
      const int c0 = ch * chunk;
      if (n_chunks > 1 || m0 == 0) stage_w(c0);  // else still staged
      stage_x(m0, c0);
      cp_async_wait_all();
      __syncthreads();
      const float4* xs = reinterpret_cast<const float4*>(x_s);
      for (int grp = kl; grp < chunk_rows(c0) / 4; grp += kLanesK) {
        float4 xv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) xv[r] = xs[r * (kMaxSlice / 4) + grp];
#pragma unroll
        for (int kr = 0; kr < 4; ++kr) {
          const uint32_t wq = *reinterpret_cast<const uint32_t*>(
              w_s + w_row(4 * grp + kr) * kTileN + 4 * quad);
          float wf[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) wf[c] = w_at(wq, c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xk = lane_of(xv[r], kr);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xk, wf[c], acc[r][c]);
          }
        }
      }
    }
    // The warp's 4 k-lanes (lanes 8 apart), then the 4 warps in order.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 8);
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
      }
    }
    if (lane < kQuads) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        *reinterpret_cast<float4*>(&red[warp][r][4 * quad]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();
    if (n_slices > 1 && m0 == 0) cluster_wait();  // every block has started
    for (int o = tid; o < kRows * kTileN; o += kThreads) {
      const int r = o / kTileN, col = o % kTileN;
      float v = red[0][r][col];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) v += red[wi][r][col];
      const int m = m0 + r, n = n_base + col;
      if (n_slices > 1) {
        cg::this_cluster().map_shared_rank(&parts[blockIdx.y][0], 0)[o] = v;
      } else if (m < M && n < N) {
        store_out(out, (size_t)m * N + n, v, scale[n], bias, n);
      }
    }
    if (n_slices == 1) continue;
    // -- the merge: the S partials in slice order, then scale and bias ---
    cg::this_cluster().sync();
    if (blockIdx.y == 0) {
      for (int o = tid; o < kRows * kTileN; o += kThreads) {
        const int m = m0 + o / kTileN, n = n_base + o % kTileN;
        float v = parts[0][o];
        for (int t = 1; t < n_slices; ++t) v += parts[t][o];
        if (m < M && n < N)
          store_out(out, (size_t)m * N + n, v, scale[n], bias, n);
      }
    }
    // Block 0 has read every partial before the next pass stores more.
    if (m0 + kRows < M) cg::this_cluster().sync();
  }
}

template <typename T>
int int8_matmul(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int m, int k, int n, int slice,
                void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || slice < kSliceStep ||
      slice % kSliceStep != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slices = k == 0 ? 1 : (k + slice - 1) / slice;
  if (n_slices > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int vec_w = (n % 16 == 0 && wa % 16 == 0) ? 16
                    : (n % 4 == 0 && wa % 4 == 0)  ? 4
                                                   : 1;
  // 16-byte loads of x: 4 floats or 8 bf16 values, whole rows of them.
  const int vec_x = (k % (16 / (int)sizeof(T)) == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kTileN - 1) / kTileN, n_slices);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = n_slices;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = n_slices > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, int8_matmul_kernel<T>, static_cast<const T*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), m, k, n, slice,
      vec_w, vec_x);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// slice: rows of K per block, a multiple of 64, with at most 8 slices (the
// cluster of a column tile).  x and out are float32 (_f32) or bfloat16
// (_bf16); scale and bias are f32 either way.
extern "C" int int8_matmul_f32(const void* x, const void* w, const void* scale,
                               const void* bias, void* out, int m, int k, int n,
                               int slice, void* stream) {
  return int8_matmul<float>(x, w, scale, bias, out, m, k, n, slice, stream);
}

extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, const void* bias, void* out,
                                int m, int k, int n, int slice, void* stream) {
  return int8_matmul<__nv_bfloat16>(x, w, scale, bias, out, m, k, n, slice,
                                    stream);
}
