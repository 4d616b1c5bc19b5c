// Int8 weight-quantized matmul (the decode projections) for Hopper
// (sm_90a): float32 activations, int8 weights, f32 per-column scales.
//
// Replaces: ml_trainer_tpu/ops/kernels/int8_matmul.py::_int8_kernel,
// launched by _int8_pallas (pl.pallas_call at
// ops/kernels/int8_matmul.py:78).
//
// Computes, for x [M, K] f32, w [K, N] int8 (N contiguous), scale [N] and
// an optional bias [N]:
//   out[m, n] = (sum_k x[m, k] * float(w[k, n])) * scale[n]  (+ bias[n])
// The int8 -> f32 conversion is exact and the sum is taken in f32 FMAs
// over the full K; the scale multiplies the finished sum and the bias is
// added after it, each as its own f32 rounding (__fmul_rn / __fadd_rn, so
// the compiler cannot contract them into one FMA), which is the plain
// version's order.  No atomics: every output is summed in a fixed order,
// so repeated runs give the same bits.
//
// What bounds it on this card: bytes.  In decode M is the batch (8), so
// every weight byte feeds 2 * M = 16 flops: the weights (K * N bytes)
// dominate the traffic, and the least time is about K * N / 3.35 TB/s
// (0.56 us for GPT-2's qkv, 768 x 2304).
//
// What the design does about it: each block owns a tile of 32 output
// columns and reads every weight byte of the tile exactly once, as one
// 32-bit load of four adjacent columns per k (8 threads cover the 32
// bytes of a tile row, one sector), and reuses it for all M rows held in
// registers (8 rows per pass; a larger M loops over passes of 8).  The
// block's 32 thread groups split K into interleaved 4-row groups; x is
// staged in shared memory 512 columns of K at a time (an [8, 3072] f32 x
// would not fit the 48 KB static limit), read back as float4 broadcasts.
// Each thread issues its 16 weight loads for a chunk before the barrier
// that publishes x, so their latency overlaps the staging.  The 32
// partial sums of each output are then added in slice order through the
// same shared buffer.  Ragged M, N and K are masked; a 32-bit weight load
// is used only when N is a multiple of 4 and the base is 4-byte aligned,
// else four byte loads.
//
// Known limit: the grid is N / 32 blocks, 24 for N = 768, fewer than the
// 132 SMs, so the narrow projections cannot pull the card's full memory
// rate.  Splitting K across blocks with a fixed-order second pass, and
// the int8/TF32 tensor cores, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesN = 8;                       // threads across a tile row
constexpr int kTileN = 4 * kLanesN;              // output columns per block
constexpr int kSlices = kThreads / kLanesN;      // thread groups splitting K
constexpr int kRows = 8;                         // rows of x per pass
constexpr int kChunkK = 512;                     // K per staged chunk of x
constexpr int kGroups = kChunkK / 4 / kSlices;   // 4-row k-groups per slice
constexpr int kBuf = kSlices * kRows * kTileN;   // floats of shared memory
static_assert(kRows * kTileN == kThreads, "one thread per output of a pass");
static_assert(kRows * kChunkK <= kBuf, "the x chunk must fit the buffer");
static_assert(kChunkK % (4 * kSlices) == 0, "whole k-groups per slice");

// Four int8 weights w[k, n0 .. n0+3] packed in 32 bits (0 where masked).
__device__ __forceinline__ uint32_t load_w4(const int8_t* __restrict__ w,
                                            int k, int n0, int K, int N,
                                            int vec) {
  if (k >= K || n0 >= N) return 0u;
  const int8_t* p = w + (size_t)k * N + n0;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n0 + c < N) v |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * c);
  }
  return v;
}

__device__ __forceinline__ float w_at(uint32_t v, int c) {
  return (float)(int8_t)(uint8_t)(v >> (8 * c));
}

__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int K, int N, int vec) {
  // One buffer, two uses: x's current chunk [kRows][kChunkK] during the
  // sum, then the partial sums [kSlices][kRows][kTileN] for the reduction.
  __shared__ __align__(16) float buf[kBuf];
  const int tid = threadIdx.x;
  const int lane_n = tid % kLanesN;
  const int slice = tid / kLanesN;
  const int n0 = blockIdx.x * kTileN + 4 * lane_n;
  const float4* xs = reinterpret_cast<const float4*>(buf);

  for (int m0 = 0; m0 < M; m0 += kRows) {
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += kChunkK) {
      __syncthreads();  // the last chunk's (or pass's) readers are done
      for (int i = tid; i < kRows * kChunkK; i += kThreads) {
        const int m = m0 + i / kChunkK, k = k0 + i % kChunkK;
        buf[i] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
      }
      uint32_t wq[kGroups][4];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int k = k0 + 4 * (slice + kSlices * g);
#pragma unroll
        for (int kr = 0; kr < 4; ++kr) wq[g][kr] = load_w4(w, k + kr, n0, K, N, vec);
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int kg = slice + kSlices * g;  // 4-row group within the chunk
        if (k0 + 4 * kg >= K) break;
        float4 xv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) xv[r] = xs[r * (kChunkK / 4) + kg];
#pragma unroll
        for (int kr = 0; kr < 4; ++kr) {
          float wf[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) wf[c] = w_at(wq[g][kr], c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xk = lane_of(xv[r], kr);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xk, wf[c], acc[r][c]);
          }
        }
      }
    }
    __syncthreads();
    float4* part = reinterpret_cast<float4*>(buf);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      part[((slice * kRows + r) * kTileN + 4 * lane_n) / 4] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    const int r = tid / kTileN, col = tid % kTileN;
    float s = 0.f;
    for (int sl = 0; sl < kSlices; ++sl) s += buf[(sl * kRows + r) * kTileN + col];
    const int m = m0 + r, n = blockIdx.x * kTileN + col;
    if (m < M && n < N) {
      float y = __fmul_rn(s, scale[n]);
      if (bias != nullptr) y = __fadd_rn(y, bias[n]);
      out[(size_t)m * N + n] = y;
    }
  }
}

}  // namespace

extern "C" int int8_matmul_f32(const void* x, const void* w, const void* scale,
                               const void* bias, void* out, int m, int k, int n,
                               void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const int blocks = (n + kTileN - 1) / kTileN;
  int8_matmul_kernel<<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), m, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}
