// Flash-attention backward for Hopper (sm_90a), float32: two kernels.
//
// K2, flash_bwd_dq_kernel, replaces
//   ml_trainer_tpu/ops/attention.py::_flash_bwd_dq_kernel
//   (pl.pallas_call at ops/attention.py:385);
// K3, flash_bwd_dkv_kernel, replaces
//   ml_trainer_tpu/ops/attention.py::_flash_bwd_dkv_kernel
//   (pl.pallas_call at ops/attention.py:403).
//
// For q/k/v/dO laid out [B*H, S, D] (row-major, contiguous) and the
// forward's per-row lse plus delta = rowsum(dO * O) as [B*H, S]:
//   P  = exp(q . k^T * scale - lse), exactly 0 where the mask drops a key
//   dP = dO . v^T,   dS = P * (dP - delta) * scale
//   dQ = dS . k      (K2)        dK = dS^T . q,   dV = P^T . dO   (K3)
// with the JAX kernels' mask (diagonal-aligned causal, key j kept for
// query i iff i >= j, and/or keys at or past kv_lens[b] dropped) and the
// JAX backward's scale placement (after the product, not on q).
//
// What bounds it on this card: per kept (query, key) pair K2 does three
// length-D products (q.k, dO.v, dS*k) and K3 four (q.k, dO.v, P*dO,
// dS*q), 2*D flops each, while each kernel reads its inputs about once:
// at GPT-2's [8, 12, 1024, 64] causal that is 50.4 M pairs, 19 GFLOP
// (K2) and 26 GFLOP (K3) against ~126 MB, so both are bound by
// operations: 0.289 ms and 0.385 ms at the 67 TFLOP/s float32 CUDA-core
// rate.  They run as float32 FMAs on the CUDA cores, as K1 does: the
// model trains in fp32, and TF32 tensor cores would change its numbers.
//
// What the design does about it: the TPU kernels carried dQ (or dK/dV)
// in VMEM scratch across a sequential grid axis; here one block owns a
// tile of 64 rows and a loop inside the block streams the other side's
// tiles through shared memory, so the accumulators stay in registers
// and each output is written once.  Splitting dQ from dK/dV is what
// lets both kernels run without atomics, so results are the same from
// run to run.  Four threads share a row (each holds D/4 of every row
// vector); after two butterfly shuffles all four hold the full dot
// products, so P and dS never leave registers and each streamed row is
// read from shared memory once per block row.  Tiles above the causal
// diagonal or wholly past kv_lens are never loaded; a kv tile wholly
// past kv_lens writes zero dK/dV.  Tensor cores, TMA and wgmma are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // rows a block owns (queries in K2, keys in K3)
constexpr int kTPR = 4;    // threads per row
constexpr int kStream = 32;  // streamed rows per tile

template <int D, int RPT>
struct Cfg {
  static constexpr int C = D / 4;                    // float4 chunks per row
  static constexpr int CPT = C / kTPR;               // chunks per thread
  static constexpr int THREADS = kRows * kTPR / RPT;
  static constexpr int ROWS_PER_PASS = kRows / RPT;  // row stride of a thread
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Sum over the four threads of a row (neighbouring lanes of one warp).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ K2
// dQ.  Replaces _flash_bwd_dq_kernel (ops/attention.py:221-281).  Bound:
// 3 x 2*D flops per kept pair (0.289 ms at [8,12,1024,64] causal).  One
// block per (q tile, b*h), 128 threads (D=64, two rows each) or 256
// (D=128); K/V tiles of 32 rows stream through shared memory.
template <int D, int RPT>
__global__ void __launch_bounds__(Cfg<D, RPT>::THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ kv_lens,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int s_q, int s_k, int causal, float scale) {
  using K = Cfg<D, RPT>;
  constexpr int C = K::C, CPT = K::CPT, THREADS = K::THREADS;
  __shared__ float4 ks[kStream][C];
  __shared__ float4 vs[kStream][C];

  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int part = tid % kTPR;
  const int row0 = tid / kTPR;  // rows row0 + r * ROWS_PER_PASS

  const size_t q_off = (size_t)bh * s_q;
  const size_t k_off = (size_t)bh * s_k;
  const float4* q4 = reinterpret_cast<const float4*>(q) + q_off * C;
  const float4* do4 = reinterpret_cast<const float4*>(dout) + q_off * C;
  const float4* k4 = reinterpret_cast<const float4*>(k) + k_off * C;
  const float4* v4 = reinterpret_cast<const float4*>(v) + k_off * C;

  int kv_len = s_k;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[bh / heads], 1), s_k);

  // Thread `part` owns chunks part, part+4, ...: the four threads of a
  // row read neighbouring 16-byte chunks, so shared reads never clash.
  float4 qr[RPT][CPT], dor[RPT][CPT], acc[RPT][CPT];
  float row_lse[RPT], row_delta[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q_start + row0 + r * K::ROWS_PER_PASS;
    const bool live = qi < s_q;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const size_t at = (size_t)qi * C + i * kTPR + part;
      qr[r][i] = live ? q4[at] : zero4();
      dor[r][i] = live ? do4[at] : zero4();
      acc[r][i] = zero4();
    }
    row_lse[r] = live ? lse[q_off + qi] : 0.f;
    row_delta[r] = live ? delta[q_off + qi] : 0.f;
  }

  // Live key range, as the JAX kernel's `live` rule: nothing past the
  // causal diagonal of this q block, nothing wholly past kv_len.
  int kv_end = s_k;
  if (causal) kv_end = min(kv_end, q_start + kRows);
  if (kv_lens != nullptr) kv_end = min(kv_end, kv_len);

  for (int kv_start = 0; kv_start < kv_end; kv_start += kStream) {
    __syncthreads();
    for (int idx = tid; idx < kStream * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      const int kr = kv_start + r;
      ks[r][c] = kr < s_k ? k4[(size_t)kr * C + c] : zero4();
      vs[r][c] = kr < s_k ? v4[(size_t)kr * C + c] : zero4();
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kStream; ++j) {
      const int col = kv_start + j;
      float s[RPT], dp[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) s[r] = dp[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 kk = ks[j][i * kTPR + part];
        const float4 vv = vs[j][i * kTPR + part];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          s[r] = dot4(qr[r][i], kk, s[r]);
          dp[r] = dot4(dor[r][i], vv, dp[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        s[r] = row_sum(s[r]);
        dp[r] = row_sum(dp[r]);
        const int qi = q_start + row0 + r * K::ROWS_PER_PASS;
        bool keep = col < s_k;
        if (causal) keep = keep && qi >= col;
        if (kv_lens != nullptr) keep = keep && col < kv_len;
        const float p = keep ? expf(s[r] * scale - row_lse[r]) : 0.f;
        const float ds = p * (dp[r] - row_delta[r]) * scale;
#pragma unroll
        for (int i = 0; i < CPT; ++i) axpy4(ds, ks[j][i * kTPR + part],
                                            acc[r][i]);
      }
    }
  }

  float4* dq4 = reinterpret_cast<float4*>(dq) + q_off * C;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q_start + row0 + r * K::ROWS_PER_PASS;
    if (qi >= s_q) continue;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dq4[(size_t)qi * C + i * kTPR + part] =
        acc[r][i];
  }
}

// ------------------------------------------------------------------ K3
// dK and dV.  Replaces _flash_bwd_dkv_kernel (ops/attention.py:284-350).
// Bound: 4 x 2*D flops per kept pair (0.385 ms at [8,12,1024,64] causal).
// One block per (kv tile, b*h), 256 threads, one key row per four
// threads; Q/dO tiles of 32 rows and their lse/delta stream through
// shared memory.
template <int D, int RPT>
__global__ void __launch_bounds__(Cfg<D, RPT>::THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ kv_lens,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int s_q, int s_k,
                     int causal, float scale) {
  using K = Cfg<D, RPT>;
  constexpr int C = K::C, CPT = K::CPT, THREADS = K::THREADS;
  __shared__ float4 qs[kStream][C];
  __shared__ float4 dos[kStream][C];
  __shared__ float lses[kStream];
  __shared__ float deltas[kStream];

  const int bh = blockIdx.y;
  const int kv_start = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int part = tid % kTPR;
  const int row0 = tid / kTPR;

  const size_t q_off = (size_t)bh * s_q;
  const size_t k_off = (size_t)bh * s_k;
  const float4* q4 = reinterpret_cast<const float4*>(q) + q_off * C;
  const float4* do4 = reinterpret_cast<const float4*>(dout) + q_off * C;
  const float4* k4 = reinterpret_cast<const float4*>(k) + k_off * C;
  const float4* v4 = reinterpret_cast<const float4*>(v) + k_off * C;

  int kv_len = s_k;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[bh / heads], 1), s_k);

  float4 kr[RPT][CPT], vr[RPT][CPT], dk_acc[RPT][CPT], dv_acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int kj = kv_start + row0 + r * K::ROWS_PER_PASS;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const size_t at = (size_t)kj * C + i * kTPR + part;
      kr[r][i] = kj < s_k ? k4[at] : zero4();
      vr[r][i] = kj < s_k ? v4[at] : zero4();
      dk_acc[r][i] = zero4();
      dv_acc[r][i] = zero4();
    }
  }

  // Live query range.  A kv tile wholly past kv_len streams nothing and
  // writes zeros (the JAX kernel's `live` rule); under the causal mask
  // no query before kv_start sees this tile.
  int q_begin = 0;
  if (causal) q_begin = (kv_start / kStream) * kStream;
  const bool dead = kv_lens != nullptr && kv_start >= kv_len;
  const int q_end = dead ? q_begin : s_q;

  for (int q_tile = q_begin; q_tile < q_end; q_tile += kStream) {
    __syncthreads();
    for (int idx = tid; idx < kStream * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      const int qi = q_tile + r;
      qs[r][c] = qi < s_q ? q4[(size_t)qi * C + c] : zero4();
      dos[r][c] = qi < s_q ? do4[(size_t)qi * C + c] : zero4();
    }
    for (int r = tid; r < kStream; r += THREADS) {
      const int qi = q_tile + r;
      lses[r] = qi < s_q ? lse[q_off + qi] : 0.f;
      deltas[r] = qi < s_q ? delta[q_off + qi] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int i_row = 0; i_row < kStream; ++i_row) {
      const int qi = q_tile + i_row;
      float s[RPT], dp[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) s[r] = dp[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 qq = qs[i_row][i * kTPR + part];
        const float4 dd = dos[i_row][i * kTPR + part];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          s[r] = dot4(qq, kr[r][i], s[r]);
          dp[r] = dot4(dd, vr[r][i], dp[r]);
        }
      }
      const float row_lse = lses[i_row], row_delta = deltas[i_row];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        s[r] = row_sum(s[r]);
        dp[r] = row_sum(dp[r]);
        const int kj = kv_start + row0 + r * K::ROWS_PER_PASS;
        bool keep = qi < s_q;
        if (causal) keep = keep && qi >= kj;
        if (kv_lens != nullptr) keep = keep && kj < kv_len;
        const float p = keep ? expf(s[r] * scale - row_lse) : 0.f;
        const float ds = p * (dp[r] - row_delta) * scale;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          axpy4(p, dos[i_row][i * kTPR + part], dv_acc[r][i]);
          axpy4(ds, qs[i_row][i * kTPR + part], dk_acc[r][i]);
        }
      }
    }
  }

  float4* dk4 = reinterpret_cast<float4*>(dk) + k_off * C;
  float4* dv4 = reinterpret_cast<float4*>(dv) + k_off * C;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int kj = kv_start + row0 + r * K::ROWS_PER_PASS;
    if (kj >= s_k) continue;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const size_t at = (size_t)kj * C + i * kTPR + part;
      dk4[at] = dk_acc[r][i];
      dv4[at] = dv_acc[r][i];
    }
  }
}

}  // namespace

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* kv_lens, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int bh, int heads, int s_q, int s_k, int d,
                                int causal, float scale, void* stream) {
  const dim3 grid((s_q + kRows - 1) / kRows, bh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq);
  if (d == 64) {
    flash_bwd_dq_kernel<64, 2><<<grid, Cfg<64, 2>::THREADS, 0, st>>>(
        qf, kf, vf, lens, dof, lf, df, out, heads, s_q, s_k, causal, scale);
  } else if (d == 128) {
    flash_bwd_dq_kernel<128, 1><<<grid, Cfg<128, 1>::THREADS, 0, st>>>(
        qf, kf, vf, lens, dof, lf, df, out, heads, s_q, s_k, causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* kv_lens, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int bh, int heads, int s_q,
                                 int s_k, int d, int causal, float scale,
                                 void* stream) {
  const dim3 grid((s_k + kRows - 1) / kRows, bh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (d == 64) {
    flash_bwd_dkv_kernel<64, 1><<<grid, Cfg<64, 1>::THREADS, 0, st>>>(
        qf, kf, vf, lens, dof, lf, df, dkf, dvf, heads, s_q, s_k, causal,
        scale);
  } else if (d == 128) {
    flash_bwd_dkv_kernel<128, 1><<<grid, Cfg<128, 1>::THREADS, 0, st>>>(
        qf, kf, vf, lens, dof, lf, df, dkf, dvf, heads, s_q, s_k, causal,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
