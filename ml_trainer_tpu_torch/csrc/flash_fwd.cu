// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces: ml_trainer_tpu/ops/attention.py::_flash_kernel, launched by
// _flash_forward (pl.pallas_call at ops/attention.py:177).
//
// Computes, for q/k/v laid out [B*H, S, D] (row-major, contiguous):
//   out = softmax(mask(q*scale . k^T)) . v     and     lse = m + log(l)
// with the JAX kernel's mask semantics: a diagonal-aligned causal mask
// (key j kept for query i iff i >= j) and an optional per-batch kv_lens
// right-pad mask; masked scores are REPLACED by -FLT_MAX (not -inf), and
// the online-softmax recurrence is the kernel's own (m, l, o kept in f32).
//
// What bounds it on this card: at the serving shapes (GPT-2, [1,12,S,64],
// S 128..1024) the work is 4*S*S*D*H/2 flops for S*D*H*16 bytes, ~S/4
// flops per byte, so from S=512 up it is bound by operations.  This
// version runs them as float32 FMAs on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores: the model serves in fp32, and the TF32
// tensor-core path would change its numbers.
//
// What the design does about it: one thread block per (64-row q block,
// batch*head); the loop over key tiles inside the block replaces the
// TPU's sequential kv grid axis.  K and V tiles are staged through shared
// memory once per block and read by all 64 rows.  Four threads share a
// query row (each holds D/4 of q and of the output accumulator) and, at
// D=64, each thread carries TWO rows, so every 16-byte K or V read from
// shared memory feeds 8 FMAs.  The tile's probabilities go through shared
// memory rather than registers, which keeps the loops rolled and the
// register count low enough for several blocks per SM.  Tiles above the
// causal diagonal or wholly past kv_lens are never loaded, as in the JAX
// kernel.  Tensor cores (bf16), TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kTPR = 4;   // threads per query row
constexpr int kBK = 32;   // keys per tile

template <int D, int RPT>
struct Cfg {
  static constexpr int C = D / 4;                   // float4 chunks per row
  static constexpr int CPT = C / kTPR;              // chunks per thread
  static constexpr int THREADS = kBQ * kTPR / RPT;  // 128 at RPT=2
  static constexpr int ROWS_PER_PASS = kBQ / RPT;   // row stride of a thread
};

template <int D, int RPT>
__global__ void __launch_bounds__(Cfg<D, RPT>::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_lens,
                 float* __restrict__ out, float* __restrict__ lse,
                 int heads, int s_q, int s_k, int causal, float scale) {
  using K = Cfg<D, RPT>;
  constexpr int C = K::C, CPT = K::CPT, THREADS = K::THREADS;
  __shared__ float4 ks[kBK][C];
  __shared__ float4 vs[kBK][C];
  __shared__ float ps[kBQ][kBK + 1];  // +1: rows land on distinct banks

  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int part = tid % kTPR;
  const int row0 = tid / kTPR;  // rows row0 + r * ROWS_PER_PASS

  const float4* q4 = reinterpret_cast<const float4*>(q) + (size_t)bh * s_q * C;
  const float4* k4 = reinterpret_cast<const float4*>(k) + (size_t)bh * s_k * C;
  const float4* v4 = reinterpret_cast<const float4*>(v) + (size_t)bh * s_k * C;

  int kv_len = s_k;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[bh / heads], 1), s_k);

  // Thread `part` owns chunks part, part+4, ...: the four threads of a
  // row read neighbouring 16-byte chunks, so shared reads never clash.
  float4 qr[RPT][CPT], acc[RPT][CPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q_start + row0 + r * K::ROWS_PER_PASS;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < s_q) t = q4[(size_t)qi * C + i * kTPR + part];
      qr[r][i] = make_float4(t.x * scale, t.y * scale, t.z * scale,
                             t.w * scale);
      acc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[r] = -FLT_MAX;
    l[r] = 0.f;
  }

  // Live key range: nothing past the causal diagonal of this q block,
  // nothing wholly past kv_len.
  int kv_end = s_k;
  if (causal) kv_end = min(kv_end, q_start + kBQ);
  if (kv_lens != nullptr) kv_end = min(kv_end, kv_len);

  for (int kv_start = 0; kv_start < kv_end; kv_start += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      const int kr = kv_start + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      ks[r][c] = kr < s_k ? k4[(size_t)kr * C + c] : zero;
      vs[r][c] = kr < s_k ? v4[(size_t)kr * C + c] : zero;
    }
    __syncthreads();

    // Scores.  After the two butterfly shuffles all four threads of a
    // row hold the full dot product; the owner of column j (j % 4 ==
    // part) stores it.
    float m_cur[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) m_cur[r] = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const int col = kv_start + j;
      float d[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) d[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 kk = ks[j][i * kTPR + part];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          d[r] = fmaf(qr[r][i].x, kk.x, d[r]);
          d[r] = fmaf(qr[r][i].y, kk.y, d[r]);
          d[r] = fmaf(qr[r][i].z, kk.z, d[r]);
          d[r] = fmaf(qr[r][i].w, kk.w, d[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
        const int row = row0 + r * K::ROWS_PER_PASS;
        bool keep = true;
        if (causal) keep = q_start + row >= col;
        if (kv_lens != nullptr) keep = keep && col < kv_len;
        // Keys past the array do not exist (-inf); masked keys are
        // replaced by -FLT_MAX exactly as in the JAX kernel.
        const float val = col >= s_k ? -INFINITY : (keep ? d[r] : -FLT_MAX);
        if ((j % kTPR) == part) ps[row][j] = val;
        m_cur[r] = fmaxf(m_cur[r], val);
      }
    }
    __syncwarp();  // a row's four threads are in one warp

    float alpha[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r * K::ROWS_PER_PASS;
      const float m_new = fmaxf(m[r], m_cur[r]);
      alpha[r] = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBK / kTPR; ++jj) {
        const int j = jj * kTPR + part;
        const float p = expf(ps[row][j] - m_new);
        ps[row][j] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[r] = l[r] * alpha[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        acc[r][i].x *= alpha[r]; acc[r][i].y *= alpha[r];
        acc[r][i].z *= alpha[r]; acc[r][i].w *= alpha[r];
      }
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) p[r] = ps[row0 + r * K::ROWS_PER_PASS][j];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 vv = vs[j][i * kTPR + part];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[r][i].x = fmaf(p[r], vv.x, acc[r][i].x);
          acc[r][i].y = fmaf(p[r], vv.y, acc[r][i].y);
          acc[r][i].z = fmaf(p[r], vv.z, acc[r][i].z);
          acc[r][i].w = fmaf(p[r], vv.w, acc[r][i].w);
        }
      }
    }
    // The next tile's score pass overwrites ps: the __syncthreads at the
    // top of the loop orders it after every thread's reads.
  }

  float4* o4 = reinterpret_cast<float4*>(out) + (size_t)bh * s_q * C;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q_start + row0 + r * K::ROWS_PER_PASS;
    if (qi >= s_q) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      o4[(size_t)qi * C + i * kTPR + part] = make_float4(
          acc[r][i].x * inv, acc[r][i].y * inv, acc[r][i].z * inv,
          acc[r][i].w * inv);
    }
    if (part == 0) lse[(size_t)bh * s_q + qi] = m[r] + logf(l[r]);
  }
}

template <int D, int RPT>
void launch(dim3 grid, cudaStream_t st, const float* q, const float* k,
            const float* v, const int* lens, float* out, float* lse,
            int heads, int s_q, int s_k, int causal, float scale) {
  flash_fwd_kernel<D, RPT><<<grid, Cfg<D, RPT>::THREADS, 0, st>>>(
      q, k, v, lens, out, lse, heads, s_q, s_k, causal, scale);
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* kv_lens, void* out, void* lse,
                             int bh, int heads, int s_q, int s_k, int d,
                             int causal, float scale, void* stream) {
  const dim3 grid((s_q + kBQ - 1) / kBQ, bh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  if (d == 64) {
    launch<64, 2>(grid, st, qf, kf, vf, lens, of, lf, heads, s_q, s_k,
                  causal, scale);
  } else if (d == 128) {
    launch<128, 1>(grid, st, qf, kf, vf, lens, of, lf, heads, s_q, s_k,
                   causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
