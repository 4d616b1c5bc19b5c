// Flash-attention forward for Hopper (sm_90a), float32 or bfloat16 in and
// out (flash_fwd_f32, flash_fwd_bf16), on the tensor cores.
//
// Replaces: ml_trainer_tpu/ops/attention.py::_flash_kernel, launched by
// _flash_forward (pl.pallas_call at ops/attention.py:177).
//
// For q/k/v laid out [B*H, S, D] (row-major, contiguous) it runs the JAX
// kernel's online-softmax recurrence over key tiles, from m = -FLT_MAX,
// l = 0, o = 0:
//   s = (q * scale) . k^T, masked scores REPLACED by -FLT_MAX (never a
//       bias), keys past s_k at -inf;
//   m_new = max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new);
//   l = l * alpha + rowsum p,   o = o * alpha + p . v,   m = m_new;
// then out = o / l and lse = m + log(l).  Masks: diagonal-aligned causal
// (key j kept for query i iff i >= j) and/or keys at or past kv_lens[b]
// dropped (kv_lens clamped to [1, s_k]).  D is 64 or 128; any s_q, s_k.
//
// What bounds it on this card: per kept (query, key) pair two length-D
// products (q.k and p.v), 4*D flops, while q, k, v are read about once.
// At the serving shape [1, 12, 1024, 64] causal that is 6.30 M pairs and
// 1.61 GFLOP against 12.6 MB: bound by operations, 0.00978 ms as
// fp32-accurate tensor-core work (three TF32 products per product,
// 494.7 / 3 TFLOP/s), 0.0241 ms on the fp32 CUDA cores (67 TFLOP/s),
// 0.0038 ms for the bytes.  At the training shape [2, 12, 1024, 64]
// causal, twice that: 0.0196 / 0.0481 / 0.0075 ms.
//
// Why three TF32 products and not one.  TF32 keeps 10 mantissa bits.
// Emulated on the CPU (tests/test_torch_flash_forward.py: this kernel's
// recurrence over 32-key tiles, operands rounded as cvt.rna.tf32.f32
// rounds, float32 sums) at [1, 2, 256, d], d 64 / 128, causal and with
// kv_lens, against the float32 plain forward: one TF32 product gives out
// / lse max abs errors of 2.7e-4 to 1.05e-3, beyond the chip gate (1e-4
// abs); three products (big*small + small*big + big*big) 5.8e-7 to
// 1.2e-6, within 8.5e-7 of a float64 forward (the float32 plain
// forward itself is within 8.1e-7 of it).
//
// What the design does about the bound (K2/K3's design, csrc/flash_bwd.cu):
// - q.k^T and p.v are mma.sync.m16n8k8 TF32 in the 3-product split
//   (csrc/tf32_mma.cuh), fp32 accumulators.  A block owns 64 query rows,
//   one warp per 16.  K and V stream through a 2-stage ring of 32-key
//   tiles in dynamic shared memory, copied with cp.async (16-byte copies;
//   keys past s_k zero-filled by a source size of 0), so the next tile's
//   copy runs under this tile's products.  Rows are padded to D + 4
//   floats: every per-thread fragment load is free of bank conflicts.
// - q * scale is split once, when loaded, into a per-thread fragment
//   store in shared memory (two 16-byte loads per k-step): in registers
//   the split pair would take 64 registers at D=64 and 128 at D=128, and
//   the store keeps three blocks (12 warps) per SM at D=64.  Streamed K/V
//   stay raw fp32 and are split on the fragment load.
// - P stays in registers.  The S accumulator holds columns {2t, 2t+1} of
//   its tile, an A fragment wants {t, t+4}: p.v runs over a permuted k
//   index (V rows 2t and 2t+1), so P needs no shuffle.  The row max and
//   row sum of the online softmax need only the quad's two shuffles.
// - Tiles above the causal diagonal or wholly past kv_lens are never
//   loaded; a warp whose 16 rows a tile's mask drops wholly skips its
//   products (exact: such a tile would add p = 0 with alpha = 1, since
//   every row keeps key 0 in the first tile).  The mask's compares run
//   only on tiles that hold the diagonal or the kv_len edge.
// - bh is gridDim.x (no 65535 cap on B*H); the q tiles are gridDim.y,
//   the longest causal tiles first.  No atomics: results repeat bit for
//   bit.
// Measured (chip_smoke.py, profiler device time, one H100 80GB HBM3 at
// 700 W): 0.0955 ms at [2, 12, 1024, 64] causal, 20.5% of the 3xTF32
// bound, where SDPA's fp32 forward takes 0.192 ms; 0.0665 ms at
// [1, 12, 1024, 64] (14.7%: 192 blocks on 132 SMs, the longest q tiles
// set the time; SDPA 0.141 ms; the fp32 CUDA-core kernel this replaces
// took 0.2375 ms there).  ptxas: 123 registers at D=64 (three blocks per
// SM), 171 at D=128, no spills.
//
// bfloat16 (flash_fwd_bf16, the JAX kernel's bf16 contract: f32 math
// inside, O in bf16, lse in f32): a kernel of its own on the bf16 tensor
// cores, flash_fwd_bf16_kernel, for the same function.
//
// What bounds it: the same two products per kept pair at the bf16 dense
// rate (989 TFLOP/s), against bf16 q, k, v and out (2 bytes a value) and
// f32 lse.  At [2, 12, 1024, 64] causal 0.0038 ms, of the bytes (the
// operations take 0.0033); at BERT-base's [32, 12, 128, 64] with kv_lens
// 0.0061 ms, of the bytes.
//
// The split.  A bf16 x bf16 product is exact in f32, so q.k^T takes one
// bf16 product.  P is f32 in the JAX kernel: it is split where it is
// formed into hi = bf16(P) and lo = bf16(P - hi), and P.v is taken as
// lo.v + hi.v with f32 sums.  Emulated on the CPU
// (tests/test_torch_flash_forward.py, against the float64 function of
// the same inputs, the 2-ulp gate |d| <= 2^-7 |x| + 1e-3 max|x|) at
// [2, 2, 256, d], d 64 and 128, [2, 12, 512, 64] and [4, 12, 128, 64]:
// two terms read 0.23-0.39 of the gate, the output rounding alone (the
// plain bf16 forward reads the same); one term (P rounded to bf16, as
// SDPA does) 0.30-0.62.  One term would pass there, but the per-call
// check of a bf16 GPT-2 step reads 0.87 of the gate with f32 P: two
// terms keep the margin.  So 3 bf16 products per kept pair (the bound
// counts 2).
//
// The design (K2's, csrc/flash_bwd.cu, with the primitives of
// csrc/wgmma_bf16.cuh).  One warpgroup a block owns 64 query rows,
// wgmma's M; the grid is the float32 kernel's (bh on gridDim.x, the q
// tiles on gridDim.y, the longest causal tiles first).  The Q tile is
// staged raw in the 128-byte swizzle; K and V stream through a 3-stage
// cp.async ring of BN rows (64 at D = 64, 32 at D = 128, for registers),
// each thread's copies on a fixed column and swizzle phase, one barrier
// a tile.  S = Q.K^T is one wgmma.m64nBNk16 bf16 -> f32 with both
// operands K-major in shared memory; the scale is applied after it, in
// log2 units: P = ex2.approx(s * scale * log2(e) - m), the running max m
// kept as s * scale * log2(e).  At D = 64 that equals the JAX kernel's
// (q * scale).k (scale = 2^-3 is exact); at D = 128 it differs by f32
// rounding only.  The mask, tested only on the tiles it cuts, sets a
// dropped key's score to -inf, so its P is exactly 0: the causal diagonal
// and keys at or past kv_lens (clamped to [1, s_k]).  Every row keeps key
// 0 in its first tile, so after it m is finite and the row max in any
// later tile is a kept score or -inf (alpha = 1, P = 0): exactly what the
// JAX kernel's finfo.min replacement gives, whose exp(finfo.min - m)
// underflows to 0.  Tiles above the diagonal or wholly past kv_len are
// never loaded; a warp whose 16 rows a tile's mask drops wholly skips its
// softmax (wgmma runs the warpgroup at once, so it still joins the
// products, with P = 0).  The row max and sum take the quad's two
// shuffles; l is summed from the unsplit f32 P.  P.V is two
// wgmma.m64n64k16 a 16-key step and 64 columns, A (lo, then hi) from
// registers, V read MN-major through the transpose bit.  O = acc / l is
// rounded once to bf16, lse = (m + log2 l) ln 2 in f32.  No atomics:
// results repeat bit for bit.
//
// The overlap (FlashAttention-3's within one warpgroup): tile it's S =
// Q.K^T is issued before tile it - 1's O += P.V, and tile it's softmax
// runs while that product does (wgmma.wait_group 1); O is rescaled by
// alpha = 2^(m_old - m_new) once the product is in.  The sums are taken
// in the same order as without it, so the results are the same bits.
// The ring holds 3 stages so that tile it + 1's copy never lands on the
// V that P.V still reads.  Against the same kernel without the overlap
// (2 stages, S then softmax then P.V; scripts/flash_fwd_ab.py, one H100
// 80GB HBM3 at 700 W, device ms): [2, 12, 1024, 64] causal 0.0222
// against 0.0231, [1, 12, 1024, 64] 0.0176 against 0.0192, BERT-base's
// [32, 12, 128, 64] 0.0148 against 0.0155, [2, 8, 1024, 128] 0.0307
// against 0.0349; it loses only where a block has one tile
// ([5467, 12, 64, 64]: 0.784 against 0.709, bound by the bytes, where
// 167 registers a thread leave 3 blocks an SM and 128 left 4).  ptxas:
// 167 registers at D = 64 (3 blocks an SM), 155 at D = 128, no spills;
// capped at 128 (4 blocks) it spills and takes 0.0301 at the first row.
// SDPA's bf16 forward takes 0.0189, 0.0129, 0.0174 and 0.0180 ms there:
// this kernel leads at BERT-base's shape and with kv_lens, trails 1.17x
// at the training shape, 1.37x at [1, 12, 1024, 64] and 1.71x at D = 128
// (32 keys a tile).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kRows = 64;      // query rows a block owns
constexpr int kThreads = 128;  // four warps of 16 query rows
constexpr int kTile = 32;      // keys per streamed K/V tile

template <int D>
struct Fwd {
  static constexpr int KS = D / 8;      // k-steps of q.k^T, n-tiles of p.v
  static constexpr int NT = kTile / 8;  // n-tiles of q.k^T, k-steps of p.v
  static constexpr int LD = D + Elem<float>::kPad;  // padded shared row
  // q's fragment store: KS x {big, small} float4 a thread.
  static constexpr int OWN = KS * 2 * kThreads;
  static constexpr int STAGE = 2 * kTile * LD;  // a K and a V tile
  static constexpr int SMEM = OWN * 16 + 2 * STAGE * (int)sizeof(float);
};

// Copy keys [row0, row0 + kTile) of K and V into a stage; keys at or past
// n are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv(float* dst, const float* k,
                                        const float* v, int row0, int n,
                                        int tid) {
  constexpr int V = Elem<float>::kVec, C = D / V, LD = Fwd<D>::LD;
#pragma unroll
  for (int i = 0; i < kTile * C / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / C, c = idx % C;
    const bool ok = row0 + r < n;
    const size_t off = ok ? (size_t)(row0 + r) * D + c * V : 0;
    cp_async16(dst + r * LD + c * V, k + off, ok);
    cp_async16(dst + kTile * LD + r * LD + c * V, v + off, ok);
  }
}

// Split this thread's A fragments of (q * scale), rows [row0, row0 + 16)
// (zero at or past n), once, into the fragment store.
template <int D>
__device__ __forceinline__ void load_q(float4* own, const float* q, int row0,
                                       int n, float scale, int tid) {
  constexpr int KS = Fwd<D>::KS;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = kk * 8 + t, c1 = c0 + 4;
    const float x[4] = {
        r0 < n ? __fmul_rn(q[(size_t)r0 * D + c0], scale) : 0.f,
        r1 < n ? __fmul_rn(q[(size_t)r1 * D + c0], scale) : 0.f,
        r0 < n ? __fmul_rn(q[(size_t)r0 * D + c1], scale) : 0.f,
        r1 < n ? __fmul_rn(q[(size_t)r1 * D + c1], scale) : 0.f};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], f.big[i], f.small[i]);
    own[(kk * 2) * kThreads + tid] =
        make_float4(__uint_as_float(f.big[0]), __uint_as_float(f.big[1]),
                    __uint_as_float(f.big[2]), __uint_as_float(f.big[3]));
    own[(kk * 2 + 1) * kThreads + tid] = make_float4(
        __uint_as_float(f.small[0]), __uint_as_float(f.small[1]),
        __uint_as_float(f.small[2]), __uint_as_float(f.small[3]));
  }
}

__device__ __forceinline__ FragA q_frag(const float4* own, int kk, int tid) {
  const float4 b = own[(kk * 2) * kThreads + tid];
  const float4 s = own[(kk * 2 + 1) * kThreads + tid];
  FragA f;
  f.big[0] = __float_as_uint(b.x);
  f.big[1] = __float_as_uint(b.y);
  f.big[2] = __float_as_uint(b.z);
  f.big[3] = __float_as_uint(b.w);
  f.small[0] = __float_as_uint(s.x);
  f.small[1] = __float_as_uint(s.y);
  f.small[2] = __float_as_uint(s.z);
  f.small[3] = __float_as_uint(s.w);
  return f;
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_lens,
                 float* __restrict__ out, float* __restrict__ lse,
                 int heads, int s_q, int s_k, int causal, float scale) {
  using F = Fwd<D>;
  constexpr int KS = F::KS, NT = F::NT, LD = F::LD;
  extern __shared__ float4 smem[];
  float4* own = smem;
  float* ring = reinterpret_cast<float*>(smem + F::OWN);
  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int row0 = q_start + warp * 16;  // this warp's first query

  const size_t q_off = (size_t)bh * s_q, k_off = (size_t)bh * s_k;
  const float* kb = k + k_off * D;
  const float* vb = v + k_off * D;

  int live = s_k;  // keys at or past `live` are masked
  if (kv_lens != nullptr) live = min(max(kv_lens[bh / heads], 1), s_k);
  // Live key range, as the JAX kernel's `live` rule: nothing past the
  // causal diagonal of this q block, nothing wholly past kv_len.
  int kv_end = live;
  if (causal) kv_end = min(kv_end, q_start + kRows);
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  if (n_tiles > 0) load_kv<D>(ring, kb, vb, 0, s_k, tid);
  cp_async_commit();
  load_q<D>(own, q + q_off * D, row0, s_q, scale, tid);

  // Rows g (h = 0) and g + 8 (h = 1) of this warp's 16.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  float o[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles)
      load_kv<D>(ring + ((it + 1) & 1) * F::STAGE, kb, vb,
                    (it + 1) * kTile, s_k, tid);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int kv0 = it * kTile;
    // Under the causal mask a tile past this warp's last query is dropped.
    if (!(causal && kv0 > row0 + 15)) {
      const float* ks = ring + (it & 1) * F::STAGE;
      const float* vs = ks + kTile * LD;
      // S = (q * scale) . K^T: B[k][n] = K[n][k], read as key rows 8n + g,
      // columns t and t + 4.
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const FragA a = q_frag(own, kk, tid);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* kr = ks + (n * 8 + g) * LD + kk * 8 + t;
          mma3(s[n], a, split_b(kr[0], kr[4]));
        }
      }
      if (kv0 + kTile > live || (causal && kv0 + kTile - 1 > row0)) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + n * 8 + 2 * t + (e & 1);
            const int qi = row0 + g + 8 * (e >> 1);
            // Keys past the array do not exist (-inf); masked keys are
            // replaced by -FLT_MAX exactly as in the JAX kernel.
            if (col >= s_k)
              s[n][e] = -INFINITY;
            else if (col >= live || (causal && qi < col))
              s[n][e] = -FLT_MAX;
          }
      }
      // The quad (t = 0..3) holds a row's 32 scores.  Every tile holds a
      // key below s_k, so the row max is >= -FLT_MAX and exp never sees
      // -inf - -inf.
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[e >> 1]);  // P
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int nd = 0; nd < KS; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];
      // O += P . V over the permuted k index of each 8-key step j.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const FragA p = acc_as_a(s[j]);
        const float* v0 = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int nd = 0; nd < KS; ++nd)
          mma3(o[nd], p, split_b(v0[nd * 8], v0[LD + nd * 8]));
      }
    }
    __syncthreads();
  }

  float* ob = out + q_off * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + g + 8 * h;
    if (qi >= s_q) continue;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
      store2(ob + (size_t)qi * D + nd * 8 + 2 * t, o[nd][2 * h] / l[h],
             o[nd][2 * h + 1] / l[h]);
    if (t == 0) lse[q_off + qi] = m[h] + logf(l[h]);
  }
}

// ------------------------------------------------------------ bf16 K1
// Its own kernel on the bf16 tensor cores (the design note is at the top
// of this file): wgmma m64nNk16 bf16 -> f32, one warpgroup a block.
template <int D, typename L = Bf16Tile<D>>
constexpr int kBf16Smem = 1024 + L::OWN + 3 * L::STAGE;  // slack, Q, ring

constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ kv_lens, bf16* __restrict__ out,
                      float* __restrict__ lse, int heads, int s_q, int s_k,
                      int causal, float scale) {
  using L = Bf16Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align1024(smem_raw);  // Q: [64, D]
  uint8_t* ring = own + L::OWN;        // 3 stages of K, V: [BN, D] each

  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int row0 = q_start + warp * 16;  // this warp's first query

  const size_t q_off = (size_t)bh * s_q, k_off = (size_t)bh * s_k;
  const bf16* kb = k + k_off * D;
  const bf16* vb = v + k_off * D;

  int live = s_k;  // keys at or past `live` are masked
  if (kv_lens != nullptr) live = min(max(kv_lens[bh / heads], 1), s_k);
  // Live key range, as the JAX kernel's `live` rule: nothing past the
  // causal diagonal of this q block, nothing wholly past kv_len.
  int kv_end = live;
  if (causal) kv_end = min(kv_end, q_start + kWgRows);
  const int n_tiles = (kv_end + L::BN - 1) / L::BN;  // >= 1: live >= 1

  auto stage = [&](int it) { return ring + (it % 3) * L::STAGE; };
  auto fetch = [&](int it) {
    stage_rows<D, L::BN>(stage(it), kb, it * L::BN, s_k, tid);
    stage_rows<D, L::BN>(stage(it) + L::STREAM, vb, it * L::BN, s_k, tid);
  };
  const float scale2 = scale * kLog2e;
  const uint64_t qd = sw128_desc(smem_u32(own), 16);
  // S = Q.K^T over tile it, unscaled; issued, not waited for.
  auto issue_qk = [&](float (&s)[L::SA], int it) {
    const uint64_t kd = sw128_desc(smem_u32(stage(it)), 16);
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk)
      wgmma_ss(s, k_major<kWgRows>(qd, kk), k_major<L::BN>(kd, kk), kk > 0);
    wgmma_commit();
  };

  // Rows g (h = 0) and g + 8 (h = 1) of this warp's 16; m in log2 units.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o_acc[L::CB][32];
#pragma unroll
  for (int c = 0; c < L::CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o_acc[c][e] = 0.f;

  // Tile it's S -> P in place, with m and l moved on; alpha (the
  // rescale of O, applied by the caller once the previous tile's P.V is
  // in) is returned.
  auto softmax = [&](float (&s)[L::SA], int it, float (&alpha)[2]) {
    const int kv0 = it * L::BN;
    alpha[0] = alpha[1] = 1.f;
    // Under the causal mask a tile past this warp's last query is
    // dropped: P = 0, alpha = 1.
    if (causal && kv0 > row0 + 15) {
#pragma unroll
      for (int i = 0; i < L::SA; ++i) s[i] = 0.f;
      return;
    }
    // The mask is evaluated only on tiles that it cuts.
    auto run = [&](auto edge_tag) {
      constexpr bool edge = decltype(edge_tag)::value;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < L::SA; ++i) {
        const int h = (i / 2) % 2;
        if (edge) {
          const int col = kv0 + (i / 4) * 8 + 2 * t + i % 2;
          const int qi = row0 + g + 8 * h;
          if (!(col < live && (!causal || qi >= col))) s[i] = -INFINITY;
        }
        mx[h] = fmaxf(mx[h], s[i]);
      }
      float neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // scale2 > 0: the max of s * scale2 is (max s) * scale2.
        const float m_new = fmaxf(m[h], mx[h] * scale2);
        alpha[h] = exp2_approx(m[h] - m_new);
        m[h] = m_new;
        neg_m[h] = -m_new;
      }
#pragma unroll
      for (int i = 0; i < L::SA; ++i) {
        const int h = (i / 2) % 2;
        s[i] = exp2_approx(fmaf(s[i], scale2, neg_m[h]));  // P
        sum[h] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
    };
    if (kv0 + L::BN > live || (causal && kv0 + L::BN - 1 > row0))
      run(std::true_type());
    else
      run(std::false_type());
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < L::CB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o_acc[c][e] *= alpha[(e / 2) % 2];
  };

  // Tile 0: S, then P (O is 0: no rescale), split in hi + lo.
  stage_rows<D, kWgRows>(own, q + q_off * D, q_start, s_q, tid);
  fetch(0);
  cp_async_commit();
  cp_async_wait0();
  fence_proxy_async();  // the copies, before wgmma reads them
  __syncthreads();
  if (n_tiles > 1) fetch(1);
  cp_async_commit();
  uint32_t hi[L::KB][4], lo[L::KB][4];  // P of the last tile, split
  {
    float s[L::SA], alpha[2];
    fence_regs(s);
    wgmma_fence();
    issue_qk(s, 0);
    wgmma_wait0();
    fence_regs(s);
    softmax(s, 0, alpha);
    split_as_a(s, hi, lo);
  }
  // Tile it's S = Q.K^T is issued before tile it - 1's O += P.V, and its
  // softmax runs while that product does (FlashAttention-3's overlap
  // within a warpgroup); O is rescaled once the product is in.
  for (int it = 1; it < n_tiles; ++it) {
    cp_async_wait0();     // tile it: the one copy in flight
    fence_proxy_async();
    // Tile it is in; every warp is done with tile it - 2, whose stage
    // takes tile it + 1.
    __syncthreads();
    if (it + 1 < n_tiles) fetch(it + 1);
    cp_async_commit();
    float s[L::SA], alpha[2];
    fence_regs(s);
    fence_acc<D>(o_acc);
    wgmma_fence();
    issue_qk(s, it);
    accumulate_bf16<D>(o_acc, hi, lo, smem_u32(stage(it - 1)) + L::STREAM);
    wgmma_commit();
    wgmma_wait1();  // S is in; P.V may still run
    fence_regs(s);
    softmax(s, it, alpha);
    wgmma_wait0();
    fence_acc<D>(o_acc);
    fence_frags(hi);  // read by P.V until here
    fence_frags(lo);
    rescale(alpha);
    split_as_a(s, hi, lo);
  }
  fence_acc<D>(o_acc);
  wgmma_fence();
  accumulate_bf16<D>(o_acc, hi, lo, smem_u32(stage(n_tiles - 1)) + L::STREAM);
  wgmma_commit();
  wgmma_wait0();
  fence_acc<D>(o_acc);

  bf16* ob = out + q_off * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + 8 * r;
    if (qi >= s_q) continue;
#pragma unroll
    for (int c = 0; c < L::CB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = (size_t)qi * D + c * 64 + j * 8 + 2 * t;
        const int e = 4 * j + 2 * r;
        store2(ob + at, o_acc[c][e] / l[r], o_acc[c][e + 1] / l[r]);
      }
    if (t == 0) lse[q_off + qi] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// The kernel of an element type: the 3xTF32 kernel for float32, the bf16
// design for bfloat16.
template <int D, typename T>
struct Kernel;
template <int D>
struct Kernel<D, float> {
  static constexpr int kSmem = Fwd<D>::SMEM;
  static auto get() { return flash_fwd_kernel<D>; }
};
template <int D>
struct Kernel<D, bf16> {
  static constexpr int kSmem = kBf16Smem<D>;
  static auto get() { return flash_fwd_bf16_kernel<D>; }
};

// Allow the kernel its dynamic shared memory (above 48 KB at D=128), then
// launch.
template <int D, typename T>
int launch(dim3 grid, cudaStream_t st, const T* q, const T* k, const T* v,
           const int* lens, T* out, float* lse, int heads, int s_q, int s_k,
           int causal, float scale) {
  const auto kernel = Kernel<D, T>::get();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Kernel<D, T>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, Kernel<D, T>::kSmem, st>>>(
      q, k, v, lens, out, lse, heads, s_q, s_k, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v,
              const void* kv_lens, void* out, void* lse, int bh, int heads,
              int s_q, int s_k, int d, int causal, float scale,
              void* stream) {
  const dim3 grid(bh, (s_q + kRows - 1) / kRows);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  T* ot = static_cast<T*>(out);
  float* lf = static_cast<float*>(lse);
  if (d == 64)
    return launch<64, T>(grid, st, qt, kt, vt, lens, ot, lf, heads, s_q,
                         s_k, causal, scale);
  if (d == 128)
    return launch<128, T>(grid, st, qt, kt, vt, lens, ot, lf, heads, s_q,
                          s_k, causal, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* kv_lens, void* out, void* lse,
                             int bh, int heads, int s_q, int s_k, int d,
                             int causal, float scale, void* stream) {
  return flash_fwd<float>(q, k, v, kv_lens, out, lse, bh, heads, s_q, s_k,
                          d, causal, scale, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* kv_lens, void* out, void* lse,
                              int bh, int heads, int s_q, int s_k, int d,
                              int causal, float scale, void* stream) {
  return flash_fwd<__nv_bfloat16>(q, k, v, kv_lens, out, lse, bh, heads,
                                  s_q, s_k, d, causal, scale, stream);
}
