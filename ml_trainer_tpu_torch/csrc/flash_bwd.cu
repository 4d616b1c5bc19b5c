// Flash-attention backward for Hopper (sm_90a), float32 or bfloat16 in
// and out (the _f32 and _bf16 entry points), on the tensor cores: two
// kernels for each element type.
//
// K2, flash_bwd_dq_kernel (float32) and flash_bwd_dq_bf16_kernel,
// replaces ml_trainer_tpu/ops/attention.py::_flash_bwd_dq_kernel
//   (pl.pallas_call at ops/attention.py:385);
// K3, flash_bwd_dkv_kernel and flash_bwd_dkv_bf16_kernel, replaces
//   ml_trainer_tpu/ops/attention.py::_flash_bwd_dkv_kernel
//   (pl.pallas_call at ops/attention.py:403).
//
// For q/k/v/dO laid out [B*H, S, D] (row-major, contiguous) and the
// forward's per-row lse plus delta = rowsum(dO * O) as [B*H, S]:
//   P  = exp(q . k^T * scale - lse), exactly 0 where the mask drops a key
//   dP = dO . v^T,   dS = P * (dP - delta) * scale
//   dQ = dS . k      (K2)        dK = dS^T . q,   dV = P^T . dO   (K3)
// with the JAX kernels' mask (diagonal-aligned causal, key j kept for
// query i iff i >= j, and/or keys at or past kv_lens[b] dropped, kv_lens
// clamped to >= 1) and the JAX backward's scale placement (after the
// product, not on q).  D is 64 or 128; any s_q, s_k (the ragged edge is
// masked and zero-filled).
//
// What bounds them on this card: per kept (query, key) pair K2 does three
// length-D products (q.k, dO.v, dS*k) and K3 four (q.k, dO.v, P*dO,
// dS*q), 2*D flops each, while each kernel reads its inputs about once.
// At the training launch, [2, 12, 1024, 64] causal, that is 12.6 M pairs,
// 4.84 GFLOP (K2) and 6.45 GFLOP (K3) against ~30 MB: both are bound by
// operations.  As fp32-accurate tensor-core work (3 TF32 products per
// product, 494.7 / 3 TFLOP/s) the bounds are 0.0293 ms and 0.0391 ms; on
// the fp32 CUDA cores (67 TFLOP/s) 0.0722 ms and 0.0962 ms.
//
// Why three TF32 products and not one.  TF32 keeps 10 mantissa bits.
// Emulated on the CPU (tests/test_torch_flash_backward.py: operands
// rounded as cvt.rna.tf32.f32 rounds, float32 sums) at [1, 2, 256, d]
// causal against the fp32 plain backward, one TF32 product gives dQ/dK/dV
// max abs errors 1.4e-3 / 1.3e-3 / 1.8e-3 at d=64 (2.1e-3 / 1.7e-3 /
// 2.5e-3 at d=128), beyond the chip gate (atol 2e-4, rtol 1e-4); three
// products (big*small + small*big + big*big, each fp32 x split into
// big = tf32(x) and small = tf32(x - big)) give 8.9e-7 / 1.6e-6 / 4.3e-6
// (3.5e-6 / 3.6e-6 / 8.6e-6), under 1/20 of it.  PyTorch's fp32 SDPA
// backward (the memory-efficient kernel) splits the same way.
//
// What the design does about the bound:
// - Every product is mma.sync.m16n8k8 TF32 in the 3-product split, fp32
//   accumulators.  A block owns 64 rows (queries in K2, keys in K3), one
//   warp per 16; the other side streams through a 2-stage ring of
//   32-row tiles in dynamic shared memory, copied with cp.async (16-byte
//   copies; rows past s_q/s_k are zero-filled by a source size of 0), so
//   the next tile's copy runs under this tile's products.  Rows are
//   padded to D + 4 floats: every per-thread fragment load is free of
//   bank conflicts.
// - The owned operands (q, dO in K2; k, v in K3) are split once, when
//   loaded, into a per-thread fragment store in shared memory (two
//   16-byte loads per k-step), not into registers: in registers the
//   split pair would take 128 of 255 registers at D=64 and all of them
//   at D=128.  Streamed tiles stay raw fp32 and are split on the fragment
//   load: pre-split big/small copies would double the ring (2 blocks per
//   SM at D=64, ~99 KB each, would become 1) and the shared-memory bytes
//   read per product.  The split rounds as cvt.rna.tf32.f32 does, bit for
//   bit, but with two integer ops (to_tf32, csrc/tf32_mma.cuh, shared
//   with K1): with the conversion
//   instruction K2/K3 took 0.517 / 0.670 ms at [8, 12, 1024, 64] causal,
//   with the integer ops 0.449 / 0.578 ms (chip_smoke.py on one H100
//   80GB HBM3 at 700 W).  ptxas: 166 / 177 registers for K2 / K3 at D=64,
//   254 / 240 at D=128, no spills.
// - P and dS stay in registers with no shuffles.  An m16n8k8 accumulator
//   holds columns {2t, 2t+1} of its tile, an A fragment wants {t, t+4}:
//   the next product runs over a permuted k index instead (c0/c1/c2/c3
//   used as a0/a2/a1/a3, B rows 2t and 2t+1 read from shared memory).
//   K3 computes S^T = K.Q^T and dP^T = V.dO^T with its keys as rows, so
//   P^T and dS^T are A operands of P^T.dO and dS^T.Q as they stand; lse
//   and delta are then per column, streamed beside Q/dO.
// - dQ is split from dK/dV so that neither kernel needs atomics: the
//   results repeat bit for bit.  Tiles above the causal diagonal or
//   wholly past kv_lens are never loaded, a warp whose rows a tile's
//   mask drops wholly skips its products, and a kv tile wholly past
//   kv_lens writes zero dK/dV.  The grid's slow axis runs the longest
//   causal tiles first (K2's last q tiles, K3's first kv tiles).
// At [2, 12, 1024, 64] this design reaches 22-23% of the 3xTF32 bound
// (K2 0.131 ms, K3 0.168 ms of device time), 1.41x faster than SDPA's
// fp32 backward for the pair.  wgmma's TF32 form takes only K-major
// operands from shared memory, so the second product of each kernel
// would need transposed copies of the streamed tiles: the next step,
// with TMA.
//
// bfloat16 (flash_bwd_dq_bf16, flash_bwd_dkv_bf16): kernels of their own
// on the bf16 tensor cores, for the JAX kernels' bf16 contract: q, k, v
// and dO bf16, lse and delta f32, P and dS f32, dQ, dK and dV rounded
// once to bf16 (__float2bfloat16_rn), dK/dV exactly 0 past kv_lens.
//
// What bounds them: the same pairs at the bf16 dense rate (989 TFLOP/s)
// and bf16 bytes; at [2, 12, 1024, 64] causal 0.0049 ms (K2) and 0.0065
// ms (K3) of operations.
//
// The split.  A bf16 x bf16 product is exact in f32, so q.k^T and dO.v^T
// take one bf16 product each.  P^T.dO, dS.k and dS^T.q have an f32
// operand: it is split in registers into hi = bf16(x) and lo = bf16(x -
// hi), and the product is taken as lo.B + hi.B with f32 sums.  Emulated
// on the CPU (tests/test_torch_flash_backward.py, float64 reference of
// the same inputs, the 2-ulp gate |d| <= 2^-7 |x| + 1e-3 max|x|) at
// [2, 12, 512, 64] causal: one term (P and dS rounded to bf16, as
// FlashAttention and SDPA do) reaches 1.35 of the gate, two terms 0.39,
// which is the output rounding alone (three terms give the same).  So
// K2 takes 4 bf16 products per kept pair and K3 6 (the function needs 3
// and 4: the bound counts those).
//
// The design.  One warpgroup (4 warps, 128 threads) a block owns 64 rows
// (queries in K2, keys in K3): wgmma's M.  S (K3: S^T = K.Q^T) and dP
// (dP^T = V.dO^T) are wgmma.m64nBNk16 bf16 -> f32 with both operands in
// shared memory, K-major, over a streamed tile of BN rows (64 at D = 64;
// 32 at D = 128, for registers).  Their f32 accumulators hold, element
// for element, wgmma's register A fragment (rows g and g + 8, columns 2t,
// 2t + 1 of each 8 wide block), so P and dS are split where they are
// formed and never touch shared memory; dQ, dK and dV accumulate with
// m64n64k16, A from registers and B the streamed tile read MN-major (the
// descriptor's transpose bit, which bf16 allows and TF32 does not).
// Streamed and owned tiles are staged raw, never widened: 16-byte
// cp.async copies write the 128-byte swizzle that the descriptors read
// (rows of 64 bf16, chunk c of row r at c ^ (r % 8)), the streamed ones
// through a 2-stage ring, the next tile's copy under this tile's
// products, one barrier a tile.  The instructions between the products
// set the pace, not the tensor cores (scripts/flash_bwd_ab.py on one
// H100 80GB HBM3 at 700 W, K2 + K3 at [2, 12, 1024, 64]): 0.138 ms with
// expf and the mask tested on every element; 0.063 with P = 2^(s *
// scale * log2 e - lse * log2 e) on ex2.approx, the mask tested only on
// the tiles that it cuts and the scale applied to dQ and dK once at the
// end; 0.052 with each thread's copies on a fixed column and swizzle
// phase (the generic copy loop had compiled to division and remainder
// code) and the descriptors built once a tile.  The causal and kv_lens
// tile ranges, the grid order and the zero dK/dV of a dead tile are the
// float32 kernels'; wgmma runs a warpgroup at once, so a warp that a
// tile's mask drops wholly skips only its elementwise work.  ptxas: 146
// / 213 registers for K2 / K3 at D = 64, 131 / 213 at D = 128, no
// spills: 3 and 2 blocks an SM at D = 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kRows = 64;     // rows a block owns (queries in K2, keys in K3)
constexpr int kThreads = 128;  // four warps of 16 owned rows
constexpr int kStream = 32;   // streamed rows per tile

template <int D, typename T>
struct Tile {
  static constexpr int KS = D / 8;          // k-steps over the head dim
  static constexpr int NT = kStream / 8;    // 8-row tiles of a stream tile
  static constexpr int LD = D + Elem<T>::kPad;  // padded shared row
  // Owned fragment store: 2 operands x KS x {big, small} float4 a thread.
  static constexpr int OWN = 2 * KS * 2 * kThreads;
  static constexpr int STAGE = 2 * kStream * LD;  // two streamed operands
  // Bytes: store, 2 stages, and (K3) lse/delta for 2 stages.
  static constexpr int SMEM =
      OWN * 16 + 2 * STAGE * (int)sizeof(T) + 2 * 2 * kStream * 4;
};

// Copy rows [row0, row0 + kStream) of two [n, D] operands into a stage;
// rows at or past n are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_stream(T* dst, const T* a, const T* b,
                                            int row0, int n, int tid) {
  constexpr int V = Elem<T>::kVec, C = D / V, LD = Tile<D, T>::LD;
#pragma unroll
  for (int idx = tid; idx < kStream * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const bool ok = row0 + r < n;
    const size_t off = ok ? (size_t)(row0 + r) * D + c * V : 0;
    cp_async16(dst + r * LD + c * V, a + off, ok);
    cp_async16(dst + kStream * LD + r * LD + c * V, b + off, ok);
  }
}

// Split this thread's A fragments of rows [row0, row0 + 16) of two
// [n, D] operands once, into the fragment store.
template <int D, typename T>
__device__ __forceinline__ void load_owned(float4* own, const T* a,
                                           const T* b, int row0, int n,
                                           int tid) {
  constexpr int KS = Tile<D, T>::KS;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const T* x = o == 0 ? a : b;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c0 = kk * 8 + t, c1 = c0 + 4;
      const float v[4] = {
          r0 < n ? to_f32(x[(size_t)r0 * D + c0]) : 0.f,
          r1 < n ? to_f32(x[(size_t)r1 * D + c0]) : 0.f,
          r0 < n ? to_f32(x[(size_t)r0 * D + c1]) : 0.f,
          r1 < n ? to_f32(x[(size_t)r1 * D + c1]) : 0.f};
      FragA f;
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], f.big[i], f.small[i]);
      own[((o * KS + kk) * 2) * kThreads + tid] =
          make_float4(__uint_as_float(f.big[0]), __uint_as_float(f.big[1]),
                      __uint_as_float(f.big[2]), __uint_as_float(f.big[3]));
      own[((o * KS + kk) * 2 + 1) * kThreads + tid] = make_float4(
          __uint_as_float(f.small[0]), __uint_as_float(f.small[1]),
          __uint_as_float(f.small[2]), __uint_as_float(f.small[3]));
    }
  }
}

template <int D>
__device__ __forceinline__ FragA owned_frag(const float4* own, int o, int kk,
                                            int tid) {
  constexpr int KS = D / 8;
  const float4 b = own[((o * KS + kk) * 2) * kThreads + tid];
  const float4 s = own[((o * KS + kk) * 2 + 1) * kThreads + tid];
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

// S = X . Y^T and dP = dX . dY^T over a stream tile: the owned operands
// from the store (operands 0 and 1), the streamed rows Y, dY from shared
// memory (B[k][n] = Y[n][k], read as rows 8n + g, columns t and t + 4).
template <int D, typename T>
__device__ __forceinline__ void scores(const float4* own, const T* ys,
                                       const T* dys, int tid,
                                       float (&s)[Tile<D, T>::NT][4],
                                       float (&dp)[Tile<D, T>::NT][4]) {
  constexpr int KS = Tile<D, T>::KS, NT = Tile<D, T>::NT;
  constexpr int LD = Tile<D, T>::LD;
  const int g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const FragA x = owned_frag<D>(own, 0, kk, tid);
    const FragA dx = owned_frag<D>(own, 1, kk, tid);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* yr = ys + (n * 8 + g) * LD + kk * 8 + t;
      mma3(s[n], x, split_b(to_f32(yr[0]), to_f32(yr[4])));
      const T* dyr = dys + (n * 8 + g) * LD + kk * 8 + t;
      mma3(dp[n], dx, split_b(to_f32(dyr[0]), to_f32(dyr[4])));
    }
  }
}

// acc += A . Z for the A fragment of 8-wide k-step j (a permuted
// accumulator) and the streamed rows Z (B rows 2t and 2t + 1 of k-step j).
template <int D, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[Tile<D, T>::KS][4],
                                           const FragA& a, const T* zs,
                                           int j, int tid) {
  constexpr int KS = Tile<D, T>::KS, LD = Tile<D, T>::LD;
  const int g = (tid % 32) / 4, t = tid % 4;
  const T* z0 = zs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
    mma3(acc[nd], a, split_b(to_f32(z0[nd * 8]), to_f32(z0[LD + nd * 8])));
}

// ------------------------------------------------------------------ K2
// dQ.  Replaces _flash_bwd_dq_kernel (ops/attention.py:221-281).  Bound:
// 3 x 2*D flops per kept pair.  One block per (b*h, q tile), the longest
// causal tiles first; K/V tiles of 32 rows stream through the ring.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ kv_lens,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int s_q, int s_k, int causal, float scale) {
  using L = Tile<D, T>;
  constexpr int KS = L::KS, NT = L::NT;
  extern __shared__ float4 smem[];
  float4* own = smem;
  T* ring = reinterpret_cast<T*>(smem + L::OWN);

  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int row0 = q_start + warp * 16;  // this warp's first query

  const size_t q_off = (size_t)bh * s_q, k_off = (size_t)bh * s_k;
  const T* kb = k + k_off * D;
  const T* vb = v + k_off * D;

  int live = s_k;  // keys at or past `live` are masked
  if (kv_lens != nullptr) live = min(max(kv_lens[bh / heads], 1), s_k);
  // Live key range, as the JAX kernel's `live` rule: nothing past the
  // causal diagonal of this q block, nothing wholly past kv_len.
  int kv_end = live;
  if (causal) kv_end = min(kv_end, q_start + kRows);
  const int n_tiles = (kv_end + kStream - 1) / kStream;

  if (n_tiles > 0) load_stream<D, T>(ring, kb, vb, 0, s_k, tid);
  cp_async_commit();
  load_owned<D, T>(own, q + q_off * D, dout + q_off * D, row0, s_q, tid);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + g + 8 * h;
    row_lse[h] = qi < s_q ? lse[q_off + qi] : 0.f;
    row_delta[h] = qi < s_q ? delta[q_off + qi] : 0.f;
  }

  float acc[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles)
      load_stream<D, T>(ring + ((it + 1) & 1) * L::STAGE, kb, vb,
                        (it + 1) * kStream, s_k, tid);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int kv0 = it * kStream;
    // Under the causal mask a tile past this warp's last query is dropped.
    if (!(causal && kv0 > row0 + 15)) {
      const T* ks = ring + (it & 1) * L::STAGE;
      const T* vs = ks + kStream * L::LD;
      float s[NT][4], dp[NT][4];
      scores<D, T>(own, ks, vs, tid, s, dp);
      const bool edge = kv0 + kStream > live || (causal && kv0 + kStream - 1 > row0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, col = kv0 + n * 8 + 2 * t + (e & 1);
          const int qi = row0 + g + 8 * h;
          const bool keep = !edge || (col < live && (!causal || qi >= col));
          const float p = keep ? expf(s[n][e] * scale - row_lse[h]) : 0.f;
          s[n][e] = p * (dp[n][e] - row_delta[h]) * scale;  // dS
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        accumulate<D, T>(acc, acc_as_a(s[j]), ks, j, tid);
    }
    __syncthreads();
  }

  T* out = dq + q_off * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + g + 8 * h;
    if (qi >= s_q) continue;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
      store2(out + (size_t)qi * D + nd * 8 + 2 * t, acc[nd][2 * h],
             acc[nd][2 * h + 1]);
  }
}

// ------------------------------------------------------------------ K3
// dK and dV.  Replaces _flash_bwd_dkv_kernel (ops/attention.py:284-350).
// Bound: 4 x 2*D flops per kept pair.  One block per (b*h, kv tile), the
// longest causal tiles first; Q/dO tiles of 32 rows and their lse/delta
// stream through the ring.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ kv_lens,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int s_q, int s_k,
                     int causal, float scale) {
  using L = Tile<D, T>;
  constexpr int KS = L::KS, NT = L::NT;
  extern __shared__ float4 smem[];
  float4* own = smem;
  T* ring = reinterpret_cast<T*>(smem + L::OWN);
  // [stage][lse | delta][kStream], after the ring.
  float* rows = reinterpret_cast<float*>(ring + 2 * L::STAGE);

  const int bh = blockIdx.x;
  const int kv_start = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int row0 = kv_start + warp * 16;  // this warp's first key

  const size_t q_off = (size_t)bh * s_q, k_off = (size_t)bh * s_k;
  const T* qb = q + q_off * D;
  const T* dob = dout + q_off * D;

  int live = s_k;
  if (kv_lens != nullptr) live = min(max(kv_lens[bh / heads], 1), s_k);
  // Live query range.  A kv tile wholly past kv_len streams nothing and
  // writes zeros (the JAX kernel's `live` rule); under the causal mask
  // no query before kv_start sees this tile.
  const int q_begin = causal ? kv_start : 0;
  const int q_end = kv_start >= live ? q_begin : s_q;
  const int n_tiles = max(0, (q_end - q_begin + kStream - 1) / kStream);

  auto fetch = [&](int it) {
    const int q0 = q_begin + it * kStream;
    load_stream<D, T>(ring + (it & 1) * L::STAGE, qb, dob, q0, s_q, tid);
    if (tid < 2 * kStream) {
      const int r = tid % kStream, which = tid / kStream;
      const bool ok = q0 + r < s_q;
      cp_async4(rows + (it & 1) * 2 * kStream + which * kStream + r,
                (which == 0 ? lse : delta) + q_off + (ok ? q0 + r : 0), ok);
    }
  };
  if (n_tiles > 0) fetch(0);
  cp_async_commit();
  load_owned<D, T>(own, k + k_off * D, v + k_off * D, row0, s_k, tid);

  float dk_acc[KS][4], dv_acc[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) fetch(it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int q0 = q_begin + it * kStream;
    // Under the causal mask a tile wholly before this warp's first key
    // is dropped.
    if (!(causal && q0 + kStream - 1 < row0)) {
      const T* qs = ring + (it & 1) * L::STAGE;
      const T* dos = qs + kStream * L::LD;
      const float* lses = rows + (it & 1) * 2 * kStream;
      const float* deltas = lses + kStream;
      float s[NT][4], dp[NT][4];  // S^T and dP^T: keys x queries
      scores<D, T>(own, qs, dos, tid, s, dp);
      const bool edge = q0 + kStream > s_q || row0 + 16 > live ||
                        (causal && q0 < row0 + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), qi = q0 + c;
          const int kj = row0 + g + 8 * (e / 2);
          const bool keep = !edge || (qi < s_q && kj < live &&
                                      (!causal || qi >= kj));
          const float p = keep ? expf(s[n][e] * scale - lses[c]) : 0.f;
          s[n][e] = p;                                    // P^T
          dp[n][e] = p * (dp[n][e] - deltas[c]) * scale;  // dS^T
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        accumulate<D, T>(dv_acc, acc_as_a(s[j]), dos, j, tid);
        accumulate<D, T>(dk_acc, acc_as_a(dp[j]), qs, j, tid);
      }
    }
    __syncthreads();
  }

  T* dk_out = dk + k_off * D;
  T* dv_out = dv + k_off * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = row0 + g + 8 * h;
    if (kj >= s_k) continue;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      const size_t at = (size_t)kj * D + nd * 8 + 2 * t;
      store2(dk_out + at, dk_acc[nd][2 * h], dk_acc[nd][2 * h + 1]);
      store2(dv_out + at, dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ bf16 K2/K3
// Their own kernels on the bf16 tensor cores (the design note is at the top
// of this file): wgmma m64nNk16 bf16 -> f32, one warpgroup a block, with
// the primitives of csrc/wgmma_bf16.cuh.

// Bytes of shared memory: alignment slack, the owned pair, 2 stages, and
// (K3) lse/delta for 2 stages.
template <int D, typename L = Bf16Tile<D>>
constexpr int kBf16Smem = 1024 + 2 * L::OWN + 2 * L::STAGE + 2 * 2 * L::BN * 4;

// S = X . Y^T and dP = dX . dY^T (m64nBN) for the owned [64, D] tiles X,
// dX and the streamed [BN, D] tiles Y, dY: one bf16 product each.
template <int D, int SA = Bf16Tile<D>::SA, int BN = Bf16Tile<D>::BN>
__device__ __forceinline__ void scores_bf16(uint32_t x, uint32_t dx,
                                            uint32_t y, uint32_t dy,
                                            float (&s)[SA], float (&dp)[SA]) {
  const uint64_t xd = sw128_desc(x, 16), dxd = sw128_desc(dx, 16);
  const uint64_t yd = sw128_desc(y, 16), dyd = sw128_desc(dy, 16);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Bf16Tile<D>::KS; ++kk) {
    wgmma_ss(s, k_major<kRows>(xd, kk), k_major<BN>(yd, kk), kk > 0);
    wgmma_ss(dp, k_major<kRows>(dxd, kk), k_major<BN>(dyd, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);
  fence_regs(dp);
}

// K2 in bf16: dQ.  The grid, tile ranges and masks of flash_bwd_dq_kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ kv_lens,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int heads, int s_q, int s_k,
                         int causal, float scale) {
  using L = Bf16Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align1024(smem_raw);  // q, then dO: [64, D] each
  uint8_t* ring = own + 2 * L::OWN;    // 2 stages of K, V: [BN, D] each

  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int row0 = q_start + warp * 16;  // this warp's first query

  const size_t q_off = (size_t)bh * s_q, k_off = (size_t)bh * s_k;
  const bf16* kb = k + k_off * D;
  const bf16* vb = v + k_off * D;

  int live = s_k;
  if (kv_lens != nullptr) live = min(max(kv_lens[bh / heads], 1), s_k);
  int kv_end = live;
  if (causal) kv_end = min(kv_end, q_start + kRows);
  const int n_tiles = (kv_end + L::BN - 1) / L::BN;

  auto fetch = [&](int it) {
    uint8_t* st = ring + (it & 1) * L::STAGE;
    stage_rows<D, L::BN>(st, kb, it * L::BN, s_k, tid);
    stage_rows<D, L::BN>(st + L::STREAM, vb, it * L::BN, s_k, tid);
  };
  stage_rows<D, kRows>(own, q + q_off * D, q_start, s_q, tid);
  stage_rows<D, kRows>(own + L::OWN, dout + q_off * D, q_start, s_q, tid);
  if (n_tiles > 0) fetch(0);
  cp_async_commit();
  const float scale2 = scale * kLog2e;
  float row_lse2[2], row_delta[2];  // lse * log2(e), delta of rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + g + 8 * h;
    row_lse2[h] = qi < s_q ? lse[q_off + qi] * kLog2e : 0.f;
    row_delta[h] = qi < s_q ? delta[q_off + qi] : 0.f;
  }

  float dq_acc[L::CB][32];
#pragma unroll
  for (int c = 0; c < L::CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq_acc[c][e] = 0.f;
  const uint32_t own_q = smem_u32(own), own_do = own_q + L::OWN;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait0();     // tile it: the one copy in flight
    fence_proxy_async();  // the copies, before wgmma reads them
    // Tile it is in; every warp is done with tile it - 1, whose stage
    // takes tile it + 1.
    __syncthreads();
    if (it + 1 < n_tiles) fetch(it + 1);
    cp_async_commit();
    const int kv0 = it * L::BN;
    const uint32_t ks = smem_u32(ring + (it & 1) * L::STAGE);
    const uint32_t vs = ks + L::STREAM;
    float s[L::SA], dp[L::SA];
    scores_bf16<D>(own_q, own_do, ks, vs, s, dp);
    // Under the causal mask a tile past this warp's last query is dropped.
    if (causal && kv0 > row0 + 15) {
#pragma unroll
      for (int i = 0; i < L::SA; ++i) s[i] = 0.f;
    } else {
      // The mask is evaluated only on tiles that it cuts.
      auto to_ds = [&](auto edge_tag) {
        constexpr bool edge = decltype(edge_tag)::value;
#pragma unroll
        for (int i = 0; i < L::SA; ++i) {
          const int h = (i / 2) % 2, col = kv0 + (i / 4) * 8 + 2 * t + i % 2;
          const int qi = row0 + g + 8 * h;
          const bool keep = !edge || (col < live && (!causal || qi >= col));
          const float p =
              keep ? exp2_approx(fmaf(s[i], scale2, -row_lse2[h])) : 0.f;
          s[i] = p * (dp[i] - row_delta[h]);  // dS / scale
        }
      };
      if (kv0 + L::BN > live || (causal && kv0 + L::BN - 1 > row0))
        to_ds(std::true_type());
      else
        to_ds(std::false_type());
    }
    uint32_t hi[L::KB][4], lo[L::KB][4];
    split_as_a(s, hi, lo);
    fence_acc<D>(dq_acc);
    wgmma_fence();
    accumulate_bf16<D>(dq_acc, hi, lo, ks);
    wgmma_commit();
    wgmma_wait0();
    fence_acc<D>(dq_acc);
  }

  bf16* dq_out = dq + q_off * D;
#pragma unroll
  for (int c = 0; c < L::CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq_acc[c][e] *= scale;
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
        store2(dq_out + at, dq_acc[c][e], dq_acc[c][e + 1]);
      }
  }
}

// K3 in bf16: dK and dV.  The grid, tile ranges and masks of
// flash_bwd_dkv_kernel; S^T = K.Q^T and dP^T = V.dO^T with the keys as
// rows, so P^T and dS^T are A operands of P^T.dO and dS^T.Q as they stand.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ kv_lens,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int heads, int s_q, int s_k, int causal,
                          float scale) {
  using L = Bf16Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align1024(smem_raw);  // k, then v: [64, D] each
  uint8_t* ring = own + 2 * L::OWN;    // 2 stages of Q, dO: [BN, D] each
  // [stage][lse | delta][BN], after the ring.
  float* rows = reinterpret_cast<float*>(ring + 2 * L::STAGE);

  const int bh = blockIdx.x;
  const int kv_start = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int row0 = kv_start + warp * 16;  // this warp's first key

  const size_t q_off = (size_t)bh * s_q, k_off = (size_t)bh * s_k;
  const bf16* qb = q + q_off * D;
  const bf16* dob = dout + q_off * D;

  int live = s_k;
  if (kv_lens != nullptr) live = min(max(kv_lens[bh / heads], 1), s_k);
  const int q_begin = causal ? kv_start : 0;
  const int q_end = kv_start >= live ? q_begin : s_q;
  const int n_tiles = max(0, (q_end - q_begin + L::BN - 1) / L::BN);

  auto fetch = [&](int it) {
    const int q0 = q_begin + it * L::BN;
    uint8_t* st = ring + (it & 1) * L::STAGE;
    stage_rows<D, L::BN>(st, qb, q0, s_q, tid);
    stage_rows<D, L::BN>(st + L::STREAM, dob, q0, s_q, tid);
    if (tid < 2 * L::BN) {
      const int r = tid % L::BN, which = tid / L::BN;
      const bool ok = q0 + r < s_q;
      cp_async4(rows + (it & 1) * 2 * L::BN + which * L::BN + r,
                (which == 0 ? lse : delta) + q_off + (ok ? q0 + r : 0), ok);
    }
  };
  if (n_tiles > 0) {  // a tile wholly past kv_len loads nothing
    stage_rows<D, kRows>(own, k + k_off * D, kv_start, s_k, tid);
    stage_rows<D, kRows>(own + L::OWN, v + k_off * D, kv_start, s_k, tid);
    fetch(0);
  }
  cp_async_commit();

  float dk_acc[L::CB][32], dv_acc[L::CB][32];
#pragma unroll
  for (int c = 0; c < L::CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;
  const uint32_t own_k = smem_u32(own), own_v = own_k + L::OWN;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait0();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) fetch(it + 1);
    cp_async_commit();
    const int q0 = q_begin + it * L::BN;
    const uint32_t qs = smem_u32(ring + (it & 1) * L::STAGE);
    const uint32_t dos = qs + L::STREAM;
    const float* lses = rows + (it & 1) * 2 * L::BN;
    const float* deltas = lses + L::BN;
    float s[L::SA], dp[L::SA];  // S^T and dP^T: keys x queries
    scores_bf16<D>(own_k, own_v, qs, dos, s, dp);
    // Under the causal mask a tile wholly before this warp's first key
    // is dropped.
    if (causal && q0 + L::BN - 1 < row0) {
#pragma unroll
      for (int i = 0; i < L::SA; ++i) s[i] = dp[i] = 0.f;
    } else {
      // The mask is evaluated only on tiles that it cuts.
      auto to_p_ds = [&](auto edge_tag) {
        constexpr bool edge = decltype(edge_tag)::value;
#pragma unroll
        for (int n = 0; n < L::SA / 4; ++n) {  // 8-wide column blocks
          const int c0 = n * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lses + c0);
          const float2 d2 = *reinterpret_cast<const float2*>(deltas + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e, qi = q0 + c0 + e % 2;
            const int kj = row0 + g + 8 * (e / 2);
            const bool keep = !edge || (qi < s_q && kj < live &&
                                        (!causal || qi >= kj));
            const float lse2 = -kLog2e * (e % 2 ? l2.y : l2.x);
            const float p =
                keep ? exp2_approx(fmaf(s[i], scale2, lse2)) : 0.f;
            s[i] = p;                                         // P^T
            dp[i] = p * (dp[i] - (e % 2 ? d2.y : d2.x));  // dS^T / scale
          }
        }
      };
      if (q0 + L::BN > s_q || row0 + 16 > live || (causal && q0 < row0 + 15))
        to_p_ds(std::true_type());
      else
        to_p_ds(std::false_type());
    }
    uint32_t p_hi[L::KB][4], p_lo[L::KB][4], ds_hi[L::KB][4], ds_lo[L::KB][4];
    split_as_a(s, p_hi, p_lo);
    split_as_a(dp, ds_hi, ds_lo);
    fence_acc<D>(dk_acc);
    fence_acc<D>(dv_acc);
    wgmma_fence();
    accumulate_bf16<D>(dv_acc, p_hi, p_lo, dos);
    accumulate_bf16<D>(dk_acc, ds_hi, ds_lo, qs);
    wgmma_commit();
    wgmma_wait0();
    fence_acc<D>(dk_acc);
    fence_acc<D>(dv_acc);
  }

  bf16* dk_out = dk + k_off * D;
#pragma unroll
  for (int c = 0; c < L::CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[c][e] *= scale;
  bf16* dv_out = dv + k_off * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = row0 + g + 8 * r;
    if (kj >= s_k) continue;
#pragma unroll
    for (int c = 0; c < L::CB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = (size_t)kj * D + c * 64 + j * 8 + 2 * t;
        const int e = 4 * j + 2 * r;
        store2(dk_out + at, dk_acc[c][e], dk_acc[c][e + 1]);
        store2(dv_out + at, dv_acc[c][e], dv_acc[c][e + 1]);
      }
  }
}

// The kernels of an element type: the 3xTF32 template for float32, the
// bf16 design for bfloat16.
template <int D, typename T>
struct Kernels {
  static constexpr int kSmem = Tile<D, T>::SMEM;
  static auto dq() { return flash_bwd_dq_kernel<D, T>; }
  static auto dkv() { return flash_bwd_dkv_kernel<D, T>; }
};
template <int D>
struct Kernels<D, bf16> {
  static constexpr int kSmem = kBf16Smem<D>;
  static auto dq() { return flash_bwd_dq_bf16_kernel<D>; }
  static auto dkv() { return flash_bwd_dkv_bf16_kernel<D>; }
};

// Allow the kernel its dynamic shared memory (above 48 KB), then launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int bytes, dim3 grid, cudaStream_t st,
           Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, bytes, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* kv_lens,
           const void* dout, const void* lse, const void* delta, void* dq,
           int bh, int heads, int s_q, int s_k, int d, int causal,
           float scale, void* stream) {
  const dim3 grid(bh, (s_q + kRows - 1) / kRows);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  const T* dot = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  T* out = static_cast<T*>(dq);
  if (d == 64)
    return launch(Kernels<64, T>::dq(), Kernels<64, T>::kSmem, grid, st, qt,
                  kt, vt, lens, dot, lf, df, out, heads, s_q, s_k, causal,
                  scale);
  if (d == 128)
    return launch(Kernels<128, T>::dq(), Kernels<128, T>::kSmem, grid, st,
                  qt, kt, vt, lens, dot, lf, df, out, heads, s_q, s_k,
                  causal, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* kv_lens,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, int bh, int heads, int s_q, int s_k, int d, int causal,
            float scale, void* stream) {
  const dim3 grid(bh, (s_k + kRows - 1) / kRows);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  const T* dot = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if (d == 64)
    return launch(Kernels<64, T>::dkv(), Kernels<64, T>::kSmem, grid, st, qt,
                  kt, vt, lens, dot, lf, df, dkt, dvt, heads, s_q, s_k,
                  causal, scale);
  if (d == 128)
    return launch(Kernels<128, T>::dkv(), Kernels<128, T>::kSmem, grid, st,
                  qt, kt, vt, lens, dot, lf, df, dkt, dvt, heads, s_q, s_k,
                  causal, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, kv_lens|NULL, dout, lse, delta, dq, bh, heads, s_q, s_k, d,
// causal, scale, stream
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* kv_lens, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int bh, int heads, int s_q, int s_k, int d,
                                int causal, float scale, void* stream) {
  return bwd_dq<float>(q, k, v, kv_lens, dout, lse, delta, dq, bh, heads,
                       s_q, s_k, d, causal, scale, stream);
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_lens, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq, int bh, int heads, int s_q,
                                 int s_k, int d, int causal, float scale,
                                 void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, v, kv_lens, dout, lse, delta, dq, bh,
                               heads, s_q, s_k, d, causal, scale, stream);
}

// q, k, v, kv_lens|NULL, dout, lse, delta, dk, dv, bh, heads, s_q, s_k, d,
// causal, scale, stream
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* kv_lens, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int bh, int heads, int s_q,
                                 int s_k, int d, int causal, float scale,
                                 void* stream) {
  return bwd_dkv<float>(q, k, v, kv_lens, dout, lse, delta, dk, dv, bh,
                        heads, s_q, s_k, d, causal, scale, stream);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* kv_lens,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int heads, int s_q, int s_k, int d,
                                  int causal, float scale, void* stream) {
  return bwd_dkv<__nv_bfloat16>(q, k, v, kv_lens, dout, lse, delta, dk, dv,
                                bh, heads, s_q, s_k, d, causal, scale,
                                stream);
}
