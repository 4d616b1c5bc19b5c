// Hopper's bf16 tensor cores for the flash kernels' bf16 entry points:
// the wgmma primitives and the tile layout shared by the bf16 forward
// (csrc/flash_fwd.cu, K1) and the bf16 backward (csrc/flash_bwd.cu,
// K2/K3).  The design notes are at the top of those files.
//
// One warpgroup (4 warps, 128 threads) a block owns 64 rows, wgmma's M.
// A [ROWS, D] bf16 tile is staged raw (16-byte cp.async copies, never
// widened) in the 128-byte swizzle that a wgmma descriptor reads, and one
// copy serves both readings: K-major (the rows as wgmma's M or N, the
// head dim as its k: S = X.Y^T) and MN-major (the rows as k, the head
// dim as N, through the descriptor's transpose bit: acc += A.Z).  wgmma's
// m64nN f32 accumulator holds, element for element, its register A
// fragment (rows g and g + 8 of the warp's 16, columns 8n + 2t, 8n + 2t +
// 1; g = lane / 4, t = lane % 4), so an f32 product such as P is split
// into hi + lo bf16 terms where it is formed (split_as_a) and feeds the
// next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

using bf16 = __nv_bfloat16;

constexpr int kWgRows = 64;      // rows a warpgroup owns: wgmma's M
constexpr int kWgThreads = 128;  // one warpgroup

template <int D>
struct Bf16Tile {
  static constexpr int BN = D == 64 ? 64 : 32;  // streamed rows per tile
  static constexpr int SA = BN / 2;    // m64nBN floats a thread (S, dP)
  static constexpr int KB = BN / 16;   // k16-steps over the streamed rows
  static constexpr int KS = D / 16;    // k16-steps over the head dim
  static constexpr int CB = D / 64;    // 128-byte column blocks
  static constexpr int OWN = kWgRows * D * 2;  // bytes of an owned operand
  static constexpr int STREAM = BN * D * 2;    // bytes of a streamed one
  static constexpr int STAGE = 2 * STREAM;     // a stage: two streamed ones
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 128-byte swizzle repeats every 1024 bytes of shared address.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A [ROWS, D] bf16 tile is D/64 column blocks of ROWS rows of 128 bytes,
// in the 128-byte swizzle a wgmma descriptor reads: 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) of its row.  Byte offset of chunk c
// (elements 8c .. 8c + 7) of row r:
template <int ROWS>
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c / 8) * ROWS * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// Copy rows [row0, row0 + ROWS) of an [n, D] operand raw into a swizzled
// tile; rows at or past n are zero-filled.  A thread copies chunk c of
// rows r0, r0 + STEP, ...: STEP is a multiple of 8, so its chunks share
// one swizzle phase and lie STEP rows apart in the tile too.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const bf16* src,
                                           int row0, int n, int tid) {
  constexpr int C = D / 8;             // 16-byte chunks a row
  constexpr int STEP = kWgThreads / C;  // rows between a thread's chunks
  static_assert(STEP % 8 == 0 && ROWS % STEP == 0, "tile shape");
  const int r0 = tid / C, c = tid % C;
  uint8_t* at = dst + swizzled<ROWS>(r0, c);
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int r = row0 + r0 + i * STEP;
    cp_async16(at + i * STEP * 128, src + (r < n ? (size_t)r * D + c * 8 : 0),
               r < n);
  }
}

// wgmma descriptor of a swizzled tile: start address, leading byte offset
// (between 64-wide column blocks when read MN-major; unused K-major),
// stride byte offset 1024 (between 8-row groups), 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

// A descriptor moved on by `bytes` (a multiple of 16): the start address
// is its low field, and shared addresses stay below 2^18.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, int bytes) {
  return desc + (bytes >> 4);
}

// k16-step kk of a [ROWS, D] tile read K-major (as the A operand, or as B
// = tile^T; desc = sw128_desc(tile, 16)): 32 bytes along the rows of
// column block kk / 4.
template <int ROWS>
__device__ __forceinline__ uint64_t k_major(uint64_t desc, int kk) {
  return desc_at(desc, (kk / 4) * ROWS * 128 + (kk % 4) * 32);
}

// Rows [16j, 16j + 16) and columns [64c, 64c + 64) of a [ROWS, D] tile
// read MN-major (B with the rows as k and the head dim as n; desc =
// sw128_desc(tile, ROWS * 128)).
template <int ROWS>
__device__ __forceinline__ uint64_t mn_major(uint64_t desc, int j, int c) {
  return desc_at(desc, c * ROWS * 128 + j * 2048);
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// All but the newest committed group done.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for register A fragments, which a product reads until it is
// waited for: their registers must not be reused before then.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

// d (+)= A . B, m64n32k16 or m64n64k16: A and B from shared memory, both
// K-major; accumulate = 0 starts the sum.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B, m64n64k16: A from registers (an m16n8k16-style fragment a
// warp), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// x = hi + lo + (under 2^-16 |x|), hi and lo bf16, two values a register.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the multi-function unit (ex2.approx, about 2 ulp): P is taken as
// 2^(s * scale * log2(e) - m), m in log2 units (K1: the running row max;
// K2/K3: lse * log2(e)).  ex2.approx(-inf) is +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// This thread's part of an m64nN accumulator (rows g, g + 8 of its warp's
// 16; columns 8n + 2t, 8n + 2t + 1 in x[4n .. 4n + 3]) as the register A
// fragments of the N/16 k16-steps over its N columns, split in hi and lo:
// wgmma's A fragment holds the same elements, in the same order.
template <int SA>
__device__ __forceinline__ void split_as_a(const float (&x)[SA],
                                           uint32_t (&hi)[SA / 8][4],
                                           uint32_t (&lo)[SA / 8][4]) {
#pragma unroll
  for (int j = 0; j < SA / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
}

// acc += A . Z over one stream tile: A [64, BN] as hi and lo fragments
// (two products, lo first), Z the streamed [BN, D] tile read MN-major.
template <int D, typename L = Bf16Tile<D>>
__device__ __forceinline__ void accumulate_bf16(float (&acc)[L::CB][32],
                                                const uint32_t (&hi)[L::KB][4],
                                                const uint32_t (&lo)[L::KB][4],
                                                uint32_t z) {
  const uint64_t zd = sw128_desc(z, L::BN * 128);
#pragma unroll
  for (int j = 0; j < L::KB; ++j)
#pragma unroll
    for (int c = 0; c < L::CB; ++c) {
      wgmma_rs_n64(acc[c], lo[j], mn_major<L::BN>(zd, j, c));
      wgmma_rs_n64(acc[c], hi[j], mn_major<L::BN>(zd, j, c));
    }
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[Bf16Tile<D>::CB][32]) {
#pragma unroll
  for (int c = 0; c < Bf16Tile<D>::CB; ++c) fence_regs(acc[c]);
}
