// fp32-accurate products on Hopper's TF32 tensor cores ("3xTF32"), and
// the cp.async copies that feed them: the helpers shared by the float32
// flash forward (csrc/flash_fwd.cu, K1) and backward (csrc/flash_bwd.cu,
// K2/K3).  The bf16 kernels of both files (csrc/wgmma_bf16.cuh) use only
// the copies and store2.
//
// A float32 x is split into big = tf32(x) and small = tf32(x - big); a
// product a.b is taken as big.small + small.big + big.big, each an
// mma.sync.m16n8k8 TF32 product with fp32 accumulators.  The dropped
// small.small term and the rounding of small leave ~fp32 accuracy, where
// one TF32 product (10 mantissa bits) does not.
//
// `Elem` holds the elements one 16-byte cp.async moves and the padding of
// a shared row that keeps the fragment loads free of bank conflicts (4
// floats: a row of D + 4 starts 4 words further along each time).
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8):  b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8): c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte copy
  static constexpr int kPad = 4;  // padding of a shared row, elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }

// Two adjacent outputs, rounded once to the output type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// cvt.rna.tf32.f32's rounding (to nearest on the 10 kept mantissa bits,
// ties away from zero) as two integer ops, bit for bit the same on finite
// inputs and faster here: K2/K3 split ~200-290 values a thread per
// stream tile, K1 144.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split A fragment (16 x 8) and B fragment (8 x 8).
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// c += a . b in three TF32 products, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.big, b.small[0], b.small[1]);
  mma(c, a.small, b.big[0], b.big[1]);
  mma(c, a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ FragB split_b(float x0, float x1) {
  FragB b;
  split(x0, b.big[0], b.small[0]);
  split(x1, b.big[1], b.small[1]);
  return b;
}

// An accumulator (columns 2t, 2t+1 of rows g, g+8) as the A fragment of
// the next product over the permuted k index {2t -> t, 2t+1 -> t+4}.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  FragA a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
