// Helpers of the decode kernels' split reductions: the ticket that tells
// the last block of a tile to merge (paged_attention.cu, K6), and the
// asynchronous copies with which K6's merge and K7's staging
// (int8_matmul.cu) keep every load of a chunk in flight at once.
//
// Each block of a tile reduces its own slice of the reduction axis and
// writes a partial to a workspace; then every block takes a ticket from the
// tile's counter.  The block that draws the last ticket reads all the
// partials back and merges them in slice order 0..S-1, whatever order the
// blocks finished in, so two calls give the same bits.  The only atomic is
// this integer ticket: no float is ever added atomically.
//
// The counters live in a buffer that the caller zeroes once (one per
// device and stream, ops/kernels/_split.py); the last block resets its
// tile's counter to 0 as it draws the last ticket, so the buffer is all
// zero again when the kernel ends.

#pragma once

#include <cuda_runtime.h>

namespace split_merge {

// Called by every thread of the block once the block's partial is stored.
// Returns, in every thread, whether this block drew the last of `total`
// tickets of `counter` (and so merges).  The caller's stores are made
// visible device-wide before the ticket; the merging block then reads the
// partials with loads that bypass L1 (__ldcg, cp.async.cg).
__device__ __forceinline__ bool last_ticket(unsigned int* counter,
                                            unsigned int total) {
  __shared__ unsigned int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int ticket = atomicAdd(counter, 1u);
    is_last = ticket == total - 1u ? 1u : 0u;
    // Every ticket of the tile has been drawn: reset for the next launch.
    if (is_last) *counter = 0u;
  }
  __syncthreads();
  const bool last = is_last != 0u;
  if (last) __threadfence();
  return last;
}

// Asynchronous copies into shared memory, 16 bytes (cp.async.cg caches at
// L2 only, so a merging block reads other blocks' partials from L2) or 4
// bytes, then one wait for all of them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace split_merge
