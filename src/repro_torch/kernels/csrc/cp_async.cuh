// Asynchronous copies into shared memory (sm_80+ cp.async) and the padded
// row stride, shared by pairwise_adjacency.cu and fused_round.cu.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace rt {

// Row stride in shared memory, in floats: whole 16-byte words, an odd number
// of them, so 8 threads reading float4s of 8 consecutive rows hit 8 distinct
// bank groups.
__host__ __device__ constexpr int padded_stride(int w) {
  return 4 * (((w + 3) / 4) | 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace rt
