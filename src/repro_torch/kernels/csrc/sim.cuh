// Shared similarity arithmetic of every kernel in this directory.
//
// One reduction order for every (u, v) pair: a sequential fused
// multiply-add over d, j = 0 .. d-1, starting from +0. The metric transform
// uses the _rn intrinsics, which the compiler never contracts, so every call
// site rounds the same way. Hence a pair's similarity is bitwise the same in
// the gathered scorer, the corpus scorer, the adjacency tile and the fused
// round, whatever the batch shape around it.
#pragma once

#include <cuda_runtime.h>

namespace rt {

enum Metric { kIP = 0, kCos = 1, kL2 = 2 };

__device__ __forceinline__ float dot_seq(const float* __restrict__ a,
                                         const float* __restrict__ b, int d) {
  float acc = 0.0f;
  for (int j = 0; j < d; ++j) acc = __fmaf_rn(a[j], b[j], acc);
  return acc;
}

// sim from <u, v>, ||u||^2 and ||v||^2, as repro_torch.core.similarity
// composes it: ip = dot; cos = dot / (|u| |v|); l2 = 1 - sqrt(max(uu + vv - 2 dot, 0)).
__device__ __forceinline__ float finish_sim(float dot, float uu, float vv,
                                            int metric) {
  if (metric == kIP) return dot;
  if (metric == kCos) {
    const float un = __fsqrt_rn(fmaxf(uu, 1e-12f));
    const float vn = __fsqrt_rn(fmaxf(vv, 1e-12f));
    return __fdiv_rn(dot, __fmul_rn(un, vn));
  }
  const float d2 = fmaxf(__fsub_rn(__fadd_rn(uu, vv), __fmul_rn(2.0f, dot)), 0.0f);
  return __fsub_rn(1.0f, __fsqrt_rn(d2));
}

}  // namespace rt
