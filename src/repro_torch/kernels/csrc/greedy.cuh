// The argmax of a greedy step (paper §II-B-2), shared by greedy_diversify.cu
// and fused_round.cu: the best candidate by score, the lowest index on ties,
// as jnp.argmax picks it.
#pragma once

#include <climits>
#include <math.h>

namespace rt {

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

}  // namespace rt
