// Block-wide greedy diverse selection (paper §II-B-2) over one lane, for
// greedy_diversify.cu; fused_round.cu shares its argmax (better, warp_argmax).
//
// k sequential steps: pick the best candidate that is not banned (masked
// argmax, lowest index on ties, as jnp.argmax), then ban the picked row of
// the adjacency and the pick itself. The banned set is a bitmask of
// ceil(W / 32) words in shared memory, so W up to ~1.8 million fits one
// block. The adjacency row is read through `Ban`, which knows its layout.
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

// Row j of a (K, K) uint8 adjacency ORed into the banned bitmask; one warp
// ballot per 32 columns. blockDim.x must be a multiple of 32.
struct BanBytes {
  const unsigned char* adj;
  int K;
  __device__ void operator()(int j, unsigned* banned) const {
    const unsigned char* row = adj + (size_t)j * K;
    const int lane = threadIdx.x & 31;
    for (int base = threadIdx.x & ~31; base < K; base += blockDim.x) {
      const bool v = base + lane < K && row[base + lane] != 0;
      const unsigned w = __ballot_sync(0xffffffffu, v);
      if (lane == 0) banned[base >> 5] |= w;
    }
  }
};

// Writes sel[0..k) (local indices, -1 padded) and, when selsc is not null,
// selsc[0..k) (picked scores, 0 where no pick). `score(i)` is candidate i's
// score, -inf for an invalid candidate. `banned` holds ceil(W/32) words of
// shared memory.
template <class Score, class Ban>
__device__ void greedy_select(int W, int k, const Score& score, const Ban& ban,
                              unsigned* banned, int* sel, float* selsc) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int pick;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int nw = (W + 31) >> 5;
  for (int w = tid; w < nw; w += blockDim.x) banned[w] = 0u;
  __syncthreads();
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < W; i += blockDim.x) {
      if ((banned[i >> 5] >> (i & 31)) & 1u) continue;
      const float v = score(i);
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        const bool ok = bv > -INFINITY;
        pick = ok ? bi : -1;
        sel[t] = pick;
        if (selsc != nullptr) selsc[t] = ok ? bv : 0.0f;
      }
    }
    __syncthreads();
    const int j = pick;
    if (j >= 0) {  // block-uniform
      ban(j, banned);
      __syncthreads();
      if (tid == 0) banned[j >> 5] |= 1u << (j & 31);
    }
    __syncthreads();
  }
}

}  // namespace rt
