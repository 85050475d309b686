// One 32 x 32 tile of pairwise similarities, shared by the adjacency kernel
// and the fused round so that both threshold bitwise-equal sims.
//
// Block shape (32, 8). Thread (tx, ty) owns column tx against rows
// ty, ty + 8, ty + 16, ty + 24 of the tile. The rows' vectors stream through
// shared memory in chunks of 32 features; every dot product and squared
// norm still accumulates j = 0 .. d-1 in order with one fused multiply-add
// per feature, as sim.cuh's dot_seq does.
#pragma once

#include "sim.cuh"

namespace rt {

constexpr int kTile = 32;
constexpr int kTileRowsPerThread = 4;
constexpr int kChunk = 32;

struct TileSmem {
  float a[kTile][kChunk + 1];   // +1: column reads by tx are conflict-free
  float b[kTile][kChunk + 1];
  float sqa[kTile];
  float sqb[kTile];
  int rid[kTile];               // corpus row of each tile row
  int cid[kTile];               // corpus row of each tile column
};

// sims[r] = sim(x[rid[ty + 8 r]], x[cid[tx]]). sm.rid / sm.cid must be set
// and visible (after __syncthreads) on entry.
__device__ __forceinline__ void tile_sims(const float* __restrict__ x, int d,
                                          int metric, TileSmem& sm,
                                          float (&sims)[kTileRowsPerThread]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  float acc[kTileRowsPerThread];
#pragma unroll
  for (int r = 0; r < kTileRowsPerThread; ++r) acc[r] = 0.0f;
  float sq = 0.0f;  // ty == 0: norm of column tx; ty == 1: norm of row tx
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    for (int t = tid; t < kTile * kChunk; t += kTile * 8) {
      const int r = t / kChunk, c = t % kChunk;
      sm.a[r][c] = c < kc ? x[(size_t)sm.rid[r] * d + k0 + c] : 0.0f;
      sm.b[r][c] = c < kc ? x[(size_t)sm.cid[r] * d + k0 + c] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      const float bv = sm.b[tx][c];
#pragma unroll
      for (int r = 0; r < kTileRowsPerThread; ++r)
        acc[r] = __fmaf_rn(sm.a[ty + 8 * r][c], bv, acc[r]);
      if (ty == 0) {
        sq = __fmaf_rn(bv, bv, sq);
      } else if (ty == 1) {
        const float av = sm.a[tx][c];
        sq = __fmaf_rn(av, av, sq);
      }
    }
    __syncthreads();
  }
  if (ty == 0) sm.sqb[tx] = sq;
  if (ty == 1) sm.sqa[tx] = sq;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kTileRowsPerThread; ++r)
    sims[r] = finish_sim(acc[r], sm.sqa[ty + 8 * r], sm.sqb[tx], metric);
}

}  // namespace rt
