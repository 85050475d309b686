// Batched diversity-graph adjacency (paper Def. 2): one G^eps per lane.
//
// Replaces the Pallas kernel pairwise_adjacency_pallas
// (src/repro/kernels/pairwise_adjacency.py:46). Where the TPU kernel builds
// one (K, K) adjacency per call and the engine vmaps it, this kernel builds
// all G lanes' (W, W) adjacencies in one launch, each against its own eps:
//
//   out[g, i, j] = sim(x[max(ids[g, i], 0)], x[max(ids[g, j], 0)]) > eps[g]
//
// as uint8, diagonal and padding rows included (the raw tile, like the TPU
// kernel); the wrapper strips the diagonal and applies the validity mask.
//
// Bound on the card: 2*G*W*W*d flops against G*W*d*4 bytes of rows and
// G*W*W bytes out; at d=96 that is ~190 flop per byte of output, so with
// float32 on the CUDA cores it is bound by operations. Each block computes
// one 32 x 32 tile through shared memory (adjacency_tile.cuh), so each row
// is read from device memory once per tile column.
#include "adjacency_tile.cuh"

namespace {

__global__ void adjacency_kernel(const float* __restrict__ x,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ eps,
                                 unsigned char* __restrict__ out, int W, int d,
                                 int metric) {
  __shared__ rt::TileSmem sm;
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * rt::kTile, j0 = blockIdx.x * rt::kTile;
  const int tid = threadIdx.y * rt::kTile + threadIdx.x;
  const int* lane_ids = ids + (size_t)g * W;
  if (tid < rt::kTile) {
    const int i = i0 + tid;
    sm.rid[tid] = i < W ? max(lane_ids[i], 0) : 0;
  } else if (tid < 2 * rt::kTile) {
    const int j = j0 + tid - rt::kTile;
    sm.cid[tid - rt::kTile] = j < W ? max(lane_ids[j], 0) : 0;
  }
  __syncthreads();
  float sims[rt::kTileRowsPerThread];
  rt::tile_sims(x, d, metric, sm, sims);
  const float e = eps[g];
  const int j = j0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < rt::kTileRowsPerThread; ++r) {
    const int i = i0 + threadIdx.y + 8 * r;
    if (i < W && j < W)
      out[((size_t)g * W + i) * W + j] = sims[r] > e ? 1 : 0;
  }
}

}  // namespace

extern "C" int adjacency_batch(const float* x, const int* ids,
                               const float* eps, unsigned char* out, int G,
                               int W, int d, int metric, void* stream) {
  if (G <= 0 || W <= 0) return 0;
  const int tiles = (W + rt::kTile - 1) / rt::kTile;
  adjacency_kernel<<<dim3(tiles, tiles, G), dim3(rt::kTile, 8), 0,
                     (cudaStream_t)stream>>>(x, ids, eps, out, W, d, metric);
  return (int)cudaGetLastError();
}
