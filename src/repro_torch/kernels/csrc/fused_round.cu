// One fused progressive round per lane: prefix mask, candidate gather,
// G^eps adjacency and k greedy steps.
//
// Replaces the Pallas kernel fused_round_batch_pallas
// (src/repro/kernels/fused_round.py:99). Per lane b, candidate i of the raw
// queue prefix is valid when i < Ks[b] and ids[b, i] >= 0; its row is
// x[max(ids_m, 0)] with ids_m the masked prefix (-1 past Ks[b]). The
// adjacency is sim(row_i, row_j) > eps[b]; the greedy loop picks k
// candidates by masked argmax (lowest index on ties) and bans each pick's
// row. Outputs sel (B, k) int32 local indices -1 padded and selsc (B, k)
// float32 picked scores, 0 where no pick.
//
// The TPU kernel keeps the (W, W) int8 adjacency in VMEM. At W = 1024 that
// is 1 MB, far over an SM's 227 KB of shared memory, so this version runs in
// two launches from one call: the first builds the adjacency tile by tile
// (adjacency_tile.cuh, the same sims as pairwise_adjacency.cu) and writes it
// bit-packed, W*W/8 bytes per lane, to a scratch buffer in device memory;
// the second runs greedy.cuh with one block per lane, reading k packed rows.
// Tiles wholly past a lane's Ks[b] are not computed.
//
// Bound on the card: 2*sum_b(Ks[b]^2)*d flops of Gram against Ks*d*4 bytes
// of rows: bound by operations at the widths the engine uses.
#include "adjacency_tile.cuh"
#include "greedy.cuh"

namespace {

__global__ void fused_adj_kernel(const float* __restrict__ x,
                                 const int* __restrict__ ids,
                                 const int* __restrict__ Ks,
                                 const float* __restrict__ eps,
                                 unsigned* __restrict__ adj, int W, int d,
                                 int metric) {
  __shared__ rt::TileSmem sm;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * rt::kTile, j0 = blockIdx.x * rt::kTile;
  const int nw = (W + 31) >> 5;
  const int Kb = min(Ks[b], W);
  unsigned* lane_adj = adj + (size_t)b * W * nw;
  if (i0 >= Kb || j0 >= Kb) {  // block-uniform: the tile holds no valid pair
    if (threadIdx.x == 0) {
#pragma unroll
      for (int r = 0; r < rt::kTileRowsPerThread; ++r) {
        const int i = i0 + threadIdx.y + 8 * r;
        if (i < W) lane_adj[(size_t)i * nw + blockIdx.x] = 0u;
      }
    }
    return;
  }
  const int tid = threadIdx.y * rt::kTile + threadIdx.x;
  const int* lane_ids = ids + (size_t)b * W;
  if (tid < rt::kTile) {
    const int i = i0 + tid;
    sm.rid[tid] = i < Kb ? max(lane_ids[i], 0) : 0;
  } else if (tid < 2 * rt::kTile) {
    const int j = j0 + tid - rt::kTile;
    sm.cid[tid - rt::kTile] = j < Kb ? max(lane_ids[j], 0) : 0;
  }
  __syncthreads();
  float sims[rt::kTileRowsPerThread];
  rt::tile_sims(x, d, metric, sm, sims);
  const float e = eps[b];
  const int j = j0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < rt::kTileRowsPerThread; ++r) {
    const int i = i0 + threadIdx.y + 8 * r;
    const unsigned w = __ballot_sync(0xffffffffu, j < W && sims[r] > e);
    if (threadIdx.x == 0 && i < W) lane_adj[(size_t)i * nw + blockIdx.x] = w;
  }
}

struct PrefixScore {
  const int* ids;
  const float* scores;
  int K;
  __device__ float operator()(int i) const {
    return (i < K && ids[i] >= 0) ? scores[i] : -INFINITY;
  }
};

__global__ void fused_greedy_kernel(const int* __restrict__ ids,
                                    const float* __restrict__ scores,
                                    const int* __restrict__ Ks,
                                    const unsigned* __restrict__ adj, int* sel,
                                    float* selsc, int W, int k) {
  extern __shared__ unsigned banned[];
  const int b = blockIdx.x;
  const int nw = (W + 31) >> 5;
  rt::greedy_select(
      W, k, PrefixScore{ids + (size_t)b * W, scores + (size_t)b * W, Ks[b]},
      rt::BanBits{adj + (size_t)b * W * nw, nw}, banned, sel + (size_t)b * k,
      selsc + (size_t)b * k);
}

constexpr int kGreedyThreads = 256;

}  // namespace

extern "C" int fused_round(const float* x, const int* ids, const float* scores,
                           const int* Ks, const float* eps, unsigned* adj,
                           int* sel, float* selsc, int B, int W, int d, int k,
                           int metric, void* stream) {
  if (B <= 0 || W <= 0 || k <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (W + rt::kTile - 1) / rt::kTile;
  fused_adj_kernel<<<dim3(tiles, tiles, B), dim3(rt::kTile, 8), 0, s>>>(
      x, ids, Ks, eps, adj, W, d, metric);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)((W + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_greedy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_greedy_kernel<<<B, kGreedyThreads, smem, s>>>(ids, scores, Ks, adj,
                                                      sel, selsc, W, k);
  return (int)cudaGetLastError();
}
