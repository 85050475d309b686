// Batched similarity scoring: the search hot loop.
//
// Replaces the Pallas kernel batch_similarity_many_pallas
// (src/repro/kernels/batch_similarity.py:51). Two entry points:
//
//   sim_many    scores[b, n] = sim(qs[b], x[n])             (growth rebuild:
//               every lane's query against the whole corpus)
//   sim_gather  scores[b, m] = sim(qs[b], x[max(ids[b, m], 0)])  (burst: each
//               lane's query against its expanded node's M0 neighbour rows)
//
// Both compute each output with sim.cuh's fixed sequential order over d (a
// __fmaf_rn per j = 0 .. d-1 from +0, for the dot, <q, q> and <x, x> alike)
// and its finish_sim, so a (query, row) pair scores bitwise the same in
// either entry point, in the adjacency tile and in the fused round, for any
// batch around it: the engine's per-lane parity needs that. For the same
// reason neither uses the tensor cores: wgmma and mma.sync sum over d in
// blocks (and TF32 rounds the inputs), and a split of d across threads
// would need a tree reduction. Each thread owns whole outputs and walks d in
// order; at these shapes the FMAs are not what bounds either kernel.
//
// sim_many, bound by bytes: at B = 16, N = 1M, d = 96 it reads 384 MB of
// corpus and writes 64 MB of scores (0.134 ms at 3.35 TB/s) for 1.5 G FMAs
// (0.046 ms at 67 TFLOP/s). A persistent grid (as many blocks as fit on the
// SMs: two of 256 threads each at d = 96) walks tiles of kTile consecutive
// rows, contiguous in device memory, one row per thread. Each tile is staged
// into shared memory in chunks of kKC columns with 16-byte cp.async (4-byte
// copies when d % 4 != 0 or x is not 16-byte aligned), in a ring of kStages,
// so the next chunk's copy runs while this one is scored. A staged row sits
// at a padded stride of an odd number of 16-byte words (52 floats for a
// 48-column chunk), so the float4 reads of 8 neighbouring threads, one row
// each, fall in distinct banks. The launch's queries (at most kMaxQ) sit in
// shared memory and are read as warp-uniform broadcasts, all of a step's
// loads before its FMAs; each thread keeps one accumulator per query plus
// <x, x> in registers (17 independent chains at B = 16), carried over the
// chunks so the order over d stays sequential, reads its row from shared
// memory once, and stores along n, coalesced. Measured variants: two rows per
// thread (each query value serving both) ran slower for want of warps, and
// whole-row chunks (kKC = 96) fit fewer blocks on an SM.
//
// sim_gather, bound by its launch: at 16 lanes x 32 rows it moves ~0.2 MB.
// The grid is (chunk of kGatherRows rows, lane), 128 blocks at 16 x 32, so
// the work spreads over the SMs. Each warp reads its row's id and copies the
// row into shared memory with coalesced cp.async, the block copies its lane's
// query, and only then does any FMA run: the latency is one round trip for
// the ids and one for the rows. One thread per output runs the dot chain,
// one thread per row runs <x, x> and one thread <q, q> (none of them for ip),
// all from shared memory at the padded stride.
#include <algorithm>

#include "cp_async.cuh"
#include "sim.cuh"

namespace {

constexpr int kTile = 256;       // sim_many: corpus rows per tile = threads
constexpr int kKC = 48;          // sim_many: columns of d per staged chunk
constexpr int kStages = 2;       // sim_many: chunks in the cp.async ring
constexpr int kMaxQ = 16;        // sim_many: queries per launch (registers)
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory
constexpr int kGatherRows = 4;   // sim_gather: rows per block, a warp each

using rt::aligned16;
using rt::cp_async16;
using rt::cp_async4;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::padded_stride;

// Copy rows [0, rows) x columns [col0, col0 + w) of a row-major [*, d] block
// starting at src into dst at row stride S, threads t, t + step, ... of the
// caller's group. VEC: d % 4 == 0, col0 % 4 == 0 and src 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int d, int col0, int w,
                                           int S, int t, int step) {
  // element i of the block is (r, c) = (i / wu, i % wu), in units of
  // 4 floats (VEC) or 1; stepping by `step` elements advances (r, c) by
  // (dr, dc) with a carry, so the loop divides once
  const int unit = VEC ? 4 : 1, wu = w / unit;
  if (wu == 0) return;
  const int dr = step / wu, dc = step - dr * wu;
  int r = t / wu, c = t - r * wu;
  for (; r < rows; r += dr, c += dc) {
    if (c >= wu) {
      c -= wu;
      ++r;
      if (r >= rows) break;
    }
    float* to = dst + r * S + c * unit;
    const float* from = src + (size_t)r * d + col0 + c * unit;
    if (VEC)
      cp_async16(to, from);
    else
      cp_async4(to, from);
  }
}

// sim.cuh's dot_seq over two rows in shared memory (16-byte aligned), read
// as float4s: the same __fmaf_rn per j in the same order.
__device__ __forceinline__ float dot_seq4(const float* a, const float* b,
                                          int d) {
  float acc = 0.0f;
  int j = 0;
  for (; j + 4 <= d; j += 4) {
    const float4 u = *reinterpret_cast<const float4*>(a + j);
    const float4 v = *reinterpret_cast<const float4*>(b + j);
    acc = __fmaf_rn(u.x, v.x, acc);
    acc = __fmaf_rn(u.y, v.y, acc);
    acc = __fmaf_rn(u.z, v.z, acc);
    acc = __fmaf_rn(u.w, v.w, acc);
  }
  for (; j < d; ++j) acc = __fmaf_rn(a[j], b[j], acc);
  return acc;
}

// A unit of sim_many's work: column chunk `chunk` of tile `tile` (rows
// tile * kTile ...). A block walks its tiles blockIdx.x, + gridDim.x, ...,
// each chunk by chunk.
struct Item {
  long long tile;
  int chunk;
  __device__ void next(int nk) {
    if (++chunk == nk) {
      chunk = 0;
      tile += gridDim.x;
    }
  }
};

// Start the copy of item `it` into `stage` (nothing past the last tile) and
// close a cp.async group, so every thread commits one group per item.
template <bool VEC>
__device__ __forceinline__ void stage_item(float* stage,
                                           const float* __restrict__ x,
                                           Item it, long long N,
                                           long long ntiles, int d, int S) {
  if (it.tile < ntiles) {
    const long long row0 = it.tile * kTile;
    const int col0 = it.chunk * kKC;
    stage_rows<VEC>(stage, x + row0 * d, (int)min((long long)kTile, N - row0),
                    d, col0, min(kKC, d - col0), S, threadIdx.x, kTile);
  }
  cp_async_commit();
}

// NQ: the launch's query slots, a power of two; the nb <= NQ live ones are
// scored, the rest are zeros whose chains are computed and never stored.
template <bool VEC, int NQ>
__global__ void __launch_bounds__(kTile)
    sim_many_kernel(const float* __restrict__ qs, const float* __restrict__ x,
                    float* __restrict__ out, int nb, long long N, int d,
                    int metric) {
  extern __shared__ __align__(16) float smem[];
  const int QS = (d + 3) / 4 * 4;             // query row stride
  const int S = padded_stride(min(d, kKC));   // staged row stride
  const int nk = max(1, (d + kKC - 1) / kKC);
  float* q_s = smem;                          // NQ * QS query values
  float* qq_s = q_s + NQ * QS;                // squared norms (kMaxQ slots)
  float* ring = qq_s + kMaxQ;                 // kStages * kTile * S
  const int t = threadIdx.x;
  const long long ntiles = (N + kTile - 1) / kTile;

  Item load{blockIdx.x, 0};
  for (int s = 0; s < kStages - 1; ++s, load.next(nk))
    stage_item<VEC>(ring + s * kTile * S, x, load, N, ntiles, d, S);
  for (int i = t; i < NQ * QS; i += kTile) {
    const int u = i / QS, j = i - u * QS;
    q_s[i] = u < nb && j < d ? qs[(size_t)u * d + j] : 0.0f;
  }
  __syncthreads();
  if (t < nb) qq_s[t] = dot_seq4(q_s + t * QS, q_s + t * QS, d);

  float acc[NQ];
  float xx = 0.0f;
  int stage = 0;
  for (Item it{blockIdx.x, 0}; it.tile < ntiles; it.next(nk)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item `it` has landed; the previous item's stage is free
    stage_item<VEC>(ring + (stage + kStages - 1) % kStages * kTile * S, x,
                    load, N, ntiles, d, S);
    load.next(nk);
    if (it.chunk == 0) {
      xx = 0.0f;
#pragma unroll
      for (int u = 0; u < NQ; ++u) acc[u] = 0.0f;
    }
    const int w = min(kKC, d - it.chunk * kKC);
    const float* xr = ring + stage * kTile * S + t * S;
    const float* qc = q_s + it.chunk * kKC;
    int j = 0;
    for (; j + 4 <= w; j += 4) {
      // every load of the step first, then 4 (NQ + 1) independent FMAs
      const float4 xv = *reinterpret_cast<const float4*>(xr + j);
      float4 qv[NQ];
#pragma unroll
      for (int u = 0; u < NQ; ++u)
        qv[u] = *reinterpret_cast<const float4*>(qc + u * QS + j);
      xx = __fmaf_rn(xv.x, xv.x, xx);
      xx = __fmaf_rn(xv.y, xv.y, xx);
      xx = __fmaf_rn(xv.z, xv.z, xx);
      xx = __fmaf_rn(xv.w, xv.w, xx);
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        acc[u] = __fmaf_rn(xv.x, qv[u].x, acc[u]);
        acc[u] = __fmaf_rn(xv.y, qv[u].y, acc[u]);
        acc[u] = __fmaf_rn(xv.z, qv[u].z, acc[u]);
        acc[u] = __fmaf_rn(xv.w, qv[u].w, acc[u]);
      }
    }
    for (; j < w; ++j) {
      const float xv = xr[j];
      xx = __fmaf_rn(xv, xv, xx);
#pragma unroll
      for (int u = 0; u < NQ; ++u)
        acc[u] = __fmaf_rn(xv, qc[u * QS + j], acc[u]);
    }
    if (it.chunk == nk - 1) {
      const long long n = it.tile * kTile + t;
      if (n < N) {
#pragma unroll
        for (int u = 0; u < NQ; ++u)
          if (u < nb)
            out[u * N + n] = rt::finish_sim(acc[u], qq_s[u], xx, metric);
      }
    }
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
}

template <bool VEC>
__global__ void __launch_bounds__(32 * kGatherRows)
    sim_gather_kernel(const float* __restrict__ qs,
                      const float* __restrict__ x,
                      const int* __restrict__ ids, float* __restrict__ out,
                      int M, int d, int metric) {
  extern __shared__ __align__(16) float smem[];
  const int S = padded_stride(d);
  const int R = blockDim.x / 32;             // rows per block
  float* q_s = smem;                         // the lane's query
  float* r_s = q_s + S;                      // R rows at stride S
  float* res = r_s + R * S;                  // R dots, R <x, x>, <q, q>
  const int b = blockIdx.y, m0 = blockIdx.x * R;
  const int rows = min(R, M - m0);
  const int t = threadIdx.x, warp = t / 32;
  if (warp < rows) {
    const int id = max(ids[(size_t)b * M + m0 + warp], 0);
    stage_rows<VEC>(r_s + warp * S, x + (size_t)id * d, 1, d, 0, d, S, t % 32,
                    32);
  }
  stage_rows<VEC>(q_s, qs + (size_t)b * d, 1, d, 0, d, S, t, blockDim.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const bool norms = metric != rt::kIP;
  if (t < rows)
    res[t] = dot_seq4(r_s + t * S, q_s, d);
  else if (t < 2 * rows)
    res[t] = norms ? dot_seq4(r_s + (t - rows) * S, r_s + (t - rows) * S, d)
                   : 0.0f;
  else if (t == 2 * rows)
    res[t] = norms ? dot_seq4(q_s, q_s, d) : 0.0f;
  __syncthreads();
  if (t < rows)
    out[(size_t)b * M + m0 + t] =
        rt::finish_sim(res[t], res[2 * rows], res[rows + t], metric);
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Dynamic shared memory of a sim_many launch with NQ query slots.
size_t many_smem(int d, int nq) {
  return ((size_t)kStages * kTile * padded_stride(std::min(d, kKC)) + kMaxQ +
          (size_t)nq * ((d + 3) / 4 * 4)) * 4;
}

template <bool VEC, int NQ>
int launch_many(const float* qs, const float* x, float* out, int nb,
                long long N, int d, int metric, cudaStream_t stream) {
  auto kernel = sim_many_kernel<VEC, NQ>;
  const size_t smem = many_smem(d, NQ);
  // the kernel's attributes and its blocks per SM, set and asked once per
  // (device, shared memory size), so a call costs the host only its launch
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int rc, dev = 0;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev != cached_dev || smem != cached_smem) {
    if ((rc = allow_smem(kernel, smem)) ||
        (rc = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared)) ||
        (rc = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kTile, smem)))
      return rc;
    cached_dev = dev;
    cached_smem = smem;
  }
  // persistent: as many blocks as fit on the SMs at once, never more than tiles
  const long long ntiles = (N + kTile - 1) / kTile;
  const unsigned grid = (unsigned)std::min<long long>(
      ntiles, (long long)std::max(per_sm, 1) * sms);
  kernel<<<grid, kTile, smem, stream>>>(qs, x, out, nb, N, d, metric);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_many_nq(int nq, const float* qs, const float* x, float* out, int nb,
                long long N, int d, int metric, cudaStream_t stream) {
  switch (nq) {
    case 1: return launch_many<VEC, 1>(qs, x, out, nb, N, d, metric, stream);
    case 2: return launch_many<VEC, 2>(qs, x, out, nb, N, d, metric, stream);
    case 4: return launch_many<VEC, 4>(qs, x, out, nb, N, d, metric, stream);
    case 8: return launch_many<VEC, 8>(qs, x, out, nb, N, d, metric, stream);
    default: return launch_many<VEC, 16>(qs, x, out, nb, N, d, metric, stream);
  }
}

}  // namespace

extern "C" int sim_many(const float* qs, const float* x, float* out, int B,
                        long long N, int d, int metric, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  // query slots per launch: a power of two up to kMaxQ that fits beside the
  // ring; more queries come in chunks, one pass over the corpus each
  int qmax = kMaxQ;
  while (qmax > 1 && many_smem(d, qmax) > (size_t)kMaxSmem) qmax /= 2;
  if (many_smem(d, qmax) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(x);
  for (int b0 = 0, nb; b0 < B; b0 += nb) {
    nb = std::min(qmax, B - b0);
    int nq = 1;
    while (nq < nb) nq *= 2;
    const int rc =
        vec ? launch_many_nq<true>(nq, qs + (size_t)b0 * d, x, out + (size_t)b0 * N,
                                nb, N, d, metric, (cudaStream_t)stream)
            : launch_many_nq<false>(nq, qs + (size_t)b0 * d, x,
                                 out + (size_t)b0 * N, nb, N, d, metric,
                                 (cudaStream_t)stream);
    if (rc) return rc;
  }
  return 0;
}

extern "C" int sim_gather(const float* qs, const float* x, const int* ids,
                          float* out, int B, int M, int d, int metric,
                          void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const int R = std::min(kGatherRows, M);
  const size_t smem = ((size_t)(1 + R) * padded_stride(d) + 2 * R + 1) * 4;
  auto kernel = (d % 4 == 0 && aligned16(x) && aligned16(qs))
                    ? sim_gather_kernel<true>
                    : sim_gather_kernel<false>;
  int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  const dim3 grid((unsigned)((M + R - 1) / R), (unsigned)B);
  kernel<<<grid, 32 * R, smem, (cudaStream_t)stream>>>(qs, x, ids, out, M, d,
                                                      metric);
  return (int)cudaGetLastError();
}
