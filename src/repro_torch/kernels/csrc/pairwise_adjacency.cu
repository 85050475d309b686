// Batched diversity-graph adjacency (paper Def. 2): one G^eps per lane.
//
// Replaces the Pallas kernel pairwise_adjacency_pallas
// (src/repro/kernels/pairwise_adjacency.py:46). Where the TPU kernel builds
// one (K, K) adjacency per call and the engine vmaps it, this kernel builds
// all G lanes' (W, W) adjacencies in one launch, each against its own eps,
// and writes the finished bool adjacency:
//
//   out[g, i, j] = i != j && ids[g, i] >= 0 && ids[g, j] >= 0
//                  && sim(x[ids[g, i]], x[ids[g, j]]) > eps[g]
//
// Bound on the card: one triangle of sims, G*W*(W-1)/2 * 2d flops, against
// G*W*d*4 bytes of rows and G*W*W bytes out; at d = 96 that is ~100 flops
// per byte, so with float32 on the CUDA cores it is bound by operations.
//
// Each similarity is sim.cuh's one sequential __fmaf_rn chain over d from
// +0, norms included, so it equals the gathered and corpus scorers' bits;
// that order rules out the tensor cores and any split of d. sim(u, v) is
// bitwise symmetric (the product in an fma commutes, and so does
// finish_sim in its two norms), so only tiles (ti, tj) with ti <= tj are
// computed and each is written to (i, j) and to (j, i).
//
// A block computes one 64 x 64 tile, R x R outputs a thread in registers:
// R = 8 (64 threads; per 4 features a thread issues 16 float4 loads from
// shared memory for 256 FMAs) once the grid holds 4 blocks an SM, R = 4
// (256 threads) below that, as at the engine's widths (one tile a lane at
// W = 64), where a block's few warps issuing the row gathers and the FMA
// chains bound it, not the card's rate. The tile's 64 + 64 gathered rows
// stream through shared memory in 32-column chunks with cp.async in a
// two-stage ring (a 4-byte copy when d % 4 != 0 or x is not 16-byte
// aligned), at an odd 16-byte-word stride so a warp's float4 reads are
// conflict-free. The threads also carry the norm chains of the 64 + 64
// tile rows, one or two a thread, so every norm is computed once per tile.
// The thresholded bytes, diagonal and padding already false, go through
// shared memory twice, as the tile and its transpose, so that both stores
// are coalesced rows. A tile whose rows or columns are all padding is
// written as zeros without any FMA.
#include <climits>

#include "cp_async.cuh"
#include "sim.cuh"

namespace {

constexpr int kT = 64;                         // tile rows = tile columns
constexpr int kKC = 32;                        // columns of d per chunk
constexpr int kS = rt::padded_stride(kKC);     // 36: staged row stride
constexpr int kOS = kT + 16;                   // byte tiles' row stride

struct Smem {
  union {
    float ring[2][2 * kT][kS];  // rows 0..63: tile rows; 64..127: columns
    struct {
      unsigned char e[kT][kOS];   // the tile
      unsigned char et[kT][kOS];  // its transpose
    } out;
  };
  float sq[2 * kT];  // squared norms of the tile rows, then columns
  int row[2 * kT];   // corpus row of each tile row / column, -1 padding
};

// Threads of a block whose threads own R x R outputs each.
template <int R>
__host__ __device__ constexpr int threads_of() {
  return (kT / R) * (kT / R);
}

// Start the copy of chunk c of the tile's 128 rows into ring stage `s`.
template <int THREADS, bool VEC>
__device__ __forceinline__ void stage_chunk(Smem& sm, const float* x, int d,
                                            int c, int s) {
  const int col0 = c * kKC;
  const int w = min(kKC, d - col0);
  const int unit = VEC ? 4 : 1, wu = (w + unit - 1) / unit;
  for (int e = threadIdx.x; e < 2 * kT * wu; e += THREADS) {
    const int r = e / wu, u = e - r * wu;
    const int id = sm.row[r];
    if (id < 0) continue;  // padding: never read unmasked
    const float* src = x + (size_t)id * d + col0 + u * unit;
    if (VEC)
      rt::cp_async16(&sm.ring[s][r][u * 4], src);
    else
      rt::cp_async4(&sm.ring[s][r][u], src);
  }
  rt::cp_async_commit();
}

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of a lane's (W, W) output from
// a byte tile in shared memory: 16-byte stores when W % 16 == 0.
template <int THREADS>
__device__ __forceinline__ void store_tile(unsigned char* o, int W, int r0,
                                           int c0,
                                           const unsigned char (*src)[kOS]) {
  if (W % 16 == 0) {
    for (int e = threadIdx.x; e < kT * (kT / 16); e += THREADS) {
      const int r = e / (kT / 16), q = 16 * (e % (kT / 16));
      if (r0 + r < W && c0 + q < W)
        *reinterpret_cast<uint4*>(o + (size_t)(r0 + r) * W + c0 + q) =
            *reinterpret_cast<const uint4*>(&src[r][q]);
    }
  } else {
    for (int e = threadIdx.x; e < kT * kT; e += THREADS) {
      const int r = e / kT, c = e % kT;
      if (r0 + r < W && c0 + c < W) o[(size_t)(r0 + r) * W + c0 + c] = src[r][c];
    }
  }
}

template <int R, bool VEC>
__global__ void __launch_bounds__(threads_of<R>())
    adjacency_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                     const float* __restrict__ eps,
                     unsigned char* __restrict__ out, int W, int d,
                     int metric) {
  constexpr int THREADS = threads_of<R>(), G = kT / R;  // G x G threads
  constexpr int NN = (2 * kT + THREADS - 1) / THREADS;   // norms a thread
  __shared__ __align__(16) Smem sm;
  const int g = blockIdx.y, t = threadIdx.x;
  // block -> upper-triangle tile (ti, tj), row-major over ti <= tj
  const int nt = (W + kT - 1) / kT;
  int ti = 0, p = blockIdx.x;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int i0 = ti * kT, j0 = tj * kT;
  const int* lane = ids + (size_t)g * W;
  for (int r = t; r < 2 * kT; r += THREADS) {
    const int i = (r < kT ? i0 + r : j0 + r - kT);
    sm.row[r] = i < W ? max(lane[i], -1) : -1;
  }
  __syncthreads();
  // threads t < 64 look at tile row t and tile column t
  const bool rows_live = __syncthreads_or(t < kT && sm.row[t] >= 0);
  const bool cols_live = __syncthreads_or(t < kT && sm.row[kT + t] >= 0);
  unsigned char* o = out + (size_t)g * W * W;

  if (rows_live && cols_live) {  // block-uniform
    // thread (tx, ty) owns tile rows ty + G*ii and columns tx + G*jj
    const int tx = t % G, ty = t / G;
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = 0.0f;
    float sq[NN];  // squared norms of staged rows t, t + THREADS (< 128)
#pragma unroll
    for (int u = 0; u < NN; ++u) sq[u] = 0.0f;
    const int nk = (d + kKC - 1) / kKC;
    stage_chunk<THREADS, VEC>(sm, x, d, 0, 0);
    for (int c = 0; c < nk; ++c) {
      if (c + 1 < nk)
        stage_chunk<THREADS, VEC>(sm, x, d, c + 1, (c + 1) & 1);
      else
        rt::cp_async_commit();
      rt::cp_async_wait<1>();
      __syncthreads();  // chunk c has landed for every thread
      const float(*A)[kS] = sm.ring[c & 1];
      const float(*B)[kS] = sm.ring[c & 1] + kT;
      const int w = min(kKC, d - c * kKC);
      int j = 0;
      for (; j + 4 <= w; j += 4) {
        float4 a[R];
#pragma unroll
        for (int ii = 0; ii < R; ++ii)
          a[ii] = *reinterpret_cast<const float4*>(&A[ty + G * ii][j]);
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const float4 b = *reinterpret_cast<const float4*>(&B[tx + G * jj][j]);
#pragma unroll
          for (int ii = 0; ii < R; ++ii) {
            float v = acc[ii][jj];
            v = __fmaf_rn(a[ii].x, b.x, v);
            v = __fmaf_rn(a[ii].y, b.y, v);
            v = __fmaf_rn(a[ii].z, b.z, v);
            v = __fmaf_rn(a[ii].w, b.w, v);
            acc[ii][jj] = v;
          }
        }
#pragma unroll
        for (int u = 0; u < NN; ++u) {
          if (t + u * THREADS < 2 * kT) {
            const float4 v =
                *reinterpret_cast<const float4*>(&A[t + u * THREADS][j]);
            sq[u] = __fmaf_rn(v.x, v.x, sq[u]);
            sq[u] = __fmaf_rn(v.y, v.y, sq[u]);
            sq[u] = __fmaf_rn(v.z, v.z, sq[u]);
            sq[u] = __fmaf_rn(v.w, v.w, sq[u]);
          }
        }
      }
      for (; j < w; ++j) {
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const float b = B[tx + G * jj][j];
#pragma unroll
          for (int ii = 0; ii < R; ++ii)
            acc[ii][jj] = __fmaf_rn(A[ty + G * ii][j], b, acc[ii][jj]);
        }
#pragma unroll
        for (int u = 0; u < NN; ++u)
          if (t + u * THREADS < 2 * kT)
            sq[u] = __fmaf_rn(A[t + u * THREADS][j], A[t + u * THREADS][j],
                              sq[u]);
      }
      __syncthreads();  // every read of this stage is done before its reuse
    }
    rt::cp_async_wait<0>();
#pragma unroll
    for (int u = 0; u < NN; ++u)
      if (t + u * THREADS < 2 * kT) sm.sq[t + u * THREADS] = sq[u];
    __syncthreads();
    const float e = eps[g];
#pragma unroll
    for (int ii = 0; ii < R; ++ii) {
      const int r = ty + G * ii;
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const int c = tx + G * jj;
        const bool edge =
            sm.row[r] >= 0 && sm.row[kT + c] >= 0 && i0 + r != j0 + c &&
            rt::finish_sim(acc[ii][jj], sm.sq[r], sm.sq[kT + c], metric) > e;
        sm.out.e[r][c] = edge;
        sm.out.et[c][r] = edge;
      }
    }
  } else {
    for (int e = t; e < kT * kOS; e += THREADS) {
      (&sm.out.e[0][0])[e] = 0;
      (&sm.out.et[0][0])[e] = 0;
    }
  }
  __syncthreads();
  store_tile<THREADS>(o, W, i0, j0, sm.out.e);
  if (ti != tj) store_tile<THREADS>(o, W, j0, i0, sm.out.et);
}

}  // namespace

extern "C" int adjacency_batch(const float* x, const int* ids,
                               const float* eps, unsigned char* out, int G,
                               int W, int d, int metric, void* stream) {
  if (G <= 0 || W <= 0) return 0;
  const long long nt = (W + kT - 1) / kT;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > INT_MAX || G > 65535) return (int)cudaErrorInvalidValue;
  // the card's SMs, asked once per device
  static int cached_dev = -1, sms = 0;
  int rc, dev = 0;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev != cached_dev) {
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev)))
      return rc;
    cached_dev = dev;
  }
  const dim3 grid((unsigned)pairs, (unsigned)G);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && rt::aligned16(x);
  // 8 x 8 outputs a thread once the grid holds 4 blocks an SM or more
  if (pairs * G >= 4LL * sms) {
    if (vec)
      adjacency_kernel<8, true><<<grid, threads_of<8>(), 0, s>>>(
          x, ids, eps, out, W, d, metric);
    else
      adjacency_kernel<8, false><<<grid, threads_of<8>(), 0, s>>>(
          x, ids, eps, out, W, d, metric);
  } else {
    if (vec)
      adjacency_kernel<4, true><<<grid, threads_of<4>(), 0, s>>>(
          x, ids, eps, out, W, d, metric);
    else
      adjacency_kernel<4, false><<<grid, threads_of<4>(), 0, s>>>(
          x, ids, eps, out, W, d, metric);
  }
  return (int)cudaGetLastError();
}
