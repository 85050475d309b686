// Tournament merge of the sharded search: the top L of two sorted runs.
//
// Replaces the Pallas kernel topk_merge_pallas
// (src/repro/kernels/topk_merge.py:53, body _kernel :39): for every row r,
//
//   (io[r], so[r]) = the first L of merge((ia[r], sa[r]), (ib[r], sb[r]))
//
// where both runs are sorted by (score desc, id asc) and an entry a comes
// before b iff s_a > s_b || (s_a == s_b && id_a < id_b), in IEEE terms: -0.0
// and +0.0 tie and the id breaks the tie; padding entries (-1, -inf) order
// by id among themselves. Entries that tie on both keys keep run a first, as
// the reference's stable lexsort of the concatenation (a, b) keeps them.
//
// Design: merge by rank. The TPU kernel pads both runs to a power of two
// (at least 128) and runs a bitonic network over the 2L lanes of one vector
// register, one call per lane. Here one launch merges every row of a
// tournament round (P * B rows) and needs neither padding nor a cap on L
// from shared memory: each thread owns one input entry, finds by binary
// search how many entries of the other run precede it (strictly for an
// entry of a, ties included for an entry of b), and its rank in the merged
// order is that count plus its own index. Ranks are distinct, so each rank
// below L is written by exactly one thread, and no thread waits on another.
//
// Bound on the card: it reads 2L (id, score) pairs and writes L a row, 24L
// bytes, and does ~2L log2(L) comparisons: at R = 64 rows that is 49 KB
// (0.015 us at 3.35 TB/s) for L = 32 and 6.3 MB (1.9 us) for L = 4096, so at
// the path's shapes the launch itself bounds it. The binary searches read
// the runs through L1/L2; staging them in shared memory is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void topk_merge_kernel(const int* __restrict__ ia,
                                  const float* __restrict__ sa,
                                  const int* __restrict__ ib,
                                  const float* __restrict__ sb,
                                  int* __restrict__ io,
                                  float* __restrict__ so, int L) {
  const long long base = (long long)blockIdx.x * L;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= 2 * L) return;
  const int *ra_i = ia + base, *rb_i = ib + base;
  const float *ra_s = sa + base, *rb_s = sb + base;
  int lo = 0, hi = L, own, id;
  float s;
  if (e < L) {  // an entry of a: the entries of b strictly before it
    own = e;
    id = ra_i[e];
    s = ra_s[e];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(rb_s[mid], rb_i[mid], s, id)) lo = mid + 1; else hi = mid;
    }
  } else {      // an entry of b: the entries of a before it or tied with it
    own = e - L;
    id = rb_i[own];
    s = rb_s[own];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!before(s, id, ra_s[mid], ra_i[mid])) lo = mid + 1; else hi = mid;
    }
  }
  const int rank = own + lo;
  if (rank < L) {
    io[base + rank] = id;
    so[base + rank] = s;
  }
}

}  // namespace

extern "C" int topk_merge(const int* ia, const float* sa, const int* ib,
                          const float* sb, int* io, float* so, int R, int L,
                          void* stream) {
  if (R <= 0 || L <= 0) return 0;
  const int chunks = (2 * L + kThreads - 1) / kThreads;
  if (L > (1 << 22)) return (int)cudaErrorInvalidValue;  // chunks < 65536
  const dim3 grid(R, chunks);
  topk_merge_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ia, sa, ib, sb, io, so, L);
  return (int)cudaGetLastError();
}
