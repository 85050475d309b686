// Tournament merge of the sharded search: a whole tournament over P sorted
// runs in one launch (topk_tournament), and the top L of two sorted runs
// (topk_merge, one butterfly round's pairwise merge).
//
// Replaces the Pallas kernel topk_merge_pallas
// (src/repro/kernels/topk_merge.py:53, body _kernel :39), which merges one
// pair of runs per call: the reference runs log2 P butterfly rounds of it,
// each between two ppermute collectives across chips
// (src/repro/sharded_search/search.py:295-304). Runs are sorted by (score
// desc, id asc), and an entry a comes before b iff s_a > s_b || (s_a == s_b
// && id_a < id_b), in IEEE terms: -0.0 and +0.0 tie and the id breaks the
// tie; padding entries (-1, -inf) order by id among themselves. Entries
// that tie on both keys keep run a first, as the reference's stable lexsort
// of the concatenation (a, b) keeps them. Scores must not be NaN (the
// search's are similarities, its padding -inf).
//
// topk_tournament: ids / scores [P, B, L], P a power of two. Shard 0's rows
// after log2 P butterfly rounds are the first L of all P runs of a lane
// merged under (score desc, id asc, shard asc, position asc): that order is
// strict and total, each round's merge keeps it (ties on both keys from the
// lower shard first, within one run in their order), and the top L of a
// union is the top L of its parts' top-L lists, so no round's truncation
// loses an entry. The kernel ranks every entry in that order directly.
//
// Bound on the card: it reads the P runs and writes one, 8 * B * L * (P + 1)
// bytes: at P = 4, B = 16, L = 32 that is 20 KB, 0.006 us at 3.35 TB/s, so
// the launch bounds it, and the time is the chain of dependent loads a
// thread waits on. What the design does about it: one launch a tournament
// instead of log2 P, each run of a lane read by the block itself at
// (p * B + b) * L (no partner exchange, no host-built index), and short
// chains. Each block ranks up to 2048 entries of one lane (one block a lane
// at the path's shapes; a longer lane splits over several). Entry e of run
// j ranks e, plus for every other run i a binary search counting the
// entries before it or tied with it (i < j) or strictly before it (i > j).
// Ranks are distinct, so each rank below L is written by exactly one
// thread, and no thread waits on another. The P - 1 searches of an entry
// run side by side on neighbouring lanes of a warp, as many as a block of
// 1024 threads holds, and their counts add up by shuffles; a search never
// counts past L - e (an entry ranked L or more is not written), so lanes
// stop early on long runs. A lane of 512 entries or more (P * L * 8 bytes:
// 4 KB at P = 4, L = 128) is first staged into shared memory with cp.async
// behind one barrier, where staging was measured to win at every P
// (tools/torch_topk_tournament_routes.py); below that, the sharded path's
// merges among them (P = 4, L <= 64), it gains nothing, and past 227 KB
// (P = 8 at L = 4096 is 256 KB) it does not fit, so the searches read
// device memory through L1.
//
// topk_merge: for every row r of two [R, L] runs,
//   (io[r], so[r]) = the first L of merge((ia[r], sa[r]), (ib[r], sb[r]))
// by the same rank rule over 2 runs, reading device memory: one launch
// merges every row of a round (P * B rows), 24 L bytes a row.
#include <climits>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTourThreads = 1024;   // most threads of a tournament block
constexpr int kMaxEntries = 2048;    // most entries a tournament block ranks
constexpr int kMinEntries = 512;     // and the fewest, when a lane splits
constexpr int kMaxStage = 232448;    // 227 KB, a block's most shared memory

// Settings of the tournament that tools/torch_topk_tournament_routes.py
// overrides at compile time to time the alternatives: the fewest entries
// (P * L) of a lane worth staging, the entries a block ranks (0: the rule
// in topk_tournament), and the most lanes of a warp that share an entry.
#ifndef TOPK_STAGE_ENTRIES
#define TOPK_STAGE_ENTRIES 512
#endif
#ifndef TOPK_BLOCK_ENTRIES
#define TOPK_BLOCK_ENTRIES 0
#endif
#ifndef TOPK_MAX_LANES
#define TOPK_MAX_LANES 32
#endif
constexpr int kStageEntries = TOPK_STAGE_ENTRIES;

// One (score, id) entry, and a sorted run of them: in shared memory or in
// device memory, ids and scores apart.
struct Entry {
  float s;
  int id;
};

struct Run {
  const int* ids;
  const float* scores;
  __device__ __forceinline__ Entry at(int c) const {
    return Entry{scores[c], ids[c]};
  }
};

// How many of the first n entries of sorted run r come before x: strictly
// before, or before or tied with it (tied). Those entries are a prefix of
// the run, so a binary search counts them. With scores that are not NaN, y
// comes before x or ties with it iff s_y > s_x || (s_y == s_x && id_y <=
// id_x), and strictly before it iff the same holds with id_y <= id_x - 1
// (no id when id_x is the least int): one id bound picks either without a
// branch, so lanes searching either way stay together.
__device__ __forceinline__ int count_before(Run r, bool tied, int n,
                                            Entry x) {
  const int bound = tied ? x.id : (int)((unsigned)x.id - 1u);
  const bool some = tied || x.id != INT_MIN;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const Entry y = r.at(mid);
    if ((y.s > x.s) | ((y.s == x.s) & some & (y.id <= bound))) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Rank entries [g0, g1) of one lane's P runs (run i at rid/rsc + i *
// stride) and write those ranked below L to (io, so). Entry e of run j
// ranks e, plus for every other run the entries before or tied with it
// (i < j) or strictly before it (i > j). Q neighbouring lanes of a warp (a
// power of two, at most P and 32) share an entry, lane q searching runs q,
// q + Q, ... in turn, and their counts add up by shuffles. Only a rank
// below L is written, so a lane's searches together count at most L - e
// entries: each search is capped by what is left, and a lane stops when
// nothing is.
template <typename Idx>
__device__ __forceinline__ void rank_entries(const int* rid, const float* rsc,
                                             Idx stride, int P, int Q, int L,
                                             int g0, int g1,
                                             int* __restrict__ io,
                                             float* __restrict__ so) {
  const int pairs = (g1 - g0) * Q;
  // every lane of a warp runs the same iterations, so the shuffles are whole
  for (int base = 0; base < pairs; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const bool live = t < pairs;
    const int g = g0 + (live ? t : 0) / Q, q = t & (Q - 1);
    const int j = g / L, e = g - j * L;
    const Entry x = Run{rid + j * stride, rsc + j * stride}.at(e);
    int count = 0;
    for (int i = q; live && i < P && count < L - e; i += Q)
      if (i != j)
        count += count_before(Run{rid + i * stride, rsc + i * stride}, i < j,
                              L - e - count, x);
    for (int m = 1; m < Q; m <<= 1)
      count += __shfl_xor_sync(0xffffffffu, count, m);
    if (live && q == 0 && e + count < L) {
      io[e + count] = x.id;
      so[e + count] = x.s;
    }
  }
}

// Block (b, c) ranks entries [c * E, ...) of lane b's P * L.
// STAGED: the lane's runs are copied into shared memory first (vec: in
// 16-byte pieces, L % 4 == 0 and 16-byte aligned bases).
template <bool STAGED>
__global__ void __launch_bounds__(kTourThreads)
    topk_tournament_kernel(const int* __restrict__ ids,
                           const float* __restrict__ scores,
                           int* __restrict__ io, float* __restrict__ so, int P,
                           int Q, int B, int L, int E, bool vec) {
  const int b = blockIdx.x;
  const long long run = (long long)B * L;  // from run p to run p + 1
  const int* rid = ids + (long long)b * L;
  const float* rsc = scores + (long long)b * L;
  const int g0 = blockIdx.y * E;
  const int g1 = min(P * L, g0 + E);
  io += (long long)b * L;
  so += (long long)b * L;
  if constexpr (STAGED) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* sid = reinterpret_cast<int*>(smem);
    float* ssc = reinterpret_cast<float*>(smem + (size_t)P * L * 4);
    if (vec) {
      const int w = L / 4;  // 16-byte words a run
      for (int t = threadIdx.x; t < P * w; t += blockDim.x) {
        const int p = t / w, c = 4 * (t - p * w);
        rt::cp_async16(sid + p * L + c, rid + p * run + c);
        rt::cp_async16(ssc + p * L + c, rsc + p * run + c);
      }
    } else {
      for (int t = threadIdx.x; t < P * L; t += blockDim.x) {
        const int p = t / L, c = t - p * L;
        rt::cp_async4(sid + t, rid + p * run + c);
        rt::cp_async4(ssc + t, rsc + p * run + c);
      }
    }
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
    rank_entries(sid, ssc, L, P, Q, L, g0, g1, io, so);
  } else {
    rank_entries(rid, rsc, run, P, Q, L, g0, g1, io, so);
  }
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
  int own, before_it;
  Entry x;
  if (e < L) {  // an entry of a: the entries of b strictly before it
    own = e;
    x = Run{ra_i, ra_s}.at(e);
    before_it = count_before(Run{rb_i, rb_s}, false, L, x);
  } else {      // an entry of b: the entries of a before it or tied with it
    own = e - L;
    x = Run{rb_i, rb_s}.at(own);
    before_it = count_before(Run{ra_i, ra_s}, true, L, x);
  }
  const int rank = own + before_it;
  if (rank < L) {
    io[base + rank] = x.id;
    so[base + rank] = x.s;
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

// Shard 0's [B, L] rows after the butterfly over ids / scores [P, B, L],
// P a power of two.
extern "C" int topk_tournament(const int* ids, const float* scores, int* io,
                               float* so, int P, int B, int L, void* stream) {
  if (P <= 0 || (P & (P - 1))) return (int)cudaErrorInvalidValue;
  if (B <= 0 || L <= 0) return 0;
  const long long entries = (long long)P * L;
  const size_t smem = (size_t)entries * 8;
  const bool staged = entries >= kStageEntries && smem <= (size_t)kMaxStage;
  // entries a block: reading device memory 512; staged, the most of 2048,
  // 1024 and 512 that still gives half the SMs a block, as each block
  // stages the lane's whole runs
  static int sms_dev = -1, sms = 0;
  int rc, dev = 0;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev != sms_dev) {
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev)))
      return rc;
    sms_dev = dev;
  }
  int E = TOPK_BLOCK_ENTRIES > 0 ? TOPK_BLOCK_ENTRIES : kMinEntries;
  for (int e = kMaxEntries; staged && !TOPK_BLOCK_ENTRIES && e > kMinEntries;
       e >>= 1)
    if (2 * (long long)B * ((entries + e - 1) / e) >= sms) {
      E = e;
      break;
    }
  const long long chunks = (entries + E - 1) / E;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const int per_block = entries < E ? (int)entries : E;
  // lanes an entry: as many as a block of at most kTourThreads allows
  int Q = P < TOPK_MAX_LANES ? P : TOPK_MAX_LANES;
  while (Q > 1 && Q * per_block > kTourThreads) Q >>= 1;
  const int threads = Q * per_block < kTourThreads
                          ? (Q * per_block + 31) / 32 * 32
                          : kTourThreads;
  const dim3 grid(B, (unsigned)chunks);
  cudaStream_t st = (cudaStream_t)stream;
  if (!staged) {
    topk_tournament_kernel<false><<<grid, threads, 0, st>>>(
        ids, scores, io, so, P, Q, B, L, E, false);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    // raised once per device to the most a block may use
    static int raised_dev = -1;
    if (dev != raised_dev) {
      if ((rc = (int)cudaFuncSetAttribute(
               topk_tournament_kernel<true>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStage)))
        return rc;
      raised_dev = dev;
    }
  }
  const bool vec = L % 4 == 0 && rt::aligned16(ids) && rt::aligned16(scores);
  topk_tournament_kernel<true><<<grid, threads, smem, st>>>(
      ids, scores, io, so, P, Q, B, L, E, vec);
  return (int)cudaGetLastError();
}
