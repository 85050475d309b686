// Batched greedy diverse selection (paper §II-B-2), one lane per warp or,
// past 1 024 candidates, per block.
//
// Replaces the Pallas kernels greedy_diversify_pallas
// (src/repro/kernels/greedy_diversify.py:46) and
// greedy_diversify_batch_pallas (:64). scores (B, W) float32, -inf marks an
// invalid candidate; adj (B, W, W) uint8, nonzero an edge; sel (B, k) int32
// local indices, -1 padded. Step t picks the best candidate not banned
// (masked argmax, lowest index on ties, as jnp.argmax) if its score is
// finite, and bans the pick and its adjacency row; with no such candidate
// the rest of sel is -1, as the plain version gives.
//
// Bound on the card: each step reads one W-byte row, so the bytes are tiny
// (~0.07 us at 16 x 1024, k = 10); the floor is the chain of k dependent
// steps, each an argmax over the lane and the picked row read and applied.
// So a step keeps what it can on chip and has no block barrier:
// - staged (W <= 128): one warp a lane. Thread t owns candidates
//   [t R, t R + R), R = ceil(W / 32), with their scores in registers and
//   their banned bits in one register word. The lane's W x W bytes are
//   copied into shared memory at launch (cp.async pieces of 16 or 4 bytes
//   where the rows allow, else bytes) while the scores load and the first
//   argmax runs, so a step is an argmax and R bytes of the picked row read
//   from shared memory and packed into bits.
// - prefetch (W <= 1024): the same warp, with each thread's part of a row
//   loaded into registers ahead of need. Greedy picks the candidates in
//   (score desc, index asc) order, skipping the banned ones, so the warp
//   keeps a queue of the next kQueue candidates in that order (each
//   extracted by the argmax over the candidates neither banned nor queued)
//   and starts their rows' loads as they join; a popped candidate still
//   unbanned is the pick, and its row has had the queue's extractions to
//   arrive. A thread loads only the bytes of its part that lie in the row
//   (W need not be a multiple of 32 R).
// The argmax of a warp route is a tree over each thread's R and one
// __reduce_max_sync over the warp. A lane with a +inf or NaN score picks
// nothing (the plain argmax takes it first, and it is not finite).
// - block (W > 1024): one block a lane; each warp owns the 32-candidate
//   chunks w, w + warps, ..., with their scores copied into shared memory
//   once (read from device memory each step only where W floats do not fit)
//   and their banned words written by that warp alone, so a step has one
//   barrier, for the warps' bests (rt::warp_argmax within each warp).
// greedy_plan reports the route of a width.
#include <climits>
#include <math.h>

#include "cp_async.cuh"
#include "greedy.cuh"

namespace {

constexpr int kStagedMax = 128;   // widest lane whose W x W bytes are staged
constexpr int kWarpMax = 1024;    // widest lane one warp holds (R = 32)
constexpr int kQueue = 2;         // prefetch queue: candidates ahead
constexpr int kBlockThreads = 512;
constexpr int kMaxSmem = 227 * 1024 - 1024;   // dynamic, beside the static
constexpr unsigned kFull = 0xffffffffu;

enum Route { kStaged = 0, kPrefetch = 1, kBlock = 2, kBlockStreamed = 3 };

// Bit i set iff byte i of w is nonzero.
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  const unsigned hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;
}

// The R bytes at p (aligned to min(R, 16)) as R bits.
template <int R>
__device__ __forceinline__ unsigned pack_bits(const unsigned char* p) {
  if constexpr (R == 1) return nonzero4(*p);
  else if constexpr (R == 2)
    return nonzero4(*reinterpret_cast<const unsigned short*>(p));
  else if constexpr (R == 4)
    return nonzero4(*reinterpret_cast<const unsigned*>(p));
  else if constexpr (R == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return nonzero4(w.x) | nonzero4(w.y) << 4;
  } else {
    unsigned bits = 0;
#pragma unroll
    for (int q = 0; q < R / 16; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[q];
      bits |= (nonzero4(w.x) | nonzero4(w.y) << 4 | nonzero4(w.z) << 8 |
               nonzero4(w.w) << 12) << (16 * q);
    }
    return bits;
  }
}

// Which pieces thread t copies of nrows rows of W bytes in g-byte pieces
// (cp.async for g = 16 or 4, each row starting on a multiple of g; plain
// loads for g = 1):
// rows j0, j0 + at_once, ..., pieces c0, c0 + 32, ... of each (a warp
// copies 32 / per_row rows a pass when a row has fewer than 32 pieces).
struct Pieces {
  int g, per_row, at_once, j0, c0;
  __device__ Pieces(int W, int g_, int t) : g(g_) {
    per_row = max((W + g - 1) / g, 1);   // W = 0 copies nothing
    at_once = per_row >= 32 ? 1 : 32 / per_row;
    j0 = per_row >= 32 ? 0 : t / per_row;
    c0 = t - j0 * per_row;
  }

  // rows [0, nrows) at src (stride W) to dst (stride S), then one commit
  __device__ void copy(unsigned char* dst, int S, const unsigned char* src,
                       int nrows, int W) const {
    if (j0 < at_once)
      for (int j = j0; j < nrows; j += at_once)
        for (int c = c0 * g; c < W; c += 32 * g) {
          if (g == 16)
            rt::cp_async16(dst + (size_t)j * S + c, src + (size_t)j * W + c);
          else if (g == 4)
            rt::cp_async4(dst + (size_t)j * S + c, src + (size_t)j * W + c);
          else
            dst[(size_t)j * S + c] = src[(size_t)j * W + c];
        }
    rt::cp_async_commit();
  }
};

// Float order as unsigned order, -0.0 and +0.0 alike (they tie).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// The warp's best (v, i), in every thread, where each thread's candidates
// all come before the next thread's: the largest v, the lowest thread on
// ties, which holds the lowest index (rt::warp_argmax's answer, in one
// reduction, one ballot and two shuffles in place of five shuffle rounds).
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const unsigned key = order_key(v);
  const unsigned top = __reduce_max_sync(kFull, key);
  const int src = __ffs(__ballot_sync(kFull, key == top)) - 1;
  v = __shfl_sync(kFull, v, src);
  i = __shfl_sync(kFull, i, src);
}

// NaN ranks as +inf: the plain version's argmax takes a NaN or +inf first
// and, as it is not finite, picks nothing, then or later.
__device__ __forceinline__ float no_nan(float v) {
  return v != v ? INFINITY : v;
}

// One lane's candidates as a warp holds them: thread t owns [t R, t R + R).
template <int R, bool VEC>
struct Lane {
  float sc[R];
  unsigned out;   // bit r: candidate t R + r banned, queued, -inf or past W
  unsigned ban;   // bit r: candidate t R + r banned

  // Loads the scores; false (in every thread) if one is +inf or NaN, when
  // greedy picks nothing at all.
  __device__ bool load(const float* s, int W, int t) {
    out = ban = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = t * R + r;
      if constexpr (VEC) {   // W % 4 == 0: a float4 is all in or all out
        if (r % 4 == 0 && i < W) {
          const float4 v = *reinterpret_cast<const float4*>(s + i);
          sc[r] = v.x;
          sc[r + 1] = v.y;
          sc[r + 2] = v.z;
          sc[r + 3] = v.w;
        }
        if (i < W) continue;
      }
      sc[r] = i < W ? s[i] : -INFINITY;
    }
    // -inf is never picked
    bool bad = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (sc[r] == -INFINITY) out |= 1u << r;
      bad |= !(sc[r] < INFINITY);
    }
    return !__any_sync(kFull, bad);
  }

  // The best candidate not out: its index in every thread, or -1 if none.
  // The thread's best is a tree over its R (the left operand kept on ties:
  // the lower index), then the warp's.
  __device__ int argmax(int t) const {
    float v[R];
    int ix[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = (out >> r) & 1u ? -INFINITY : sc[r];
      ix[r] = r;
    }
#pragma unroll
    for (int w = 1; w < R; w *= 2)
#pragma unroll
      for (int r = 0; r + w < R; r += 2 * w)
        if (v[r + w] > v[r]) {
          v[r] = v[r + w];
          ix[r] = ix[r + w];
        }
    float bv = v[0];
    int bi = v[0] > -INFINITY ? t * R + ix[0] : INT_MAX;
    warp_best(bv, bi);
    return bv > -INFINITY ? bi : -1;
  }

  // Bans row bits `bits` (this thread's R) and candidate j.
  __device__ void apply(unsigned bits, int j, int t) {
    if (j / R == t) bits |= 1u << (j % R);
    ban |= bits;
    out |= bits;
  }

  __device__ bool banned(int j) const {
    return __shfl_sync(kFull, (ban >> (j % R)) & 1u, j / R);
  }
};

__device__ __forceinline__ void pad_sel(int* sel, int from, int k, int tid,
                                        int nthreads) {
  for (int s = from + tid; s < k; s += nthreads) sel[s] = -1;
}

template <int R, bool VEC>
__global__ void __launch_bounds__(32)
    greedy_staged_kernel(const float* __restrict__ scores,
                         const unsigned char* __restrict__ adj, int* sel,
                         int W, int k, int g) {
  extern __shared__ __align__(16) unsigned char rows[];   // row stride 32 R
  constexpr int S = 32 * R;
  const int b = blockIdx.x, t = threadIdx.x;
  Pieces(W, g, t).copy(rows, S, adj + (size_t)b * W * W, W, W);
  Lane<R, VEC> L;
  int* out = sel + (size_t)b * k;
  const bool ok = L.load(scores + (size_t)b * W, W, t);
  int j = ok ? L.argmax(t) : -1;
  rt::cp_async_wait<0>();
  __syncwarp();
  for (int s = 0; s < k; ++s) {
    if (j < 0) return pad_sel(out, s, k, t, 32);
    if (t == 0) out[s] = j;
    L.apply(pack_bits<R>(rows + (size_t)j * S + t * R), j, t);
    j = L.argmax(t);
  }
}

// A thread's R bytes of one adjacency row, loaded into registers: as
// 32-bit words where they are aligned to min(R, 16) (ALIGNED), else byte by
// byte. Only the first `lim` bytes lie in the row (W - t R, at most R, may
// be 0 or less); the rest are not read and give no bit. Aligned, W and t R
// are multiples of min(R, 16), so a word is all in the row or all past it.
// Nothing reads the loads before bits(), so they stay in flight.
template <int R, bool ALIGNED>
struct RowPart {
  static constexpr int N = ALIGNED ? (R >= 4 ? R / 4 : 1) : R;
  unsigned u[N];

  __device__ __forceinline__ void load(const unsigned char* p, int lim) {
    if constexpr (!ALIGNED) {
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = r < lim ? __ldg(p + r) : 0u;
    } else if constexpr (R >= 16) {
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const uint4 v = 4 * q < lim
                            ? __ldg(reinterpret_cast<const uint4*>(p) + q / 4)
                            : make_uint4(0u, 0u, 0u, 0u);
        u[q] = v.x;
        u[q + 1] = v.y;
        u[q + 2] = v.z;
        u[q + 3] = v.w;
      }
    } else if constexpr (R == 8) {
      const uint2 v = lim > 0 ? __ldg(reinterpret_cast<const uint2*>(p))
                              : make_uint2(0u, 0u);
      u[0] = v.x;
      u[1] = v.y;
    } else if constexpr (R == 4) {
      u[0] = lim > 0 ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
    } else if constexpr (R == 2) {
      u[0] = lim > 0 ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
    } else {
      u[0] = lim > 0 ? __ldg(p) : 0u;
    }
  }

  __device__ __forceinline__ unsigned bits() const {
    unsigned b = 0u;
#pragma unroll
    for (int q = 0; q < N; ++q)
      b |= ALIGNED ? nonzero4(u[q]) << (4 * q) : (u[q] != 0u) << q;
    return b;
  }
};

template <int R, bool VEC, bool ALIGNED>
__global__ void __launch_bounds__(32)
    greedy_prefetch_kernel(const float* __restrict__ scores,
                           const unsigned char* __restrict__ adj, int* sel,
                           int W, int k) {
  const int b = blockIdx.x, t = threadIdx.x, lim = W - t * R;
  const unsigned char* a = adj + (size_t)b * W * W + t * R;
  Lane<R, VEC> L;
  int* out = sel + (size_t)b * k;
  if (!L.load(scores + (size_t)b * W, W, t)) return pad_sel(out, 0, k, t, 32);
  // A queue of the next kQueue candidates in (score desc, index asc) order,
  // each extracted by the argmax over the candidates neither banned nor
  // queued, with each thread's part of its row loading into registers.
  // Slot q is popped and refilled in turn, q = 0, 1, ..., so every index
  // into the slots is a constant and no load is waited on before its pop.
  // A popped candidate still unbanned is the pick; -1 marks an empty slot,
  // after which every later one is empty too.
  RowPart<R, ALIGNED> part[kQueue];
  int id[kQueue];
  auto refill = [&](int q) {
    const int i = L.argmax(t);
    if (i >= 0 && i / R == t) L.out |= 1u << (i % R);
    id[q] = i;
    part[q].load(a + (size_t)(i < 0 ? 0 : i) * W, lim);
  };
#pragma unroll
  for (int q = 0; q < kQueue; ++q) refill(q);
  int picks = 0;
  while (picks < k && id[0] >= 0) {
#pragma unroll
    for (int q = 0; q < kQueue; ++q) {
      const int h = id[q];
      if (h < 0 || picks == k) break;
      if (!L.banned(h)) {
        L.apply(part[q].bits(), h, t);
        if (t == 0) out[picks] = h;
        ++picks;
      }
      refill(q);
    }
  }
  pad_sel(out, picks, k, t, 32);
}

template <bool SMEM_SCORES>
__global__ void __launch_bounds__(kBlockThreads)
    greedy_block_kernel(const float* __restrict__ scores,
                        const unsigned char* __restrict__ adj, int* sel,
                        int W, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];
  const int nw = (W + 31) / 32;
  unsigned* banned = reinterpret_cast<unsigned*>(smem);   // nw words
  float* ssc = reinterpret_cast<float*>(banned + nw);     // nw * 32 scores
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* s = scores + (size_t)b * W;
  const unsigned char* a = adj + (size_t)b * W * W;
  // each warp sets up and later reads only its own chunks
  for (int c = warp; c < nw; c += nwarps) {
    const int i = 32 * c + lane;
    if (SMEM_SCORES) ssc[i] = i < W ? no_nan(s[i]) : -INFINITY;
    if (lane == 0) banned[c] = 0u;
  }
  __syncwarp();
  int* out = sel + (size_t)b * k;
  for (int st = 0; st < k; ++st) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = warp; c < nw; c += nwarps) {
      const int i = 32 * c + lane;
      if (i < W && !((banned[c] >> lane) & 1u)) {
        const float v = SMEM_SCORES ? ssc[i] : no_nan(s[i]);
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
    }
    rt::warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[st & 1][warp] = bv;
      red_i[st & 1][warp] = bi;
    }
    __syncthreads();
    bv = lane < nwarps ? red_v[st & 1][lane] : -INFINITY;
    bi = lane < nwarps ? red_i[st & 1][lane] : INT_MAX;
    rt::warp_argmax(bv, bi);
    if (!isfinite(bv)) return pad_sel(out, st, k, tid, blockDim.x);
    if (tid == 0) out[st] = bi;
    // the row's bytes of 8 chunks a warp are loaded before any is used
    const unsigned char* row = a + (size_t)bi * W;
    for (int c0 = warp; c0 < nw; c0 += 8 * nwarps) {
      unsigned char v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = 32 * (c0 + u * nwarps) + lane;
        v[u] = i < W ? __ldg(row + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u * nwarps;
        const unsigned bal = __ballot_sync(kFull, v[u] != 0);
        if (lane == 0 && c < nw)
          banned[c] |= bal | (c == bi / 32 ? 1u << (bi & 31) : 0u);
      }
    }
    __syncwarp();
  }
}

struct Plan {
  int route, threads, R;
  size_t smem;
};

Plan plan(int W) {
  const int R = W <= 32 ? 1 : W <= 64 ? 2 : W <= 128 ? 4 : W <= 256 ? 8
              : W <= 512 ? 16 : 32;
  if (W <= kStagedMax) return Plan{kStaged, 32, R, (size_t)W * 32 * R};
  if (W <= kWarpMax) return Plan{kPrefetch, 32, R, 0};
  const size_t nw = (size_t)(W + 31) / 32;
  const size_t with_scores = nw * 4 + nw * 32 * 4;
  if (with_scores <= (size_t)kMaxSmem)
    return Plan{kBlock, kBlockThreads, 0, with_scores};
  return Plan{kBlockStreamed, kBlockThreads, 0, nw * 4};
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int R, bool VEC>
int launch_route(const Plan& p, const float* scores, const unsigned char* adj,
                 int* sel, int B, int W, int k, int arg, cudaStream_t stream) {
  // R <= 4 is the staged route (W <= 128: at most 16 KB of rows a lane),
  // R >= 8 the prefetch route
  if constexpr (R <= 4)
    greedy_staged_kernel<R, VEC><<<B, 32, p.smem, stream>>>(scores, adj, sel,
                                                          W, k, arg);
  else if (arg)
    greedy_prefetch_kernel<R, VEC, true><<<B, 32, 0, stream>>>(scores, adj,
                                                             sel, W, k);
  else
    greedy_prefetch_kernel<R, VEC, false><<<B, 32, 0, stream>>>(scores, adj,
                                                              sel, W, k);
  return (int)cudaGetLastError();
}

// arg: the staged route's piece size, the prefetch route's alignment
template <int R>
int launch_warp(const Plan& p, bool vec, const float* scores,
                const unsigned char* adj, int* sel, int B, int W, int k,
                int arg, cudaStream_t stream) {
  if constexpr (R % 4 == 0)
    if (vec)
      return launch_route<R, true>(p, scores, adj, sel, B, W, k, arg, stream);
  return launch_route<R, false>(p, scores, adj, sel, B, W, k, arg, stream);
}

template <bool SMEM_SCORES>
int launch_block(const Plan& p, const float* scores, const unsigned char* adj,
                 int* sel, int B, int W, int k, cudaStream_t stream) {
  auto kernel = greedy_block_kernel<SMEM_SCORES>;
  // raised once per device, to the largest size asked so far
  static int cached_dev = -1;
  static size_t allowed = 0;
  int rc, dev = 0;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev != cached_dev || p.smem > allowed) {
    if ((rc = allow_smem(kernel, p.smem))) return rc;
    cached_dev = dev;
    allowed = p.smem > 48 * 1024 ? p.smem : 48 * 1024;
  }
  kernel<<<B, p.threads, p.smem, stream>>>(scores, adj, sel, W, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The route a lane of W candidates runs: out = {route (0 staged, 1
// prefetch, 2 block with the scores in shared memory, 3 block reading them
// from device memory), threads a lane, candidates a thread (warp routes),
// dynamic shared memory bytes}.
extern "C" int greedy_plan(int W, long long* out) {
  if (W < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(W);
  out[0] = p.route;
  out[1] = p.threads;
  out[2] = p.R;
  out[3] = (long long)p.smem;
  return p.smem <= (size_t)kMaxSmem ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" int greedy_batch(const float* scores, const unsigned char* adj,
                            int* sel, int B, int K, int k, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(K);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // staged: the lane's W x W bytes in g-byte pieces, each row starting on a
  // multiple of g; prefetched: each thread's R bytes of a row in one load
  // where they are aligned to min(R, 16), else byte by byte
  const uintptr_t a = (uintptr_t)adj;
  int arg = 0;
  if (p.route == kStaged)
    arg = K % 16 == 0 && a % 16 == 0 ? 16 : K % 4 == 0 && a % 4 == 0 ? 4 : 1;
  else if (p.route == kPrefetch)
    arg = a % 16 == 0 && K % (p.R < 16 ? p.R : 16) == 0;
  const bool vec = K % 4 == 0 && rt::aligned16(scores);
  switch (p.route) {
    case kStaged:
    case kPrefetch:
      switch (p.R) {
        case 1:
          return launch_warp<1>(p, vec, scores, adj, sel, B, K, k, arg, s);
        case 2:
          return launch_warp<2>(p, vec, scores, adj, sel, B, K, k, arg, s);
        case 4:
          return launch_warp<4>(p, vec, scores, adj, sel, B, K, k, arg, s);
        case 8:
          return launch_warp<8>(p, vec, scores, adj, sel, B, K, k, arg, s);
        case 16:
          return launch_warp<16>(p, vec, scores, adj, sel, B, K, k, arg, s);
        default:
          return launch_warp<32>(p, vec, scores, adj, sel, B, K, k, arg, s);
      }
    case kBlock:
      return launch_block<true>(p, scores, adj, sel, B, K, k, s);
    default:
      return launch_block<false>(p, scores, adj, sel, B, K, k, s);
  }
}
