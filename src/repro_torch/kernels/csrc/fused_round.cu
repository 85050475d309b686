// One fused progressive round per lane: prefix mask, candidate gather and
// k greedy steps over G^eps, scoring only the rows greedy picks.
//
// Replaces the Pallas kernel fused_round_batch_pallas
// (src/repro/kernels/fused_round.py:99). Per lane b, candidate i of the raw
// queue prefix is valid when i < Ks[b] and ids[b, i] >= 0. Greedy picks the
// best valid candidate that is not banned (masked argmax, lowest index on
// ties, as greedy.cuh and the plain version), then bans its G^eps
// neighbours: the candidates j with sim(x[ids[pick]], x[ids[j]]) > eps[b].
// Outputs per lane: sel_ids (k) the picks' global ids, -1 padded; selsc (k)
// picked scores, 0 where no pick; count; and cert (2) = (sum of selsc in
// pick order, as the plain version sums it, and the smallest valid score or
// -inf).
//
// The TPU kernel builds the whole (W, W) adjacency and then runs greedy on
// it. Greedy only ever reads the rows it picks, and a banned candidate stays
// banned, so here each step scores the picked row against the candidates
// still unbanned and nothing else: k * W sims in place of W * W, the same
// picks. Every sim is sim.cuh's sequential __fmaf_rn chain (dot and both
// norms), bitwise the sim the adjacency and the scorers give.
//
// Bound on the card: the bytes of the valid prefix's rows, ids and scores
// (~1.4 us at 16 x 1024 x 96), but the floor is the chain of k dependent
// steps, each a d-long FMA chain per candidate plus a block (and cluster)
// argmax. One launch does everything, with no scratch in device memory.
//
// Layout, chosen from W and d by fused_round_plan:
// - staged: the lane's W candidates in one block, or split over a cluster
//   of C = 8 blocks where one block's shared memory cannot hold them (8
//   beat 2 and 4 on the card), each block holding its slice's rows,
//   ids and scores in shared memory (rows at an odd 16-byte-word stride, so
//   a warp's float4 reads of 32 rows are conflict-free), copied in with
//   cp.async. A step's argmax is reduced in the block; in a cluster each
//   block then pushes its best (score, index, id) and that candidate's row
//   into every block's shared memory (distributed shared memory stores)
//   before barrier.cluster, so after it every warp reduces the C bests
//   itself and the picked row is already local: one block barrier and one
//   cluster barrier a step, no remote load on the critical path, and one
//   cluster barrier before the first push, so that every block has started.
// - streamed: past what a cluster of 8 holds, the same cluster of 8 reads
//   each candidate's row from device memory (L2) at every step.
// Each thread owns candidates t, t + T, ... of its block's slice (blocks of
// 256 to 512 threads: enough warps to issue the staging copies together,
// and room for ~90 registers a thread, so a step's dot chain loads its next
// float4s while it runs). A staged candidate's squared norm is computed once, when
// its row lands, so a step runs one d-long chain a candidate, the dot. The
// banned set is one bit per candidate in shared memory, one word per warp
// and round, so only its warp writes it.
#include <algorithm>
#include <climits>

#include <cooperative_groups.h>

#include "cp_async.cuh"
#include "greedy.cuh"
#include "sim.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;   // 128 registers a thread
constexpr int kMinThreads = 256;   // warps enough to issue the staging
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 227 * 1024 - 1024;  // a block's dynamic shared
                                             // memory, beside its static

// A block's best candidate of a step, pushed to every block of the cluster.
struct Best {
  float v;   // best unbanned score, -inf if none
  int i;     // its candidate index (INT_MAX if none)
  int id;    // its corpus row
  float nn;  // its squared norm (staged)
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// sim(p, r) for the streamed route: p the picked row in shared memory
// (16-byte aligned), r a candidate's row in device memory (read as float4s
// when ROW4). Dot and both norms in sim.cuh's order.
template <bool ROW4>
__device__ __forceinline__ float pair_sim(const float* p, const float* r,
                                          int d, int metric) {
  float dot = 0.0f, pp = 0.0f, rr = 0.0f;
  int j = 0;
  if (ROW4) {
    for (; j + 4 <= d; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + j);
      const float4 b = *reinterpret_cast<const float4*>(r + j);
      dot = __fmaf_rn(a.x, b.x, dot);
      pp = __fmaf_rn(a.x, a.x, pp);
      rr = __fmaf_rn(b.x, b.x, rr);
      dot = __fmaf_rn(a.y, b.y, dot);
      pp = __fmaf_rn(a.y, a.y, pp);
      rr = __fmaf_rn(b.y, b.y, rr);
      dot = __fmaf_rn(a.z, b.z, dot);
      pp = __fmaf_rn(a.z, a.z, pp);
      rr = __fmaf_rn(b.z, b.z, rr);
      dot = __fmaf_rn(a.w, b.w, dot);
      pp = __fmaf_rn(a.w, a.w, pp);
      rr = __fmaf_rn(b.w, b.w, rr);
    }
  }
  for (; j < d; ++j) {
    const float a = p[j], b = r[j];
    dot = __fmaf_rn(a, b, dot);
    pp = __fmaf_rn(a, a, pp);
    rr = __fmaf_rn(b, b, rr);
  }
  return rt::finish_sim(dot, pp, rr, metric);
}

// sim.cuh's dot_seq over two rows in shared memory (16-byte aligned), read
// as float4s one step ahead of the FMAs that use them, so a step's loads
// wait behind the previous step's chain and not in front of its own.
__device__ __forceinline__ float dot_smem(const float* p, const float* r,
                                          int d) {
  float acc = 0.0f;
  const int d4 = d / 4;
  if (d4 > 0) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(r);
#pragma unroll 4
    for (int q = 1; q < d4; ++q) {
      const float4 an = *reinterpret_cast<const float4*>(p + 4 * q);
      const float4 bn = *reinterpret_cast<const float4*>(r + 4 * q);
      acc = __fmaf_rn(a.x, b.x, acc);
      acc = __fmaf_rn(a.y, b.y, acc);
      acc = __fmaf_rn(a.z, b.z, acc);
      acc = __fmaf_rn(a.w, b.w, acc);
      a = an;
      b = bn;
    }
    acc = __fmaf_rn(a.x, b.x, acc);
    acc = __fmaf_rn(a.y, b.y, acc);
    acc = __fmaf_rn(a.z, b.z, acc);
    acc = __fmaf_rn(a.w, b.w, acc);
  }
  for (int j = 4 * d4; j < d; ++j) acc = __fmaf_rn(p[j], r[j], acc);
  return acc;
}

// Shared memory of one block, in floats: [rows P*S] [ids P] [scores P]
// [squared norms P] (staged only), the banned words, then (clusters only)
// the pushed rows: one a block and step parity, 2*C*S.
struct Layout {
  int S, M, nwarps;
  size_t rows, ids, sc, nrm, banned, cand, bytes;
  __host__ __device__ Layout(int P, int d, int T, int C, bool staged)
      : S(rt::padded_stride(d)), M((P + T - 1) / T), nwarps(T / 32) {
    rows = 0;
    ids = staged ? (size_t)P * S : 0;
    sc = ids + (staged ? P : 0);
    nrm = sc + (staged ? P : 0);
    banned = nrm + (staged ? P : 0);
    cand = (banned + (size_t)M * nwarps + 3) / 4 * 4;
    bytes = (cand + (C > 1 ? (size_t)2 * C * S : 0)) * 4;
  }
};

template <bool STAGED, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_round_kernel(const float* __restrict__ x,
                       const int* __restrict__ ids,
                       const float* __restrict__ scores,
                       const int* __restrict__ Ks,
                       const float* __restrict__ eps,
                       int* __restrict__ sel_ids, float* __restrict__ selsc,
                       int* __restrict__ count, float* __restrict__ cert,
                       int W, int d, int k, int metric, int P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[2][32];           // warps' bests, by step parity
  __shared__ int red_i[2][32];
  __shared__ Best slots[2][kMaxCluster];   // blocks' bests, by step parity
  __shared__ float mins[kMaxCluster];      // blocks' smallest valid scores
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int T = blockDim.x;
  const Layout L(P, d, T, C, STAGED);
  const int S = L.S, nw = L.nwarps;
  float* rows = smem + L.rows;
  int* sid = reinterpret_cast<int*>(smem + L.ids);
  float* ssc = smem + L.sc;
  float* nrm = smem + L.nrm;
  unsigned* banned = reinterpret_cast<unsigned*>(smem + L.banned);
  float* cand = smem + L.cand;
  const int* lane_ids = ids + (size_t)b * W;
  const float* lane_sc = scores + (size_t)b * W;
  const int lo = rank * P, n = max(0, min(P, W - lo));  // slice [lo, lo + n)
  const int Kb = min(max(Ks[b], 0), W);
  const float e = eps[b];

  // 1. the slice's candidates: validity as banned bits, ids and scores
  // (staged: into shared memory), the smallest valid score
  float mn = INFINITY;
  bool any = false;
  for (int m = 0; m < L.M; ++m) {
    const int li = m * T + t, i = lo + li;
    const int id = li < n ? lane_ids[i] : -1;
    const float s = li < n ? lane_sc[i] : -INFINITY;
    const bool valid = li < n && i < Kb && id >= 0;
    if (valid) {
      mn = fminf(mn, s);
      any = true;
    }
    if (STAGED && li < n) {
      sid[li] = id;
      ssc[li] = s;
    }
    const unsigned w = __ballot_sync(0xffffffffu, !valid);
    if (lane == 0) banned[m * nw + warp] = w;
  }
  mn = warp_min(mn);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) red_v[1][warp] = any ? mn : NAN;  // NaN: no valid candidate
  __syncthreads();
  if (STAGED) {
    // every thread copies 16-byte pieces (4-byte when !VEC) of the valid
    // rows into rows + li * S: the block's warps issue the gather together
    const int unit = VEC ? 4 : 1, du = d / unit;
    for (int q = t; q < n * du; q += T) {
      const int li = q / du, c = (q - li * du) * unit;
      const int id = sid[li];
      if (lo + li >= Kb || id < 0) continue;
      if (VEC)
        rt::cp_async16(rows + (size_t)li * S + c, x + (size_t)id * d + c);
      else
        rt::cp_async4(rows + (size_t)li * S + c, x + (size_t)id * d + c);
    }
    rt::cp_async_commit();
  }
  // Every block of the cluster has started before any block stores into
  // another's shared memory (the smallest score here, the bests and rows at
  // each step); the staging copies run on under the barrier.
  if (C > 1) cluster.sync();
  if (warp == 0) {  // this block's smallest valid score, to rank 0
    float m2 = lane < nw ? red_v[1][lane] : NAN;
    m2 = warp_min(m2);  // fminf: NaN only where every entry is NaN
    if (lane == 0) {
      float* dst = C > 1 ? cluster.map_shared_rank(&mins[rank], 0)
                         : &mins[0];
      *dst = m2;
    }
  }
  if (STAGED) {  // each valid candidate's squared norm, once
    rt::cp_async_wait<0>();
    __syncthreads();
    for (int m = 0; m < L.M; ++m) {
      const int li = m * T + t;
      if (li < n && lo + li < Kb && sid[li] >= 0)
        nrm[li] = dot_smem(rows + (size_t)li * S, rows + (size_t)li * S, d);
    }
  }
  __syncthreads();

  // 2. k dependent steps. Step st scores the previous pick jp (its row at
  // prow) against this thread's unbanned candidates, bans those over eps
  // (and jp itself) and keeps the best of the rest. The block's best goes
  // to every block of the cluster, its row too; after the cluster barrier
  // each warp reduces those C bests itself, so the next pick and its row
  // are local.
  int jp = -1;
  const float* prow = nullptr;
  float pn = 0.0f;  // the pick's squared norm (staged)
  float total = 0.0f;
  int picks = 0;
  const int steps = max(k, 1);  // k = 0 still reduces the smallest score
  for (int st = 0; st < steps; ++st) {
    const int par = st & 1;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int m = 0; m < L.M; ++m) {
      const int li = m * T + t, i = lo + li;
      const unsigned word = banned[m * nw + warp];
      bool ban = false;
      if (!((word >> lane) & 1u)) {
        if (i == jp) {
          ban = true;
        } else if (jp >= 0) {
          const float sim =
              STAGED ? rt::finish_sim(dot_smem(prow, rows + (size_t)li * S, d),
                                      pn, nrm[li], metric)
                     : pair_sim<VEC>(prow, x + (size_t)lane_ids[i] * d, d,
                                     metric);
          ban = sim > e;
        }
        if (!ban) {
          const float v = STAGED ? ssc[li] : lane_sc[i];
          if (v > bv) {
            bv = v;
            bi = i;
          }
        }
      }
      const unsigned nb = __ballot_sync(0xffffffffu, ban);
      if (lane == 0 && nb) banned[m * nw + warp] = word | nb;
    }
    rt::warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[par][warp] = bv;
      red_i[par][warp] = bi;
    }
    __syncthreads();
    Best o;
    if (C == 1) {  // every warp reduces the block's warps itself
      o.v = lane < nw ? red_v[par][lane] : -INFINITY;
      o.i = lane < nw ? red_i[par][lane] : INT_MAX;
      rt::warp_argmax(o.v, o.i);
      if (o.v > -INFINITY) {  // one block per lane is always staged
        o.id = sid[o.i - lo];
        prow = rows + (size_t)(o.i - lo) * S;
        pn = nrm[o.i - lo];
      }
    } else {
      if (warp == 0) {  // push the block's best and its row to every block
        float v = lane < nw ? red_v[par][lane] : -INFINITY;
        int i = lane < nw ? red_i[par][lane] : INT_MAX;
        rt::warp_argmax(v, i);
        const bool ok = v > -INFINITY;
        const int id = !ok ? -1 : STAGED ? sid[i - lo] : lane_ids[i];
        const float nn = ok && STAGED ? nrm[i - lo] : 0.0f;
        if (lane < C)
          *cluster.map_shared_rank(&slots[par][rank], lane) =
              Best{v, i, id, nn};
        if (ok) {
          const float* src = STAGED ? rows + (size_t)(i - lo) * S
                                    : x + (size_t)id * d;
          float* dst = cand + (size_t)(par * C + rank) * S;
          if (STAGED || VEC) {
            const int d4 = (d + 3) / 4;   // staged rows: whole float4s
            for (int q = lane; q < C * d4; q += 32) {
              const int r = q / d4, c = 4 * (q - r * d4);
              *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, r) + c) =
                  *reinterpret_cast<const float4*>(src + c);
            }
          } else {
            for (int q = lane; q < C * d; q += 32) {
              const int r = q / d, c = q - r * d;
              cluster.map_shared_rank(dst, r)[c] = src[c];
            }
          }
        }
      }
      cluster.sync();
      o.v = lane < C ? slots[par][lane].v : -INFINITY;
      o.i = lane < C ? slots[par][lane].i : INT_MAX;
      int id = lane < C ? slots[par][lane].id : -1;
      float nn = lane < C ? slots[par][lane].nn : 0.0f;
      const int from = lane;
      int w = from;
      {  // the best of the C blocks, and which block it came from
        float v = o.v;
        int i = o.i;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, off);
          const int oi = __shfl_xor_sync(0xffffffffu, i, off);
          const int ow = __shfl_xor_sync(0xffffffffu, w, off);
          const int oid = __shfl_xor_sync(0xffffffffu, id, off);
          const float onn = __shfl_xor_sync(0xffffffffu, nn, off);
          if (rt::better(ov, oi, v, i)) {
            v = ov;
            i = oi;
            w = ow;
            id = oid;
            nn = onn;
          }
        }
        o.v = v;
        o.i = i;
      }
      o.id = id;
      pn = nn;
      prow = cand + (size_t)(par * C + w) * S;
    }
    const bool ok = o.v > -INFINITY;
    const int j = ok ? o.i : -1;
    if (rank == 0 && t == 0) {
      if (st == 0) {
        float m2 = NAN;
        for (int r = 0; r < C; ++r) m2 = fminf(m2, mins[r]);
        cert[(size_t)b * 2 + 1] = m2 == m2 ? m2 : -INFINITY;
      }
      if (st < k) {
        sel_ids[(size_t)b * k + st] = ok ? o.id : -1;
        selsc[(size_t)b * k + st] = ok ? o.v : 0.0f;
        total = __fadd_rn(total, ok ? o.v : 0.0f);
        picks += ok;
      }
    }
    jp = j;
    if (j < 0) {  // no candidate left: every later step picks nothing
      if (rank == 0 && t == 0)
        for (int s2 = st + 1; s2 < k; ++s2) {
          sel_ids[(size_t)b * k + s2] = -1;
          selsc[(size_t)b * k + s2] = 0.0f;
        }
      break;
    }
  }
  if (rank == 0 && t == 0) {
    count[b] = picks;
    cert[(size_t)b * 2] = total;
  }
}

struct Plan {
  int cluster, staged, threads, P;
  size_t smem;
};

// Threads of a block holding P candidates: one a candidate, in whole warps,
// at least kMinThreads and at most kMaxThreads (then a thread takes several).
int threads(int P) {
  return std::min(kMaxThreads, std::max(kMinThreads, (P + 31) / 32 * 32));
}

// One block if the lane's rows fit its shared memory; else a cluster of 8,
// staged if the rows fit 8 blocks, streamed if not. Measured on an H100 at
// d = 96: once a lane needs a cluster, 8 blocks beat 2 or 4 (each block
// stages and scans fewer rows, and the push and barrier cost about the
// same), and staging beats streaming 1.6x at 16 x 1024 and 16 x 4096
// (tools/torch_adjacency_ab.py --routes).
Plan plan(int W, int d) {
  for (int C : {1, kMaxCluster}) {
    const int P = (W + C - 1) / C;
    const int T = threads(P);
    const Layout L(P, d, T, C, true);
    if (L.bytes <= (size_t)kMaxSmem) return Plan{C, 1, T, P, L.bytes};
  }
  const int P = (W + kMaxCluster - 1) / kMaxCluster;
  const int T = threads(P);
  return Plan{kMaxCluster, 0, T, P,
              Layout(P, d, T, kMaxCluster, false).bytes};
}

template <bool STAGED, bool VEC>
int launch(const Plan& p, int B, cudaStream_t stream, const float* x,
           const int* ids, const float* scores, const int* Ks,
           const float* eps, int* sel_ids, float* selsc, int* count,
           float* cert, int W, int d, int k, int metric) {
  auto kernel = fused_round_kernel<STAGED, VEC>;
  if (p.smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cluster, (unsigned)B);
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, x, ids, scores, Ks, eps,
                                 sel_ids, selsc, count, cert, W, d, k, metric,
                                 p.P);
}

}  // namespace

// The layout a (W, d) round runs with: out = {cluster size, staged (1) or
// streamed (0), threads a block, candidates a block, shared memory bytes}.
extern "C" int fused_round_plan(int W, int d, long long* out) {
  if (W < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(W, d);
  out[0] = p.cluster;
  out[1] = p.staged;
  out[2] = p.threads;
  out[3] = p.P;
  out[4] = (long long)p.smem;
  return p.smem <= (size_t)kMaxSmem ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" int fused_round(const float* x, const int* ids, const float* scores,
                           const int* Ks, const float* eps, int* sel_ids,
                           float* selsc, int* count, float* cert,
                           int B, int W, int d, int k, int metric,
                           void* stream) {
  if (B <= 0) return 0;
  if (B > 65535 || W < 0 || d <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(W, d);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && rt::aligned16(x);
  if (p.staged)
    return vec ? launch<true, true>(p, B, s, x, ids, scores, Ks, eps,
                                    sel_ids, selsc, count, cert, W, d, k,
                                    metric)
               : launch<true, false>(p, B, s, x, ids, scores, Ks, eps,
                                     sel_ids, selsc, count, cert, W, d, k,
                                     metric);
  return vec ? launch<false, true>(p, B, s, x, ids, scores, Ks, eps,
                                   sel_ids, selsc, count, cert, W, d, k,
                                   metric)
             : launch<false, false>(p, B, s, x, ids, scores, Ks, eps,
                                    sel_ids, selsc, count, cert, W, d, k,
                                    metric);
}
