// PQ lookup-table sums: the gather part of the compressed-corpus scorer.
//
// Replaces the Pallas kernel pq_lut_sum_pallas
// (src/repro/kernels/pq_lut_similarity.py:47):
//
//   out[b, n] = sum_m T[b, m, codes[n, m]]   f32, added m = 0 .. M-1 in turn
//
// Every code must be under C (the Python wrapper checks it when C < 256).
// The sum starts from -0.0, the identity of IEEE addition (-0 + x is x for
// every x, signed zeros included), and adds each entry with __fadd_rn, which
// the compiler never contracts or reorders, so the result equals
// repro_torch.quant.pq_lut_sum (and the reference's) bit for bit on the
// same T.
//
// Bound on the card: at b = 16, n = 1M, M = 16, C = 256 it reads 16 MB of
// codes and writes 64 MB of sums for 256 M float additions, so it is bound
// by bytes (~0.024 ms at 3.35 TB/s). Its real floor is the 256 M table
// lookups: shared memory serves 32 banks of 4 bytes a clock on each SM, so
// even free of bank conflicts they take ~31 us on 132 SMs at 1.98 GHz.
// The TPU kernel gathered through one-hot matmuls because the TPU has no
// fast gather; Hopper gathers from shared memory directly.
//
// Design: a block holds QG queries' tables in shared memory, interleaved by
// query and transposed as it stages them, and walks the corpus rows
// grid-stride. A lookup of row n at subspace m reads the QG queries'
// entries of code c as one span, so the threads that share a row share a
// span and only threads of different rows can meet in a bank: at QG = 8
// two threads take a row, four queries each with one 16-byte load. QG is 8
// for five queries or more, 4 for two to four, 1 for one query (the cos
// path's centroid-norm sums) or when 4 tables do not fit. At QG = 8 and
// M = 16 (the compressed path's shape) a skewed schedule makes the loads
// free of bank conflicts (pq_lut_sum_kernel_skew); otherwise a quarter-warp
// of 4 rows at random codes costs ~2.1 wavefronts for 32 lookups. The
// sums go out with streaming stores (st.global.cs), so the 64 MB of output
// does not evict the codes from L2 before the next query group reads them.
// The launch plan (attributes, blocks per SM) is asked of the runtime once
// per device and table size, not at every call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;   // a block's dynamic shared memory

template <int V>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
};
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};

// CODES: 16 = a row's codes as 16-byte words (M % 16 == 0, aligned), 4 =
// 4-byte words, 1 = bytes.
template <int QG, int CODES>
__global__ void __launch_bounds__(kThreads)
    pq_lut_sum_kernel(const float* __restrict__ T,
                      const uint8_t* __restrict__ codes,
                      float* __restrict__ out, int B, long long N, int M,
                      int C) {
  constexpr int V = QG >= 4 ? 4 : 1;   // a thread's queries (one load)
  constexpr int LPR = QG / V;          // threads a row
  constexpr int RPB = kThreads / LPR;  // rows a block pass
  extern __shared__ __align__(16) float lut[];   // [M * C][QG]
  const int q0 = blockIdx.y * QG;
  const int nq = min(QG, B - q0);
  const int MC = M * C;
  for (int mc = threadIdx.x; mc < MC; mc += kThreads) {
    float v[QG];
#pragma unroll
    for (int u = 0; u < QG; ++u)
      v[u] = u < nq ? T[(size_t)(q0 + u) * MC + mc] : 0.0f;
#pragma unroll
    for (int u = 0; u < QG; u += V) {
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(lut + (size_t)mc * QG + u) =
            make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
      else
        lut[(size_t)mc * QG + u] = v[u];
    }
  }
  __syncthreads();

  const int h = threadIdx.x % LPR;
  const float* lh = lut + h * V;
  const long long stride = (long long)gridDim.x * RPB;
  long long n = (long long)blockIdx.x * RPB + threadIdx.x / LPR;
  float acc[V];
  auto add = [&](int m, unsigned c) {
    Vec<V> t;
    t.load(lh + ((size_t)m * C + c) * QG);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], t.v[j]);
  };
  auto store = [&](long long r) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (h * V + j < nq)
        __stcs(out + (size_t)(q0 + h * V + j) * N + r, acc[j]);
  };
  if constexpr (CODES == 16) {
    // the codes of row n + stride load while row n is summed
    uint4 next = {0u, 0u, 0u, 0u};
    if (n < N) next = *reinterpret_cast<const uint4*>(codes + n * M);
    for (; n < N; n += stride) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = -0.0f;
      for (int m0 = 0; m0 < M; m0 += 16) {
        const uint4 w = next;
        const long long nn = m0 + 16 < M ? n : n + stride;
        const int off = m0 + 16 < M ? m0 + 16 : 0;
        if (nn < N)
          next = *reinterpret_cast<const uint4*>(codes + nn * M + off);
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          add(m0 + i, (words[i >> 2] >> (8 * (i & 3))) & 0xffu);
      }
      store(n);
    }
  } else {
    for (; n < N; n += stride) {
      const uint8_t* cr = codes + n * M;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = -0.0f;
      if constexpr (CODES == 4) {
        for (int m0 = 0; m0 < M; m0 += 4) {
          const unsigned w = *reinterpret_cast<const unsigned*>(cr + m0);
#pragma unroll
          for (int i = 0; i < 4; ++i) add(m0 + i, (w >> (8 * i)) & 0xffu);
        }
      } else {
#pragma unroll 4
        for (int m = 0; m < M; ++m) add(m, cr[m]);
      }
      store(n);
    }
  }
}

// CODES of the skewed schedule: 8 queries a block, M = 16 codes a row as
// one aligned 16-byte word.
constexpr int kSkew = 0;

// The same sums for QG = 8 and M = 16 with no bank conflict. Subspace m's
// entries live in bank group m % 4 of the 128-byte lines, [m / 4][c][m % 4][8]
// (one group is 32 bytes, 8 banks: one entry of 8 queries). The four rows
// of a quarter-warp (r = 0..3, two threads a row) run skewed by r
// subspaces: at unrolled step p, row r adds subspace (p - r) % 16, so the
// four rows of every load read four distinct bank groups, one wavefront for
// 32 lookups (on an H100: 57.6 us against 75.4 for the plain schedule at
// 16 x 1M, whose random codes cost ~2.1 wavefronts). Each row still adds
// its subspaces in order, m = 0 .. 15, over two passes of 16 steps.
__global__ void __launch_bounds__(kThreads)
    pq_lut_sum_kernel_skew(const float* __restrict__ T,
                           const uint8_t* __restrict__ codes,
                           float* __restrict__ out, int B, long long N,
                           int M, int C) {
  constexpr int QG = 8, RPB = kThreads / 2;
  extern __shared__ __align__(16) float lut[];   // [4][C][4][8]
  const int q0 = blockIdx.y * QG;
  const int nq = min(QG, B - q0);
  const int MC = 16 * C;
  // staging: thread e writes half (e & 1) of group ((e >> 1) & 3) of line
  // e >> 3, so the 8 threads of a quarter-warp fill one line
  for (int e = threadIdx.x; e < 2 * MC; e += kThreads) {
    const int half = e & 1, g = (e >> 1) & 3, line = e >> 3;
    const int m = 4 * (line / C) + g, c = line % C;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = half * 4 + j < nq
                 ? T[(size_t)(q0 + half * 4 + j) * MC + (size_t)m * C + c]
                 : 0.0f;
    *reinterpret_cast<float4*>(lut + (size_t)e * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  // thread: half h (queries 4 h .. 4 h + 3) of row slot j of its warp,
  // r = j % 4 its skew
  const int h = threadIdx.x & 1, j = (threadIdx.x & 31) >> 1, r = j & 3;
  const long long stride = (long long)gridDim.x * RPB;
  const long long n0 = (long long)blockIdx.x * RPB + (threadIdx.x >> 1);
  const float* lh = lut + h * 4;
  // where step p reads: subspace m = (p - r) % 16 of its row
  int off[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int m = (p - r) & 15;
    off[p] = ((m >> 2) * C * 4 + (m & 3)) * 8;
  }
  // Pass i: steps p < r end row n0 + (i - 1) stride (its subspaces
  // 16 - r .. 15), steps p >= r start row n0 + i stride; so a thread's rows
  // run one pass each, and the warp makes one pass more than its most rows.
  // Step p's code is byte p of the pass's codes: the last r bytes of the
  // ending row's, then the first 16 - r of the starting row's.
  const unsigned rows = n0 < N ? (unsigned)((N - 1 - n0) / stride) + 1u : 0u;
  const unsigned passes = __reduce_max_sync(0xffffffffu, rows) + 1u;
  auto load = [&](long long n) {
    return n < N ? *reinterpret_cast<const uint4*>(codes + n * 16)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 old = make_uint4(0u, 0u, 0u, 0u), now = load(n0);
  // prev: the row that ends in this pass (its steps p < r); cur: the row
  // that starts (steps p >= r). Every thread stores prev at the pass's end,
  // so a warp's stores cover its 16 rows.
  float prev[4], cur[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) prev[q] = cur[q] = -0.0f;
  long long row = n0 - stride;   // prev's row
  for (unsigned pass = 0; pass < passes; ++pass, row += stride) {
    const uint4 next = load(row + 2 * stride);
    const int sh = 8 * r;
    const unsigned pw[4] = {__funnelshift_l(old.w, now.x, sh),
                            __funnelshift_l(now.x, now.y, sh),
                            __funnelshift_l(now.y, now.z, sh),
                            __funnelshift_l(now.z, now.w, sh)};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const unsigned c = (pw[p >> 2] >> (8 * (p & 3))) & 0xffu;
      const float4 t =
          *reinterpret_cast<const float4*>(lh + off[p] + (int)c * 32);
      const float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (p < 4 && p < r)
          prev[q] = __fadd_rn(prev[q], v[q]);
        else
          cur[q] = __fadd_rn(cur[q], v[q]);
      }
    }
    if (row >= 0 && row < N) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (h * 4 + q < nq)
          __stcs(out + (size_t)(q0 + h * 4 + q) * N + row, prev[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      prev[q] = cur[q];
      cur[q] = -0.0f;
    }
    old = now;
    now = next;
  }
}

// Queries a block holds: 8 from five queries up, 4 from two, else 1, and
// fewer where their tables do not fit a block's shared memory.
int group_size(int B, size_t per_q) {
  if (B >= 5 && 8 * per_q <= (size_t)kMaxSmem) return 8;
  if (B >= 2 && 4 * per_q <= (size_t)kMaxSmem) return 4;
  return 1;
}

template <int QG, int CODES>
int launch(const float* T, const uint8_t* codes, float* out, int B,
           long long N, int M, int C, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (CODES == kSkew) return pq_lut_sum_kernel_skew;
    else return pq_lut_sum_kernel<QG, CODES>;
  }();
  const size_t smem = (size_t)QG * M * C * sizeof(float);
  // set and asked once per (device, table size): a call costs the host
  // only its launch
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int rc, dev = 0;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if (dev != cached_dev || smem != cached_smem) {
    if ((rc = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)) ||
        (rc = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)))
      return rc;
    cached_dev = dev;
    cached_smem = smem;
  }
  constexpr int rpb = kThreads / (QG >= 4 ? QG / 4 : 1);
  const unsigned groups = (unsigned)((B + QG - 1) / QG);
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  // one wave over the card: each block stages its tables once
  long long gx = ((long long)sms * (per_sm > 0 ? per_sm : 1) + groups - 1) /
                 groups;
  const long long need = (N + rpb - 1) / rpb;
  gx = gx < 1 ? 1 : (gx > need ? need : gx);
  kernel<<<dim3((unsigned)gx, groups), kThreads, smem, stream>>>(
      T, codes, out, B, N, M, C);
  return (int)cudaGetLastError();
}

template <int QG>
int launch_codes(const float* T, const uint8_t* codes, float* out, int B,
                 long long N, int M, int C, cudaStream_t stream) {
  const uintptr_t a = (uintptr_t)codes;
  if constexpr (QG == 8)
    if (M == 16 && a % 16 == 0)
      return launch<QG, kSkew>(T, codes, out, B, N, M, C, stream);
  if (M % 16 == 0 && a % 16 == 0)
    return launch<QG, 16>(T, codes, out, B, N, M, C, stream);
  if (M % 4 == 0 && a % 4 == 0)
    return launch<QG, 4>(T, codes, out, B, N, M, C, stream);
  return launch<QG, 1>(T, codes, out, B, N, M, C, stream);
}

}  // namespace

extern "C" int pq_lut_sum(const float* T, const uint8_t* codes, float* out,
                          int B, long long N, int M, int C, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const size_t per_q = (size_t)M * C * sizeof(float);
  if (M <= 0 || C <= 0 || C > 256 || per_q > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group_size(B, per_q)) {
    case 8: return launch_codes<8>(T, codes, out, B, N, M, C, s);
    case 4: return launch_codes<4>(T, codes, out, B, N, M, C, s);
    default: return launch_codes<1>(T, codes, out, B, N, M, C, s);
  }
}
