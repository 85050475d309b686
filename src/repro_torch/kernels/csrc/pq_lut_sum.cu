// PQ lookup-table sums: the gather part of the compressed-corpus scorer.
//
// Replaces the Pallas kernel pq_lut_sum_pallas
// (src/repro/kernels/pq_lut_similarity.py:47):
//
//   out[b, n] = sum_m T[b, m, codes[n, m]]   f32, added m = 0 .. M-1 in turn
//
// Every code must be under C (the Python wrapper checks it when C < 256).
// The sum starts from the m = 0 entry and adds each later one with
// __fadd_rn, which the compiler never contracts or reorders, so the result
// equals repro_torch.quant.pq_lut_sum (and the reference's) bit for bit on
// the same T.
//
// Bound on the card: at b = 16, n = 1M, M = 16, C = 256 it reads 16 MB of
// codes and writes 64 MB of sums for 256 M float additions, so it is bound
// by bytes (~0.024 ms at 3.35 TB/s). The TPU kernel gathered through
// one-hot matmuls because the TPU has no fast gather; Hopper gathers from
// shared memory directly. Design: a block holds the tables of up to 8
// queries in shared memory (16 KB each at M = 16, C = 256; above 48 KB by
// opt-in) and walks the corpus rows grid-stride, so each block loads its
// tables once. A thread reads its row's M codes (16-byte loads when
// M % 16 == 0) and keeps one running sum per query in registers; writes
// are coalesced along rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQG = 8;                  // queries per block
constexpr int kThreads = 512;
constexpr int kMaxSmem = 200 * 1024;    // tables of one block

__global__ void __launch_bounds__(kThreads)
    pq_lut_sum_kernel(const float* __restrict__ T,
                      const uint8_t* __restrict__ codes,
                      float* __restrict__ out, int B, long long N, int M,
                      int C, int qg, int vec16) {
  extern __shared__ float lut[];  // nq * M * C
  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, B - q0);
  const int per_q = M * C;
  const float* src = T + (size_t)q0 * per_q;
  for (int i = threadIdx.x; i < nq * per_q; i += blockDim.x) lut[i] = src[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const uint8_t* cr = codes + n * M;
    float acc[kQG];
#pragma unroll
    for (int u = 0; u < kQG; ++u) acc[u] = 0.0f;
    auto add = [&](int m, int c) {
      const float* tm = lut + m * C + c;
#pragma unroll
      for (int u = 0; u < kQG; ++u)
        if (u < nq) {
          const float v = tm[u * per_q];
          acc[u] = m == 0 ? v : __fadd_rn(acc[u], v);
        }
    };
    if (vec16) {
      for (int m0 = 0; m0 < M; m0 += 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(cr + m0);
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          add(m0 + i, (int)((words[i >> 2] >> (8 * (i & 3))) & 0xffu));
      }
    } else {
      for (int m = 0; m < M; ++m) add(m, (int)cr[m]);
    }
#pragma unroll
    for (int u = 0; u < kQG; ++u)
      if (u < nq) out[(long long)(q0 + u) * N + n] = acc[u];
  }
}

}  // namespace

extern "C" int pq_lut_sum(const float* T, const uint8_t* codes, float* out,
                          int B, long long N, int M, int C, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const size_t per_q = (size_t)M * C * sizeof(float);
  if (M <= 0 || C <= 0 || C > 256 || per_q > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int qg = (int)(kMaxSmem / per_q);
  qg = qg > kQG ? kQG : qg;
  qg = qg > B ? B : qg;
  const size_t smem = (size_t)qg * per_q;
  cudaError_t err = cudaFuncSetAttribute(
      pq_lut_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pq_lut_sum_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const unsigned groups = (unsigned)((B + qg - 1) / qg);
  // one wave over the card: each block loads its tables once
  long long gx = ((long long)sms * (per_sm > 0 ? per_sm : 1) + groups - 1) /
                 groups;
  const long long need = (N + kThreads - 1) / kThreads;
  gx = gx < 1 ? 1 : (gx > need ? need : gx);
  const int vec16 = (M % 16 == 0) && (((uintptr_t)codes & 15) == 0);
  pq_lut_sum_kernel<<<dim3((unsigned)gx, groups), kThreads, smem,
                      (cudaStream_t)stream>>>(T, codes, out, B, N, M, C, qg,
                                              vec16);
  return (int)cudaGetLastError();
}
