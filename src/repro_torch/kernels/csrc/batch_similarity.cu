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
// Both compute each output with sim.cuh's fixed sequential order over d, so a
// (query, row) pair scores bitwise the same in either entry point and for any
// batch size: the engine's per-lane parity needs that batch invariance.
//
// Bound on the card: sim_many reads the corpus once (N*d*4 bytes) and writes
// B*N scores; at B=16, d=96 that is ~1.4 flop per byte, far below the ridge,
// so it is bound by bytes. One thread owns one corpus row and scores it
// against a register block of queries held in shared memory, so the row is
// read from device memory once per query chunk. sim_gather is a few hundred
// outputs per call and is bound by its launch.
#include "sim.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQB = 8;  // queries per register block

__global__ void sim_many_kernel(const float* __restrict__ qs,
                                const float* __restrict__ x,
                                float* __restrict__ out, int B, long long N,
                                int d, int qchunk, int metric) {
  extern __shared__ float smem[];
  float* q_s = smem;                              // qchunk * d query values
  float* qq_s = smem + (size_t)qchunk * d;        // qchunk squared norms
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;
  const float* xr = x + (live ? n : 0) * (long long)d;
  const float xx = live ? rt::dot_seq(xr, xr, d) : 0.0f;
  for (int b0 = 0; b0 < B; b0 += qchunk) {
    const int nb = min(qchunk, B - b0);
    __syncthreads();
    for (int t = threadIdx.x; t < nb * d; t += blockDim.x)
      q_s[t] = qs[(size_t)b0 * d + t];
    __syncthreads();
    for (int t = threadIdx.x; t < nb; t += blockDim.x)
      qq_s[t] = rt::dot_seq(q_s + (size_t)t * d, q_s + (size_t)t * d, d);
    __syncthreads();
    if (!live) continue;
    for (int u0 = 0; u0 < nb; u0 += kQB) {
      float acc[kQB];
#pragma unroll
      for (int u = 0; u < kQB; ++u) acc[u] = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float xv = xr[j];
#pragma unroll
        for (int u = 0; u < kQB; ++u)
          if (u0 + u < nb) acc[u] = __fmaf_rn(xv, q_s[(size_t)(u0 + u) * d + j], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kQB; ++u)
        if (u0 + u < nb)
          out[(size_t)(b0 + u0 + u) * N + n] =
              rt::finish_sim(acc[u], qq_s[u0 + u], xx, metric);
    }
  }
}

__global__ void sim_gather_kernel(const float* __restrict__ qs,
                                  const float* __restrict__ x,
                                  const int* __restrict__ ids,
                                  float* __restrict__ out, int B, int M, int d,
                                  int metric) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * M) return;
  const float* q = qs + (size_t)(t / M) * d;
  const float* xr = x + (size_t)max(ids[t], 0) * d;
  const float qq = rt::dot_seq(q, q, d);
  const float xx = rt::dot_seq(xr, xr, d);
  out[t] = rt::finish_sim(rt::dot_seq(xr, q, d), qq, xx, metric);
}

}  // namespace

extern "C" int sim_many(const float* qs, const float* x, float* out, int B,
                        long long N, int d, int metric, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  // query chunk: at most 40 KB of shared memory (below the 48 KB default)
  int qchunk = (40 * 1024 / 4) / (d + 1);
  if (qchunk > B) qchunk = B;
  if (qchunk < 1) qchunk = 1;
  const size_t smem = (size_t)qchunk * (d + 1) * sizeof(float);
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  sim_many_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      qs, x, out, B, N, d, qchunk, metric);
  return (int)cudaGetLastError();
}

extern "C" int sim_gather(const float* qs, const float* x, const int* ids,
                          float* out, int B, int M, int d, int metric,
                          void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const int total = B * M;
  sim_gather_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(qs, x, ids, out, B, M, d, metric);
  return (int)cudaGetLastError();
}
