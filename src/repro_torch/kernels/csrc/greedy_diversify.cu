// Batched greedy diverse selection: one block per lane.
//
// Replaces the Pallas kernels greedy_diversify_pallas
// (src/repro/kernels/greedy_diversify.py:46) and
// greedy_diversify_batch_pallas (:64). scores (B, K) float32, -inf marks an
// invalid candidate; adj (B, K, K) uint8; sel (B, k) int32 local indices,
// -1 padded.
//
// Bound on the card: each step reads K scores and one K-byte adjacency row,
// so it moves B*k*(4K + K) bytes and is bound by its k dependent block
// reductions (latency), not by bytes or operations. The greedy loop
// (greedy.cuh) is the same device code the fused round runs.
#include "greedy.cuh"

namespace {

struct RowScore {
  const float* s;
  __device__ float operator()(int i) const { return s[i]; }
};

__global__ void greedy_kernel(const float* __restrict__ scores,
                              const unsigned char* __restrict__ adj, int* sel,
                              int K, int k) {
  extern __shared__ unsigned banned[];
  const int b = blockIdx.x;
  rt::greedy_select(K, k, RowScore{scores + (size_t)b * K},
                    rt::BanBytes{adj + (size_t)b * K * K, K}, banned,
                    sel + (size_t)b * k, nullptr);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int greedy_batch(const float* scores, const unsigned char* adj,
                            int* sel, int B, int K, int k, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  const size_t smem = (size_t)((K + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(scores, adj, sel,
                                                            K, k);
  return (int)cudaGetLastError();
}
