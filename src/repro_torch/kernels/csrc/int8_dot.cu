// Exact int8 dots: the integer part of the compressed-corpus scorer.
//
// Replaces the Pallas kernel int8_dot_pallas
// (src/repro/kernels/int8_similarity.py:34):
//
//   out[b, n] = sum_j q_codes[b, j] * x_codes[n, j]   int8 x int8 -> int32
//
// Every product and partial sum is an integer below 127^2 * d < 2^31, so the
// result is exact in any order and equals the plain version bit for bit. The
// float postprocess (scales, norms, metric) stays outside, in
// repro_torch.quant.int8_score_from_dots, as the reference keeps it outside
// its pallas_call.
//
// Bound on the card: at b = 16, n = 1M, d = 96 it reads 96 MB of codes and
// writes 64 MB of int32 dots for 3.1 G int8 operations, so it is bound by
// bytes (~0.048 ms at 3.35 TB/s); the operations are nothing to the card.
// Design: one block stages a tile of corpus rows in shared memory with
// coalesced 16-byte loads (byte loads when d is not a multiple of 16, each
// row zero-padded to whole 4-byte words, so no read passes a row's end).
// Rows sit at an odd word stride, so one thread per row reads its row's
// words without bank conflicts. A chunk of 16 query rows sits beside it
// (read as broadcasts); each thread accumulates its row against the chunk
// with __dp4a into 16 int32 registers and writes out[b, row], coalesced
// along rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 16;            // queries per register block
constexpr int kTileWords = 8192;   // corpus tile: at most 32 KB
constexpr int kMaxD = 768;         // tile + query chunk stay under 48 KB

__global__ void int8_dot_kernel(const int8_t* __restrict__ q,
                                const int8_t* __restrict__ x,
                                int32_t* __restrict__ out, int B, long long N,
                                int d, int dw, int sw, int vec16) {
  extern __shared__ int smem[];
  const int T = blockDim.x;
  int* xs = smem;                  // T rows * sw words
  int* qs = smem + T * sw;         // kQB rows * dw words
  const long long r0 = (long long)blockIdx.x * T;
  const int rows = (int)min((long long)T, N - r0);
  const int8_t* src = x + r0 * d;

  if (vec16) {  // d % 16 == 0 and the tile starts 16-byte aligned
    const int per_row = d / 16;
    const int n16 = rows * per_row;
    for (int i = threadIdx.x; i < n16; i += T) {
      const int4 v = reinterpret_cast<const int4*>(src)[i];
      int* dst = xs + (i / per_row) * sw + (i % per_row) * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    const int wb = dw * 4;  // padded row bytes
    for (int i = threadIdx.x; i < rows * wb; i += T) {
      const int r = i / wb, c = i % wb;
      reinterpret_cast<int8_t*>(xs + r * sw)[c] =
          c < d ? src[(long long)r * d + c] : (int8_t)0;
    }
  }

  for (int b0 = 0; b0 < B; b0 += kQB) {
    __syncthreads();  // the tile is staged; the last chunk's reads are done
    const int wb = dw * 4;
    for (int i = threadIdx.x; i < kQB * wb; i += T) {
      const int u = i / wb, c = i % wb;
      reinterpret_cast<int8_t*>(qs + u * dw)[c] =
          (b0 + u < B && c < d) ? q[(long long)(b0 + u) * d + c] : (int8_t)0;
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      int acc[kQB];
#pragma unroll
      for (int u = 0; u < kQB; ++u) acc[u] = 0;
      const int* xr = xs + threadIdx.x * sw;
      for (int w = 0; w < dw; ++w) {
        const int xv = xr[w];
#pragma unroll
        for (int u = 0; u < kQB; ++u) acc[u] = __dp4a(xv, qs[u * dw + w], acc[u]);
      }
      const long long n = r0 + threadIdx.x;
#pragma unroll
      for (int u = 0; u < kQB; ++u)
        if (b0 + u < B) out[(long long)(b0 + u) * N + n] = acc[u];
    }
  }
}

}  // namespace

extern "C" int int8_dot(const int8_t* q, const int8_t* x, int32_t* out, int B,
                        long long N, int d, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const int dw = (d + 3) / 4;
  const int sw = dw | 1;  // odd word stride: conflict-free row reads
  int T = (kTileWords / sw) / 32 * 32;
  T = T < 32 ? 32 : (T > 256 ? 256 : T);
  const size_t smem = ((size_t)T * sw + (size_t)kQB * dw) * sizeof(int);
  const int vec16 = (d % 16 == 0) && (((uintptr_t)x & 15) == 0);
  const unsigned blocks = (unsigned)((N + T - 1) / T);
  int8_dot_kernel<<<blocks, T, smem, (cudaStream_t)stream>>>(
      q, x, out, B, N, d, dw, sw, vec16);
  return (int)cudaGetLastError();
}
