// INT8 weight-only matmul for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel specdec_tpu/ops/quant_matmul.py::_int8_kernel
// (called through _int8_matmul_2d). One kernel serves the 2D lm_head and layer
// `idx` of an [L, K, N] stack (every layer projection): the layer is a
// base-pointer offset given by the layer index and the layer strides.
//
// Computes, for x [M, K] bf16, q [K, N] int8 and scale [1, N] f32:
//
//   y[m, n] = bf16(scale[n] * sum_k x[m, k] * q[k, n])
//
// with the sum in f32 (an int8 value is exact in bf16, so this is the TPU's bf16
// dot with f32 accumulation) and the scale applied once, after the sum, as the
// TPU kernel does at its last K step.
//
// What bounds it on an H100: bytes. One call must read q (K*N bytes), the scale
// (4N), x (M*K*2) and write y (M*N*2); at 3.35 TB/s one layer's four
// projections are ~13.1 us and the 2048 x 32000 lm_head ~19.6 us at M = 1,
// while the products stay far below the bf16 tensor-core line at the main
// path's M <= 64. What this design does about it:
//   - q is [K, N] with N contiguous; a lane-per-column int8 load would move only
//     32 bytes per warp, so a thread owns 4 adjacent columns and loads them as
//     one char4: 128-byte coalesced loads per warp-row (the wrapper checks
//     N % 4 == 0 and 4-byte alignment);
//   - a block owns 128 columns and its 8 warps split K: in each chunk of 256 k,
//     warp w loads its 32 rows before converting any, so 8 x 32 rows are in
//     flight; the warps' sums meet in shared memory in a fixed warp order;
//   - every weight byte is read once per chunk of MC rows of x (M runs in chunks
//     of at most 8), and each converted weight feeds all MC rows; x is staged in
//     shared memory as f32 that all lanes read by broadcast;
//   - K needs no alignment: k past K reads as 0.
// Each output element is summed in an order that does not depend on M (the row
// chunk only decides which rows share a pass over the weights), so a row's
// result is bit-identical at M = 1, 2, 13 or 64.
// Not done yet (later work): wgmma/TMA pipelining, split-K across blocks for the
// narrow-N shapes (N = 2048 launches only 16 blocks on 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4 * 32;                   // columns per block
constexpr int kRowsPerWarp = 32;                // k rows per warp per chunk
constexpr int kChunk = kWarps * kRowsPerWarp;   // k per chunk

template <int MC>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  __shared__ float xs[MC][kChunk];
  __shared__ float red[kWarps][MC][kCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + 4 * lane;  // first of this thread's 4
  const bool col_ok = n < N;                     // N % 4 == 0: all 4 or none

  for (int m0 = 0; m0 < M; m0 += MC) {
    float acc[MC][4];
#pragma unroll
    for (int i = 0; i < MC; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();  // previous chunk's readers are done with xs
      for (int i = threadIdx.x; i < MC * kChunk; i += kThreads) {
        const int m = i / kChunk;
        const int k = k0 + i % kChunk;
        xs[m][i % kChunk] = (m0 + m < M && k < K)
            ? __bfloat162float(x[(size_t)(m0 + m) * K + k]) : 0.f;
      }
      __syncthreads();

      const int kb = k0 + warp * kRowsPerWarp;
      char4 wv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        wv[r] = (col_ok && kb + r < K)
            ? __ldg(reinterpret_cast<const char4*>(
                  q + (size_t)(kb + r) * N + n))
            : make_char4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float w[4] = {(float)wv[r].x, (float)wv[r].y, (float)wv[r].z,
                            (float)wv[r].w};
#pragma unroll
        for (int i = 0; i < MC; ++i) {
          const float xv = xs[i][warp * kRowsPerWarp + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv, w[c], acc[i][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MC; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][i][4 * lane + c] = acc[i][c];
    __syncthreads();
    for (int i = threadIdx.x; i < MC * kCols; i += kThreads) {
      const int m = i / kCols;
      const int nn = blockIdx.x * kCols + i % kCols;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][m][i % kCols];
      if (m0 + m < M && nn < N)
        y[(size_t)(m0 + m) * N + nn] = __float2bfloat16_rn(s * scale[nn]);
    }
  }
}

template <int MC>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* q, const float* sc,
                   __nv_bfloat16* y, int M, int K, int N,
                   cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols);
  int8_matmul_kernel<MC><<<grid, kThreads, 0, stream>>>(x, q, sc, y, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: [M, K] bf16; q: the base of an
// [L, K, N] (or [K, N]) int8 stack; scale: the base of [L, 1, N] f32; y:
// [M, N] bf16; all contiguous, N % 4 == 0 and q 4-byte aligned. The layer read
// is `layer`, at `q_layer_stride` / `scale_layer_stride` elements per layer.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* y, int M, int K, int N, long long layer,
                           long long q_layer_stride,
                           long long scale_layer_stride, void* stream) {
  if (M < 1 || N < 4 || N % 4 != 0 || K < 1) return (int)cudaErrorInvalidValue;
  const int8_t* qb = static_cast<const int8_t*>(q) + layer * q_layer_stride;
  const float* sc = static_cast<const float*>(scale) + layer * scale_layer_stride;
  if (reinterpret_cast<uintptr_t>(qb) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M == 1)
    err = launch<1>(xb, qb, sc, yb, M, K, N, s);
  else if (M == 2)
    err = launch<2>(xb, qb, sc, yb, M, K, N, s);
  else if (M <= 4)
    err = launch<4>(xb, qb, sc, yb, M, K, N, s);
  else
    err = launch<8>(xb, qb, sc, yb, M, K, N, s);
  return (int)err;
}
