// INT4 pair4 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels specdec_tpu/ops/quant_matmul.py::_pair_kernel
// (2D, the lm_head) and ::_pair_kernel_stacked (layer `idx` of an [L, K/8, N]
// stack, every layer projection). One kernel serves both: the layer is a
// base-pointer offset given by the layer index and the layer strides.
//
// Computes, for x [M, K] bf16, words [K/8, N] int32, absmax [K/64, N] bf16:
//
//   y[m, n] = sum_b absmax[row(b), n] * sum_{k in block b} x[m, k] * (code(k, n) - 8)
//
// accumulated in f32, written as bf16. Layouts (specdec_tpu_torch/quant/core.py):
// word r, bits [4p + 16h, +4), holds the code for k = p*K/4 + 2r + h; absmax is
// stored block-major, natural block g = p*(G/4) + b at row b*4 + p (G = K/64).
// So the 32 word rows [32b, 32b + 32) hold, for each quarter p, the 64
// consecutive k of natural block p*(G/4) + b, whose scales are the 4
// consecutive stored rows 4b .. 4b+3. Requires K % 256 == 0 (the wrapper checks).
//
// What bounds it on an H100: bytes. One call must read the words (K/8 * N * 4
// bytes), the absmax (K/64 * N * 2), x (M * K * 2) and write y (M * N * 2); at
// 3.35 TB/s that is ~10 us for the 2048 x 32000 lm_head and ~3.6 us for one
// 2048 x 11264 gate/up layer, while the products (2*M*K*N) are far below the
// bf16 tensor-core line at the main path's M <= 64. What this design does
// about it:
//   - each lane owns one output column, so a warp reads 32 neighbouring words of
//     a word row: 128-byte coalesced loads along N, the contiguous axis;
//   - the 8 warps of a block split K (warp w takes groups b = w, w + 8, ...) so a
//     block keeps 8 x 32 word rows in flight; the warps' sums meet in shared
//     memory and are added in a fixed warp order;
//   - every weight byte is read once per chunk of MC rows of x; x is staged in
//     shared memory as bf16 pairs that all lanes read by broadcast;
//   - nibbles are taken with unsigned shifts (a word has bit 31 set whenever its
//     p=3, h=1 code is >= 8), two per quarter per word;
//   - the block scale multiplies each 64-k partial sum, as the TPU kernel does.
// Each output element is computed in an order that does not depend on M (the
// row chunk only decides which rows share a pass over the weights), so a row's
// result is bit-identical at M = 1, 2, 13 or 64.
// Not done yet (later work): wgmma/TMA pipelining, split-K across blocks for the
// narrow-N shapes (N = 2048 launches only 64 blocks on 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerGroup = 32;  // word rows per group b (64 k per quarter)

template <int MC>
__global__ void __launch_bounds__(kThreads)
int4_pair_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const int32_t* __restrict__ words,
                        const __nv_bfloat16* __restrict__ absmax,
                        __nv_bfloat16* __restrict__ y,
                        int M, int K, int N) {
  // x chunk: MC rows x 4 quarters x (kWarps groups * 32 pairs)
  __shared__ __nv_bfloat162 xs[MC][4][kWarps * kRowsPerGroup];
  __shared__ float red[kWarps][MC][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const bool col_ok = n < N;
  const int groups = K / 256;
  const int quarter = K / 4;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);

  for (int m0 = 0; m0 < M; m0 += MC) {
    float acc[MC];
#pragma unroll
    for (int i = 0; i < MC; ++i) acc[i] = 0.f;

    for (int b0 = 0; b0 < groups; b0 += kWarps) {
      __syncthreads();  // previous chunk's readers are done with xs
      for (int i = threadIdx.x; i < MC * 4 * kWarps * kRowsPerGroup;
           i += kThreads) {
        const int j = i % (kWarps * kRowsPerGroup);
        const int p = (i / (kWarps * kRowsPerGroup)) % 4;
        const int m = i / (4 * kWarps * kRowsPerGroup);
        const int b = b0 + j / kRowsPerGroup;
        __nv_bfloat162 v = zero2;
        if (m0 + m < M && b < groups) {
          v = *reinterpret_cast<const __nv_bfloat162*>(
              x + (size_t)(m0 + m) * K + (size_t)p * quarter +
              (size_t)b0 * 64 + 2 * j);
        }
        xs[m][p][j] = v;
      }
      __syncthreads();

      const int b = b0 + warp;
      if (b < groups) {
        uint32_t wv[kRowsPerGroup];
        const int32_t* wp = words + (size_t)b * kRowsPerGroup * N + n;
#pragma unroll
        for (int r = 0; r < kRowsPerGroup; ++r)
          wv[r] = col_ok ? (uint32_t)__ldg(wp + (size_t)r * N) : 0u;
        float sc[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          sc[p] = col_ok
              ? __bfloat162float(absmax[(size_t)(b * 4 + p) * N + n]) : 0.f;

#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float part[MC];
#pragma unroll
          for (int i = 0; i < MC; ++i) part[i] = 0.f;
#pragma unroll
          for (int r = 0; r < kRowsPerGroup; ++r) {
            const uint32_t u = wv[r] >> (4 * p);
            const float w0 = (float)((int)(u & 0xFu) - 8);
            const float w1 = (float)((int)((u >> 16) & 0xFu) - 8);
#pragma unroll
            for (int i = 0; i < MC; ++i) {
              const float2 xv =
                  __bfloat1622float2(xs[i][p][warp * kRowsPerGroup + r]);
              part[i] = fmaf(xv.x, w0, part[i]);
              part[i] = fmaf(xv.y, w1, part[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < MC; ++i) acc[i] = fmaf(part[i], sc[p], acc[i]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MC; ++i) red[warp][i][lane] = acc[i];
    __syncthreads();
    for (int i = threadIdx.x; i < MC * 32; i += kThreads) {
      const int m = i / 32;
      const int l = i % 32;
      const int nn = blockIdx.x * 32 + l;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][m][l];
      if (m0 + m < M && nn < N)
        y[(size_t)(m0 + m) * N + nn] = __float2bfloat16_rn(s);
    }
  }
}

template <int MC>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* w,
                   const __nv_bfloat16* am, __nv_bfloat16* y, int M, int K,
                   int N, cudaStream_t stream) {
  const dim3 grid((N + 31) / 32);
  int4_pair_matmul_kernel<MC><<<grid, kThreads, 0, stream>>>(x, w, am, y, M,
                                                             K, N);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: [M, K] bf16; words: the base of an
// [L, K/8, N] (or [K/8, N]) int32 stack; absmax: the base of [L, K/64, N]
// bf16; y: [M, N] bf16; all contiguous. The layer read is `layer`, at
// `words_layer_stride` / `absmax_layer_stride` elements per layer. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int int4_pair_matmul(const void* x, const void* words,
                                const void* absmax, void* y, int M, int K,
                                int N, long long layer,
                                long long words_layer_stride,
                                long long absmax_layer_stride, void* stream) {
  if (M < 1 || N < 1 || K < 256 || K % 256 != 0) return (int)cudaErrorInvalidValue;
  const int32_t* w = static_cast<const int32_t*>(words) + layer * words_layer_stride;
  const __nv_bfloat16* am =
      static_cast<const __nv_bfloat16*>(absmax) + layer * absmax_layer_stride;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M == 1)
    err = launch<1>(xb, w, am, yb, M, K, N, s);
  else if (M == 2)
    err = launch<2>(xb, w, am, yb, M, K, N, s);
  else if (M <= 4)
    err = launch<4>(xb, w, am, yb, M, K, N, s);
  else
    err = launch<8>(xb, w, am, yb, M, K, N, s);
  return (int)err;
}
