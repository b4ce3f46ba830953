// NF4 / FP4 dequant-matmul on the pair4 layout, for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels specdec_tpu/ops/quant_matmul.py::_halfplane_kernel
// (2D, the lm_head) and ::_halfplane_kernel_stacked (layer `idx` of an
// [L, K/8, N] stack, every layer projection). One kernel, templated on the codec,
// serves both: the layer is a base-pointer offset given by the layer index and
// the layer strides.
//
// Computes, for x [M, K] bf16, words [K/8, N] int32, absmax [K/64, N] bf16:
//
//   y[m, n] = sum_k x[m, k] * bf16(decode(code(k, n)) * absmax[row(k / 64), n])
//
// accumulated in f32, written as bf16. decode is the NF4 codebook rounded to
// bf16 (quant/core.py::_nf4_decode_bits) or the e2m1 bit assembly
// (::_fp4_decode_bits). As on the TPU (_halfplane_tile), every weight is scaled
// and rounded to bf16 before its product: the product of a bf16 code value and a
// bf16 scale is exact in f32, so this kernel and its plain version see
// bit-identical weights and differ only in f32 summation order. The layout is
// the INT4 kernel's (int4_pair_matmul.cu): word r, bits [4p + 16h, +4), holds
// the code for k = p*K/4 + 2r + h; absmax is stored block-major, natural block
// g = p*(G/4) + b at row b*4 + p (G = K/64), so the 32 word rows [32b, 32b + 32)
// hold, for each quarter p, the 64 consecutive k of natural block p*(G/4) + b.
// Requires K % 256 == 0 (the wrapper checks).
//
// What bounds it on an H100: bytes. One call must read the words (K*N/2 bytes),
// the absmax (K/64 * N * 2), x (M*K*2) and write y (M*N*2); at 3.35 TB/s one
// layer's four projections are ~7.0 us and the 2048 x 32000 lm_head ~10.4 us at
// M = 1, while the products (2*M*K*N) stay far below the bf16 tensor-core line
// at the main path's M <= 64. The per-weight decode, scale and rounding (about
// six instructions a weight, against INT4's one subtract) is the next limit.
// What this design does about it:
//   - each lane owns one output column, so a warp reads 32 neighbouring words of
//     a word row: 128-byte coalesced loads along N, the contiguous axis;
//   - the 8 warps of a block split K (warp w takes groups b = w, w + 8, ...) and
//     each loads its 32 word rows before decoding any, so 8 x 32 rows are in
//     flight; the warps' sums meet in shared memory in a fixed warp order;
//   - every weight byte is read once per chunk of MC rows of x (M runs in chunks
//     of at most 8), and one decoded weight feeds all MC rows; x is staged in
//     shared memory as bf16 pairs (k, k + 1) that all lanes read by broadcast;
//   - NF4 decodes through a 16-entry table in shared memory: the lanes' codes
//     differ, and 16 words in 16 banks are read without conflicts (a
//     __constant__ table would serialize divergent addresses); FP4 assembles
//     the f32 bits with integer operations and no table.
// Each output element is summed in an order that does not depend on M (the row
// chunk only decides which rows share a pass over the weights), so a row's
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

enum Codec { kNF4 = 0, kFP4 = 1 };

// bf16 bit patterns of the NF4 codebook (quant/core.py::NF4_CODEBOOK rounded to
// bf16, the halves of ::_NF4_WORDS), codes 0..15
__constant__ uint16_t kNF4Bits[16] = {
    0xBF80, 0xBF32, 0xBF06, 0xBECA, 0xBE92, 0xBE3D, 0xBDBA, 0x0000,
    0x3DA3, 0x3E25, 0x3E7C, 0x3EAD, 0x3EE2, 0x3F10, 0x3F39, 0x3F80};

// code (0..15) -> its f32 value
template <int CODEC>
__device__ __forceinline__ float decode(uint32_t c, const float* nf4) {
  if (CODEC == kNF4) return nf4[c];
  // e2m1: (e:m + 252) << 22 for e >= 1, 0x3F000000 * m for e = 0; sign bit 31
  const uint32_t s31 = (c & 8u) << 28;
  const uint32_t bits = (c & 6u) ? ((((c & 7u) + 252u) << 22) | s31)
                                 : (((c & 1u) * 0x3F000000u) | s31);
  return __uint_as_float(bits);
}

// the weight as the TPU kernel forms it: value * scale, rounded to bf16
template <int CODEC>
__device__ __forceinline__ float weight(uint32_t c, float scale,
                                        const float* nf4) {
  return __bfloat162float(__float2bfloat16_rn(decode<CODEC>(c, nf4) * scale));
}

template <int MC, int CODEC>
__global__ void __launch_bounds__(kThreads)
q4_halfplane_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                           const int32_t* __restrict__ words,
                           const __nv_bfloat16* __restrict__ absmax,
                           __nv_bfloat16* __restrict__ y,
                           int M, int K, int N) {
  // x chunk: MC rows x 4 quarters x (kWarps groups * 32 pairs)
  __shared__ __nv_bfloat162 xs[MC][4][kWarps * kRowsPerGroup];
  __shared__ float red[kWarps][MC][32];
  __shared__ float nf4[16];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const bool col_ok = n < N;
  const int groups = K / 256;
  const int quarter = K / 4;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  // read only after the __syncthreads that follows the first x staging
  if (CODEC == kNF4 && threadIdx.x < 16)
    nf4[threadIdx.x] = __uint_as_float((uint32_t)kNF4Bits[threadIdx.x] << 16);

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
#pragma unroll
          for (int r = 0; r < kRowsPerGroup; ++r) {
            const uint32_t u = wv[r] >> (4 * p);
            const float w0 = weight<CODEC>(u & 0xFu, sc[p], nf4);
            const float w1 = weight<CODEC>((u >> 16) & 0xFu, sc[p], nf4);
#pragma unroll
            for (int i = 0; i < MC; ++i) {
              const float2 xv =
                  __bfloat1622float2(xs[i][p][warp * kRowsPerGroup + r]);
              acc[i] = fmaf(xv.x, w0, acc[i]);
              acc[i] = fmaf(xv.y, w1, acc[i]);
            }
          }
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

template <int MC, int CODEC>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* w,
                   const __nv_bfloat16* am, __nv_bfloat16* y, int M, int K,
                   int N, cudaStream_t stream) {
  const dim3 grid((N + 31) / 32);
  q4_halfplane_matmul_kernel<MC, CODEC><<<grid, kThreads, 0, stream>>>(
      x, w, am, y, M, K, N);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t launch_rows(const __nv_bfloat16* x, const int32_t* w,
                        const __nv_bfloat16* am, __nv_bfloat16* y, int M,
                        int K, int N, cudaStream_t s) {
  if (M == 1) return launch<1, CODEC>(x, w, am, y, M, K, N, s);
  if (M == 2) return launch<2, CODEC>(x, w, am, y, M, K, N, s);
  if (M <= 4) return launch<4, CODEC>(x, w, am, y, M, K, N, s);
  return launch<8, CODEC>(x, w, am, y, M, K, N, s);
}

}  // namespace

// C interface, loaded with ctypes. x: [M, K] bf16; words: the base of an
// [L, K/8, N] (or [K/8, N]) int32 stack; absmax: the base of [L, K/64, N]
// bf16; y: [M, N] bf16; all contiguous. The layer read is `layer`, at
// `words_layer_stride` / `absmax_layer_stride` elements per layer; codec 0 is
// NF4, 1 is FP4. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int q4_halfplane_matmul(const void* x, const void* words,
                                   const void* absmax, void* y, int M, int K,
                                   int N, long long layer,
                                   long long words_layer_stride,
                                   long long absmax_layer_stride, int codec,
                                   void* stream) {
  if (M < 1 || N < 1 || K < 256 || K % 256 != 0 || (codec != kNF4 && codec != kFP4))
    return (int)cudaErrorInvalidValue;
  const int32_t* w = static_cast<const int32_t*>(words) + layer * words_layer_stride;
  const __nv_bfloat16* am =
      static_cast<const __nv_bfloat16*>(absmax) + layer * absmax_layer_stride;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = codec == kNF4
      ? launch_rows<kNF4>(xb, w, am, yb, M, K, N, s)
      : launch_rows<kFP4>(xb, w, am, yb, M, K, N, s);
  return (int)err;
}
