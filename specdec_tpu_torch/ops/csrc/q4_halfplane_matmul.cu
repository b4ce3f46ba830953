// NF4 / FP4 dequant-matmul on the pair4 layout, for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU (Pallas) kernels specdec_tpu/ops/quant_matmul.py::_halfplane_kernel
// (:241, 2D, the lm_head) and ::_halfplane_kernel_stacked (:263, layer `idx` of
// an [L, K/8, N] stack, every layer projection). One kernel serves both, and
// both codecs: the layer is a base-pointer offset given by the layer index and
// the layer strides, and the codec picks the 16-entry decode table.
//
// Computes, for x [M, K] bf16, words [K/8, N] int32, absmax [K/64, N] bf16:
//
//   y[m, n] = sum_k x[m, k] * bf16(decode(code(k, n)) * absmax[row(k / 64), n])
//
// accumulated in f32, written as bf16. decode is the NF4 codebook rounded to
// bf16 (quant/core.py::_nf4_decode_bits) or the e2m1 value
// (::_fp4_decode_bits); all 16 values of either are exact in bf16. As on the
// TPU (_halfplane_tile), every weight is scaled and rounded to bf16 before its
// product: the product of a bf16 code value and a bf16 scale is exact in f32,
// so one bf16x2 multiply (rounded once) gives the same bits as the plain
// version's bf16(decode * scale), and kernel and plain version differ only in
// f32 summation order. The layout is the INT4 kernel's (int4_pair_matmul.cu):
// word r, bits [4p + 16h, +4), holds the code for k = p*K/4 + 2r + h; absmax is
// stored block-major, natural block g = p*(G/4) + b at row b*4 + p (G = K/64),
// so the 32 word rows [32b, 32b + 32) hold, for each quarter p, the 64
// consecutive k of natural block p*(G/4) + b. Requires K % 256 == 0 and x
// 16-byte aligned (the wrapper checks and aligns).
//
// What bounds it on an H100: bytes K*N/2 (words) + K/64*N*2 (absmax) + M*K*2
// (x) + M*N*2 (y) at 3.35 TB/s, or 2*M*K*N operations at 989 TFLOP/s (bf16),
// whichever is longer: bytes at the decode row counts, operations from M of a
// few hundred (one layer's four projections: ~7.0 us at M = 1, ~22.8 us at
// M = 256).
//
// Design:
//   - Products on the tensor cores, swap-AB: mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with A = 16 output columns n x 16 k of decoded weights and
//     B = 16 k x 8 rows m of x, so C holds y transposed. M = 1..8 costs one n8
//     tile; one decoded A fragment feeds every n8 tile of the block's M tile
//     (up to 64 rows, 8 tiles, in registers). Each weight is decoded once per
//     block pass over its M tile, i.e. once per 64 rows of x.
//   - The pair4 word is already an A fragment. With g = lane / 4, t = lane % 4
//     and an 8-row step r0, the mma's k-index 2t + h maps to word row r0 + t,
//     and 2t + 8 + h to row r0 + t + 4: k-index j is then quarter-local k
//     2*r0 + j, so the nibbles (h = 0, 1) of quarter p of one word are one
//     bf16x2 register of the A fragment of quarter p's mma. A-row g is column
//     n0 + 2g and A-row g + 8 column n0 + 2g + 1, so a thread reads its four
//     words as two 8-byte loads (rows r0 + t and r0 + t + 4, columns
//     n0 + 2g .. +1), and the four words give the A fragments of four mmas,
//     one per quarter. B is then x[m, p*K/4 + 2*r0 + 2t + {0, 1}] and + 8.
//   - Decode a pair at a time: two lookups in a 16-entry table in shared
//     memory (lanes that differ read different banks, lanes that agree
//     broadcast), one byte permute into a bf16x2, one bf16x2 multiply by the
//     pair's scale. Both codecs decode through a table.
//   - Warps: a column group is 16 output columns and 4 warps that split K:
//     a chunk is one 32-word-row absmax group (256 k), and warp w takes the
//     chunk's 8-row step w. A block holds one or two column groups (CG) and
//     a tile of up to 64 rows of M. Two groups share one staging of x, which
//     halves x's re-reads from L2 (each block reads all of x for its rows)
//     and gives 128-byte row segments of words: the wide layers (N >= 8192:
//     the lm_head, w_gateup) take two at every M, the others from M = 33.
//   - Latency: at M = 1 a chunk's work is a few hundred cycles, too short
//     to hide a load behind it. Each warp keeps its words and scales for
//     the next D chunks in flight in registers (a ring, D = 1..3 by
//     instance, fewer where the tile's accumulators need the registers),
//     and x is staged per chunk by cp.async into a shared-memory ring of S
//     chunks (S - 1 ahead: 8, 4, 4, 2 for 8, 16, 32, 64 rows). Only live
//     rows are staged, at a row stride of 528 bytes (132 words, 4 mod 32
//     banks) so that the ldmatrix reads of the B fragments are free of bank
//     conflicts; ldmatrix lanes of rows past M read a zero row instead.
//     The instances' D and S were chosen by timing variants on the H100;
//     ptxas reports no spill in any of the seven (chip_smoke.py checks).
//   - Row independence (the greedy oracles compare AR at M = 1 with the
//     verify at M = 13): the K partition (which warp sums which steps, in
//     which order, and the fixed warp order in which the partial sums meet in
//     shared memory) depends only on K. M only picks how many n8 tiles a
//     pass carries (NT), the column groups per block and gridDim.x =
//     ceil(M / (8 * NT)); an mma's output column depends only on its own B
//     column, so the pad rows (read as zeros) change nothing, and a row's
//     result is bit-identical at every M. No atomics.
//   - Ragged edges: columns past N read no memory (their A rows are zero
//     and not stored); an odd N or unaligned pointers take scalar loads.
// Not done yet (later work): wgmma and TMA (a shared-memory ring fed by TMA
// for the words), split-K across blocks for the narrow layers (N = 2048 gives
// 128 blocks on 132 SMs), and B fragments reused across two A tiles per warp
// (every mma reads its 256-byte B fragment from shared memory), and larger M
// tiles: above M = 64 each weight is decoded ceil(M / 64) times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;          // columns of a column group (one mma A tile)
constexpr int kChunkK = 256;       // k per chunk: one absmax group b, 4 quarters
constexpr int kXStride = kChunkK + 8;  // staged x row, bf16: 528 bytes

enum Codec { kNF4 = 0, kFP4 = 1 };

// bf16 bit patterns of the NF4 codebook (quant/core.py::NF4_CODEBOOK rounded to
// bf16, the halves of ::_NF4_WORDS), codes 0..15
__constant__ uint16_t kNF4Bits[16] = {
    0xBF80, 0xBF32, 0xBF06, 0xBECA, 0xBE92, 0xBE3D, 0xBDBA, 0x0000,
    0x3DA3, 0x3E25, 0x3E7C, 0x3EAD, 0x3EE2, 0x3F10, 0x3F39, 0x3F80};

// bf16 bit patterns of the e2m1 values (quant/core.py::_fp4_decode_bits),
// codes 0..15: 0, 0.5, 1, 1.5, 2, 3, 4, 6 and their negatives (code 8 is -0)
__constant__ uint16_t kFP4Bits[16] = {
    0x0000, 0x3F00, 0x3F80, 0x3FC0, 0x4000, 0x4040, 0x4080, 0x40C0,
    0x8000, 0xBF00, 0xBF80, 0xBFC0, 0xC000, 0xC040, 0xC080, 0xC0C0};

// one ring slot: a step's four words (rows r0 + t, r0 + t + 4; columns
// n0 + 2g, n0 + 2g + 1) and the chunk's scales of both columns per quarter
struct Slot {
  uint2 w_lo;   // row r0 + t: columns 2g, 2g + 1
  uint2 w_hi;   // row r0 + t + 4
  uint32_t s[4];  // quarter p: bf16 scale of column 2g (low), 2g + 1 (high)
};

// two consecutive int32 (or two bf16 packed in a uint32) at columns n, n + 1
// of a row; zero past N. vec: N even and the row 8-byte (4-byte) aligned.
__device__ __forceinline__ uint2 load_words(const int32_t* row, int n, int N,
                                            bool vec) {
  if (vec) {
    return n < N ? __ldg(reinterpret_cast<const uint2*>(row + n))
                 : make_uint2(0u, 0u);
  }
  return make_uint2(n < N ? (uint32_t)__ldg(row + n) : 0u,
                    n + 1 < N ? (uint32_t)__ldg(row + n + 1) : 0u);
}

__device__ __forceinline__ uint32_t load_scales(const __nv_bfloat16* row,
                                                int n, int N, bool vec) {
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  if (vec) {
    return n < N ? __ldg(reinterpret_cast<const unsigned int*>(r + n)) : 0u;
  }
  const uint32_t a = n < N ? __ldg(r + n) : 0u;
  const uint32_t b = n + 1 < N ? __ldg(r + n + 1) : 0u;
  return a | (b << 16);
}

// bf16x2 product a * b, each half rounded once to bf16 (a - 0 fma: exact
// product, one rounding; -0 keeps the sign of a zero product)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b),
      "r"(0x80008000u));
  return d;
}

// the A register of quarter p of word w: the pair of weights (h = 0 low,
// h = 1 high), decoded through the table and scaled by s2 (the scale in
// both halves)
__device__ __forceinline__ uint32_t decode_pair(uint32_t w, int p,
                                                uint32_t s2,
                                                const uint32_t* tab) {
  const uint32_t lo = tab[(w >> (4 * p)) & 0xFu];
  const uint32_t hi = tab[(w >> (4 * p + 16)) & 0xFu];
  return bf16x2_mul(__byte_perm(lo, hi, 0x5410), s2);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// shared memory of a launch: S x-chunk buffers of `rows` rows and the zero
// row; the warps' partial sums reuse it at the end
__host__ __device__ constexpr int smem_bytes(int S, int rows, int CG) {
  return (S * rows + 1) * kXStride * 2 >
                 CG * kWarps * ((rows + 7) / 8) * 8 * kCols * 4
             ? (S * rows + 1) * kXStride * 2
             : CG * kWarps * ((rows + 7) / 8) * 8 * kCols * 4;
}

// NT: n8 tiles of M per block (rows 8 * NT); S: x chunks in the ring (S - 1
// staged ahead); CG: column groups of 16 per block, each with its own 4
// K-split warps, all reading the block's staged x
template <int NT, int S, int CG>
__global__ void __launch_bounds__(kThreads * CG)
q4_halfplane_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                           const int32_t* __restrict__ words,
                           const __nv_bfloat16* __restrict__ absmax,
                           __nv_bfloat16* __restrict__ y, int M, int K, int N,
                           int codec, bool vec) {
  constexpr int BM = 8 * NT;
  // chunks of words and scales in flight per warp: deeper where a warp's
  // work per chunk is short and registers are left (measured on the H100)
  constexpr int D = NT == 1 ? (CG == 1 ? 3 : 2) : NT == 2 && CG == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // x ring [S][xrows][kXStride] bf16, then one zero row
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ uint32_t tab[16];

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & (kWarps - 1);  // its K step
  const int cg = threadIdx.x / kThreads;                 // its column group
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int nb = blockIdx.y * CG * kCols;  // the block's first column
  const int n0 = nb + cg * kCols;          // the warp's first column
  const int nc = n0 + 2 * g;  // this thread's columns nc, nc + 1
  const int quarter = K / 4;
  const int chunks = K / kChunkK;
  const int xrows = min(BM, M);  // rows of a ring buffer (every block)
  const int rows_live = min(BM, M - m0);
  const int tiles_live = (rows_live + 7) / 8;

  if (threadIdx.x < 16)
    tab[threadIdx.x] = codec == kNF4 ? kNF4Bits[threadIdx.x]
                                     : kFP4Bits[threadIdx.x];
  for (int i = threadIdx.x; i < kXStride / 2; i += kThreads * CG)
    reinterpret_cast<uint32_t*>(xs + S * xrows * kXStride)[i] = 0u;

  auto load_slot = [&](int c) {
    Slot s;
    const int r = c * 32 + warp * 8 + t;
    s.w_lo = load_words(words + (size_t)r * N, nc, N, vec);
    s.w_hi = load_words(words + (size_t)(r + 4) * N, nc, N, vec);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      s.s[p] = load_scales(absmax + (size_t)(c * 4 + p) * N, nc, N, vec);
    return s;
  };

  // x of chunk c (k = p*K/4 + 64c .. + 64 for each quarter p) into buffer
  // c % S: live row m, quarter p, 16-byte piece q at xs[c % S][m][p*64 + 8q].
  // Every thread commits one group per call, empty or not, so that the
  // group count stays in step with the chunks.
  const uint32_t xs_base = (uint32_t)__cvta_generic_to_shared(xs);
  auto stage_x = [&](int c) {
    if (c < chunks) {
      const int b = c % S;
      for (int i = threadIdx.x; i < rows_live * 32; i += kThreads * CG) {
        const int m = i >> 5;
        const int p = (i >> 3) & 3;
        const int q = i & 7;
        cp_async16(xs_base + 2u * (uint32_t)((b * xrows + m) * kXStride +
                                             p * 64 + 8 * q),
                   x + (size_t)(m0 + m) * K + (size_t)p * quarter + 64 * c +
                       8 * q);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Slot ring[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < chunks) ring[d] = load_slot(d);
#pragma unroll
  for (int c = 0; c < S - 1; ++c) stage_x(c);

  // ldmatrix row address of this lane: matrix j = lane / 8 (b0, b1 of quarter
  // 2pp, then of quarter 2pp + 1), row lane % 8 = m within the n8 tile
  const int lm_row = lane & 7;
  const int lm_col = ((lane >> 4) & 1) * 64 + warp * 16 + ((lane >> 3) & 1) * 8;

  for (int c0 = 0; c0 < chunks; c0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int c = c0 + d;
      if (c >= chunks) break;
      const Slot cur = ring[d];
      if (c + D < chunks) ring[d] = load_slot(c + D);
      cp_async_wait<S - 2>();
      __syncthreads();  // chunk c staged; every warp is done with chunk c - 1
      stage_x(c + S - 1);  // into chunk c - 1's buffer

      // A fragments of the four quarters' mmas
      uint32_t a[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t s_even = __byte_perm(cur.s[p], 0, 0x1010);
        const uint32_t s_odd = __byte_perm(cur.s[p], 0, 0x3232);
        a[p][0] = decode_pair(cur.w_lo.x, p, s_even, tab);  // row g,     k 2t
        a[p][1] = decode_pair(cur.w_lo.y, p, s_odd, tab);   // row g + 8, k 2t
        a[p][2] = decode_pair(cur.w_hi.x, p, s_even, tab);  // row g,     k 2t + 8
        a[p][3] = decode_pair(cur.w_hi.y, p, s_odd, tab);   // row g + 8, k 2t + 8
      }
      const int buf = (c % S) * xrows;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < tiles_live) {
          const int m = 8 * i + lm_row;
          const uint32_t row =
              xs_base + 2u * (uint32_t)((m < rows_live ? buf + m : S * xrows) *
                                            kXStride + lm_col);
          uint32_t b[4];
          ldmatrix_x4(b, row);                 // quarters 0, 1
          mma_bf16(acc[i], a[0], b[0], b[1]);
          mma_bf16(acc[i], a[1], b[2], b[3]);
          ldmatrix_x4(b, row + 2u * 128u);     // quarters 2, 3
          mma_bf16(acc[i], a[2], b[0], b[1]);
          mma_bf16(acc[i], a[3], b[2], b[3]);
        }
      }
    }
  }

  // the warps' partial sums meet in shared memory (reusing the x buffers),
  // summed in warp order: red[cg][w][m][n], n the group's 16 columns
  cp_async_wait<0>();  // (only empty groups are left)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int red_rows = 8 * ((xrows + 7) / 8);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < tiles_live) {
      const int m = 8 * i + 2 * t;
      float* r = red + ((size_t)(cg * kWarps + warp) * red_rows + m) * kCols +
                 2 * g;
      *reinterpret_cast<float2*>(r) = make_float2(acc[i][0], acc[i][2]);
      *reinterpret_cast<float2*>(r + kCols) = make_float2(acc[i][1], acc[i][3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows_live * CG * (kCols / 2);
       i += kThreads * CG) {
    const int m = i / (CG * (kCols / 2));
    const int j = i % (CG * (kCols / 2));  // column pair j of the block
    const int n = nb + 2 * j;
    const float* part = red + ((size_t)(j / (kCols / 2)) * kWarps * red_rows +
                               m) * kCols + 2 * (j % (kCols / 2));
    float2 s = *reinterpret_cast<const float2*>(part);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(
          part + (size_t)w * red_rows * kCols);
      s.x += v.x;
      s.y += v.y;
    }
    __nv_bfloat16* out = y + (size_t)(m0 + m) * N + n;
    if (vec) {
      if (n < N)
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(s.x, s.y);
    } else {
      if (n < N) out[0] = __float2bfloat16_rn(s.x);
      if (n + 1 < N) out[1] = __float2bfloat16_rn(s.y);
    }
  }
}

template <int NT, int S, int CG>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* w,
                   const __nv_bfloat16* am, __nv_bfloat16* y, int M, int K,
                   int N, int codec, bool vec, cudaStream_t stream) {
  constexpr int BM = 8 * NT;
  static bool configured = false;
  if (!configured) {  // the most any launch of this instance asks for
    const cudaError_t err = cudaFuncSetAttribute(
        q4_halfplane_matmul_kernel<NT, S, CG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(S, BM, CG));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + CG * kCols - 1) / (CG * kCols));
  q4_halfplane_matmul_kernel<NT, S, CG>
      <<<grid, kThreads * CG, smem_bytes(S, M < BM ? M : BM, CG), stream>>>(
          x, w, am, y, M, K, N, codec, vec);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: [M, K] bf16, 16-byte aligned; words: the
// base of an [L, K/8, N] (or [K/8, N]) int32 stack; absmax: the base of
// [L, K/64, N] bf16; y: [M, N] bf16; all contiguous. The layer read is
// `layer`, at `words_layer_stride` / `absmax_layer_stride` elements per layer;
// codec 0 is NF4, 1 is FP4. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int q4_halfplane_matmul(const void* x, const void* words,
                                   const void* absmax, void* y, int M, int K,
                                   int N, long long layer,
                                   long long words_layer_stride,
                                   long long absmax_layer_stride, int codec,
                                   void* stream) {
  if (M < 1 || N < 1 || K < 256 || K % 256 != 0 ||
      (codec != kNF4 && codec != kFP4) || (uintptr_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* w = static_cast<const int32_t*>(words) + layer * words_layer_stride;
  const __nv_bfloat16* am =
      static_cast<const __nv_bfloat16*>(absmax) + layer * absmax_layer_stride;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads and stores of column pairs: N even and every row aligned
  const bool vec = N % 2 == 0 && (uintptr_t)w % 8 == 0 &&
                   (uintptr_t)am % 4 == 0 && (uintptr_t)yb % 4 == 0;
  // the instance: NT by M; two column groups per block for the wide layers
  // and from M = 33 (see the header note)
  const bool wide = N >= 8192;
  cudaError_t err;
  if (M <= 8)
    err = wide ? launch<1, 8, 2>(xb, w, am, yb, M, K, N, codec, vec, s)
               : launch<1, 8, 1>(xb, w, am, yb, M, K, N, codec, vec, s);
  else if (M <= 16)
    err = wide ? launch<2, 4, 2>(xb, w, am, yb, M, K, N, codec, vec, s)
               : launch<2, 4, 1>(xb, w, am, yb, M, K, N, codec, vec, s);
  else if (M <= 32)
    err = wide ? launch<4, 4, 2>(xb, w, am, yb, M, K, N, codec, vec, s)
               : launch<4, 4, 1>(xb, w, am, yb, M, K, N, codec, vec, s);
  else
    err = launch<8, 2, 2>(xb, w, am, yb, M, K, N, codec, vec, s);
  return (int)err;
}
