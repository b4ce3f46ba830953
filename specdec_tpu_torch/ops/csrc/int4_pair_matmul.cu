// INT4 pair4 dequant-matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU (Pallas) kernels specdec_tpu/ops/quant_matmul.py::_pair_kernel
// (:196, 2D, the lm_head) and ::_pair_kernel_stacked (:219, layer `idx` of an
// [L, K/8, N] stack, every layer projection). One kernel serves both: the
// layer is a base-pointer offset given by the layer index and the layer
// strides.
//
// Computes, for x [M, K] bf16, words [K/8, N] int32, absmax [K/64, N] bf16:
//
//   y[m, n] = bf16(sum_b absmax[row(b), n] * sum_{k in block b} x[m, k] * (code(k, n) - 8))
//
// accumulated in f32. As on the TPU (_pair_tile, :161), each weight is
// code - 8, exact in bf16, and each 64-k block's bf16 scale multiplies an f32
// partial sum of that block; the scale is never folded into the weight
// ((code - 8) * scale is not exact in bf16, so folding it would change the
// function). Layouts (specdec_tpu_torch/quant/core.py): word r, bits
// [4p + 16h, +4), holds the code for k = p*K/4 + 2r + h; absmax is stored
// block-major, natural block g = p*(G/4) + b at row b*4 + p (G = K/64). So
// the 32 word rows [32b, 32b + 32) hold, for each quarter p, the 64
// consecutive k of natural block p*(G/4) + b, whose scales are the 4
// consecutive stored rows 4b .. 4b+3. Requires K % 256 == 0 and x 16-byte
// aligned (the wrapper checks and aligns).
//
// What bounds it on an H100: bytes K*N/2 (words) + K/64*N*2 (absmax) + M*K*2
// (x) + M*N*2 (y) at 3.35 TB/s, or 2*M*K*N operations at 989 TFLOP/s (bf16),
// whichever is longer: bytes at the decode row counts, operations from M of a
// few hundred (one layer's four projections: ~7.0 us at M = 1, ~22.8 us at
// M = 256).
//
// Design (the structure of q4_halfplane_matmul.cu, K6, on the same layout):
//   - Products on the tensor cores, swap-AB: mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with A = 16 output columns n x 16 k of decoded weights and
//     B = 16 k x 8 rows m of x, so C holds y transposed. M = 1..8 costs one n8
//     tile; one decoded A fragment feeds every n8 tile of the block's M tile
//     (up to 64 rows, 8 tiles, in registers). Each weight is read and decoded
//     once per block pass over its M tile, i.e. once per 64 rows of x.
//   - The pair4 word is already an A fragment (K6's mapping). With g = lane
//     / 4, t = lane % 4 and an 8-row step r0, the mma's k-index 2t + h maps
//     to word row r0 + t, and 2t + 8 + h to row r0 + t + 4: k-index j is
//     then quarter-local k 2*r0 + j, so the nibbles (h = 0, 1) of quarter p
//     of one word are one bf16x2 register of the A fragment of quarter p's
//     mma. A-row g is column n0 + 2g and A-row g + 8 column n0 + 2g + 1, so a
//     thread reads its four words as two 8-byte loads, and the four words
//     give the A fragments of four mmas, one per quarter.
//   - Decode, as the TPU does: ((w >> 4p) & 0x000F000F) | 0x43004300 is the
//     bf16x2 pair (128 + code), and one bf16x2 fma (x 1, - 136) gives code -
//     8 exactly. Shifts are unsigned: bit 31 is set whenever the p = 3, h = 1
//     code is >= 8.
//   - Where the scale goes: quarter p of chunk c (32 word rows) is the whole
//     of one natural block. Two partitions of K were open. (a) K6's: the 4
//     warps of a column group take the chunk's four 8-row steps; each runs
//     its step's four quarter-mmas from a zero accumulator and adds
//     scale_p * partial into its running sum (fmaf), so a block's 64-k sum
//     is scaled in four 16-k pieces: one more f32 rounding per piece than
//     the plain version, a change of rounding order only. (b) Each warp owns
//     whole blocks, so a block's sum completes in one warp. Owning whole
//     chunks would grow the x staged per chunk with the warps (4 warps: 1024
//     k a row, 128 KB a buffer at 64 rows, more than a ring of two can hold);
//     owning one quarter of each chunk keeps K6's staging but loads every
//     word in all four warps. Timed on the H100 against each other, (b) as a
//     quarter per warp was slower at every main-path row count, most at M =
//     1 (the four-fold word loads), for a bit-equal share only slightly
//     higher. This kernel takes (a); the bit-equal gate in chip_smoke.py
//     measures what its extra roundings cost.
//   - Warps: a column group is 16 output columns and 4 warps that split K
//     as above. A block holds one or two column groups (CG) and a tile of up
//     to 64 rows of M. Two groups share one staging of x, which halves x's
//     re-reads from L2 and gives 128-byte row segments of words: the wide
//     layers (N >= 8192: the lm_head, w_gateup) take two at every M, the
//     others from M = 33.
//   - Latency: each warp keeps its words and scales for the next D chunks
//     in flight in registers (a ring, D = 1..3 by instance, fewer where the
//     tile's accumulators need the registers), and x is staged per chunk by
//     cp.async into a shared-memory ring of S chunks (S - 1 ahead: 8, 4, 4,
//     2 for 8, 16, 32, 64 rows). Only live rows are staged, at a row stride
//     of 528 bytes (132 words, 4 mod 32 banks) so that the ldmatrix reads of
//     the B fragments are free of bank conflicts; ldmatrix lanes of rows past
//     M read a zero row instead. ptxas reports no spill in any of the seven
//     instances (chip_smoke.py checks).
//   - Row independence (the greedy oracles compare AR at M = 1 with the
//     verify at M = 13): the K partition (which warp sums which steps, in
//     which order, and the fixed warp order in which the partial sums meet in
//     shared memory) depends only on K. M only picks how many n8 tiles a
//     pass carries (NT), the column groups per block and gridDim.x =
//     ceil(M / (8 * NT)); an mma's output column depends only on its own B
//     column, so the pad rows (read as zeros) change nothing, and a row's
//     result is bit-identical at every M. No atomics.
//   - Ragged edges: columns past N read no memory (their words and scales
//     are zero) and are not stored; an odd N or unaligned pointers take
//     scalar loads and stores.
// Not done yet (later work): wgmma and TMA, split-K across blocks for the
// narrow layers (N = 2048 gives 128 blocks on 132 SMs), B fragments reused
// across two A tiles per warp, and larger M tiles: above M = 64 each weight
// is decoded ceil(M / 64) times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;          // columns of a column group (one mma A tile)
constexpr int kChunkK = 256;       // k per chunk: one absmax group b, 4 quarters
constexpr int kXStride = kChunkK + 8;  // staged x row, bf16: 528 bytes

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

// the A register of quarter p of word w: the weights code - 8 of its two
// nibbles (h = 0 low, h = 1 high) as bf16x2, exactly
__device__ __forceinline__ uint32_t decode_pair(uint32_t w, int p) {
  const uint32_t biased = ((w >> (4 * p)) & 0x000F000Fu) | 0x43004300u;
  uint32_t d;  // (128 + code) * 1 - 136
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(biased),
      "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += the partial sums d of one quarter times its scales: C rows g (c0,
// c1) are column 2g, rows g + 8 (c2, c3) column 2g + 1
__device__ __forceinline__ void add_scaled(float (&acc)[4], const float (&d)[4],
                                           float s_even, float s_odd) {
  acc[0] = fmaf(d[0], s_even, acc[0]);
  acc[1] = fmaf(d[1], s_even, acc[1]);
  acc[2] = fmaf(d[2], s_odd, acc[2]);
  acc[3] = fmaf(d[3], s_odd, acc[3]);
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
int4_pair_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const int32_t* __restrict__ words,
                        const __nv_bfloat16* __restrict__ absmax,
                        __nv_bfloat16* __restrict__ y, int M, int K, int N,
                        bool vec) {
  constexpr int BM = 8 * NT;
  // chunks of words and scales in flight per warp: deeper where a warp's
  // work per chunk is short and registers are left
  constexpr int D = NT == 1 ? (CG == 1 ? 3 : 2) : NT == 2 && CG == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // x ring [S][xrows][kXStride] bf16, then one zero row
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

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

      // A fragments of the four quarters' mmas, and their scales as f32
      uint32_t a[4][4];
      float s_even[4], s_odd[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a[p][0] = decode_pair(cur.w_lo.x, p);  // row g,     k 2t
        a[p][1] = decode_pair(cur.w_lo.y, p);  // row g + 8, k 2t
        a[p][2] = decode_pair(cur.w_hi.x, p);  // row g,     k 2t + 8
        a[p][3] = decode_pair(cur.w_hi.y, p);  // row g + 8, k 2t + 8
        s_even[p] = __uint_as_float(cur.s[p] << 16);
        s_odd[p] = __uint_as_float(cur.s[p] & 0xFFFF0000u);
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
          // quarter p's partial sums of this step, from zero, then scaled
          float part[4][4] = {};
          ldmatrix_x4(b, row);                 // quarters 0, 1
          mma_bf16(part[0], a[0], b[0], b[1]);
          mma_bf16(part[1], a[1], b[2], b[3]);
          ldmatrix_x4(b, row + 2u * 128u);     // quarters 2, 3
          mma_bf16(part[2], a[2], b[0], b[1]);
          mma_bf16(part[3], a[3], b[2], b[3]);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            add_scaled(acc[i], part[p], s_even[p], s_odd[p]);
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
                   int N, bool vec, cudaStream_t stream) {
  constexpr int BM = 8 * NT;
  static bool configured = false;
  if (!configured) {  // the most any launch of this instance asks for
    const cudaError_t err = cudaFuncSetAttribute(
        int4_pair_matmul_kernel<NT, S, CG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(S, BM, CG));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + CG * kCols - 1) / (CG * kCols));
  int4_pair_matmul_kernel<NT, S, CG>
      <<<grid, kThreads * CG, smem_bytes(S, M < BM ? M : BM, CG), stream>>>(
          x, w, am, y, M, K, N, vec);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: [M, K] bf16, 16-byte aligned; words: the
// base of an [L, K/8, N] (or [K/8, N]) int32 stack; absmax: the base of
// [L, K/64, N] bf16; y: [M, N] bf16; all contiguous. The layer read is
// `layer`, at `words_layer_stride` / `absmax_layer_stride` elements per layer.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int int4_pair_matmul(const void* x, const void* words,
                                const void* absmax, void* y, int M, int K,
                                int N, long long layer,
                                long long words_layer_stride,
                                long long absmax_layer_stride, void* stream) {
  if (M < 1 || N < 1 || K < 256 || K % 256 != 0 || (uintptr_t)x % 16 != 0)
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
    err = wide ? launch<1, 8, 2>(xb, w, am, yb, M, K, N, vec, s)
               : launch<1, 8, 1>(xb, w, am, yb, M, K, N, vec, s);
  else if (M <= 16)
    err = wide ? launch<2, 4, 2>(xb, w, am, yb, M, K, N, vec, s)
               : launch<2, 4, 1>(xb, w, am, yb, M, K, N, vec, s);
  else if (M <= 32)
    err = wide ? launch<4, 4, 2>(xb, w, am, yb, M, K, N, vec, s)
               : launch<4, 4, 1>(xb, w, am, yb, M, K, N, vec, s);
  else
    err = launch<8, 2, 2>(xb, w, am, yb, M, K, N, vec, s);
  return (int)err;
}
