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
// whichever is longer: bytes at the decode row counts, operations from M of
// ~100 (one TinyLlama layer's four projections: ~7.0 us at M = 1, ~22.8 us
// at M = 256; one Qwen3-8B layer's at M = 2048: ~800 us).
//
// Two designs, chosen in the C entry by M alone: the small-M instances (M <
// kTiledMinRows: the drafter's steps, decoding, the verifies of a few
// slots), bound by the bytes of the weights, and the tiled instance (from
// kTiledMinRows rows: the admissions' prefills, the verifies of many slots,
// training forwards), bound by operations.
//
// Small-M design (the structure of q4_halfplane_matmul.cu, K6, on the same
// layout):
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
//     result is bit-identical at every M below kTiledMinRows. No atomics.
//   - Ragged edges: columns past N read no memory (their words and scales
//     are zero) and are not stored; an odd N or unaligned pointers take
//     scalar loads and stores.
//
// Tiled design (M >= kTiledMinRows). The small-M instances read and decode
// each weight once per 64 rows of x, so a 2048-row admission decoded every
// weight 32 times and ran at ~11% of its operations bound. Here a block
// owns 128 rows of x by 128 output columns, so each weight is read and
// decoded once per 128 rows, and its products run on Hopper's wgmma:
//   - Swap-AB with A from registers: wgmma m64n64k16 takes A = 64 output
//     columns x 16 k of decoded weights in the mma.m16n8k16 A-fragment
//     layout that the pair4 word already is (the mapping above: warp w of
//     a warpgroup holds columns 16w .. 16w + 15 as its 16 A rows), and B =
//     64 rows of x x 16 k, K-major in shared memory in the 128-byte swizzle
//     (one 128-byte row per row of x and quarter, 64 k). D is y transposed:
//     its column j is row j of x, and depends on nothing else, so pad rows
//     and the rows of other tiles change nothing.
//   - The scale keeps K1's arithmetic: quarter p of a 256-k chunk is one
//     natural 64-k block; its four k16 wgmmas start from zero, and the
//     block's f32 partial is then scaled by the column's bf16 scale into
//     the running sum (fmaf): one rounding per 64-k block, the plain
//     version's order, and the scale is never folded into the weight.
//   - Warps: two consumer warpgroups, 64 columns each, share one staged x
//     tile. Each splits its 128 rows into two halves of 64 (two wgmma
//     groups a quarter): a group is completed (wait 1) once the next is
//     issued, so the tensor cores run one half while the other's partial is
//     scaled in and the next quarter's A fragments are decoded. A last tile
//     of at most 64 rows runs one half.
//   - A producer warpgroup keeps x and the words in flight by cp.async into
//     rings in shared memory (x: 3 chunks of 64 KB, written in the swizzle;
//     words: 2 chunks of 16 KB, zero past N), each slot with a full and an
//     empty mbarrier (the copies' completion arrives on full through
//     cp.async.mbarrier.arrive; the 8 consumer warps arrive on empty). It
//     gives up registers (setmaxnreg 56) to the consumers (224). The
//     consumers read their words from shared memory and the scales, one
//     chunk ahead, from global memory. No TMA: x changes every call, and
//     its tensor map would cost a driver call a launch.
//   - Grid: the 128-row tiles of one column tile are neighbours in launch
//     order, so the weight tile the first reads from device memory comes
//     from L2 for the others, and x (16 MB at a 2048-row Qwen3-8B
//     admission) stays in L2 across column tiles.
//   - Row independence: the K order (chunks, quarters, k16 steps, halves)
//     depends on K alone; no split-K, no atomics. A row's result is the
//     same at every M >= kTiledMinRows, but its sums run in another order
//     than the small-M instances': across the threshold a row agrees only
//     within the kernel-vs-plain tolerance.
//   - Where it stands on an H100 (chip_smoke.py phase 3): a Qwen3-8B
//     layer's projections at 40-44% of their operations bound from M =
//     512, 3.7-4.5x the small-M design there (DeepSeek-V2-Lite's narrower
//     layers lower); cuBLAS on bf16 weights (which the port never calls)
//     is ~1.9x faster.
//     kTiledMinRows = 160 is the least row count at which it is at least as
//     fast at every served layer (verifies from 32 slots of 5 rows); below
//     it the narrow layers (N = 2048: 16 column tiles) leave most SMs idle.
// Not done yet (later work): split-K for the narrow layers, a persistent
// grid that overlaps a tile's fill with the last tile's epilogue, TMA with
// a device-side tensor map (multicast across a cluster would halve x's L2
// traffic), and the small-M instances' own redesign.

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

// ---- the tiled instance (M >= kTiledMinRows): wgmma, 128 x 128 tiles ----

constexpr int kTiledMinRows = 160;  // the least M that takes it
constexpr int kTileRows = 128;      // rows of x a block
constexpr int kTileCols = 128;      // output columns a block: 2 warpgroups x 64
constexpr int kConsumers = 256;     // two warpgroups of wgmma
constexpr int kProducers = 128;     // one warpgroup of copies
constexpr int kTiledThreads = kConsumers + kProducers;
constexpr int kXStages = 3;         // x chunks in their ring
constexpr int kWStages = 2;         // word chunks in theirs
constexpr int kQuarterBytes = kTileRows * 128;  // a quarter's 64 k, bf16
constexpr int kXStageBytes = 4 * kQuarterBytes;  // one chunk of x: 64 KB
constexpr int kWRowBytes = kTileCols * 4;        // a word row of the tile
constexpr int kWStageBytes = 32 * kWRowBytes;    // a chunk's words: 16 KB
// the x ring (aligned to the 128-byte swizzle's 1024-byte period), the word
// ring, the ring's barriers, and the alignment's slack
constexpr int kTiledSmem = kXStages * kXStageBytes + kWStages * kWStageBytes +
                           2 * (kXStages + kWStages) * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

// one arrival on the barrier once this thread's cp.asyncs so far are done
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar) : "memory");
}

// cp.async of 16 (or 4) bytes, of which the source's first n, the rest
// zero
__device__ __forceinline__ void cp_async_zfill16(uint32_t dst, const void* src,
                                                 int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_zfill4(uint32_t dst, const void* src,
                                                int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from reading (or moving a read of) a wgmma's
// accumulator across the wait that completes it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] (registers) * B[16 x 64] (shared memory,
// K-major): one half of a tile's rows; accumulate = 0 starts D from zero
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// the shared memory of a tiled block: rings and their barriers (full: the
// producer's copies of a slot have landed; empty: the 8 consumer warps are
// done with it)
struct Ring {
  uint32_t x, w;  // ring bases; x 1024-aligned
  uint32_t x_full, x_empty, w_full, w_empty;  // barrier arrays, 8 B apart
};

// the producer warpgroup: x of chunk c into x slot c % kXStages (quarter p's
// 64 k of live row m as a 128-byte row, its 16-byte piece q at piece q ^ (m
// % 8): the 128-byte swizzle; producer thread i copies piece q = i % 8 of
// quarter p = i / 8 % 4 of rows i / 32 + 4j), and the chunk's 32 word rows
// of the tile's columns into word slot c % kWStages (16 bytes a thread and
// row, rows i / 32 + 4j, zero past N)
__device__ __forceinline__ void tiled_producer(
    const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ words,
    int M, int K, int N, const Ring& r) {
  const int i = threadIdx.x - kConsumers;
  const int m0 = blockIdx.x * kTileRows;
  const int rows_live = min(kTileRows, M - m0);
  const int chunks = K / kChunkK;
  const int p = (i >> 3) & 3, q = i & 7, row0 = i >> 5;
  const __nv_bfloat16* x_src =
      x + (size_t)(m0 + row0) * K + (size_t)p * (K / 4) + 8 * q;
  // rows row0 + 4j: the swizzle of the even j's and of the odd j's
  const uint32_t x_dst = p * kQuarterBytes + row0 * 128;
  const uint32_t swz[2] = {(uint32_t)(q ^ (row0 & 7)) << 4,
                           (uint32_t)(q ^ ((row0 + 4) & 7)) << 4};
  const bool vec16 = N % 4 == 0 && (uintptr_t)words % 16 == 0;
  const int col = blockIdx.y * kTileCols + 4 * (i & 31);  // first word column
  for (int c = 0; c < chunks; ++c) {
    const int xs = c % kXStages, ws = c % kWStages;
    mbar_wait(r.x_empty + 8 * xs, ((c / kXStages) & 1) ^ 1);
    uint32_t xb = r.x + xs * kXStageBytes + x_dst;
    const __nv_bfloat16* xp = x_src + 64 * c;
#pragma unroll 4
    for (int m = row0; m < rows_live; m += 8) {  // rows m and m + 4
      cp_async16(xb + swz[0], xp);
      if (m + 4 < rows_live) cp_async16(xb + 512 + swz[1], xp + 4 * (size_t)K);
      xb += 1024;
      xp += 8 * (size_t)K;
    }
    cp_async_arrive(r.x_full + 8 * xs);
    mbar_wait(r.w_empty + 8 * ws, ((c / kWStages) & 1) ^ 1);
    const uint32_t wb = r.w + ws * kWStageBytes + 16 * (i & 31);
    const int32_t* src = words + (size_t)c * 32 * N + col;
#pragma unroll 2
    for (int j = 0; j < 8; ++j) {
      const int row = row0 + 4 * j;
      if (vec16) {
        const int n = col < N ? 16 : 0;
        cp_async_zfill16(wb + row * kWRowBytes,
                         n ? src + (size_t)row * N : words, n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = col + e < N ? 4 : 0;
          cp_async_zfill4(wb + row * kWRowBytes + 4 * e,
                          n ? src + (size_t)row * N + e : words, n);
        }
      }
    }
    cp_async_arrive(r.w_full + 8 * ws);
  }
  cp_async_wait<0>();
}

// a consumer's share of one block's tile: HALVES = 2 for up to 128 rows of
// x, two wgmma groups of 64 rows a quarter, one accumulating while the
// other's partial is scaled in; HALVES = 1 for a last tile of at most 64
// rows
template <int HALVES>
__device__ __forceinline__ void tiled_consumer(
    const __nv_bfloat16* __restrict__ absmax, __nv_bfloat16* __restrict__ y,
    int M, int K, int N, bool vec, const Ring& r) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // its warp in the warpgroup
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kTileRows;
  const int rows_live = min(kTileRows, M - m0);
  // A-row g of this warp is column nc, A-row g + 8 column nc + 1
  const int col = (tid >> 7) * 64 + warp * 16 + 2 * g;  // in the tile
  const int nc = blockIdx.y * kTileCols + col;
  const int chunks = K / kChunkK;

  auto load_scales4 = [&](uint32_t (&sc)[4], int c) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      sc[p] = load_scales(absmax + (size_t)(c * 4 + p) * N, nc, N, vec);
  };
  // the A fragments of quarter p's four k16 steps from the chunk's words
  // (step s: rows 8s + t and 8s + t + 4, columns nc and nc + 1)
  auto decode = [](uint32_t (&a)[4][4], const uint2 (&w)[4][2], int p) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s][0] = decode_pair(w[s][0].x, p);  // A-row g,     k 2t
      a[s][1] = decode_pair(w[s][0].y, p);  // A-row g + 8, k 2t
      a[s][2] = decode_pair(w[s][1].x, p);  // A-row g,     k 2t + 8
      a[s][3] = decode_pair(w[s][1].y, p);  // A-row g + 8, k 2t + 8
    }
  };
  // acc += partial times the block's scale: D row g (part[4j], [4j + 1]) is
  // column nc, row g + 8 column nc + 1
  auto scale_in = [](float (&acc)[32], float (&part)[32], uint32_t sc) {
    fence_regs(part);
    const float s_even = __uint_as_float(sc << 16);
    const float s_odd = __uint_as_float(sc & 0xFFFF0000u);
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      acc[j] = fmaf(part[j], s_even, acc[j]);
      acc[j + 1] = fmaf(part[j + 1], s_even, acc[j + 1]);
      acc[j + 2] = fmaf(part[j + 2], s_odd, acc[j + 2]);
      acc[j + 3] = fmaf(part[j + 3], s_odd, acc[j + 3]);
    }
  };
  // quarter p's four k16 wgmmas over half h's 64 rows, from zero: one
  // natural 64-k block's partial sum
  auto issue = [](float (&part)[32], const uint32_t (&a)[4][4], uint64_t desc) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma(part, a[s], desc + 2 * s, s);
    wgmma_commit();
  };

  float acc[HALVES][32], part[HALVES][32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  uint32_t sc[4], sc_next[4];
  load_scales4(sc, 0);

  for (int c = 0; c < chunks; ++c) {
    const int xs = c % kXStages, ws = c % kWStages;
    // the next chunk's scales stay in flight through this one (the last
    // chunk's again at the end, so that nothing waits on them early)
    load_scales4(sc_next, min(c + 1, chunks - 1));
    mbar_wait(r.w_full + 8 * ws, (c / kWStages) & 1);
    uint2 w[4][2];
    const uint32_t wrow = r.w + ws * kWStageBytes + 4 * col;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                     : "=r"(w[s][e].x), "=r"(w[s][e].y)
                     : "r"(wrow + (8 * s + 4 * e + t) * kWRowBytes));
    mbar_wait(r.x_full + 8 * xs, (c / kXStages) & 1);
    // the producer's copies are visible to this thread; order them before
    // the wgmma's reads (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t buf = r.x + xs * kXStageBytes;
    // quarter p of chunk c is one natural 64-k block. Each wgmma group is
    // completed (wait 1) once the next is issued, so the tensor cores work
    // on one half while the other's partial is scaled in.
    uint32_t a[2][4][4];
    decode(a[0], w, 0);
    // this warp's word reads are done (decode used them): free the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(r.w_empty + 8 * ws);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint64_t desc = sw128_desc(buf + p * kQuarterBytes);
      issue(part[0], a[p & 1], desc);
      if (HALVES == 2) {
        if (p > 0) {
          wgmma_wait<1>();  // half 1 of quarter p - 1
          scale_in(acc[HALVES - 1], part[HALVES - 1], sc[p - 1]);
        }
        issue(part[HALVES - 1], a[p & 1], desc + (64 * 128 >> 4));
      }
      if (p < 3) decode(a[(p + 1) & 1], w, p + 1);
      if (HALVES == 2) {
        wgmma_wait<1>();  // half 0 of quarter p
      } else {
        wgmma_wait<0>();
      }
      scale_in(acc[0], part[0], sc[p]);
    }
    if (HALVES == 2) {
      wgmma_wait<0>();  // half 1 of quarter 3
      scale_in(acc[HALVES - 1], part[HALVES - 1], sc[3]);
    }
    // every wgmma of this warpgroup reading the slots is done
    __syncwarp();
    if (lane == 0) mbar_arrive(r.x_empty + 8 * xs);
#pragma unroll
    for (int p = 0; p < 4; ++p) sc[p] = sc_next[p];
  }

  // half h's D column 8j + 2t (+ 1) is row m0 + 64h + 8j + 2t (+ 1) of y
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      const int m = 64 * h + 2 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (m + e < rows_live) {
          const float lo = acc[h][j + e], hi = acc[h][j + 2 + e];
          __nv_bfloat16* out = y + (size_t)(m0 + m + e) * N + nc;
          if (vec) {
            if (nc < N)
              *reinterpret_cast<__nv_bfloat162*>(out) =
                  __floats2bfloat162_rn(lo, hi);
          } else {
            if (nc < N) out[0] = __float2bfloat16_rn(lo);
            if (nc + 1 < N) out[1] = __float2bfloat16_rn(hi);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads, 1)
int4_pair_matmul_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                              const int32_t* __restrict__ words,
                              const __nv_bfloat16* __restrict__ absmax,
                              __nv_bfloat16* __restrict__ y, int M, int K,
                              int N, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  Ring r;
  r.x = (base + 1023u) & ~1023u;
  r.w = r.x + kXStages * kXStageBytes;
  r.x_full = r.w + kWStages * kWStageBytes;
  r.x_empty = r.x_full + 8 * kXStages;
  r.w_full = r.x_empty + 8 * kXStages;
  r.w_empty = r.w_full + 8 * kWStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kXStages; ++i) {
      mbar_init(r.x_full + 8 * i, kProducers);  // the producer's threads
      mbar_init(r.x_empty + 8 * i, kConsumers / 32);  // the consumer warps
    }
    for (int i = 0; i < kWStages; ++i) {
      mbar_init(r.w_full + 8 * i, kProducers);
      mbar_init(r.w_empty + 8 * i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the copies need few registers, the wgmma accumulators many
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    tiled_producer(x, words, M, K, N, r);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    if (M - (int)blockIdx.x * kTileRows > 64)
      tiled_consumer<2>(absmax, y, M, K, N, vec, r);
    else
      tiled_consumer<1>(absmax, y, M, K, N, vec, r);
  }
}

cudaError_t launch_tiled(const __nv_bfloat16* x, const int32_t* w,
                         const __nv_bfloat16* am, __nv_bfloat16* y, int M,
                         int K, int N, bool vec, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_pair_matmul_tiled_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTiledSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // the row tiles of one column tile are neighbours in launch order, so
  // that a weight tile read by the first comes from L2 for the others
  const dim3 grid((M + kTileRows - 1) / kTileRows,
                  (N + kTileCols - 1) / kTileCols);
  int4_pair_matmul_tiled_kernel<<<grid, kTiledThreads, kTiledSmem, stream>>>(
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
  // the instance: the tiled one from kTiledMinRows rows; below it NT by M,
  // with two column groups per block for the wide layers and from M = 33
  // (see the header note)
  const bool wide = N >= 8192;
  cudaError_t err;
  if (M >= kTiledMinRows)
    err = launch_tiled(xb, w, am, yb, M, K, N, vec, s);
  else if (M <= 8)
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

// The least M at which int4_pair_matmul takes the tiled instance, for the
// wrappers' count of the calls that take it.
extern "C" int int4_pair_matmul_tiled_min_rows() { return kTiledMinRows; }
