// Grouped INT4 pair4 dequant-matmul over a stack of experts, for Hopper
// (sm_90a), on the tensor cores: the expert layers of a mixture of experts
// (specdec_tpu_torch/core/moe.py). One launch takes every expert of a layer.
//
// Computes, for the n rows of an expert-sorted assignment list,
//
//   y[j, c] = bf16(sum_k x[row(j), k] * W_e(j)[k, c])
//
// where assignment j in [offsets[e], offsets[e + 1]) belongs to expert e,
// row(j) = rows[j] (or j where rows is null: the input is already sorted),
// and W_e is expert e's INT4 matrix in K1's pair4 layout (int4_pair_matmul.cu,
// specdec_tpu_torch/quant/core.py): word r of quarter p, bits [4p + 16h, +4),
// holds the code of k = p*K/4 + 2r + h; the bf16 absmax [K/64, N] stored
// block-major (natural block g = p*(G/4) + b at row b*4 + p) when G = K/64 is
// a multiple of 4, in natural order otherwise. Every weight is code - 8,
// exact in bf16; each 16-k piece of a block is summed in f32 on the tensor
// cores and multiplied by its block's scale into the f32 accumulator (fmaf),
// as K1 does. Takes any K % 64 == 0: the down projection's K = 1408 (G = 22,
// natural order) as well as 2048.
//
// What bounds it on an H100: the touched experts' words and scales read once
// (K*N/2 + K/64*N*2 bytes an expert) plus x and y (n*K*2 + n*N*2) at
// 3.35 TB/s, or 2*n*K*N operations at 989 TFLOP/s, whichever is longer
// (portbench/expert_bound.py).
//
// Design:
//   - A block is one tile of up to BM = 8*NT consecutive assignments of one
//     expert and 64 output columns: four warps of 16 columns each, every
//     warp over the whole of K, so no partial sums meet across warps. The
//     tiles of all experts are numbered in expert order; tile_end[e] (the
//     wrapper's cumulative sum of ceil(count / BM)) lets each block find its
//     expert by a binary search, on the device: the host never reads the
//     routing. The grid is ceil(n / BM) + E tiles, a bound of the true count
//     known from the shapes alone; blocks past the last tile return at once.
//   - Products on the tensor cores, swap-AB as in K1: mma.sync m16n8k16
//     with A = 16 output columns x 16 k of decoded weights and B = 16 k x 8
//     rows of x. A step of K is 8 word rows: for each quarter p the 16 k
//     p*K/4 + 16s .. + 16, one mma each; a thread's four words (rows
//     8s + t and 8s + t + 4, columns 2g and 2g + 1 of its 16) are the A
//     fragments of all four quarters (K1's mapping). 16 consecutive k from
//     a multiple of 16 lie in one 64-k block, whatever K/4 is, so each mma's
//     partial takes exactly one scale.
//   - x is staged a step at a time (4 quarters x 16 k of each live row,
//     gathered through rows[]) by cp.async into a ring of S steps, S - 1
//     ahead; rows past the tile's live rows read a zero row. A warp keeps its
//     words and scales D steps ahead in registers.
//   - Row independence: the sums of a row depend only on K (its steps in
//     order), not on the tile or the other rows, so a token's result is the
//     same at every batch and routing. No atomics.
// Not done yet (later work): wgmma and TMA, larger column tiles that share
// one staging of x, and split-K for experts given a handful of rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;                 // columns of a warp (one A tile)
constexpr int kBlockCols = kWarps * kCols;
constexpr int kStepK = 64;                // global k of one step (4 x 16)
constexpr int kXStride = kStepK + 8;      // staged x row, bf16: 144 bytes
constexpr int kStages = 4;                // steps of x in the ring
constexpr int kAhead = 2;                 // steps of words in registers

struct Slot {
  uint2 w_lo;     // word row 8s + t: columns 2g, 2g + 1
  uint2 w_hi;     // word row 8s + t + 4
  uint32_t s[4];  // quarter p: bf16 scales of columns 2g (low), 2g + 1
};

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

// quarter p of word w as the bf16x2 pair of its two codes minus 8, exactly
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int smem_bytes(int rows) {
  return (kStages * rows + 1) * kXStride * 2;
}

}  // namespace

// NT: n8 tiles of rows per block (BM = 8 * NT)
template <int NT>
__global__ void __launch_bounds__(kThreads)
int4_expert_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ tile_end,
                          const int32_t* __restrict__ words,
                          const __nv_bfloat16* __restrict__ absmax,
                          __nv_bfloat16* __restrict__ y, int K, int N, int E,
                          long long words_stride, long long absmax_stride,
                          bool block_major, bool vec) {
  constexpr int BM = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  // the block's expert: the first e with tile_end[e] > tile
  const int tile = blockIdx.x;
  if (tile >= __ldg(tile_end + E - 1)) return;
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tile_end + mid) > tile) hi = mid; else lo = mid + 1;
  }
  const int e = lo;
  const int first = e ? __ldg(tile_end + e - 1) : 0;
  const int start = __ldg(offsets + e) + (tile - first) * BM;
  const int rows_live = min(BM, __ldg(offsets + e + 1) - start);
  const int tiles_live = (rows_live + 7) / 8;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nc = blockIdx.y * kBlockCols + warp * kCols + 2 * g;
  const int quarter = K / 4;
  const int steps = K / kStepK;
  const int G = K / 64;
  const int32_t* w = words + (long long)e * words_stride;
  const __nv_bfloat16* am = absmax + (long long)e * absmax_stride;

  for (int i = threadIdx.x; i < kXStride / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(xs + kStages * BM * kXStride)[i] = 0u;

  auto load_slot = [&](int s) {
    Slot sl;
    const int r = 8 * s + t;
    sl.w_lo = load_words(w + (size_t)r * N, nc, N, vec);
    sl.w_hi = load_words(w + (size_t)(r + 4) * N, nc, N, vec);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // the natural block of k = p*K/4 + 16s and its stored row
      const int nat = (p * quarter + 16 * s) / 64;
      const int row = block_major ? (nat % (G / 4)) * 4 + nat / (G / 4) : nat;
      sl.s[p] = load_scales(am + (size_t)row * N, nc, N, vec);
    }
    return sl;
  };

  // x of step s into buffer s % kStages: live row m, quarter p, 16-byte
  // piece q (8 k) at xs[buf][m][16p + 8q]; one commit a call, empty or not
  const uint32_t xs_base = (uint32_t)__cvta_generic_to_shared(xs);
  auto stage_x = [&](int s) {
    if (s < steps) {
      const int b = s % kStages;
      for (int i = threadIdx.x; i < rows_live * 8; i += kThreads) {
        const int m = i >> 3;
        const int p = (i >> 1) & 3;
        const int q = i & 1;
        const int src = rows ? __ldg(rows + start + m) : start + m;
        cp_async16(xs_base + 2u * (uint32_t)((b * BM + m) * kXStride +
                                             16 * p + 8 * q),
                   x + (size_t)src * K + (size_t)p * quarter + 16 * s + 8 * q);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Slot ring[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    if (d < steps) ring[d] = load_slot(d);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage_x(s);

  // ldmatrix rows: matrix j = lane / 8 is k 0-7, 8-15 of quarter 2pp, then of
  // quarter 2pp + 1; row lane % 8 is the row within the n8 tile
  const int lm_row = lane & 7;
  const int lm_col = ((lane >> 4) & 1) * 16 + ((lane >> 3) & 1) * 8;

  for (int s0 = 0; s0 < steps; s0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int s = s0 + d;
      if (s >= steps) break;
      const Slot cur = ring[d];
      if (s + kAhead < steps) ring[d] = load_slot(s + kAhead);
      cp_async_wait<kStages - 2>();
      __syncthreads();  // step s staged; every warp is done with step s - 1
      stage_x(s + kStages - 1);

      uint32_t a[4][4];
      float s_even[4], s_odd[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a[p][0] = decode_pair(cur.w_lo.x, p);  // column 2g,     k 2t
        a[p][1] = decode_pair(cur.w_lo.y, p);  // column 2g + 1, k 2t
        a[p][2] = decode_pair(cur.w_hi.x, p);  // column 2g,     k 2t + 8
        a[p][3] = decode_pair(cur.w_hi.y, p);  // column 2g + 1, k 2t + 8
        s_even[p] = __uint_as_float(cur.s[p] << 16);
        s_odd[p] = __uint_as_float(cur.s[p] & 0xFFFF0000u);
      }
      const int buf = (s % kStages) * BM;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < tiles_live) {
          const int m = 8 * i + lm_row;
          const uint32_t addr =
              xs_base + 2u * (uint32_t)((m < rows_live ? buf + m
                                                       : kStages * BM) *
                                            kXStride + lm_col);
          uint32_t b[4];
          float part[4][4] = {};
          ldmatrix_x4(b, addr);             // quarters 0, 1
          mma_bf16(part[0], a[0], b[0], b[1]);
          mma_bf16(part[1], a[1], b[2], b[3]);
          ldmatrix_x4(b, addr + 2u * 32u);  // quarters 2, 3
          mma_bf16(part[2], a[2], b[0], b[1]);
          mma_bf16(part[3], a[3], b[2], b[3]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[i][0] = fmaf(part[p][0], s_even[p], acc[i][0]);
            acc[i][1] = fmaf(part[p][1], s_even[p], acc[i][1]);
            acc[i][2] = fmaf(part[p][2], s_odd[p], acc[i][2]);
            acc[i][3] = fmaf(part[p][3], s_odd[p], acc[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // C of tile i: (c0, c1) column nc at rows 2t, 2t + 1; (c2, c3) column nc + 1
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * i + 2 * t + h;
      if (m >= rows_live) continue;
      __nv_bfloat16* out = y + (size_t)(start + m) * N + nc;
      if (vec) {
        if (nc < N)
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(acc[i][h], acc[i][2 + h]);
      } else {
        if (nc < N) out[0] = __float2bfloat16_rn(acc[i][h]);
        if (nc + 1 < N) out[1] = __float2bfloat16_rn(acc[i][2 + h]);
      }
    }
  }
}

namespace {

template <int NT>
cudaError_t launch(const __nv_bfloat16* x, const int32_t* rows,
                   const int32_t* offsets, const int32_t* tile_end,
                   const int32_t* w, const __nv_bfloat16* am,
                   __nv_bfloat16* y, int n, int K, int N, int E,
                   long long ws, long long as, bool block_major, bool vec,
                   cudaStream_t stream) {
  constexpr int BM = 8 * NT;
  const dim3 grid((n + BM - 1) / BM + E, (N + kBlockCols - 1) / kBlockCols);
  int4_expert_matmul_kernel<NT><<<grid, kThreads, smem_bytes(BM), stream>>>(
      x, rows, offsets, tile_end, w, am, y, K, N, E, ws, as, block_major, vec);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: [R, K] bf16, 16-byte aligned rows;
// rows: n int32 row indices into x in expert order, or null (x is already
// in that order, R = n); offsets: E + 1 int32, expert e's assignments are
// [offsets[e], offsets[e + 1]); tile_end: E int32, the cumulative count of
// ceil(count_e / (8 * nt)) tiles; words: [E, K/8, N] int32 at
// words_stride elements an expert; absmax: [E, K/64, N] bf16 at
// absmax_stride; y: [n, N] bf16. nt: 1, 2, 4 or 8, the row tiles of 8 a
// block. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int int4_expert_matmul(const void* x, const void* rows,
                                  const void* offsets, const void* tile_end,
                                  const void* words, const void* absmax,
                                  void* y, int n, int K, int N, int E,
                                  long long words_stride,
                                  long long absmax_stride, int nt,
                                  void* stream) {
  if (n < 1 || N < 1 || E < 1 || K < 64 || K % 64 != 0 ||
      (uintptr_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* te = static_cast<const int32_t*>(tile_end);
  const int32_t* w = static_cast<const int32_t*>(words);
  const __nv_bfloat16* am = static_cast<const __nv_bfloat16*>(absmax);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool block_major = (K / 64) % 4 == 0;
  const bool vec = N % 2 == 0 && (uintptr_t)w % 8 == 0 &&
                   (uintptr_t)am % 4 == 0 && (uintptr_t)yb % 4 == 0 &&
                   words_stride % 2 == 0 && absmax_stride % 2 == 0;
  switch (nt) {
    case 1: return (int)launch<1>(xb, r, off, te, w, am, yb, n, K, N, E,
                                  words_stride, absmax_stride, block_major,
                                  vec, s);
    case 2: return (int)launch<2>(xb, r, off, te, w, am, yb, n, K, N, E,
                                  words_stride, absmax_stride, block_major,
                                  vec, s);
    case 4: return (int)launch<4>(xb, r, off, te, w, am, yb, n, K, N, E,
                                  words_stride, absmax_stride, block_major,
                                  vec, s);
    case 8: return (int)launch<8>(xb, r, off, te, w, am, yb, n, K, N, E,
                                  words_stride, absmax_stride, block_major,
                                  vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
