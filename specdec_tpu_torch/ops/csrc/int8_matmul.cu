// INT8 weight-only matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU (Pallas) kernel specdec_tpu/ops/quant_matmul.py::_int8_kernel
// (:91, called through _int8_matmul_2d). One kernel serves the 2D lm_head and
// layer `idx` of an [L, K, N] stack (every layer projection): the layer is a
// base-pointer offset given by the layer index and the layer strides.
//
// Computes, for x [M, K] bf16, q [K, N] int8 and scale [1, N] f32:
//
//   y[m, n] = bf16(scale[n] * sum_k x[m, k] * q[k, n])
//
// with the sum in f32 (an int8 value is exact in bf16, so this is the TPU's
// bf16 dot with f32 accumulation) and the scale applied once, after the
// complete sum, as the TPU kernel does at its last K step. Every weight is
// converted to exactly q.to(bf16), so kernel and plain version differ only in
// f32 summation order.
//
// What bounds it on an H100: bytes K*N (q) + 4N (scale) + 2MK (x) + 2MN (y)
// at 3.35 TB/s, or 2MKN operations at 989 TFLOP/s (bf16), whichever is
// longer: bytes at the decode row counts (one layer's four projections ~13.2
// us at M = 1), operations from M of a few hundred (~22.8 us at M = 256).
//
// Design:
//   - Products on the tensor cores, swap-AB: mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with A = 16 output columns x 16 k of converted weights and
//     B = 16 k x 8 rows of x, so C holds y transposed. M = 1..8 costs one n8
//     tile; one converted A fragment feeds every n8 tile of the block's M
//     tile (up to 64 rows, 8 tiles, in registers). Each weight byte is read
//     and converted once per block pass over its M tile, i.e. once per 64
//     rows of x.
//   - k permutation. In m16n8k16, thread (g = lane / 4, t = lane % 4) holds
//     the mma's k-indices {2t, 2t+1, 2t+8, 2t+9}, for A rows g and g + 8 and
//     for B column g. The sum is the same under any bijection of the 16
//     k-indices that A and B share; this kernel maps 2t + h to k0 + 4t + h and
//     2t + 8 + h to k0 + 4t + 2 + h. A thread's B fragment is then x[m][k0 +
//     4t .. k0 + 4t + 3], one 8-byte shared-memory read, and its A registers
//     for one column are that column's 4 consecutive k.
//   - Byte transpose. q is [K, N] with N contiguous. Thread (g, t) loads rows
//     k0 + 4t + {0, 1, 2, 3} at columns c0 + 4g .. c0 + 4g + 3 as four 32-bit
//     words (per load instruction the 8 lanes that share t read 32 contiguous
//     bytes of one row: a full sector). Byte i of the four row words is column
//     c0 + 4g + i at 4 consecutive k. Column c0 + 4g feeds A-row g of tile 0,
//     c0 + 4g + 1 A-row g + 8 of tile 0, and c0 + 4g + 2 / + 3 rows g / g + 8
//     of tile 1, so one warp step covers 32 columns x 16 k; C's rows are
//     un-permuted at the store. No repack: q keeps its stored layout (the
//     wrapper checks N % 4 == 0 and 4-byte alignment).
//   - Exact conversion: one byte permute places byte i (xor 0x80) under the
//     f32 exponent of 2^23 (0x4B0000uu = 8388608 + b + 128), one f32 subtract
//     of 8388736 gives b exactly, and since b is exact in bf16 the high
//     halves of two such floats are a bf16x2 register (one more permute).
//   - Warps: a column group is 32 output columns and W warps that split K:
//     a chunk is W * 32 k and warp w takes its k [32w, 32w + 32), two mma
//     k-steps. W = 16 for the narrow layers (N <= 4096: wqkv, wo, w_down,
//     where 32-column groups alone give at most 128 blocks) and 4 otherwise.
//     A block holds a tile of up to 64 rows of M and, at W = 4, two column
//     groups (CG), which share one staging of x; at W = 16 one.
//   - Latency: each warp keeps its weight words for the next D chunks in
//     flight in registers (a ring, D = 2 at M <= 8, else 1), and x is staged
//     per chunk by cp.async into a shared-memory ring of S chunks (S - 1
//     ahead). Only live rows are staged, at a row stride of 2 * chunk + 32
//     bytes (32 mod 128), so that the 8-byte B reads are free of bank
//     conflicts; rows past M read a zero row. When K % 8 != 0 (rows of x not
//     16-byte aligned) x is staged by scalar loads instead.
//   - Row independence (the greedy oracles compare AR at M = 1 with the
//     verify at M = 13): the K partition (which warp sums which k-steps, in
//     which order, and the fixed warp order in which the partial sums meet
//     in shared memory) depends only on K and N (W by N). M only picks the
//     n8 tiles a pass carries (NT) and gridDim.x = ceil(M / (8 * NT)); an
//     mma's output column depends only on its own B column, so the pad rows
//     (read as zeros) change nothing, and a row's result is bit-identical
//     at every M. No atomics. The scale multiply and the bf16 rounding come
//     after the complete sum.
//   - Ragged edges: k past K reads as 0 in q and in x; columns past N (N %
//     4 == 0: a thread's 4 columns are all in or all out) read no memory and
//     are not stored.
// Not done yet (later work): wgmma and TMA (a shared-memory ring fed by TMA
// for the weights), larger M tiles (above M = 64 each weight is read and
// converted ceil(M / 64) times), and B fragments reused across more than two
// A tiles per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;             // columns of a column group: 2 A tiles
constexpr int kSteps = 2;             // mma k-steps of 16 per warp per chunk
constexpr int kWarpK = 16 * kSteps;   // k per warp per chunk
constexpr int kRedStride = kCols + 4; // floats per row of the partial sums

// k per chunk, and the staged x row's stride in bf16 (2 * chunk + 32 bytes)
__host__ __device__ constexpr int chunk_k(int W) { return W * kWarpK; }
__host__ __device__ constexpr int x_stride(int W) { return chunk_k(W) + 16; }

// one ring slot: a chunk's 8 weight words of this thread, word 4s + j is row
// k0 + 16s + 4t + j at columns c0 + 4g .. + 3 (s the k-step, j = 0..3)
struct Slot {
  uint32_t w[4 * kSteps];
};

// bf16x2 of byte I of two words (their bytes xor 0x80 already): low half
// from `lo`, high half from `hi`; exactly the int8 values as bf16
template <int I>
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = 0x7540u | I;  // byte I, 0x00, 0x00, 0x4B
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) -
                  8388736.0f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) -
                  8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte copy; bytes past src_bytes (0 or 16) are written as zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes));
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
__host__ __device__ constexpr int smem_bytes(int S, int rows, int CG, int W) {
  return (S * rows + 1) * x_stride(W) * 2 >
                 CG * W * ((rows + 7) / 8) * 8 * kRedStride * 4
             ? (S * rows + 1) * x_stride(W) * 2
             : CG * W * ((rows + 7) / 8) * 8 * kRedStride * 4;
}

// NT: n8 tiles of M per block (rows 8 * NT); S: x chunks in the ring (S - 1
// staged ahead); CG: column groups of 32 per block, each with its own W
// K-split warps, all reading the block's staged x
template <int NT, int S, int CG, int W>
__global__ void __launch_bounds__(32 * W * CG)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N,
                   bool vec_x) {
  constexpr int BM = 8 * NT;
  constexpr int kThreads = 32 * W * CG;
  constexpr int kChunk = chunk_k(W);
  constexpr int XS = x_stride(W);
  // chunks of weight words in flight per warp: two where a warp's work per
  // chunk is shortest (measured on the H100)
  constexpr int D = NT == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // x ring [S][xrows][XS] bf16, then one zero row
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % W;  // its k slice of each chunk
  const int cg = threadIdx.x / (32 * W);    // its column group
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int nb = blockIdx.y * CG * kCols;  // the block's first column
  const int nc = nb + cg * kCols + 4 * g;  // this thread's columns nc .. + 3
  const bool col_ok = nc < N;              // N % 4 == 0: all 4 or none
  const int chunks = (K + kChunk - 1) / kChunk;
  const int xrows = min(BM, M);  // rows of a ring buffer (every block)
  const int rows_live = min(BM, M - m0);
  const int tiles_live = (rows_live + 7) / 8;

  for (int i = threadIdx.x; i < XS / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(xs + S * xrows * XS)[i] = 0u;

  const int8_t* qcol = q + nc;
  auto load_slot = [&](int c) {
    Slot s;
    const int kb = c * kChunk + warp * kWarpK + 4 * t;
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kb + 16 * st + j;
        s.w[4 * st + j] =
            col_ok && k < K
                ? __ldg(reinterpret_cast<const unsigned int*>(
                      qcol + (size_t)k * N))
                : 0u;  // converts to zeros
      }
    return s;
  };

  // x of chunk c (k = c * kChunk .. + kChunk) into buffer c % S: live row m
  // at xs[c % S][m][0 .. kChunk), zeros past K. Every thread commits one
  // group per call, empty or not, so that the group count stays in step
  // with the chunks.
  const uint32_t xs_base = (uint32_t)__cvta_generic_to_shared(xs);
  auto stage_x = [&](int c) {
    if (c < chunks) {
      const int b = c % S;
      const int kc = c * kChunk;
      if (vec_x) {
        constexpr int kPieces = kChunk / 8;
        for (int i = threadIdx.x; i < rows_live * kPieces; i += kThreads) {
          const int m = i / kPieces;
          const int p = i % kPieces;
          const int k = kc + 8 * p;
          cp_async16(xs_base + 2u * (uint32_t)((b * xrows + m) * XS + 8 * p),
                     k < K ? x + (size_t)(m0 + m) * K + k : x,
                     k < K ? 16 : 0);
        }
      } else {
        const uint16_t* xr = reinterpret_cast<const uint16_t*>(x);
        uint16_t* xw = reinterpret_cast<uint16_t*>(xs);
        for (int i = threadIdx.x; i < rows_live * kChunk; i += kThreads) {
          const int m = i / kChunk;
          const int kk = i % kChunk;
          const int k = kc + kk;
          xw[(b * xrows + m) * XS + kk] =
              k < K ? xr[(size_t)(m0 + m) * K + k] : (uint16_t)0;
        }
      }
    }
    cp_async_commit();
  };

  float acc0[NT][4], acc1[NT][4];  // A tile 0 and A tile 1
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  Slot ring[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < chunks) ring[d] = load_slot(d);
#pragma unroll
  for (int c = 0; c < S - 1; ++c) stage_x(c);

  for (int c0 = 0; c0 < chunks; c0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int c = c0 + d;
      if (c >= chunks) break;
      Slot cur = ring[d];
      if (c + D < chunks) ring[d] = load_slot(c + D);
      cp_async_wait<S - 2>();
      __syncthreads();  // chunk c staged; every warp is done with chunk c - 1
      stage_x(c + S - 1);  // into chunk c - 1's buffer

      const int buf = (c % S) * xrows;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = cur.w[4 * st + j] ^ 0x80808080u;
        // tile 0: A-row g = column nc, A-row g + 8 = nc + 1; tile 1: nc + 2,
        // nc + 3. Registers 0, 1: k 4t, 4t + 1; registers 2, 3: 4t + 2, + 3
        const uint32_t a0[4] = {
            bytes_to_bf16x2<0>(w[0], w[1]), bytes_to_bf16x2<1>(w[0], w[1]),
            bytes_to_bf16x2<0>(w[2], w[3]), bytes_to_bf16x2<1>(w[2], w[3])};
        const uint32_t a1[4] = {
            bytes_to_bf16x2<2>(w[0], w[1]), bytes_to_bf16x2<3>(w[0], w[1]),
            bytes_to_bf16x2<2>(w[2], w[3]), bytes_to_bf16x2<3>(w[2], w[3])};
        const int kx = warp * kWarpK + 16 * st + 4 * t;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (i < tiles_live) {
            const int m = 8 * i + g;
            const uint2 b = *reinterpret_cast<const uint2*>(
                xs + (m < rows_live ? buf + m : S * xrows) * XS + kx);
            mma_bf16(acc0[i], a0, b.x, b.y);
            mma_bf16(acc1[i], a1, b.x, b.y);
          }
        }
      }
    }
  }

  // the warps' partial sums meet in shared memory (reusing the x buffers),
  // summed in warp order: red[cg][w][m][n], n the group's 32 columns
  cp_async_wait<0>();  // (only empty groups are left)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int red_rows = 8 * ((xrows + 7) / 8);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < tiles_live) {
      float* r = red + ((size_t)(cg * W + warp) * red_rows + 8 * i + 2 * t) *
                           kRedStride + 4 * g;
      // C: c0 row g / mma column 2t, c1 column 2t + 1, c2 / c3 row g + 8
      *reinterpret_cast<float4*>(r) =
          make_float4(acc0[i][0], acc0[i][2], acc1[i][0], acc1[i][2]);
      *reinterpret_cast<float4*>(r + kRedStride) =
          make_float4(acc0[i][1], acc0[i][3], acc1[i][1], acc1[i][3]);
    }
  }
  __syncthreads();
  constexpr int kQuads = kCols / 4;  // column quads of a group
  for (int i = threadIdx.x; i < rows_live * CG * kQuads; i += kThreads) {
    const int m = i / (CG * kQuads);
    const int j = i % (CG * kQuads);  // column quad j of the block
    const int n = nb + 4 * j;
    if (n >= N) continue;
    const float* part = red + ((size_t)(j / kQuads) * W * red_rows + m) *
                                  kRedStride + 4 * (j % kQuads);
    float4 s = *reinterpret_cast<const float4*>(part);
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(
          part + (size_t)w * red_rows * kRedStride);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(s.x * __ldg(scale + n), s.y * __ldg(scale + n + 1));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        s.z * __ldg(scale + n + 2), s.w * __ldg(scale + n + 3));
    uint2 out;
    out.x = *reinterpret_cast<const uint32_t*>(&lo);
    out.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(y + (size_t)(m0 + m) * N + n) = out;
  }
}

template <int NT, int S, int CG, int W>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* q, const float* sc,
                   __nv_bfloat16* y, int M, int K, int N, bool vec_x,
                   cudaStream_t stream) {
  constexpr int BM = 8 * NT;
  static bool configured = false;
  if (!configured) {  // the most any launch of this instance asks for
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel<NT, S, CG, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(S, BM, CG, W));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + CG * kCols - 1) / (CG * kCols));
  int8_matmul_kernel<NT, S, CG, W>
      <<<grid, 32 * W * CG, smem_bytes(S, M < BM ? M : BM, CG, W), stream>>>(
          x, q, sc, y, M, K, N, vec_x);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: [M, K] bf16; q: the base of an
// [L, K, N] (or [K, N]) int8 stack; scale: the base of [L, 1, N] f32; y:
// [M, N] bf16; all contiguous, N % 4 == 0, q 4-byte aligned and y 8-byte
// aligned. The layer read is `layer`, at `q_layer_stride` /
// `scale_layer_stride` elements per layer. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* y, int M, int K, int N, long long layer,
                           long long q_layer_stride,
                           long long scale_layer_stride, void* stream) {
  if (M < 1 || N < 4 || N % 4 != 0 || K < 1 || (uintptr_t)y % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* qb = static_cast<const int8_t*>(q) + layer * q_layer_stride;
  const float* sc = static_cast<const float*>(scale) + layer * scale_layer_stride;
  if (reinterpret_cast<uintptr_t>(qb) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // cp.async staging of x in 16-byte pieces: rows 16-byte aligned
  const bool vec_x = K % 8 == 0 && (uintptr_t)xb % 16 == 0;
  // W (the K split) by N only, so that a row's sums never depend on M: 16
  // warps where 32-column groups alone give at most 128 blocks, else 4
  // warps and two column groups per block
  cudaError_t err;
  if (N <= 4096) {
    if (M <= 8)
      err = launch<1, 6, 1, 16>(xb, qb, sc, yb, M, K, N, vec_x, s);
    else if (M <= 16)
      err = launch<2, 4, 1, 16>(xb, qb, sc, yb, M, K, N, vec_x, s);
    else if (M <= 32)
      err = launch<4, 3, 1, 16>(xb, qb, sc, yb, M, K, N, vec_x, s);
    else
      err = launch<8, 2, 1, 16>(xb, qb, sc, yb, M, K, N, vec_x, s);
  } else if (M <= 8) {
    err = launch<1, 6, 2, 4>(xb, qb, sc, yb, M, K, N, vec_x, s);
  } else if (M <= 16) {
    err = launch<2, 4, 2, 4>(xb, qb, sc, yb, M, K, N, vec_x, s);
  } else if (M <= 32) {
    err = launch<4, 3, 2, 4>(xb, qb, sc, yb, M, K, N, vec_x, s);
  } else {
    err = launch<8, 2, 2, 4>(xb, qb, sc, yb, M, K, N, vec_x, s);
  }
  return (int)err;
}
