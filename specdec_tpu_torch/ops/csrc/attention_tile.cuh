// Online-softmax decode attention for Hopper (sm_90a): the kernel body that
// csrc/paged_attention.cu (keys through a page table) and
// csrc/decode_attention.cu (keys in the slotted cache) instantiate.
//
// Computes, for q [B, T, Hq, Dh] and the keys and values of one layer,
//
//   out[b, t, h*G + g, :] = sum_s softmax_s(scale * q . k_s) v_s
//
// over the key positions s <= offsets[b] + t (G = Hq / Hk query heads share KV
// head h). Scores, the running max and sum and the P.V accumulator are f32;
// the probabilities are rounded to q's type before P.V and the result is
// divided by max(l, 1e-38) and written in q's type, as the TPU kernels do.
// `scale` is the f32 number 1/sqrt(Dh).
//
// With int8 K/V (kQuant) each key position and head carries an f32 scale per
// array: the k-scale multiplies the score after (q.k) * scale and the v-scale
// multiplies the unnormalized probability before it is rounded for P.V, the
// scale-after-dot order of the TPU kernels, so no dequantized tile is formed.
// The int8 values are exact in f32 and are converted as they are staged.
//
// Design. The TPU kernels walk a sequential grid axis over key tiles and carry
// their softmax state in scratch memory from one grid step to the next; here
// the grid is (B, Hk, query-row tiles) and a block loops over its sequence's
// live key tiles 0 .. last itself, last being the tile of the largest query
// position of the block's rows. A block holds kRows of the T*G rows that share
// KV head h (row r is query head h*G + r % G at position t = r / G); its 4
// warps own 4 rows each, lanes own keys for the scores and head dimensions for
// P.V. Per tile the block stages K and V [tile, Dh] in shared memory as f32 (K
// rows padded by one float, so the lanes' 32 keys sit in 32 banks), and each
// warp then updates its rows' online softmax. Q is read straight from
// [B, T, Hq, Dh] and the output written straight to it, so the wrappers
// transpose and pad nothing. Any T takes the kernel: tiles cover T*G rows, so
// there is no counterpart of the TPU's VMEM guard.
//
// Rows do not depend on their neighbours: a row runs the same operations in
// the same order whatever T is and whichever rows share its block. A tile past
// a row's own position is fully masked for it: its scores are -1e30, so the
// row's running max stays, alpha is exactly 1 and every probability exactly
// 0, and the tile adds exactly nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // query rows per block (ops/attention_args.py)
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxDimPerLane = 4;  // head_dim <= 128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One tile of keys as the block reads it: row j of K (and of V) starts at
// k + j * row_stride, its scales (int8 only) at ks[j * scale_stride]; rows
// j >= valid do not exist and are masked.
template <typename TKV>
struct Tile {
  const TKV* k;
  const TKV* v;
  const float* ks;
  const float* vs;
  long long row_stride;
  long long scale_stride;
  int valid;
};

// Copy `rows` rows of dh elements of T (row r at src + r * src_stride;
// dh * sizeof(T) and the strides multiples of 16 bytes, src 16-byte aligned)
// into f32 shared memory with row stride dst_stride, 16 bytes per thread per
// step. Rows at or past `valid` (>= 1) repeat row valid - 1: their keys are
// masked, so what they hold never counts. Clamping the row instead of
// branching around the load keeps the loop free of divergent loads, which
// ran slower.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long src_stride, int valid,
                                      int rows, int dh, float* dst,
                                      int dst_stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = dh / kVec;
  const int n_vec = rows * per_row;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(
        src + min(r, valid - 1) * src_stride + c));
    const T* e = reinterpret_cast<const T*>(&w);
    float* d = dst + r * dst_stride + c;
#pragma unroll
    for (int j = 0; j < kVec; ++j) d[j] = to_float(e[j]);
  }
}

__device__ __forceinline__ void stage_scales(const float* __restrict__ src,
                                             long long stride, int valid,
                                             int rows, float* dst) {
  for (int j = threadIdx.x; j < rows; j += kThreads)
    dst[j] = __ldg(src + min(j, valid - 1) * stride);
}

// Dynamic shared memory of one block: the query tile, K (rows padded by one
// float), V, each warp's probabilities and, for int8 K/V, the two scale rows,
// all f32 (the wrappers compute the same number).
__host__ __device__ inline size_t shared_bytes(int tile, int dh, bool quant) {
  return sizeof(float) *
         ((size_t)kRows * dh + (size_t)tile * (dh + 1) + (size_t)tile * dh +
          (size_t)kWarps * tile + (quant ? 2 * (size_t)tile : 0));
}

// Keys: the key layout, with
//   int last_tile(int b, int q_last) const   last tile any row reads
//   Tile<TKV> at(int b, int h, int lp) const tile lp of sequence b, head h
// Tile lp holds key positions lp * tile .. lp * tile + tile - 1.
template <typename TQ, typename TKV, bool kQuant, typename Keys>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const TQ* __restrict__ q, const Keys keys,
                 const int32_t* __restrict__ offsets, TQ* __restrict__ out,
                 int nT, int Hq, int Hk, int Dh, int tile, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [kRows][Dh]
  float* ks = qs + kRows * Dh;         // [tile][Dh + 1]
  float* vs = ks + tile * (Dh + 1);    // [tile][Dh]
  float* ps = vs + tile * Dh;          // [kWarps][tile]
  float* kss = ps + kWarps * tile;     // [tile] (int8 K/V only)
  float* vss = kss + tile;             // [tile] (int8 K/V only)

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hk, TG = nT * G;
  const int row0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = offsets[b];

  for (int i = threadIdx.x; i < kRows * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh, row = row0 + r;
    float x = 0.f;
    if (row < TG) {
      const int t = row / G, g = row - t * G;
      x = to_float(q[((size_t)(b * nT + t) * Hq + h * G + g) * Dh + d]);
    }
    qs[i] = x;
  }

  // the last tile holding a key that some row of this block attends
  const int t_max = (min(row0 + kRows, TG) - 1) / G;
  const int last = keys.last_tile(b, off + t_max);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDimPerLane; ++c) acc[i][c] = 0.f;
  }

  float* pw = ps + warp * tile;
  for (int lp = 0; lp <= last; ++lp) {
    const Tile<TKV> tl = keys.at(b, h, lp);
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    stage(tl.k, tl.row_stride, tl.valid, tile, Dh, ks, Dh + 1);
    stage(tl.v, tl.row_stride, tl.valid, tile, Dh, vs, Dh);
    if constexpr (kQuant) {
      stage_scales(tl.ks, tl.scale_stride, tl.valid, tile, kss);
      stage_scales(tl.vs, tl.scale_stride, tl.valid, tile, vss);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      const int row = row0 + r;
      if (row >= TG) continue;  // uniform across the warp
      const int q_pos = off + row / G;
      const float* qr = qs + r * Dh;

      float mx = kNegInf;
      for (int j = lane; j < tile; j += 32) {
        const float* kr = ks + j * (Dh + 1);
        float s = 0.f;
        for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
        s *= scale;
        if constexpr (kQuant) s *= kss[j];
        if (lp * tile + j > q_pos || j >= tl.valid) s = kNegInf;
        pw[j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float p = expf(pw[j] - m_new);
        sum += p;
        if constexpr (kQuant)
          pw[j] = round_to<TQ>(p * vss[j]);
        else
          pw[j] = round_to<TQ>(p);
      }
      l[i] = l[i] * alpha + warp_sum(sum);
      m[i] = m_new;
      __syncwarp();  // every lane's probabilities are in pw

#pragma unroll
      for (int c = 0; c < kMaxDimPerLane; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < tile; ++j) {
        const float p = pw[j];
        const float* vr = vs + j * Dh;
#pragma unroll
        for (int c = 0; c < kMaxDimPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < Dh) acc[i][c] = fmaf(p, vr[d], acc[i][c]);
        }
      }
      __syncwarp();  // pw is rewritten by the next row
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + i * kWarps;
    if (row >= TG) continue;
    const int t = row / G, g = row - t * G;
    TQ* o = out + ((size_t)(b * nT + t) * Hq + h * G + g) * Dh;
    const float inv = 1.f / fmaxf(l[i], 1e-38f);
#pragma unroll
    for (int c = 0; c < kMaxDimPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) store(o + d, acc[i][c] * inv);
    }
  }
}

// Launch attention_kernel<TQ, TKV, kQuant, Keys> on `stream` over the grid
// (B, Hk, row tiles); returns cudaGetLastError() after the launch.
template <typename TQ, typename TKV, bool kQuant, typename Keys>
cudaError_t launch(const void* q, const Keys& keys, const int32_t* offsets,
                   void* out, int B, int nT, int Hq, int Hk, int Dh, int tile,
                   float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(tile, Dh, kQuant);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<TQ, TKV, kQuant, Keys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int TG = nT * (Hq / Hk);
  const dim3 grid(B, Hk, (TG + kRows - 1) / kRows);
  attention_kernel<TQ, TKV, kQuant, Keys><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), keys, offsets, static_cast<TQ*>(out), nT, Hq,
      Hk, Dh, tile, scale);
  return cudaGetLastError();
}

}  // namespace attn
