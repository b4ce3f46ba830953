// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels specdec_tpu/ops/paged_attention.py::_kernel
// (paged_decode_attention, a [NP, Hk, page, Dh] pool) and ::_kernel_stacked
// (paged_decode_attention_stacked, layer `layer` of [L, NP, Hk, page, Dh]
// stacks). One kernel serves both: the layer is a base-pointer offset given by
// the layer index and the layer stride (0 for a 4D pool).
//
// Computes, for q [B, T, Hq, Dh], pools [.., NP, Hk, page, Dh] (f32 or bf16,
// the same type as q), table [B, MP] int32 and offsets [B] int32:
//
//   out[b, t, h*G + g, :] = sum_s softmax_s(scale * q . k_s) v_s
//
// over the key positions s <= offsets[b] + t (G = Hq / Hk query heads share KV
// head h; key position s lives at slot s % page of pool page
// table[b, s / page]). Scores, the running max and sum and the P.V accumulator
// are f32; the probabilities are rounded to the value type before P.V and the
// result is divided by max(l, 1e-38) and written in q's type, as the TPU kernel
// does. `scale` is the f32 number 1/sqrt(Dh).
//
// Design. The TPU kernel walks a sequential grid axis over pages and carries
// its softmax state in scratch memory from one grid step to the next; here the
// grid is (B, Hk, query-row tiles) and a block loops over its sequence's live
// pages 0 .. min(last, MP-1) itself, last = (offsets[b] + t_max) / page for the
// tile's largest t. A tile is kRows rows of the T*G rows that share KV head h
// (row r is query head h*G + r % G at position t = r / G); its 4 warps own 4
// rows each, lanes own keys for the scores and head dimensions for P.V. Per
// page the block stages K and V [page, Dh] in shared memory as f32 (K rows
// padded by one float, so the lanes' 32 keys sit in 32 banks), each warp then
// updates its rows' online softmax. Q is read straight from [B, T, Hq, Dh] and
// the output written straight to it, so the wrapper transposes and pads
// nothing. Any T takes the kernel: tiles cover T*G rows, so there is no
// counterpart of the TPU's VMEM guard.
//
// What bounds it on an H100: bytes. A call must read the live pages of K and V
// (for each sequence, (last+1) pages x Hk x page x Dh, twice) plus q and write
// out; at T*G <= 72 rows per KV head the products stay far below the
// tensor-core line. This kernel reads each live page once per query-row tile
// (five times at the verify's T*G = 72), with 16-byte loads, and does the
// products on the CUDA cores from shared memory. It does no more about the
// bytes yet: no cp.async/TMA double buffering, no split over pages for long
// sequences at small batch, no tensor cores (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // query rows per block (ops/paged_attention.py)
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxDimPerLane = 4;  // head_dim <= 128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Copy a contiguous [rows, dh] block of T (dh % 8 == 0, 16-byte aligned) into
// f32 shared memory with row stride `stride`, 16 bytes per thread per step.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int rows, int dh, int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_vec = rows * dh / kVec;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 w = __ldg(s + i);
    const T* e = reinterpret_cast<const T*>(&w);
    const int r = (i * kVec) / dh;
    const int c = i * kVec - r * dh;
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * stride + c + j] = to_float(e[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ offsets,
                       T* __restrict__ out, int nT, int Hq, int Hk, int Dh,
                       int page, int MP, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [kRows][Dh]
  float* ks = qs + kRows * Dh;         // [page][Dh + 1]
  float* vs = ks + page * (Dh + 1);    // [page][Dh]
  float* ps = vs + page * Dh;          // [kWarps][page]

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

  // the last logical page holding a key that some row of this tile attends
  const int t_max = (min(row0 + kRows, TG) - 1) / G;
  const int last = min((off + t_max) / page, MP - 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDimPerLane; ++c) acc[i][c] = 0.f;
  }

  const size_t page_elems = (size_t)page * Dh;
  float* pw = ps + warp * page;
  for (int lp = 0; lp <= last; ++lp) {
    const size_t base = ((size_t)table[b * MP + lp] * Hk + h) * page_elems;
    __syncthreads();  // the previous page is consumed (and qs is staged)
    stage(k + base, ks, page, Dh, Dh + 1);
    stage(v + base, vs, page, Dh, Dh);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      const int row = row0 + r;
      if (row >= TG) continue;  // uniform across the warp
      const int q_pos = off + row / G;
      const float* qr = qs + r * Dh;

      float mx = kNegInf;
      for (int j = lane; j < page; j += 32) {
        const float* kr = ks + j * (Dh + 1);
        float s = 0.f;
        for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
        s *= scale;
        if (lp * page + j > q_pos) s = kNegInf;
        pw[j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float p = expf(pw[j] - m_new);
        sum += p;
        pw[j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + warp_sum(sum);
      m[i] = m_new;
      __syncwarp();  // every lane's probabilities are in pw

#pragma unroll
      for (int c = 0; c < kMaxDimPerLane; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < page; ++j) {
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
    T* o = out + ((size_t)(b * nT + t) * Hq + h * G + g) * Dh;
    const float inv = 1.f / fmaxf(l[i], 1e-38f);
#pragma unroll
    for (int c = 0; c < kMaxDimPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) store(o + d, acc[i][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* table, const int32_t* offsets, void* out,
                   int B, int nT, int Hq, int Hk, int Dh, int page, int MP,
                   long long layer_offset, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRows * Dh + (size_t)page * (Dh + 1) +
                       (size_t)page * Dh + (size_t)kWarps * page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int TG = nT * (Hq / Hk);
  const dim3 grid(B, Hk, (TG + kRows - 1) / kRows);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k) + layer_offset,
      static_cast<const T*>(v) + layer_offset, table, offsets,
      static_cast<T*>(out), nT, Hq, Hk, Dh, page, MP, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q/out: [B, T, Hq, Dh]; k/v: the base of
// [L, NP, Hk, page, Dh] (or [NP, Hk, page, Dh]) pools, all contiguous and of
// one type, dtype 0 = float32, 1 = bfloat16; table [B, MP] and offsets [B]
// int32. The layer read is `layer`, at `layer_stride` elements per layer.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* table, const void* offsets,
                               void* out, int dtype, int B, int T, int Hq,
                               int Hk, int Dh, int page, int MP,
                               long long layer, long long layer_stride,
                               float scale, void* stream) {
  if (B < 1 || T < 1 || Hk < 1 || Hq % Hk != 0 || Dh < 8 || Dh % 8 != 0 ||
      Dh > 32 * kMaxDimPerLane || page < 1 || MP < 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* tbl = static_cast<const int32_t*>(table);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long layer_offset = layer * layer_stride;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, tbl, off, out, B, T, Hq, Hk, Dh, page,
                              MP, layer_offset, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, tbl, off, out, B, T, Hq, Hk,
                                      Dh, page, MP, layer_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
